"""One gloo rank of the pipeline twins (tests/test_torch_pipeline.py).

Run as ``python tests/torch_pipeline_rank.py DIR CASE [CASE ...]`` in the
env the slice daemon renders (tests/torch_ranks.py ``rank_env``): it
joins the group (``bootstrap.initialize_from_env``), runs each case on
the CPU and prints one JSON line of results. The pipeline cases:

- ``apply``: ``pipeline_apply`` of ``tanh(x @ w)`` stages at pp=4 x tp=2,
  4 microbatches, on ``apply_inputs()``: the output and the gradient of
  ``sum(out ** 2)`` for the stacked weights (this rank's stage's row
  alone: the stage dim is sharded over pp);
- ``llama``: ``pipelined_llama_forward`` of TINY_LLAMA fp32 at pp=2 x
  dp=2 x tp=2, 2 microbatches, on the weights the parent wrote to
  ``DIR/llama.npz`` (JAX's stacked tree) and ``llama_tokens()``; the
  logits go to ``DIR/llama_logits_rank<r>.npy`` and the gradients of
  ``mean(logits ** 2)`` (the JAX test's loss) that reached this rank to
  ``DIR/llama_grads_rank<r>.npz``;
- ``refusals``: a batch the microbatches do not split and a layer count
  the stages do not split, each ValueError's message.

Any other case is a Trainer case of tests/torch_train_rank.py. No JAX
import: the ranks are the port's.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tests import torch_train_rank as TR  # noqa: E402

APPLY_MESH = dict(pp=4, tp=2)
LLAMA_MESH = dict(pp=2, dp=2, tp=2)
APPLY_DIM = 16


def apply_inputs():
    """(stacked stage weights [4, d, d], x [8, d]), fp32, from a seed."""
    rng = np.random.default_rng(5)
    ws = rng.normal(size=(4, APPLY_DIM, APPLY_DIM)) / np.sqrt(APPLY_DIM)
    x = rng.normal(size=(8, APPLY_DIM))
    return ws.astype(np.float32), x.astype(np.float32)


def llama_tokens() -> np.ndarray:
    return np.random.default_rng(6).integers(0, 256, (4, 16)).astype(np.int32)


def _stage_fn(w, x):
    import torch

    return torch.tanh(x @ w[0])  # w: [1, d, d], this rank's stage


def _apply(mesh) -> dict:
    import torch

    from tpu_dra_torch.workloads.parallel import pipeline_apply

    ws, x = apply_inputs()
    ws = torch.from_numpy(ws).requires_grad_(True)
    staged = ws.reshape(4, 1, APPLY_DIM, APPLY_DIM)
    out = pipeline_apply(_stage_fn, staged, torch.from_numpy(x), mesh=mesh,
                         n_microbatches=4)
    (out ** 2).sum().backward()
    return {"out": out.detach().tolist(), "grad": ws.grad.tolist(),
            "coords": mesh.coords, "collectives": dict(mesh.collectives)}


def _llama(mesh, root: Path, rank: int) -> dict:
    import torch

    from tpu_dra_torch.workloads.convert import params_from_numpy
    from tpu_dra_torch.workloads.parallel import pipelined_llama_forward

    cfg = TR.config_of(TR.Case({}, "fp32", "seed"))
    with np.load(root / "llama.npz") as f:
        tree = TR._tree({k: f[k] for k in f.files}, "")
    params = params_from_numpy(tree, cfg, device="cpu", trainable=True)
    logits = pipelined_llama_forward(
        cfg, params, torch.from_numpy(llama_tokens()), mesh=mesh,
        n_microbatches=2)
    (logits ** 2).mean().backward()
    np.save(root / f"llama_logits_rank{rank}.npy", logits.detach().numpy())
    grads = {n: p.grad.numpy() for n, p in params.named_parameters()
             if p.grad is not None}
    np.savez(root / f"llama_grads_rank{rank}.npz", **grads)
    return {"coords": mesh.coords, "grads": sorted(grads),
            "collectives": dict(mesh.collectives)}


def _refusals(mesh) -> dict:
    import torch

    from tpu_dra_torch.workloads.parallel import (
        pipeline_apply,
        stage_layer_names,
    )

    out = {}
    try:
        pipeline_apply(lambda w, x: x, torch.zeros(mesh.shape["pp"], 1),
                       torch.zeros(5, 3), mesh=mesh, n_microbatches=2)
    except ValueError as e:
        out["microbatches"] = str(e)
    try:
        stage_layer_names(3, mesh)
    except ValueError as e:
        out["stages"] = str(e)
    return out


def run_pipeline_case(name: str, rank: int, root: Path) -> dict:
    from tpu_dra_torch.workloads.parallel.mesh import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(**(APPLY_MESH if name == "apply"
                                    else LLAMA_MESH)), device="cpu")
    if name == "apply":
        return _apply(mesh)
    if name == "llama":
        return _llama(mesh, root, rank)
    return _refusals(mesh)


def main(argv) -> int:
    from tpu_dra_torch.workloads.bootstrap import initialize_from_env, shutdown
    from tpu_dra_torch.workloads.parallel.context import set_global_mesh

    root, names = Path(argv[0]), argv[1:]
    se = initialize_from_env(device="cpu")
    out = {"rank": se.worker_id, "world": se.num_processes}
    try:
        for name in names:
            if name in ("apply", "llama", "refusals"):
                out[name] = run_pipeline_case(name, se.worker_id, root)
            else:
                out[name] = TR.run_case(name, TR.CASES[name], root,
                                        se.worker_id)
            set_global_mesh(None)
    finally:
        shutdown()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
