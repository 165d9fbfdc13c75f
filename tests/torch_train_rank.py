"""One gloo rank of the sharded-training twins (tests/test_torch_train.py,
tests/test_torch_train_sharded.py, tests/test_torch_train_moe.py,
tests/test_torch_pipeline.py).

Run as ``python tests/torch_train_rank.py DIR CASE [CASE ...]`` in the env
the slice daemon renders (tests/torch_ranks.py ``rank_env``): it joins
the group (``bootstrap.initialize_from_env``), runs each case's Trainer
on the CPU and prints one JSON line of results. A case starts from a
JAX training state the parent wrote to ``DIR/state_<name>.npz``
(``params/...`` and ``opt/mu/...``, ``opt/nu/...``, ``opt/count``),
converted through ``convert.train_state_from_numpy``, or from the
Trainer's own seeded ``init_state``. With ``gather``, rank 0 writes the
global logits of the starting weights (``make_forward``) to
``DIR/<case>_logits.npy``, and the step-1 gradients and the final
parameters, gathered whole (``gather_train_params``), to
``DIR/<case>_grads.npz`` and ``DIR/<case>_params.npz``; a case of no
steps only runs the forward. No JAX import: the ranks are the port's.
"""

import dataclasses
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

#: tests/test_workloads.py's batches: its full-mesh step and its
#: Ulysses step.
TOKENS = {
    "b4": np.tile(np.arange(16, dtype=np.int32)[None], (4, 1)),
    "b2": np.tile(np.arange(16, dtype=np.int32)[None], (2, 1)),
    # The MoE twins': seeded rows that route apart.
    "r4": np.random.default_rng(1).integers(0, 256, (4, 16)).astype(np.int32),
}


@dataclasses.dataclass(frozen=True)
class Case:
    mesh: dict
    dtype: str  # "fp32" | "bf16"
    state: str  # "seed", or the name of a state_<name>.npz
    tokens: str = "b4"
    steps: int = 2
    lr: float = 1e-3
    config: tuple = ()  # config overrides, (name, value) pairs
    gather: bool = False
    model: str = "llama"  # "llama" (TINY_LLAMA) | "mixtral" (TINY_MIXTRAL)


CASES = {
    # tests/test_workloads.py test_trainer_full_sharded_step.
    "full_fp32": Case(dict(fsdp=2, sp=2, tp=2), "fp32", "fp32",
                      config=(("attention_impl", "ring"),), gather=True),
    "full_bf16": Case(dict(fsdp=2, sp=2, tp=2), "bf16", "bf16",
                      config=(("attention_impl", "ring"),)),
    "full_remat": Case(dict(fsdp=2, sp=2, tp=2), "fp32", "fp32",
                       config=(("attention_impl", "ring"), ("remat", True))),
    # tests/test_workloads.py test_llama_ulysses_impl_trains.
    "ulysses": Case(dict(sp=2, tp=2), "bf16", "ulysses_bf16", tokens="b2",
                    steps=1, lr=3e-4,
                    config=(("attention_impl", "ulysses"),)),
    "dp_fsdp_remat": Case(dict(dp=2, fsdp=2), "fp32", "fp32",
                          config=(("remat", True),)),
    "sp_auto": Case(dict(dp=2, sp=2), "fp32", "fp32"),
    "fused_tp": Case(dict(sp=2, tp=2), "fp32", "fp32",
                     config=(("fused_ce", True), ("ce_chunk", 4))),
    # train --distributed's default mesh at a world of 2.
    "fsdp2": Case({}, "fp32", "seed", tokens="b2"),
    # tests/test_moe_pipeline.py test_mixtral_trainer_ep_step.
    "moe_dp_ep_tp": Case(dict(dp=2, ep=2, tp=2), "fp32", "moe_fp32",
                         tokens="r4", gather=True, model="mixtral"),
    # tests/test_moe_pipeline.py test_mixtral_ep_sharded_matches_single_
    # device: the forward alone, in fp32 and bf16.
    "moe_ep4_fwd": Case(dict(ep=4, tp=2), "fp32", "moe_fp32", tokens="r4",
                        steps=0, gather=True, model="mixtral"),
    "moe_ep4_fwd_bf16": Case(dict(ep=4, tp=2), "bf16", "moe_bf16",
                             tokens="r4", steps=0, gather=True,
                             model="mixtral"),
    # Tight capacity over the global sequence, chunked over sp.
    "moe_fsdp_sp_ep": Case(dict(fsdp=2, sp=2, ep=2), "fp32", "moe_fp32",
                           tokens="r4", gather=True, model="mixtral",
                           config=(("attention_impl", "ring"),
                                   ("capacity_factor", 0.5))),
    "moe_ulysses": Case(dict(sp=2, tp=2), "bf16", "moe_bf16", tokens="r4",
                        model="mixtral",
                        config=(("attention_impl", "ulysses"),)),
    # A dense Llama at ep=2: replicated over ep.
    "llama_ep2": Case(dict(ep=2), "fp32", "seed", tokens="r4"),
    # JAX's Trainer at pp=2 runs its step replicated over pp: the same
    # losses as the mesh without pp (tests/test_torch_pipeline.py).
    "pp_dp_tp": Case(dict(pp=2, dp=2, tp=2), "fp32", "pp_fp32", steps=3),
    "dp_tp": Case(dict(dp=2, tp=2), "fp32", "pp_fp32", steps=3),
    "moe_pp_ep": Case(dict(pp=2, ep=2), "fp32", "moe_pp_fp32", tokens="r4",
                      steps=3, model="mixtral"),
    "moe_ep": Case(dict(ep=2), "fp32", "moe_pp_fp32", tokens="r4", steps=3,
                   model="mixtral"),
}


def config_of(case: Case):
    import torch

    from tpu_dra_torch.workloads.models.llama import TINY_LLAMA
    from tpu_dra_torch.workloads.models.mixtral import TINY_MIXTRAL

    base = {"llama": TINY_LLAMA, "mixtral": TINY_MIXTRAL}[case.model]
    dtype = torch.float32 if case.dtype == "fp32" else torch.bfloat16
    return dataclasses.replace(base, dtype=dtype, param_dtype=dtype,
                               **dict(case.config))


def _tree(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        *parents, leaf = key[len(prefix):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def load_state(path: Path, cfg, mesh) -> dict:
    from tpu_dra_torch.workloads.convert import train_state_from_numpy

    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    opt = SimpleNamespace(count=flat["opt/count"],
                          mu=_tree(flat, "opt/mu/"), nu=_tree(flat, "opt/nu/"))
    return train_state_from_numpy(_tree(flat, "params/"), opt, cfg, mesh,
                                  device="cpu")


def _nested(named: dict) -> dict:
    out: dict = {}
    for name, t in named.items():
        node = out
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def _flat_numpy(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_numpy(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.float().numpy()
    return out


def run_case(name: str, case: Case, root: Path, rank: int) -> dict:
    import torch

    from tpu_dra_torch.workloads import train as T
    from tpu_dra_torch.workloads.parallel.mesh import gather_train_params

    cfg = config_of(case)
    mesh_config = (T.MeshConfig(**case.mesh) if case.mesh
                   else T.MeshConfig.for_device_count(
                       torch.distributed.get_world_size()))
    trainer = T.Trainer(cfg, mesh_config,
                        T.TrainConfig(learning_rate=case.lr), device="cpu")
    mesh = trainer.mesh
    if case.state == "seed":
        state = trainer.init_state()
    else:
        state = load_state(root / f"state_{case.state}.npz", cfg, mesh)
    shardings = trainer.state_shardings(state)
    specs = {
        "wq": shardings["params"]["layer_0"]["attention"]["wq"]["kernel"],
        "wq_mu": shardings["opt_state"].mu["layer_0.attention.wq.kernel"],
        "embed": shardings["params"]["embed"]["embedding"],
        "norm": shardings["params"]["final_norm"]["scale"],
        "count": shardings["opt_state"].count, "step": shardings["step"],
    }
    tokens = torch.from_numpy(TOKENS[case.tokens])
    grads_seen = []
    if case.gather:
        # The global logits of the starting weights, on every rank.
        logits = trainer.make_forward()(state["params"], tokens)
        if rank == 0:
            np.save(root / f"{name}_logits.npy", logits.float().numpy())
    if case.gather and case.steps:
        update = trainer.optimizer.update

        def spy(grads, opt_state, params):
            if not grads_seen:
                grads_seen.append(gather_train_params(mesh, _nested(grads)))
            return update(grads, opt_state, params)

        trainer.optimizer.update = spy
    step = trainer.make_train_step()
    losses = []
    for _ in range(case.steps):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    out = {
        "losses": losses, "mesh": {a: n for a, n in mesh.shape.items()
                                   if n > 1},
        "coords": mesh.coords,
        "local_wq": list(state["params"].tree()["layer_0"]["attention"][
            "wq"]["kernel"].shape),
        "collectives": dict(mesh.collectives), "staged": dict(mesh.staged),
        "step": state["step"], "count": int(state["opt_state"].count),
        "specs": specs,
        "local_moe": {n: list(t.shape) for n, t in
                      state["params"].named_parameters()
                      if n.startswith("layer_0.moe.")},
    }
    if case.gather and case.steps:
        full = gather_train_params(mesh, state["params"])
        if rank == 0:
            np.savez(root / f"{name}_grads.npz", **_flat_numpy(grads_seen[0]))
            np.savez(root / f"{name}_params.npz", **_flat_numpy(full))
    return out


def main(argv) -> int:
    from tpu_dra_torch.workloads.bootstrap import initialize_from_env, shutdown
    from tpu_dra_torch.workloads.parallel.context import set_global_mesh

    root, names = Path(argv[0]), argv[1:]
    se = initialize_from_env(device="cpu")
    out = {"rank": se.worker_id, "world": se.num_processes}
    try:
        for name in names:
            out[name] = run_case(name, CASES[name], root, se.worker_id)
            set_global_mesh(None)
    finally:
        shutdown()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
