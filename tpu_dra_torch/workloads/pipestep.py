"""One pipelined training step against the unpipelined one.

Joins the slice's process group from the driver-rendered env (as ``train
--distributed`` does), builds the mesh ``MeshConfig(pp = the world)`` and
runs :func:`.parallel.pipeline.pipelined_llama_forward` of a Llama preset
and its backward on the next-token loss, ``--steps`` times on the same
weights (no optimizer; the first pass warms up), then the unpipelined
``Llama`` forward and backward of the same weights on the same rank.
Prints one JSON line a rank: the losses and the unpipelined loss, the
step ms, each step's kernel launches, the collectives (their count and
MB over all steps), the peak memory, which layers got gradients, and
each gradient leaf's cosine to the unpipelined gradient.

    python -m tpu_dra_torch.workloads.pipestep --device cpu --seq 32
    # two ranks sharing one card, under the rendered env of each:
    python -m tpu_dra_torch.workloads.pipestep --device cuda:0 \\
        --backend gloo --model llama3-8b --layers 2 --seq 2048 --steps 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

#: Rows of the batch, and the microbatches the relay splits them into.
BATCH, MICROBATCHES = 2, 2


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def _step(args, world: int) -> dict:
    import numpy as np
    import torch

    from tpu_dra_torch import kernels
    from tpu_dra_torch.workloads import models as models_mod
    from tpu_dra_torch.workloads.device import resolve_device, synchronize
    from tpu_dra_torch.workloads.models.llama import Llama, init_params
    from tpu_dra_torch.workloads.parallel.mesh import MeshConfig, build_mesh
    from tpu_dra_torch.workloads.parallel.pipeline import (
        pipelined_llama_forward,
    )
    from tpu_dra_torch.workloads.train import MODEL_PRESETS, next_token_loss

    device = resolve_device(args.device)
    cfg = getattr(models_mod, MODEL_PRESETS[args.model])
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh = build_mesh(MeshConfig(pp=world), device=device)
    # The Trainer's weights (seed 0 on the device) and train's batch.
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         trainable=True)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, args.seq)).astype(np.int32)).to(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms, launches = [], [], []
    for _ in range(args.steps):
        for p in params.parameters():
            p.grad = None
        before = dict(kernels.LAUNCHES)
        synchronize(device)
        t0 = time.perf_counter()
        loss = next_token_loss(pipelined_llama_forward(
            cfg, params, tokens, mesh=mesh, n_microbatches=MICROBATCHES),
            tokens)
        loss.backward()
        losses.append(float(loss.detach()))  # waits for the device
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: n - before.get(k, 0)
                         for k, n in kernels.LAUNCHES.items()
                         if n != before.get(k, 0)})
        del loss
    peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9
               if device.type == "cuda" else None)
    grads = {n: p.grad for n, p in params.named_parameters()
             if p.grad is not None}
    for p in params.parameters():
        p.grad = None
    plain = next_token_loss(Llama(cfg)(tokens, params=params), tokens)
    plain.backward()
    named = dict(params.named_parameters())
    layers = sorted({n.split(".")[0] for n in grads if n.startswith("layer_")},
                    key=lambda n: int(n.split("_")[1]))
    return {
        "ok": losses[-1] == losses[-1], "loss": losses[-1], "losses": losses,
        "unpipelined_loss": float(plain.detach()), "step_ms": step_ms,
        "rank": mesh.rank, "mesh": {a: n for a, n in mesh.shape.items()
                                    if n > 1},
        "microbatches": MICROBATCHES, "batch": BATCH, "seq": args.seq,
        "layers": cfg.n_layers, "device": str(device),
        "stage_layers": layers,
        "layer_grads_nonzero": {
            layer: all(bool(g.abs().sum() > 0) for n, g in grads.items()
                       if n.startswith(layer + "."))
            for layer in layers},
        "leaf_cosines": {n: _cosine(g, named[n].grad)
                         for n, g in grads.items()},
        "launches_per_step": launches,
        "collectives": {k: {"count": n, "mb": mesh.bytes[k] / 1e6,
                            "ms": mesh.seconds[k] * 1e3,
                            "staged": mesh.staged[k]}
                        for k, n in mesh.collectives.items()},
        "peak_memory_gb": peak_gb,
    }


def main(argv=None) -> int:
    from tpu_dra_torch.workloads.bootstrap import initialize_from_env, shutdown

    p = argparse.ArgumentParser("tpu-dra-torch-pipestep")
    p.add_argument("--model", choices=("llama3-8b", "tiny"), default="tiny",
                   help="a Llama preset of train's MODEL_PRESETS")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the preset to this many layers (0: keep)")
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--steps", type=int, default=1,
                   help="pipelined forward and backward passes on the same "
                        "weights (no optimizer; the first one warms up)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' for "
                        "the plain PyTorch path)")
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                   help="process group backend (default: NCCL for CUDA, "
                        "gloo for the CPU)")
    args = p.parse_args(argv)
    se = initialize_from_env(device=args.device, backend=args.backend)
    try:
        out = _step(args, se.num_processes)
    finally:
        shutdown()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
