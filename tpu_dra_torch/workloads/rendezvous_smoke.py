"""Cross-process rendezvous smoke: prove a driver-rendered bootstrap env.

Counterpart of ``tpu_dra/workloads/rendezvous_smoke.py``, with its flags
(``--device`` in place of ``--cpu-devices``: one rank is one device) and
its JSON keys. What makes a ComputeDomain real for a workload is a
process group built from the env the slice daemon rendered and the CD
kubelet plugin injected (CDI env + the /tpu-cd mount). This CLI is that
workload at its smallest: load the bootstrap env, rendezvous
(:func:`.bootstrap.initialize_from_env`), count the global devices, run
one collective and one data-parallel train step, and print one JSON
line. Run it as the workload container's command (the injected env), or
point ``--config-dir`` at a daemon-rendered dir to source bootstrap.env
explicitly; one process a rank:

    python -m tpu_dra_torch.workloads.rendezvous_smoke --config-dir D --device cpu

Exit 0 iff the rendezvous succeeded, the world equals the rendered
``JAX_NUM_PROCESSES``, the global device count is processes x local
devices, the all-gathered sum saw every rank's contribution, and the
train step's loss is finite, descends and is bit-identical on every
rank.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

FEATURE_DIM = 8


def main(argv=None) -> int:
    p = argparse.ArgumentParser("tpu-dra-torch-rendezvous-smoke")
    p.add_argument(
        "--config-dir",
        default=os.environ.get("CD_CONFIG_DIR", ""),
        help="Per-CD config dir; when set, bootstrap.env from it is "
        "loaded into the process env first (the CDI-injection analog)",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA device, NCCL; 'cpu' for "
        "gloo)",
    )
    p.add_argument(
        "--rows-per-device",
        type=int,
        default=4,
        help="Local batch rows per device for the train step",
    )
    args = p.parse_args(argv)

    from tpu_dra_torch.workloads.bootstrap import (
        initialize_from_env,
        read_bootstrap_env,
        shutdown,
    )

    if args.config_dir:
        env = read_bootstrap_env(args.config_dir)
        if env is None:
            print(f"no bootstrap.env under {args.config_dir}", file=sys.stderr)
            return 2
        os.environ.update(env)
        os.environ["CD_CONFIG_DIR"] = args.config_dir

    se = initialize_from_env(device=args.device)
    try:
        out = _run(se, args.device, args.rows_per_device)
    finally:
        shutdown()
    print(json.dumps(out))
    return 0


def _require(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def _run(se, device, rows_per_device: int) -> dict:
    import torch
    import torch.distributed as dist

    from tpu_dra_torch.workloads.smoke import group_device

    dev = group_device(device)
    distributed = dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    _require(world == se.num_processes,
             f"world {world} != rendered JAX_NUM_PROCESSES {se.num_processes}")

    def all_sum(t):
        if distributed:
            dist.all_reduce(t)
        return t

    def all_gather(t):
        if not distributed:
            return t
        g = torch.empty(world * t.numel(), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(g, t)
        return g

    n_local = 1  # one device a rank
    n_global = int(all_sum(torch.tensor([n_local], device=dev))[0])
    _require(n_global == se.num_processes * n_local,
             f"global {n_global} != {se.num_processes} x {n_local}")

    # 1. Global collective: every rank contributes 2**worker_id; the
    #    all-gathered sum proves each worker's bytes crossed the fabric.
    contrib = all_gather(
        torch.tensor([2.0 ** se.worker_id], dtype=torch.float32, device=dev))
    psum = float(contrib.sum())
    expected = float(2.0 ** se.num_processes - 1)
    _require(psum == expected, f"psum {psum} != {expected}")

    # 2. One data-parallel train step: the rows sharded over the ranks,
    #    the weights replicated. The loss is the mean over the GLOBAL
    #    batch, so the squared sums and the gradient are summed across
    #    ranks before dividing; the loss after the step must be finite,
    #    lower and identical everywhere.
    rows = rows_per_device * n_local
    x = torch.stack([
        torch.full((FEATURE_DIM,), 1.0 + se.worker_id * 0.5 + i * 0.01,
                   dtype=torch.float32)
        for i in range(rows)
    ]).to(dev)
    n_rows = world * rows
    w = torch.ones(FEATURE_DIM, dtype=torch.float32, device=dev)

    def step(w):
        y = x @ w
        sums = torch.cat([(y * y).sum()[None], 2.0 * (x.T @ y)])
        sums = all_sum(sums) / n_rows
        loss, grad = sums[0], sums[1:]
        return loss, w - 0.01 * grad

    loss, w = step(w)
    loss2, _ = step(w)
    l1, l2 = float(loss), float(loss2)
    _require(math.isfinite(l1) and math.isfinite(l2),
             f"loss not finite: {l1} {l2}")
    _require(l2 < l1, f"train step did not descend: {l1} -> {l2}")
    losses = all_gather(loss[None])
    _require(bool(torch.all(losses == losses[0])),
             f"loss disagreement: {losses.tolist()}")
    return {
        "worker": se.worker_id,
        "processes": se.num_processes,
        "local_devices": n_local,
        "global_devices": n_global,
        "psum": psum,
        "loss": l1,
        "loss_after_step": l2,
    }


if __name__ == "__main__":
    raise SystemExit(main())
