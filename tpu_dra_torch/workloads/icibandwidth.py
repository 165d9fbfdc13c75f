"""Collective-bandwidth exerciser, the nvbandwidth analog.

Counterpart of ``tpu_dra/workloads/icibandwidth.py``, with its legs, keys
and bus-bandwidth algebra, over a ``torch.distributed`` process group
(one device a rank; :mod:`.bootstrap` builds the group from the
driver-rendered env: NCCL on the card, gloo on the CPU). It measures the
collectives a training step lives on — all-reduce, all-gather,
reduce-scatter and a one-hop ring exchange (the ring-attention and
pipeline primitive) — and fails when a leg's bus bandwidth is below a
threshold.

Bus-bandwidth normalization (the NCCL-tests algebra): every leg divides
the bytes its algorithm moves a rank by the elapsed time, so on a
balanced fabric of per-link bandwidth B each leg reports ~B and one
``--min-gbps`` gates them all: all-reduce ``2(n-1)/n * S``, all-gather
``(n-1) * S``, reduce-scatter ``(n-1)/n * S``, the ring hop ``S`` (S =
the per-rank shard, in bytes).

With one rank (no fabric) it measures the device's copy bandwidth
instead (``hbm_copy``: each rep reads and writes S once), so the same
Job spec stays meaningful on one device. NCCL puts no two ranks on one
GPU, so a single card never measures a fabric.

CLI (the Job payload):
    python -m tpu_dra_torch.workloads.icibandwidth \
        --size-mb 64 --reps 10 --min-gbps 0 [--distributed] [--device cpu]

Prints one JSON line a run; exit 1 when any leg misses ``--min-gbps``
(0 disables the gate: smoke mode).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from tpu_dra_torch.workloads.device import synchronize
from tpu_dra_torch.workloads.smoke import group_device


def fetch(y: torch.Tensor) -> float:
    """Wait for the device, then read a FULL sum on the host: every
    element stays live, and the differential timing cancels the sum's
    own cost."""
    synchronize(y.device)
    return float(torch.sum(y))


def _timed_pair(run1: Callable, run_n: Callable, x, reps: int,
                outer: int = 3) -> float:
    """Per-op seconds by DIFFERENTIAL timing: a 1-iteration loop against
    an N-iteration loop (both fetched), which cancels the dispatch and
    the fetch that would otherwise swamp a single op."""
    fetch(run1(x))
    fetch(run_n(x))

    def best(run):
        b = float("inf")
        for _ in range(outer):
            t0 = time.perf_counter()
            fetch(run(x))
            b = min(b, time.perf_counter() - t0)
        return b

    t1, tn = best(run1), best(run_n)
    per_op = (tn - t1) / (reps - 1) if reps > 1 else tn
    # Noise floor: differential timing can go epsilon-negative.
    return max(per_op, 1e-9)


def _loop(body: Callable, iters: int) -> Callable:
    def run(t):
        for _ in range(iters):
            t = body(t)
        return t

    return run


def measure_collectives(
    size_mb: float = 64.0, reps: int = 10, group=None, device=None,
) -> Dict[str, dict]:
    """Bandwidth per collective over ``group``'s ranks (default: the
    default group, when one exists), one rank a device; with one rank,
    the ``hbm_copy`` probe on ``device`` (default: the card)."""
    dev = group_device(device)
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    size_bytes = int(size_mb * 1024 * 1024)
    out: Dict[str, dict] = {
        "devices": n,
        "payload_mb": size_mb,
        "reps": reps,
    }

    if n == 1:
        # No fabric: a copy probe, read + write S each rep, in one
        # elementwise pass (b + a * v; a second op would move 4 S),
        # between two buffers allocated once.
        x = torch.zeros(size_bytes // 4, dtype=torch.float32, device=dev)
        other = torch.empty_like(x)
        bias = torch.tensor(1e-9, dtype=torch.float32, device=dev)

        def body(v):
            out = other if v is x else x
            return torch.add(bias, v, alpha=1.000001, out=out)

        dt = _timed_pair(_loop(body, 1), _loop(body, reps), x, reps)
        out["hbm_copy"] = {
            "seconds": dt,
            "gbps": 2 * size_bytes / dt / 1e9,
        }
        return out

    rank = dist.get_rank(group)
    # The per-rank shard: S bytes, a whole number of reduce-scatter
    # chunks.
    m = size_bytes // 4 // n * n
    shard = m * 4
    x = torch.zeros(m, dtype=torch.float32, device=dev)

    def peer(i: int) -> int:
        return dist.get_global_rank(group, i) if group is not None else i

    def timed(body):
        return _timed_pair(_loop(body, 1), _loop(body, reps), x, reps)

    results = {}

    # all-reduce over the per-rank buffer S: 2(n-1)S/n bytes a rank.
    # In place: x is zeros, and the mean keeps it so.
    def allreduce(t):
        dist.all_reduce(t, group=group)
        return t.mul_(1.0 / n)

    dt = timed(allreduce)
    results["psum_allreduce"] = {
        "seconds": dt,
        "busbw_gbps": 2 * (n - 1) / n * shard / dt / 1e9,
    }

    # all-gather, then this rank's shard of the result (keeps the shape
    # for the next application): each rank receives (n-1)S.
    def all_gather(t):
        g = torch.empty(n * m, dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(g, t, group=group)
        return g[rank * m:(rank + 1) * m]

    dt = timed(all_gather)
    results["all_gather"] = {
        "seconds": dt,
        "busbw_gbps": (n - 1) * shard / dt / 1e9,
    }

    # reduce-scatter of S into n chunks, tiled back to S: each rank sends
    # (n-1)S/n.
    def reduce_scatter(t):
        r = torch.empty(m // n, dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(r, t, group=group)
        return r.repeat(n)

    dt = timed(reduce_scatter)
    results["reduce_scatter"] = {
        "seconds": dt,
        "busbw_gbps": (n - 1) / n * shard / dt / 1e9,
    }

    # ring: each rank forwards its shard one hop: S over one link.
    def ring(t):
        r = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, peer((rank + 1) % n), group),
               dist.P2POp(dist.irecv, r, peer((rank - 1) % n), group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return r

    dt = timed(ring)
    results["ppermute_ring"] = {
        "seconds": dt,
        "busbw_gbps": shard / dt / 1e9,
    }

    out.update(results)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("tpu-dra-torch-collective-bandwidth")
    p.add_argument("--size-mb", type=float, default=64.0)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument(
        "--min-gbps", type=float, default=0.0,
        help="Fail when any collective's bus bandwidth is below this "
        "(0 = smoke mode: measure and pass)",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="Initialize torch.distributed from the CD-injected bootstrap "
        "env first (multi-host domains)",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA device, NCCL; 'cpu' for "
        "gloo); one rank is one device",
    )
    args = p.parse_args(argv)

    from tpu_dra_torch.workloads.bootstrap import initialize_from_env, shutdown
    from tpu_dra_torch.workloads.multiplex_client import auto_lease

    try:
        if args.distributed:
            initialize_from_env(device=args.device)
        with auto_lease():
            results = measure_collectives(args.size_mb, args.reps,
                                          device=args.device)
    finally:
        if args.distributed:
            shutdown()
    print(json.dumps(results))

    failed: Optional[str] = None
    if args.min_gbps > 0:
        for name, leg in results.items():
            if not isinstance(leg, dict):
                continue
            bw = leg.get("busbw_gbps", leg.get("gbps"))
            if bw is not None and bw < args.min_gbps:
                failed = f"{name}: {bw:.2f} GB/s < {args.min_gbps}"
                print(f"FAIL {failed}", file=sys.stderr)
    if failed:
        return 1
    print("PASS", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
