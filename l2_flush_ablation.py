#!/usr/bin/env python3
"""How the way chip_smoke.py clears the L2 moves its kernel times, on one
NVIDIA GPU.

    python3 l2_flush_ablation.py

Before each timed call, chip_smoke.py's ``time_ms`` evicts the call's
inputs from the 50 MB L2 through a 64 MB buffer: by writing it
(``evict_by_writing``, which leaves the L2 full of dirty lines that a
timed read must write back as it evicts them) or by reading it
(``evict_by_reading``, which leaves only clean lines). This script times
three rows of chip_smoke.py's timing phase, at its shapes, under each,
in turns (writing, reading, reading, writing) over ROUNDS rounds:

- paged decode attention, bf16 pools, B = 8 slots of 512 keys;
- the fused decode MLP, B = 8, d 4096, ffn 14336, bf16;
- the int8 matmul's decode GEMV, M = 8, K 4096, N 14336 (gate/up).

Each is ``time_ms`` as chip_smoke.py runs it (median of 60 single
calls, the host's enqueue kept out of the interval). One JSON line a
row after the card's nvidia-smi line: every median by eviction, each
eviction's spread (largest median less smallest), the move (reading's
median of medians less writing's) and whether it exceeds the larger
spread.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("l2_flush_ablation: no CUDA device", file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke as C
    from tpu_dra_torch.workloads import quantize as Q
    from tpu_dra_torch.workloads.ops import attention as A
    from tpu_dra_torch.workloads.ops import decode_mlp as DM
    from tpu_dra_torch.workloads.ops import int8mm as I8

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    q, kp, vp, tables, lens = C.paged_inputs(gen, [512] * 8)
    x, scale, tree = C.mlp_inputs(gen, 8)
    xm, w_q, w_s = C.int8mm_inputs(Q, gen, 8, 4096, 14336)
    rows = {
        "paged_decode_attention": functools.partial(
            A.paged_decode_attention, q, kp, vp, tables, lens, impl="cuda"),
        "decode_mlp": functools.partial(
            DM.decode_mlp, x, scale, tree, 1e-5, impl="cuda"),
        "int8mm_gemv_m8_gate_up": functools.partial(
            I8.int8_matmul, xm, w_q, w_s, impl="cuda"),
    }
    evictions = {"writing": C.evict_by_writing, "reading": C.evict_by_reading}
    flush = torch.zeros(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    medians = {row: {mode: [] for mode in evictions} for row in rows}
    for _ in range(ROUNDS):
        for mode in ("writing", "reading", "reading", "writing"):
            for row, call in rows.items():
                medians[row][mode].append(
                    C.time_ms(call, flush, evict=evictions[mode]))
    for row, by_mode in medians.items():
        spread = {m: max(v) - min(v) for m, v in by_mode.items()}
        center = {m: statistics.median(v) for m, v in by_mode.items()}
        move = center["reading"] - center["writing"]
        print(json.dumps({
            "row": row, "ms": by_mode, "median_ms": center,
            "spread_ms": spread, "move_ms": move,
            "move_over_writing": move / center["writing"],
            "moves_beyond_spread": abs(move) > max(spread.values()),
            "nvidia_smi": smi,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
