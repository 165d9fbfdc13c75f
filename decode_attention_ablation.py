#!/usr/bin/env python3
"""What the decode attention's exact head-dim builds buy, on one NVIDIA
GPU (tpu_dra_torch/csrc/decode_attention.cuh, used by paged_decode.cu
and decode.cu).

    python3 decode_attention_ablation.py [TURNS]

With bf16 q each head-dim bucket (64, 128, 256) has two builds of the
split and combine kernels: one whose head dim is the bucket, known at
compile time (``kExact``), and one that takes it at run time (the
padded head dims). Three builds of the header, both sources each: as it
is ("as_built"), every call sent to the run-time build ("runtime_hd"),
and the exact builds kept from the int8 cache ("int8_runtime"); each
variant's source text is replaced exactly (a changed source raises and
builds nothing). The wrapper is pointed at each build in turn: ORDER,
rotated by two places a turn so that over three turns each variant
takes every place, TURNS times (default 1). Rows, bf16 q, 8 rows of 512 live keys:
the paged kernel at Llama-3-8B's heads with bf16 and int8 pools, at Llama-3.2-3B's heads (kvh 8, n_rep
3) and at hd 256 (kvh 8, n_rep 2), and the contiguous kernel (max_seq
1024) at Llama-3-8B's heads with a bf16 and an int8 cache and at hd 256.
Each is timed as chip_smoke.py times a kernel (time_ms: L2 flushed,
host enqueue kept out, median of 60), with the split and combine
kernels' device µs from torch.profiler; one JSON line after the card's
nvidia-smi line.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HEADER = "decode_attention.cuh"
SOURCES = ("paged_decode.cu", "decode.cu")
EXACT = "  const bool exact = kHasExact && a.hd == HD;\n"
HAS_EXACT = ("  constexpr bool kHasExact = "
             "std::is_same<T, __nv_bfloat16>::value;\n")
# name: (old, new) replacements of decode_attention.cuh.
VARIANTS = {
    "as_built": [],
    "runtime_hd": [(EXACT, "  const bool exact = false;\n")],
    "int8_runtime": [(HAS_EXACT, "  constexpr bool kHasExact = "
                     "std::is_same<T, __nv_bfloat16>::value &&\n"
                     "      std::is_same<KV, __nv_bfloat16>::value;\n")],
}
ORDER = ("as_built", "runtime_hd", "int8_runtime", "int8_runtime",
         "runtime_hd", "as_built")


def build_variants(kernels) -> dict:
    """{variant: {source: CDLL}}, built into build/decode_attention_ablation/
    (each variant's header beside copies of both sources, the other
    headers from csrc/)."""
    header = open(os.path.join(kernels.CSRC, HEADER)).read()
    procs = {}
    for name, reps in VARIANTS.items():
        out_dir = os.path.join(REPO, "build", "decode_attention_ablation",
                               name)
        os.makedirs(out_dir, exist_ok=True)
        text = header
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in header")
            text = text.replace(old, new)
        with open(os.path.join(out_dir, HEADER), "w") as f:
            f.write(text)
        for source in SOURCES:
            src = os.path.join(out_dir, source)
            with open(src, "w") as f:
                f.write(open(os.path.join(kernels.CSRC, source)).read())
            lib = os.path.join(out_dir, source.replace(".cu", ".so"))
            procs[name, source] = (lib, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                 str(kernels.CSRC), "-o", lib, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, source), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {source}:\n"
                               f"{log[-3000:]}")
        libs.setdefault(name, {})[source] = ctypes.CDLL(lib)
    return libs


def use(kernels, libs: dict) -> None:
    """Point the wrappers at one variant's libraries."""
    with kernels._LOCK:
        kernels._LIBS.update(libs)
        for key in [k for k in kernels._FUNCS if k[0] in SOURCES]:
            del kernels._FUNCS[key]


def rows(C, A, Q, gen) -> dict:
    """label: the call of each timing row."""
    out = {}
    for label, kvh, n_rep, hd in (("8b", 8, 4, 128), ("3b", 8, 3, 128),
                                  ("hd256", 8, 2, 256)):
        lengths = [512] * 8
        q, kp, vp, tables, lens = C.paged_inputs(gen, lengths, kvh=kvh,
                                                 n_rep=n_rep, hd=hd)
        out[f"paged_{label}"] = functools.partial(
            A.paged_decode_attention, q, kp, vp, tables, lens, impl="cuda")
        if label == "8b":
            kq, vq, sc = C.int8_pools(Q, kp, vp)
            out["paged_8b_int8"] = functools.partial(
                A.paged_decode_attention, q, kq, vq, tables, lens, **sc,
                impl="cuda")
        if label != "3b":
            q, k, v, _ = C.contiguous_inputs(Q, gen, n_rep=n_rep, hd=hd)
            out[f"contiguous_{label}"] = functools.partial(
                A.decode_attention, q, k, v, 512, impl="cuda")
        if label == "8b":
            q, k, v, sc = C.contiguous_inputs(Q, gen, n_rep=n_rep, hd=hd,
                                              int8=True)
            out["contiguous_8b_int8"] = functools.partial(
                A.decode_attention, q, k, v, 512, **sc, impl="cuda")
    return out


def main(turns: int = 1) -> int:
    if not torch.cuda.is_available():
        print("decode_attention_ablation: no CUDA device", file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke as C
    from tpu_dra_torch import kernels
    from tpu_dra_torch.workloads import quantize as Q
    from tpu_dra_torch.workloads.ops import attention as A

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    libs = build_variants(kernels)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    calls = rows(C, A, Q, gen)
    ms = {label: {name: [] for name in VARIANTS} for label in calls}
    us = {label: {} for label in calls}
    order = [name for t in range(turns)
             for name in ORDER[2 * t % 6:] + ORDER[:2 * t % 6]]
    for name in order:
        use(kernels, libs[name])
        for label, call in calls.items():
            ms[label][name].append(C.time_ms(call, flush))
            if name not in us[label]:
                us[label][name] = C.body_profile(call, flush)
    C.emit("exact_builds", order=order, ms=ms, kernels_us=us)
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:2])))
