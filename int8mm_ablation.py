#!/usr/bin/env python3
"""Where the int8 matmul's kernels (tpu_dra_torch/csrc/int8mm_sm90.cu,
the prefill tile, and int8mm_gemv_sm90.cu, the decode GEMV) spend their
time, and what the prefill tile moves end to end, on one NVIDIA GPU.

    python3 int8mm_ablation.py [variants] [gemv] [generate] [prefill]

(no argument runs every phase). Phases, one JSON line each after the
card's nvidia-smi line:

1. variants — the prefill tile's source built as it is and with parts
   of its step taken out (their results are wrong; only their times
   count): no int8 -> bf16 conversion; no conversion and no raw W copy;
   the products alone (no copies and no conversion in the loop). Each is
   timed as chip_smoke.py times a kernel (time_ms: L2 flushed, host
   enqueue kept out, median of 60) at the engine bucket's gate/up
   (M=1024, K=4096, N=14336) and down (M=1024, K=14336, N=4096) shapes
   on the 256-row tile, in two rounds. This phase is a one-off tied to
   the revision of int8mm_sm90.cu it was written against: it deletes
   three lines of the source by their exact text (CONVERT, RAW_COPY,
   ``issue(t);``) and raises, building nothing, once any of them has
   changed. Its readings stand in PERF.md; a later edit of the kernel
   retires the phase rather than re-targets it.
2. gemv — the decode GEMV's source built as it is and with parts taken
   out (GEMV_VARIANTS, the same rule: exact text, wrong results, a
   changed source raises): no W copies (the ring is read as it lies),
   no int8 -> bf16 conversion (raw words into the products), no
   reduction (each warp stores its sums and leaves: no cross-warp or
   cross-CTA sum, no output), and the launch alone (every CTA leaves at
   once). Each is timed with the wrapper's plan at the five decode
   shapes (M = 8), two rounds; then the kernel as it is under other
   plans (GEMV_PLANS: two CTAs an SM, wider column blocks, larger
   clusters) beside the wrapper's; and how many clusters of each size
   the card holds at once (cudaOccupancyMaxActiveClusters).
3. generate — greedy_generate at Llama-3-8B widths (32 layers, random
   weights, b=8, prompt 256, 32 new tokens) with int8 weights and KV:
   its int8 matmuls with M > 16 on the wgmma tile ("sm90") or forced
   onto int8mm.cu's WMMA tile ("wmma", the route before it), in turns
   sm90, wmma, wmma, sm90 after one untimed call of each; wall seconds
   and tok/s of each.
4. prefill — one w8kv8 engine prefill bucket (8 rows x a 128-token
   chunk, M = 1024) at the same widths, host ms to a synchronized end,
   the routes in turns as above.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONVERT = ("      convert_w<ROWS>(base, (t + 1) % kRawStages, "
           "(t + 1) % kWBufs);\n")
RAW_COPY = "    cp_async16(raw + raw_offset(c), g, ok);\n"
# name: (old, new) line replacements of int8mm_sm90.cu.
VARIANTS = {
    "as_is": [],
    "no_conversion": [(CONVERT, "")],
    "no_conversion_no_raw_w": [(CONVERT, ""), (RAW_COPY, "    (void)g;\n")],
    "products_only": [(CONVERT, ""), ("    issue(t);\n", "")],
}


# The decode GEMV's variants: name -> (old, new) line replacements of
# int8mm_gemv_sm90.cu.
W_COPY = ("      cp_async16(stage + w_dst[j], ok ? src + j * r_stride : w, "
          "ok);\n")
CONVERSION = """      a[0] = pack_upper_halves(i8_f32_bits(u[0][q], i),
                               i8_f32_bits(u[1][q], i));
      a[1] = pack_upper_halves(i8_f32_bits(u[0][q + 2], i),
                               i8_f32_bits(u[1][q + 2], i));
      a[2] = pack_upper_halves(i8_f32_bits(u[2][q], i),
                               i8_f32_bits(u[3][q], i));
      a[3] = pack_upper_halves(i8_f32_bits(u[2][q + 2], i),
                               i8_f32_bits(u[3][q + 2], i));
"""
RAW = """      a[0] = u[0][q] ^ u[1][q];
      a[1] = u[0][q + 2] ^ u[1][q + 2];
      a[2] = u[2][q] ^ u[3][q];
      a[3] = u[2][q + 2] ^ u[3][q + 2];
"""
REDUCTION = "  __syncthreads();\n\n  // The CTA's sum of each slab"
ENTRY = "  constexpr int kRows = 8 * PLANES;  // the partial sums' rows\n"
GEMV_VARIANTS = {
    "as_is": [],
    "no_w_copy": [(W_COPY, "      (void)ok;\n")],
    "no_conversion": [(CONVERSION, RAW)],
    "no_reduction": [(REDUCTION, "  if (M > 0) return;\n" + REDUCTION)],
    "launch_only": [(ENTRY, ENTRY + "  if (M > 0) return;\n")],
}
GEMV_SHAPES = (("gate_up", 4096, 14336), ("wq_wo", 4096, 4096),
               ("wk_wv", 4096, 1024), ("down", 14336, 4096),
               ("lm_head", 4096, 128256))
# Other plans (slabs a CTA, cluster) for the kernel as it is.
GEMV_PLANS = {
    "gate_up": ((1, 2), (2, 2), (4, 4), (8, 8), (4, 8)),
    "wq_wo": ((1, 4), (1, 7), (2, 6), (2, 8)),
    "wk_wv": ((1, 4), (2, 8)),
    "down": ((1, 4), (1, 7), (2, 6), (2, 8), (4, 8)),
    "lm_head": ((4, 1), (8, 2), (2, 1)),
}


def build_variants(kernels, source="int8mm_sm90.cu", variants=VARIANTS,
                   entry="tpu_int8_matmul_sm90", n_ints=4) -> dict:
    """Each variant's C entry (``entry`` of ``source``, whose arguments
    are 4 pointers, ``n_ints`` ints and the stream), built into
    build/int8mm_ablation/."""
    out_dir = os.path.join(REPO, "build", "int8mm_ablation")
    os.makedirs(out_dir, exist_ok=True)
    src = open(os.path.join(kernels.CSRC, source)).read()
    stem = os.path.splitext(source)[0]
    procs = {}
    for name, reps in variants.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"{stem}_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
             "-o", os.path.join(out_dir, f"{stem}_{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{stem}_{name}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def variants_phase(C, kernels, Q, rates) -> dict:
    fns = build_variants(kernels)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, m, k, n in (("gate_up", 1024, 4096, 14336),
                           ("down", 1024, 14336, 4096)):
        x, w_q, w_s = C.int8mm_inputs(Q, gen, m, k, n)
        y = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")

        def call(fn):
            kernels.check(fn(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
                             y.data_ptr(), m, k, n, 256,
                             torch.cuda.current_stream().cuda_stream),
                          "variant")

        row = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                row[name].append(C.time_ms(lambda: call(fn), flush))
        out[label] = {
            "shape": f"M={m}, K={k}, N={n}, 256-row tile",
            "ms": row,
            **C.bound(k * n + n * 4 + m * k * 2 + m * n * 2, 2 * m * k * n,
                      rates),
        }
        del x, w_q, w_s, y
    return out


def gemv_phase(C, kernels, Q, I8, rates) -> dict:
    fns = build_variants(kernels, "int8mm_gemv_sm90.cu", GEMV_VARIANTS,
                         "tpu_int8_gemv_sm90", 6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    out = {}
    for label, k, n in GEMV_SHAPES:
        m = 8
        x, w_q, w_s = C.int8mm_inputs(Q, gen, m, k, n)
        y = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        plan = I8.gemv_sm90_plan(m, k, n, sms)

        def call(fn, warps_n, cluster):
            cta_steps = -(-(-(-k // 16)) // cluster)
            kernels.check(fn(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
                             y.data_ptr(), m, k, n, warps_n, cluster,
                             cta_steps,
                             torch.cuda.current_stream().cuda_stream),
                          "gemv variant")

        row = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                row[name].append(C.time_ms(
                    lambda: call(fn, plan.warps_n, plan.cluster), flush))
        plans = {}
        for warps_n, cluster in GEMV_PLANS[label]:
            ctas = cluster * -(-(-(-n // 128)) // warps_n)
            plans[f"{warps_n}x{cluster}"] = {
                "ctas": ctas, "ms": C.time_ms(
                    lambda: call(fns["as_is"], warps_n, cluster), flush)}
        out[label] = {
            "shape": f"M={m}, K={k}, N={n}",
            "plan": plan._asdict(), "ctas": plan.ctas, "ms": row,
            "other_plans": plans,
            **C.bound(k * n + n * 4 + m * k * 2 + m * n * 2, 2 * m * k * n,
                      rates),
        }
        del x, w_q, w_s, y
    # Clusters of each size the card holds at once (one plane, one slab a
    # CTA): cudaOccupancyMaxActiveClusters, through the source's entry.
    query = kernels.function("int8mm_gemv_sm90.cu",
                             "tpu_int8_gemv_sm90_max_clusters",
                             [ctypes.c_int] * 3)
    out["max_active_clusters"] = {
        f"{warps_n}_slabs": {cluster: query(1, warps_n, cluster)
                             for cluster in range(1, 9)}
        for warps_n in (1, 2, 8)}
    return out


class ForceWmma:
    """While active, the int8 matmuls that would take the wgmma tile
    take int8mm.cu's WMMA tile instead."""

    def __init__(self, I8, on: bool):
        self.I8, self.on = I8, on

    def __enter__(self):
        self.orig = self.I8._int8mm_route
        if self.on:
            self.I8._int8mm_route = lambda x, w: (
                "wmma" if self.orig(x, w) == "sm90" else self.orig(x, w))

    def __exit__(self, *exc):
        self.I8._int8mm_route = self.orig


# One untimed run of each route, then the timed ones in turns.
WARMUP = ("sm90", "wmma")
ORDER = ("sm90", "wmma", "wmma", "sm90")


def generate_phase(G, I8, kernels, cfg, params) -> dict:
    b, s, new = 8, 256, 32
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (b, s)).astype(np.int32))
    runs = []
    for i, route in enumerate(WARMUP + ORDER):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ForceWmma(I8, route == "wmma"):
            G.greedy_generate(cfg, params, prompt, new, kv_quant="int8",
                              weight_quant="int8")
        wall = time.perf_counter() - t0
        if i < len(WARMUP):
            continue
        runs.append({"route": route, "wall_seconds": wall,
                     "tok_s": b * new / wall,
                     "int8mm_sm90_launches": kernels.LAUNCHES["int8mm_sm90"]})
    return {"batch": b, "prompt": s, "new_tokens": new, "runs": runs}


def prefill_phase(E, I8, cfg, params) -> dict:
    ec = E.EngineConfig(page_size=16, max_slots=8, max_pages_per_seq=64,
                        scan_chunk=8, prefill_chunk=128, weight_quant="int8",
                        kv_quant="int8")
    eng = E.Engine(cfg, params, ec)
    rng = np.random.default_rng(0)
    runs = []
    for i, route in enumerate(WARMUP + ORDER):
        for j in range(8):
            eng.add_request(E.Request(
                rid=f"a{i}_{j}", max_new_tokens=2,
                prompt=rng.integers(1, cfg.vocab_size, 256).astype(np.int32)))
        now = eng.clock()
        eng._admit(now)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ForceWmma(I8, route == "wmma"):
            eng._prefill_tick(now)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        eng.run()
        if i >= len(WARMUP):
            runs.append({"route": route, "bucket_ms": ms})
    return {"bucket": "8 rows x 128 tokens (M = 1024)", "runs": runs}


def main() -> int:
    if not torch.cuda.is_available():
        print("int8mm_ablation: no CUDA device", file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke as C
    from tpu_dra_torch import kernels
    from tpu_dra_torch.workloads import engine as E
    from tpu_dra_torch.workloads import generate as G
    from tpu_dra_torch.workloads import quantize as Q
    from tpu_dra_torch.workloads.models.llama import LLAMA3_8B, init_params
    from tpu_dra_torch.workloads.ops import int8mm as I8

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rates = C.peaks(torch.cuda.get_device_name(0))
    phases = sys.argv[1:] or ["variants", "gemv", "generate", "prefill"]
    unknown = set(phases) - {"variants", "gemv", "generate", "prefill"}
    if unknown:
        print(f"int8mm_ablation: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    kernels.build()
    if "variants" in phases:
        C.emit("variants", **variants_phase(C, kernels, Q, rates))
    if "gemv" in phases:
        C.emit("gemv", **gemv_phase(C, kernels, Q, I8, rates))
    if {"generate", "prefill"} & set(phases):
        cfg = LLAMA3_8B
        params = init_params(cfg,
                             torch.Generator(device="cuda").manual_seed(0))
        if "generate" in phases:
            C.emit("generate", **generate_phase(G, I8, kernels, cfg, params))
        if "prefill" in phases:
            C.emit("prefill", **prefill_phase(E, I8, cfg, params))
    return 0


if __name__ == "__main__":
    sys.exit(main())
