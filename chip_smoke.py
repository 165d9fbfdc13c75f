#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_dra_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without a result:

1. device  — needs CUDA (else exits 1 at once); prints the card's name
   and power limit as nvidia-smi reports them; TF32 off.
2. build   — builds every kernel from tpu_dra_torch/csrc with nvcc
   (one process per source, in parallel) into build/torch_kernels/;
   prints each instantiation's registers, shared memory and spills, and
   for the wgmma kernels (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu,
   flash_bwd_sm90.cu, int8mm_sm90.cu) the dynamic shared memory a CTA
   asks for; every instantiation of the wgmma kernels, of the decode
   bodies (decode_split_kernel, decode_combine_kernel in paged_decode.cu
   and decode.cu), of the tensor-core int8 GEMV
   (int8mm_gemv_sm90.cu, both planes) and of the tensor-core decode MLP
   (decode_mlp_sm90.cu: gate/up and down, both planes) must spill 0
   bytes.
3. parity  — each kernel against its plain PyTorch version and the fp32
   reference, in bf16 at Llama-3-8B widths (h=32, kvh=8, hd=128,
   d=4096, ffn=14336, vocab 128256): paged decode with B=8, page 16,
   513 pages and lengths [0,1,15,16,17,255,512,1000], then lengths on
   the split boundaries and at the capacity [63,64,65,127,128,129,1023,
   1024], then one slot of 8192 keys, with bf16 pools and with int8
   pools; decode MLP with B in {1, 8, 13, 16}, each on the tensor-core
   route (sm90, decode_mlp_sm90.cu, with its plan; reruns
   bit-identical), and decode_mlp.cu (the simt route: fp32 and B > 16)
   launched directly at fp32 B = 8 and bf16 B = 32, against the plain
   version on the same inputs; the int8 matmul at
   M in {1, 8, 1024} for (K, N) in {(4096, 14336), (14336, 4096),
   (4096, 1024), (4096, 128256)}, at M in {17, 129, 2048} for
   4096 x 14336, wq/wo's 4096 x 4096 at M in {1024, 2048}, the
   lm_head at M = 2048 and M in {2, 13, 16} for 4096 x 14336
   (INT8MM_PARITY), with an all-zero weight column, each row naming its
   route (gemv_sm90, the tensor-core GEMV, which every row with M <= 16
   must take, with its plan; sm90, the wgmma tile, which every bf16 row
   with M > 16 must take); each row with M <= 16 also holds int8mm.cu's
   weight-streaming GEMV, which still serves fp32 and the shapes the new
   one does not take, on the same inputs (zero column, reruns
   bit-identical); each row with M > 16 also holds int8mm.cu's WMMA tile,
   which serves the bf16 shapes the wgmma tile does not take, on the
   same inputs (zero column, reruns bit-identical); the
   contiguous decode, bf16 and int8 caches, b=8, max_seq 1024, lengths
   {1, 63, 64, 65, 129, 255, 256, 257, 1000}, and b=1 with 8192 keys
   (the decode kernels split the keys over CTAs: at fp32 each is held
   to the plain split form with the kernel's split plan, and reruns
   are bit-identical); the three flash kernels (forward, dQ,
   dK/dV) at b=2, h=32, kvh=8, hd=128 for s=2048 causal and non-causal,
   ragged s=1000 causal and suffix queries sq=512 over skv=2048 (with a
   non-zero lse cotangent folded into delta), each against its plain
   version on the same inputs, bf16 and fp32, reruns bit-identical;
   each case names the forward's, the dQ and the dK/dV kernel's routes
   (sm90: the wgmma kernels for bf16 at hd 64/128, which every bf16 case
   must take; wmma: flash_attention.cu's kernels, fp32 here).
   Tolerance: rtol 2e-2 plus, per row (one head of one slot or token,
   one token of the MLP, one output row of the matmul), an atol of two
   bf16 ulps of that row's largest |reference| value. At fp32 each new
   kernel matches its plain version within 1e-5 of the output's largest
   magnitude (the flash lse too); the flash gradients within 1e-4, as
   they sum up to n_rep * s rows in another order.
4. timing  — CUDA events around single launches after warm-up, L2
   flushed before each, median of 60, the host's enqueue time kept out
   of the interval (time_ms): kernel, plain version, and the least time
   the card could take (bytes over the memory rate vs operations over
   the bf16 peak, whichever is larger). Each kernel also has
   ``ms_with_host``, timed with the wrapper's host time included. The
   decode MLP at B = 8 on the tensor-core kernel, with decode_mlp.cu (the
   kernel it replaced on this route) on the same inputs, each pass's
   device time from torch.profiler, and as the library yardstick a chain
   of PyTorch library calls for the same block (rms_norm, three cuBLAS
   GEMMs, silu, mul, add: a chain, not one call). The flash kernels at b=2, s=2048, causal, bf16, with SDPA's forward and
   its backward (the dQ + dK/dV pair) as the library yardsticks, each
   with achieved TFLOP/s and share of the bound; each flash row also
   times the WMMA kernel it replaced, on the same inputs, and the dK/dV
   row the pair's time (dQ + dK/dV) beside SDPA's backward. The int8
   contiguous-decode row times SDPA over the live K/V dequantized to
   bf16 as its yardstick (no PyTorch call takes the int8 cache). The
   int8 matmul's tensor-core GEMV at every decode shape (M = 8), each
   row asserted to take it, with its plan, share of the bound and
   int8mm.cu's GEMV on the same inputs (old_gemv_ms), and its wgmma tile
   at each prefill shape (INT8MM_PREFILL_TIMING:
   every projection at the engine bucket's M = 1024, the lm_head at the
   generate prefill's M = 2048), each row asserted to take the wgmma
   tile, with the WMMA tile it replaced on the same inputs (its output
   held against the plain version), a bf16 matmul on a dequantized copy
   as the yardstick,
   TFLOP/s and share of the bound. The
   decode rows print their split plan (splits, CTAs), and two long
   rows time one 8192-key sequence (decode_attention_long,
   paged_decode_attention_long), each with its SDPA yardstick.
4b. sampling — the fused pick (csrc/sample.cu) at [8, 128256] fp32,
   seeded logits and a copy rounded through bf16 (ties at the top),
   for (temperature, top_k) in PICK_CASES and both key layouts (the
   engine's per-row (seed, serial, position) keys, sample_generate's
   one folded key for the block): the kernel, its plain version on the
   card and the plain version on the CPU draw identical tokens over
   identical candidates; the plain jax.random twins give the same
   Threefry bits and uniforms on the card as on the CPU and Gumbel
   values within 2 ulps of max(|g|, 1); topk_exact agrees; the pick's
   time beside its bound, the plain pick and argmax.
5. tiny    — fp32 TINY_LLAMA on the card (kernels) and on the CPU
   (plain versions): the bf16-config engine agrees on >= 0.97 of the
   tokens; the w8+kv8 engine and greedy_generate in all four
   (kv_quant, weight_quant) combinations give identical tokens; the
   twin config of tests/test_torch_train.py (dim 256, 2 layers, hd 64,
   fp32) trains 3 steps with the same losses within 1e-5 relative.
6. engine  — Llama-3-8B widths, all 32 layers, vocab 128256, bf16,
   random weights from a seeded CUDA generator; 8 seeded requests
   (prompts 64-512, 32-64 new tokens) through the paged engine. Every
   request completes with its token count, the allocator ends
   leak-free, and both bf16 kernels launch once per layer per decode
   step, every decode MLP on the tensor-core route; a profile of steady
   decode names the decode attention's split and combine kernels' and
   the decode MLP's kernels' device ms per step (the MLP: the two passes
   of decode_mlp_sm90.cu, one launch each per layer per step, and none
   of decode_mlp.cu's) and the MLP's share of the step's device time.
   Then, with all 8 slots
   decoding the same prompts, one decode
   step runs from one state with kernels, plain versions, fp32
   reference versions and each kernel alone (STEP_VARIANTS): with fp32
   weights every pair's logits agree above cosine 0.9999; in bf16 see
   step_gates. The same step with the depth cut to 2 layers, in bf16,
   holds every pair above 0.999.
7. engine_w8kv8 — the same requests with weight_quant="int8" and
   kv_quant="int8": every request completes, the allocator ends
   leak-free with every pool (scales included) zero; per decode step
   225 int8 matmul launches (7 projections x 32 layers + the lm_head),
   every launch with M > 16 (the prefill projections) on the wgmma tile
   and every other on the tensor-core GEMV (int8mm.cu's GEMV never), 32
   paged-decode launches on int8 pools and no fused-MLP launch; a
   profile of its steady decode as for the bf16 engine, with the int8
   matmul's device ms and launches a step (225, all the tensor-core
   GEMV's: one launch a call), and of one prefill bucket (8 rows x a
   128-token chunk, M = 1024) by kernel with the int8 matmul's share.
   The one-state
   decode-step check with W8_STEP_VARIANTS, at bf16, fp32 activations
   and bf16 cut to 2 layers.
7b. engine_sampled — the engine phase's config and requests with
   temperature 0.8, top_k 40, sample_seed 11: fused is token-identical
   to fused=False, contiguous=True; paged-decode and tensor-core MLP
   launches as greedy's, sample_pick one a decode step plus one a
   finishing prefill row; a decode step at most 16 launches above the
   greedy step's (profile); decode tok/s and TTFT beside greedy's. The
   tiny fp32 sampled engine is token-identical on the card and the CPU.
7c. engine_spec — spec_k 4: the tiny fp32 spec engine (greedy, sampled,
   and both under w8kv8, n-gram drafts on lookup-friendly prompts) is
   token-identical to its fused=False, contiguous=True oracle on the
   card (else the first differing position and its top-2 logit gap),
   its pool whole and zero; at 8B widths (bf16, 32 layers) with the
   n-gram draft and a replay of the greedy run's tokens: proposed,
   accepted, decode tok/s against the non-spec engine and token
   agreement with it (no identity gate: the verify pass runs the plain
   attention and MLP chain, the per-token step the kernels); w8kv8 with
   the n-gram draft, every verify-pass matmul (M = 40) on the wgmma tile.
8. generate — greedy_generate at the same widths, b=8, prompt 256, 32
   new tokens, once in bf16 and once with int8 weights and KV: 32
   contiguous-decode launches per decode step, and 32 fused-MLP (bf16,
   all on the tensor-core route) or 225 int8 matmul (w8kv8) launches per
   step; the w8kv8 prefill's
   225 (M = 2048, the lm_head over every position) all on the wgmma
   tile, the decode steps' all on the tensor-core GEMV.
9. train   — the Trainer at Llama-3-8B widths cut to 4 layers, bf16,
   remat "nothing", TrainConfig() defaults, b=2, s=2048, 5 steps on one
   seeded batch: the loss is finite and falls, and every step launches
   exactly 2L flash forwards (the remat recompute is the second), L dQ
   and L dK/dV, all on the wgmma route; step ms, trained tok/s, MFU,
   peak memory and the flash forward's, dQ's and dK/dV's device ms in a
   profiled step.
   Then one step's loss and gradients from the initial weights, kernels
   against the plain versions (attention_impl="torch"): at fp32 with 2
   layers the loss within 1e-5 relative and every gradient leaf above
   cosine 0.99999; in bf16 each leaf's gap (1 - cosine) to an fp32
   reference at most BF16_GAP_RATIO times the plain version's (gaps
   under 1e-5 count as equal).

The line before last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks (NVIDIA data sheets), keyed by a substring of the
# name nvidia-smi reports: (memory bytes/s, dense bf16 flop/s, fp32
# flop/s outside the tensor cores).
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),  # SXM: "NVIDIA H100 80GB HBM3"
}
TIMING_ITERS = 60
# ~1 ms of device sleep at the H100's clocks: longer than any timed call
# takes on the host to enqueue its launches (time_ms).
HOST_SHIELD_CYCLES = 2_000_000
BF16_RTOL = 2e-2
FP32_REL = 1e-5
# Bars for the decode-step logits of the STEP_VARIANTS (step_gates).
FP32_COSINE = 0.9999
BF16_COSINE = 0.999
BF16_GAP_RATIO = 1.5
# Llama-3-8B: 7 int8 projections per layer (q, k, v, o, gate, up,
# down) plus the lm_head.
INT8MM_PER_LAYER = 7
# Flash gradients at fp32: up to n_rep * s rows summed in another order.
FP32_GRAD_REL = 1e-4
# Train-step gradients: fp32 leaf cosine bar; bf16 gaps below this
# count as equal (it is the fp32 bar's gap).
TRAIN_FP32_COSINE = 0.99999
TRAIN_GAP_FLOOR = 1e-5
FLASH_CASES = (
    # name, sq, skv, causal, lse cotangent
    ("s2048_causal", 2048, 2048, True, False),
    ("s2048_noncausal", 2048, 2048, False, False),
    ("s1000_causal", 1000, 1000, True, False),
    ("suffix_512_of_2048", 512, 2048, True, True),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bf16_row_atol(ref: torch.Tensor, atol_floor: float = 0.0):
    """Per-row atol for a bf16 result against the fp32 reference: two
    bf16 ulps of each row's own largest |reference| value (a row is the
    last axis: one head of one slot or token, one token of the MLP, one
    output row of a matmul), so a row of small values is held to its own
    scale. A row of zeros must come out exactly zero, unless the caller
    gives ``atol_floor``: the atol of a gradient row is never below it,
    since a gradient element carries the absolute error of the sums that
    produce it however small it is (dQ of the first causal rows is
    dP - delta, two sums that cancel)."""
    top = ref.float().abs().amax(dim=-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    atol = torch.where(top > 0, 2 * ulp, torch.zeros_like(top))
    return torch.clamp(atol, min=atol_floor)


def compare(name: str, got, ref, rtol: float = BF16_RTOL,
            atol_floor: float = 0.0) -> dict:
    """Every element within its row's atol plus rtol * |ref|."""
    got, ref = got.float(), ref.float()
    atol = bf16_row_atol(ref, atol_floor)
    err = (got - ref).abs()
    limit = atol + rtol * ref.abs()
    over = torch.where(limit > 0, err / limit,
                       torch.where(err > 0, torch.inf, 0.0))
    out = {
        "max_abs_err": float(err.max()),
        "max_rel_err": float((err / ref.abs().clamp(min=1e-6)).max()),
        "worst_err_over_limit": float(over.max()),
        "row_atol_range": [float(atol.min()), float(atol.max())],
        "rtol": rtol,
    }
    if out["worst_err_over_limit"] > 1:
        raise AssertionError(
            f"{name}: {int((over > 1).sum())} elements outside two bf16 "
            f"ulps of their row's max |ref| plus rtol {rtol}; {out}"
        )
    return out


def compare_fp32(name: str, got, ref, rel: float = FP32_REL) -> dict:
    """fp32 kernel vs its plain version: the same arithmetic in another
    summation order, so every element within ``rel`` (FP32_REL) of the
    output's largest magnitude (a matmul over K = 14336 accumulates
    rounding error of that order relative to its outputs)."""
    err = float((got.float() - ref.float()).abs().max())
    top = max(float(ref.float().abs().max()), 1e-30)
    out = {"max_abs_err": err, "max_err_over_max_ref": err / top}
    if err > rel * top:
        raise AssertionError(f"{name} at fp32: {out} (bar {rel})")
    return out


def short_name(fn: str) -> str:
    """A demangled kernel name without namespaces and arguments."""
    for ns in ("(anonymous namespace)::", "tpu_dra::attention::",
               "tpu_dra::", "void "):
        fn = fn.replace(ns, "")
    return fn.split("(")[0]


def time_ms(fn, flush: torch.Tensor, shield: bool = True) -> float:
    """Median device time of one call of ``fn`` between CUDA events,
    the L2 flushed before each. With ``shield`` the stream first sleeps
    for HOST_SHIELD_CYCLES, so the host enqueues the call's launches
    (wrapper checks, allocations, ctypes) while the device is still
    busy and the interval holds device work only; without it the
    wrapper's host time falls inside the interval whenever it exceeds
    the kernel's. A call that syncs with the host
    inside (the plain paged walk reads its longest length) is host
    bound either way."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(TIMING_ITERS):
        flush.zero_()  # evict the inputs from the 50 MB L2
        if shield:
            torch.cuda._sleep(HOST_SHIELD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def yardstick_ms(fn, flush) -> "float | str":
    """Time a PyTorch call kept only as a yardstick; a refusal records
    why it is absent instead of failing the run."""
    try:
        return time_ms(fn, flush)
    except RuntimeError as e:
        return f"not measured: {e}"[:200]


def peaks(name: str) -> tuple:
    for key, rates in PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peaks for {name!r}")


def bound(nbytes: float, flops: float, rates: tuple) -> dict:
    """The least time the card could take: bytes over the memory rate
    or operations over the bf16 peak, whichever is larger."""
    t_bytes, t_ops = nbytes / rates[0] * 1e3, flops / rates[1] * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }


def paged_inputs(gen, lengths, page=16, num_pages=513, kvh=8, n_rep=4,
                 hd=128):
    b = len(lengths)
    max_pages = (num_pages - 1) // b
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    tables = perm.reshape(b, max_pages).to(torch.int32).contiguous()
    bf = torch.bfloat16
    q = torch.randn(b, kvh * n_rep, hd, generator=gen, device="cuda").to(bf)
    kp = torch.randn(num_pages, page, kvh, hd, generator=gen,
                     device="cuda").to(bf)
    vp = torch.randn(num_pages, page, kvh, hd, generator=gen,
                     device="cuda").to(bf)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens


def int8_pools(Q, kp, vp) -> tuple:
    """bf16 pools -> (int8 k, int8 v, {"k_scale", "v_scale"})."""
    (kq, ks), (vq, vs) = Q.quantize_kv(kp), Q.quantize_kv(vp)
    return kq, vq, {"k_scale": ks, "v_scale": vs}


def mlp_inputs(gen, b, d=4096, ffn=14336):
    bf = torch.bfloat16
    x = torch.randn(b, d, generator=gen, device="cuda").to(bf)
    scale = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(bf)

    def w(*shape):
        return torch.empty(shape, dtype=bf, device="cuda").normal_(
            0.0, 0.02, generator=gen
        )

    tree = {
        "w_gate": {"kernel": w(d, ffn)},
        "w_up": {"kernel": w(d, ffn)},
        "w_down": {"kernel": w(ffn, d)},
    }
    return x, scale, tree


def mlp_weights(tree) -> tuple:
    return tuple(tree[n]["kernel"] for n in ("w_gate", "w_up", "w_down"))


def mlp_library_chain(x, scale, tree, eps=1e-5):
    """The decode MLP block as a chain of PyTorch library calls (the
    timing yardstick; the port never runs it): rms_norm, three cuBLAS
    GEMMs, silu, mul and the residual add."""
    wg, wu, wd = mlp_weights(tree)
    h = torch.nn.functional.rms_norm(x, (x.shape[-1],), scale, eps)
    return x + (torch.nn.functional.silu(h @ wg) * (h @ wu)) @ wd


def int8mm_inputs(Q, gen, m, k, n, dtype=torch.bfloat16, zero_col=None):
    """x [m, k] and one int8 weight [k, n] quantized from normal(0.02)
    (an all-zero column at ``zero_col``)."""
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = torch.empty(k, n, device="cuda").normal_(0.0, 0.02, generator=gen)
    if zero_col is not None:
        w[:, zero_col] = 0.0
    q = Q.quantize_weight(w)
    del w
    return x, q["kernel_q"], q["scale"]


# The int8 matmul's parity rows (M, K, N): decode (M <= 16, the GEMV)
# and prefill (the wgmma tile in bf16) at every projection's shape, the
# tile's edges at M = 17 and 129, wq/wo (4096 x 4096, the 256-row tile
# at both prefill M) and the generate prefill's M = 2048 with the
# lm_head over every position; the GEMV at M = 2, 13 and 16 too (one
# plane of 8 rows of x, two planes, the most rows).
INT8MM_PARITY = tuple(
    (m, k, n)
    for k, n in ((4096, 14336), (14336, 4096), (4096, 1024), (4096, 128256))
    for m in (1, 8, 1024)
) + ((17, 4096, 14336), (129, 4096, 14336), (2048, 4096, 14336),
     (1024, 4096, 4096), (2048, 4096, 4096), (2048, 4096, 128256),
     (2, 4096, 14336), (13, 4096, 14336), (16, 4096, 14336))
# The prefill timing rows: each projection at the engine bucket's M and
# the lm_head at the generate prefill's (label, M, K, N).
INT8MM_PREFILL_TIMING = (
    ("int8mm_prefill", 1024, 4096, 14336),  # gate, up
    ("int8mm_prefill_wq", 1024, 4096, 4096),  # wq, wo
    ("int8mm_prefill_wk", 1024, 4096, 1024),  # wk, wv
    ("int8mm_prefill_down", 1024, 14336, 4096),
    ("int8mm_prefill_lm_head", 2048, 4096, 128256),
)
# Kernel names of the int8 matmul, both sources.
INT8MM_KERNELS = ("int8_matmul_sm90_kernel", "int8_gemv_sm90_kernel",
                  "gemv_kernel", "finish_kernel", "mma_bf16_kernel",
                  "sgemm_kernel")


def int8mm_wmma(kernels, I8, x, w_q, w_s):
    """int8mm.cu's WMMA tile on x, w_q, w_s, launched directly (not
    counted in LAUNCHES): it served every bf16 M > 16 product before
    int8mm_sm90.cu and still serves the bf16 shapes that tile does not
    take, so parity holds it at the prefill shapes and timing sets its
    time beside the new tile's."""
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    kernels.check(kernels.function(
        "int8mm.cu", "tpu_int8_matmul", I8._INT8MM_ARGTYPES)(
        x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), out.data_ptr(), None,
        1, m, k, n, 1, 16, 1, 1, torch.cuda.current_stream().cuda_stream),
        "int8mm wmma")
    return out


def int8mm_gemv(kernels, I8, x, w_q, w_s):
    """int8mm.cu's weight-streaming GEMV on x, w_q, w_s (M <= 16),
    launched directly with the wrapper's plan (not counted in LAUNCHES):
    it served every decode product before int8mm_gemv_sm90.cu and still
    serves fp32 and the shapes that kernel does not take, so parity holds
    it at the decode shapes and timing sets its time beside the new
    kernel's."""
    m, k = x.shape
    n = w_q.shape[1]
    rows_tile, vec, splits = I8._gemv_plan(m, k, n, w_q.data_ptr(),
                                           x.device)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    partial = (torch.empty(splits, m, n, dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    kernels.check(kernels.function(
        "int8mm.cu", "tpu_int8_matmul", I8._INT8MM_ARGTYPES)(
        x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        I8._DTYPE_CODES[x.dtype], m, k, n, rows_tile, vec, splits,
        int(k % 8 == 0 and x.data_ptr() % 16 == 0),
        torch.cuda.current_stream().cuda_stream), "int8mm gemv")
    return out


class RouteLog:
    """Records (M, route) of every int8 matmul launch while active, by
    wrapping ``int8mm._int8mm_route``, which the wrapper calls once
    before each launch."""

    def __init__(self, I8):
        self.I8, self.calls = I8, []

    def __enter__(self):
        self.orig = self.I8._int8mm_route

        def traced(x, w_q):
            route = self.orig(x, w_q)
            self.calls.append((x.shape[0], route))
            return route

        self.I8._int8mm_route = traced
        return self

    def __exit__(self, *exc):
        self.I8._int8mm_route = self.orig

    def check(self, name: str) -> dict:
        """Every launch with M > 16 took the wgmma tile and every other
        the tensor-core GEMV (all bf16 here); returns launches by route
        and the M values seen."""
        wrong = [(m, r) for m, r in self.calls
                 if r != ("sm90" if m > 16 else "gemv_sm90")]
        if wrong:
            raise AssertionError(f"{name}: int8 matmul routes {wrong[:8]}")
        routes = {}
        for m, r in self.calls:
            routes[r] = routes.get(r, 0) + 1
        return {"launches_by_route": routes,
                "prefill_m": sorted({m for m, _ in self.calls if m > 16})}


def int8mm_prefill_timing(kernels, I8, Q, gen, rates, flush) -> dict:
    """The wgmma tile at each prefill shape (INT8MM_PREFILL_TIMING):
    kernel, the WMMA tile it replaced on the same inputs, the plain
    version, a bf16 matmul on a copy dequantized ahead (the yardstick: no
    PyTorch call takes int8 weights with per-column scales), bound,
    achieved TFLOP/s and share of the bound."""
    rows = {}
    for label, m, k, n in INT8MM_PREFILL_TIMING:
        x, w_q, w_s = int8mm_inputs(Q, gen, m, k, n)
        nbytes = k * n + n * 4 + m * k * 2 + m * n * 2
        flops = 2 * m * k * n
        route = I8._int8mm_route(x, w_q)
        if route != "sm90":
            raise AssertionError(f"{label}: route {route}, want sm90")
        call = functools.partial(I8.int8_matmul, x, w_q, w_s, impl="cuda")
        w_bf = (w_q.float() * w_s).to(torch.bfloat16)
        wmma_vs_plain = compare(
            f"{label} wmma vs plain", int8mm_wmma(kernels, I8, x, w_q, w_s),
            I8.int8_matmul(x, w_q, w_s, impl="torch"))
        row = {
            "shape": f"M={m}, K={k}, N={n}, bf16 x, int8 W",
            "route": route,
            "tile_rows": I8._sm90_rows(m, n, x.device),
            "ms": time_ms(call, flush),
            "ms_with_host": time_ms(call, flush, shield=False),
            "wmma_kernel_ms": time_ms(functools.partial(
                int8mm_wmma, kernels, I8, x, w_q, w_s), flush),
            "plain_ms": time_ms(
                lambda: I8.int8_matmul(x, w_q, w_s, impl="torch"), flush),
            "library_ms": None,
            "dequantized_bf16_matmul_ms": yardstick_ms(lambda: x @ w_bf,
                                                       flush),
            **bound(nbytes, flops, rates),
        }
        row["tflops"] = flops / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["wmma_over_kernel"] = row["wmma_kernel_ms"] / row["ms"]
        row["plain_over_kernel"] = row["plain_ms"] / row["ms"]
        row["wmma_vs_plain"] = wmma_vs_plain
        rows[label] = row
        del x, w_q, w_s, w_bf
    return rows


def profile_prefill(E, I8, eng, prompts) -> dict:
    """One prefill bucket of ``eng`` under torch.profiler: the prompts
    are admitted and one ``_prefill_tick`` runs alone (no decode chunk).
    Device ms by kernel, the int8 matmul's share, the device busy share
    of the host window, and the bucket's M; the engine then finishes the
    requests."""
    from torch.profiler import ProfilerActivity, profile

    for i, p in enumerate(prompts):
        eng.add_request(E.Request(rid=f"pre{i}", prompt=p, max_new_tokens=4))
    now = eng.clock()
    eng._admit(now)
    torch.cuda.synchronize()
    with RouteLog(I8) as log, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._prefill_tick(now)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
    kernels_ = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels_.append((ev.self_device_time_total, ev.count, ev.key))
    if not kernels_:
        return {"device_busy_share": "not measured",
                "reason": "profiler recorded no device time"}
    kernels_.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels_) / 1e3
    int8mm = [(us, n, key) for us, n, key in kernels_
              if any(name in key for name in INT8MM_KERNELS)]
    int8mm_ms = sum(k[0] for k in int8mm) / 1e3
    return {
        "bucket_m": sorted({m for m, _ in log.calls}),
        "routes": log.check("prefill bucket")["launches_by_route"],
        "window_ms": window_ms, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        "kernel_launches": sum(k[1] for k in kernels_),
        "int8mm_device_ms": int8mm_ms,
        "int8mm_share_of_device_time": int8mm_ms / device_ms,
        "int8mm_kernels": [
            {"name": short_name(key)[:60], "device_ms": us / 1e3, "count": n}
            for us, n, key in int8mm],
        "top_kernels": [{"name": key[:90], "device_ms": us / 1e3, "count": n}
                        for us, n, key in kernels_[:12]],
    }


def contiguous_inputs(Q, gen, b=8, max_seq=1024, kvh=8, n_rep=4, hd=128,
                      dtype=torch.bfloat16, int8=False):
    q = torch.randn(b, kvh * n_rep, hd, generator=gen, device="cuda")
    k = torch.randn(b, max_seq, kvh, hd, generator=gen, device="cuda")
    v = torch.randn(b, max_seq, kvh, hd, generator=gen, device="cuda")
    if int8:
        (k, ks), (v, vs) = Q.quantize_kv(k), Q.quantize_kv(v)
        return q.to(dtype), k, v, {"k_scale": ks, "v_scale": vs}
    return q.to(dtype), k.to(dtype), v.to(dtype), {}


# The decode step is run once per variant: (paged_decode_impl,
# decode_mlp_impl, int8 matmul impl), "auto" being the kernel on the
# card. STEP_VARIANTS serve plain weights (the int8 impl is unused);
# W8_STEP_VARIANTS serve int8 weights, whose MLP is the plain chain of
# int8 matmuls under every decode_mlp impl but "reference".
STEP_VARIANTS = {
    "kernels": ("auto", "auto", "auto"),
    "torch": ("torch", "torch", "torch"),
    "reference": ("reference", "reference", "reference"),
    "attn_kernel": ("auto", "torch", "torch"),
    "mlp_kernel": ("torch", "auto", "torch"),
}
W8_STEP_VARIANTS = {
    "kernels": ("auto", "auto", "auto"),
    "torch": ("torch", "torch", "torch"),
    "reference": ("reference", "reference", "reference"),
    "attn_kernel": ("auto", "torch", "torch"),
    "int8mm_kernel": ("torch", "torch", "auto"),
}


def step_logits(E, I8, cfg, eng, prompts, variants) -> dict:
    """Admit ``prompts`` into ``eng`` and step until every slot decodes,
    then run one ``_decode_step`` from that state once per variant and
    compare the logits row by row (cosine, worst row): each variant
    against "torch", and "torch" against "reference". The engine then
    finishes its requests."""
    for i, p in enumerate(prompts):
        eng.add_request(E.Request(rid=f"cos{i}", prompt=p, max_new_tokens=64))
    while eng._prefilling or eng._queue:
        eng.step()
    if not eng._active.all():
        raise AssertionError(
            f"compared step needs every slot live: {eng._active.tolist()}")
    # The page for position `lengths` must exist, as _decode_tick makes
    # sure before every chunk: an unmapped table entry is the scratch
    # page, where the inactive slots' writes land too.
    for slot, seq in enumerate(eng._slots):
        eng._ensure_pages(seq, int(eng._lengths[slot]) + 1)
    state = [torch.tensor(a, device=eng.device) for a in (
        eng._tables, eng._lengths, eng._last_tokens, eng._active)]
    lengths = eng._lengths.tolist()
    logits = {}
    try:
        for name, (paged, mlp, mm) in variants.items():
            c = dataclasses.replace(
                cfg, paged_decode_impl=paged, decode_mlp_impl=mlp)
            I8.MM_IMPL = mm
            logits[name] = E._decode_step(c, eng.params, eng.cache, *state)[2]
    finally:
        I8.MM_IMPL = "auto"
    eng.run()

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(
            logits[a], logits[b], dim=-1).min().item()

    pairs = [("kernels", "torch"), ("kernels", "reference"),
             ("torch", "reference")] + [
        (v, "torch") for v in variants
        if v not in ("kernels", "torch", "reference")]
    return {
        "rows": len(lengths),
        "lengths": lengths,
        "cosine_min": {f"{a}_vs_{b}": cosine(a, b) for a, b in pairs},
        "argmax": {k: v.argmax(-1).tolist() for k, v in logits.items()},
        "finite": all(bool(torch.isfinite(v).all()) for v in logits.values()),
    }


def step_gates(steps_cmp: dict) -> dict:
    """Hold the compared decode steps to their bars; raise on a miss.

    fp32, 32 layers: every pair above FP32_COSINE. bf16, 2 layers:
    every pair above BF16_COSINE. bf16, 32 layers: 32 random layers
    amplify any difference in rounding into a logits gap of ~1e-3
    (1 - cosine), the two plain versions included, so the bar there is
    relative: every pair with a kernel at most BF16_GAP_RATIO times the
    gap between the plain version and the fp32 reference (PERF.md,
    parity contract)."""
    gates = {}
    for name, bar in (("fp32", FP32_COSINE), ("bf16_2_layers", BF16_COSINE)):
        worst = min(steps_cmp[name]["cosine_min"].values())
        gates[name] = {"worst_cosine": worst, "bar": bar}
        if not (steps_cmp[name]["finite"] and worst > bar):
            raise AssertionError(f"{name} decode-step logits: {gates}")
    cos = steps_cmp["bf16"]["cosine_min"]
    plain_gap = 1 - cos["torch_vs_reference"]
    ratios = {k: (1 - v) / max(plain_gap, 1e-9)
              for k, v in cos.items() if k != "torch_vs_reference"}
    gates["bf16"] = {
        "gap_over_plain_gap": ratios, "bar": BF16_GAP_RATIO,
        "kernels_vs_torch_above_0.999": cos["kernels_vs_torch"] > BF16_COSINE,
    }
    if not (steps_cmp["bf16"]["finite"]
            and max(ratios.values()) <= BF16_GAP_RATIO):
        raise AssertionError(f"bf16 decode-step logits: {gates}")
    return gates


def profile_decode(E, eng, prompts, chunks: int = 2) -> dict:
    """Trace ``chunks`` steady decode chunks with torch.profiler once
    every slot is decoding: device busy share of the host window, CUDA
    kernel launches per decode step, and the kernels with the most
    device time. Reports "not measured" where the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    for i, p in enumerate(prompts):
        eng.add_request(E.Request(rid=f"prof{i}", prompt=p, max_new_tokens=40))
    while eng._prefilling or eng._queue:
        eng.step()
    steps0 = eng.decode_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            eng.step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    steps = eng.decode_steps - steps0
    eng.run()
    kernels_ = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and ev.key and not ev.key.startswith(("cuda", "aten")):
            kernels_.append((dev_us, ev.count, ev.key))
    device_ms = sum(k[0] for k in kernels_) / 1e3
    if not kernels_:
        return {"device_busy_share": "not measured",
                "reason": "profiler recorded no device time"}
    kernels_.sort(reverse=True)
    attention = {
        name: {
            "device_ms_per_step": sum(
                us for us, _, key in kernels_ if name in key) / 1e3 / steps,
            "launches_per_step": sum(
                n for _, n, key in kernels_ if name in key) / steps,
        }
        for name in DECODE_BODY_KERNELS
    }
    int8mm = [(us, n, key) for us, n, key in kernels_
              if any(name in key for name in INT8MM_KERNELS)]
    mlp = [(us, n, key) for us, n, key in kernels_
           if any(name in key for name in MLP_KERNELS)]
    mlp_ms = sum(k[0] for k in mlp) / 1e3 / steps
    return {
        "decode_attention_kernels": attention,
        "int8mm_kernels": {
            short_name(key)[:60]: {"device_ms_per_step": us / 1e3 / steps,
                                   "launches_per_step": n / steps}
            for us, n, key in int8mm},
        "int8mm_device_ms_per_step": sum(k[0] for k in int8mm) / 1e3 / steps,
        "int8mm_launches_per_step": sum(k[1] for k in int8mm) / steps,
        "mlp_kernels": {
            short_name(key)[:60]: {"device_ms_per_step": us / 1e3 / steps,
                                   "launches_per_step": n / steps}
            for us, n, key in mlp},
        "mlp_device_ms_per_step": mlp_ms,
        "mlp_launches_per_step": sum(k[1] for k in mlp) / steps,
        "device_ms_per_step": device_ms / steps,
        "mlp_share_of_device_time": mlp_ms / (device_ms / steps),
        "decode_steps": steps,
        "window_ms": window_ms,
        "step_ms": window_ms / steps,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        "kernel_launches_per_step": sum(k[1] for k in kernels_) / steps,
        "top_kernels": [
            {"name": name[:90], "device_ms": us / 1e3, "count": n}
            for us, n, name in kernels_[:10]
        ],
    }


def serve(E, kernels, cfg, params, ec, reqs) -> tuple:
    """Run ``reqs`` through a fresh engine with the launch counts set
    to 0 just before; returns (engine, completions, launches, wall s).
    Every request must complete with its token count and ids in range,
    and the allocator must end leak-free."""
    eng = E.Engine(cfg, params, ec)
    kernels.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for r in reqs:
        n = len(done[r.rid].tokens)
        if n != r.max_new_tokens:
            raise AssertionError(f"{r.rid}: {n} tokens, want {r.max_new_tokens}")
        if not (0 <= done[r.rid].tokens.min()
                and done[r.rid].tokens.max() < cfg.vocab_size):
            raise AssertionError(f"{r.rid}: token ids out of range")
    alloc = eng.allocator
    if alloc.free_pages != alloc.num_pages - 1 or alloc.reserved_pages:
        raise AssertionError(
            f"allocator leaked: {alloc.free_pages} free of "
            f"{alloc.num_pages - 1}, {alloc.reserved_pages} reserved"
        )
    return eng, done, launches, wall


def serve_summary(eng, done, launches, wall) -> dict:
    decode_tokens = sum(len(c.tokens) - 1 for c in done.values())
    ttft = sorted(c.ttft_s for c in done.values())
    steps = eng.decode_steps
    return {
        "requests": len(done), "wall_seconds": wall, "decode_steps": steps,
        "decode_seconds": eng.decode_seconds, "decode_tokens": decode_tokens,
        "decode_tok_s": decode_tokens / eng.decode_seconds,
        "ttft_p50_s": ttft[len(ttft) // 2],
        "prefill_buckets": eng.prefill_buckets, "launches": launches,
    }


# The decode attention body (csrc/decode_attention.cuh): the kernels of
# its two launches, and the sources that instantiate it.
DECODE_BODY_KERNELS = ("decode_split_kernel", "decode_combine_kernel")
DECODE_BODY_SOURCES = ("paged_decode.cu", "decode.cu")


def decode_body_build(kernels, report) -> dict:
    """Registers and spill bytes of every instantiation of the decode
    body; raises unless each one spills nothing."""
    out = {}
    for source in DECODE_BODY_SOURCES:
        out[source] = {
            short_name(fn): {"registers": p["registers"],
                             "spill_store_bytes": p["spill_stores"]}
            for fn, p in kernels.ptxas_report(report[source]["log"]).items()
        }
        names = " ".join(out[source])
        if not all(k in names for k in DECODE_BODY_KERNELS):
            raise AssertionError(f"{source}: no ptxas report for the decode "
                                 f"body: {sorted(out[source])}")
        spills = {k: v for k, v in out[source].items()
                  if v["spill_store_bytes"]}
        if spills:
            raise AssertionError(f"{source}: instantiations spill: {spills}")
    return out


def plan_of(A, b: int, kvh: int, key_range: int, live: list) -> dict:
    """The decode kernels' split plan for a call, with the CTAs it
    launches and those whose range starts below their row's length."""
    splits, chunk = A.split_plan(
        b, kvh, key_range, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    return {"splits": splits, "chunk": chunk, "ctas": splits * kvh * b,
            "live_ctas": kvh * sum(min(-(-n // chunk), splits)
                                   for n in live),
            "combine": splits > 1}


def body_profile(call, flush, reps: int = 20) -> dict:
    """Device µs of each decode-body kernel (split, combine) a call
    takes, from torch.profiler over ``reps`` calls with the L2 flushed
    before each, and its CUDA launches a call."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        for name in DECODE_BODY_KERNELS:
            if name in ev.key and dev_us > 0:
                out[f"{name}_us"] = dev_us / ev.count
                out[f"{name}_launches_per_call"] = ev.count / reps
    return out or {"profile": "not measured: no device time recorded"}


def share(ms: float, nbytes: float, rates: tuple) -> dict:
    """A bytes-bound kernel's achieved rate and share of its bound."""
    return {"tb_per_s": nbytes / ms / 1e9,
            "share_of_bound": nbytes / rates[0] * 1e3 / ms}


def paged_timing(A, q, k_, v_, sc, tables, lens, lengths, rates,
                 flush) -> dict:
    """One paged-decode timing row. Yardstick only (not the same
    inputs): SDPA over the same live K/V already gathered into
    contiguous [B, kvh, L, hd] bf16 buffers (dequantized for int8
    pools); every slot holds the same length L."""
    b, h, hd = q.shape
    kvh, page = k_.shape[2], k_.shape[1]
    live = sum(lengths)
    pages_read = sum(-(-n // page) for n in lengths)
    kv_bytes = 1 if sc else 2
    nbytes = (2 * q.numel() * 2 + live * kvh * hd * kv_bytes * 2
              + (live * kvh * 4 * 2 if sc else 0)
              + pages_read * 4 + b * 4)
    args = (q, k_, v_, tables, lens)
    call = functools.partial(A.paged_decode_attention, *args, **sc,
                             impl="cuda")
    ms = time_ms(call, flush)
    host_ms = time_ms(call, flush, shield=False)
    plain_ms = time_ms(lambda: A.paged_decode_attention(
        *args, **sc, impl="torch"), flush)
    n = lengths[0]
    kd = k_.float() * sc["k_scale"][..., None] if sc else k_
    vd = v_.float() * sc["v_scale"][..., None] if sc else v_
    kc = A._gather_flat(kd.to(torch.bfloat16), tables)[:, :n].permute(
        0, 2, 1, 3).contiguous()
    vc = A._gather_flat(vd.to(torch.bfloat16), tables)[:, :n].permute(
        0, 2, 1, 3).contiguous()
    del kd, vd
    sdpa_ms = yardstick_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kc, vc, enable_gqa=True), flush)
    return {
        "shape": f"B={b} x {n} tokens, page {page}, {tables.shape[1]} "
                 f"pages a slot, h={h} kvh={kvh} hd={hd}, bf16 q, "
                 f"{'int8' if sc else 'bf16'} pools",
        "split_plan": plan_of(A, b, kvh, tables.shape[1] * page, lengths),
        "ms": ms, "ms_with_host": host_ms, "plain_ms": plain_ms,
        "library_ms": None, "sdpa_contiguous_ms": sdpa_ms,
        **bound(nbytes, 4 * live * h * hd, rates),
        **share(ms, nbytes, rates),
        "kernels": body_profile(call, flush),
    }


def contiguous_timing(A, q, k_, v_, sc, L, rates, flush) -> dict:
    """One contiguous-decode timing row at length L, with SDPA over the
    live keys as its library call (bf16), or over them dequantized to
    bf16 ahead as a yardstick (int8: no PyTorch call takes the cache)."""
    b, h, hd = q.shape
    kvh, max_seq = k_.shape[2], k_.shape[1]
    int8 = bool(sc)
    nbytes = (2 * q.numel() * 2 + b * L * kvh * hd * (1 if int8 else 2)
              * 2 + (b * L * kvh * 4 * 2 if int8 else 0))
    call = functools.partial(
        A.decode_attention, q, k_, v_, L, **sc, impl="cuda")
    ms = time_ms(call, flush)
    host_ms = time_ms(call, flush, shield=False)
    plain_ms = time_ms(lambda: A.decode_attention(q, k_, v_, L, **sc,
                                                  impl="torch"), flush)
    row = {
        "shape": f"b={b}, length {L} of max_seq {max_seq}, h={h} kvh={kvh} "
                 f"hd={hd}, bf16 q, {'int8' if int8 else 'bf16'} cache",
        "split_plan": plan_of(A, b, kvh, L, [L] * b),
        "ms": ms, "ms_with_host": host_ms, "plain_ms": plain_ms,
        "library_ms": None,
        **bound(nbytes, 4 * b * L * h * hd, rates),
        **share(ms, nbytes, rates),
        "kernels": body_profile(call, flush),
    }
    if not int8:
        # The same function in one PyTorch call: SDPA over the live
        # keys, views of the cache (no copy).
        row["library_ms"] = yardstick_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k_[:, :L].transpose(1, 2),
                v_[:, :L].transpose(1, 2), enable_gqa=True), flush)
        if isinstance(row["library_ms"], str):
            row["library_note"] = row.pop("library_ms")
            row["library_ms"] = None
    else:
        kd, vd = ((c[:, :L].float() * sc[n][:, :L, :, None]).to(
            torch.bfloat16).transpose(1, 2)
            for c, n in ((k_, "k_scale"), (v_, "v_scale")))
        row["sdpa_dequantized_ms"] = yardstick_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kd, vd, enable_gqa=True), flush)
    return row


def paged_parity(A, name, q, k_, v_, sc, tables, lens) -> dict:
    """The paged kernel against the plain walk and the fp32 reference in
    bf16, against the plain split form with its own plan at fp32 (the
    same cache under fp32 activations, an int8 cache as it is); reruns
    bit-identical, dead slots exact zeros."""
    args = (q, k_, v_, tables, lens)
    got = A.paged_decode_attention(*args, **sc, impl="cuda")
    again = A.paged_decode_attention(*args, **sc, impl="cuda")
    plain = A.paged_decode_attention(*args, **sc, impl="torch")
    ref = A.paged_decode_attention(*args, **sc, impl="reference")
    f32 = (q.float(), k_ if sc else k_.float(), v_ if sc else v_.float(),
           tables, lens)
    lengths = lens.tolist()
    plan = plan_of(A, q.shape[0], k_.shape[2], tables.shape[1] * k_.shape[1],
                   lengths)
    torch.cuda.synchronize()
    out = {
        "split_plan": plan,
        "vs_plain": compare(f"{name} vs plain", got, plain),
        "vs_reference": compare(f"{name} vs reference", got, ref),
        "fp32_vs_split": compare_fp32(
            name, A.paged_decode_attention(*f32, **sc, impl="cuda"),
            A.paged_decode_attention(*f32, **sc, impl="torch",
                                     split_keys=plan["chunk"])),
        "rerun_bit_identical": bool(torch.equal(got, again)),
        "dead_slot_exact_zero": all(
            bool(torch.all(got[i] == 0)) for i, n in enumerate(lengths)
            if n == 0),
    }
    if not (out["rerun_bit_identical"] and out["dead_slot_exact_zero"]):
        raise AssertionError(f"{name}: reruns must give identical bits and "
                             f"a length-0 slot exact zeros: {out}")
    return out


def contiguous_parity(A, name, q, k_, v_, sc, length) -> dict:
    """The contiguous kernel as paged_parity holds the paged one."""
    got = A.decode_attention(q, k_, v_, length, **sc, impl="cuda")
    again = A.decode_attention(q, k_, v_, length, **sc, impl="cuda")
    plain = A.decode_attention(q, k_, v_, length, **sc, impl="torch")
    ref = A.decode_attention(q, k_, v_, length, **sc, impl="reference")
    f32 = (q.float(), k_ if sc else k_.float(), v_ if sc else v_.float())
    plan = plan_of(A, q.shape[0], k_.shape[2], length, [length] * q.shape[0])
    torch.cuda.synchronize()
    out = {
        "split_plan": plan,
        "vs_plain": compare(f"{name} vs plain", got, plain),
        "vs_reference": compare(f"{name} vs reference", got, ref),
        "fp32_vs_split": compare_fp32(
            name, A.decode_attention(*f32, length, **sc, impl="cuda"),
            A.decode_attention(*f32, length, **sc, impl="torch",
                               split_keys=plan["chunk"])),
        "rerun_bit_identical": bool(torch.equal(got, again)),
    }
    if not out["rerun_bit_identical"]:
        raise AssertionError(f"{name}: reruns must give identical bits")
    return out


# The wgmma kernels' sources, the C entries that give the dynamic shared
# memory a CTA asks for, and the template argument each entry takes (the
# flash kernels' head dim, the int8 matmul's CTA tile rows).
SM90_SOURCES = {
    "flash_fwd_sm90.cu": ("tpu_flash_fwd_sm90_smem", (64, 128)),
    "flash_bwd_dq_sm90.cu": ("tpu_flash_bwd_dq_sm90_smem", (64, 128)),
    "flash_bwd_sm90.cu": ("tpu_flash_bwd_dkv_sm90_smem", (64, 128)),
    "int8mm_sm90.cu": ("tpu_int8_matmul_sm90_smem", (128, 256)),
}


# The decode GEMV's source and its instantiations (1 or 2 planes of 8
# rows of x).
GEMV_SM90_SOURCE = "int8mm_gemv_sm90.cu"
GEMV_SM90_KERNEL = "int8_gemv_sm90_kernel"


def gemv_sm90_build(kernels, report) -> dict:
    """Registers and spill bytes of each instantiation of the decode
    GEMV (both planes); raises unless ptxas reported both and neither
    spills."""
    out = {
        short_name(fn): {"registers": p["registers"],
                         "spill_store_bytes": p["spill_stores"],
                         "static_smem_bytes": p["smem_bytes"]}
        for fn, p in kernels.ptxas_report(
            report[GEMV_SM90_SOURCE]["log"]).items()
    }
    if sum(GEMV_SM90_KERNEL in k for k in out) != 2:
        raise AssertionError(f"{GEMV_SM90_SOURCE}: no ptxas report for "
                             f"both planes: {sorted(out)}")
    spills = {k: v for k, v in out.items() if v["spill_store_bytes"]}
    if spills:
        raise AssertionError(f"{GEMV_SM90_SOURCE}: instantiations spill: "
                             f"{spills}")
    return out


# The tensor-core decode MLP's source and kernel: instantiations for
# (1 or 2 planes of 8 rows) x (gate/up, down).
MLP_SM90_SOURCE = "decode_mlp_sm90.cu"
MLP_SM90_KERNEL = "mlp_sm90_kernel"
# The decode MLP's kernels by name: the tensor-core kernel's two passes
# and decode_mlp.cu's three kernels.
MLP_KERNELS = (MLP_SM90_KERNEL, "gate_up_kernel", "down_kernel",
               "residual_kernel")


def mlp_sm90_build(kernels, report) -> dict:
    """Registers, static shared memory and spill bytes of each
    instantiation of the tensor-core decode MLP; raises unless ptxas
    reported all four and none spills."""
    out = {
        short_name(fn): {"registers": p["registers"],
                         "spill_store_bytes": p["spill_stores"],
                         "static_smem_bytes": p["smem_bytes"]}
        for fn, p in kernels.ptxas_report(
            report[MLP_SM90_SOURCE]["log"]).items()
    }
    if sum(MLP_SM90_KERNEL in k for k in out) != 4:
        raise AssertionError(f"{MLP_SM90_SOURCE}: no ptxas report for "
                             f"every instantiation: {sorted(out)}")
    spills = {k: v for k, v in out.items() if v["spill_store_bytes"]}
    if spills:
        raise AssertionError(f"{MLP_SM90_SOURCE}: instantiations spill: "
                             f"{spills}")
    return out


def mlp_plan_dict(plan) -> dict:
    return {"planes": plan.planes, "gate_up": plan.gate_up._asdict(),
            "down": plan.down._asdict()}


def mlp_pass_profile(call, flush, reps: int = 20) -> dict:
    """Device µs a call of the tensor-core decode MLP spends in each
    pass (gate/up, down), from torch.profiler over ``reps`` calls with
    the L2 flushed before each."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if MLP_SM90_KERNEL in ev.key and dev_us > 0:
            name = "gate_up" if "true>" in ev.key else "down"
            out[f"{name}_us"] = dev_us / ev.count
            out[f"{name}_launches_per_call"] = ev.count / reps
    return out or {"profile": "not measured: no device time recorded"}


def sm90_build(kernels, report) -> dict:
    """The wgmma kernels' instantiations, by source: registers and spill
    bytes from ptxas, and the dynamic shared memory a CTA asks for at
    launch; raises unless ptxas reported each source and each
    instantiation spills nothing."""
    out = {}
    for source, (entry, args) in SM90_SOURCES.items():
        smem = kernels.function(source, entry, [ctypes.c_int])
        out[source] = {}
        for fn, p in kernels.ptxas_report(report[source]["log"]).items():
            arg = next((d for d in args
                        if f"<{d}>" in fn or f"ILi{d}E" in fn), None)
            out[source][short_name(fn)] = {
                "registers": p["registers"],
                "spill_store_bytes": p["spill_stores"],
                "static_smem_bytes": p["smem_bytes"],
                "dynamic_smem_bytes": smem(arg) if arg else None,
            }
        if not out[source]:
            raise AssertionError(f"{source}: no ptxas report")
        spills = {k: v for k, v in out[source].items()
                  if v["spill_store_bytes"]}
        if spills:
            raise AssertionError(f"{source}: instantiations spill: {spills}")
    return out


def flash_inputs(gen, sq, skv, dtype, b=2, h=32, kvh=8, hd=128):
    """q, k, v, dO in the public layouts and a lse cotangent [b, h, sq]."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return (rand(b, sq, h, hd), rand(b, skv, kvh, hd), rand(b, skv, kvh, hd),
            rand(b, sq, h, hd),
            torch.randn(b, h, sq, generator=gen, device="cuda"))


def flash_delta(out, do, g_lse=None):
    """delta = rowsum(dO . O) [b, h, sq] f32, minus the lse cotangent —
    what the autograd.Function hands both backward kernels."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    return (delta if g_lse is None else delta - g_lse).contiguous()


def flash_parity(A, gen) -> dict:
    """Each flash kernel against its plain version on the same inputs:
    the backward pair takes the plain forward's lse and delta. Every
    bf16 case must take the wgmma forward, dQ and dK/dV kernels."""
    out = {}
    for name, sq, skv, causal, with_glse in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do, g_lse = flash_inputs(gen, sq, skv, dtype)
            o_k, lse_k = A._cuda_flash_fwd(q, k, v, causal)
            o_p, lse_p = A._torch_flash_fwd(q, k, v, causal)
            delta = flash_delta(o_p, do, g_lse if with_glse else None)
            bwd = (q, k, v, do, lse_p, delta, causal)
            dq_k = A._cuda_flash_bwd_dq(*bwd)
            dk_k, dv_k = A._cuda_flash_bwd_dkv(*bwd)
            dq_p = A._torch_flash_bwd_dq(*bwd)
            dk_p, dv_p = A._torch_flash_bwd_dkv(*bwd)
            again = (A._cuda_flash_fwd(q, k, v, causal)[0],
                     A._cuda_flash_bwd_dq(*bwd),
                     *A._cuda_flash_bwd_dkv(*bwd))
            torch.cuda.synchronize()
            tag = f"flash_{name}_{'bf16' if dtype == torch.bfloat16 else 'fp32'}"
            pairs = {"out": (o_k, o_p), "dq": (dq_k, dq_p), "dk": (dk_k, dk_p),
                     "dv": (dv_k, dv_p)}
            if dtype == torch.bfloat16:
                # Gradient rows: atol never below the fp32 bar of the
                # tensor's largest magnitude (see bf16_row_atol).
                row = {f"{n}_vs_plain": compare(
                    f"{tag} {n}", a, b_, atol_floor=FP32_REL * float(
                        b_.float().abs().max()) if n != "out" else 0.0)
                    for n, (a, b_) in pairs.items()}
                row["lse_vs_plain"] = compare_fp32(f"{tag} lse", lse_k, lse_p)
            else:
                row = {f"{n}_vs_plain": compare_fp32(
                    f"{tag} {n}", a, b_, FP32_REL if n == "out" else
                    FP32_GRAD_REL) for n, (a, b_) in pairs.items()}
                row["lse_vs_plain"] = compare_fp32(f"{tag} lse", lse_k, lse_p)
            row["fwd_route"] = A._flash_fwd_route(q)
            row["dq_route"] = A._flash_bwd_dq_route(q)
            row["dkv_route"] = A._flash_bwd_dkv_route(q)
            if dtype == torch.bfloat16 and {
                    row["fwd_route"], row["dq_route"],
                    row["dkv_route"]} != {"sm90"}:
                raise AssertionError(f"{tag}: bf16 hd 128 must take the "
                                     f"sm90 routes, not {row}")
            row["rerun_bit_identical"] = all(
                bool(torch.equal(a, b_)) for a, b_ in zip(
                    again, (o_k, dq_k, dk_k, dv_k)))
            if not row["rerun_bit_identical"]:
                raise AssertionError(f"{tag}: reruns must give identical bits")
            out[tag] = row
            del q, k, v, do, o_k, o_p, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p, again
    return out


def visible_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the attention computes per (batch, head)."""
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(min(skv, i + off + 1) for i in range(sq))


def flash_timing(A, kernels, gen, rates, flush) -> dict:
    """The three kernels at the train phase's attention shape (b=2,
    s=2048, h=32, kvh=8, hd=128, causal, bf16): kernel, plain version,
    bound, and SDPA as the library yardstick (its forward for the
    forward, its backward for the dQ + dK/dV pair), each with its
    achieved TFLOP/s and the kernel's share of the bound. Each row also
    times the WMMA kernel (flash_attention.cu) that served bf16 before
    the wgmma one, on the same inputs; the dK/dV row adds the pair's
    time (dQ + dK/dV) beside SDPA's backward."""
    F = torch.nn.functional
    b, s, h, kvh, hd = 2, 2048, 32, 8, 128
    q, k, v, do, _ = flash_inputs(gen, s, s, torch.bfloat16, b, h, kvh, hd)
    out, lse = A._cuda_flash_fwd(q, k, v, True)
    delta = flash_delta(out, do)
    bwd = (q, k, v, do, lse, delta, True)
    pairs = b * h * visible_pairs(s, s, True)
    n_q, n_kv = q.numel() * 2, k.numel() * 2  # bf16 bytes
    rows_f32 = b * h * s * 4
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_times() -> tuple:
        with torch.no_grad():
            fwd = time_ms(sdpa, flush)
        o_lib = sdpa()
        bwd = time_ms(lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), flush)
        return fwd, bwd

    # name: the WMMA kernel's (table, argtypes, inputs, outputs' likes,
    # scales).
    wmma_args = {
        "flash_fwd": (A._FLASH_FWD_KERNELS, A._FLASH_FWD_ARGTYPES, (q, k, v),
                      (q, lse), (hd ** -0.5 * A.LOG2_E,)),
        "flash_bwd_dq": (A._FLASH_DQ_KERNELS, A._FLASH_DQ_ARGTYPES, bwd[:6],
                         (q,), (hd ** -0.5 * A.LOG2_E, hd ** -0.5)),
        "flash_bwd_dkv": (A._FLASH_DKV_KERNELS, A._FLASH_DKV_ARGTYPES,
                          bwd[:6], (k, v), (hd ** -0.5 * A.LOG2_E, hd ** -0.5)),
    }

    def wmma(name):
        """flash_attention.cu's kernel for row ``name``, which served bf16
        at hd 128 before the wgmma kernels, on the same inputs: the
        earlier kernel's time, measured beside the new one's."""
        table, argtypes, ins, like, scales = wmma_args[name]
        source, entry = table["wmma"]
        outs = [torch.empty_like(t) for t in like]
        kernels.check(kernels.function(source, entry, argtypes)(
            *(t.data_ptr() for t in (*ins, *outs)),
            *A._flash_dims(q, k, True), *scales,
            torch.cuda.current_stream().cuda_stream), entry)
        return outs

    from torch.nn.attention import SDPBackend, sdpa_kernel
    try:  # SDPA's flash backend, where this build takes GQA there
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_fwd, lib_bwd = sdpa_times()
        lib_backend = "flash"
    except RuntimeError as e:
        lib_backend = f"default (flash refused: {str(e)[:120]})"
        try:
            lib_fwd, lib_bwd = sdpa_times()
        except RuntimeError as e2:
            lib_fwd = lib_bwd = f"not measured: {e2}"[:200]
    shape = "b=2, s=2048, h=32, kvh=8, hd=128, causal, bf16"
    rows = {}
    for name, call, plain, route, flops, nbytes, lib in (
        ("flash_fwd", lambda: A._cuda_flash_fwd(q, k, v, True),
         lambda: A._torch_flash_fwd(q, k, v, True), A._flash_fwd_route,
         4 * pairs * hd, 2 * n_q + 2 * n_kv + rows_f32, lib_fwd),
        ("flash_bwd_dq", lambda: A._cuda_flash_bwd_dq(*bwd),
         lambda: A._torch_flash_bwd_dq(*bwd), A._flash_bwd_dq_route,
         6 * pairs * hd, 3 * n_q + 2 * n_kv + 2 * rows_f32, lib_bwd),
        ("flash_bwd_dkv", lambda: A._cuda_flash_bwd_dkv(*bwd),
         lambda: A._torch_flash_bwd_dkv(*bwd), A._flash_bwd_dkv_route,
         8 * pairs * hd, 2 * n_q + 4 * n_kv + 2 * rows_f32, lib_bwd),
    ):
        row = {
            "shape": shape, "ms": time_ms(call, flush),
            "ms_with_host": time_ms(call, flush, shield=False),
            "plain_ms": time_ms(plain, flush),
            **bound(nbytes, flops, rates), "route": route(q),
            "wmma_kernel_ms": time_ms(functools.partial(wmma, name), flush),
        }
        row["tflops"] = flops / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if isinstance(lib, str):
            row.update(library_ms=None, library_note=lib)
        else:
            row.update(library_ms=lib, library_backend=lib_backend)
        if name != "flash_fwd":
            row["library_covers"] = "SDPA backward: the dQ + dK/dV pair"
        elif row["library_ms"] is not None:
            row["library_tflops"] = flops / lib / 1e9
        if name == "flash_bwd_dkv":
            row["pair_ms"] = rows["flash_bwd_dq"]["ms"] + row["ms"]
            if row["library_ms"] is not None:
                row["pair_over_library"] = row["pair_ms"] / lib
        rows[name] = row
    del q, k, v, do, out, lse, delta, qt, kt, vt
    return rows


def profile_train_step(step, state, tokens) -> tuple:
    """One more train step under torch.profiler: device kernel time by
    kernel, the flash kernels' share, the step's phases and the device
    busy share of the host window. Only device-side events count (a CPU
    op such as the autograd.Function around a ctypes launch is charged
    its kernel's time too). The forward and optimizer are train.py's
    ``train_step/*`` spans; the backward runs on autograd's own thread,
    outside them, and is the remainder. Returns (state, report)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        float(loss)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels_, spans = [], {}
    for ev in prof.key_averages():
        if ev.key.startswith("train_step/"):
            spans[ev.key] = ev.device_time_total / 1e3
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels_.append((ev.self_device_time_total, ev.count, ev.key))
    if not kernels_:
        return state, {"device_busy_share": "not measured",
                       "reason": "profiler recorded no device time"}
    kernels_.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels_) / 1e3
    flash = {}
    for us, n, key in kernels_:
        for name in ("flash_fwd_sm90", "flash_fwd", "flash_bwd_dq_sm90",
                     "flash_bwd_dq", "flash_bwd_dkv_sm90", "flash_bwd_dkv"):
            if f"{name}_kernel" in key:
                flash[name] = {"device_ms": us / 1e3, "count": n}
    flash_ms = sum(v["device_ms"] for v in flash.values())
    return state, {
        "window_ms": window_ms, "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / window_ms,
        "kernel_launches": sum(k[1] for k in kernels_),
        "flash": flash, "flash_device_ms": flash_ms,
        "flash_share_of_device_time": flash_ms / device_ms,
        "phase_device_ms": {
            "forward": spans.get("train_step/forward"),
            "optimizer": spans.get("train_step/optimizer"),
            "backward_remainder": device_ms - sum(spans.values()),
        },
        "top_kernels": [{"name": key[:90], "device_ms": us / 1e3, "count": n}
                        for us, n, key in kernels_[:12]],
    }


def grad_step(T, cfg, params, tokens) -> tuple:
    """(loss, {name: grad}) of one forward and backward from ``params``
    under ``cfg`` (the weights are not updated)."""
    params.zero_grad(set_to_none=True)
    loss = T.loss_fn(T.build_model(cfg), params, tokens)
    loss.backward()
    grads = {n: p.grad for n, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def leaf_cosines(a: dict, b: dict) -> dict:
    """Cosine of each gradient leaf pair, in float64 (a 1e-5 gap over
    525M elements is below what fp32 sums resolve)."""
    def cos(x, y):
        x, y = x.double().flatten(), y.double().flatten()
        return float(x @ y / (x.norm() * y.norm()))

    return {n: cos(a[n], b[n]) for n in a}


def train_phase(T, kernels, LLAMA3_8B, init_params, train_flops_per_token,
                rates) -> dict:
    """The Trainer at Llama-3-8B widths, 4 layers, then the compared
    steps (see the module docstring)."""
    cfg = dataclasses.replace(LLAMA3_8B, n_layers=4)
    L, b, s, steps = cfg.n_layers, 2, 2048, 5
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = T.Trainer(cfg)
    state = trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
    step = trainer.make_train_step()
    # Every forward, dQ and dK/dV on the wgmma route (bf16, hd 128).
    want = {"flash_fwd": 2 * L, "flash_fwd_sm90": 2 * L, "flash_bwd_dq": L,
            "flash_bwd_dq_sm90": L, "flash_bwd_dkv": L,
            "flash_bwd_dkv_sm90": L}
    losses, step_ms, per_step = [], [], []
    kernels.reset_launches()
    for _ in range(steps):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        losses.append(float(loss))  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: kernels.LAUNCHES[k] - before[k]
                         for k in kernels.LAUNCHES})
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state, profile = profile_train_step(step, state, tokens)
    for i, d in enumerate(per_step):
        other = {k: v for k, v in d.items() if k not in want and v}
        if any(d[k] != v for k, v in want.items()) or other:
            raise AssertionError(f"train step {i}: launches {d}, want {want}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train losses {losses}: finite and falling")
    steady = statistics.median(step_ms[1:])
    tokens_per_step = b * s
    out = {
        "model": "LLAMA3_8B widths cut to 4 layers, bf16, remat nothing, "
                 "random weights", "batch": b, "seq": s,
        "losses": losses, "step_ms": step_ms, "steady_step_ms": steady,
        "trained_tok_s": tokens_per_step / (steady / 1e3),
        "mfu": train_flops_per_token(cfg, s) * tokens_per_step
        / (steady / 1e3) / rates[1],
        "peak_memory_gb": peak_gb, "launches": launches,
        "launches_per_step": per_step[-1], "profile": profile,
        **{f"{name}_device_ms_per_step": profile.get("flash", {}).get(
            kernel, {}).get("device_ms", "not measured")
           for name, kernel in (("flash_fwd", "flash_fwd_sm90"),
                                ("flash_bwd_dq", "flash_bwd_dq_sm90"),
                                ("flash_bwd_dkv", "flash_bwd_dkv_sm90"))},
    }

    # One step from the initial weights (after 5 steps on one batch the
    # loss is near 0): kernels vs plain versions vs an fp32 reference
    # (the same weights upcast, reference attention).
    del state, trainer, step
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         trainable=True)
    loss_k, g_k = grad_step(T, cfg, params, tokens)
    loss_p, g_p = grad_step(
        T, dataclasses.replace(cfg, attention_impl="torch"), params, tokens)
    ref_cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  param_dtype=torch.float32,
                                  attention_impl="reference")
    params.float()
    loss_r, g_r = grad_step(T, ref_cfg, params, tokens)
    del params
    torch.cuda.empty_cache()
    cos_kr, cos_pr = leaf_cosines(g_k, g_r), leaf_cosines(g_p, g_r)
    cos_kp = leaf_cosines(g_k, g_p)
    ratios = {n: (1 - cos_kr[n]) / max(1 - cos_pr[n], TRAIN_GAP_FLOOR)
              for n in g_k}
    bf16 = {
        "loss_kernels": loss_k, "loss_torch": loss_p, "loss_fp32": loss_r,
        "worst_leaf_cosine_kernels_vs_fp32": min(cos_kr.values()),
        "worst_leaf_cosine_torch_vs_fp32": min(cos_pr.values()),
        "worst_leaf_cosine_kernels_vs_torch": min(cos_kp.values()),
        "worst_gap_ratio": max(ratios.values()),
        "worst_gap_ratio_leaf": max(ratios, key=ratios.get),
        "bar": BF16_GAP_RATIO,
    }
    del g_k, g_p, g_r
    if not (np.isfinite([loss_k, loss_p, loss_r]).all()
            and bf16["worst_gap_ratio"] <= BF16_GAP_RATIO):
        raise AssertionError(f"bf16 train step, kernels vs plain: {bf16}")

    c32 = dataclasses.replace(LLAMA3_8B, n_layers=2, dtype=torch.float32,
                              param_dtype=torch.float32)
    params = init_params(c32, torch.Generator(device="cuda").manual_seed(0),
                         trainable=True)
    loss_k, g_k = grad_step(T, c32, params, tokens)
    loss_p, g_p = grad_step(
        T, dataclasses.replace(c32, attention_impl="torch"), params, tokens)
    del params
    cos = leaf_cosines(g_k, g_p)
    del g_k, g_p
    torch.cuda.empty_cache()
    fp32 = {
        "layers": 2, "loss_kernels": loss_k, "loss_torch": loss_p,
        "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
        "worst_leaf_cosine": min(cos.values()),
        "worst_leaf": min(cos, key=cos.get),
        "bars": {"loss_rel": FP32_REL, "cosine": TRAIN_FP32_COSINE},
    }
    if not (fp32["loss_rel_diff"] <= FP32_REL
            and fp32["worst_leaf_cosine"] >= TRAIN_FP32_COSINE):
        raise AssertionError(f"fp32 train step, kernels vs plain: {fp32}")
    out["step_check"] = {"bf16_4_layers": bf16, "fp32_2_layers": fp32}
    return out


# --- sampling, the sampled engine and speculative decoding -----------------

# (temperature, top_k) cases of the sampling phase; k = 40 is the sampled
# engine's.
PICK_CASES = ((0.8, 40), (1.3, 8), (1.0, 0))
# Integer and float operations per drawn candidate in the fused pick:
# Threefry-2x32's 20 rounds of add, rotate and xor (two shifts and an
# or) plus six key injections, the bit work of the uniform, two logf
# (~10 operations each) and the add; counted at the CUDA-core fp32 rate.
PICK_OPS_PER_DRAW = 20 * 5 + 6 * 2 + 6 + 2 * 10 + 2


def ulps_over_scale(got, ref) -> float:
    """Largest |got - ref| in ulps of max(|ref|, 1): where Gumbel noise
    meets a score of magnitude ~1, the unit its error counts in."""
    ref64 = ref.double()
    scale = torch.from_numpy(np.spacing(
        np.maximum(ref.abs().cpu().numpy(), 1.0).astype(np.float32)))
    return float(((got.double() - ref64).abs().cpu() / scale).max())


def pick_keys(layout: str, rows: int, device) -> dict:
    """The sample_pick key arguments of one layout: the engine's rows
    layout (seed 11, serials and positions like a decode step's), or
    sample_generate's block layout (one key folded with the step)."""
    if layout == "block":
        return {"key": torch.tensor([0, 42], dtype=torch.int64,
                                    device=device), "fold": 7}
    return {"seed": torch.tensor(11, dtype=torch.int32, device=device),
            "serials": torch.arange(1, rows + 1, dtype=torch.int32,
                                    device=device),
            "positions": torch.arange(rows, dtype=torch.int32,
                                      device=device) * 37 + 300}


def to_cpu(kw: dict) -> dict:
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in kw.items()}


def sampling_phase(S, SP, G, kernels, rates) -> dict:
    """The fused pick (csrc/sample.cu) against its plain version at the
    engine's shape, [8, 128256] fp32, with seeded logits and a copy
    rounded through bf16 (equal values at the top of each row), for each
    (temperature, top_k) of PICK_CASES in both key layouts: the kernel
    and the plain version on the card draw the same tokens over the same
    candidates, and so does the plain version on the CPU. The plain
    Threefry bits and uniforms on the card equal the CPU's, their Gumbel
    values within 2 ulps of max(|g|, 1) (the logs may round apart);
    topk_exact on the card equals the CPU's. Then the pick's device time
    at the engine's case (rows layout, 0.8, 40) beside its bound, the
    plain pick and the greedy argmax it stands in for."""
    dev = torch.device("cuda")
    rows, vocab = 8, 128256
    gen = torch.Generator(device="cpu").manual_seed(12)
    fp32 = torch.randn(rows, vocab, generator=gen) * 4
    inputs = {"fp32": fp32.to(dev),
              "bf16_ties": fp32.to(torch.bfloat16).float().to(dev)}
    out = {"shape": [rows, vocab], "cases": {}}
    for name, x in inputs.items():
        top40 = G.topk_exact(x.cpu(), 40)[0]
        ties = int((top40[:, 1:] == top40[:, :-1]).sum())
        for t, k in PICK_CASES:
            for layout in ("rows", "block"):
                kw = pick_keys(layout, rows, dev)
                kernels.reset_launches()
                got = SP.sample_pick(x, t, k, impl="cuda", candidates=True,
                                     **kw)
                launches = kernels.LAUNCHES["sample_pick"]
                plain = SP.sample_pick(x, t, k, impl="torch",
                                       candidates=True, **kw)
                cpu = SP.sample_pick(x.cpu(), t, k, impl="torch",
                                     candidates=True, **to_cpu(kw))
                torch.cuda.synchronize()
                case = {
                    "launches": launches,
                    "tokens_vs_plain_identical": bool(torch.equal(
                        got[0], plain[0])),
                    "tokens_card_vs_cpu_identical": bool(torch.equal(
                        got[0].cpu(), cpu[0])),
                    "plain_card_vs_cpu_identical": bool(torch.equal(
                        plain[0].cpu(), cpu[0])),
                    "tokens": got[0].tolist(),
                }
                if k:
                    case.update(
                        candidates_vs_plain_identical=bool(
                            torch.equal(got[1], plain[1])
                            and torch.equal(got[2], plain[2])),
                        candidates_vs_cpu_identical=bool(
                            torch.equal(got[1].cpu(), cpu[1])
                            and torch.equal(got[2].cpu(), cpu[2])),
                        max_abs_err=float((got[1] - plain[1]).abs().max()),
                    )
                else:
                    case["max_abs_err"] = 0.0
                bad = [key for key, v in case.items()
                       if isinstance(v, bool) and not v]
                if bad or launches != 1:
                    raise AssertionError(
                        f"sample_pick {name} T={t} k={k} {layout}: {bad} "
                        f"{case}")
                out["cases"][f"{name}_t{t}_k{k}_{layout}"] = case
        out[f"{name}_equal_neighbours_in_top40"] = ties
    # The plain jax.random twins on the card and on the CPU.
    key = S.fold_in(S.fold_in(S.prng_key(5), 3), 17)
    bits = S.random_bits(key.to(dev), (rows, vocab))
    bits_cpu = S.random_bits(key, (rows, vocab))
    g_card = S.gumbel_from_bits(bits)
    g_cpu = S.gumbel_from_bits(bits_cpu)
    out["threefry_bits_identical"] = bool(torch.equal(bits.cpu(), bits_cpu))
    out["uniforms_identical"] = bool(torch.equal(
        S.uniform_from_bits(bits).cpu(), S.uniform_from_bits(bits_cpu)))
    out["gumbel_max_ulps_of_scale"] = ulps_over_scale(g_card.cpu(), g_cpu)
    out["gumbel_bit_identical_share"] = float(
        (g_card.cpu() == g_cpu).float().mean())
    topk = {}
    for name, x in inputs.items():
        v, i = G.topk_exact(x, 40)
        vc, ic = G.topk_exact(x.cpu(), 40)
        topk[name] = bool(torch.equal(v.cpu(), vc)
                          and torch.equal(i.cpu(), ic))
    out["topk_exact_card_vs_cpu_identical"] = topk
    if not (out["threefry_bits_identical"] and out["uniforms_identical"]
            and out["gumbel_max_ulps_of_scale"] <= 2.0
            and all(topk.values())):
        raise AssertionError(f"sampling twins card vs CPU: {out}")
    # Time at the engine's case.
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    x = inputs["fp32"]
    kw = pick_keys("rows", rows, dev)
    timing = {}
    for t, k in PICK_CASES:
        call = functools.partial(SP.sample_pick, x, t, k, impl="cuda", **kw)
        draws = rows * (k or vocab)
        nbytes = x.numel() * 4 + rows * 4
        ops = draws * PICK_OPS_PER_DRAW + x.numel()
        t_bytes = nbytes / rates[0] * 1e3
        t_ops = ops / rates[2] * 1e3
        ms = time_ms(call, flush)
        timing[f"t{t}_k{k}"] = {
            "ms": ms, "ms_with_host": time_ms(call, flush, shield=False),
            "plain_ms": time_ms(functools.partial(
                SP.sample_pick, x, t, k, impl="torch", **kw), flush),
            "argmax_ms": time_ms(lambda: torch.argmax(x, dim=-1), flush),
            "library_ms": None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops,
        }
        timing[f"t{t}_k{k}"]["share_of_bound"] = (
            timing[f"t{t}_k{k}"]["bound_ms"] / ms)
    out["timing"] = timing
    out["library_note"] = ("no PyTorch call draws jax.random's bits; "
                           "argmax_ms is the greedy pick the sampled one "
                           "replaces on the path")
    del flush
    return out


def first_difference(a: dict, b: dict):
    """(rid, position) of the first token where two runs differ, or
    None."""
    for rid in sorted(a):
        ta, tb = a[rid].tokens, b[rid].tokens
        n = min(len(ta), len(tb))
        diff = np.flatnonzero(ta[:n] != tb[:n])
        if diff.size or len(ta) != len(tb):
            return rid, int(diff[0]) if diff.size else n
    return None


def top2_gap(G, cfg, params, prompt, tokens) -> float:
    """The gap between the two largest logits after ``prompt`` plus
    ``tokens`` (one contiguous forward on the card)."""
    ctx = torch.as_tensor(np.concatenate([prompt, tokens])[None],
                          device="cuda")
    tree = G.unroll_params(G.as_tree(params, torch.device("cuda")))
    cache = G.init_cache(cfg, 1, ctx.shape[1])
    logits = G.forward_chunk(cfg, tree, cache, ctx)[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def identical_or_explain(G, cfg, params, trace, got, want, what) -> None:
    """Raise unless ``got`` and ``want`` hold the same tokens, naming the
    first differing position and the top-2 logit gap there."""
    where = first_difference(got, want)
    if where is None:
        return
    rid, pos = where
    prompt = next(p for r, p, _ in trace if r == rid)
    gap = top2_gap(G, cfg, params, prompt, want[rid].tokens[:pos])
    raise AssertionError(
        f"{what}: {rid} differs first at generated position {pos} "
        f"(top-2 logit gap there {gap:.3e}): {got[rid].tokens.tolist()} vs "
        f"{want[rid].tokens.tolist()}")


def pool_whole_and_zero(eng, what: str) -> None:
    alloc = eng.allocator
    if alloc.free_pages != alloc.num_pages - 1 or alloc.reserved_pages:
        raise AssertionError(f"{what}: allocator leaked")
    if not all(bool((layer[1:] == 0).all())
               for _, pool in eng.cache._pools() for layer in pool):
        raise AssertionError(f"{what}: freed pages not zero")


class ReplayDraft:
    """Proposes each request's completion from an earlier run: a draft
    source whose guesses are mostly right, so the verify pass accepts
    most of them."""

    def __init__(self, reqs, done):
        self.runs = [(np.asarray(r.prompt, np.int32), done[r.rid].tokens)
                     for r in reqs]

    def propose(self, history, k):
        for prompt, tokens in self.runs:
            if (len(history) >= len(prompt)
                    and np.array_equal(history[:len(prompt)], prompt)):
                at = len(history) - len(prompt)
                return np.asarray(tokens[at:at + k], np.int32)
        return np.zeros(0, np.int32)


def token_agreement(a: dict, b: dict) -> float:
    return float(np.mean([np.mean(a[r].tokens == b[r].tokens) for r in a]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tpu_dra_torch import kernels
    from tpu_dra_torch.workloads import engine as E
    from tpu_dra_torch.workloads import generate as G
    from tpu_dra_torch.workloads import quantize as Q
    from tpu_dra_torch.workloads import sampling as S
    from tpu_dra_torch.workloads import specdraft as SD
    from tpu_dra_torch.workloads import train as T
    from tpu_dra_torch.workloads.models.llama import (
        LLAMA3_8B,
        TINY_LLAMA,
        init_params,
        num_params,
        train_flops_per_token,
    )
    from tpu_dra_torch.workloads.ops import attention as A
    from tpu_dra_torch.workloads.ops import decode_mlp as DM
    from tpu_dra_torch.workloads.ops import int8mm as I8
    from tpu_dra_torch.workloads.ops import sample as SP

    t_start = time.perf_counter()
    # --- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    rates = peaks(kind)
    emit("device", kind=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, mem_bytes_per_s=rates[0],
         bf16_flops_per_s=rates[1])

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    report = kernels.build()
    emit("build", seconds=time.perf_counter() - t0,
         per_source={k: v["seconds"] for k, v in report.items()},
         ptxas={src: {short_name(fn): [p["registers"], p["smem_bytes"],
                                       p["spill_stores"]]
                      for fn, p in kernels.ptxas_report(v["log"]).items()}
                for src, v in report.items()},
         ptxas_columns=["registers", "smem_bytes", "spill_store_bytes"],
         sm90=sm90_build(kernels, report),
         decode_body=decode_body_build(kernels, report),
         gemv_sm90=gemv_sm90_build(kernels, report),
         mlp_sm90=mlp_sm90_build(kernels, report))

    # --- 3. parity at 8B widths ------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(1234)
    parity = {}
    for label, lengths in (
        ("", [0, 1, 15, 16, 17, 255, 512, 1000]),
        ("split_boundaries", [63, 64, 65, 127, 128, 129, 1023, 1024]),
        ("long", [8192]),
    ):
        q, kp, vp, tables, lens = paged_inputs(gen, lengths)
        for name, (k_, v_, sc) in (
            ("paged_decode_attention", (kp, vp, {})),
            ("paged_decode_attention_int8", int8_pools(Q, kp, vp)),
        ):
            res = paged_parity(A, name, q, k_, v_, sc, tables, lens)
            if label:
                parity[name][label] = res
            else:
                parity[name] = res
        del q, kp, vp, tables, lens, k_, v_, sc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (1, 8, 13, 16):
        x, scale, tree = mlp_inputs(gen, b)
        route = DM._decode_mlp_route(x, mlp_weights(tree))
        if route != "sm90":
            raise AssertionError(f"decode_mlp b={b}: route {route}, want "
                                 f"sm90")
        got = DM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
        plain = DM.decode_mlp(x, scale, tree, 1e-5, impl="torch")
        ref = DM.decode_mlp(x, scale, tree, 1e-5, impl="reference")
        again = DM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
        torch.cuda.synchronize()
        parity[f"decode_mlp_b{b}"] = {
            "route": route,
            "plan": mlp_plan_dict(DM.mlp_sm90_plan(b, 4096, 14336, sms)),
            "vs_plain": compare(f"mlp b={b} vs plain", got, plain),
            "vs_reference": compare(f"mlp b={b} vs reference", got, ref),
            "rerun_bit_identical": bool(torch.equal(got, again)),
        }
        if not parity[f"decode_mlp_b{b}"]["rerun_bit_identical"]:
            raise AssertionError("decode_mlp reruns must give identical bits")
    # decode_mlp.cu, which serves the simt route (fp32, B > 16), launched
    # directly (not counted): fp32 at B = 8, bf16 at B = 32.
    for label, b, dtype in (("fp32_b8", 8, torch.float32),
                            ("bf16_b32", 32, torch.bfloat16)):
        x, scale, tree = mlp_inputs(gen, b)
        x, scale = x.to(dtype), scale.to(dtype)
        tree = {k: {"kernel": v["kernel"].to(dtype)} for k, v in tree.items()}
        ws = mlp_weights(tree)
        route = DM._decode_mlp_route(x, ws)
        old = DM._simt_decode_mlp(x, scale, *ws, 1e-5)
        old_again = DM._simt_decode_mlp(x, scale, *ws, 1e-5)
        plain = DM.decode_mlp(x, scale, tree, 1e-5, impl="torch")
        ref = DM.decode_mlp(x, scale, tree, 1e-5, impl="reference")
        torch.cuda.synchronize()
        name = f"decode_mlp_simt_{label}"
        parity[name] = {"route": route,
                        "rerun_bit_identical": bool(torch.equal(
                            old, old_again))}
        if dtype == torch.float32:
            parity[name]["vs_plain"] = compare_fp32(name, old, plain)
        else:
            parity[name]["vs_plain"] = compare(f"{name} vs plain", old,
                                               plain)
            parity[name]["vs_reference"] = compare(f"{name} vs reference",
                                                   old, ref)
        if route != "simt" or not parity[name]["rerun_bit_identical"]:
            raise AssertionError(f"{name}: {parity[name]}")
        del old, old_again, plain, ref
    del x, scale, tree, ws
    for m, k, n in INT8MM_PARITY:
        x, w_q, w_s = int8mm_inputs(Q, gen, m, k, n, zero_col=n // 3)
        got = I8.int8_matmul(x, w_q, w_s, impl="cuda")
        plain = I8.int8_matmul(x, w_q, w_s, impl="torch")
        ref = I8.int8_matmul(x, w_q, w_s, impl="reference")
        again = I8.int8_matmul(x, w_q, w_s, impl="cuda")
        torch.cuda.synchronize()
        name = f"int8mm_m{m}_k{k}_n{n}"
        parity[name] = {
            "route": I8._int8mm_route(x, w_q),
            "vs_plain": compare(f"{name} vs plain", got, plain),
            "vs_reference": compare(f"{name} vs reference", got, ref),
            "zero_column_exact_zero": bool(torch.all(got[:, n // 3] == 0)),
            "rerun_bit_identical": bool(torch.equal(got, again)),
        }
        if parity[name]["route"] == "gemv_sm90":
            parity[name]["plan"] = I8.gemv_sm90_plan(
                m, k, n, torch.cuda.get_device_properties(0)
                .multi_processor_count)._asdict()
            # int8mm.cu's GEMV on the same inputs.
            old = int8mm_gemv(kernels, I8, x, w_q, w_s)
            old_again = int8mm_gemv(kernels, I8, x, w_q, w_s)
            torch.cuda.synchronize()
            parity[name]["old_gemv"] = {
                "vs_plain": compare(f"{name} old gemv vs plain", old, plain),
                "vs_reference": compare(f"{name} old gemv vs reference",
                                        old, ref),
                "zero_column_exact_zero": bool(torch.all(
                    old[:, n // 3] == 0)),
                "rerun_bit_identical": bool(torch.equal(old, old_again)),
            }
            if not (parity[name]["old_gemv"]["zero_column_exact_zero"]
                    and parity[name]["old_gemv"]["rerun_bit_identical"]):
                raise AssertionError(
                    f"{name} old gemv: {parity[name]['old_gemv']}")
            del old, old_again
        if parity[name]["route"] == "sm90":
            parity[name]["tile_rows"] = I8._sm90_rows(m, n, x.device)
            # int8mm.cu's WMMA tile on the same inputs.
            wmma = int8mm_wmma(kernels, I8, x, w_q, w_s)
            wmma_again = int8mm_wmma(kernels, I8, x, w_q, w_s)
            torch.cuda.synchronize()
            parity[name]["wmma"] = {
                "vs_plain": compare(f"{name} wmma vs plain", wmma, plain),
                "vs_reference": compare(f"{name} wmma vs reference", wmma,
                                        ref),
                "zero_column_exact_zero": bool(torch.all(
                    wmma[:, n // 3] == 0)),
                "rerun_bit_identical": bool(torch.equal(wmma, wmma_again)),
            }
            if not (parity[name]["wmma"]["zero_column_exact_zero"]
                    and parity[name]["wmma"]["rerun_bit_identical"]):
                raise AssertionError(f"{name} wmma: {parity[name]['wmma']}")
            del wmma, wmma_again
        if n in (14336, 4096) and m in (1, 8, 1024):
            parity[name]["fp32_vs_plain"] = compare_fp32(
                name, I8.int8_matmul(x.float(), w_q, w_s, impl="cuda"),
                I8.int8_matmul(x.float(), w_q, w_s, impl="torch"))
        if not (parity[name]["zero_column_exact_zero"]
                and parity[name]["rerun_bit_identical"]
                and parity[name]["route"]
                == ("sm90" if m > 16 else "gemv_sm90")):
            raise AssertionError(f"{name}: {parity[name]}")
        del x, w_q, w_s, got, plain, ref, again
    for int8 in (False, True):
        name = "decode_attention_int8" if int8 else "decode_attention"
        parity[name] = {}
        for b, max_seq, lengths in (
            (8, 1024, (1, 63, 64, 65, 129, 255, 256, 257, 1000)),
            (1, 8192, (8191, 8192)),
        ):
            q, k_, v_, sc = contiguous_inputs(Q, gen, b=b, max_seq=max_seq,
                                              int8=int8)
            for length in lengths:
                key = f"length_{length}" + ("_b1" if b == 1 else "")
                parity[name][key] = contiguous_parity(
                    A, f"{name} b={b} L={length}", q, k_, v_, sc, length)
            zero = A.decode_attention(q, k_, v_, 0, **sc, impl="cuda")
            if not bool(torch.all(zero == 0)):
                raise AssertionError(f"{name}: length 0 must give exact "
                                     f"zeros")
            del q, k_, v_, sc
    parity.update(flash_parity(A, gen))
    emit("parity", **parity)

    # --- 4. kernel times -----------------------------------------------------
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    timing = {}
    for label, lengths in (("", [512] * 8), ("_long", [8192])):
        q, kp, vp, tables, lens = paged_inputs(gen, lengths)
        pools = [("paged_decode_attention", kp, vp, {})]
        if not label:
            pools.append(("paged_decode_attention_int8",
                          *int8_pools(Q, kp, vp)))
        for name, k_, v_, sc in pools:
            timing[name + label] = paged_timing(
                A, q, k_, v_, sc, tables, lens, lengths, rates, flush)
        del q, kp, vp, tables, lens, pools, k_, v_, sc
    x, scale, tree = mlp_inputs(gen, 8)
    ws = mlp_weights(tree)
    d, ffn = x.shape[1], tree["w_gate"]["kernel"].shape[1]
    route = DM._decode_mlp_route(x, ws)
    if route != "sm90":
        raise AssertionError(f"decode_mlp timing: route {route}, want sm90")
    nbytes = 3 * d * ffn * 2 + d * 2 + 2 * x.numel() * 2
    flops = 2 * x.shape[0] * d * ffn * 3
    call = functools.partial(DM.decode_mlp, x, scale, tree, 1e-5,
                             impl="cuda")
    ms = time_ms(call, flush)
    host_ms = time_ms(call, flush, shield=False)
    old_ms = time_ms(lambda: DM._simt_decode_mlp(x, scale, *ws, 1e-5),
                     flush)
    plain_ms = time_ms(
        lambda: DM.decode_mlp(x, scale, tree, 1e-5, impl="torch"), flush)
    library_ms = yardstick_ms(lambda: mlp_library_chain(x, scale, tree),
                              flush)
    timing["decode_mlp"] = {
        "shape": "B=8, d=4096, ffn=14336, bf16",
        "route": route,
        "plan": mlp_plan_dict(DM.mlp_sm90_plan(8, d, ffn, sms)),
        "ms": ms, "ms_with_host": host_ms, "replaced_kernel_ms": old_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms if isinstance(library_ms, float) else None,
        "library_note": "a chain of library calls (rms_norm, three cuBLAS "
                        "GEMMs, silu, mul, add), not one call"
                        + ("" if isinstance(library_ms, float)
                           else f"; {library_ms}"),
        "passes": mlp_pass_profile(call, flush),
        **bound(nbytes, flops, rates),
    }
    row = timing["decode_mlp"]
    row["share_of_bound"] = row["bound_ms"] / ms
    row["replaced_over_kernel"] = old_ms / ms
    row["plain_over_kernel"] = plain_ms / ms
    del x, scale, tree, ws
    # The tensor-core GEMV at every decode shape (M = 8 slots): gate and
    # up, the lm_head, wq and wo, wk and wv, down; int8mm.cu's GEMV, the
    # kernel it replaced on this route, on the same inputs.
    for label, m, k, n in (("int8mm", 8, 4096, 14336),
                           ("int8mm_lm_head", 8, 4096, 128256),
                           ("int8mm_decode_wq", 8, 4096, 4096),
                           ("int8mm_decode_wk", 8, 4096, 1024),
                           ("int8mm_decode_down", 8, 14336, 4096)):
        x, w_q, w_s = int8mm_inputs(Q, gen, m, k, n)
        route = I8._int8mm_route(x, w_q)
        if route != "gemv_sm90":
            raise AssertionError(f"{label}: route {route}, want gemv_sm90")
        nbytes = k * n + n * 4 + m * k * 2 + m * n * 2
        call = functools.partial(I8.int8_matmul, x, w_q, w_s, impl="cuda")
        ms = time_ms(call, flush)
        host_ms = time_ms(call, flush, shield=False)
        old_ms = time_ms(functools.partial(int8mm_gemv, kernels, I8, x, w_q,
                                           w_s), flush)
        plain_ms = time_ms(
            lambda: I8.int8_matmul(x, w_q, w_s, impl="torch"), flush)
        # Yardstick only: no PyTorch call takes int8 weights with
        # per-column scales; a bf16 matmul on a copy dequantized ahead.
        w_bf = (w_q.float() * w_s).to(torch.bfloat16)
        dense_ms = yardstick_ms(lambda: x @ w_bf, flush)
        timing[label] = {
            "shape": f"M={m}, K={k}, N={n}, bf16 x, int8 W",
            "route": route,
            "plan": I8.gemv_sm90_plan(m, k, n, sms)._asdict(),
            "ms": ms, "ms_with_host": host_ms, "old_gemv_ms": old_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "dequantized_bf16_matmul_ms": dense_ms,
            **bound(nbytes, 2 * m * k * n, rates),
        }
        row = timing[label]
        row["share_of_bound"] = row["bound_ms"] / ms
        row["old_over_kernel"] = old_ms / ms
        if isinstance(dense_ms, float):
            row["dequantized_over_kernel"] = dense_ms / ms
        del x, w_q, w_s, w_bf
    timing.update(int8mm_prefill_timing(kernels, I8, Q, gen, rates, flush))
    for label, int8, b, max_seq, length in (
        ("decode_attention", False, 8, 1024, 512),
        ("decode_attention_int8", True, 8, 1024, 512),
        ("decode_attention_long", False, 1, 8192, 8192),
    ):
        q, k_, v_, sc = contiguous_inputs(Q, gen, b=b, max_seq=max_seq,
                                          int8=int8)
        timing[label] = contiguous_timing(A, q, k_, v_, sc, length, rates,
                                          flush)
        del q, k_, v_, sc
    timing.update(flash_timing(A, kernels, gen, rates, flush))
    del flush
    emit("timing", iters=TIMING_ITERS, **timing)

    # --- 4b. the fused pick against its plain version -------------------------
    sampling = sampling_phase(S, SP, G, kernels, rates)
    emit("sampling", **sampling)

    # --- 5. small model: the card vs the CPU -----------------------------------
    tiny = dataclasses.replace(
        TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32, dim=256,
    )
    tparams = init_params(tiny, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    trace = [
        (f"t{i}", rng.integers(1, tiny.vocab_size,
                               rng.integers(3, 30)).astype(np.int32),
         int(rng.integers(4, 12)))
        for i in range(5)
    ]
    tiny_out = {}
    for label, quant in (("bf_config", {}),
                         ("w8kv8", {"kv_quant": "int8",
                                    "weight_quant": "int8"})):
        tec = E.EngineConfig(page_size=4, max_slots=3, max_pages_per_seq=12,
                             scan_chunk=3, prefill_chunk=8, **quant)
        outs = {
            dev: E.Engine(tiny, tparams, tec, device=dev).run([
                E.Request(rid=r, prompt=p, max_new_tokens=n)
                for r, p, n in trace
            ])
            for dev in ("cuda", "cpu")
        }
        tiny_out[f"engine_{label}_token_agreement"] = float(np.mean([
            np.mean(outs["cuda"][r].tokens == outs["cpu"][r].tokens)
            for r, _, _ in trace
        ]))
    prompt = rng.integers(1, tiny.vocab_size, (3, 20)).astype(np.int32)
    for kvq in ("none", "int8"):
        for wq in ("none", "int8"):
            outs = [
                G.greedy_generate(tiny, tparams, prompt, 10, kv_quant=kvq,
                                  weight_quant=wq, device=dev).numpy()
                for dev in ("cuda", "cpu")
            ]
            tiny_out[f"generate_kv_{kvq}_w_{wq}_identical"] = bool(
                np.array_equal(*outs))
    twin = dataclasses.replace(tiny, ffn_dim=512)  # tests/test_torch_train.py
    twin_tokens = np.random.default_rng(8).integers(
        0, twin.vocab_size, (2, 64)).astype(np.int32)
    twin_losses = {}
    for dev in ("cuda", "cpu"):
        tr = T.Trainer(twin, device=dev)
        st = tr.init_state(torch.Generator().manual_seed(0))
        step = tr.make_train_step()
        twin_losses[dev] = []
        for _ in range(3):
            st, loss = step(st, twin_tokens)
            twin_losses[dev].append(float(loss))
    tiny_out["train_losses"] = twin_losses
    tiny_out["train_loss_rel_diff"] = float(np.max(
        np.abs(np.subtract(twin_losses["cuda"], twin_losses["cpu"]))
        / np.abs(twin_losses["cpu"])))
    emit("tiny", requests=len(trace), **tiny_out)
    if tiny_out["train_loss_rel_diff"] > FP32_REL:
        raise AssertionError(f"tiny train card vs CPU: {twin_losses}")
    if tiny_out["engine_bf_config_token_agreement"] < 0.97:
        raise AssertionError(f"tiny engine card vs CPU: {tiny_out}")
    if tiny_out["engine_w8kv8_token_agreement"] != 1.0 or not all(
        v for k, v in tiny_out.items() if k.endswith("_identical")
    ):
        raise AssertionError(f"tiny int8 / generate card vs CPU: {tiny_out}")

    # --- 6. engine at Llama-3-8B widths, bf16 --------------------------------
    cfg = LLAMA3_8B
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ec = E.EngineConfig(page_size=16, max_slots=8, max_pages_per_seq=64,
                        scan_chunk=8, prefill_chunk=128)
    rng = np.random.default_rng(0)
    reqs = [
        E.Request(
            rid=f"q{i}",
            prompt=rng.integers(1, cfg.vocab_size,
                                int(rng.integers(64, 513))).astype(np.int32),
            max_new_tokens=int(rng.integers(32, 65)),
        )
        for i in range(8)
    ]
    eng, done, launches, wall = serve(E, kernels, cfg, params, ec, reqs)
    greedy_done = dict(done)  # the profile below adds its own requests
    del params
    steps = eng.decode_steps
    want_attn = L * steps
    want_mlp = L * (steps + eng.prefill_single_token_buckets)
    if not (launches["paged_decode_attention"] == want_attn > 0
            and launches["decode_mlp"] == launches["decode_mlp_sm90"]
            == want_mlp > 0
            and launches["int8mm"] == launches["int8mm_sm90"]
            == launches["int8mm_gemv_sm90"] == launches["int8mm_gemv"] == 0
            and launches["paged_decode_attention_int8"] == 0):
        raise AssertionError(
            f"launches {launches} != {L} per layer per decode step "
            f"({steps} steps)"
        )
    engine_launches = launches
    summary = serve_summary(eng, done, launches, wall)

    profile = profile_decode(E, eng, [
        np.resize(r.prompt, 128) for r in reqs
    ])
    emit("profile", **profile)
    # The MLP of every steady decode step: the tensor-core kernel's two
    # passes, one launch each a layer, and none of decode_mlp.cu's.
    if "mlp_kernels" in profile:
        per_step = {k: v["launches_per_step"]
                    for k, v in profile["mlp_kernels"].items()}
        sm90 = sum(v for k, v in per_step.items() if MLP_SM90_KERNEL in k)
        if sm90 != 2 * L or profile["mlp_launches_per_step"] != 2 * L:
            raise AssertionError(
                f"profile: decode MLP kernels a step {per_step}, want "
                f"{2 * L} {MLP_SM90_KERNEL} launches and nothing else")

    step_prompts = [r.prompt for r in reqs]
    steps_cmp = {"bf16": step_logits(E, I8, cfg, eng, step_prompts,
                                     STEP_VARIANTS)}
    del eng
    torch.cuda.empty_cache()
    # The same step at fp32 (the variants differ only in summation
    # order), and in bf16 with the depth cut to 2 layers (the rounding
    # noise of 2 layers, not amplified through 32).
    for name, c in (
        ("fp32", dataclasses.replace(
            cfg, dtype=torch.float32, param_dtype=torch.float32)),
        ("bf16_2_layers", dataclasses.replace(cfg, n_layers=2)),
    ):
        e = E.Engine(c, init_params(
            c, torch.Generator(device="cuda").manual_seed(0)), ec)
        steps_cmp[name] = step_logits(E, I8, c, e, step_prompts,
                                      STEP_VARIANTS)
        del e
        torch.cuda.empty_cache()
    emit(
        "engine", model="LLAMA3_8B widths, 32 layers, bf16, random weights",
        params=num_params(cfg), init_seconds=init_s, **summary,
        launches_per_decode_step={
            k: v / steps for k, v in launches.items()},
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    emit("decode_step", **steps_cmp, gates=step_gates(steps_cmp))

    # --- 7. engine at Llama-3-8B widths, int8 weights and KV ---------------
    torch.cuda.reset_peak_memory_stats()
    w8 = dataclasses.replace(ec, weight_quant="int8", kv_quant="int8")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    with RouteLog(I8) as w8_routes:
        eng, done, launches, wall = serve(E, kernels, cfg, params, w8, reqs)
    del params  # the engine holds the quantized tree only
    torch.cuda.empty_cache()
    steps = eng.decode_steps
    mm_per_pass = INT8MM_PER_LAYER * L + 1
    # Every launch with M > 16 (the prefill projections) on the wgmma
    # tile, every other (decode steps, the prefill lm_head over one row
    # a slot) on the tensor-core GEMV; int8mm.cu's GEMV never.
    routes = w8_routes.check("engine w8kv8")
    if not (launches["int8mm"] == mm_per_pass * (steps + eng.prefill_buckets)
            and launches["int8mm_sm90"] == routes["launches_by_route"].get(
                "sm90", 0) > 0
            and launches["int8mm_gemv_sm90"]
            == routes["launches_by_route"].get("gemv_sm90", 0) > 0
            and launches["int8mm_gemv"] == 0
            and launches["int8mm_sm90"] + launches["int8mm_gemv_sm90"]
            == launches["int8mm"]
            and launches["paged_decode_attention_int8"] == L * steps > 0
            and launches["paged_decode_attention"] == 0
            and launches["decode_mlp"] == launches["decode_mlp_sm90"] == 0):
        raise AssertionError(
            f"w8kv8 launches {launches}: want {mm_per_pass} int8mm per "
            f"forward pass ({steps} decode steps, {eng.prefill_buckets} "
            f"prefill buckets), the M > 16 ones on int8mm_sm90 and the "
            f"rest on int8mm_gemv_sm90 {routes}, "
            f"{L} int8 paged per step, no fused MLP"
        )
    pools_zero = all(
        bool((layer[1:] == 0).all())
        for _, pool in eng.cache._pools() for layer in pool
    )
    if not (eng.cache.quantized and pools_zero):
        raise AssertionError("w8kv8: freed pages (values, scales) not zero")
    w8_launches = launches
    w8_summary = serve_summary(eng, done, launches, wall)
    w8_summary["int8mm_routes"] = routes
    w8_summary["launches_per_decode_step"] = {
        "int8mm": (launches["int8mm"] - mm_per_pass * eng.prefill_buckets)
        / steps,
        "paged_decode_attention_int8":
            launches["paged_decode_attention_int8"] / steps,
        "decode_mlp": launches["decode_mlp"] / steps,
    }
    w8_profile = profile_decode(E, eng, [
        np.resize(r.prompt, 128) for r in reqs
    ])
    emit("profile_w8kv8", **w8_profile)
    # One launch a GEMV call: the steady decode steps run the
    # tensor-core GEMV only, 225 a step, and no second kernel.
    if "int8mm_kernels" in w8_profile:
        gemv = [k for k in w8_profile["int8mm_kernels"]
                if GEMV_SM90_KERNEL in k]
        per_step = sum(w8_profile["int8mm_kernels"][k]["launches_per_step"]
                       for k in gemv)
        if (per_step != mm_per_pass
                or w8_profile["int8mm_launches_per_step"] != mm_per_pass):
            raise AssertionError(
                f"profile_w8kv8: int8mm kernels a step "
                f"{w8_profile['int8mm_kernels']}, want {mm_per_pass} "
                f"{GEMV_SM90_KERNEL} launches and nothing else")
    # TTFT's first breakdown: one bucket of 8 rows x a 128-token chunk.
    emit("profile_prefill_w8kv8", **profile_prefill(E, I8, eng, [
        np.resize(r.prompt, 256) for r in reqs
    ]))
    w8_cmp = {"bf16": step_logits(E, I8, cfg, eng, step_prompts,
                                  W8_STEP_VARIANTS)}
    del eng
    torch.cuda.empty_cache()
    for name, c in (
        ("fp32", dataclasses.replace(
            cfg, dtype=torch.float32, param_dtype=torch.float32)),
        ("bf16_2_layers", dataclasses.replace(cfg, n_layers=2)),
    ):
        e = E.Engine(c, init_params(
            c, torch.Generator(device="cuda").manual_seed(0)), w8)
        torch.cuda.empty_cache()
        w8_cmp[name] = step_logits(E, I8, c, e, step_prompts,
                                   W8_STEP_VARIANTS)
        del e
        torch.cuda.empty_cache()
    emit("engine_w8kv8",
         model="LLAMA3_8B widths, 32 layers, bf16 activations, int8 "
               "weights and KV, random weights",
         **w8_summary,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("decode_step_w8kv8", **w8_cmp, gates=step_gates(w8_cmp))

    # --- 7b. the sampled engine ------------------------------------------------
    sampled = {"temperature": 0.8, "top_k": 40, "sample_seed": 11}
    sec = dataclasses.replace(ec, **sampled)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    eng, s_done, launches, wall = serve(E, kernels, cfg, params, sec, reqs)
    s_done = dict(s_done)  # the profile below adds its own requests
    steps = eng.decode_steps
    want = {"paged_decode_attention": L * steps,
            "decode_mlp": L * (steps + eng.prefill_single_token_buckets),
            "decode_mlp_sm90": L * (steps + eng.prefill_single_token_buckets),
            "sample_pick": steps + len(reqs), "int8mm": 0}
    if steps <= 0 or any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"engine_sampled: launches {launches}, want "
                             f"{want}")
    sampled_launches = launches
    s_summary = serve_summary(eng, s_done, launches, wall)
    s_profile = profile_decode(E, eng, [np.resize(r.prompt, 128)
                                        for r in reqs])
    del eng
    torch.cuda.empty_cache()
    _, s_oracle, _, _ = serve(
        E, kernels, cfg, params,
        dataclasses.replace(sec, fused=False, contiguous=True), reqs)
    del params
    torch.cuda.empty_cache()
    if first_difference(s_done, s_oracle) is not None:
        raise AssertionError(
            f"engine_sampled: fused vs unfused contiguous differ at "
            f"{first_difference(s_done, s_oracle)}")
    extra = None
    if "kernel_launches_per_step" in s_profile and (
            "kernel_launches_per_step" in profile):
        extra = (s_profile["kernel_launches_per_step"]
                 - profile["kernel_launches_per_step"])
        if extra > 16:
            raise AssertionError(
                f"engine_sampled: {extra} more launches a decode step than "
                f"greedy (bar 16)")
    tsec = E.EngineConfig(page_size=4, max_slots=3, max_pages_per_seq=12,
                          scan_chunk=3, prefill_chunk=8, **sampled)
    tiny_sampled = {
        dev: E.Engine(tiny, tparams, tsec, device=dev).run([
            E.Request(rid=r, prompt=p, max_new_tokens=n)
            for r, p, n in trace])
        for dev in ("cuda", "cpu")
    }
    identical_or_explain(G, tiny, tparams, trace, tiny_sampled["cuda"],
                         tiny_sampled["cpu"], "tiny sampled card vs CPU")
    emit("engine_sampled",
         model="LLAMA3_8B widths, 32 layers, bf16, random weights",
         sampling=sampled, **s_summary,
         fused_vs_unfused_contiguous_identical=True,
         tiny_fp32_card_vs_cpu_identical=True,
         greedy={"decode_tok_s": summary["decode_tok_s"],
                 "ttft_p50_s": summary["ttft_p50_s"],
                 "kernel_launches_per_step":
                     profile.get("kernel_launches_per_step"),
                 "device_ms_per_step": profile.get("device_ms_per_step")},
         launches_per_decode_step=s_profile.get("kernel_launches_per_step"),
         extra_launches_per_step_vs_greedy=extra,
         profile={k: s_profile.get(k) for k in (
             "device_ms_per_step", "step_ms", "device_busy_share",
             "kernel_launches_per_step", "decode_steps", "top_kernels")},
         sample_pick_launches=launches["sample_pick"])

    # --- 7c. speculative decoding ----------------------------------------------
    spec_out = {}
    rng_spec = np.random.default_rng(3)
    lookup = []
    for i in range(4):
        motif = rng_spec.integers(1, tiny.vocab_size, 5).astype(np.int32)
        lookup.append((f"lk{i}", np.tile(motif, 4)[:18], 16))
    spec_ec = dict(page_size=4, max_slots=3, max_pages_per_seq=16,
                   scan_chunk=3, prefill_chunk=8)
    for label, kw in (("greedy", {}), ("sampled", sampled),
                      ("w8kv8_greedy", {"kv_quant": "int8",
                                        "weight_quant": "int8"}),
                      ("w8kv8_sampled", {"kv_quant": "int8",
                                         "weight_quant": "int8",
                                         **sampled})):
        runs = {}
        for name, extra_kw in (("spec", {"spec_k": 4}),
                               ("oracle", {"fused": False,
                                           "contiguous": True})):
            e = E.Engine(tiny, tparams,
                         E.EngineConfig(**spec_ec, **kw, **extra_kw),
                         device="cuda")
            runs[name] = (e, e.run([
                E.Request(rid=r, prompt=p, max_new_tokens=n)
                for r, p, n in lookup]))
        e = runs["spec"][0]
        identical_or_explain(G, tiny, tparams, lookup, runs["spec"][1],
                             runs["oracle"][1], f"tiny spec {label}")
        pool_whole_and_zero(e, f"tiny spec {label}")
        spec_out[f"tiny_{label}"] = {
            "identical_to_oracle": True, "proposed": e.spec_proposed,
            "accepted": e.spec_accepted, "verify_passes": e.verify_passes}
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    spec8 = dataclasses.replace(ec, spec_k=4)
    for label, draft in (("ngram", SD.NgramDraft(spec8.spec_lookup_order)),
                         ("replay", ReplayDraft(reqs, greedy_done))):
        e = E.Engine(cfg, params, spec8, draft_source=draft)
        kernels.reset_launches()
        t0 = time.perf_counter()
        d = e.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pool_whole_and_zero(e, f"8B spec {label}")
        tokens = sum(len(c.tokens) - 1 for c in d.values())
        spec_out[label] = {
            "proposed": e.spec_proposed, "accepted": e.spec_accepted,
            "acceptance": e.spec_accepted / max(e.spec_proposed, 1),
            "verify_passes": e.verify_passes,
            "decode_tok_s": tokens / e.decode_seconds,
            "non_spec_decode_tok_s": summary["decode_tok_s"],
            "wall_seconds": wall,
            "token_agreement_with_non_spec": token_agreement(d,
                                                             greedy_done),
            "launches": dict(kernels.LAUNCHES),
        }
        if not all(len(d[r.rid].tokens) == r.max_new_tokens for r in reqs):
            raise AssertionError(f"8B spec {label}: token counts")
        del e
        torch.cuda.empty_cache()
    # int8 weights and KV: the verify pass's matmuls (M = 8 slots x 5
    # positions = 40) take the wgmma tile.
    w8spec = dataclasses.replace(w8, spec_k=4)
    e = E.Engine(cfg, params, w8spec)
    del params
    torch.cuda.empty_cache()
    kernels.reset_launches()
    with RouteLog(I8) as spec_routes:
        d = e.run(reqs)
    torch.cuda.synchronize()
    pool_whole_and_zero(e, "8B spec w8kv8")
    launches = dict(kernels.LAUNCHES)
    routes = spec_routes.check("8B spec w8kv8")
    # Prefill buckets have power-of-two row and chunk counts, so M = 40
    # is the verify pass alone: every matmul of every pass on the tile.
    verify_m = w8spec.max_slots * (w8spec.spec_k + 1)
    verify_sm90 = sum(1 for m, r in spec_routes.calls
                      if m == verify_m and r == "sm90")
    if not (e.verify_passes > 0
            and verify_sm90 == mm_per_pass * e.verify_passes
            and launches["int8mm_sm90"] >= verify_sm90
            and launches["int8mm_gemv"] == 0
            and launches["paged_decode_attention_int8"] == 0
            and launches["decode_mlp"] == 0):
        raise AssertionError(
            f"8B spec w8kv8: launches {launches}, {verify_sm90} int8mm_sm90 "
            f"launches at M = {verify_m}, want {mm_per_pass} a verify pass "
            f"({e.verify_passes} passes)")
    spec_out["w8kv8_ngram"] = {
        "proposed": e.spec_proposed, "accepted": e.spec_accepted,
        "verify_passes": e.verify_passes, "launches": launches,
        "int8mm_routes": routes,
        "verify_int8mm_sm90_launches": verify_sm90,
        "decode_tok_s": sum(len(c.tokens) - 1 for c in d.values())
        / e.decode_seconds,
        "non_spec_decode_tok_s": w8_summary["decode_tok_s"],
    }
    del e
    torch.cuda.empty_cache()
    emit("engine_spec", model="LLAMA3_8B widths, 32 layers, spec_k 4, "
                              "random weights", **spec_out)

    # --- 8. greedy_generate at Llama-3-8B widths -----------------------------
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    b, s, new = 8, 256, 32
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(1, cfg.vocab_size, (b, s))
        .astype(np.int32))
    gen_out, gen_launches, tokens = {}, {}, {}
    for label, quant in (("bf16", "none"), ("w8kv8", "int8")):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RouteLog(I8) as gen_routes:
            out = G.greedy_generate(cfg, params, prompt, new, kv_quant=quant,
                                    weight_quant=quant)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        gen_launches[label] = launches
        steps = new - 1
        want = {"decode_attention": L * steps}
        # The prefill (b x s = 2048 rows, the lm_head over every
        # position) on the wgmma tile, every decode step on the
        # tensor-core GEMV.
        if quant == "none":
            want.update(decode_mlp=L * steps, decode_mlp_sm90=L * steps,
                        int8mm=0, int8mm_sm90=0, int8mm_gemv_sm90=0,
                        int8mm_gemv=0)
        else:
            want.update(decode_mlp=0, decode_mlp_sm90=0,
                        int8mm=mm_per_pass * new,
                        int8mm_sm90=mm_per_pass,
                        int8mm_gemv_sm90=mm_per_pass * steps, int8mm_gemv=0)
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"generate {label}: launches {launches}, "
                                 f"want {want}")
        if not (out.shape == (b, s + new)
                and torch.equal(out[:, :s], prompt)
                and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size):
            raise AssertionError(f"generate {label}: bad output {out.shape}")
        tokens[label] = out[:, s:]
        gen_out[label] = {
            "wall_seconds": wall, "tok_s": b * new / wall,
            "launches": launches,
            "int8mm_routes": gen_routes.check(f"generate {label}"),
            "launches_per_decode_step": {
                "decode_attention": launches["decode_attention"] / steps,
                "decode_mlp": launches["decode_mlp"] / steps,
                "decode_mlp_sm90": launches["decode_mlp_sm90"] / steps,
                "int8mm": (launches["int8mm"] - (mm_per_pass if quant
                                                 == "int8" else 0)) / steps,
            },
        }
    del params
    torch.cuda.empty_cache()
    emit("generate", model="LLAMA3_8B widths, 32 layers, random weights",
         batch=b, prompt=s, new_tokens=new, **gen_out,
         w8kv8_vs_bf16_token_agreement=float(
             (tokens["bf16"] == tokens["w8kv8"]).float().mean()))

    # --- 9. training at Llama-3-8B widths, 4 layers ------------------------
    train = train_phase(T, kernels, LLAMA3_8B, init_params,
                        train_flops_per_token, rates)
    emit("train", **train)

    # --- kernel list and result ----------------------------------------------
    rows = []
    for name, source, replaces, par, t, n_launch in (
        ("paged_decode_attention", "tpu_dra_torch/csrc/paged_decode.cu",
         "tpu_dra/workloads/ops/attention.py:1128",
         parity["paged_decode_attention"], timing["paged_decode_attention"],
         engine_launches["paged_decode_attention"]),
        ("decode_mlp", "tpu_dra_torch/csrc/decode_mlp_sm90.cu",
         "tpu_dra/workloads/ops/decode_mlp.py:102", parity["decode_mlp_b8"],
         timing["decode_mlp"], engine_launches["decode_mlp_sm90"]),
        # The int8 matmul's two routes on the path: the tensor-core GEMV
        # for M <= 16 (decode) and the wgmma tile for M > 16 (prefill).
        ("int8mm_gemv_sm90", "tpu_dra_torch/csrc/int8mm_gemv_sm90.cu",
         "tpu_dra/workloads/ops/int8mm.py:47",
         parity["int8mm_m8_k4096_n14336"], timing["int8mm"],
         w8_launches["int8mm_gemv_sm90"]),
        ("int8mm_sm90", "tpu_dra_torch/csrc/int8mm_sm90.cu",
         "tpu_dra/workloads/ops/int8mm.py:47",
         parity["int8mm_m1024_k4096_n14336"], timing["int8mm_prefill"],
         w8_launches["int8mm_sm90"]),
        ("decode_attention", "tpu_dra_torch/csrc/decode.cu",
         "tpu_dra/workloads/ops/attention.py:803",
         parity["decode_attention"]["length_1000"],
         timing["decode_attention"],
         sum(v["decode_attention"] for v in gen_launches.values())),
        ("paged_decode_attention_int8", "tpu_dra_torch/csrc/paged_decode.cu",
         "tpu_dra/workloads/ops/attention.py:1128",
         parity["paged_decode_attention_int8"],
         timing["paged_decode_attention_int8"],
         w8_launches["paged_decode_attention_int8"]),
    ) + tuple(
        (name, f"tpu_dra_torch/csrc/{source}",
         f"tpu_dra/workloads/ops/attention.py:{line}",
         {"vs_plain": parity["flash_s2048_causal_bf16"][f"{out}_vs_plain"]},
         timing[name], train["launches"][counter])
        for name, source, counter, line, out in (
            ("flash_fwd", "flash_fwd_sm90.cu", "flash_fwd_sm90", 92, "out"),
            ("flash_bwd_dq", "flash_bwd_dq_sm90.cu", "flash_bwd_dq_sm90",
             178, "dq"),
            ("flash_bwd_dkv", "flash_bwd_sm90.cu", "flash_bwd_dkv_sm90",
             239, "dk"))
    ):
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": par["vs_plain"]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "ms_with_host": t["ms_with_host"],
            "parity": par,
        })
        if name == "int8mm_gemv_sm90":
            rows[-1]["replaced_kernel_ms"] = t["old_gemv_ms"]
        if name == "decode_mlp":
            rows[-1].update(counter="decode_mlp_sm90",
                            replaced_kernel_ms=t["replaced_kernel_ms"],
                            library_note=t["library_note"])
        if name.startswith("int8mm"):
            rows[-1]["serves"] = {
                "int8mm_gemv_sm90": "gemv_sm90: bf16 M <= 16 (decode steps, "
                                    "the engine prefill's lm_head)",
                "int8mm_sm90": "sm90: bf16 M > 16 (prefill projections, the "
                               "generate lm_head)",
            }[name]
    pick = sampling["timing"]["t0.8_k40"]
    pick_cases = sampling["cases"]
    rows.append({
        "name": "sample_pick", "route": "cuda",
        "source": "tpu_dra_torch/csrc/sample.cu",
        "replaces": "tpu_dra/workloads/generate.py:559",
        "launches": sampled_launches["sample_pick"],
        "max_abs_err": max(c["max_abs_err"] for c in pick_cases.values()),
        "ms": pick["ms"], "plain_ms": pick["plain_ms"],
        "bound_ms": pick["bound_ms"], "bound_by": pick["bound_by"],
        "library_ms": None, "ms_with_host": pick["ms_with_host"],
        "argmax_ms": pick["argmax_ms"],
        "parity": {"cases": len(pick_cases), "tokens_identical": all(
            c["tokens_vs_plain_identical"] for c in pick_cases.values())},
        "note": "no Pallas kernel: the JAX sampler is an XLA fusion; "
                "replaces names the function it computes",
    })
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
