#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_dra_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without a result:

1. device  — needs CUDA (else exits 1 at once); prints the card's name
   and power limit as nvidia-smi reports them; TF32 off.
2. build   — builds every kernel from tpu_dra_torch/csrc with nvcc
   (one process per source, in parallel) into build/torch_kernels/.
3. parity  — each kernel against its plain PyTorch version and the fp32
   reference, in bf16 at Llama-3-8B widths (h=32, kvh=8, hd=128,
   d=4096, ffn=14336): paged decode with B=8, page 16, 513 pages and
   lengths [0,1,15,16,17,255,512,1000]; decode MLP with B in {1, 8}.
   Tolerance: rtol 2e-2 plus, per row (one head of one slot, one
   token of the MLP), an atol of two bf16 ulps of that row's largest
   |reference| value.
4. timing  — CUDA events around single launches after warm-up, L2
   flushed before each, median of 60: kernel, plain version, and the
   least time the card could take (bytes over the memory rate vs
   operations over the bf16 peak, whichever is larger).
5. tiny    — fp32 TINY_LLAMA through the engine on the card (kernels)
   and on the CPU (plain versions): greedy tokens must agree.
6. engine  — Llama-3-8B widths, all 32 layers, vocab 128256, bf16,
   random weights from a seeded CUDA generator; 8 seeded requests
   (prompts 64-512, 32-64 new tokens) through the paged engine. Every
   request completes with its token count, the allocator ends
   leak-free, and both kernels launch once per layer per decode step.
   Then, with all 8 slots decoding the same prompts, one decode step
   runs from one state with kernels, plain versions, fp32 reference
   versions and each kernel alone (STEP_VARIANTS): with fp32 weights
   every pair's logits agree above cosine 0.9999; in bf16 see
   step_gates. The same step with the depth cut to 2 layers, in bf16,
   holds every pair above 0.999.

The line before last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
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
# name nvidia-smi reports: (memory bytes/s, dense bf16 flop/s).
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H100": (3.35e12, 989e12),  # SXM: "NVIDIA H100 80GB HBM3"
}
TIMING_ITERS = 60
BF16_RTOL = 2e-2
# Bars for the decode-step logits of the STEP_VARIANTS (step_gates).
FP32_COSINE = 0.9999
BF16_COSINE = 0.999
BF16_GAP_RATIO = 1.5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bf16_row_atol(ref: torch.Tensor) -> torch.Tensor:
    """Per-row atol for a bf16 result against the fp32 reference: two
    bf16 ulps of each row's own largest |reference| value (a row is the
    last axis: one head of one slot, or one token of the MLP), so a
    row of small values is held to its own scale. A row of zeros must
    come out exactly zero."""
    top = ref.float().abs().amax(dim=-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return torch.where(top > 0, 2 * ulp, torch.zeros_like(top))


def compare(name: str, got, ref, rtol: float = BF16_RTOL) -> dict:
    """Every element within its row's atol plus rtol * |ref|."""
    got, ref = got.float(), ref.float()
    atol = bf16_row_atol(ref)
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


def time_ms(fn, flush: torch.Tensor) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(TIMING_ITERS):
        flush.zero_()  # evict the inputs from the 50 MB L2
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def peaks(name: str) -> tuple:
    for key, rates in PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peaks for {name!r}")


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


# The decode step is run once per variant: (paged_decode_impl,
# decode_mlp_impl), "auto" being the kernel on the card.
STEP_VARIANTS = {
    "kernels": ("auto", "auto"),
    "torch": ("torch", "torch"),
    "reference": ("reference", "reference"),
    "attn_kernel": ("auto", "torch"),
    "mlp_kernel": ("torch", "auto"),
}


def step_logits(E, cfg, eng, prompts) -> dict:
    """Admit ``prompts`` into ``eng`` and step until every slot decodes,
    then run one ``_decode_step`` from that state once per
    STEP_VARIANTS entry and compare the logits row by row (cosine,
    worst row). The engine then finishes its requests."""
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
    for name, (paged, mlp) in STEP_VARIANTS.items():
        c = dataclasses.replace(
            cfg, paged_decode_impl=paged, decode_mlp_impl=mlp)
        logits[name] = E._decode_step(c, eng.params, eng.cache, *state)[2]
    eng.run()

    def cosine(a, b):
        return torch.nn.functional.cosine_similarity(
            logits[a], logits[b], dim=-1).min().item()

    pairs = [("kernels", "torch"), ("kernels", "reference"),
             ("torch", "reference"), ("attn_kernel", "torch"),
             ("mlp_kernel", "torch")]
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
    return {
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on the card",
              file=sys.stderr)
        return 1
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from tpu_dra_torch import kernels
    from tpu_dra_torch.workloads import engine as E
    from tpu_dra_torch.workloads.models.llama import (
        LLAMA3_8B,
        TINY_LLAMA,
        init_params,
        num_params,
    )
    from tpu_dra_torch.workloads.ops import attention as A
    from tpu_dra_torch.workloads.ops import decode_mlp as DM

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
    mem_rate, bf16_rate = peaks(kind)
    emit("device", kind=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, mem_bytes_per_s=mem_rate,
         bf16_flops_per_s=bf16_rate)

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    report = kernels.build()
    emit("build", seconds=time.perf_counter() - t0,
         per_source={k: v["seconds"] for k, v in report.items()})

    # --- 3. parity at 8B widths, bf16 ---------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(1234)
    parity = {}
    args = paged_inputs(gen, [0, 1, 15, 16, 17, 255, 512, 1000])
    got = A.paged_decode_attention(*args, impl="cuda")
    plain = A.paged_decode_attention(*args, impl="torch")
    ref = A.paged_decode_attention(*args, impl="reference")
    torch.cuda.synchronize()
    parity["paged_decode_attention"] = {
        "vs_plain": compare("paged vs plain", got, plain),
        "vs_reference": compare("paged vs reference", got, ref),
        "dead_slot_exact_zero": bool(torch.all(got[0] == 0)),
    }
    if not parity["paged_decode_attention"]["dead_slot_exact_zero"]:
        raise AssertionError("a length-0 slot must give exact zeros")
    for b in (1, 8):
        x, scale, tree = mlp_inputs(gen, b)
        got = DM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
        plain = DM.decode_mlp(x, scale, tree, 1e-5, impl="torch")
        ref = DM.decode_mlp(x, scale, tree, 1e-5, impl="reference")
        again = DM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
        torch.cuda.synchronize()
        parity[f"decode_mlp_b{b}"] = {
            "vs_plain": compare(f"mlp b={b} vs plain", got, plain),
            "vs_reference": compare(f"mlp b={b} vs reference", got, ref),
            "rerun_bit_identical": bool(torch.equal(got, again)),
        }
        if not parity[f"decode_mlp_b{b}"]["rerun_bit_identical"]:
            raise AssertionError("decode_mlp reruns must give identical bits")
    emit("parity", **parity)

    # --- 4. kernel times -----------------------------------------------------
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    timing = {}
    lengths = [512] * 8
    q, kp, vp, tables, lens = paged_inputs(gen, lengths)
    b, h, hd = q.shape
    kvh, page = kp.shape[2], kp.shape[1]
    live = sum(lengths)
    pages_read = sum(-(-n // page) for n in lengths)
    nbytes = (2 * q.numel() * 2 + live * kvh * hd * 2 * 2
              + pages_read * 4 + b * 4)
    flops = 4 * live * h * hd
    ms = time_ms(lambda: A.paged_decode_attention(
        q, kp, vp, tables, lens, impl="cuda"), flush)
    plain_ms = time_ms(lambda: A.paged_decode_attention(
        q, kp, vp, tables, lens, impl="torch"), flush)
    # Yardstick only (not the same inputs): SDPA over the same live K/V
    # already gathered into contiguous [B, kvh, L, hd] buffers.
    kc = A._gather_flat(kp, tables)[:, :512].permute(0, 2, 1, 3).contiguous()
    vc = A._gather_flat(vp, tables)[:, :512].permute(0, 2, 1, 3).contiguous()
    try:
        sdpa_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kc, vc, enable_gqa=True), flush)
    except RuntimeError as e:  # a yardstick only: record why it is absent
        sdpa_ms = f"not measured: {e}"[:200]
    t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / bf16_rate * 1e3
    timing["paged_decode_attention"] = {
        "shape": "B=8 x 512 tokens, page 16, h=32 kvh=8 hd=128, bf16",
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "sdpa_contiguous_ms": sdpa_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    del q, kp, vp, tables, lens, kc, vc
    x, scale, tree = mlp_inputs(gen, 8)
    d, ffn = x.shape[1], tree["w_gate"]["kernel"].shape[1]
    nbytes = 3 * d * ffn * 2 + d * 2 + 2 * x.numel() * 2
    flops = 2 * x.shape[0] * d * ffn * 3
    ms = time_ms(lambda: DM.decode_mlp(x, scale, tree, 1e-5, impl="cuda"),
                 flush)
    plain_ms = time_ms(
        lambda: DM.decode_mlp(x, scale, tree, 1e-5, impl="torch"), flush)
    t_bytes, t_ops = nbytes / mem_rate * 1e3, flops / bf16_rate * 1e3
    timing["decode_mlp"] = {
        "shape": "B=8, d=4096, ffn=14336, bf16",
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
    }
    del x, scale, tree, flush
    emit("timing", iters=TIMING_ITERS, **timing)

    # --- 5. small model: the card's engine vs the CPU engine -----------------
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
    tec = E.EngineConfig(page_size=4, max_slots=3, max_pages_per_seq=12,
                         scan_chunk=3, prefill_chunk=8)
    outs = {
        dev: E.Engine(tiny, tparams, tec, device=dev).run([
            E.Request(rid=r, prompt=p, max_new_tokens=n) for r, p, n in trace
        ])
        for dev in ("cuda", "cpu")
    }
    agree = float(np.mean([
        np.mean(outs["cuda"][r].tokens == outs["cpu"][r].tokens)
        for r, _, _ in trace
    ]))
    emit("tiny", token_agreement=agree, requests=len(trace))
    if agree < 0.97:
        raise AssertionError(f"tiny engine card vs CPU agreement {agree}")

    # --- 6. engine at Llama-3-8B widths --------------------------------------
    cfg = LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ec = E.EngineConfig(page_size=16, max_slots=8, max_pages_per_seq=64,
                        scan_chunk=8, prefill_chunk=128)
    eng = E.Engine(cfg, params, ec)
    del params
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
    kernels.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps, decode_s = eng.decode_steps, eng.decode_seconds
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
    L = cfg.n_layers
    want_attn = L * steps
    want_mlp = L * (steps + eng.prefill_single_token_buckets)
    if not (launches["paged_decode_attention"] == want_attn > 0
            and launches["decode_mlp"] == want_mlp > 0):
        raise AssertionError(
            f"launches {launches} != {L} per layer per decode step "
            f"({steps} steps)"
        )
    decode_tokens = sum(len(c.tokens) - 1 for c in done.values())
    ttft = sorted(c.ttft_s for c in done.values())

    profile = profile_decode(E, eng, [
        np.resize(r.prompt, 128) for r in reqs
    ])
    emit("profile", **profile)

    step_prompts = [r.prompt for r in reqs]
    steps_cmp = {"bf16": step_logits(E, cfg, eng, step_prompts)}
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
        steps_cmp[name] = step_logits(E, c, e, step_prompts)
        del e
        torch.cuda.empty_cache()
    emit(
        "engine", model="LLAMA3_8B widths, 32 layers, bf16, random weights",
        params=num_params(cfg), init_seconds=init_s, requests=len(reqs),
        wall_seconds=wall, decode_steps=steps, decode_seconds=decode_s,
        decode_tokens=decode_tokens, decode_tok_s=decode_tokens / decode_s,
        ttft_p50_s=ttft[len(ttft) // 2], launches=launches,
        launches_per_decode_step={k: v / steps for k, v in launches.items()},
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    emit("decode_step", **steps_cmp, gates=step_gates(steps_cmp))

    # --- kernel list and result ----------------------------------------------
    rows = []
    for name, source, replaces, par in (
        ("paged_decode_attention", "tpu_dra_torch/csrc/paged_decode.cu",
         "tpu_dra/workloads/ops/attention.py:1128",
         parity["paged_decode_attention"]),
        ("decode_mlp", "tpu_dra_torch/csrc/decode_mlp.cu",
         "tpu_dra/workloads/ops/decode_mlp.py:102", parity["decode_mlp_b8"]),
    ):
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": par["vs_plain"]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "parity": par,
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
