"""Serving-engine bench and smoke of the port: the counterpart of
``tpu_dra/workloads/enginebench.py``, over the port's ``Engine`` and
``greedy_generate``.

    python -m tpu_dra_torch.workloads.enginebench [--smoke] [--device cpu]
    python -m tpu_dra_torch.workloads.enginebench --serve [--device cpu]

The measurement core:

- seeded traces (:func:`make_trace`, :func:`make_lookup_trace`): the
  same numpy draws in the same order as the JAX module, so one seed
  gives the same prompts, lengths, arrivals and rids in both packages;
- the fixed-batch baseline (:func:`run_fixed_batch_baseline`): batches
  of ``batch`` in arrival order, each launched once its last member has
  arrived, prompts left-padded to the trace's longest, decoding the
  longest output, with the honest padding accounting of
  :func:`fixed_batch_padding_waste`;
- the engine replay (:func:`run_engine_trace`) at equal batch memory
  (:func:`equal_memory_engine_config`), after a warmup of one request
  per power-of-two prefill bucket, as the JAX module warms its jit
  caches (it also advances the engine's sampling serials as JAX's
  does, so sampled tokens stay JAX's);
- copy-on-write prefix sharing (:func:`run_prefix_fleet`) and batched
  against serial prefill (:func:`run_prefill_ttft_pair`);
- :func:`run_serve_bench`, the serve measurement: every arm above, with
  the ``BENCH_SERVE_*``, ``BENCH_SPEC_K`` and ``BENCH_PREFIX_FLEET``
  keys of the JAX module and its defaults, and the same result keys.

Times are host seconds around work that ends in a synchronize of the
device. Beside JAX's keys, :func:`run_engine_trace` returns the
engine's own decode timer (``decode_seconds``: host seconds in decode
chunks, each ending in its device->host copy), from which decode tok/s
reads off the same run.

The smoke (``--smoke``, the default) holds the engine to the JAX
smoke's asserts on a tiny fp32 model: paged and fused against the
contiguous per-token oracle, token for token, greedy and sampled;
every request completes once with its token count and the allocator
ends whole and zero; a lease revocation drains and resumes with every
pre-drain token kept; the padding accounting; int8 KV and int8 weights
agreeing with fp32 on at least 0.9 of the positions, each picked from
the fp32 run's context. ``--serve`` runs
:func:`run_serve_bench` over the process environment: Llama-3-8B widths
at 32 layers with random weights on the card, the tiny model at
bench.py's drill sizes on ``--device cpu``. Each prints one JSON line
and exits non-zero on any violation. Entry points run on the card
unless given ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from tpu_dra_torch.workloads import paged_kv
from tpu_dra_torch.workloads.device import resolve_device, synchronize
from tpu_dra_torch.workloads.engine import (
    Engine,
    EngineConfig,
    EventGate,
    Request,
)
from tpu_dra_torch.workloads.generate import greedy_generate
from tpu_dra_torch.workloads.models.llama import as_tree

# --- seeded Poisson arrival trace -------------------------------------------


def make_trace(
    seed: int,
    n_requests: int,
    rate_rps: float,
    prompt_lens,
    output_lens,
    vocab: int,
):
    """Seeded trace: exponential inter-arrivals (a Poisson process at
    ``rate_rps``), prompt/output lengths drawn uniformly from the given
    mixes, prompt tokens uniform over [1, vocab). Returns a list of
    engine Requests (arrival_s is the offset from trace start)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    reqs = []
    for i in range(n_requests):
        plen = int(rng.choice(prompt_lens))
        olen = int(rng.choice(output_lens))
        reqs.append(
            Request(
                rid=f"r{i:04d}",
                prompt=rng.integers(1, vocab, plen).astype(np.int32),
                max_new_tokens=olen,
                arrival_s=float(arrivals[i]),
            )
        )
    return reqs


def make_lookup_trace(
    seed: int,
    n_requests: int,
    rate_rps: float,
    prompt_lens,
    output_lens,
    vocab: int,
):
    """Lookup-friendly twin of :func:`make_trace`: each prompt is a
    short random motif tiled to the drawn length, so the n-gram draft
    source has structure to hit. Same arrival process and length mixes
    as make_trace, from the generator seeded ``seed + 777``."""
    rng = np.random.default_rng(seed + 777)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    reqs = []
    for i in range(n_requests):
        plen = int(rng.choice(prompt_lens))
        olen = int(rng.choice(output_lens))
        motif = rng.integers(
            1, vocab, max(2, plen // 4)
        ).astype(np.int32)
        prompt = np.tile(motif, -(-plen // len(motif)))[:plen]
        reqs.append(
            Request(
                rid=f"lk{i:04d}",
                prompt=prompt,
                max_new_tokens=olen,
                arrival_s=float(arrivals[i]),
            )
        )
    return reqs


def trace_stats(trace) -> dict:
    return {
        "requests": len(trace),
        "prompt_tokens": int(sum(len(r.prompt) for r in trace)),
        "output_tokens": int(sum(r.max_new_tokens for r in trace)),
        "max_prompt": max(len(r.prompt) for r in trace),
        "max_output": max(r.max_new_tokens for r in trace),
    }


# --- token comparisons -------------------------------------------------------


def first_difference(a: dict, b: dict):
    """(rid, position) of the first token where two runs' completions
    differ, or None."""
    for rid in sorted(a):
        ta, tb = a[rid].tokens, b[rid].tokens
        n = min(len(ta), len(tb))
        diff = np.flatnonzero(ta[:n] != tb[:n])
        if diff.size or len(ta) != len(tb):
            return rid, int(diff[0]) if diff.size else n
    return None


def token_agreement(a: dict, b: dict) -> float:
    """Mean over requests of the share of positions where two runs'
    tokens agree."""
    return float(np.mean([np.mean(a[r].tokens == b[r].tokens) for r in a]))


class MetricsRecorder:
    """The engine's ``metrics`` duck type (inc, set_gauge, observe):
    counters summed, each gauge's largest value, every observation
    kept."""

    def __init__(self):
        self.counters, self.gauge_max, self.observed = {}, {}, {}

    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        self.gauge_max[name] = max(self.gauge_max.get(name, value), value)

    def observe(self, name: str, value: float) -> None:
        self.observed.setdefault(name, []).append(value)


def _free(device: torch.device) -> None:
    """Return a dropped engine's memory to the card before the next."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# --- fixed-batch baseline (the system the engine replaces) -------------------


def fixed_batch_padding_waste(trace, batch: int) -> dict:
    """Pure accounting for the fixed-batch system: requests grouped in
    arrival order into batches of ``batch``, every prompt padded to the
    global max prompt and every output to the global max output (one
    shape for every batch). Decode waste is the fraction of decoded
    token-steps that served padding instead of a real request token."""
    stats = trace_stats(trace)
    n_batches = -(-len(trace) // batch)
    padded_decode = n_batches * batch * stats["max_output"]
    useful_decode = stats["output_tokens"]
    return {
        "n_batches": n_batches,
        "padded_decode_tokens": padded_decode,
        "useful_decode_tokens": useful_decode,
        "decode_padding_waste": round(1.0 - useful_decode / padded_decode, 4),
    }


def run_fixed_batch_baseline(
    config, params, trace, batch: int, kv_quant: str = "none", device=None
) -> dict:
    """Measure the fixed-batch system on the trace: batches of
    ``batch`` in arrival order, prompts padded to the global max prompt,
    decoding the global max output through ``greedy_generate``. One
    untimed call of the same shapes (prompt, cache size) warms the
    path first. Reports both the padded-token rate and useful-token
    throughput, plus per-request completion latency quantiles (a
    request completes when its whole batch does)."""
    device = resolve_device(device)
    tree = as_tree(params, device)
    acc = fixed_batch_padding_waste(trace, batch)
    stats = trace_stats(trace)
    P, O = stats["max_prompt"], stats["max_output"]
    max_seq = -(-(P + O) // 64) * 64  # greedy_generate's own sizing

    def generate(tokens, new_tokens):
        return greedy_generate(
            config, tree, torch.as_tensor(tokens), new_tokens,
            max_seq=max_seq, kv_quant=kv_quant, device=device,
        )

    generate(np.ones((batch, P), np.int32), min(O, 2))
    synchronize(device)

    lat = []
    t0 = time.monotonic()
    for b0 in range(0, len(trace), batch):
        group = trace[b0:b0 + batch]
        # A fixed-batch server cannot launch a batch before its last
        # member arrives (batches form in arrival order): the wait is
        # part of the system measured, and it keeps latencies
        # non-negative.
        gate = max(r.arrival_s for r in group)
        wait = gate - (time.monotonic() - t0)
        if wait > 0:
            time.sleep(wait)
        toks = np.ones((batch, P), np.int32)
        for i, r in enumerate(group):
            # Right-aligned: every prompt's last token sits at the
            # decode boundary (left padding, the fixed-batch convention).
            toks[i, P - len(r.prompt):] = r.prompt
        generate(toks, O)
        synchronize(device)
        done = time.monotonic() - t0
        lat.extend(done - r.arrival_s for r in group)
    wall = time.monotonic() - t0
    lat_ms = sorted(x * 1000 for x in lat)
    return {
        **acc,
        "wall_seconds": round(wall, 3),
        "padded_tok_s": round(acc["padded_decode_tokens"] / wall, 1),
        "useful_tok_s": round(acc["useful_decode_tokens"] / wall, 1),
        # Unrounded, for a strict beat-the-baseline comparison: a
        # marginal true win must not round down to exactly 1.0.
        "useful_tok_s_raw": acc["useful_decode_tokens"] / wall,
        "p50_ms": round(statistics.median(lat_ms), 1),
        "p99_ms": round(lat_ms[int(0.99 * (len(lat_ms) - 1))], 1),
        "batch": batch,
        "max_seq": P + O,
    }


# --- engine replay -----------------------------------------------------------


def equal_memory_engine_config(
    trace,
    batch: int,
    page_size: int = 16,
    scan_chunk: int = 8,
    prefill_chunk: int = 64,
    slots_factor: int = 2,
    kv_quant: str = "none",
    weight_quant: str = "none",
):
    """EngineConfig whose page pool holds the same number of KV
    positions as the fixed-batch baseline's ``batch x (max_prompt +
    max_output)`` allocation: the equal-batch-memory comparison. The
    engine may hold more concurrent sequences (``slots_factor *
    batch``) because short sequences release their pages instead of
    squatting on a max_seq row."""
    stats = trace_stats(trace)
    max_seq = stats["max_prompt"] + stats["max_output"]
    mpp = -(-(max_seq + scan_chunk) // page_size)
    budget_pages = batch * (-(-max_seq // page_size))
    return EngineConfig(
        page_size=page_size,
        max_slots=slots_factor * batch,
        max_pages_per_seq=mpp,
        num_pages=1 + budget_pages,
        scan_chunk=scan_chunk,
        prefill_chunk=prefill_chunk,
        kv_quant=kv_quant,
        weight_quant=weight_quant,
    )


def run_engine_trace(
    config, params, ec, trace, gate=None, metrics=None, warmup=True,
    device=None,
) -> dict:
    """Replay the trace through a fresh Engine (arrivals honored on the
    wall clock) and report sustained useful tok/s, per-request latency
    quantiles and the engine's decode seconds. ``warmup`` first runs
    one request per power-of-two prefill bucket (chunks are padded to
    such buckets, so this covers every prefill shape of the trace) plus
    a decode chunk through the same engine, outside the timing."""
    device = resolve_device(device)
    engine = Engine(
        config, params, ec, gate=gate, metrics=metrics, device=device
    )
    if warmup:
        cap = ec.max_pages_per_seq * ec.page_size - (
            2 * ec.scan_chunk + 1
        )
        buckets = set()
        b = 1
        while b < ec.prefill_chunk:
            buckets.add(b)
            b *= 2
        buckets.add(ec.prefill_chunk)
        lens = sorted(x for x in buckets if 1 <= x <= cap)
        w = [
            Request(
                rid=f"warm{i}",
                prompt=np.ones(bl, np.int32),
                max_new_tokens=ec.scan_chunk + 1,
            )
            for i, bl in enumerate(lens)
        ]
        engine.run(w)
        engine.completed.clear()
        # The all-ones warmup prompts feed the draft source junk with
        # near-zero acceptance: the recorded acceptance and decode time
        # cover only the measured trace.
        engine.spec_proposed = 0
        engine.spec_accepted = 0
        engine.decode_seconds = 0.0
    synchronize(device)
    t0 = time.monotonic()
    completions = engine.run(trace)
    synchronize(device)
    wall = time.monotonic() - t0
    useful = int(sum(len(c.tokens) for c in completions.values()))
    lat_ms = sorted(c.latency_s * 1000 for c in completions.values())
    ttft_ms = sorted(c.ttft_s * 1000 for c in completions.values())
    return {
        "completions": completions,
        "wall_seconds": round(wall, 3),
        "useful_decode_tokens": useful,
        "tok_s": round(useful / wall, 1),
        "tok_s_raw": useful / wall,
        "p50_ms": round(statistics.median(lat_ms), 1),
        "p99_ms": round(lat_ms[int(0.99 * (len(lat_ms) - 1))], 1),
        "ttft_p50_ms": round(statistics.median(ttft_ms), 1),
        "decode_seconds": engine.decode_seconds,
        "engine": engine,
    }


def run_prefix_fleet(
    config, params, fleet_n: int, prompt_len: int, max_new: int,
    page_size: int, vocab: int, seed: int = 0, device=None,
    exact: bool = True,
) -> dict:
    """Copy-on-write prefix-sharing accounting: a fleet of ``fleet_n``
    sequences carrying one shared system prompt, run twice (private: no
    prefix_id; shared: prefix_id and a page-aligned prefix_len) and
    compared on peak simultaneously-allocated pages (the allocator's
    free-list low-water mark). A leak-free, zeroed pool after each run
    is asserted here, and so is token identity between the two runs
    when ``exact``. Without it the two runs' token agreement and first
    difference are reported instead: in bf16 on the card a row's
    result depends on the shape of the product it rides in (cuBLAS
    picks its kernel by shape), so the private and the shared prefill
    round differently."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed + 99)
    prompt = rng.integers(1, vocab, prompt_len).astype(np.int32)
    # Page-aligned share point: the clean ~1/N number (a mid-page
    # prefix additionally pays one frozen page and one fork per sharer).
    prefix_len = (prompt_len - 1) // page_size * page_size

    def fleet(share: bool):
        return [
            Request(
                rid=f"pf{i}", prompt=prompt, max_new_tokens=max_new,
                prefix_id="bench-sys" if share else None,
                prefix_len=prefix_len if share else 0,
            )
            for i in range(fleet_n)
        ]

    mpp = -(-(prompt_len + max_new + 8) // page_size)
    ec = EngineConfig(
        page_size=page_size, max_slots=fleet_n, max_pages_per_seq=mpp,
        num_pages=1 + fleet_n * mpp, scan_chunk=4, prefill_chunk=32,
    )
    out = {}
    runs = {}
    for label, share in (("private", False), ("shared", True)):
        eng = Engine(config, params, dataclasses.replace(ec), device=device)
        runs[label] = dict(eng.run(fleet(share)))
        alloc = eng.allocator
        peak = alloc.num_pages - 1 - alloc.min_free
        if alloc.free_pages != alloc.num_pages - 1:
            raise AssertionError(f"{label} fleet leaked pages")
        if not paged_kv.pages_are_zero(
            eng.cache, list(range(1, alloc.num_pages))
        ):
            raise AssertionError(f"{label} fleet left unzeroed pages")
        out[f"{label}_peak_pages"] = peak
        if share:
            out["prefix_attached"] = eng.prefix_attached
            out["prefix_saved_hw"] = eng.prefix_saved_hw
        del eng, alloc
        _free(device)
    where = first_difference(runs["private"], runs["shared"])
    if exact and where is not None:
        raise AssertionError(
            f"prefix sharing changed tokens (first at {where}): COW must "
            f"be invisible to the math"
        )
    if not exact:
        out["token_agreement"] = token_agreement(
            runs["shared"], runs["private"])
        out["first_difference"] = where
    out["prefix_pages_saved"] = (
        out["private_peak_pages"] - out["shared_peak_pages"]
    )
    out["fleet_n"] = fleet_n
    return out


def run_prefill_ttft_pair(config, params, ec=None, burst_n: int = 8,
                          prompt_len: int = 24, vocab: int = 0,
                          seed: int = 0, page_size: int = 16,
                          prefill_chunk: int = 64, device=None,
                          on_arm=None) -> dict:
    """Batched against serial chunked prefill: the same admission burst
    (every arrival at t=0) through the engine with the bucket packing
    on (prefill_batch=0) and with one sequence per iteration
    (prefill_batch=1); first-token p50 shows the serialization. ``ec``
    defaults to a generously pooled config with ``burst_n`` slots, so
    admission never blocks on pages (a tight pool would throttle both
    schedules alike). ``on_arm(name, trace, run)``, when given, sees
    each run (:func:`run_engine_trace`'s dict) before it is dropped."""
    if vocab < 2:
        vocab = config.vocab_size
    if ec is None:
        mpp = -(-(prompt_len + 8 + 8) // page_size)
        ec = EngineConfig(
            page_size=page_size, max_slots=burst_n,
            max_pages_per_seq=mpp, num_pages=1 + burst_n * mpp,
            scan_chunk=8, prefill_chunk=prefill_chunk,
        )
    device = resolve_device(device)
    rng = np.random.default_rng(seed + 55)
    # Distinct prompts of one length: identical content would let prefix
    # sharing skip work. The same burst replays through both schedules.
    burst = [
        _mk_burst_req(rng, i, prompt_len, vocab) for i in range(burst_n)
    ]
    out = {}
    for label, pb in (("batched", 0), ("serial", 1)):
        res = run_engine_trace(
            config, params, dataclasses.replace(ec, prefill_batch=pb),
            burst, device=device,
        )
        if on_arm is not None:
            on_arm(f"prefill_{label}", burst, res)
        out[f"{label}_ttft_p50_ms"] = res["ttft_p50_ms"]
        out[f"{label}_tok_s"] = res["tok_s"]
        del res
        _free(device)
    return out


def _mk_burst_req(rng, i, prompt_len, vocab):
    return Request(
        rid=f"b{i}",
        prompt=rng.integers(1, vocab, prompt_len).astype(np.int32),
        max_new_tokens=8,
    )


def _lengths(env, key: str, default: str) -> list:
    return [int(x) for x in env.get(key, default).split(",")]


def run_serve_bench(config, params, env, device=None, exact: bool = True,
                    on_arm=None) -> dict:
    """The serve measurement: a seeded Poisson trace, the fixed-batch
    baseline at ``BENCH_SERVE_BATCH``, then the engine at equal batch
    memory in bf16, with int8 weights and sampled; speculative against
    non-speculative on a lookup-friendly trace; the prefix fleet; and
    the prefill pair. Returns the JAX module's result dict (serve_*
    keys).

    Beside the JAX keys of ``env``, ``BENCH_SPEC_REQUESTS``,
    ``BENCH_SPEC_PROMPTS`` and ``BENCH_SPEC_OUTPUTS`` may cut the
    lookup trace of the spec arm and its baseline (default: the serve
    trace's count and mixes, as in JAX). With ``exact``, the spec and
    non-spec engines must give identical tokens on it, and the prefix
    fleet's two runs too (:func:`run_prefix_fleet` says when they
    cannot be); without it, the result adds each pair's token agreement
    and first difference (``spec_token_agreement``,
    ``spec_first_difference``, ``prefix_token_agreement``,
    ``prefix_first_difference``). ``on_arm(name, trace, run)``, when
    given, sees each
    arm's run before its engine is dropped: "baseline", "engine",
    "w8", "sampled", "lookup", "spec", "prefix_fleet" (trace None),
    "prefill_batched" and "prefill_serial"."""
    from tpu_dra_torch.workloads.specbench import _assert_identical

    device = resolve_device(device)

    def arm(name, trace, run):
        if on_arm is not None:
            on_arm(name, trace, run)
        run.pop("engine", None)
        _free(device)

    seed = int(env.get("BENCH_SERVE_SEED", "0"))
    n = int(env.get("BENCH_SERVE_REQUESTS", "64"))
    # The default rate saturates the device (arrivals far faster than
    # service), so sustained tok/s measures capacity, not the arrival
    # process; the p99 then reflects queueing under burst.
    rate = float(env.get("BENCH_SERVE_RATE_RPS", "1000"))
    batch = int(env.get("BENCH_SERVE_BATCH", "16"))
    kv_quant = env.get("BENCH_SERVE_KV_QUANT", "none")
    prompt_lens = _lengths(env, "BENCH_SERVE_PROMPTS", "16,64,128,256")
    output_lens = _lengths(env, "BENCH_SERVE_OUTPUTS", "8,32,96,192")
    trace = make_trace(
        seed, n, rate, prompt_lens, output_lens, config.vocab_size
    )
    baseline = run_fixed_batch_baseline(
        config, params, trace, batch, kv_quant=kv_quant, device=device
    )
    arm("baseline", trace, baseline)
    ec = equal_memory_engine_config(
        trace, batch,
        page_size=int(env.get("BENCH_SERVE_PAGE", "16")),
        scan_chunk=int(env.get("BENCH_SERVE_CHUNK", "8")),
        kv_quant=kv_quant,
    )
    engine = run_engine_trace(config, params, ec, trace, device=device)
    arm("engine", trace, engine)
    ec_w8 = equal_memory_engine_config(
        trace, batch,
        page_size=ec.page_size, scan_chunk=ec.scan_chunk,
        kv_quant=kv_quant, weight_quant="int8",
    )
    engine_w8 = run_engine_trace(config, params, ec_w8, trace, device=device)
    arm("w8", trace, engine_w8)
    # Sampled serving: the same trace, temperature / top-k drawn inside
    # the decode chunk.
    ec_sampled = dataclasses.replace(
        ec,
        temperature=float(env.get("BENCH_SERVE_TEMP", "0.8")),
        top_k=int(env.get("BENCH_SERVE_TOPK", "40")),
    )
    engine_sampled = run_engine_trace(
        config, params, ec_sampled, trace, device=device)
    arm("sampled", trace, engine_sampled)
    # Speculative against non-speculative decoding on the same
    # lookup-friendly trace (repetitive prompts: the draft source has
    # structure to hit).
    spec_k = int(env.get("BENCH_SPEC_K", "6"))
    lookup = make_lookup_trace(
        seed, int(env.get("BENCH_SPEC_REQUESTS", str(n))), rate,
        _lengths(env, "BENCH_SPEC_PROMPTS", ",".join(map(str, prompt_lens))),
        _lengths(env, "BENCH_SPEC_OUTPUTS", ",".join(map(str, output_lens))),
        config.vocab_size,
    )
    ec_lookup = equal_memory_engine_config(
        lookup, batch,
        page_size=ec.page_size, scan_chunk=ec.scan_chunk,
        kv_quant=kv_quant,
    )
    lookup_base = run_engine_trace(
        config, params, ec_lookup, lookup, device=device)
    arm("lookup", lookup, lookup_base)
    spec_run = run_engine_trace(
        config, params, dataclasses.replace(ec_lookup, spec_k=spec_k),
        lookup, device=device,
    )
    spec_proposed = spec_run["engine"].spec_proposed
    spec_accepted = spec_run["engine"].spec_accepted
    arm("spec", lookup, spec_run)
    agreement = {}
    if exact:
        _assert_identical(spec_run["completions"],
                          lookup_base["completions"], "spec vs non-spec")
    else:
        agreement = {
            "spec_token_agreement": token_agreement(
                spec_run["completions"], lookup_base["completions"]),
            "spec_first_difference": first_difference(
                spec_run["completions"], lookup_base["completions"]),
        }
    accept = spec_accepted / max(spec_proposed, 1)
    # Copy-on-write prefix sharing: peak pages for an N-strong
    # same-system-prompt fleet, shared against private.
    fleet_n = int(env.get("BENCH_PREFIX_FLEET", "8"))
    prefix = run_prefix_fleet(
        config, params, fleet_n,
        prompt_len=max(prompt_lens), max_new=min(output_lens),
        page_size=ec.page_size, vocab=config.vocab_size, seed=seed,
        device=device, exact=exact,
    )
    if on_arm is not None:
        on_arm("prefix_fleet", None, prefix)
    if not exact:
        agreement.update(
            prefix_token_agreement=prefix["token_agreement"],
            prefix_first_difference=prefix["first_difference"])
    # Batched chunked prefill: TTFT under an admission burst, bucket
    # packing against one sequence per iteration (its own generously
    # pooled config: this measures scheduling, not page pressure).
    ttft_pair = run_prefill_ttft_pair(
        config, params,
        burst_n=min(2 * batch, 16),
        prompt_len=max(prompt_lens), vocab=config.vocab_size, seed=seed,
        page_size=ec.page_size, device=device, on_arm=on_arm,
    )
    return {
        "serve_tok_s": engine["tok_s"],
        "serve_sampled_tok_s": engine_sampled["tok_s"],
        "serve_p50_ms": engine["p50_ms"],
        "serve_p99_ms": engine["p99_ms"],
        "serve_ttft_p50_ms": engine["ttft_p50_ms"],
        "serve_w8_tok_s": engine_w8["tok_s"],
        "serve_baseline_tok_s": baseline["useful_tok_s"],
        "serve_baseline_padded_tok_s": baseline["padded_tok_s"],
        "serve_baseline_p50_ms": baseline["p50_ms"],
        "serve_baseline_p99_ms": baseline["p99_ms"],
        "decode_padding_waste": baseline["decode_padding_waste"],
        # Rounded for the record; the _raw twin carries a strict > 1.0
        # comparison, which rounding must not flip.
        "serve_vs_fixed_batch": round(
            engine["tok_s_raw"] / max(baseline["useful_tok_s_raw"], 1e-9),
            3,
        ),
        "serve_vs_fixed_batch_raw": engine["tok_s_raw"] / max(
            baseline["useful_tok_s_raw"], 1e-9
        ),
        "serve_requests": n,
        "serve_batch": batch,
        "serve_kv_quant": kv_quant,
        "trace": trace_stats(trace),
        "serve_spec_tok_s": spec_run["tok_s"],
        "serve_spec_baseline_tok_s": lookup_base["tok_s"],
        "serve_spec_vs_nonspec": round(
            spec_run["tok_s_raw"] / max(lookup_base["tok_s_raw"], 1e-9),
            3,
        ),
        "serve_spec_vs_nonspec_raw": spec_run["tok_s_raw"] / max(
            lookup_base["tok_s_raw"], 1e-9
        ),
        "spec_accept_rate": round(accept, 4),
        "spec_k": spec_k,
        "spec_proposed": spec_proposed,
        "spec_accepted": spec_accepted,
        "prefix_pages_saved": prefix["prefix_pages_saved"],
        "prefix_fleet_n": prefix["fleet_n"],
        "prefix_private_peak_pages": prefix["private_peak_pages"],
        "prefix_shared_peak_pages": prefix["shared_peak_pages"],
        "prefill_batched_ttft_p50_ms": ttft_pair["batched_ttft_p50_ms"],
        "prefill_serial_ttft_p50_ms": ttft_pair["serial_ttft_p50_ms"],
        **agreement,
    }


# --- the smoke ---------------------------------------------------------------


def _smoke_config(device):
    """The smokes' model: TINY_LLAMA at fp32 (dim 64, head dim 16, as
    JAX's smokes run it), random weights drawn on the CPU from seed 7,
    so every device holds the same weights."""
    from tpu_dra_torch.workloads.models.llama import TINY_LLAMA, init_params

    cfg = dataclasses.replace(
        TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32
    )
    params = init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    return cfg, as_tree(params, device)


def _smoke_trace(cfg, n=8, seed=3):
    return make_trace(
        seed, n, rate_rps=1e9,  # all arrive at once: saturating
        prompt_lens=[3, 7, 11, 16], output_lens=[2, 5, 9, 13],
        vocab=cfg.vocab_size,
    )


def _check(cond: bool, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def smoke(device) -> dict:
    """The engine smoke's asserts (module docstring); returns the
    report."""
    from tpu_dra_torch.workloads.ops import attention as A

    report = {}
    cfg, params = _smoke_config(device)
    trace = _smoke_trace(cfg)

    def ec(**kw):
        base = dict(
            page_size=4, max_slots=3, max_pages_per_seq=10,
            scan_chunk=3, prefill_chunk=5,
        )
        base.update(kw)
        return EngineConfig(**base)

    def run(**kw):
        return run_engine_trace(
            cfg, params, ec(**kw), trace, warmup=False, device=device)

    # (1) exact parity: paged and fused against the contiguous,
    # per-token oracle.
    A._LAST_PAGED_IMPL = None
    paged = run()
    _check(A._LAST_PAGED_IMPL is not None,
           "the engine never dispatched the block-table attention op")
    oracle = run(fused=False, contiguous=True)
    where = first_difference(paged["completions"], oracle["completions"])
    _check(set(paged["completions"]) == set(oracle["completions"])
           and where is None,
           f"paged/fused engine diverged from the contiguous/unfused "
           f"oracle at {where}")
    report["parity_requests"] = len(paged["completions"])
    report["paged_impl"] = A._LAST_PAGED_IMPL

    # (2) admission/eviction accounting, allocator leak and zero checks.
    eng = paged["engine"]
    for r in trace:
        got = len(paged["completions"][r.rid].tokens)
        _check(got == r.max_new_tokens,
               f"{r.rid}: {got} tokens != {r.max_new_tokens}")
    alloc = eng.allocator
    _check(alloc.free_pages == alloc.num_pages - 1, "page leak")
    _check(alloc.reserved_pages == 0, "reservation leak")
    _check(paged_kv.pages_are_zero(eng.cache, list(range(1, alloc.num_pages))),
           "freed pages were not re-zeroed (per-page zero-tail invariant)")
    report["pages"] = alloc.num_pages

    # (3) backpressure drill: revoke mid-trace, drain, resume.
    gate = EventGate()
    metrics = MetricsRecorder()
    drill = Engine(cfg, params, ec(), gate=gate, metrics=metrics,
                   device=device)
    for r in _smoke_trace(cfg):
        drill.add_request(r)
    for _ in range(6):
        drill.step()
    pre = {s.req.rid: list(s.out) for s in drill._live()}
    _check(any(s is not None for s in drill._slots),
           "drill revoked before anything was in flight")
    gate.revoke()
    for _ in range(3):
        drill.step()  # enters the stall: drains and sets the gauge
    _check(all(s is None for s in drill._slots), "drain left slots live")
    _check(drill.allocator.free_pages == drill.allocator.num_pages - 1,
           "the drain left pages allocated")
    _check("engine_admission_stalled" in metrics.gauge_max,
           "the stall gauge was never set")
    _check(metrics.counters.get("engine_backpressure_drains_total") == 1,
           f"drains counted: {metrics.counters}")
    stalled_completed = len(drill.completed)
    for _ in range(3):
        drill.step()
    _check(len(drill.completed) == stalled_completed,
           "engine made progress while the lease was revoked")
    gate.restore()
    completions = drill.run([])
    want = {r.rid: r.max_new_tokens for r in _smoke_trace(cfg)}
    _check(set(completions) == set(want),
           "a sequence was lost (or invented) across the drain")
    for rid, c in completions.items():
        if pre.get(rid):
            _check(list(c.tokens[: len(pre[rid])]) == pre[rid],
                   f"{rid}: pre-drain tokens were re-emitted or changed")
    lens = {rid: len(c.tokens) for rid, c in completions.items()}
    _check(lens == want, f"post-drain token counts drifted: {lens}")
    report["drill_drains"] = 1
    report["drill_resumed"] = len(completions)

    # (4) honest padding accounting.
    acc = fixed_batch_padding_waste(trace, batch=3)
    useful = sum(r.max_new_tokens for r in trace)
    batches = -(-len(trace) // 3)
    expect = 1.0 - useful / (batches * 3 * max(
        r.max_new_tokens for r in trace
    ))
    _check(abs(acc["decode_padding_waste"] - expect) < 5e-5,
           f"padding waste {acc} != {expect}")  # 4-dp round
    _check(acc["useful_decode_tokens"] == useful, f"useful tokens {acc}")
    report["decode_padding_waste"] = acc["decode_padding_waste"]

    # (6) sampling inside the decode chunk: fused is token-identical to
    # the per-token oracle under the same (seed, serial, position)
    # schedule, and it really samples (not the greedy trajectory).
    samp_kw = dict(temperature=0.8, top_k=8, sample_seed=11)
    sampled = run(**samp_kw)
    sampled_oracle = run(fused=False, contiguous=True, **samp_kw)
    where = first_difference(
        sampled["completions"], sampled_oracle["completions"])
    _check(set(sampled["completions"]) == set(sampled_oracle["completions"])
           and where is None,
           f"sampled fused engine diverged from the unfused oracle at "
           f"{where}")
    _check(first_difference(sampled["completions"], paged["completions"])
           is not None,
           "sampled engine emitted the greedy trajectory on every request")
    report["sampled_parity_requests"] = len(sampled["completions"])

    # (5) int8 KV and int8 weight-only engines complete every request
    # and agree with the fp32 engine on almost every position
    # (quantization noise only), each position picked from the fp32
    # engine's context (decodebench.teacher_forced_agreement); the
    # free-running agreement is reported beside it.
    from tpu_dra_torch.workloads.decodebench import (
        QUANT_AGREEMENT,
        teacher_forced_agreement,
    )

    for name, kw in (
        ("int8kv", {"kv_quant": "int8"}),
        ("w8", {"weight_quant": "int8"}),
    ):
        q = run(**kw)
        total = agree = free = 0
        for r in trace:
            got = q["completions"][r.rid].tokens
            ref = paged["completions"][r.rid].tokens
            _check(len(got) == r.max_new_tokens,
                   f"{name} {r.rid}: {len(got)} tokens")
            total += len(ref)
            free += int(np.sum(got == ref))
            agree += len(ref) * teacher_forced_agreement(
                cfg, params, r.prompt[None], ref[None], device=device, **kw)
        ratio = agree / total
        _check(ratio >= QUANT_AGREEMENT,
               f"{name} engine agreement {ratio:.3f} vs fp32 (bar "
               f"{QUANT_AGREEMENT})")
        report[f"{name}_token_agreement"] = round(ratio, 3)
        report[f"{name}_free_running_agreement"] = round(free / total, 3)
    return report


def serve(device, environ) -> dict:
    """:func:`run_serve_bench` over ``environ``: Llama-3-8B widths, 32
    layers, bf16 random weights from a seeded generator on the card;
    the tiny fp32 model at bench.py's drill sizes on the CPU."""
    from tpu_dra_torch.workloads.models.llama import LLAMA3_8B, init_params

    env = dict(environ)
    if device.type == "cuda":
        cfg = LLAMA3_8B
        params = init_params(
            cfg, torch.Generator(device=device).manual_seed(0))
    else:
        # Drill sizes: seconds of runtime through the identical path.
        env.setdefault("BENCH_SERVE_REQUESTS", "8")
        env.setdefault("BENCH_SERVE_BATCH", "4")
        env.setdefault("BENCH_SERVE_PROMPTS", "6,10,16,24")
        env.setdefault("BENCH_SERVE_OUTPUTS", "4,8,12,20")
        cfg, params = _smoke_config(device)
    # In bf16 on the card a row's product depends on the shape it rides
    # in, so the spec and prefix pairs report their agreement there.
    return run_serve_bench(cfg, params, env, device=device,
                           exact=device.type != "cuda")


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("tpu-dra-torch-enginebench")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--smoke", action="store_true",
                      help="the engine smoke (the default)")
    mode.add_argument("--serve", action="store_true",
                      help="the serve bench over the BENCH_SERVE_* keys "
                           "of the environment")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    t0 = time.monotonic()
    if args.serve:
        report = serve(device, os.environ)
    else:
        report = smoke(device)
    report.update(ok=True, device=_device_name(device),
                  seconds=round(time.monotonic() - t0, 2))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
