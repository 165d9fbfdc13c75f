"""Decode-step breakdown and decode smoke of the port: the counterpart
of ``tpu_dra/workloads/decodebench.py``.

    python -m tpu_dra_torch.workloads.decodebench [--device cpu]

:func:`measure_step_breakdown` splits one decode step of the
fixed-batch path (``generate.forward_chunk`` at s=1 over the unrolled
tree and its in-place contiguous cache) into attention, the q/k/v and
output projections, the MLP, embedding plus final norm, the logits head
and the sampler, each timed on the host over ``reps`` calls that end in
a synchronize, with the JAX module's keys. On the card each part also
has its device time (``<part>_device_ms``: the device time of one call,
kernels, copies and sets summed, from torch.profiler), ``step_launches``,
``busy_share`` (device over host time of the step) and ``device_time``
(how the profile was attributed, :func:`device_time`): eager PyTorch
pays a host launch for every kernel, so a host time alone would measure
the host.

The smoke (``main``) keeps the JAX smoke's asserts on a tiny fp32 model:

1. the decode step dispatches the decode attention op and the fused
   decode MLP (their kernels on the card, the plain versions on the
   CPU);
2. the decode attention op matches the fp32 oracle on a random cache,
   model-dtype and int8 storage;
3. int8-KV and int8-weight greedy decode agree with full-precision
   decode on at least QUANT_AGREEMENT of 192 positions (8 seeded prompts
   x 24 tokens), each position picked from the full-precision context
   (teacher_forced_agreement). The JAX smoke holds 12 positions of two
   identical rows, free-running, to 0.99 (int8 KV) and 0.95 (int8
   weights): on random weights one flipped near-tie changes every later
   token of its row, so those bars pass or fail with the seed. The
   port's tiny model flips 1-2 % (int8 KV) and 2-5 % (int8 weights) of
   the positions teacher-forced, so both take the engine smoke's 0.9;
4. the fused sampler is token-identical to the unfused per-token loop
   for a fixed key;
5. the breakdown's schema: every component key present and positive.

The port holds only the unrolled layout (generate.py), so where the JAX
smoke loops over both layouts this one runs the unrolled case. Prints
one JSON line; exits non-zero on any violation.
"""

from __future__ import annotations

import bisect
import collections
import functools
import json
import sys
import time

import numpy as np
import torch

from tpu_dra_torch.workloads.device import resolve_device, synchronize
from tpu_dra_torch.workloads.generate import (
    _mm,
    _project_qkv,
    _rms,
    forward_chunk,
    init_cache,
    sample_token,
    unroll_params,
)
from tpu_dra_torch.workloads.models.llama import as_tree, rope_frequencies
from tpu_dra_torch.workloads.ops.attention import decode_attention
from tpu_dra_torch.workloads.ops.decode_mlp import decode_mlp
from tpu_dra_torch.workloads.sampling import prng_key

# The share of positions at which int8 KV or int8 weights must pick the
# full-precision token (enginebench's smoke holds its engines to it).
QUANT_AGREEMENT = 0.9


# The profiler spans of the breakdown's parts, and the span that closes
# the last part's window.
SPAN = "decodebench/"
END = "end"
# Small kernels launched after the closing span: late in chip_smoke.py's
# long process a short session's last device records came back missing.
TAIL_PAD = 256
# Host sleep at each end of a part's span, the device idle: the parts'
# device work lies GUARD_S inside its span and 2 GUARD_S apart on the
# device's own clock.
GUARD_S = 0.02
# Profiler sessions device_time tries before it raises.
SESSIONS = 2


def attribute_kernels(events, prefix: str) -> tuple:
    """({part: device µs}, {part: device activities}) from torch.profiler
    events: every device activity (kernel, copy, set) counts toward the
    ``prefix + part`` span whose host start is the last before the
    activity's device start. The caller synchronizes the device between
    spans, so each part's device work lies inside its window. A kernel
    launched through ctypes outside any aten op is linked to no op in
    the profile (not to the span either), so the windows go by time,
    not by parentage."""
    spans, acts = _spans_and_activities(events, prefix)
    starts = [t for t, _ in spans]
    us = collections.defaultdict(float)
    launches = collections.defaultdict(int)
    for start, length in acts:
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0:
            part = spans[i][1]
            us[part] += length
            launches[part] += 1
    return dict(us), dict(launches)


def attribute_by_gaps(events, prefix: str, gap_us: float):
    """Like attribute_kernels, but on the device's clock alone: the
    device activities, in device order, split wherever the device was
    idle longer than ``gap_us``, and the k-th group goes to the k-th
    span. The host and device clocks of a profile can part by more than
    a short part's window, which then charges its work to a neighbour;
    the groups do not compare the two clocks. Returns (us, launches,
    skews) with skews[part] = the group's first device start less its
    span's host start, in µs, or None where the groups are not one a
    span."""
    spans, acts = _spans_and_activities(events, prefix)
    groups, end = [], None
    for start, length in sorted(acts):
        if end is None or start - end > gap_us:
            groups.append([start, 0.0, 0])
        groups[-1][1] += length
        groups[-1][2] += 1
        end = max(end or start, start + length)
    if len(groups) != len(spans):
        return None
    us = {name: g[1] for (_, name), g in zip(spans, groups)}
    launches = {name: g[2] for (_, name), g in zip(spans, groups)}
    skews = {name: g[0] - t for (t, name), g in zip(spans, groups)}
    return us, launches, skews


def _spans_and_activities(events, prefix: str):
    """The ``prefix`` spans as sorted (host start µs, part) and the
    device activities, the spans' own device annotations left out, as
    (device start µs, length µs)."""
    from torch.autograd import DeviceType

    spans = sorted(
        (ev.time_range.start, ev.name[len(prefix):]) for ev in events
        if ev.device_type == DeviceType.CPU and ev.name.startswith(prefix)
    )
    acts = [
        (ev.time_range.start, ev.time_range.elapsed_us()) for ev in events
        if ev.device_type == DeviceType.CUDA
        and not ev.name.startswith(prefix)
    ]
    return spans, acts


def device_time(calls: dict, reps: int = 3) -> tuple:
    """({name: (device ms, device activities)}, info) of one call of
    each thunk of ``calls`` on the card, from a torch.profiler session in
    which each thunk runs ``reps`` times inside a span named after it,
    the device synchronized after each and idle GUARD_S at each end of
    the span; an END span and TAIL_PAD small kernels close the session.
    The parts' device work is grouped on the device's clock
    (attribute_by_gaps) where it falls into one group a span, else
    charged by host windows (attribute_kernels). A session in which a
    part has no device activity is made again, up to SESSIONS in all,
    then this raises. ``info``: the attribution, the sessions taken and
    ``start_offset_us``, the range over the parts of their first device
    start less their span's host start and GUARD_S: at least the launch
    latency where the two clocks agree, negative where the device's
    reads behind."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pad = torch.zeros(1, device="cuda")
    seen = []
    for session in range(1, SESSIONS + 1):
        torch.cuda.synchronize()
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            for name in list(calls) + [END]:
                with record_function(SPAN + name):
                    time.sleep(GUARD_S)
                    for _ in range(reps if name in calls else 0):
                        calls[name]()
                    torch.cuda.synchronize()
                    time.sleep(GUARD_S)
            for _ in range(TAIL_PAD):
                pad.add_(1)
            torch.cuda.synchronize()
        events = prof.events()
        grouped = attribute_by_gaps(events, SPAN, GUARD_S * 1e6)
        if grouped is not None:
            us, launches, skews = grouped
            lag = [skews[name] - GUARD_S * 1e6 for name in calls]
            info = {"attribution": "device_gaps",
                    "start_offset_us": [round(min(lag), 1),
                                        round(max(lag), 1)]}
        else:
            us, launches = attribute_kernels(events, SPAN)
            info = {"attribution": "host_windows", "start_offset_us": None}
        missing = [name for name in calls if not launches.get(name)]
        seen.append({"missing": missing, **info})
        if not missing:
            info["sessions"] = session
            return ({name: (us[name] / reps / 1e3, launches[name] / reps)
                     for name in calls}, info)
    raise RuntimeError(
        f"torch.profiler recorded no device time in {SESSIONS} sessions: "
        f"{seen}")


def measure_step_breakdown(
    config,
    params,
    batch: int,
    ctx_len: int,
    reps: int = 10,
    temperature: float = 0.8,
    top_k: int = 40,
    device=None,
) -> dict:
    """Per-component timing of one decode step at a fixed context
    length: attention vs q/k/v and output projections vs MLP vs
    embedding and final norm vs logits vs sampling, each timed over
    ``reps`` eager calls against the same cache state (the unrolled
    in-place layout), after one warm call, closed by a synchronize. Also
    times the full greedy step and the full sampled step, so the
    sampled-vs-greedy gap is attributable (``sampling_ms``).
    ``residual_ms`` = step - sum(parts): what the parts do not explain
    (negative where the parts cost more alone than inside the step).
    Inputs are drawn from a seeded ``torch.Generator``: the shapes of
    the JAX module, not its values. On the card, ``<part>_device_ms``
    beside each ``<part>_ms``, ``step_launches`` and ``busy_share``.
    Returns a JSON-ready dict."""
    c = config
    device = resolve_device(device)
    params = unroll_params(as_tree(params, device))
    max_seq = -(-(ctx_len + 1) // 64) * 64
    gen = torch.Generator(device=device).manual_seed(0)
    prompt = torch.randint(
        1, c.vocab_size, (batch, ctx_len), generator=gen, device=device,
        dtype=torch.int32,
    )
    cache = init_cache(c, batch, max_seq, device=device)
    forward_chunk(c, params, cache, prompt)
    tok = prompt[:, -1:]
    x = torch.randn(batch, 1, c.dim, generator=gen, device=device).to(c.dtype)
    q1 = torch.randn(
        batch, c.n_heads, c.head_dim, generator=gen, device=device
    ).to(c.dtype)
    logits = torch.randn(batch, c.vocab_size, generator=gen, device=device)
    key = prng_key(9, device)

    def timed(fn, *args) -> float:
        fn(*args)  # warm outside the timing
        synchronize(device)
        t0 = time.monotonic()
        for _ in range(reps):
            fn(*args)
        synchronize(device)
        return (time.monotonic() - t0) / reps * 1e3

    def attention_all(q):
        return torch.stack([
            decode_attention(
                q, cache.k[i], cache.v[i], cache.pos,
                k_scale=None if cache.k_scale is None else cache.k_scale[i],
                v_scale=None if cache.v_scale is None else cache.v_scale[i],
                impl=c.decode_impl, block_k=c.decode_block_k,
            )
            for i in range(c.n_layers)
        ])

    def qkv_all(xx):
        cos, sin = rope_frequencies(
            c, cache.pos + torch.arange(1, device=device))
        return torch.stack([
            _project_qkv(c, params[f"layer_{i}"], xx, cos, sin, batch, 1)[0]
            for i in range(c.n_layers)
        ])

    def attn_out_all(q):
        flat = q.reshape(batch, 1, c.n_heads * c.head_dim)
        return torch.stack([
            _mm(flat, params[f"layer_{i}"]["attention"]["wo"])
            for i in range(c.n_layers)
        ])

    def mlp_all(xx):
        x2 = xx[:, 0]
        return torch.stack([
            decode_mlp(
                x2, params[f"layer_{i}"]["mlp_norm"]["scale"],
                params[f"layer_{i}"]["mlp"], c.norm_eps,
                impl=c.decode_mlp_impl,
            )
            for i in range(c.n_layers)
        ])

    def embed_norm(t, xx):
        emb = params["embed"]["embedding"].to(c.dtype)[t.long()]
        return emb, _rms(xx, params["final_norm"]["scale"], c.norm_eps)

    def logits_head(xx):
        # The final norm is timed in embed_norm; this times only the
        # lm_head matmul (xx stands in for the normalized activation),
        # so the parts count the norm once.
        return _mm(xx, params["lm_head"]).to(torch.float32)

    def step_logits(t):
        # Every call decodes the same position: forward_chunk writes
        # position ctx_len in place and advances pos, so rewind it.
        cache.pos = ctx_len
        return forward_chunk(c, params, cache, t)[:, -1]

    def greedy_step(t):
        return torch.argmax(step_logits(t), dim=-1)

    def sampled_step(t):
        return sample_token(step_logits(t), key, temperature, top_k)

    def sampling(lg):
        return sample_token(lg, key, temperature, top_k)

    calls = {
        "step": (greedy_step, tok),
        "sampled_step": (sampled_step, tok),
        "attention": (attention_all, q1),
        "qkv": (qkv_all, x),
        "attn_out": (attn_out_all, q1[:, None]),
        "mlp": (mlp_all, x),
        "embed_norm": (embed_norm, tok, x),
        "logits": (logits_head, x),
        "sampling": (sampling, logits),
    }
    host = {name: timed(fn, *args) for name, (fn, *args) in calls.items()}
    cache.pos = ctx_len
    cache.zero_tail()
    parts = {
        f"{name}_ms": host[name]
        for name in ("attention", "qkv", "attn_out", "mlp", "embed_norm",
                     "logits")
    }
    step_ms = host["step"]
    out = {
        "ctx_len": ctx_len,
        "batch": batch,
        "reps": reps,
        "step_ms": round(step_ms, 3),
        "sampled_step_ms": round(host["sampled_step"], 3),
        "sampling_ms": round(host["sampling"], 3),
        # The sampled-vs-greedy gap, attributed: the step-level delta
        # beside the isolated sampler's cost.
        "sampled_overhead_ms": round(host["sampled_step"] - step_ms, 3),
        "residual_ms": round(step_ms - sum(parts.values()), 3),
    }
    out.update({k: round(v, 3) for k, v in parts.items()})
    for k, v in parts.items():
        out[k.replace("_ms", "_frac")] = round(v / max(step_ms, 1e-9), 3)
    if device.type == "cuda":
        dev, info = device_time({
            name: functools.partial(fn, *args)
            for name, (fn, *args) in calls.items()
        })
        out["device_time"] = info
        for name, (ms, _) in dev.items():
            out[f"{name}_device_ms"] = round(ms, 4)
        out["step_launches"] = dev["step"][1]
        cache.pos = ctx_len
        cache.zero_tail()
        out["busy_share"] = round(out["step_device_ms"] / step_ms, 4)
    return out


def teacher_forced_agreement(config, params, prompt, tokens,
                             kv_quant: str = "none",
                             weight_quant: str = "none",
                             device=None) -> float:
    """Share of the positions of ``tokens`` [b, n] (generated after
    ``prompt`` [b, s]) where the model under ``kv_quant`` /
    ``weight_quant`` picks the same token greedily given the same
    context: one forward over prompt + tokens[:, :-1]. Unlike comparing
    two free-running generations, one flipped near-tie does not change
    every later position, so the share measures the quantization's own
    flips."""
    from tpu_dra_torch.workloads.generate import _maybe_quantize_params

    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device)
    tokens = torch.as_tensor(tokens, device=device)
    ctx = torch.cat([prompt, tokens[:, :-1].to(prompt.dtype)], dim=1)
    tree = _maybe_quantize_params(
        unroll_params(as_tree(params, device)), weight_quant)
    cache = init_cache(config, ctx.shape[0], ctx.shape[1], kv_quant,
                       device=device)
    logits = forward_chunk(config, tree, cache, ctx)
    picks = torch.argmax(logits[:, prompt.shape[1] - 1:], dim=-1)
    return float((picks == tokens).to(torch.float32).mean())


def smoke(device) -> dict:
    """The decode smoke's asserts (module docstring); returns the
    report."""
    from tpu_dra_torch.workloads import enginebench
    from tpu_dra_torch.workloads.enginebench import _check
    from tpu_dra_torch.workloads.generate import (
        greedy_generate,
        sample_generate,
        sample_generate_unfused,
    )
    from tpu_dra_torch.workloads.ops import attention as A
    from tpu_dra_torch.workloads.ops import decode_mlp as DM
    from tpu_dra_torch.workloads.quantize import dequantize_kv, quantize_kv

    report = {}
    kernel_impl = "cuda" if device.type == "cuda" else "torch"

    # (2) op-level parity on a random cache, both storages.
    b, S, h, kvh, hd = 2, 32, 8, 2, 64
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, h, hd, generator=gen).to(device)
    k = torch.randn(b, S, kvh, hd, generator=gen).to(device)
    v = torch.randn(b, S, kvh, hd, generator=gen).to(device)
    L = 21  # chunk-unaligned on purpose
    ref = A.reference_decode_attention(q, k, v, L)
    got = A.decode_attention(q, k, v, L, block_k=8)
    err = float((got - ref).abs().max())
    _check(err < 1e-4, f"decode attention drifted {err} from the oracle")
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    refq = A.reference_decode_attention(
        q, dequantize_kv(k8, ks), dequantize_kv(v8, vs), L
    )
    gotq = A.decode_attention(q, k8, v8, L, k_scale=ks, v_scale=vs, block_k=8)
    errq = float((gotq - refq).abs().max())
    _check(errq < 1e-4, f"int8 decode attention drifted {errq}")
    report["op_max_err"] = err
    report["op_int8_max_err"] = errq

    # (1) + (3): generation dispatches both decode ops, int8 KV agrees.
    cfg, params = enginebench._smoke_config(device)
    new_tokens = 12
    prompt = torch.arange(8, dtype=torch.int32)[None].repeat(2, 1)
    A._LAST_DECODE_IMPL = None
    DM._LAST_DECODE_MLP_IMPL = None
    t0 = time.monotonic()
    base = greedy_generate(cfg, params, prompt, new_tokens, device=device)
    _check(A._LAST_DECODE_IMPL == kernel_impl,
           f"the decode step dispatched decode attention as "
           f"{A._LAST_DECODE_IMPL!r}, want {kernel_impl!r}")
    _check(DM._LAST_DECODE_MLP_IMPL == kernel_impl,
           f"the decode step dispatched the fused MLP as "
           f"{DM._LAST_DECODE_MLP_IMPL!r}, want {kernel_impl!r}")
    # (3) and (5): int8 KV and int8 weights on the whole generate path,
    # over 8 seeded prompts x 24 tokens, each position picked from the
    # full-precision context (teacher_forced_agreement); the
    # free-running agreement is reported beside it.
    report["unrolled_impl"] = A._LAST_DECODE_IMPL
    qprompt = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (8, 8)).astype(np.int32))
    ref = greedy_generate(cfg, params, qprompt, 24, device=device)[:, 8:]
    for name, kw in (("unrolled_int8kv", {"kv_quant": "int8"}),
                     ("w8", {"weight_quant": "int8"})):
        out = greedy_generate(cfg, params, qprompt, 24, device=device,
                              **kw)[:, 8:]
        _check(tuple(out.shape) == (8, 24) and bool((out >= 0).all())
               and bool((out < cfg.vocab_size).all()),
               f"{name} generate: bad output {tuple(out.shape)}")
        agree = teacher_forced_agreement(
            cfg, params, qprompt, ref, device=device, **kw)
        _check(agree >= QUANT_AGREEMENT,
               f"{name} disagreed with full-precision decode: {agree:.3f} "
               f"(bar {QUANT_AGREEMENT})")
        report[f"{name}_token_agreement"] = agree
        report[f"{name}_free_running_agreement"] = float(
            (out == ref).to(torch.float32).mean())
    report["unrolled_seconds"] = round(time.monotonic() - t0, 2)

    # (6) the step breakdown's schema.
    bd = measure_step_breakdown(
        cfg, params, batch=2, ctx_len=24, reps=2, device=device)
    for key in (
        "step_ms", "sampled_step_ms", "sampling_ms", "attention_ms",
        "qkv_ms", "attn_out_ms", "mlp_ms", "embed_norm_ms", "logits_ms",
        "residual_ms", "attention_frac",
    ):
        _check(key in bd, f"step breakdown missing {key}")
        if key.endswith("_ms") and "residual" not in key:
            _check(bd[key] > 0, f"step breakdown {key} = {bd[key]}")
    report["breakdown_step_ms"] = bd["step_ms"]
    report["breakdown_attention_frac"] = bd["attention_frac"]

    # (4) fused sampler == unfused oracle, fixed key.
    key = prng_key(5)
    fused = sample_generate(
        cfg, params, prompt, new_tokens, key, temperature=0.8, top_k=8,
        device=device,
    )
    unfused = sample_generate_unfused(
        cfg, params, prompt, new_tokens, key, temperature=0.8, top_k=8,
        device=device,
    )
    _check(torch.equal(fused, unfused), "fused sampler diverged")
    report["sampler_parity"] = True
    return report


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("tpu-dra-torch-decodebench")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args.device)
    from tpu_dra_torch.workloads.enginebench import _device_name

    report = smoke(device)
    report.update(ok=True, device=_device_name(device))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
