"""Speculative decoding, prefix sharing and batched prefill smoke of the
port: the counterpart of ``tpu_dra/workloads/specbench.py``, on the
tiny fp32 model of enginebench's smoke.

    python -m tpu_dra_torch.workloads.specbench [--device cpu]

Asserts (exit non-zero on any violation):

1. spec == oracle token identity, greedy and sampled: the speculative
   engine (n-gram draft, one verify pass a step) gives the tokens of
   the unfused, contiguous-page oracle on a lookup-friendly trace (with
   real acceptance), on a rejection-heavy random trace, and with an
   always-wrong draft source: a proposer changes speed, never tokens;
2. rewind hygiene: after the rejection-heavy run the allocator is
   leak-free and every non-scratch page is zero;
3. the copy-on-write prompt fleet saves at least (N - 1) x the shared
   prefix's full pages - 1 of peak pages against the private fleet
   (token identity and zero leaks asserted inside the fleet helper);
4. batched prefill beats serial on first-token p50 for the same
   admission burst (a wall-clock comparison).
"""

from __future__ import annotations

import json
import sys

import numpy as np

from tpu_dra_torch.workloads import paged_kv
from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.engine import Engine, EngineConfig, Request


def _model(device):
    from tpu_dra_torch.workloads.enginebench import _smoke_config

    return _smoke_config(device)


def _lookup_reqs(cfg, n=5, seed=3, max_new=20):
    """Repetitive prompts: the n-gram proposer has structure to hit."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(1, cfg.vocab_size, 6).astype(np.int32)
        out.append(
            Request(
                rid=f"l{i}", prompt=np.tile(motif, 4)[:22],
                max_new_tokens=max_new,
            )
        )
    return out


def _random_reqs(cfg, n=6, seed=11):
    """Structureless prompts: near-zero acceptance, so every verify pass
    exercises the rewind."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            rid=f"r{i}",
            prompt=rng.integers(
                1, cfg.vocab_size, int(rng.integers(4, 15))
            ).astype(np.int32),
            max_new_tokens=int(rng.integers(3, 12)),
        )
        for i in range(n)
    ]


def _assert_identical(got, want, label):
    if set(got) != set(want):
        raise AssertionError(
            f"{label}: completion sets differ: {set(got) ^ set(want)}")
    bad = [
        rid for rid in got
        if not np.array_equal(got[rid].tokens, want[rid].tokens)
    ]
    if bad:
        raise AssertionError(
            f"{label}: tokens diverged from the oracle on {bad}")


def smoke(device) -> dict:
    """The spec smoke's asserts (module docstring); returns the
    report."""
    from tpu_dra_torch.workloads.enginebench import (
        _check,
        run_prefill_ttft_pair,
        run_prefix_fleet,
    )
    from tpu_dra_torch.workloads.ops import attention as A
    from tpu_dra_torch.workloads.specdraft import StaticDraft

    report = {}
    cfg, params = _model(device)

    def ec(**kw):
        base = dict(
            page_size=4, max_slots=3, max_pages_per_seq=16,
            scan_chunk=3, prefill_chunk=8,
        )
        base.update(kw)
        return EngineConfig(**base)

    def rerun(reqs_fn, config, **engine_kw):
        eng = Engine(cfg, params, config, device=device, **engine_kw)
        return eng.run(reqs_fn()), eng

    # (1a) greedy spec parity on the lookup-friendly trace, with real
    # acceptance. Batched prefill dispatches the multiquery op too, so
    # the verify pass having run is read from spec_proposed /
    # spec_accepted (only the verify step moves them).
    A._LAST_MULTIQUERY_IMPL = None
    spec, eng = rerun(lambda: _lookup_reqs(cfg), ec(spec_k=4))
    _check(A._LAST_MULTIQUERY_IMPL is not None,
           "the engine never dispatched the multiquery op at all")
    oracle, _ = rerun(
        lambda: _lookup_reqs(cfg), ec(fused=False, contiguous=True)
    )
    _assert_identical(spec, oracle, "greedy lookup")
    rate = eng.spec_accepted / max(eng.spec_proposed, 1)
    _check(eng.spec_proposed > 0 and rate > 0.2,
           f"lookup trace acceptance {rate:.3f} over {eng.spec_proposed} "
           f"proposals: the n-gram proposer is not engaging")
    report["lookup_accept_rate"] = round(rate, 4)
    report["lookup_proposed"] = eng.spec_proposed

    # (1b) sampled spec parity: the (seed, serial, position) schedule
    # keeps acceptance exact under sampling too.
    samp = dict(temperature=0.8, top_k=8, sample_seed=11)
    sspec, _ = rerun(lambda: _lookup_reqs(cfg), ec(spec_k=4, **samp))
    soracle, _ = rerun(
        lambda: _lookup_reqs(cfg),
        ec(fused=False, contiguous=True, **samp),
    )
    _assert_identical(sspec, soracle, "sampled lookup")

    # (1c) rejection-heavy trace: parity and (2) rewind hygiene.
    rspec, reng = rerun(lambda: _random_reqs(cfg), ec(spec_k=4))
    roracle, _ = rerun(
        lambda: _random_reqs(cfg), ec(fused=False, contiguous=True)
    )
    _assert_identical(rspec, roracle, "rejection-heavy")
    rej_rate = reng.spec_accepted / max(reng.spec_proposed, 1)
    alloc = reng.allocator
    _check(alloc.free_pages == alloc.num_pages - 1,
           "rejection-heavy spec run leaked pages")
    _check(alloc.reserved_pages == 0, "reservation leak")
    _check(paged_kv.pages_are_zero(reng.cache,
                                   list(range(1, alloc.num_pages))),
           "rewind left unzeroed pages (zero-tail invariant)")
    report["rejection_accept_rate"] = round(rej_rate, 4)

    # (1d) adversarial proposer: always-wrong drafts cost throughput,
    # never tokens.
    wrong = StaticDraft(np.zeros(8, np.int32) + 1)
    adv, _ = rerun(
        lambda: _random_reqs(cfg, seed=17), ec(spec_k=3),
        draft_source=wrong,
    )
    aoracle, _ = rerun(
        lambda: _random_reqs(cfg, seed=17),
        ec(fused=False, contiguous=True),
    )
    _assert_identical(adv, aoracle, "adversarial draft")

    # (3) COW prompt fleet: pages saved against the private twin.
    fleet_n = 6
    fl = run_prefix_fleet(
        cfg, params, fleet_n=fleet_n, prompt_len=17, max_new=6,
        page_size=4, vocab=cfg.vocab_size, device=device,
    )
    n_full = (17 - 1) // 4  # page-aligned shared prefix pages
    want_saved = (fleet_n - 1) * n_full
    _check(fl["prefix_pages_saved"] >= want_saved - 1,
           f"COW fleet saved {fl['prefix_pages_saved']} pages; expected "
           f"~{want_saved} ((N-1) x shared prefix pages)")
    _check(fl["prefix_attached"] >= fleet_n - 1,
           f"only {fl['prefix_attached']} of {fleet_n - 1} followers "
           f"attached via incref")
    report["prefix_pages_saved"] = fl["prefix_pages_saved"]
    report["prefix_private_peak"] = fl["private_peak_pages"]
    report["prefix_shared_peak"] = fl["shared_peak_pages"]

    # (4) batched prefill beats the serialized schedule on first-token
    # p50 for the same admission burst.
    pair = run_prefill_ttft_pair(
        cfg, params,
        EngineConfig(
            page_size=4, max_slots=6, max_pages_per_seq=10,
            scan_chunk=3, prefill_chunk=16,
        ),
        burst_n=6, prompt_len=12, vocab=cfg.vocab_size, device=device,
    )
    _check(pair["batched_ttft_p50_ms"] < pair["serial_ttft_p50_ms"],
           f"batched prefill p50 {pair['batched_ttft_p50_ms']} ms did not "
           f"beat serial {pair['serial_ttft_p50_ms']} ms")
    report["prefill_batched_ttft_p50_ms"] = pair["batched_ttft_p50_ms"]
    report["prefill_serial_ttft_p50_ms"] = pair["serial_ttft_p50_ms"]
    return report


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("tpu-dra-torch-specbench")
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
