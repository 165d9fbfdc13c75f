"""Disaggregated prefill/decode bench + smoke.

The port's copy of ``tpu_dra/serving/disaggbench.py`` (the port imports
nothing of the JAX package). The contrast this leg measures: batched
chunked prefill still shares each engine's iterations with decode, so a
prompt-heavy burst degrades both decode ITL and prefill TTFT at once.
Phase disaggregation splits the fleet into a PREFILL pool (takes prompt
dispatches, exports each sequence's paged-KV extent at prefill
completion) and a DECODE pool (grafts migrated extents, never runs a
prefill chunk), with the handoff a live page transfer — not a
re-prefill. Both sides of the comparison run the IDENTICAL seeded
prompt-heavy trace at EQUAL chips: N colocated ("both"-role) replicas
vs the same N split across the two phase pools.

Three measured phases:

1. **parity**: a small disagg fabric where sequences migrate
   mid-generation — completions must be TOKEN-IDENTICAL to an
   uninterrupted single-engine reference, greedy AND under the pinned
   (seed, serial, position) sampled schedule, with at least one real
   shipped migration and every allocator leak-free after the drive;
2. **kill drill** (faultbench-style): the decode replica is crashed at
   the migration boundary — first poll after it holds grafted
   sequences in flight. The dispatch journal replays ``prompt +
   emitted`` by re-prefill on the survivors: zero lost, zero
   duplicated, completions still token-identical to the reference;
3. **measure**: colocated vs disaggregated on the same trace. Reports
   TTFT p50/p99 and ITL p50/p99 per side and the ratios
   ``disagg_vs_colocated_ttft`` / ``disagg_vs_colocated_itl``
   (disagg p99 over colocated p99; < 1.0 = disaggregation wins). Full
   mode gates BOTH ratios < 1.0; ``DISAGG_ALLOW_GAP=1`` bypasses at
   drill sizes where queueing noise owns the quantiles.

Engines run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu``).

Knobs (env): DISAGG_NODES, DISAGG_REPLICAS, DISAGG_PREFILL (pool
split), DISAGG_REQUESTS, DISAGG_RATE, DISAGG_SEED, DISAGG_SLOTS,
DISAGG_ALLOW_GAP.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
from typing import List, Optional

import numpy as np

from tpu_dra_torch.serving.autoscaler import AutoscalerConfig
from tpu_dra_torch.serving.fabricbench import (
    Fabric,
    _engine_config,
    _layer,
    _model,
    _pct,
    _watchdog,
    warm_jit,
)
from tpu_dra_torch.serving.router import (
    INTERACTIVE,
    Replica,
    RouterConfig,
    TenantSpec,
)
from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.engine import Engine, Request

NS = "fabric"


def _note(msg: str) -> None:
    print(f"disaggbench: {msg}", file=sys.stderr)


# --- role-partitioned fabric -------------------------------------------------


class DisaggFabric(Fabric):
    """Fabric whose bootstrap assigns phase roles from a plan: the
    first claims bound become prefill replicas, the rest decode (or
    all "both" for the colocated baseline). The autoscaler's
    disaggregated mode calls ``make_replica(claim, role)`` explicitly
    (replacement inherits the dead replica's role); bootstrap binds
    walk the plan in claim order."""

    def __init__(self, *args, roles: Optional[List[str]] = None, **kw):
        self._role_plan = list(roles or [])
        self._role_i = 0
        super().__init__(*args, **kw)

    def _make_replica(self, claim: dict, role: Optional[str] = None):
        if role is None:
            if self._role_i < len(self._role_plan):
                role = self._role_plan[self._role_i]
                self._role_i += 1
            else:
                role = "both"
        rep = Replica(
            claim["metadata"]["name"], self._engine(),
            claim_name=claim["metadata"]["name"], claim=claim,
            metrics=self.metrics, role=role,
        )
        rep.start()
        return rep


def _mk_fabric(
    nodes, config, params, ec, slots, roles=None, sample_seed=None,
    device=None, make_claim_layer=None, stall_deadline_seconds=None,
) -> DisaggFabric:
    if sample_seed is not None:
        ec = dataclasses.replace(ec, sample_seed=sample_seed)
    return DisaggFabric(
        nodes, [TenantSpec("t", INTERACTIVE, weight=1.0)],
        config, params, ec,
        RouterConfig(
            backlog_cap_tokens=1e9, max_inflight_per_replica=slots,
            **_watchdog(stall_deadline_seconds),
        ),
        AutoscalerConfig(
            min_replicas=1, max_replicas=64,
            disaggregated=roles is not None,
        ),
        roles=roles,
        claim_layer=_layer(make_claim_layer, nodes), device=device,
    )


# --- trace -------------------------------------------------------------------


def make_disagg_trace(
    seed: int, requests: int, rate_rps: float, vocab: int,
    prompt_lens, output_lens, pin_sampling: bool = False,
    sample_seed: int = 0,
):
    """Seeded prompt-heavy open-loop trace, arrival-sorted
    ``(arrival_s, tenant, Request, session)`` tuples in the fabric
    drive contract. ``pin_sampling`` stamps an explicit per-request
    (seed, serial) so the sampled trajectory is a pure function of the
    trace — identical across disagg/colocated/reference runs
    regardless of admission order."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, requests))
    out = []
    for i in range(requests):
        plen = int(rng.choice(prompt_lens))
        olen = int(rng.choice(output_lens))
        out.append((
            float(arrivals[i]), "t",
            Request(
                rid=f"d-{i:05d}",
                prompt=rng.integers(1, vocab, plen).astype(np.int32),
                max_new_tokens=olen,
                sample_seed=sample_seed if pin_sampling else None,
                sample_serial=i if pin_sampling else None,
            ),
            None,
        ))
    out.sort(key=lambda x: (x[0], x[2].rid))
    return out


def _reference_tokens(config, params, ec, trace, sample_seed=None,
                      device=None):
    """Uninterrupted single-engine run of the trace's requests — the
    token-parity oracle both disagg phases compare against."""
    if sample_seed is not None:
        ec = dataclasses.replace(ec, sample_seed=sample_seed)
    eng = Engine(config, params, ec, device=device)
    done = eng.run([dataclasses.replace(t[2]) for t in trace])
    eng.close()
    return {rid: c.tokens for rid, c in done.items()}


def _itl_ms(completions) -> List[float]:
    """Per-sequence mean inter-token latency, decode side only: time
    from first token to done over the tokens after the first. One
    sample per completion keeps slow sequences from drowning fast ones
    (the quantile is over SEQUENCES, matching the TTFT convention)."""
    out = []
    for c in completions.values():
        n = len(c.tokens)
        if n >= 2:
            out.append((c.t_done - c.t_first_token) * 1000.0 / (n - 1))
    return sorted(out)


def _latency_report(fab: DisaggFabric) -> dict:
    ttft = sorted(
        c.ttft_s * 1000.0 for c in fab.router.completions.values()
    )
    itl = _itl_ms(fab.router.completions)
    return {
        "n": len(ttft),
        "ttft_p50_ms": round(_pct(ttft, 0.5), 2),
        "ttft_p99_ms": round(_pct(ttft, 0.99), 2),
        "itl_p50_ms": round(_pct(itl, 0.5), 2),
        "itl_p99_ms": round(_pct(itl, 0.99), 2),
        "itl_mean_ms": round(statistics.mean(itl), 2) if itl else 0.0,
    }


# --- phase 1: parity ---------------------------------------------------------


def run_parity(config, params, nodes, slots, seed, timeout, device=None,
               make_claim_layer=None) -> dict:
    """Migrated sequences are token-identical to the un-migrated
    reference — greedy AND sampled — with >= 1 real shipped migration
    and leak-free allocators on both pools."""
    ec = _engine_config(slots, max_prompt=12, max_out=24)
    warm_jit(config, params, ec, device)
    trace = make_disagg_trace(
        seed, requests=8, rate_rps=50.0, vocab=config.vocab_size,
        prompt_lens=[8, 12], output_lens=[16, 24],
        pin_sampling=True, sample_seed=seed,
    )
    out = {}
    for label, sample_seed in (("greedy", None), ("sampled", seed)):
        # Greedy ignores the sampling schedule — strip the pins so the
        # engines (default seed) accept the requests.
        t = trace if sample_seed is not None else [
            (a, tn, dataclasses.replace(
                r, sample_seed=None, sample_serial=None,
            ), s)
            for a, tn, r, s in trace
        ]
        ref = _reference_tokens(config, params, ec, t, sample_seed, device)
        fab = _mk_fabric(
            nodes, config, params, ec, slots,
            roles=["prefill", "decode"], sample_seed=sample_seed,
            device=device, make_claim_layer=make_claim_layer,
        )
        try:
            fab.scale_to(2)
            fab.drive(t, timeout=timeout)
            done = fab.router.completions
            assert len(done) == len(trace), (
                f"parity[{label}]: {len(done)}/{len(trace)} completed"
            )
            shipped = fab.router.kv_migrations.get("shipped", 0)
            assert shipped >= 1, (
                f"parity[{label}]: no migration ever shipped "
                f"({fab.router.kv_migrations}) — the disagg path "
                f"did not exercise"
            )
            mismatch = [
                rid for rid in ref
                if not np.array_equal(done[rid].tokens, ref[rid])
            ]
            assert not mismatch, (
                f"parity[{label}]: migrated completions diverged from "
                f"the un-migrated reference on {mismatch}"
            )
            for rep in fab.router.replicas:
                alloc = rep.engine.allocator
                assert alloc.free_pages == alloc.num_pages - 1, (
                    f"parity[{label}]: {rep.name} leaked pages "
                    f"({alloc.free_pages}/{alloc.num_pages})"
                )
                assert alloc.reserved_pages == 0
            out[label] = {
                "completed": len(done),
                "kv_migrations_shipped": shipped,
                "kv_migrations_fallback":
                    fab.router.kv_migrations.get("fallback", 0),
                "kv_migrated_pages": fab.router.kv_migrated_pages,
            }
            _note(
                f"parity[{label}]: {len(done)} token-identical, "
                f"{shipped} shipped migrations "
                f"({fab.router.kv_migrated_pages} pages)"
            )
        finally:
            fab.stop()
    return out


# --- phase 2: kill drill -----------------------------------------------------


def run_kill_drill(config, params, nodes, slots, seed, timeout,
                   device=None, make_claim_layer=None) -> dict:
    """Crash the decode replica at the migration boundary (grafted
    sequences in flight): the journal replays prompt + emitted by
    re-prefill on the surviving prefill replica — zero lost, zero
    duplicated, tokens identical to the uninterrupted reference."""
    ec = _engine_config(slots, max_prompt=12, max_out=32)
    warm_jit(config, params, ec, device)
    trace = make_disagg_trace(
        seed + 1, requests=8, rate_rps=100.0, vocab=config.vocab_size,
        prompt_lens=[8, 12], output_lens=[24, 32],
    )
    ref = _reference_tokens(config, params, ec, trace, device=device)
    fab = _mk_fabric(
        nodes, config, params, ec, slots, roles=["prefill", "decode"],
        device=device, make_claim_layer=make_claim_layer,
    )
    killed = [False]

    def _kill_at_migration_boundary():
        if killed[0]:
            return
        for rep in fab.router.replicas:
            if rep.role == "decode" and rep.inflight:
                # Grafted sequences in flight on the decode pool: the
                # exact window where the source already RELEASED its
                # pages — only the journal can reconstruct.
                rep.inject_fault("crash")
                killed[0] = True
                return

    try:
        fab.scale_to(2)
        fab.drive(
            trace, timeout=timeout,
            extra_tick=_kill_at_migration_boundary,
        )
        done = fab.router.completions
        want = {t[2].rid for t in trace}
        assert killed[0], (
            "kill drill never armed: no migration reached the decode "
            "replica's inflight set"
        )
        assert set(done) == want, (
            f"kill drill lost/invented sequences: {set(done) ^ want}"
        )
        mismatch = [
            rid for rid in want
            if not np.array_equal(done[rid].tokens, ref[rid])
        ]
        assert not mismatch, (
            f"kill drill: post-crash completions diverged from the "
            f"reference on {mismatch}"
        )
        recovered = [
            rid for rid, c in done.items() if len(c.replicas) > 1
        ]
        _note(
            f"kill drill: decode replica crashed with grafts in "
            f"flight; {len(recovered)} sequences journal-recovered, "
            f"all {len(done)} token-identical"
        )
        return {
            "killed": True,
            "completed": len(done),
            "journal_recovered": len(recovered),
            "kv_migrations": dict(fab.router.kv_migrations),
        }
    finally:
        fab.stop()


# --- phase 3: measure --------------------------------------------------------


def run_measure(
    config, params, nodes, replicas, prefill_replicas, requests,
    rate, slots, seed, timeout, device=None, make_claim_layer=None,
    stall_deadline_seconds=None,
) -> dict:
    """Colocated vs disaggregated at equal chips on the identical
    seeded prompt-heavy trace. ``stall_deadline_seconds`` sets the
    Router's watchdog (None: its default)."""
    ec = _engine_config(slots, max_prompt=48, max_out=16)
    warm_jit(config, params, ec, device)
    trace = make_disagg_trace(
        seed, requests=requests, rate_rps=rate,
        vocab=config.vocab_size,
        # Prompt-heavy by design: prefill work per request is ~3x the
        # decode work, the regime where phase interference shows.
        prompt_lens=[24, 32, 48], output_lens=[8, 12, 16],
    )
    n_p = max(1, min(prefill_replicas, replicas - 1))
    plans = {
        "colocated": ["both"] * replicas,
        "disagg": ["prefill"] * n_p + ["decode"] * (replicas - n_p),
    }
    out = {}
    for label, roles in plans.items():
        fab = _mk_fabric(
            nodes, config, params, ec, slots, roles=roles,
            device=device, make_claim_layer=make_claim_layer,
            stall_deadline_seconds=stall_deadline_seconds,
        )
        try:
            fab.scale_to(replicas)
            res = fab.drive(trace, timeout=timeout)
            done = fab.router.completions
            assert res["submitted"] == len(done), (
                f"measure[{label}]: lost sequences "
                f"({res['submitted']} admitted, {len(done)} completed)"
            )
            rep = _latency_report(fab)
            rep.update({
                "wall_s": res["wall_s"],
                "kv_migrations_shipped":
                    fab.router.kv_migrations.get("shipped", 0),
                "kv_migrations_fallback":
                    fab.router.kv_migrations.get("fallback", 0),
                "kv_migrated_pages": fab.router.kv_migrated_pages,
                "migration_p50_ms": round(_pct(sorted(
                    s * 1000.0 for s in fab.router.migration_seconds
                ), 0.5), 3),
            })
            out[label] = rep
            _note(
                f"measure[{label}]: ttft p99 {rep['ttft_p99_ms']} ms, "
                f"itl p99 {rep['itl_p99_ms']} ms, "
                f"{rep['kv_migrations_shipped']} migrations, wall "
                f"{rep['wall_s']}s"
            )
        finally:
            fab.stop()
    assert out["disagg"]["kv_migrations_shipped"] >= 1, (
        "measured disagg side shipped no migrations — the phase split "
        "never engaged (roles/export wiring broke)"
    )
    assert out["colocated"]["kv_migrations_shipped"] == 0, (
        "colocated baseline shipped migrations — 'both' replicas must "
        "never export"
    )
    return out


# --- entry point -------------------------------------------------------------


def run(
    nodes: int,
    replicas: int,
    prefill_replicas: int,
    requests: int,
    rate: float,
    slots: int,
    seed: int,
    smoke: bool = False,
    timeout: float = 900.0,
    device=None,
    make_claim_layer=None,
) -> dict:
    config, params = _model(device)

    parity = run_parity(
        config, params, nodes=min(nodes, 8), slots=slots, seed=seed,
        timeout=timeout, device=device, make_claim_layer=make_claim_layer,
    )
    drill = run_kill_drill(
        config, params, nodes=min(nodes, 8), slots=slots, seed=seed,
        timeout=timeout, device=device, make_claim_layer=make_claim_layer,
    )
    measure = run_measure(
        config, params, nodes, replicas, prefill_replicas, requests,
        rate, slots, seed, timeout, device=device,
        make_claim_layer=make_claim_layer,
    )

    dis, col = measure["disagg"], measure["colocated"]
    vs_ttft = round(
        dis["ttft_p99_ms"] / max(col["ttft_p99_ms"], 1e-9), 3
    )
    vs_itl = round(dis["itl_p99_ms"] / max(col["itl_p99_ms"], 1e-9), 3)
    report = {
        "disagg_nodes": nodes,
        "disagg_replicas": replicas,
        "disagg_prefill_replicas": max(
            1, min(prefill_replicas, replicas - 1)
        ),
        "disagg_requests": requests,
        "disagg_ttft_p50_ms": dis["ttft_p50_ms"],
        "disagg_ttft_p99_ms": dis["ttft_p99_ms"],
        "disagg_itl_p50_ms": dis["itl_p50_ms"],
        "disagg_itl_p99_ms": dis["itl_p99_ms"],
        "disagg_colocated_ttft_p99_ms": col["ttft_p99_ms"],
        "disagg_colocated_itl_p99_ms": col["itl_p99_ms"],
        "disagg_vs_colocated_ttft": vs_ttft,
        "disagg_vs_colocated_itl": vs_itl,
        "disagg_kv_migrations": dis["kv_migrations_shipped"],
        "disagg_kv_migration_fallbacks": dis["kv_migrations_fallback"],
        "disagg_kv_migrated_pages": dis["kv_migrated_pages"],
        "disagg_migration_p50_ms": dis["migration_p50_ms"],
        "disagg_parity": parity,
        "disagg_kill_drill": drill,
        "seed": seed,
    }
    _note(
        f"disagg vs colocated: ttft p99 x{vs_ttft}, itl p99 x{vs_itl} "
        f"(< 1.0 = disaggregation wins)"
    )
    allow_gap = os.environ.get("DISAGG_ALLOW_GAP") == "1"
    if not smoke and not allow_gap:
        # The headline claim, gated hard at full size: phase
        # disaggregation beats colocation on BOTH tails at equal
        # chips. Drill sizes run the identical code path but their
        # quantiles are queueing noise — DISAGG_ALLOW_GAP=1 records
        # anyway.
        assert vs_ttft < 1.0, (
            f"disaggregated TTFT p99 did not beat colocated "
            f"(x{vs_ttft}) — DISAGG_ALLOW_GAP=1 to record anyway"
        )
        assert vs_itl < 1.0, (
            f"disaggregated ITL p99 did not beat colocated "
            f"(x{vs_itl}) — DISAGG_ALLOW_GAP=1 to record anyway"
        )
    if smoke:
        _note(
            "smoke contract: token parity greedy+sampled across live "
            "migration, lossless kill at the migration boundary, "
            "shipped migrations on the measured disagg side, zero on "
            "colocated — all hold"
        )
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser("disaggbench", description=__doc__)
    p.add_argument(
        "--smoke", action="store_true",
        help="CI size: small fleet/trace + the hard contract asserts",
    )
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    env = os.environ.get
    if args.smoke:
        nodes = int(env("DISAGG_NODES", "8"))
        replicas = int(env("DISAGG_REPLICAS", "2"))
        prefill = int(env("DISAGG_PREFILL", "1"))
        requests = int(env("DISAGG_REQUESTS", "24"))
        rate = float(env("DISAGG_RATE", "60"))
        slots = int(env("DISAGG_SLOTS", "4"))
    else:
        nodes = int(env("DISAGG_NODES", "64"))
        replicas = int(env("DISAGG_REPLICAS", "8"))
        prefill = int(env("DISAGG_PREFILL", "4"))
        requests = int(env("DISAGG_REQUESTS", "2000"))
        rate = float(env("DISAGG_RATE", "400"))
        slots = int(env("DISAGG_SLOTS", "8"))
    seed = int(env("DISAGG_SEED", "20260807"))
    report = run(
        nodes, replicas, prefill, requests, rate, slots, seed,
        smoke=args.smoke, device=device,
    )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
