"""Crash-tolerant serving fabric bench + smoke.

The port's copy of ``tpu_dra/serving/faultbench.py`` (the port imports
nothing of the JAX package): the fabric's failure semantics proven
under load, on the same stack :mod:`.fabricbench` composes (a claim
layer, claims, live engine replicas). Three drills:

1. **crash drill (greedy)**: a seeded chaos schedule
   (``replica_crash`` + ``replica_stall``) kills one replica hard and
   wedges a second MID-GENERATION under an open-loop trace. Gates:
   zero lost and zero duplicated sequences (journal recovery is
   exactly-once), completions TOKEN-IDENTICAL to an uninterrupted
   single-engine reference, both death reasons detected (reaper +
   stuck-iteration watchdog), and post-kill TTFT p99 recovery within
   the gated window (``fault_recovery_p99_ms`` vs
   FAULT_RECOVERY_BOUND_MS);
2. **crash drill (sampled)**: the same kills under temperature
   sampling — survivors resume with the JOURNALED ``(seed, serial)``
   schedule, and completions must be token-identical to a reference
   engine replaying that schedule (position-keyed folding makes the
   schedule portable across replicas);
3. **crash-loop drill**: one claim's replica is re-crashed on every
   hot re-bind until its circuit opens — the breaker must quarantine
   the claim (routing stops, claim DELETED) and the autoscaler must
   REPLACE it through the normal claim path (allocated by the claim
   layer), with the trace still completing losslessly. No replica
   death raises out of ``Fabric.drive``.

Engines run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu``).

Knobs (env): FAULT_NODES, FAULT_REQUESTS, FAULT_SEED,
FAULT_RECOVERY_BOUND_MS.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import time
from typing import List

import numpy as np

from tpu_dra_torch.infra import chaos
from tpu_dra_torch.serving.autoscaler import AutoscalerConfig
from tpu_dra_torch.serving.fabricbench import (
    NS,
    Fabric,
    _engine_config,
    _layer,
    _model,
    warm_jit,
)
from tpu_dra_torch.serving.router import INTERACTIVE, RouterConfig, TenantSpec
from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.engine import Engine, Request


def _note(msg: str) -> None:
    print(f"faultbench: {msg}", file=sys.stderr)


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[int(q * (len(sorted_vals) - 1))]


def _kill_schedule(seed: int) -> chaos.FaultSchedule:
    """The seeded schedule: one hard crash, then one stall, both early
    enough that the open-loop trace still has work in flight AND
    arrivals keep landing afterwards (the recovery-TTFT window).
    Round-tripped through from_dict so the new serving kinds run the
    same validation gate every schedule file does."""
    rng = random.Random(seed)
    t_crash = round(0.15 + rng.uniform(0.0, 0.1), 3)
    t_stall = round(t_crash + 0.3 + rng.uniform(0.0, 0.15), 3)
    return chaos.FaultSchedule.from_dict({
        "version": 1,
        "seed": seed,
        "description": "faultbench: hard-kill one replica, wedge another",
        "events": [
            {"at": t_crash, "kind": chaos.REPLICA_CRASH,
             "replica_index": rng.randrange(8)},
            {"at": t_stall, "kind": chaos.REPLICA_STALL,
             "replica_index": rng.randrange(8)},
        ],
    })


def _make_trace(seed: int, requests: int, vocab: int, span_s: float):
    """Open-loop single-tenant trace: arrivals spread over ``span_s``
    so the kill schedule lands mid-trace with sequences in flight and
    post-kill arrivals measuring recovery."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(requests):
        out.append((
            round(span_s * i / max(1, requests - 1), 4),
            "gold",
            Request(
                rid=f"g-{i:04d}",
                prompt=rng.integers(1, vocab, 8).astype(np.int32),
                max_new_tokens=int(rng.choice([16, 24, 32])),
            ),
            f"s{i % 6}",
        ))
    return out


def run_crash_drill(
    config, params, nodes, requests, seed, timeout,
    temperature: float = 0.0, recovery_bound_ms: float = 20000.0,
    device=None, make_claim_layer=None,
) -> dict:
    """Kill one replica hard and wedge another mid-generation; gate
    exactly-once recovery, token identity (greedy OR sampled via the
    journaled schedule), and bounded post-kill TTFT."""
    label = "sampled" if temperature > 0 else "greedy"
    gold = TenantSpec("gold", INTERACTIVE, weight=1.0)
    slots = 4
    ec = _engine_config(slots, max_prompt=10, max_out=34)
    if temperature > 0:
        ec = dataclasses.replace(
            ec, temperature=temperature, top_k=20, sample_seed=13
        )
    warm_jit(config, params, ec, device)
    fab = Fabric(
        nodes, [gold], config, params, ec,
        RouterConfig(
            backlog_cap_tokens=1e9, max_inflight_per_replica=slots,
            # Detection small enough that the wedged replica's work
            # re-dispatches inside the drill; large enough that a slow
            # step (a shape the warm-up missed) never false-positives
            # a healthy engine — a too-tight
            # deadline also races the armed crash flag: the watchdog
            # declares "stall" before the engine thread finishes its
            # step and trips the crash.
            stall_deadline_seconds=2.5,
            breaker_deaths=3, breaker_window_seconds=10.0,
            redispatch_backoff_base_seconds=0.01,
            redispatch_backoff_cap_seconds=0.1,
        ),
        AutoscalerConfig(
            min_replicas=3, max_replicas=3,
            # Load-driven scaling parked (the drill measures the
            # failure path): replacement/rebind still run.
            target_tokens_per_replica=1e9,
            cooldown_seconds=0.1,
            claim_check_seconds=0.2,
            dead_join_timeout_seconds=2.0,
        ),
        claim_layer=_layer(make_claim_layer, nodes), device=device,
    )
    sched = _kill_schedule(seed)
    trace = _make_trace(
        seed, requests, config.vocab_size,
        span_s=max(1.2, sched.events[-1].at + 0.6),
    )
    eng = chaos.ChaosEngine(sched)
    kill_walls: List[float] = []  # wall time each kill actually fired

    def _inject(kind):
        fault = "crash" if kind == chaos.REPLICA_CRASH else "stall"

        def inject(ev):
            # Never double-arm: a replica already carrying a pending
            # fault (or already erroring out) would have its one-shot
            # flag OVERWRITTEN, silently losing the first kill.
            live = [
                r for r in fab.router.live_replicas()
                if r._fault is None and r.error is None
            ]
            # Mid-generation is the point: prefer a replica holding
            # in-flight sequences (the replica_index picks among them).
            cands = [r for r in live if r.inflight] or live
            if not cands:
                return
            rep = cands[ev.params["replica_index"] % len(cands)]
            rep.inject_fault(fault)
            kill_walls.append(time.monotonic())

        return inject

    eng.register(chaos.REPLICA_CRASH, _inject(chaos.REPLICA_CRASH))
    eng.register(chaos.REPLICA_STALL, _inject(chaos.REPLICA_STALL))

    t0 = None  # chaos clock starts when the DRIVE starts, not at setup

    def chaos_tick():
        # Fire due events on the drive's control thread (the injector
        # touches replicas — the router's threading contract). The
        # first tick anchors t0 so event offsets are relative to the
        # open-loop trace, not to however long engine bring-up took.
        nonlocal t0
        if t0 is None:
            t0 = time.monotonic()
        while eng.remaining:
            nxt = eng.schedule.events[len(eng.schedule.events)
                                      - eng.remaining]
            if nxt.at > time.monotonic() - t0:
                break
            eng.step()

    try:
        fab.scale_to(3)
        res = fab.drive(
            trace, autoscale=True, timeout=timeout,
            extra_tick=chaos_tick,
        )
        # Late stall: if the trace drained before the stall landed, the
        # gate below fails loudly — the schedule/trace sizing contract
        # (kills land mid-generation) is part of what this smoke pins.
        deaths = fab.router.deaths
        reasons = {r for _, r, _ in fab.router.death_log}
        assert deaths >= 2, (
            f"[{label}] wanted >= 2 replica deaths, got {deaths} "
            f"({fab.router.death_log})"
        )
        assert "crash" in reasons and "stall" in reasons, (
            f"[{label}] wanted both detection paths (crash + stall), "
            f"got {reasons}"
        )
        assert fab.router.redispatched >= 1, (
            f"[{label}] no sequence was journal-recovered — the kills "
            f"did not land mid-generation"
        )
        # Exactly-once: every admitted rid completed, none twice (the
        # completion store is keyed by rid; count equality + set
        # equality close both directions).
        done = fab.router.completions
        want = {r.rid for _, _, r, _ in trace}
        assert res["rejected"] == 0, (
            f"[{label}] {res['rejected']} rejects under an uncapped "
            f"backlog"
        )
        assert set(done) == want, (
            f"[{label}] lost/invented sequences across replica "
            f"deaths: {set(done) ^ want}"
        )
        # Token identity vs an uninterrupted single-engine reference.
        # Sampled: the reference pins each request's JOURNALED
        # (seed, serial) schedule — the survivors did the same, so the
        # trajectories must agree token for token.
        refs = []
        for _, _, r, _ in trace:
            if temperature > 0:
                ss = fab.router.journal.sample_schedule(r.rid)
                assert ss is not None and ss[1] is not None, (
                    f"[{label}] no journaled sampling schedule for "
                    f"{r.rid}"
                )
                refs.append(dataclasses.replace(
                    r, sample_seed=ss[0], sample_serial=ss[1],
                ))
            else:
                refs.append(dataclasses.replace(r))
        ref = Engine(config, params, ec, device=device).run(refs)
        mismatch = [
            rid for rid in want
            if not np.array_equal(done[rid].tokens, ref[rid].tokens)
        ]
        assert not mismatch, (
            f"[{label}] completions diverged from the uninterrupted "
            f"reference on {sorted(mismatch)[:5]}"
        )
        # Post-kill recovery: TTFT p99 of requests submitted AFTER the
        # last kill fired must sit inside the gated window — capacity
        # loss plus journal replay cannot park late arrivals forever.
        last_kill = max(kill_walls) if kill_walls else t0
        post = sorted(
            c.ttft_s * 1000.0 for c in done.values()
            if c.t_submit >= last_kill
        )
        assert post, (
            f"[{label}] no arrivals after the last kill — the trace "
            f"span does not cover the recovery window"
        )
        recovery_p99 = round(_pct(post, 0.99), 2)
        assert recovery_p99 <= recovery_bound_ms, (
            f"[{label}] post-kill TTFT p99 {recovery_p99} ms exceeds "
            f"the {recovery_bound_ms} ms recovery bound "
            f"(FAULT_RECOVERY_BOUND_MS to widen on a hostile machine)"
        )
        _note(
            f"crash[{label}]: deaths={deaths} ({', '.join(sorted(reasons))}), "
            f"redispatched={fab.router.redispatched}, "
            f"duplicates_dropped={fab.router.duplicates_dropped}, "
            f"post-kill ttft p99 {recovery_p99} ms over {len(post)} "
            f"arrivals, wall {res['wall_s']}s"
        )
        return {
            "deaths": deaths,
            "reasons": sorted(reasons),
            "redispatched": fab.router.redispatched,
            "duplicates_dropped": fab.router.duplicates_dropped,
            "lost": 0,
            "recovery_p99_ms": recovery_p99,
            "recovery_n": len(post),
            "identical": True,
        }
    finally:
        fab.stop()


def run_crash_loop_drill(
    config, params, nodes, seed, timeout, device=None,
    make_claim_layer=None,
) -> dict:
    """Crash one claim's replica on every hot re-bind until the
    breaker opens: the claim must be quarantined + DELETED, a
    replacement claim allocated by the claim layer, and the trace must
    still complete losslessly and token-identically."""
    gold = TenantSpec("gold", INTERACTIVE, weight=1.0)
    slots = 4
    ec = _engine_config(slots, max_prompt=10, max_out=28)
    warm_jit(config, params, ec, device)
    fab = Fabric(
        nodes, [gold], config, params, ec,
        RouterConfig(
            backlog_cap_tokens=1e9, max_inflight_per_replica=slots,
            stall_deadline_seconds=5.0,
            breaker_deaths=3, breaker_window_seconds=30.0,
            redispatch_backoff_base_seconds=0.01,
            redispatch_backoff_cap_seconds=0.1,
        ),
        AutoscalerConfig(
            min_replicas=2, max_replicas=2,
            target_tokens_per_replica=1e9,
            cooldown_seconds=0.1,
            claim_check_seconds=0.5,
            dead_join_timeout_seconds=2.0,
        ),
        claim_layer=_layer(make_claim_layer, nodes), device=device,
    )
    rng = np.random.default_rng(seed)
    reqs = [
        Request(
            rid=f"loop-{i:03d}",
            prompt=rng.integers(1, config.vocab_size, 8).astype(np.int32),
            max_new_tokens=24,
        )
        for i in range(20)
    ]
    trace = [(0.0, "gold", r, f"s{i}") for i, r in enumerate(reqs)]
    try:
        fab.scale_to(2)
        target = fab.router.replicas[0].claim_name
        armed: set = set()

        def crash_loop_tick():
            # Re-arm the crash on whatever replica currently serves
            # the target claim (each re-bind makes a fresh Replica) —
            # the seam the replica_crash_loop chaos kind drives.
            if len(armed) >= 3:
                return
            for rep in fab.router.live_replicas():
                if (
                    rep.claim_name == target
                    and id(rep) not in armed
                    and rep.inflight
                    and rep.error is None
                ):
                    armed.add(id(rep))
                    rep.inject_fault("crash")
                    return

        res = fab.drive(
            trace, autoscale=True, timeout=timeout,
            extra_tick=crash_loop_tick,
        )
        deaths_on_target = sum(
            1 for name, _, _ in fab.router.death_log if name
        )
        assert fab.router.breaker.opened_total >= 1, (
            f"circuit never opened after {deaths_on_target} deaths "
            f"({fab.router.death_log})"
        )
        quarantines = [
            e for e in fab.autoscaler.events if e[0] == "quarantine"
        ]
        assert quarantines and quarantines[0][1] == target, (
            f"no quarantine event for {target}: "
            f"{fab.autoscaler.events}"
        )
        assert fab.claims.try_get(target, NS) is None, (
            f"quarantined claim {target} was not deleted"
        )
        replaces = [
            e for e in fab.autoscaler.events
            if e[0] == "replace-requested"
        ]
        assert replaces, "autoscaler never requested a replacement"
        replacement = replaces[0][1]
        cur = fab.claims.try_get(replacement, NS)
        alloc = ((cur or {}).get("status") or {}).get("allocation")
        assert alloc, (
            f"replacement claim {replacement} never placed by the "
            f"packer"
        )
        assert any(
            e[0] == "up-ready" and e[1] == replacement
            for e in fab.autoscaler.events
        ), f"replacement {replacement} never bound a replica"
        done = fab.router.completions
        want = {r.rid for r in reqs}
        assert set(done) == want and res["rejected"] == 0, (
            f"lost/invented sequences across the crash loop: "
            f"{set(done) ^ want}"
        )
        ref = Engine(config, params, ec, device=device).run(
            [dataclasses.replace(r) for r in reqs]
        )
        mismatch = [
            rid for rid in want
            if not np.array_equal(done[rid].tokens, ref[rid].tokens)
        ]
        assert not mismatch, (
            f"crash-loop completions diverged from the reference on "
            f"{mismatch}"
        )
        _note(
            f"crash-loop: {len(armed)} injected crashes on {target}, "
            f"rebinds={fab.autoscaler.rebinds}, circuit opened, claim "
            f"replaced by {replacement}, wall {res['wall_s']}s"
        )
        return {
            "deaths": fab.router.deaths,
            "rebinds": fab.autoscaler.rebinds,
            "circuit_opens": fab.router.breaker.opened_total,
            "quarantined": fab.autoscaler.quarantined,
            "claims_replaced": fab.autoscaler.replaced,
            "redispatched": fab.router.redispatched,
            "duplicates_dropped": fab.router.duplicates_dropped,
        }
    finally:
        fab.stop()


# --- entry points ------------------------------------------------------------


def run(
    nodes: int,
    requests: int,
    seed: int,
    smoke: bool = False,
    timeout: float = 600.0,
    recovery_bound_ms: float = 20000.0,
    device=None,
    make_claim_layer=None,
) -> dict:
    config, params = _model(device)
    _note(
        f"crash drills: {nodes} nodes, 3 replicas, {requests} requests, "
        f"seed {seed}"
    )
    greedy = run_crash_drill(
        config, params, nodes, requests, seed, timeout,
        temperature=0.0, recovery_bound_ms=recovery_bound_ms,
        device=device, make_claim_layer=make_claim_layer,
    )
    sampled = run_crash_drill(
        config, params, nodes, requests, seed + 1, timeout,
        temperature=0.8, recovery_bound_ms=recovery_bound_ms,
        device=device, make_claim_layer=make_claim_layer,
    )
    loop = run_crash_loop_drill(
        config, params, nodes, seed, timeout, device=device,
        make_claim_layer=make_claim_layer,
    )
    report = {
        "fault_deaths": (
            greedy["deaths"] + sampled["deaths"] + loop["deaths"]
        ),
        "fault_redispatched": (
            greedy["redispatched"] + sampled["redispatched"]
            + loop["redispatched"]
        ),
        "fault_lost_sequences": greedy["lost"] + sampled["lost"],
        "fault_duplicates_dropped": (
            greedy["duplicates_dropped"] + sampled["duplicates_dropped"]
            + loop["duplicates_dropped"]
        ),
        "fault_recovery_p99_ms": greedy["recovery_p99_ms"],
        "fault_recovery_sampled_p99_ms": sampled["recovery_p99_ms"],
        "fault_circuit_opens": loop["circuit_opens"],
        "fault_claims_replaced": loop["claims_replaced"],
        "fault_rebinds": loop["rebinds"],
        "fault_greedy_identical": greedy["identical"],
        "fault_sampled_identical": sampled["identical"],
        "seed": seed,
    }
    if smoke:
        _note(
            "smoke contract: both detection paths, exactly-once journal "
            "recovery, greedy + journaled-sampled token identity, "
            "bounded post-kill TTFT, circuit-open -> quarantine -> "
            "claim replacement — all hold"
        )
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser("faultbench", description=__doc__)
    p.add_argument(
        "--smoke", action="store_true",
        help="CI size: small fleet/trace + the hard contract asserts",
    )
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    env = os.environ.get
    nodes = int(env("FAULT_NODES", "8"))
    requests = int(env("FAULT_REQUESTS", "36" if args.smoke else "160"))
    seed = int(env("FAULT_SEED", "20260807"))
    bound = float(env("FAULT_RECOVERY_BOUND_MS", "20000"))
    report = run(
        nodes, requests, seed, smoke=args.smoke,
        recovery_bound_ms=bound, device=device,
    )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
