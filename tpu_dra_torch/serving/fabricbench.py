"""Serving-fabric bench + smoke: the tier above the engine, end to end.

The port's copy of ``tpu_dra/serving/fabricbench.py`` (the port imports
nothing of the JAX package). It composes a claim layer, ResourceClaims
created and deleted by the
:class:`~tpu_dra_torch.serving.autoscaler.ClaimAutoscaler`, and N live
:class:`~tpu_dra_torch.workloads.engine.Engine` replicas behind the
multi-tenant :class:`~tpu_dra_torch.serving.router.Router`, replaying a
seeded open-loop multi-tenant Poisson trace.

The claim layer is a seam (:class:`Fabric`'s ``claim_layer``): by
default a :class:`~tpu_dra_torch.serving.claims.ClaimStore`, which grants
every claim at once on the engines' device; a caller may pass the
driver's own (a fake cluster, its published fleet and the scheduler's
packer), as the CPU twin tests do.

Headline: **user-request-submitted → first-token** p50/p99
(``fabric_ttft_p50_ms`` / ``fabric_ttft_p99_ms``) per tenant, with the
tenants' token shares, the peak in-system concurrency, the affinity hit
rate and the prefix pages the engines shared. The driver's bench also
judges the per-class TTFT against its SLO catalog through a metrics
endpoint and its fleet monitor; those are the driver's operations tools
and are not part of the port.

Three measured phases:

1. **headline**: the full tenant mix (interactive + standard + batch)
   at an arrival rate held above the fleet's service rate;
2. **fairness pair** (smoke gate a): the identical quiet-tenant trace
   measured twice — hot batch tenant ABSENT vs PRESENT. The WFQ
   contract: the hot tenant cannot degrade a quiet tenant's TTFT p99
   beyond a pinned bound over the hot-absent baseline
   (``fabric_quiet_p99_x``; FABRIC_ALLOW_GAP=1 bypasses on hostile
   machines);
3. **autoscale drill** (smoke gate b): a burst drives a claim-driven
   scale-up — the claim must be ALLOCATED by the claim layer (device
   results) and the decision→serving reaction time is recorded — then
   the post-burst lull drives a scale-down whose victim is evacuated
   MID-GENERATION: zero lost or duplicated sequences, completions
   TOKEN-IDENTICAL to an uninterrupted single-engine reference
   (greedy), and the ResourceClaim deleted only after the drain (the
   events log pins the ordering).

Engines run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu``).

Knobs (env): FABRIC_NODES, FABRIC_REPLICAS, FABRIC_REQUESTS,
FABRIC_RATE, FABRIC_SEED, FABRIC_CAP, FABRIC_SLOTS, FABRIC_ALLOW_GAP,
FABRIC_ALLOW_SCALE.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from tpu_dra_torch.infra.metrics import Metrics
from tpu_dra_torch.serving.autoscaler import AutoscalerConfig, ClaimAutoscaler
from tpu_dra_torch.serving.claims import ClaimStore, make_claim
from tpu_dra_torch.serving.router import (
    BATCH,
    INTERACTIVE,
    STANDARD,
    Replica,
    Router,
    RouterConfig,
    TenantSpec,
)
from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.engine import Engine, EngineConfig, Request
from tpu_dra_torch.workloads.models.llama import as_tree

NS = "fabric"


def _note(msg: str) -> None:
    print(f"fabricbench: {msg}", file=sys.stderr)


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[int(q * (len(sorted_vals) - 1))]


def _device_name(device) -> str:
    """``"cuda:<index>"`` or ``"cpu"``: the device a claim is granted."""
    device = resolve_device(device)
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        return f"cuda:{index}"
    return str(device)


# --- model (TINY, fp32) ------------------------------------------------------


def _model(device=None):
    """TINY_LLAMA at fp32, widened to dim 256 (head dim 64, which the
    card's decode kernels take; TINY's 16 they refuse), random weights
    from a seeded generator, the same on every device."""
    from tpu_dra_torch.workloads.enginebench import _smoke_config

    return _smoke_config(resolve_device(device))


# --- multi-tenant trace ------------------------------------------------------


@dataclasses.dataclass
class TenantTraffic:
    spec: TenantSpec
    requests: int
    rate_rps: float
    prompt_lens: List[int]
    output_lens: List[int]
    sessions: int = 0  # 0 = affinity by prompt-prefix digest
    # The tenant's requests share one system prompt: the first
    # shared_prefix_len tokens of every prompt are a per-tenant
    # constant (drawn once from the tenant's rng). The router's prefix
    # digest then matches across the tenant's traffic and the engines
    # share the prefix pages copy-on-write; the headline records the
    # fleet-level saving as fabric_prefix_pages_saved.
    shared_prefix_len: int = 0


def make_fabric_trace(seed: int, traffic: List[TenantTraffic], vocab: int):
    """Seeded merged trace: per-tenant Poisson arrivals, prompt/output
    mixes, optional session ids and a per-tenant shared system-prompt
    prefix. Returns arrival-sorted ``(arrival_s, tenant, Request,
    session)`` tuples — the contract the smoke pins as deterministic
    before spending minutes replaying it."""
    out = []
    for ti, tt in enumerate(traffic):
        rng = np.random.default_rng((seed, ti))
        shared = (
            rng.integers(
                1, vocab, tt.shared_prefix_len
            ).astype(np.int32)
            if tt.shared_prefix_len else None
        )
        arrivals = np.cumsum(
            rng.exponential(1.0 / tt.rate_rps, tt.requests)
        )
        for i in range(tt.requests):
            plen = int(rng.choice(tt.prompt_lens))
            olen = int(rng.choice(tt.output_lens))
            session = (
                f"{tt.spec.name}-s{int(rng.integers(tt.sessions))}"
                if tt.sessions else None
            )
            prompt = rng.integers(1, vocab, plen).astype(np.int32)
            if shared is not None and plen > len(shared):
                prompt[: len(shared)] = shared
            out.append((
                float(arrivals[i]),
                tt.spec.name,
                Request(
                    rid=f"{tt.spec.name}-{i:05d}",
                    prompt=prompt,
                    max_new_tokens=olen,
                ),
                session,
            ))
    out.sort(key=lambda x: (x[0], x[2].rid))
    return out


# --- warm-up -----------------------------------------------------------------


def warm_engine(eng: Engine) -> None:
    """Run one request per prefill bucket (plus the decode chunk they
    share) through ``eng`` and drop the completions: its first steps
    build the kernels, warm cuBLAS and touch its pools outside any
    measurement, and a replica warmed this way before ``Replica.start``
    cannot trip the stall watchdog on its first step."""
    ec = eng.ec
    cap = ec.max_pages_per_seq * ec.page_size - (2 * ec.scan_chunk + 1)
    buckets = set()
    b = 1
    while b < ec.prefill_chunk:
        buckets.add(b)
        b *= 2
    buckets.add(ec.prefill_chunk)
    eng.run([
        Request(
            rid=f"warm{i}", prompt=np.ones(bl, np.int32),
            max_new_tokens=ec.scan_chunk + 1,
        )
        for i, bl in enumerate(sorted(x for x in buckets if x <= cap))
    ])
    eng.completed.clear()


def warm_jit(config, params, ec: EngineConfig, device=None) -> None:
    """Warm a throwaway engine of ``ec``'s shape (:func:`warm_engine`)
    before a phase builds its fleet, so the kernel build and the first
    cuBLAS calls of the process land outside every measurement."""
    warm_engine(Engine(config, params, ec, device=device))


# --- the fabric harness ------------------------------------------------------


class Fabric:
    """Claim layer + router + claim-driven autoscaler + N engine
    replicas, one process.

    ``claim_layer`` is an object with ``claims`` (the client the
    autoscaler calls: ``create``, ``try_get``, ``delete``), ``start()``
    and ``stop()``; None means a
    :class:`~tpu_dra_torch.serving.claims.ClaimStore` granting claims on
    ``device``. ``nodes`` sizes the fleet of a layer the caller builds
    (a ClaimStore has one card). Every replica shares one weight tree
    on ``device``."""

    def __init__(
        self,
        nodes: int,
        tenants: List[TenantSpec],
        config,
        params,
        engine_config: EngineConfig,
        router_config: RouterConfig,
        autoscaler_config: AutoscalerConfig,
        shape: str = "1x1x1",
        claim_layer=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.metrics = Metrics()
        self.claim_layer = (
            claim_layer if claim_layer is not None
            else ClaimStore(device=_device_name(self.device))
        )
        self.claim_layer.start()
        self.claims = self.claim_layer.claims
        self.config = config
        self.params = as_tree(params, self.device)
        self.engine_config = engine_config
        self.shape = shape
        self.router = Router(
            tenants, [], router_config, metrics=self.metrics
        )
        self.autoscaler = ClaimAutoscaler(
            self.router, self.claims,
            make_claim=self._make_claim,
            make_replica=self._make_replica,
            config=autoscaler_config,
            metrics=self.metrics,
        )

    def _make_claim(self, name: str) -> dict:
        claim = make_claim(0, self.shape)
        claim["metadata"] = {"name": name, "namespace": NS}
        return claim

    def _engine(self) -> Engine:
        """A replica's engine, warmed (:func:`warm_engine`)."""
        engine = Engine(self.config, self.params, self.engine_config,
                        device=self.device)
        warm_engine(engine)
        return engine

    def _make_replica(self, claim: dict) -> Replica:
        rep = Replica(
            claim["metadata"]["name"], self._engine(),
            claim_name=claim["metadata"]["name"], claim=claim,
            metrics=self.metrics,
        )
        rep.start()
        return rep

    def scale_to(self, n: int, timeout: float = 60.0) -> None:
        """Bootstrap the initial replica set through the SAME
        claim-create → claim-allocated → bind path scale-up uses."""
        deadline = time.monotonic() + timeout
        while len(self.router.live_replicas()) < n:
            if self.autoscaler._pending_claim is None:
                self.autoscaler._begin_scale_up(time.monotonic())
            self.autoscaler._tick_pending_alloc()
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"bootstrap to {n} replicas timed out at "
                    f"{len(self.router.live_replicas())}"
                )
            time.sleep(0.002)
        # Bootstrapping is provisioning, not a load decision: the
        # cooldown/flap bookkeeping AND the scale-up record start
        # clean — reaction times and events describe load-driven
        # actions only.
        self.autoscaler._last_action = None
        self.autoscaler._last_action_t = -1e18
        self.autoscaler.scaleups = 0
        self.autoscaler.reaction_s = []
        self.autoscaler.events = []

    def drive(
        self,
        trace,
        autoscale: bool = False,
        timeout: float = 600.0,
        extra_tick: Optional[Callable[[], None]] = None,
    ) -> dict:
        """Replay the trace open-loop (arrivals on the wall clock) on
        the control thread: submit due arrivals, poll the router, tick
        the autoscaler, until drained. ``extra_tick`` (optional) runs
        once per loop pass on the SAME control thread (a chaos schedule
        or a repacker's tick), per the router's threading contract."""
        i = 0
        submitted = 0
        rejected = 0
        t0 = time.monotonic()
        while True:
            now = time.monotonic() - t0
            while i < len(trace) and trace[i][0] <= now:
                _, tenant, req, session = trace[i]
                if self.router.submit(tenant, req, session=session):
                    submitted += 1
                else:
                    rejected += 1
                i += 1
            # A replica death does not raise out of the drive loop:
            # poll()'s reaper classifies it, the dispatch journal
            # re-queues its in-flight sequences onto survivors, and the
            # autoscaler (when ticking) re-binds or replaces the claim.
            moved = self.router.poll()
            if autoscale:
                self.autoscaler.tick()
            if extra_tick is not None:
                extra_tick()
            scaling = (
                self.autoscaler._pending_claim is not None
                or self.autoscaler._draining is not None
                or (autoscale and (
                    self.autoscaler._replace_owed > 0
                    or bool(self.router.dead_replicas)
                ))
            )
            if i >= len(trace) and not self.router.busy and not scaling:
                break
            if time.monotonic() - t0 > timeout:
                raise RuntimeError(
                    f"fabric drive timed out: {self.router.in_system()} "
                    f"sequences still in system"
                )
            if not moved:
                time.sleep(0.0005)
        return {
            "submitted": submitted,
            "rejected": rejected,
            "wall_s": round(time.monotonic() - t0, 3),
        }

    def stop(self) -> None:
        for rep in list(self.router.replicas):
            rep.stop()
        # Dead replicas the autoscaler never collected (autoscale=False
        # drives) still own threads; join them bounded.
        for rep in list(self.router.dead_replicas):
            rep.stop(timeout=2.0)
        self.claim_layer.stop()

    # --- reporting ---

    def ttft_quantiles(self, tenant: Optional[str] = None) -> dict:
        vals = sorted(
            c.ttft_s * 1000.0
            for c in self.router.completions.values()
            if tenant is None or c.tenant == tenant
        )
        return {
            "n": len(vals),
            "p50_ms": round(_pct(vals, 0.5), 2),
            "p99_ms": round(_pct(vals, 0.99), 2),
            "mean_ms": round(statistics.mean(vals), 2) if vals else 0.0,
        }


def _layer(make_claim_layer, nodes):
    """The claim layer a phase's Fabric runs on: ``make_claim_layer``
    (a callable of ``nodes``) when given, else None (a ClaimStore)."""
    return make_claim_layer(nodes) if make_claim_layer is not None else None


def _watchdog(stall_deadline_seconds) -> dict:
    """RouterConfig keywords for a phase's stuck-step watchdog: None
    keeps the Router's default. A replica thread's step on the card can
    outlast the default at Llama-3-8B widths, where two replica threads
    and the control loop share one interpreter."""
    if stall_deadline_seconds is None:
        return {}
    return {"stall_deadline_seconds": stall_deadline_seconds}


# --- phases ------------------------------------------------------------------


def _engine_config(slots: int, max_prompt: int, max_out: int) -> EngineConfig:
    page, chunk = 8, 4
    mpp = -(-(max_prompt + max_out + chunk) // page)
    return EngineConfig(
        page_size=page, max_slots=slots, max_pages_per_seq=mpp,
        scan_chunk=chunk, prefill_chunk=16,
    )


def run_headline(
    config, params, nodes, replicas, traffic, seed, cap,
    slots, timeout, device=None, make_claim_layer=None,
    stall_deadline_seconds=None,
) -> dict:
    tenants = [t.spec for t in traffic]
    max_p = max(max(t.prompt_lens) for t in traffic)
    max_o = max(max(t.output_lens) for t in traffic)
    ec = _engine_config(slots, max_p, max_o)
    warm_jit(config, params, ec, device)
    fab = Fabric(
        nodes, tenants, config, params, ec,
        RouterConfig(
            backlog_cap_tokens=cap, max_inflight_per_replica=slots,
            **_watchdog(stall_deadline_seconds),
        ),
        AutoscalerConfig(
            min_replicas=replicas, max_replicas=replicas,
        ),
        claim_layer=_layer(make_claim_layer, nodes), device=device,
    )
    try:
        fab.scale_to(replicas)
        trace = make_fabric_trace(seed, traffic, config.vocab_size)
        res = fab.drive(trace, timeout=timeout)
        done = fab.router.completions
        total_served = sum(len(c.tokens) for c in done.values())
        per_tenant = {
            t.spec.name: fab.ttft_quantiles(t.spec.name)
            for t in traffic
        }
        shares = {
            name: round(st["served_tokens"] / max(total_served, 1), 4)
            for name, st in fab.router.tenant_stats().items()
        }
        hits, misses = fab.router.affinity_hits, fab.router.affinity_misses
        # Fleet-level copy-on-write prefix sharing: high-water of page
        # allocations the engines avoided by incref'ing shared prefix
        # pages, summed over the replica fleet — the router's prefix
        # grouping measured as MEMORY, not just hit-rate.
        prefix_saved = sum(
            int(getattr(rep.engine, "prefix_saved_hw", 0))
            for rep in fab.router.replicas
        )
        out = {
            **res,
            "prefix_pages_saved": prefix_saved,
            "replicas": len(fab.router.live_replicas()),
            "completed": len(done),
            "ttft": fab.ttft_quantiles(),
            "per_tenant_ttft": per_tenant,
            "tenant_token_shares": shares,
            "peak_concurrent": fab.router.peak_concurrent,
            "wfq_max_lag_tokens": round(fab.router.max_lag_tokens, 1),
            "affinity_hit_rate": round(
                hits / max(hits + misses, 1), 4
            ),
        }
        assert res["submitted"] == len(done), (
            f"lost sequences: {res['submitted']} admitted, "
            f"{len(done)} completed"
        )
        return out
    finally:
        fab.stop()


def run_fairness_pair(
    config, params, nodes, replicas, seed, slots, timeout,
    device=None, make_claim_layer=None,
) -> dict:
    """The identical quiet trace, hot tenant absent vs present."""
    gold = TenantTraffic(
        TenantSpec("gold", INTERACTIVE, weight=3.0),
        requests=12, rate_rps=15.0,
        prompt_lens=[6, 10], output_lens=[4, 8], sessions=4,
    )
    silver = TenantTraffic(
        TenantSpec("silver", STANDARD, weight=1.0),
        requests=8, rate_rps=10.0,
        prompt_lens=[8], output_lens=[6], sessions=2,
    )
    hot = TenantTraffic(
        TenantSpec("bulk", BATCH, weight=1.0),
        requests=60, rate_rps=2000.0,  # a t~0 flood
        prompt_lens=[8], output_lens=[16],
    )
    out = {}
    for label, traffic in (
        ("baseline", [gold, silver]),
        ("hot", [gold, silver, hot]),
    ):
        res = run_headline(
            config, params, nodes, replicas, traffic, seed,
            cap=1e9, slots=slots, timeout=timeout, device=device,
            make_claim_layer=make_claim_layer,
        )
        out[label] = res
        _note(
            f"fairness[{label}]: gold p99 "
            f"{res['per_tenant_ttft']['gold']['p99_ms']} ms, overall "
            f"p99 {res['ttft']['p99_ms']} ms, wall {res['wall_s']}s"
        )
    base = out["baseline"]["per_tenant_ttft"]["gold"]["p99_ms"]
    hot_p99 = out["hot"]["per_tenant_ttft"]["gold"]["p99_ms"]
    out["quiet_baseline_p99_ms"] = base
    out["quiet_p99_ms"] = hot_p99
    out["quiet_p99_x"] = round(hot_p99 / max(base, 1e-9), 3)
    # The structural contrast: the flooding tenant's own p99 carries
    # its backlog; the quiet tenant's must not (WFQ isolation).
    out["hot_tenant_p99_ms"] = (
        out["hot"]["per_tenant_ttft"]["bulk"]["p99_ms"]
    )
    return out


def run_autoscale_drill(config, params, nodes, seed, timeout,
                        device=None, make_claim_layer=None) -> dict:
    """Claim-driven scale-up allocated by the claim layer, then a
    scale-down that evacuates mid-generation — lossless and
    token-identical."""
    gold = TenantSpec("gold", INTERACTIVE, weight=1.0)
    slots = 4
    ec = _engine_config(slots, max_prompt=10, max_out=40)
    warm_jit(config, params, ec, device)
    fab = Fabric(
        nodes, [gold], config, params, ec,
        RouterConfig(
            backlog_cap_tokens=1e9, max_inflight_per_replica=slots,
        ),
        AutoscalerConfig(
            min_replicas=1, max_replicas=2,
            target_tokens_per_replica=256.0,
            # down_factor starts at 0 so the post-burst lull cannot
            # scale down INSIDE phase 1 (the drill wants the decision
            # to fire against phase 2's mid-generation longs).
            up_factor=1.25, down_factor=0.0,
            cooldown_seconds=0.3,
        ),
        claim_layer=_layer(make_claim_layer, nodes), device=device,
    )
    rng = np.random.default_rng(seed)
    burst = [
        Request(
            rid=f"burst-{i:03d}",
            prompt=rng.integers(1, config.vocab_size, 8).astype(np.int32),
            max_new_tokens=10,
        )
        for i in range(24)
    ]
    longs = [
        Request(
            rid=f"long-{i:03d}",
            prompt=rng.integers(1, config.vocab_size, 8).astype(np.int32),
            max_new_tokens=40,
        )
        for i in range(6)
    ]
    try:
        fab.scale_to(1)
        # Phase 1: the burst's queued backlog (16 x 18 tokens vs a
        # 256-token target on one replica) demands a second replica.
        trace = [
            (0.0, "gold", r, f"s{i}") for i, r in enumerate(burst)
        ]
        fab.drive(trace, autoscale=True, timeout=timeout)
        assert fab.autoscaler.scaleups >= 1, "burst never scaled up"
        up = [e for e in fab.autoscaler.events if e[0] == "up-ready"]
        assert up and up[0][3]["devices"], (
            "scale-up claim has no packer-placed devices"
        )
        reaction_ms = fab.autoscaler.reaction_s[0] * 1000.0
        # Arm scale-down for phase 2, after the cooldown from the
        # scale-up has fully expired.
        time.sleep(fab.autoscaler.config.cooldown_seconds + 0.05)
        fab.autoscaler.config.down_factor = 0.25
        # Phase 2: a few LONG sequences keep both replicas decoding
        # while the queue is empty — the lull decision drains a victim
        # MID-GENERATION and the survivors resume its sequences.
        trace2 = [
            (0.0, "gold", r, f"t{i}") for i, r in enumerate(longs)
        ]
        fab.drive(trace2, autoscale=True, timeout=timeout)
        assert fab.autoscaler.scaledowns >= 1, "lull never scaled down"
        down = [
            e for e in fab.autoscaler.events if e[0] == "down-complete"
        ][0]
        assert down[3]["engine_empty_at_delete"], (
            "claim deleted before the drain emptied the engine"
        )
        requeued = down[3]["requeued"]
        victim_claim = down[1]
        assert fab.claims.try_get(victim_claim, NS) is None, (
            f"victim claim {victim_claim} still exists"
        )
        # Lossless: every request completed exactly once...
        done = fab.router.completions
        want = {r.rid for r in burst} | {r.rid for r in longs}
        assert set(done) == want, (
            f"lost/invented sequences across the scale cycle: "
            f"{set(done) ^ want}"
        )
        # ...with completions TOKEN-IDENTICAL to an uninterrupted
        # single-engine reference (greedy determinism across replicas).
        ref = Engine(config, params, ec, device=device).run(
            [dataclasses.replace(r) for r in burst + longs]
        )
        mismatch = [
            rid for rid in want
            if not np.array_equal(done[rid].tokens, ref[rid].tokens)
        ]
        assert not mismatch, (
            f"scale-cycle completions diverged from the uninterrupted "
            f"reference on {mismatch}"
        )
        drain_ms = fab.autoscaler.drain_s[0] * 1000.0
        return {
            "scaleups": fab.autoscaler.scaleups,
            "scaledowns": fab.autoscaler.scaledowns,
            "scaleup_reaction_ms": round(reaction_ms, 2),
            "scaledown_drain_ms": round(drain_ms, 2),
            "evacuated_requeued": requeued,
            "flaps": fab.autoscaler.flaps,
            "placed_devices": up[0][3]["devices"],
        }
    finally:
        fab.stop()


# --- entry points ------------------------------------------------------------


def smoke_mix(requests: int, rate: float) -> List[TenantTraffic]:
    """The headline tenant mix: requests split ~27/33/40 across the
    tiers, rates scaled so arrivals outrun service (the in-system
    population climbs while the tiers separate)."""
    return [
        TenantTraffic(
            TenantSpec("gold", INTERACTIVE, weight=4.0),
            requests=int(requests * 0.27), rate_rps=rate * 0.25,
            # One shared 16-token system prompt across the tenant: the
            # router's affinity-prefix digest matches across gold's
            # traffic, the engines share the prefix's pages
            # copy-on-write, and the headline records the fleet saving
            # as fabric_prefix_pages_saved. Prompts run past the prefix
            # so the share point stays page-aligned.
            prompt_lens=[20, 24, 28], output_lens=[2, 4, 6],
            sessions=50, shared_prefix_len=16,
        ),
        TenantTraffic(
            TenantSpec("silver", STANDARD, weight=2.0),
            requests=int(requests * 0.33), rate_rps=rate * 0.31,
            prompt_lens=[4, 8, 12], output_lens=[2, 4, 6], sessions=50,
        ),
        TenantTraffic(
            TenantSpec("bulk", BATCH, weight=1.0),
            requests=requests - int(requests * 0.27)
            - int(requests * 0.33),
            rate_rps=rate * 0.44,
            prompt_lens=[4, 8, 12], output_lens=[2, 4, 6],
        ),
    ]


def run(
    nodes: int,
    replicas: int,
    requests: int,
    rate: float,
    seed: int,
    cap: float,
    slots: int,
    smoke: bool = False,
    timeout: float = 900.0,
    device=None,
    make_claim_layer=None,
) -> dict:
    config, params = _model(device)

    # Trace determinism: the seeded multi-tenant trace is the contract
    # future rounds replay; pin it before spending minutes.
    probe = [TenantTraffic(
        TenantSpec("probe"), requests=32, rate_rps=100.0,
        prompt_lens=[4, 8], output_lens=[2, 4], sessions=3,
    )]
    t1 = make_fabric_trace(seed, probe, config.vocab_size)
    t2 = make_fabric_trace(seed, probe, config.vocab_size)
    assert len(t1) == len(t2) and all(
        a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
        and np.array_equal(a[2].prompt, b[2].prompt)
        and a[2].max_new_tokens == b[2].max_new_tokens
        for a, b in zip(t1, t2)
    ), "fabric trace is not deterministic for a fixed seed"

    mix = smoke_mix(requests, rate)
    _note(
        f"headline: {nodes} nodes, {replicas} replicas, "
        f"{requests} requests at ~{rate:g}/s aggregate"
    )
    headline = run_headline(
        config, params, nodes, replicas, mix, seed, cap, slots, timeout,
        device=device, make_claim_layer=make_claim_layer,
    )
    _note(
        f"headline: ttft p50 {headline['ttft']['p50_ms']} ms p99 "
        f"{headline['ttft']['p99_ms']} ms, peak concurrent "
        f"{headline['peak_concurrent']}, rejected "
        f"{headline['rejected']}, wall {headline['wall_s']}s"
    )

    fairness = run_fairness_pair(
        config, params, nodes=min(nodes, 8), replicas=2, seed=seed,
        slots=4, timeout=timeout, device=device,
        make_claim_layer=make_claim_layer,
    )
    drill = run_autoscale_drill(
        config, params, nodes=min(nodes, 8), seed=seed, timeout=timeout,
        device=device, make_claim_layer=make_claim_layer,
    )
    _note(
        f"autoscale: reaction {drill['scaleup_reaction_ms']} ms, drain "
        f"{drill['scaledown_drain_ms']} ms, requeued "
        f"{drill['evacuated_requeued']} mid-flight"
    )

    report = {
        "fabric_nodes": nodes,
        "fabric_replicas": headline["replicas"],
        "fabric_tenants": len(mix),
        "fabric_requests": headline["submitted"],
        "fabric_rejected": headline["rejected"],
        "fabric_ttft_p50_ms": headline["ttft"]["p50_ms"],
        "fabric_ttft_p99_ms": headline["ttft"]["p99_ms"],
        "fabric_peak_concurrent": headline["peak_concurrent"],
        "fabric_wfq_max_lag_tokens": headline["wfq_max_lag_tokens"],
        "fabric_affinity_hit_rate": headline["affinity_hit_rate"],
        "fabric_prefix_pages_saved": headline["prefix_pages_saved"],
        "fabric_tenant_shares": headline["tenant_token_shares"],
        "fabric_per_tenant_ttft": headline["per_tenant_ttft"],
        "fabric_quiet_p99_ms": fairness["quiet_p99_ms"],
        "fabric_quiet_baseline_p99_ms":
            fairness["quiet_baseline_p99_ms"],
        "fabric_quiet_p99_x": fairness["quiet_p99_x"],
        "fabric_hot_tenant_p99_ms": fairness["hot_tenant_p99_ms"],
        "fabric_scaleup_reaction_ms": drill["scaleup_reaction_ms"],
        "fabric_scaledown_drain_ms": drill["scaledown_drain_ms"],
        "fabric_autoscaler_flaps": drill["flaps"],
        "seed": seed,
    }

    allow_gap = os.environ.get("FABRIC_ALLOW_GAP") == "1"
    allow_scale = os.environ.get("FABRIC_ALLOW_SCALE") == "1"
    for key in (
        "fabric_ttft_p50_ms", "fabric_ttft_p99_ms",
        "fabric_scaleup_reaction_ms",
    ):
        assert report[key] > 0, f"{key} missing/zero"
    # Gate (a): the hot tenant cannot degrade the quiet tenant's p99
    # beyond the pinned bound vs the hot-absent baseline. An absolute
    # floor keeps sub-100ms jitter from tripping the ratio.
    if not allow_gap:
        assert fairness_holds(fairness), (
            f"fairness gate: quiet tenant p99 "
            f"{fairness['quiet_p99_ms']} ms with the hot tenant vs "
            f"{fairness['quiet_baseline_p99_ms']} ms without "
            f"(x{fairness['quiet_p99_x']}) — WFQ is not isolating "
            f"(FABRIC_ALLOW_GAP=1 to bypass on a hostile machine)"
        )
    # Gate (b) ran inside the drill (claim allocation, lossless +
    # token-identical scale-down, drain-before-delete ordering).
    if not smoke and not allow_scale:
        assert report["fabric_replicas"] >= 8, (
            f"full leg wants >= 8 replicas, got "
            f"{report['fabric_replicas']} (FABRIC_ALLOW_SCALE=1 to "
            f"record anyway)"
        )
        assert report["fabric_peak_concurrent"] >= 10000, (
            f"full leg wants >= 10k concurrent in-system sequences, "
            f"peaked at {report['fabric_peak_concurrent']} — raise "
            f"FABRIC_REQUESTS/FABRIC_RATE (FABRIC_ALLOW_SCALE=1 to "
            f"record anyway)"
        )
    if smoke:
        # Gold's shared system prompt must actually share pages on the
        # engines: the router stamps its popular prefix and at least
        # one replica registers + increfs it.
        assert report["fabric_prefix_pages_saved"] >= 1, (
            "fabric_prefix_pages_saved is 0 — the shared gold prefix "
            "never shared a page on any replica (router stamping or "
            "engine registry broke)"
        )
        _note(
            "smoke contract: trace determinism, fairness gate "
            f"(x{fairness['quiet_p99_x']}), claim-allocated scale-up, "
            "lossless token-identical scale-down before claim delete "
            "— all hold"
        )
    return report


# The fairness gate's bounds: the quiet tenant's p99 with the hot tenant
# within FAIRNESS_MAX_X of its hot-absent baseline, or under
# FAIRNESS_FLOOR_MS outright.
FAIRNESS_MAX_X = 3.0
FAIRNESS_FLOOR_MS = 500.0


def fairness_holds(fairness: dict) -> bool:
    return (fairness["quiet_p99_x"] <= FAIRNESS_MAX_X
            or fairness["quiet_p99_ms"] <= FAIRNESS_FLOOR_MS)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("fabricbench", description=__doc__)
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
        nodes = int(env("FABRIC_NODES", "8"))
        replicas = int(env("FABRIC_REPLICAS", "2"))
        requests = int(env("FABRIC_REQUESTS", "60"))
        rate = float(env("FABRIC_RATE", "200"))
        cap = float(env("FABRIC_CAP", "100000"))
        slots = int(env("FABRIC_SLOTS", "4"))
    else:
        nodes = int(env("FABRIC_NODES", "64"))
        replicas = int(env("FABRIC_REPLICAS", "8"))
        requests = int(env("FABRIC_REQUESTS", "15000"))
        rate = float(env("FABRIC_RATE", "3500"))
        cap = float(env("FABRIC_CAP", "500000"))
        slots = int(env("FABRIC_SLOTS", "16"))
    seed = int(env("FABRIC_SEED", "20260804"))
    report = run(
        nodes, replicas, requests, rate, seed, cap, slots,
        smoke=args.smoke, device=device,
    )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
