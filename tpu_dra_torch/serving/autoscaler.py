"""Claim-driven autoscaling: the replica set IS a set of ResourceClaims.

A copy of ``tpu_dra/serving/autoscaler.py`` over the port's
:class:`~tpu_dra_torch.serving.router.Router` (the port imports nothing
of the JAX package). ``claims`` is duck-typed: the class calls only its
``try_get``, ``create`` and ``delete``.

The autoscaler never picks a node and never places anything — it scales
the serving fabric by creating and deleting ResourceClaims and lets the
scheduler's fragmentation-aware packer place them, exactly like
any other tenant of the control plane:

- **scale-up**: create one claim (the caller's ``make_claim`` template
  names the sub-slice shape), wait for ``status.allocation`` to appear
  (the batch solve places it), then ``make_replica(claim)`` binds a new
  engine to the allocated device and the router starts dispatching to
  it. Decision → first-dispatchable is recorded as the **reaction
  time** (``fabric_autoscaler_reaction_seconds``).
- **scale-down**: quiesce the least-loaded replica, drive the engine's
  backpressure drain through :meth:`Engine.evacuate` (host checkpoint,
  pages freed), splice the evacuated sequences back into the router's
  WFQ for lossless resume on the surviving replicas, and ONLY THEN
  delete the ResourceClaim — the tenant-transparent eviction ordering
  the fabric smoke gates (zero lost or duplicated sequences,
  token-identical completions under greedy decoding).

Decisions are load-derived (MISO, arXiv 2207.11428): the signal is
the router's queued token backlog per live replica vs a target, with a
hysteresis band (``up_factor`` / ``down_factor``) and a cooldown
between actions. A desired REVERSAL inside the cooldown window is the
flapping signal — counted as ``fabric_autoscaler_flaps_total`` (and
suppressed); the doctor WARNs on it with the widen-the-band
remediation.

``tick()`` is a non-blocking state machine (steady → waiting-alloc →
steady, steady → draining → steady) advanced from the fabric's control
thread, so tests drive every transition deterministically.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from tpu_dra_torch.infra import lockdep
from tpu_dra_torch.serving.router import Replica, Router


@dataclasses.dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    # Queued-backlog target per live replica, in tokens. Above
    # target * up_factor per replica -> scale up; below
    # target * down_factor -> scale down. The gap between the two
    # factors is the hysteresis band that keeps a steady load from
    # oscillating the replica count.
    target_tokens_per_replica: float = 4096.0
    up_factor: float = 1.25
    down_factor: float = 0.25
    cooldown_seconds: float = 3.0
    # A claim the packer cannot place within this window is deleted and
    # the scale-up abandoned until the next pressure signal (capacity
    # may have been freed meanwhile).
    alloc_timeout_seconds: float = 30.0
    namespace: str = "fabric"
    # --- crash tolerance ---
    # How often the claim-vanished detector polls the claim store (a
    # deleted/lost claim means the replica's device lease is gone: the
    # router must reclaim its sequences even though the thread lives).
    claim_check_seconds: float = 1.0
    # Join timeout when collecting a dead replica's thread: bounded so
    # a wedged thread cannot stall the control loop (the stop-timeout
    # path logs + counts it and leaves the corpse dead).
    dead_join_timeout_seconds: float = 1.0
    # --- disaggregated prefill/decode ---
    # When True the fleet runs phase-role pools: the load signal splits
    # into queued PREFILL tokens per prefill replica vs queued DECODE
    # tokens per decode replica, scale-up creates a claim for the
    # needier phase (``make_replica`` is then called as
    # ``make_replica(claim, role)``), scale-down retires from the
    # emptier pool without ever dropping a phase to zero replicas, and
    # a dead replica's replacement inherits its role.
    disaggregated: bool = False


class ClaimAutoscaler:
    """``make_claim(name) -> dict`` builds the ResourceClaim body
    (shape/class selectors are the caller's policy);
    ``make_replica(claim) -> Replica`` binds a started replica to an
    ALLOCATED claim (the engine is cheap when replicas share one weight
    tree)."""

    def __init__(
        self,
        router: Router,
        claims,  # ResourceClient bound to RESOURCE_CLAIMS
        make_claim: Callable[[str], dict],
        make_replica: Callable[[dict], Replica],
        config: Optional[AutoscalerConfig] = None,
        metrics=None,
        clock=time.monotonic,
    ):
        self.router = router
        self.claims = claims
        self.make_claim = make_claim
        self.make_replica = make_replica
        self.config = config or AutoscalerConfig()
        self.metrics = metrics
        self.clock = clock
        self.flaps = 0
        self.scaleups = 0
        self.scaledowns = 0
        self.rebinds = 0
        self.quarantined = 0
        self.replaced = 0
        self.reaction_s: List[float] = []
        self.drain_s: List[float] = []
        # Event log for tests and the bench: (kind, claim_name, t, info).
        self.events: List[tuple] = []
        self._serial = 0
        self._last_action: Optional[str] = None  # "up" | "down"
        self._last_action_t = -1e18
        # One flap per reversal EPISODE: tick() runs at control-loop
        # frequency (sub-ms), so counting every suppressed tick would
        # make the flap metric loop-frequency-dependent. The latch
        # clears when the reversal desire goes away or an action runs.
        self._flap_latched = False
        # In-flight transitions (at most one of each at a time).
        self._pending_claim: Optional[dict] = None
        self._pending_t0 = 0.0
        self._pending_is_replace = False
        self._draining: Optional[Replica] = None
        self._drain_t0 = 0.0
        # Crash tolerance: replacements owed to quarantined
        # or claim-less dead replicas (drained one at a time through
        # the single pending-claim slot), and the claim-vanished
        # detector's last poll time.
        self._replace_owed = 0
        self._last_claim_check = -1e18
        # Disaggregation: the role the in-flight scale-up /
        # replacement claim will bind as, and the roles owed by
        # quarantined or claim-less dead replicas (FIFO next to
        # _replace_owed; empty when not disaggregated).
        self._pending_role: Optional[str] = None
        self._replace_roles: List[str] = []

    # --- the control-thread entry point ---

    def tick(self) -> None:  # thread: control
        # Keyed on the ROUTER: the contract is "ticks on the same
        # thread that drives Router.poll", not merely self-consistency.
        lockdep.single_owner(self.router, "control")
        self._check_claims()
        self._tick_dead()
        if self._pending_claim is not None:
            self._tick_pending_alloc()
            return
        if self._draining is not None:
            self._tick_draining()
            return
        if self._replace_owed > 0:
            # Replacement is a repair, not a load decision: it bypasses
            # the cooldown/hysteresis band (the fleet is OWED this
            # capacity) but still flows through the one-at-a-time
            # pending-claim slot the packer places.
            self._begin_replace(self.clock())
            return
        self._maybe_scale()

    # --- crash tolerance ---

    def _check_claims(self) -> None:
        """Claim-vanished detection: a live replica whose ResourceClaim
        no longer exists has lost its device lease — the router must
        reclaim its journaled sequences even though the thread is
        healthy."""
        now = self.clock()
        if now - self._last_claim_check < self.config.claim_check_seconds:
            return
        self._last_claim_check = now
        for rep in list(self.router.replicas):
            if not rep.claim_name or rep.dead or rep is self._draining:
                continue
            cur = self.claims.try_get(
                rep.claim_name, self.config.namespace
            )
            if cur is None:
                self.router.mark_dead(rep, "claim-vanished")

    def _tick_dead(self) -> None:
        """Collect replicas the router declared dead: join the thread
        (bounded), then either hot RE-BIND a fresh replica onto the
        still-allocated claim, or — when the claim's circuit is open
        (crash-looping) or the claim is gone — QUARANTINE: delete the
        claim and owe a replacement through the normal claim path."""
        for rep in self.router.take_dead():
            now = self.clock()
            rep.stop(timeout=self.config.dead_join_timeout_seconds)
            key = rep.claim_name or rep.name
            claim = (
                self.claims.try_get(
                    rep.claim_name, self.config.namespace
                )
                if rep.claim_name else None
            )
            alloc = ((claim or {}).get("status") or {}).get("allocation")
            if self.router.breaker.is_open(key):
                # Crash loop: re-binding would feed the loop. Replace
                # the claim — fresh name, fresh placement, closed
                # circuit.
                if rep.claim_name and claim is not None:
                    try:
                        self.claims.delete(
                            rep.claim_name, self.config.namespace
                        )
                    except Exception:  # noqa: BLE001 — already gone
                        pass
                self.quarantined += 1
                if self.metrics is not None:
                    self.metrics.inc("fabric_quarantined_total")
                self.events.append(("quarantine", rep.claim_name, now, {
                    "reason": rep.death_reason,
                }))
                self._replace_owed += 1
                if self.config.disaggregated:
                    self._replace_roles.append(rep.role)
            elif alloc:
                # First (or rare) death with the claim still allocated:
                # hot re-bind a fresh engine onto the same devices —
                # with the dead replica's phase role: the pools' sizes
                # are the autoscaler's decision, not the crash's.
                rep2 = (
                    self.make_replica(claim, rep.role)
                    if self.config.disaggregated
                    else self.make_replica(claim)
                )
                rep2.claim_name = rep.claim_name
                rep2.claim = claim
                self.router.add_replica(rep2)
                self.rebinds += 1
                if self.metrics is not None:
                    self.metrics.inc("fabric_rebinds_total")
                self.events.append(("rebind", rep.claim_name, now, {
                    "reason": rep.death_reason,
                }))
            else:
                # Claim vanished (or claim-less bootstrap replica):
                # nothing to re-bind onto — owe a replacement.
                self.events.append(
                    ("dead-claim-gone", rep.claim_name, now, {
                        "reason": rep.death_reason,
                    })
                )
                self._replace_owed += 1
                if self.config.disaggregated:
                    self._replace_roles.append(rep.role)

    def _begin_replace(self, now: float) -> None:
        self._replace_owed -= 1
        self._pending_role = (
            self._replace_roles.pop(0) if self._replace_roles else None
        )
        self._serial += 1
        name = f"fabric-replica-{self._serial:04d}"
        claim = self.make_claim(name)
        claim["metadata"]["name"] = name
        claim["metadata"]["namespace"] = self.config.namespace
        self.claims.create(claim)
        self._pending_claim = claim
        self._pending_t0 = now
        self._pending_is_replace = True
        self.replaced += 1
        if self.metrics is not None:
            self.metrics.inc("fabric_claims_replaced_total")
        self.events.append(("replace-requested", name, now, {}))

    # --- decision ---

    def _load_per_replica(self) -> float:
        n = max(1, len(self.router.live_replicas()))
        return self.router.queued_tokens() / n

    def _gate_cooldown(self, want: str, now: float) -> bool:
        """Shared cooldown/hysteresis gate: False suppresses the
        action. A desired REVERSAL inside the cooldown window is the
        flapping signal, counted once per episode."""
        c = self.config
        if now - self._last_action_t < c.cooldown_seconds:
            if self._last_action is not None and want != self._last_action:
                # Up+down inside one cooldown window: the hysteresis
                # band is too tight for this load's variance. Count it
                # ONCE per episode (the doctor's flapping WARN) and
                # suppress the action.
                if not self._flap_latched:
                    self._flap_latched = True
                    self.flaps += 1
                    if self.metrics is not None:
                        self.metrics.inc("fabric_autoscaler_flaps_total")
            else:
                self._flap_latched = False
            return False
        self._flap_latched = False
        return True

    def _maybe_scale(self) -> None:
        if self.config.disaggregated:
            return self._maybe_scale_disagg()
        c = self.config
        n = len(self.router.live_replicas())
        load = self._load_per_replica()
        want: Optional[str] = None
        if load > c.target_tokens_per_replica * c.up_factor:
            if n < c.max_replicas:
                want = "up"
        elif load < c.target_tokens_per_replica * c.down_factor:
            if n > c.min_replicas:
                want = "down"
        if want is None:
            self._flap_latched = False
            return
        now = self.clock()
        if not self._gate_cooldown(want, now):
            return
        if want == "up":
            self._begin_scale_up(now)
        else:
            self._begin_scale_down(now)

    def _maybe_scale_disagg(self) -> None:
        """Per-phase pool sizing: the load signal is queued
        PREFILL tokens per prefill replica vs queued DECODE tokens per
        decode replica — the split of ``queued_tokens()`` the router
        maintains. The needier phase scales up; scale-down retires from
        the emptier pool, never dropping a phase below one replica (a
        phaseless fleet would deadlock its half of the pipeline into
        the re-prefill fallback)."""
        c = self.config
        live = self.router.live_replicas()
        n = len(live)
        n_p = sum(1 for r in live if r.role == "prefill")
        n_d = sum(1 for r in live if r.role == "decode")
        load_p = self.router.queued_prefill_tokens() / max(1, n_p)
        load_d = self.router.queued_decode_tokens() / max(1, n_d)
        want: Optional[str] = None
        role: Optional[str] = None
        if max(load_p, load_d) > c.target_tokens_per_replica * c.up_factor:
            if n < c.max_replicas:
                want = "up"
                role = "prefill" if load_p >= load_d else "decode"
        elif (
            load_p < c.target_tokens_per_replica * c.down_factor
            and load_d < c.target_tokens_per_replica * c.down_factor
            and n > c.min_replicas
            and (n_p > 1 or n_d > 1)
        ):
            want = "down"
            if n_d <= 1 or (load_p <= load_d and n_p > 1):
                role = "prefill"
            else:
                role = "decode"
        if want is None:
            self._flap_latched = False
            return
        now = self.clock()
        if not self._gate_cooldown(want, now):
            return
        if want == "up":
            self._begin_scale_up(now, role=role)
        else:
            self._begin_scale_down(now, role=role)

    # --- scale-up: create claim -> packer places -> bind replica ---

    def _begin_scale_up(
        self, now: float, role: Optional[str] = None
    ) -> None:
        self._serial += 1
        name = f"fabric-replica-{self._serial:04d}"
        claim = self.make_claim(name)
        claim["metadata"]["name"] = name
        claim["metadata"]["namespace"] = self.config.namespace
        self.claims.create(claim)
        self._pending_claim = claim
        self._pending_t0 = now
        self._pending_is_replace = False
        self._pending_role = role
        self._last_action, self._last_action_t = "up", now
        self.events.append(
            ("up-requested", name, now, {"role": role} if role else {})
        )

    def _tick_pending_alloc(self) -> None:
        name = self._pending_claim["metadata"]["name"]
        now = self.clock()
        cur = self.claims.try_get(name, self.config.namespace)
        alloc = ((cur or {}).get("status") or {}).get("allocation")
        if not alloc:
            if now - self._pending_t0 > self.config.alloc_timeout_seconds:
                # Unschedulable: abandon (delete so the claim does not
                # squat the queue) and re-decide on the next pressure.
                try:
                    self.claims.delete(name, self.config.namespace)
                except Exception:  # noqa: BLE001 — already gone
                    pass
                self.events.append(("up-unplaceable", name, now, {}))
                if self._pending_is_replace:
                    # A replacement is a debt, not an opportunity: an
                    # unplaceable one stays owed and retries on a later
                    # tick (capacity may free meanwhile).
                    self._replace_owed += 1
                    if self._pending_role is not None:
                        self._replace_roles.append(self._pending_role)
                self._pending_claim = None
                self._pending_role = None
            return
        rep = (
            self.make_replica(cur, self._pending_role)
            if self._pending_role is not None
            else self.make_replica(cur)
        )
        self._pending_role = None
        rep.claim_name = name
        rep.claim = cur
        self.router.add_replica(rep)
        self._pending_claim = None
        self.scaleups += 1
        reaction = now - self._pending_t0
        self.reaction_s.append(reaction)
        if self.metrics is not None:
            self.metrics.observe(
                "fabric_autoscaler_reaction_seconds", reaction
            )
            self.metrics.inc("fabric_autoscaler_scaleups_total")
        self.events.append(("up-ready", name, now, {
            "reaction_s": reaction,
            "devices": [
                r["device"] for r in alloc["devices"]["results"]
            ],
        }))

    # --- scale-down: quiesce -> evacuate -> requeue -> DELETE claim ---

    def _victim(self, role: Optional[str] = None) -> Optional[Replica]:
        # A replica mid-repack is NOT a scale-down candidate:
        # the repacker is moving its claim, not retiring it — deleting
        # the claim under the mover would strand the half-move. The
        # replica count still includes it (its claim still serves).
        live = [
            r for r in self.router.live_replicas() if not r.migrating
        ]
        if role is not None:
            live = [r for r in live if r.role == role]
        if len(self.router.live_replicas()) <= self.config.min_replicas:
            return None
        if not live:
            return None
        # Least in-flight work moves the least state; claim-less
        # replicas (bootstrap) are never preferred over claim-backed
        # ones — deleting their "claim" would be a no-op and the
        # measured drill wants the real ordering.
        return min(
            live,
            key=lambda r: (not r.claim_name, len(r.inflight)),
        )

    def _begin_scale_down(
        self, now: float, role: Optional[str] = None
    ) -> None:
        victim = self._victim(role)
        if victim is None:
            return
        victim.quiesced = True
        victim.begin_evacuate()
        self._draining = victim
        self._drain_t0 = now
        self._last_action, self._last_action_t = "down", now
        self.events.append(
            ("down-draining", victim.claim_name, now, {})
        )

    def _tick_draining(self) -> None:
        victim = self._draining
        if not victim.evac_done:
            return
        now = self.clock()
        requeued = self.router.requeue_evacuated(victim)
        engine_empty = not victim.engine.busy
        # THE ordering contract: the ResourceClaim is deleted only
        # after the drain handed every sequence back (pages freed,
        # engine empty) — eviction is tenant-transparent.
        if victim.claim_name:
            try:
                self.claims.delete(
                    victim.claim_name, self.config.namespace
                )
            except Exception:  # noqa: BLE001 — already gone
                pass
        self.router.remove_replica(victim)
        victim.stop(
            timeout=self.router.config.replica_join_timeout_seconds
        )
        self._draining = None
        self.scaledowns += 1
        drain = now - self._drain_t0
        self.drain_s.append(drain)
        if self.metrics is not None:
            self.metrics.inc("fabric_autoscaler_scaledowns_total")
            self.metrics.observe(
                "fabric_autoscaler_drain_seconds", drain
            )
        self.events.append(("down-complete", victim.claim_name, now, {
            "requeued": requeued,
            "drain_s": drain,
            "engine_empty_at_delete": engine_empty,
        }))
