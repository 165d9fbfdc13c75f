"""Serving-fabric adapter for the elastic repacker.

A copy of ``tpu_dra/serving/repack.py`` over the port's
:class:`~tpu_dra_torch.serving.router.Router` (the port imports nothing
of the JAX package). The repacker (the driver's
``tpu_dra/scheduler/repacker.py``) is a control-plane controller: it
plans and WAL's placement moves but knows nothing about engines. This
module is the serving half of a tenant-transparent migration — the
engine's evacuation driven through the repack protocol:

- **drain**: quiesce the victim replica (marked ``migrating`` so the
  autoscaler never picks it as a scale-down victim mid-move) and start
  the engine-thread evacuation handshake (``begin_evacuate`` →
  ``evac_done``);
- **finish_drain**: splice the evacuated sequences back into the
  router's WFQ at their tenants' queue FRONT
  (``Router.requeue_evacuated``) — they re-prefill ``prompt + emitted``
  on a surviving replica and, under greedy decoding, complete
  token-identical to an uninterrupted run;
- **rebind**: once the claim is committed at its new placement, bind a
  fresh replica to it and retire the drained one;
- **abort**: roll back — requeue anything drained, un-quiesce, clear
  the migrating mark; the tenant keeps serving on the old placement.

:class:`ServingAdapter` is the port's copy of the repacker's protocol:
five methods with no-op defaults, every one taking the claim key
``namespace/name``.

Threading: every method runs on the fabric's CONTROL thread (the same
thread that drives ``Router.poll`` and the autoscaler) — the
repacker's ``tick()`` is called from that thread when embedded in a
fabric, as the ``# thread: control`` annotations below state.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Set

from tpu_dra_torch.serving.router import Replica, Router


class ServingAdapter:
    """How the repacker talks to whatever serves the claim's tenant.
    The default is a no-op for claims with no live serving tier:
    migration is placement-only. All methods take the claim key
    ``namespace/name``; every implementation must tolerate a key it has
    never seen (recovery aborts plans for claims whose replica died
    with the previous leader)."""

    def begin_drain(self, key: str) -> None:
        """Start draining the engine behind ``key`` (non-blocking)."""

    def drain_done(self, key: str) -> bool:
        return True

    def finish_drain(self, key: str) -> int:
        """Hand the drained sequences back to the routing tier; returns
        how many were requeued (the lossless-accounting probe)."""
        return 0

    def rebind(self, key: str, claim: dict) -> None:
        """The claim is committed at its new placement: bind a fresh
        engine to it and resume dispatch."""

    def abort(self, key: str) -> None:
        """Roll back: resume the tenant on its OLD placement (requeue
        anything drained, un-quiesce)."""


class FabricRepackAdapter(ServingAdapter):
    """``make_replica(claim) -> Replica`` binds a STARTED replica to a
    committed claim (the same callback the autoscaler uses)."""

    def __init__(
        self,
        router: Router,
        make_replica: Callable[[dict], Replica],
        clock=time.monotonic,
    ):
        self.router = router
        self.make_replica = make_replica
        self.clock = clock
        self._draining: Set[str] = set()
        self.rebinds = 0
        self.aborts = 0

    # --- lookup ---

    @staticmethod
    def _claim_name(key: str) -> str:
        return key.split("/", 1)[-1]

    def _replica(self, key: str) -> Optional[Replica]:
        name = self._claim_name(key)
        for rep in self.router.replicas:
            if rep.claim_name == name:
                return rep
        return None

    # --- the repacker protocol ---

    def begin_drain(self, key: str) -> None:  # thread: control
        rep = self._replica(key)
        if rep is None:
            return  # no live tenant behind this claim: placement-only
        rep.migrating = True
        rep.quiesced = True  # control-thread-only by the router's threading contract; the repacker tick runs on it
        rep.begin_evacuate()
        self._draining.add(key)

    def drain_done(self, key: str) -> bool:  # thread: control
        rep = self._replica(key)
        return rep is None or rep.evac_done

    def finish_drain(self, key: str) -> int:  # thread: control
        rep = self._replica(key)
        if rep is None or key not in self._draining:
            return 0
        self._draining.discard(key)
        return self.router.requeue_evacuated(rep)

    def rebind(self, key: str, claim: dict) -> None:  # thread: control
        old = self._replica(key)
        new = self.make_replica(claim)
        new.claim_name = claim["metadata"]["name"]
        new.claim = claim
        self.router.add_replica(new)
        if old is not None and old is not new:
            self.router.remove_replica(old)
            old.stop()
        self.rebinds += 1

    def abort(self, key: str) -> None:  # thread: control
        rep = self._replica(key)
        if rep is None:
            return
        if key in self._draining:
            # The engine thread may still be mid-evacuate: wait for the
            # handshake fence, then splice the drained work back. Abort
            # is rare (lease loss, drain timeout) — a bounded wait on
            # the control thread beats losing sequences.
            deadline = self.clock() + 10.0
            while not rep.evac_done and self.clock() < deadline:
                time.sleep(0.005)
            self._draining.discard(key)
            if rep.evac_done:
                self.router.requeue_evacuated(rep)
        rep.quiesced = False  # control-thread-only, same contract as begin_drain
        rep.migrating = False
        self.aborts += 1

    # --- the utilization signal (MISO: idle claims move first) ---

    def utilization(self) -> Dict[str, float]:  # thread: control
        """Per-claim occupancy in [0, 1]: the replica's in-flight share
        of its dispatch cap. The repacker takes this callable directly
        as its ``utilization`` signal when embedded in a fabric."""
        cap = max(1, self.router.config.max_inflight_per_replica)
        out: Dict[str, float] = {}
        for rep in self.router.replicas:
            if not rep.claim_name or rep.claim is None:
                continue
            ns = rep.claim.get("metadata", {}).get("namespace")
            out[f"{ns}/{rep.claim_name}"] = min(
                1.0, len(rep.inflight) / cap
            )
        return out
