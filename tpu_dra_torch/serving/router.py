"""Multi-tenant router: SLO-class admission + token-WFQ + affinity.

A copy of ``tpu_dra/serving/router.py`` over the port's engine
(``Completion``, ``Evacuated`` and ``Request`` come from
:mod:`tpu_dra_torch.workloads.engine`; the port imports nothing of the
JAX package). Names, defaults, metric names and span names are the JAX
module's: they are the interface the fleet monitor and the doctor read.

The data-plane fairness problem is the ShardedWorkQueue problem one
layer up: many tenants share a fleet of engine replicas, and a hot
tenant flooding requests must not starve everyone else's first-token
latency. The control-plane answer was sharding reconciles by
key; the data-plane answer here is **weighted fair queuing over
tokens** — the router holds the backlog itself (engines only ever see a
bounded number of in-flight sequences), and dispatch order is decided
by per-tenant virtual time, not arrival order:

- every request costs ``prompt_tokens + max_new_tokens`` virtual
  tokens;
- a tenant's request gets a start tag ``S = max(V, tenant.tail)`` and a
  finish tag ``F = S + cost / weight``; dispatch always picks the
  backlogged head with the smallest finish tag, and the fabric-wide
  virtual clock ``V`` advances to the dispatched start tag — classic
  WFQ, so over any busy interval tenant service converges to the weight
  ratio no matter how hot one tenant runs;
- per-tenant **virtual-time lag** (how far past a backlogged tenant's
  head turn the clock has advanced, in weighted tokens) is exported as
  ``fabric_tenant_vtime_lag{tenant=}`` — in a healthy fabric it stays
  bounded by roughly one request cost; sustained growth is the
  starvation signal the doctor WARNs on.

**SLO classes** (latency-tier admission control): each tenant carries a
class (INTERACTIVE / STANDARD / BATCH) whose ``admit_frac`` caps how
full the fabric's token backlog may be before that tier's requests are
REJECTED at the door. Under pressure the batch tier sheds first and
the interactive tier keeps admitting until the hard cap — overload
degrades the deferrable traffic, not the latency tier (MISO's
load-derived placement idea applied to admission).

**Affinity**: a request's affinity key (its session id, else a digest
of its prompt prefix) picks a preferred replica by rendezvous hashing,
so a session's turns — and unrelated requests sharing one system
prompt — land on the engine already holding their KV history (prefix
reuse is a locality property; the engine's copy-on-write sharing then
shares the prefix pages outright). A preferred replica with no
headroom spills to the least-loaded one: affinity is a hint, never a
hot spot.

**Crash tolerance**: replicas are mortal. The control loop
classifies a replica dead on engine-thread death (``Replica.error``),
on a stuck-iteration watchdog (no engine step progress past a
``deadline.Budget`` while work is in flight), or when the autoscaler
reports its claim vanished. Every dispatch is journaled
(:class:`~tpu_dra_torch.serving.faults.DispatchJournal`), so a dead
replica's in-flight sequences are reconstructed WITHOUT the engine's
cooperation and re-dispatched to survivors at their tenants' queue
front — token-identical under greedy, and token-identical under
sampling via the journaled per-request ``(seed, serial)`` schedule.
Containment: re-dispatches carry jittered exponential backoff, a
crash-looping claim's circuit opens
(:class:`~tpu_dra_torch.serving.faults.CircuitBreaker`) so the autoscaler
replaces it instead of hot re-binding, and lost capacity degrades
admission gracefully — the backlog cap scales down by the owed
fraction, so BATCH sheds at the door first (``fabric_shed_total{cls=}``
counts it, ``fabric_degraded`` gauges it for fleetmon).

Threading contract — stated by ``# thread:`` annotations and checked
at run time by :mod:`tpu_dra_torch.infra.lockdep`:
``submit()`` and the lock-guarded gauges are ``# thread: any``;
``poll()`` and everything the autoscaler/repacker call are
``# thread: control`` (one thread assumes the control role per
fabric); ``Replica._loop`` is ``# thread: replica`` — it owns the only
thread that touches its engine's internals (dispatch rides the
engine's append-only ``add_request``).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import logging
import threading
import time
import zlib
from typing import Deque, Dict, List, Optional

import numpy as np

from tpu_dra_torch.infra import deadline, lockdep, trace
from tpu_dra_torch.serving.faults import (
    CircuitBreaker,
    DispatchJournal,
    ReplicaFault,
    redispatch_backoff,
)
from tpu_dra_torch.workloads.engine import Completion, Evacuated, Request

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One latency tier. ``admit_frac`` is the fraction of the router's
    token-backlog cap this tier may still admit into: lower tiers hit
    their admission ceiling first as the fabric fills. ``ttft_target_ms``
    is the tier's advertised objective (recorded next to the measured
    quantiles; the bench compares, the router does not enforce)."""

    name: str
    tier: int  # 0 = most latency-sensitive
    admit_frac: float
    ttft_target_ms: float


INTERACTIVE = SLOClass("interactive", 0, 1.0, 250.0)
STANDARD = SLOClass("standard", 1, 0.85, 1000.0)
BATCH = SLOClass("batch", 2, 0.6, 30000.0)
# The built-in tiers, in tier order — what fleetmon's catalog states
# its per-class TTFT objectives from (fabricbench's SLO mode passes
# these targets in; tools cannot import serving per the layer DAG).
SLO_CLASSES = (INTERACTIVE, STANDARD, BATCH)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    name: str
    slo: SLOClass = STANDARD
    weight: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name}: weight must be > 0")


@dataclasses.dataclass
class RouterConfig:
    # Hard token-backlog cap (queued + in-flight request costs); tier
    # admission ceilings are fractions of it (SLOClass.admit_frac).
    backlog_cap_tokens: float = 262144.0
    # Engines admit/evict between scan chunks on their own; the router
    # additionally bounds how many sequences it hands each replica so
    # the BACKLOG stays in the WFQ (dispatch order keeps meaning) and a
    # drain/evacuation never strands more than this many sequences.
    max_inflight_per_replica: int = 16
    # Prompt tokens digested into the affinity key when the request
    # has no session id (one shared system prompt -> one replica).
    affinity_prefix_tokens: int = 16
    # --- crash tolerance ---
    # Stuck-iteration watchdog: a replica with in-flight work whose
    # engine step-progress counter stands still this long is declared
    # dead (hung device call, wedged thread). deadline.Budget-backed.
    stall_deadline_seconds: float = 5.0
    # Circuit breaker: this many deaths of one claim inside the window
    # opens its circuit — the router stops routing to it and the
    # autoscaler REPLACES the claim instead of hot re-binding.
    breaker_deaths: int = 3
    breaker_window_seconds: float = 30.0
    # Jittered exponential backoff before a dead replica's sequence is
    # re-dispatched (a poisoned request must not hot-loop survivors).
    redispatch_backoff_base_seconds: float = 0.05
    redispatch_backoff_cap_seconds: float = 2.0
    # Replica.stop() join timeout: a wedged engine thread past this is
    # logged + counted (fabric_replica_stop_timeouts_total) and the
    # replica left in the dead state instead of silently blocking the
    # control thread for 30s while pretending it stopped.
    replica_join_timeout_seconds: float = 30.0


@dataclasses.dataclass
class FabricCompletion:
    """One request's end-to-end record, stitched across every replica
    it ran on (evacuations splice transparently)."""

    rid: str
    tenant: str
    tokens: np.ndarray
    t_submit: float  # router clock, at submit()
    t_first_token: float
    t_done: float
    replicas: List[str]  # every replica that served part of it

    @property
    def ttft_s(self) -> float:
        """The fabric SLO: user-request-submitted -> first token."""
        return self.t_first_token - self.t_submit

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


class _FabricReq:
    __slots__ = (
        "rid", "tenant", "prompt", "max_new", "session", "cost",
        "start_tag", "finish_tag", "t_submit", "t_first", "emitted",
        "replicas", "trace_ctx", "t_dispatch", "prefix_key",
        "sample_seed", "sample_serial", "retries", "not_before",
    )

    def __init__(self, rid, tenant, prompt, max_new, session, cost):
        self.rid = rid
        self.tenant = tenant
        self.prompt = prompt
        self.max_new = max_new
        self.session = session
        self.cost = cost
        self.start_tag = 0.0
        self.finish_tag = 0.0
        self.t_submit = 0.0
        self.t_first: Optional[float] = None
        self.emitted = np.zeros(0, np.int32)
        self.replicas: List[str] = []
        # The request's trace identity (None while tracing is off):
        # minted at submit, it is the serving.request.queued span's
        # own ctx; dispatch/prefill/first-token/evacuate spans parent
        # under it (recorded retroactively from the completion stamps).
        self.trace_ctx = trace.new_ctx()
        self.t_dispatch: Optional[float] = None
        # Content digest of the prompt's affinity prefix — the engine's
        # prefix-sharing id, stamped at dispatch only once
        # the prefix has proven popular (>= 2 submissions).
        self.prefix_key: Optional[str] = None
        # Sampling schedule: serial assigned at submit (the
        # router's counter, engine-independent so it survives replica
        # death); seed captured from the first engine dispatched to.
        self.sample_seed: Optional[int] = None
        self.sample_serial: Optional[int] = None
        # Re-dispatch containment: death-recovery retry count and the
        # earliest clock time the next dispatch may run (backoff).
        self.retries = 0
        self.not_before = 0.0

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.emitted)


class _TenantState:
    __slots__ = ("spec", "queue", "tail_tag", "served_tokens", "rejected")

    def __init__(self, spec: TenantSpec):
        self.spec = spec
        self.queue: Deque[_FabricReq] = collections.deque()
        self.tail_tag = 0.0  # finish tag of the newest queued request
        self.served_tokens = 0
        self.rejected = 0


class Replica:
    """One engine replica bound to one ResourceClaim. Owns the ONLY
    thread that steps the engine; the router talks to it through the
    engine's append-only ``add_request``, the completion ``outbox``,
    and the evacuation handshake (``begin_evacuate`` → ``evac_done`` →
    ``take_evacuated``) the autoscaler's scale-down drives."""

    def __init__(self, name: str, engine, claim_name: str = "",
                 claim: Optional[dict] = None, metrics=None,
                 role: str = "both"):
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"replica {name}: role must be prefill/decode/both, "
                f"got {role!r}"
            )
        self.name = name
        self.engine = engine
        self.claim_name = claim_name
        self.claim = claim
        self.metrics = metrics
        # Phase role: "prefill" replicas take prompt
        # dispatches and EXPORT each sequence to the decode pool at
        # prefill completion (live paged-KV migration); "decode"
        # replicas take migrated extents only; "both" is the colocated
        # default — no exports, all dispatches, every pre-existing
        # behavior unchanged.
        self.role = role
        # Set by the router's control loop: exports only run while a
        # live decode-role replica exists to receive them (otherwise a
        # fallback re-prefill would bounce straight back here).
        self.export_enabled = False
        self.quiesced = False  # router stops dispatching; engine drains
        # Mid-repack: the repacker owns this replica's fate;
        # the autoscaler must not pick it as a scale-down victim (the
        # claim is being MOVED, not retired — deleting it would turn a
        # defrag into an outage).
        self.migrating = False
        self.error: Optional[BaseException] = None  # engine-thread death
        # Dead state: set by Router.mark_dead (crash / stall
        # / claim-vanished) or by a stop() join timeout. A dead replica
        # is out of the routing set; its thread may still be wedged.
        self.dead = False
        self.death_reason = ""
        # Watchdog state, control-thread-owned: the engine progress
        # value last seen and the deadline budget it must beat.
        self.last_progress: Optional[int] = None  # thread: control
        self.watchdog: Optional[deadline.Budget] = None  # thread: control
        self._fault: Optional[str] = None  # chaos injection seam
        self.outbox: Deque[Completion] = collections.deque()
        # KV-migration mailboxes. GIL-atomic deque append /
        # popleft is the whole protocol: the engine thread produces
        # exports and import results, the control thread consumes them
        # (and produces the import inbox the engine thread consumes).
        self.migration_outbox: Deque = collections.deque()  # SequenceExtent
        self._import_inbox: Deque = collections.deque()  # (sx, t0)
        self.import_results: Deque = collections.deque()  # (sx, ok, t0)
        self.inflight: Dict[str, _FabricReq] = {}  # thread: control (router dispatch bookkeeping)
        self._evac_request = threading.Event()
        self._evac_done = threading.Event()
        self._evacuated: List[Evacuated] = []
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:  # thread: control
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"replica-{self.name}"
        )
        self._thread.start()

    def signal_stop(self) -> None:  # thread: control
        """Ask the engine thread to exit WITHOUT joining: the control
        loop must not block on a thread that may be wedged (that is the
        exact failure being contained). The autoscaler joins later with
        a bounded timeout via :meth:`stop`."""
        self._stop.set()
        self._wake.set()

    def stop(self, timeout: Optional[float] = None) -> bool:  # thread: control
        """Stop the engine thread; returns True if it actually exited
        within ``timeout`` seconds. A join timeout no longer hangs
        silently: it is logged, counted
        (``fabric_replica_stop_timeouts_total``), and the replica is
        left in the dead state instead of pretending it stopped."""
        if timeout is None:
            timeout = 30.0
        self._stop.set()
        self._wake.set()
        joined = True
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            joined = not self._thread.is_alive()
        if not joined:
            log.warning(
                "replica %s: engine thread did not stop within %.1fs "
                "(wedged); leaving it dead", self.name, timeout,
            )
            self.dead = True
            if not self.death_reason:
                self.death_reason = "stop-timeout"
            if self.metrics is not None:
                self.metrics.inc("fabric_replica_stop_timeouts_total")
        self.engine.close()
        return joined

    def inject_fault(self, kind: str) -> None:  # thread: control
        """Chaos seam: arm a fault the engine thread trips
        before its next step. ``"crash"`` raises :class:`ReplicaFault`
        out of the loop (the hard-death path); ``"stall"`` wedges the
        thread — it stops stepping and produces no progress, exactly
        what the router's stuck-iteration watchdog exists to catch."""
        self._fault = kind  # one-shot flag handoff: single writer arms, the engine thread consumes-and-clears; a GIL-atomic attribute store is the whole protocol
        self._wake.set()

    def submit(self, req: Request) -> None:  # thread: control
        self.engine.add_request(req)
        self._wake.set()

    def submit_extent(self, sx, t0: float) -> None:  # thread: control
        """Hand a migrated sequence's KV extent to this replica's
        engine thread for grafting (control thread side of the import
        handshake). The result — grafted or rejected for capacity —
        comes back through ``import_results``."""
        self._import_inbox.append((sx, t0))  # GIL-atomic deque mailbox: control thread appends, engine thread popleft-drains
        self._wake.set()

    # --- evacuation handshake (autoscaler scale-down) ---

    def begin_evacuate(self) -> None:  # thread: control
        self._evac_done.clear()
        self._evac_request.set()
        self._wake.set()

    @property
    def evac_done(self) -> bool:  # thread: control
        return self._evac_done.is_set()

    def take_evacuated(self) -> List[Evacuated]:  # thread: control
        out, self._evacuated = self._evacuated, []  # handshake-ordered: written by the engine thread BEFORE _evac_done.set(), read by the control thread only AFTER evac_done — the Event is the fence
        return out

    # --- engine thread ---

    def _loop(self) -> None:  # thread: replica (entry: Thread target started by start())
        lockdep.single_owner(self, "replica")
        try:
            while not self._stop.is_set():
                fault = self._fault
                if fault == "crash":
                    self._fault = None  # consume side of the inject_fault one-shot flag handoff
                    raise ReplicaFault(
                        f"chaos: injected crash on replica {self.name}"
                    )
                if fault == "stall":
                    # A wedged engine: no steps, no outbox drain, no
                    # progress — only the stop flag gets it out. The
                    # router's watchdog must detect this on its own.
                    while not self._stop.is_set():
                        time.sleep(0.005)
                    break
                if self._evac_request.is_set():
                    # Runs ON the engine thread between steps: evacuate
                    # is a host-side drain, never concurrent with a
                    # chunk.
                    self._drain_outbox()
                    self._evacuated = self.engine.evacuate()  # handshake-ordered: _evac_done.set() below is the fence the control-thread reader waits on
                    self._evac_request.clear()
                    self._evac_done.set()
                # Graft migrated-in extents BETWEEN steps (host-side,
                # never concurrent with a chunk). A capacity rejection
                # is a normal result — the router falls back to
                # re-prefill dispatch.
                while self._import_inbox:
                    sx, t0 = self._import_inbox.popleft()  # GIL-atomic deque mailbox: consumer side of submit_extent
                    ok = self.engine.import_sequence(sx)
                    self.import_results.append((sx, ok, t0))
                busy = self.engine.step() if self.engine.busy else False
                self._drain_outbox()
                if self.role == "prefill" and self.export_enabled:
                    # Phase handoff: every sequence that
                    # completed prefill ships its pages to the decode
                    # pool instead of decoding here.
                    for rid in self.engine.decoding_rids():
                        self.migration_outbox.append(
                            self.engine.export_sequence(rid)
                        )
                if not busy:
                    self._wake.wait(0.002)
                    self._wake.clear()
        except ReplicaFault as e:
            # Injected (chaos) death: expected and recovered — record
            # it for the control loop's reaper without the traceback
            # noise a re-raise through the thread excepthook produces.
            self.error = e
        except BaseException as e:  # noqa: BLE001 — surfaced to control
            # A dead engine thread must not look like a stuck queue:
            # the control loop checks .error, journals the replica's
            # in-flight sequences onto survivors, and keeps serving
            # (the old behavior here was to fail loudly and
            # take every tenant down with one bad replica).
            self.error = e
            raise

    def _drain_outbox(self) -> None:
        done = self.engine.completed
        if done:
            for rid in list(done):
                self.outbox.append(done.pop(rid))


class Router:
    """See module doc. ``metrics`` gets the fabric gauges the doctor
    reads (``fabric_tenant_vtime_lag``, ``fabric_backlog_tokens``, ...);
    ``clock`` must be the same monotonic base the engines stamp with."""

    def __init__(
        self,
        tenants: List[TenantSpec],
        replicas: Optional[List[Replica]] = None,
        config: Optional[RouterConfig] = None,
        metrics=None,
        clock=time.monotonic,
    ):
        self.config = config or RouterConfig()
        self.metrics = metrics
        self.clock = clock
        self._tenants: Dict[str, _TenantState] = {
            t.name: _TenantState(t) for t in tenants
        }
        self.replicas: List[Replica] = list(replicas or [])
        self._vtime = 0.0
        self._lock = threading.Lock()  # guards WFQ state vs submit()
        self.completions: Dict[str, FabricCompletion] = {}
        # --- crash tolerance, control-thread-owned ---
        self.journal = DispatchJournal()
        self.breaker = CircuitBreaker(
            max_deaths=self.config.breaker_deaths,
            window_seconds=self.config.breaker_window_seconds,
            clock=clock,
        )
        # Dead replicas parked for the autoscaler (take_dead): it joins
        # their threads with a bounded timeout and decides re-bind vs
        # quarantine+replace.
        self.dead_replicas: List[Replica] = []
        self.deaths = 0
        self.death_log: List[tuple] = []  # (name, reason, t)
        self.redispatched = 0
        self.duplicates_dropped = 0
        # Replicas owed: died and not yet replaced. While > 0 the
        # admission cap scales down by live/(live+owed), so BATCH sheds
        # at the door first (graceful degradation, not a cliff).
        self._capacity_owed = 0
        self.shed: Dict[str, int] = {}  # per-SLO-class shed counts
        # Router-level sampling serial: engine-independent, assigned at
        # submit, journaled at dispatch — a re-dispatched SAMPLED
        # sequence pins it so the new engine replays the same
        # (seed, serial, position) key schedule.
        self._sample_serial = 0
        self._in_system = 0
        self.peak_concurrent = 0
        self._backlog_tokens = 0.0  # queued + inflight costs
        self._inflight_tokens = 0.0  # dispatched-not-completed costs
        # Per-phase split of the queued work: prefill-side
        # tokens still to be computed (prompt + folded emitted at next
        # dispatch) vs decode-side tokens still owed (remaining), for
        # queued requests plus the migration waiting room. The sums
        # track the same mutations as _backlog/_inflight under the same
        # lock; the autoscaler sizes the two phase pools from them.
        self._queued_prefill_tokens = 0.0
        self._queued_decode_tokens = 0.0
        # Migration waiting room: sequences exported off a
        # prefill replica, pages in hand, waiting for a decode replica
        # with headroom. Control-thread-owned.
        self._migrating: Deque = collections.deque()  # (sx, fr, t0)
        self.kv_migrations: Dict[str, int] = {}  # outcome -> count
        self.kv_migrated_pages = 0
        self.migration_seconds: List[float] = []
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.max_lag_tokens = 0.0  # high-water starvation lag observed
        # Prefix popularity: content-digest -> submissions
        # seen, bounded LRU. A request is stamped with prefix_id /
        # prefix_len for the ENGINE's copy-on-write sharing only once
        # its prefix digest has been seen >= 2 times — unique-prompt
        # traffic never pays the engine-side registration cost, while
        # a shared system prompt starts sharing from its second user.
        self._prefix_seen: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict()
        )
        self._prefix_seen_cap = 1024
        # Gauge export rides poll() but is throttled: the control loop
        # polls every ~ms and re-rendering the whole per-tenant gauge
        # set each pass starves the engine threads of the GIL for
        # nothing a scraper could see.
        self._export_period = 0.05
        self._last_export = -1e18

    # --- replica set (autoscaler-mutated, control thread only) ---

    def add_replica(self, rep: Replica) -> None:  # thread: control
        self.replicas.append(rep)  # replica-set mutation is control-thread-only by the module's threading contract; submit() threads never touch it
        if self._capacity_owed > 0:
            # Capacity restored (re-bind or replacement claim): the
            # degradation factor recovers with it. Written under the
            # lock because submit() reads it for the admission ceiling.
            with self._lock:
                self._capacity_owed -= 1
        self._export()

    def remove_replica(self, rep: Replica) -> None:  # thread: control
        self.replicas = [r for r in self.replicas if r is not rep]  # control-thread-only, same contract as add_replica
        self._export()

    def live_replicas(self) -> List[Replica]:  # thread: control
        return [r for r in self.replicas if not r.quiesced]

    def take_dead(self) -> List[Replica]:  # thread: control
        """Hand the parked dead replicas to the autoscaler (which joins
        their threads with a bounded timeout and re-binds or replaces
        their claims); clears the parking list."""
        out, self.dead_replicas = self.dead_replicas, []  # control-thread-only: poll() parks corpses, the autoscaler tick — same thread by contract — takes them
        return out

    # --- intake ---

    # thread: any (the open-loop trace threads; WFQ state is lock-guarded)
    def submit(
        self, tenant: str, req: Request, session: Optional[str] = None
    ) -> bool:
        """Admit or reject (False) one request. Latency-tier admission:
        a tier admits only while the fabric backlog is under its
        ``admit_frac`` share of the cap — under pressure BATCH sheds
        first, INTERACTIVE keeps admitting until the hard cap."""
        ts = self._tenants[tenant]
        cost = float(len(req.prompt) + req.max_new_tokens)
        with self._lock:
            ceiling = (
                ts.spec.slo.admit_frac * self.config.backlog_cap_tokens
            )
            owed = self._capacity_owed
            if owed > 0:
                # Graceful degradation: dead-but-unreplaced
                # replicas shrink the effective cap by the lost
                # fraction, so tier ceilings bite sooner and BATCH
                # (admit_frac 0.6) sheds at the door FIRST while
                # INTERACTIVE keeps admitting — capacity loss degrades
                # the deferrable traffic, never a hard outage.
                live = len(self.replicas)  # len() of the atomically-swapped list; submit threads read, control thread swaps
                ceiling *= live / float(live + owed)
            if self._backlog_tokens + cost > ceiling:
                ts.rejected += 1
                if self.metrics is not None:
                    self.metrics.inc(
                        "fabric_rejected_total",
                        labels={"tenant": tenant},
                    )
                if owed > 0:
                    cls = ts.spec.slo.name
                    self.shed[cls] = self.shed.get(cls, 0) + 1
                    if self.metrics is not None:
                        self.metrics.inc(
                            "fabric_shed_total", labels={"cls": cls}
                        )
                return False
            fr = _FabricReq(
                req.rid, tenant, np.asarray(req.prompt, np.int32),
                req.max_new_tokens, session, cost,
            )
            npfx = min(
                self.config.affinity_prefix_tokens, len(fr.prompt)
            )
            if npfx > 1:
                pkey = hashlib.sha1(
                    fr.prompt[:npfx].tobytes()
                ).hexdigest()
                self._prefix_seen[pkey] = (
                    self._prefix_seen.pop(pkey, 0) + 1
                )
                while len(self._prefix_seen) > self._prefix_seen_cap:
                    self._prefix_seen.popitem(last=False)
                fr.prefix_key = pkey
            fr.t_submit = self.clock()
            self._sample_serial += 1
            fr.sample_serial = self._sample_serial
            fr.start_tag = max(self._vtime, ts.tail_tag)
            fr.finish_tag = fr.start_tag + cost / ts.spec.weight
            ts.tail_tag = fr.finish_tag
            ts.queue.append(fr)
            self._backlog_tokens += cost
            self._queued_prefill_tokens += len(fr.prompt)
            self._queued_decode_tokens += fr.max_new
            self._in_system += 1
            self.peak_concurrent = max(self.peak_concurrent, self._in_system)
        return True

    # --- control loop ---

    def poll(self) -> bool:  # thread: control
        """One control-loop pass: reap dead replicas (journal-recover
        their in-flight work), collect completions, dispatch from the
        WFQ into replicas with headroom, export gauges. Returns True
        when any work moved. A replica death never raises out of here —
        it is detected, contained, and recovered."""
        lockdep.single_owner(self, "control")
        moved = self._reap()
        # Migrations settle BEFORE completions: a fast decode replica
        # can graft an extent AND finish the sequence inside one poll
        # interval — collecting the completion first would pop the
        # in-flight entry and orphan the import result (the migration
        # would never count as shipped).
        moved = self._collect_migrations() or moved
        moved = self._dispatch_migrations() or moved
        moved = self._collect() or moved
        moved = self._dispatch() or moved
        now = self.clock()
        if now - self._last_export >= self._export_period:
            self._last_export = now
            self._export()
        return moved

    # --- failure detection + journal recovery ---

    def _reap(self) -> bool:
        """Detection: engine-thread death (``Replica.error``) and the
        stuck-iteration watchdog (no step progress past the deadline
        while work is in flight). Claim-vanished detection lives in the
        autoscaler (it owns the claim store) and calls
        :meth:`mark_dead` with reason ``"claim-vanished"``."""
        moved = False
        for rep in list(self.replicas):
            if rep.error is not None and not rep.dead:
                self.mark_dead(rep, "crash")
                moved = True
            elif self._stalled(rep):
                self.mark_dead(rep, "stall")
                moved = True
        return moved

    def _stalled(self, rep: Replica) -> bool:
        prog = getattr(rep.engine, "progress", None)
        if prog is None or rep.quiesced or not rep.inflight:
            # No heartbeat source (stub engines), draining, or idle:
            # nothing to watchdog. Drop any armed budget so an idle
            # stretch never counts against the next burst.
            rep.watchdog = None
            return False
        if rep.watchdog is None or prog != rep.last_progress:
            rep.last_progress = prog
            rep.watchdog = deadline.Budget(
                timeout=self.config.stall_deadline_seconds,
                name=f"replica-{rep.name}-progress",
            )
            return False
        return rep.watchdog.expired()

    def mark_dead(self, rep: Replica, reason: str) -> int:  # thread: control
        """Classify ``rep`` dead, recover its in-flight sequences from
        the dispatch journal, and park it for the autoscaler. Returns
        how many sequences were re-queued. Idempotent per replica."""
        if rep.dead:
            return 0
        now = self.clock()
        rep.dead = True
        rep.quiesced = True
        rep.death_reason = reason
        # Never join here: the control thread must not block on a
        # possibly-wedged thread. The autoscaler joins with a bounded
        # timeout when it takes the corpse.
        rep.signal_stop()
        self.deaths += 1
        self.death_log.append((rep.name, reason, now))
        key = rep.claim_name or rep.name
        opened = self.breaker.record_death(key)
        # Sequences that FINISHED before the death are sitting in the
        # outbox — collect them first so the journal replay covers
        # exactly the in-flight set (zero duplicates).
        self._collect()
        n = self._reclaim(rep, now)
        self.replicas = [r for r in self.replicas if r is not rep]  # control-thread-only, same contract as add_replica
        self.dead_replicas.append(rep)  # control-thread-only parking list, same contract as take_dead
        with self._lock:
            # submit() reads the owed count for the degraded ceiling.
            self._capacity_owed += 1
        if self.metrics is not None:
            self.metrics.inc(
                "fabric_replica_deaths_total", labels={"reason": reason}
            )
            if n:
                self.metrics.inc("fabric_redispatched_total", float(n))
            if opened:
                self.metrics.inc("fabric_circuit_opened_total")
        log.warning(
            "replica %s dead (%s): %d in-flight sequences recovered "
            "from the journal%s", rep.name, reason, n,
            "; circuit OPEN" if opened else "",
        )
        self._export()
        return n

    def _reclaim(self, rep: Replica, now: float) -> int:
        """Journal recovery: rebuild every sequence the dead replica
        still held and splice it at the FRONT of its tenant's queue
        (its virtual cost was charged at first dispatch — re-entry is
        free), with jittered backoff gating the re-dispatch."""
        n = 0
        for rid in list(rep.inflight):
            rep.inflight.pop(rid)
            e = self.journal.get(rid)
            if e is None or self.journal.is_closed(rid):
                continue  # completed (collected above) or never journaled
            fr = self._from_journal(e)
            fr.retries += 1
            fr.not_before = now + redispatch_backoff(
                fr.retries,
                self.config.redispatch_backoff_base_seconds,
                self.config.redispatch_backoff_cap_seconds,
                fr.rid,
            )
            ts = self._tenants[fr.tenant]
            with self._lock:
                fr.start_tag = fr.finish_tag = self._vtime
                ts.queue.appendleft(fr)
                self._inflight_tokens -= fr.cost
                self._queued_prefill_tokens += (
                    len(fr.prompt) + len(fr.emitted)
                )
                self._queued_decode_tokens += fr.remaining
                self.redispatched += 1
            n += 1
        return n

    def _from_journal(self, e) -> _FabricReq:
        """A fresh _FabricReq carrying everything the journal knows —
        the dead engine contributes nothing."""
        fr = _FabricReq(
            e.rid, e.tenant, e.prompt, e.max_new, e.session, e.cost
        )
        fr.emitted = np.asarray(e.emitted, np.int32)
        fr.t_submit = e.t_submit
        fr.t_first = e.t_first
        fr.t_dispatch = e.t_dispatch
        fr.replicas = list(e.replicas)
        fr.sample_seed = e.sample_seed
        fr.sample_serial = e.sample_serial
        fr.retries = e.retries
        if e.trace_ctx is not None:
            fr.trace_ctx = e.trace_ctx
        return fr

    def recover_from_journal(self, journal: DispatchJournal) -> int:  # thread: control
        """Crash-matrix restart path: a NEW router adopts a restored
        journal — every open entry re-enters its tenant's queue front
        (first-dispatch order), accounting is rebuilt, and closed rids
        stay closed so replay is exactly-once. Returns the number of
        sequences re-queued."""
        self.journal = journal
        n = 0
        # appendleft inverts order: walk newest-first so the oldest
        # dispatch lands at the queue head.
        for e in reversed(journal.open_entries()):
            if e.tenant not in self._tenants:
                continue
            fr = self._from_journal(e)
            fr.retries += 1
            ts = self._tenants[fr.tenant]
            with self._lock:
                fr.start_tag = fr.finish_tag = self._vtime
                ts.queue.appendleft(fr)
                self._backlog_tokens += fr.cost
                self._queued_prefill_tokens += (
                    len(fr.prompt) + len(fr.emitted)
                )
                self._queued_decode_tokens += fr.remaining
                self._in_system += 1
            n += 1
        with self._lock:
            self.redispatched += n
        return n

    @property
    def busy(self) -> bool:  # thread: any (lock-guarded read)
        if self._in_system > 0:
            return True
        return any(r.outbox for r in self.replicas)

    def backlog_tokens(self) -> float:  # thread: any (lock-guarded read)
        with self._lock:
            return self._backlog_tokens

    def queued_tokens(self) -> float:  # thread: any (lock-guarded read)
        """Token cost still waiting in the WFQ (excludes dispatched
        work) — the autoscaler's load signal: in-flight cost is bounded
        by the per-replica inflight cap and finishes on its own; it is
        the QUEUE that says the replica set is too small (or too big)."""
        with self._lock:
            return self._backlog_tokens - self._inflight_tokens

    def in_system(self) -> int:  # thread: any (lock-guarded read)
        return self._in_system

    def queued_prefill_tokens(self) -> float:  # thread: any (lock-guarded read)
        """Prefill-side queued work: prompt (+ folded emitted) tokens
        the next dispatches will have to compute — the signal that says
        the PREFILL pool is too small."""
        with self._lock:
            return self._queued_prefill_tokens

    def queued_decode_tokens(self) -> float:  # thread: any (lock-guarded read)
        """Decode-side queued work: tokens still owed by queued
        requests plus the migration waiting room — the signal that says
        the DECODE pool is too small."""
        with self._lock:
            return self._queued_decode_tokens

    def migration_backlog(self) -> int:  # thread: any (lock-guarded read)
        """Extents waiting for a decode replica with headroom."""
        return len(self._migrating)

    # --- WFQ dispatch ---

    def _next_tenant(self, now: float) -> Optional[_TenantState]:
        best = None
        for ts in self._tenants.values():
            if not ts.queue:
                continue
            if ts.queue[0].not_before > now:
                # Re-dispatch backoff: this head is cooling
                # off after its replica died; skip the tenant this pass
                # rather than busy-spin the poisoned request.
                continue
            if best is None or (
                ts.queue[0].finish_tag < best.queue[0].finish_tag
            ):
                best = ts
        return best

    def _affinity_key(self, fr: _FabricReq) -> str:
        if fr.session:
            return fr.session
        prefix = fr.prompt[: self.config.affinity_prefix_tokens]
        return hashlib.sha1(prefix.tobytes()).hexdigest()

    def _pick_replica(self, fr: _FabricReq) -> Optional[Replica]:
        # An open circuit quarantines the claim: no routing to any
        # replica bound to it until the autoscaler replaces it (or the
        # deaths age out of the breaker window).
        live = [
            r for r in self.live_replicas()
            if not self.breaker.is_open(r.claim_name or r.name)
        ]
        # Phase roles: prompt dispatches go to
        # prefill-capable replicas; the decode pool only receives
        # migrated extents. If every prefill-capable replica is gone
        # (deaths outpacing replacement), serving degraded on the
        # decode pool beats deadlocking the queue.
        prefill_capable = [r for r in live if r.role != "decode"]
        live = prefill_capable or live
        if not live:
            return None
        cap = self.config.max_inflight_per_replica
        with_headroom = [r for r in live if len(r.inflight) < cap]
        if not with_headroom:
            return None
        # Rendezvous hash over the LIVE set: stable while the set is,
        # minimal movement when the autoscaler changes it.
        key = self._affinity_key(fr)
        preferred = max(
            live,
            key=lambda r: zlib.crc32(f"{key}|{r.name}".encode()),
        )
        if len(preferred.inflight) < cap:
            self.affinity_hits += 1
            return preferred
        self.affinity_misses += 1
        return min(with_headroom, key=lambda r: len(r.inflight))

    def _dispatch(self) -> bool:
        moved = False
        while True:
            with self._lock:
                ts = self._next_tenant(self.clock())
                if ts is None:
                    break
                fr = ts.queue[0]
            rep = self._pick_replica(fr)
            if rep is None:
                break
            with self._lock:
                ts.queue.popleft()
                self._vtime = max(self._vtime, fr.start_tag)
                self._inflight_tokens += fr.cost
                self._queued_prefill_tokens -= (
                    len(fr.prompt) + len(fr.emitted)
                )
                self._queued_decode_tokens -= fr.remaining
                # Read under the same lock submit() mutates it under.
                popular = (
                    fr.prefix_key is not None
                    and self._prefix_seen.get(fr.prefix_key, 0) >= 2
                )
                # High-water starvation lag is tracked HERE — vtime
                # only moves on dispatch, so sampling it in the
                # throttled export would miss any spike that drains
                # between exports and make the recorded
                # fabric_wfq_max_lag_tokens export-phase-dependent.
                for other in self._tenants.values():
                    if other.queue:
                        lag = (
                            self._vtime - other.queue[0].finish_tag
                        ) * other.spec.weight
                        if lag > self.max_lag_tokens:
                            self.max_lag_tokens = lag
            now = self.clock()
            if fr.t_dispatch is None:
                fr.t_dispatch = now
                # The queued (root) span closes at FIRST dispatch; an
                # evacuation re-dispatch must not re-record it under
                # the same span id.
                trace.record_span(
                    "serving.request.queued", fr.t_submit, now,
                    self_ctx=fr.trace_ctx,
                    attrs={"rid": fr.rid, "tenant": fr.tenant},
                )
            prompt = (
                np.concatenate([fr.prompt, fr.emitted])
                if len(fr.emitted) else fr.prompt
            )
            rep.inflight[fr.rid] = fr
            fr.replicas.append(rep.name)
            if fr.sample_seed is None:
                # The engine-wide seed, captured at FIRST dispatch:
                # with the router-assigned serial it is the journaled
                # sampling schedule a cross-replica resume pins.
                fr.sample_seed = getattr(
                    getattr(rep.engine, "ec", None), "sample_seed", None
                )
            # Write-ahead: the journal entry must cover this dispatch
            # BEFORE the engine can touch the request — a death at any
            # later point finds everything needed to rebuild.
            self.journal.record(fr, rep.name)
            # Prefix sharing: stamp the engine's COW fields
            # once the prefix digest is popular (>= 2 submissions). The
            # digest is over fr.prompt — a resumed sequence's folded
            # emitted tokens ride AFTER the prefix, so its prefix
            # tokens still match the registered entry and the resume
            # RE-ATTACHES via incref instead of re-materializing
            # private pages.
            with trace.span(
                "serving.request.dispatch", ctx=fr.trace_ctx,
                attrs={"rid": fr.rid, "replica": rep.name},
            ):
                rep.submit(Request(
                    rid=fr.rid, prompt=prompt, max_new_tokens=fr.remaining,
                    # A resumed sequence whose first token already
                    # happened on the drained replica must not
                    # re-observe the engine's TTFT histogram with a
                    # near-zero sample.
                    ttft_preobserved=fr.t_first is not None,
                    prefix_id=fr.prefix_key if popular else None,
                    prefix_len=min(
                        self.config.affinity_prefix_tokens,
                        len(fr.prompt),
                    ) if popular else 0,
                    # Pin the journaled sampling schedule: a sampled
                    # sequence resumed on ANY replica replays the same
                    # (seed, serial, position) keys.
                    sample_seed=fr.sample_seed,
                    sample_serial=fr.sample_serial,
                ))
            moved = True
        return moved

    def _collect(self) -> bool:
        moved = False
        for rep in self.replicas:
            while rep.outbox:
                c = rep.outbox.popleft()
                fr = rep.inflight.pop(c.rid, None)
                if fr is None or fr.rid in self.completions:
                    # Not ours anymore: the rid was journal-recovered
                    # onto another replica (or already completed there)
                    # after this engine raced its completion out.
                    # Exactly-once means the LATE copy is dropped.
                    self.duplicates_dropped += 1
                    if self.metrics is not None:
                        self.metrics.inc(
                            "fabric_duplicates_dropped_total"
                        )
                    continue
                tokens = (
                    np.concatenate([fr.emitted, c.tokens])
                    if len(fr.emitted) else np.asarray(c.tokens)
                )
                t_first = (
                    fr.t_first if fr.t_first is not None
                    else c.t_first_token
                )
                self.completions[fr.rid] = FabricCompletion(
                    rid=fr.rid, tenant=fr.tenant, tokens=tokens,
                    t_submit=fr.t_submit, t_first_token=t_first,
                    t_done=c.t_done, replicas=fr.replicas,
                )
                if fr.trace_ctx is not None and t_first is not None:
                    # Retroactive engine-side stages (the completion is
                    # the first moment the router knows them): prefill
                    # = dispatch -> first token, first_token = the TTFT
                    # span the fabric SLO quantiles measure.
                    if fr.t_dispatch is not None:
                        trace.record_span(
                            "serving.request.prefill",
                            fr.t_dispatch, t_first, ctx=fr.trace_ctx,
                            attrs={"rid": fr.rid,
                                   "replica": fr.replicas[0]
                                   if fr.replicas else ""},
                        )
                    trace.record_span(
                        "serving.request.first_token",
                        fr.t_submit, t_first, ctx=fr.trace_ctx,
                        attrs={"rid": fr.rid, "tenant": fr.tenant},
                    )
                ts = self._tenants[fr.tenant]
                if self.metrics is not None and t_first is not None:
                    # The SLO engine's per-class series:
                    # submitted -> first-token, keyed by SLO CLASS (3
                    # classes, bounded cardinality — per-tenant would
                    # explode under tenant churn). fleetmon's catalog
                    # evaluates ttft-p99-<cls> against the rendered
                    # {cls=,quantile="0.99"} quantile of this summary.
                    self.metrics.observe(
                        "fabric_ttft_seconds",
                        max(t_first - fr.t_submit, 0.0),
                        labels={"cls": ts.spec.slo.name},
                    )
                with self._lock:
                    ts.served_tokens += len(tokens)
                    self._backlog_tokens -= fr.cost
                    self._inflight_tokens -= fr.cost
                    self._in_system -= 1
                self.journal.close(fr.rid)
                moved = True
        return moved

    # --- live KV migration ---

    def _decode_pool(self) -> List[Replica]:
        return [
            r for r in self.live_replicas()
            if r.role == "decode"
            and not self.breaker.is_open(r.claim_name or r.name)
        ]

    def _collect_migrations(self) -> bool:
        """Drain both migration mailboxes: exports coming OFF prefill
        replicas enter the waiting room (journal updated FIRST — from
        this moment a crash anywhere replays ``prompt + emitted`` by
        re-prefill, losing and duplicating nothing), and import results
        coming back from decode replicas settle as shipped (pages
        grafted, decode resumed) or fall back to re-prefill dispatch."""
        moved = False
        has_decode = bool(self._decode_pool())
        now = self.clock()
        for rep in self.replicas:
            if rep.role == "prefill":
                rep.export_enabled = has_decode and not rep.quiesced  # GIL-atomic bool gate read by the engine thread before each export batch
            while rep.migration_outbox:
                sx = rep.migration_outbox.popleft()
                fr = rep.inflight.pop(sx.req.rid, None)
                if fr is None:
                    # Journal-recovered off this replica already (the
                    # death path owns it); the extent is just pages —
                    # dropping it loses nothing.
                    continue
                if len(sx.emitted):
                    fr.emitted = np.concatenate([fr.emitted, sx.emitted])
                if fr.t_first is None:
                    fr.t_first = sx.t_first
                # Crash-safety line: the journal's emitted-so-far is
                # current BEFORE the extent travels anywhere, so a death
                # mid-transfer (source already released its pages) falls
                # back to journal replay — re-prefill, token-identical
                # under the pinned (seed, serial, position) schedule.
                self.journal.note_progress(fr.rid, fr.emitted, fr.t_first)
                with self._lock:
                    self._inflight_tokens -= fr.cost
                    self._queued_decode_tokens += fr.remaining
                self._migrating.append((sx, fr, now))  # control-thread-owned: every reader/writer of the migration waiting room and counters runs on the single poll() thread
                moved = True
            while rep.import_results:
                sx, ok, t0 = rep.import_results.popleft()
                fr = rep.inflight.get(sx.req.rid)
                if fr is None:
                    continue  # reclaimed by a death in between
                if ok:
                    dt = now - t0
                    self.kv_migrations["shipped"] = (  # control-thread-owned: every reader/writer of the migration waiting room and counters runs on the single poll() thread
                        self.kv_migrations.get("shipped", 0) + 1
                    )
                    self.kv_migrated_pages += sx.extent.n_pages
                    self.migration_seconds.append(dt)
                    if self.metrics is not None:
                        self.metrics.inc(
                            "fabric_kv_migrations_total",
                            labels={"outcome": "shipped"},
                        )
                        self.metrics.inc(
                            "fabric_kv_migrated_pages_total",
                            float(sx.extent.n_pages),
                        )
                        self.metrics.observe(
                            "fabric_kv_migration_seconds", dt
                        )
                    trace.record_span(
                        "serving.request.migrate", t0, now,
                        ctx=fr.trace_ctx,
                        attrs={
                            "rid": fr.rid, "to_replica": rep.name,
                            "pages": int(sx.extent.n_pages),
                        },
                    )
                else:
                    # Capacity race on the destination: the sequence is
                    # NOT lost — it re-enters the WFQ front and the next
                    # dispatch re-prefills prompt + emitted.
                    rep.inflight.pop(sx.req.rid)
                    with self._lock:
                        self._inflight_tokens -= fr.cost
                    self._migration_fallback(fr)
                moved = True
        return moved

    def _dispatch_migrations(self) -> bool:
        """Move the waiting room onto decode replicas with headroom.
        With no decode pool at all (scaled away, all dead), waiting
        would deadlock — every extent falls back to re-prefill."""
        moved = False
        cap = self.config.max_inflight_per_replica
        while self._migrating:
            pool = self._decode_pool()
            if not pool:
                sx, fr, _t0 = self._migrating.popleft()  # control-thread-owned: every reader/writer of the migration waiting room and counters runs on the single poll() thread
                with self._lock:
                    self._queued_decode_tokens -= fr.remaining
                self._migration_fallback(fr)
                moved = True
                continue
            with_headroom = [r for r in pool if len(r.inflight) < cap]
            if not with_headroom:
                break  # decode pool full: extents wait, pages in hand
            sx, fr, t0 = self._migrating.popleft()  # control-thread-owned: every reader/writer of the migration waiting room and counters runs on the single poll() thread
            rep = min(with_headroom, key=lambda r: len(r.inflight))
            rep.inflight[fr.rid] = fr
            fr.replicas.append(rep.name)
            with self._lock:
                self._queued_decode_tokens -= fr.remaining
                self._inflight_tokens += fr.cost
            # Write-ahead, like _dispatch: the journal names the decode
            # replica BEFORE its engine can touch the extent.
            self.journal.record(fr, rep.name)
            rep.submit_extent(sx, t0)
            moved = True
        return moved

    def _migration_fallback(self, fr: _FabricReq) -> None:
        """Re-prefill fallback: splice the sequence back at its
        tenant's queue front (virtual cost charged at first dispatch —
        re-entry is free). The journal already carries every emitted
        token, so nothing is lost and _collect's duplicate drop keeps
        exactly-once intact."""
        self.kv_migrations["fallback"] = (  # control-thread-owned: every reader/writer of the migration waiting room and counters runs on the single poll() thread
            self.kv_migrations.get("fallback", 0) + 1
        )
        if self.metrics is not None:
            self.metrics.inc(
                "fabric_kv_migrations_total",
                labels={"outcome": "fallback"},
            )
        ts = self._tenants[fr.tenant]
        with self._lock:
            fr.start_tag = fr.finish_tag = self._vtime
            ts.queue.appendleft(fr)
            self._queued_prefill_tokens += (
                len(fr.prompt) + len(fr.emitted)
            )
            self._queued_decode_tokens += fr.remaining

    # --- evacuation splice (autoscaler scale-down) ---

    def requeue_evacuated(self, rep: Replica) -> int:  # thread: control
        """Fold a drained replica's evacuated sequences back into the
        WFQ at the FRONT of their tenants' queues (they already waited
        their fair turn once — their virtual cost was charged at first
        dispatch, so re-entry is free and immediate). The next dispatch
        prefills ``prompt + emitted`` on another replica; completions
        splice transparently (_collect concatenates)."""
        # Sequences that FINISHED before the drain landed are sitting in
        # the outbox; collect them first so inflight holds exactly the
        # evacuated set.
        self._collect()
        n = 0
        for ev in rep.take_evacuated():
            fr = rep.inflight.pop(ev.req.rid)
            if len(ev.emitted):
                fr.emitted = np.concatenate([fr.emitted, ev.emitted])
            if fr.t_first is None:
                fr.t_first = ev.t_first
            # Keep the journal's emitted-so-far current: a death after
            # this drain must not replay tokens the drain preserved.
            self.journal.note_progress(fr.rid, fr.emitted, fr.t_first)
            t_evac = self.clock()
            ts = self._tenants[fr.tenant]
            with self._lock:
                fr.start_tag = fr.finish_tag = self._vtime
                ts.queue.appendleft(fr)
                self._inflight_tokens -= fr.cost
                self._queued_prefill_tokens += (
                    len(fr.prompt) + len(fr.emitted)
                )
                self._queued_decode_tokens += fr.remaining
            if fr.trace_ctx is not None:
                # The span covers the HAND-BACK + front-splice only
                # (the taxonomy's "evacuate" stage) — the sequence's
                # whole residence on the drained replica belongs to
                # its prefill/decode stages, not this one.
                trace.record_span(
                    "serving.request.evacuate", t_evac, self.clock(),
                    ctx=fr.trace_ctx,
                    attrs={
                        "rid": fr.rid, "from_replica": rep.name,
                        "emitted": int(len(fr.emitted)),
                    },
                )
            n += 1
        return n

    # --- observability ---

    def tenant_stats(self) -> Dict[str, dict]:  # thread: any (lock-guarded read)
        out = {}
        with self._lock:
            for name, ts in self._tenants.items():
                out[name] = {
                    "queued": len(ts.queue),
                    "served_tokens": ts.served_tokens,
                    "rejected": ts.rejected,
                    "weight": ts.spec.weight,
                    "slo": ts.spec.slo.name,
                }
        return out

    def _export(self) -> None:
        if self.metrics is None:
            return
        m = self.metrics
        with self._lock:
            m.set_gauge("fabric_backlog_tokens", self._backlog_tokens)
            m.set_gauge("fabric_in_system_sequences", self._in_system)
            m.set_gauge("fabric_replicas", len(self.live_replicas()))
            # Degradation fraction: owed/(live+owed) — 0 in
            # a healthy fabric, climbing toward 1 as deaths outpace
            # replacement. fleetmon burn-rates it (fabric-degraded).
            owed = self._capacity_owed
            live = len(self.replicas)
            m.set_gauge(
                "fabric_degraded",
                owed / float(live + owed) if owed else 0.0,
            )
            m.set_gauge(
                "fabric_circuit_open",
                float(len(self.breaker.open_keys())),
            )
            # Per-phase backlog + migration waiting room:
            # the autoscaler's pool-sizing signals, and the doctor's
            # imbalance / migration-backlog probes.
            m.set_gauge(
                "fabric_queued_prefill_tokens",
                self._queued_prefill_tokens,
            )
            m.set_gauge(
                "fabric_queued_decode_tokens",
                self._queued_decode_tokens,
            )
            m.set_gauge(
                "fabric_migration_backlog", float(len(self._migrating))
            )
            roles = {"prefill": 0, "decode": 0, "both": 0}
            for r in self.live_replicas():
                roles[r.role] = roles.get(r.role, 0) + 1
            for role, count in roles.items():
                m.set_gauge(
                    "fabric_phase_replicas", float(count),
                    labels={"phase": role},
                )
            for name, ts in self._tenants.items():
                # Starvation lag (weighted tokens): how far the fabric
                # clock ran past a backlogged tenant's head turn. Near
                # zero in a healthy WFQ; growth = this tenant is owed
                # service others received (the doctor's signal).
                lag = 0.0
                if ts.queue:
                    lag = max(
                        0.0,
                        (self._vtime - ts.queue[0].finish_tag)
                        * ts.spec.weight,
                    )
                self.max_lag_tokens = max(self.max_lag_tokens, lag)
                m.set_gauge(
                    "fabric_tenant_vtime_lag", lag,
                    labels={"tenant": name},
                )
                m.set_gauge(
                    "fabric_tenant_queued", float(len(ts.queue)),
                    labels={"tenant": name},
                )
