"""Deterministic, seedable chaos fault-injection harness.

A copy of ``tpu_dra/infra/chaos.py`` (framework-free; the port imports
nothing of the JAX package): the fault kinds, the schedule, its
validation and seeded generation, and the :class:`ChaosEngine` that
fires events at injectors. The port's faultbench registers injectors
for the serving kinds (``replica_crash``, ``replica_stall``); the
injectors of the control-plane kinds belong to the driver and are not
copied. The kinds, their params and the validation are the driver's,
so a schedule validates the same way in both packages; ``crash``
events name a point of :data:`CRASH_POINTS`, the names of the driver's
crash-point registry (``tpu_dra/infra/crashpoint.py``).

The reference driver has no fault-injection surface at all (its e2e needs a
real GPU cluster and real faults); this layer closes that gap for the whole
stack. A :class:`FaultSchedule` is an ordered list of fault events — chip
health flaps through the tpulib stub's health-event queue, apiserver
429/5xx bursts and watch-stream drops through the fake apiserver's fault
hooks, kubelet-plugin crash/restart mid-``PrepareResourceClaim`` (replayed
through the WAL checkpoint), and multiplex-client death mid-lease. The
schedule is either generated deterministically from a seed or loaded from a
JSON file; :class:`ChaosEngine` dispatches the events to injector callbacks
registered by the harness.

Determinism is the point: the same seed produces the same schedule, so a
soak failure reproduces with ``TPU_DRA_CHAOS_SEED=<n>``; schedules can also
be captured to JSON and replayed exactly (``TPU_DRA_CHAOS_SCHEDULE=<path>``,
validated by ``hack/lint.py``).

Schedule JSON format (``*.chaos.json``)::

    {
      "version": 1,
      "seed": 7,                       # provenance only (optional)
      "description": "what this drill covers",
      "events": [
        {"at": 0.5, "kind": "chip_down", "chip_index": 2,
         "reason": "ici-link-down"},
        {"at": 1.2, "kind": "chip_up", "chip_index": 2},
        {"at": 1.5, "kind": "apiserver_throttle", "count": 5,
         "retry_after": 0.05},
        {"at": 1.6, "kind": "apiserver_errors", "count": 3, "status": 503},
        {"at": 1.8, "kind": "api_partition", "duration": 0.5},
        {"at": 1.9, "kind": "api_latency", "delay": 0.1, "duration": 0.5},
        {"at": 2.0, "kind": "watch_drop"},
        {"at": 2.5, "kind": "plugin_crash"},
        {"at": 2.8, "kind": "crash",
         "point": "checkpoint.write.before_replace"},
        {"at": 3.0, "kind": "client_death"},
        {"at": 3.2, "kind": "replica_crash", "replica_index": 1},
        {"at": 3.5, "kind": "replica_stall", "replica_index": 0},
        {"at": 3.8, "kind": "replica_crash_loop", "replica_index": 2,
         "count": 3},
        {"at": 4.0, "kind": "apiserver_restart", "outage": 0.5},
        {"at": 4.5, "kind": "apiserver_brownout", "concurrency": 2,
         "duration": 1.0}
      ]
    }

Every ``chip_down`` must be followed by a later ``chip_up`` for the same
chip: convergence assertions ("ResourceSlices match chip health") are only
meaningful when the schedule's terminal state is all-healthy.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

# The named crash points of the driver's WAL lifecycle (the keys of
# ``tpu_dra/infra/crashpoint.py``'s registry), which a ``crash`` event
# must name.
CRASH_POINTS = frozenset({
    "checkpoint.write.before_tmp",
    "checkpoint.write.after_tmp",
    "checkpoint.write.before_replace",
    "checkpoint.write.before_bak",
    "plugin.prepare.after_wal_started",
    "plugin.prepare.between_devices",
    "plugin.prepare.before_wal_completed",
    "plugin.unprepare.after_teardown",
    "plugin.unprepare.before_wal_removed",
    "tpulib.subslice.after_persist",
    "plugin.gc.before_unprepare",
    "plugin.gc.between_claims",
    "cdplugin.prepare.after_wal_started",
    "cdplugin.prepare.before_wal_completed",
    "cdplugin.unprepare.before_wal_removed",
    "repack.migrate.after_plan_persisted",
    "repack.migrate.after_evacuate",
    "repack.migrate.between_unprepare_prepare",
    "repack.migrate.before_commit",
    "gang.commit.between_intents",
    "gang.commit.after_intent_persisted",
    "gang.commit.between_members",
    "gang.commit.before_finalize",
    "gang.teardown.after_intent",
})

SCHEDULE_VERSION = 1

# Environment knobs (documented in docs/operations.md).
CHAOS_SEED_ENV = "TPU_DRA_CHAOS_SEED"
CHAOS_SCHEDULE_ENV = "TPU_DRA_CHAOS_SCHEDULE"
CHAOS_TIME_SCALE_ENV = "TPU_DRA_CHAOS_TIME_SCALE"

# Fault kinds, and the injection seam each one drives.
CHIP_DOWN = "chip_down"            # tpulib stub health-event queue
CHIP_UP = "chip_up"                # tpulib stub health-event queue
APISERVER_THROTTLE = "apiserver_throttle"  # fakeserver 429 burst
APISERVER_ERRORS = "apiserver_errors"      # fakeserver 5xx burst
WATCH_DROP = "watch_drop"          # fakeserver server-side watch close
PLUGIN_CRASH = "plugin_crash"      # harness kills/rebuilds the plugin
CLIENT_DEATH = "client_death"      # multiplex client dies mid-lease
CRASH = "crash"                    # process death at a NAMED crash point
#   (the CRASH_POINTS names) — unlike plugin_crash, which kills
#   the plugin "whenever", a crash event arms a registered crash point so
#   process death lands at a specific instruction of the WAL lifecycle.
API_PARTITION = "api_partition"    # fakeserver blackhole: requests hang
#   for params["duration"] seconds (then 503) and watch streams drop —
#   the fault deadline budgets + the circuit breaker exist for.
API_LATENCY = "api_latency"        # fakeserver injects params["delay"]
#   seconds into every request for params["duration"] seconds (slow
#   concierge / overloaded etcd analog).
REPLICA_CRASH = "replica_crash"    # serving fabric: a
#   replica's engine thread raises mid-generation — the hard-death
#   path the router's reaper + dispatch journal recover.
REPLICA_STALL = "replica_stall"    # serving fabric: a replica's engine
#   thread wedges (no step progress, thread alive) — the path the
#   stuck-iteration watchdog exists to catch.
REPLICA_CRASH_LOOP = "replica_crash_loop"  # serving fabric: re-crash
#   the replica on every re-bind, params["count"] times total — drives
#   the circuit breaker open and the autoscaler's claim replacement.

APISERVER_RESTART = "apiserver_restart"  # full process restart:
#   FakeApiServer.restart — state snapshot/restore, every watch
#   dropped, resourceVersions advanced past the event window (410 on
#   resume -> relist), the port dark for params["outage"] seconds.
APISERVER_BROWNOUT = "apiserver_brownout"  # flow-control squeeze: the
#   live server's APF concurrency drops to params["concurrency"] for
#   params["duration"] seconds, shedding low-share flows with 429 —
#   the sustained-overload regime, vs apiserver_throttle's burst.

# Serving-layer kinds target the fabric harness (faultbench), not the
# control-plane soaks; they are EXCLUDED from from_seed's default
# population so adding them did not change what any existing seed
# generates (seeded soak reproducibility is the whole point).
SERVING_FAULT_KINDS = frozenset({
    REPLICA_CRASH, REPLICA_STALL, REPLICA_CRASH_LOOP,
})

# Control-plane recovery kinds are likewise opt-in: a full
# apiserver restart or brownout inside the long-standing chip-flap
# soaks would change what every existing seed generates AND what those
# soaks assert (they converge through weather, not through relists).
# The storm drills pass these via ``kinds`` explicitly.
CONTROL_PLANE_FAULT_KINDS = frozenset({
    APISERVER_RESTART, APISERVER_BROWNOUT,
})

FAULT_KINDS = frozenset({
    CHIP_DOWN, CHIP_UP, APISERVER_THROTTLE, APISERVER_ERRORS,
    WATCH_DROP, PLUGIN_CRASH, CLIENT_DEATH, CRASH,
    API_PARTITION, API_LATENCY,
}) | SERVING_FAULT_KINDS | CONTROL_PLANE_FAULT_KINDS


def _positive_number(v: object) -> bool:
    return (
        isinstance(v, (int, float))
        and not isinstance(v, bool)
        and v > 0
    )

# Per-kind required params: name -> predicate (check_bench_schema-style).
_REQUIRED_PARAMS: Dict[str, Dict[str, Callable[[object], bool]]] = {
    CHIP_DOWN: {},   # chip_index OR chip_uuid, checked specially
    CHIP_UP: {},
    APISERVER_THROTTLE: {
        "count": lambda v: isinstance(v, int) and v >= 1,
    },
    APISERVER_ERRORS: {
        "count": lambda v: isinstance(v, int) and v >= 1,
    },
    CRASH: {
        # The point must exist in the canonical crash-point table, or the
        # soak "passes" while never crashing anywhere (the schedule gate
        # catches drift when a point is renamed).
        "point": lambda v: isinstance(v, str) and v in CRASH_POINTS,
    },
    API_PARTITION: {
        "duration": _positive_number,
    },
    API_LATENCY: {
        "delay": _positive_number,
        "duration": _positive_number,
    },
    REPLICA_CRASH: {
        "replica_index": lambda v: isinstance(v, int)
        and not isinstance(v, bool) and v >= 0,
    },
    REPLICA_STALL: {
        "replica_index": lambda v: isinstance(v, int)
        and not isinstance(v, bool) and v >= 0,
    },
    REPLICA_CRASH_LOOP: {
        "replica_index": lambda v: isinstance(v, int)
        and not isinstance(v, bool) and v >= 0,
        # Fewer than 2 deaths cannot distinguish a crash LOOP from a
        # one-off crash the re-bind path absorbs.
        "count": lambda v: isinstance(v, int)
        and not isinstance(v, bool) and v >= 2,
    },
    APISERVER_RESTART: {
        # A zero-length outage is a valid drill (watch-cache loss with
        # no dark window), so only the presence of a number is checked.
        "outage": lambda v: isinstance(v, (int, float))
        and not isinstance(v, bool) and v >= 0,
    },
    APISERVER_BROWNOUT: {
        "concurrency": lambda v: isinstance(v, int)
        and not isinstance(v, bool) and v >= 1,
        "duration": _positive_number,
    },
}


@dataclass(frozen=True)
class FaultEvent:
    at: float            # seconds from schedule start
    kind: str
    params: dict = field(default_factory=dict, hash=False)

    def chip_key(self) -> Optional[object]:
        """Identity used to pair chip_down/chip_up events."""
        if "chip_uuid" in self.params:
            return self.params["chip_uuid"]
        if "chip_index" in self.params:
            return int(self.params["chip_index"])
        return None

    def to_dict(self) -> dict:
        return {"at": self.at, "kind": self.kind, **self.params}


def validate_schedule(data: object) -> List[str]:
    """Validate a decoded ``*.chaos.json`` document; returns error strings
    (empty = valid). Shared by the loader and the ``hack/lint.py`` gate so
    a drifting schedule file fails `make lint`, not a 2am soak."""
    errs: List[str] = []
    if not isinstance(data, dict):
        return ["schedule must be a JSON object"]
    version = data.get("version", SCHEDULE_VERSION)
    if version != SCHEDULE_VERSION:
        errs.append(f"unsupported schedule version: {version!r}")
    events = data.get("events")
    if not isinstance(events, list) or not events:
        return errs + ["'events' must be a non-empty list"]
    # Structural pass in file order (so error indices match the file) ...
    chip_events = []  # (file index, at, kind, chip key) of valid chip events
    for i, ev in enumerate(events):
        where = f"events[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: must be an object")
            continue
        at = ev.get("at")
        if not isinstance(at, (int, float)) or isinstance(at, bool) or at < 0:
            errs.append(f"{where}: 'at' must be a number >= 0")
            at = 0.0
        kind = ev.get("kind")
        if kind not in FAULT_KINDS:
            errs.append(
                f"{where}: unknown kind {kind!r} "
                f"(known: {', '.join(sorted(FAULT_KINDS))})"
            )
            continue
        for name, ok in _REQUIRED_PARAMS.get(kind, {}).items():
            if not ok(ev.get(name)):
                errs.append(f"{where}: {kind} needs valid {name!r}")
        if kind in (CHIP_DOWN, CHIP_UP):
            has_idx = isinstance(ev.get("chip_index"), int)
            has_uuid = isinstance(ev.get("chip_uuid"), str) and ev["chip_uuid"]
            if not (has_idx or has_uuid):
                errs.append(
                    f"{where}: {kind} needs 'chip_index' (int) or "
                    f"'chip_uuid' (string)"
                )
                continue
            key = ev.get("chip_uuid") or int(ev["chip_index"])
            chip_events.append((i, float(at), kind, key))
    # ... then pair down/up in EXECUTION order: the engine fires events
    # sorted by 'at' (FaultSchedule sorts), so a time-misordered file whose
    # chip_up precedes its chip_down on the timeline must be rejected even
    # though the list order looks paired. Stable sort keeps file order for
    # equal timestamps, matching the engine exactly.
    down: Dict[object, int] = {}  # chip key -> index of unmatched chip_down
    for i, _, kind, key in sorted(chip_events, key=lambda e: e[1]):
        if kind == CHIP_DOWN:
            if key in down:
                errs.append(
                    f"events[{i}]: chip {key!r} taken down twice without a "
                    f"chip_up in between (first at events[{down[key]}])"
                )
            down[key] = i
        else:
            if key not in down:
                errs.append(
                    f"events[{i}]: chip_up for chip {key!r} that is not "
                    f"down at that point of the timeline"
                )
            down.pop(key, None)
    for key, i in sorted(down.items(), key=lambda kv: kv[1]):
        errs.append(
            f"events[{i}]: chip {key!r} never recovers (no later chip_up) — "
            f"the schedule's terminal state must be all-healthy"
        )
    return errs


class FaultSchedule:
    """An ordered, deterministic list of fault events."""

    def __init__(self, events: List[FaultEvent], seed: Optional[int] = None,
                 description: str = ""):
        self.events = sorted(events, key=lambda e: e.at)
        self.seed = seed
        self.description = description

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    def to_dict(self) -> dict:
        d: dict = {"version": SCHEDULE_VERSION}
        if self.seed is not None:
            d["seed"] = self.seed
        if self.description:
            d["description"] = self.description
        d["events"] = [ev.to_dict() for ev in self.events]
        return d

    @classmethod
    def from_dict(cls, data: dict) -> "FaultSchedule":
        errs = validate_schedule(data)
        if errs:
            raise ValueError(
                "invalid fault schedule: " + "; ".join(errs)
            )
        events = []
        for raw in data["events"]:
            params = {
                k: v for k, v in raw.items() if k not in ("at", "kind")
            }
            events.append(
                FaultEvent(at=float(raw["at"]), kind=raw["kind"],
                           params=params)
            )
        return cls(
            events, seed=data.get("seed"),
            description=data.get("description", ""),
        )

    @classmethod
    def from_file(cls, path: str) -> "FaultSchedule":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_seed(
        cls,
        seed: int,
        duration: float = 5.0,
        chips: int = 4,
        events_per_second: float = 2.0,
        kinds: Optional[List[str]] = None,
        max_chips_down: Optional[int] = None,
        replicas: int = 2,
    ) -> "FaultSchedule":
        """Generate a randomized-but-deterministic schedule.

        Chip flaps come as paired down/up events (recovery after a random
        fraction of a second to a couple of seconds, clamped into the
        schedule) so the terminal state is always all-healthy. At most
        ``max_chips_down`` chips (default: all but one) are down at any
        instant — a schedule that takes out the whole host tests nothing
        but the empty ResourceSlice."""
        rng = random.Random(seed)
        # Serving-fabric kinds are opt-in (pass them via ``kinds``):
        # keeping them out of the default population preserves what
        # every pre-existing seed generates for the control-plane
        # soaks. ``replicas`` bounds their replica_index.
        kinds = list(
            kinds
            or sorted(
                FAULT_KINDS - {CHIP_UP} - SERVING_FAULT_KINDS
                - CONTROL_PLANE_FAULT_KINDS
            )
        )
        # Chip flaps are the fault the remediation pipeline exists for:
        # weight them so every non-trivial schedule exercises that path.
        population = kinds + [CHIP_DOWN] * (2 if CHIP_DOWN in kinds else 0)
        if max_chips_down is None:
            max_chips_down = max(1, chips - 1)
        n = max(1, int(duration * events_per_second))
        events: List[FaultEvent] = []
        down_until: Dict[int, float] = {}  # chip index -> recovery time
        for _ in range(n):
            at = round(rng.uniform(0, duration * 0.8), 3)
            kind = rng.choice(population)
            if kind == CHIP_DOWN:
                live_down = {
                    c for c, until in down_until.items() if until > at
                }
                candidates = [
                    c for c in range(chips) if c not in live_down
                ]
                if not candidates or len(live_down) >= max_chips_down:
                    continue
                chip = rng.choice(candidates)
                up_at = round(
                    min(duration, at + rng.uniform(0.1, duration / 2)), 3
                )
                down_until[chip] = up_at
                reason = rng.choice(
                    ["ici-link-down", "hbm-uncorrectable", "thermal-trip"]
                )
                events.append(FaultEvent(at, CHIP_DOWN, {
                    "chip_index": chip, "reason": reason,
                }))
                events.append(FaultEvent(up_at, CHIP_UP, {
                    "chip_index": chip, "reason": "recovered",
                }))
            elif kind == APISERVER_THROTTLE:
                # Burst sizes sit inside the transport's retry budget
                # (rest.KubeClient: 4x429 / 3x5xx): chaos here probes
                # "weather the client must absorb", not "outage" — the
                # convergence assertions need the terminal state reachable.
                events.append(FaultEvent(at, kind, {
                    "count": rng.randint(1, 4),
                    "retry_after": round(rng.uniform(0.01, 0.1), 3),
                }))
            elif kind == APISERVER_ERRORS:
                events.append(FaultEvent(at, kind, {
                    "count": rng.randint(1, 3),
                    "status": rng.choice([500, 503]),
                }))
            elif kind == CRASH:
                # Seeded soaks mix process death at a random registered
                # crash point in with the API-weather faults.
                events.append(FaultEvent(at, kind, {
                    "point": rng.choice(sorted(CRASH_POINTS)),
                }))
            elif kind == API_PARTITION:
                # Short windows: the soak's convergence assertions need
                # the terminal state reachable well inside its timeout,
                # and budgets/circuits trip on fractions of a second.
                events.append(FaultEvent(at, kind, {
                    "duration": round(rng.uniform(0.1, 0.8), 3),
                }))
            elif kind == API_LATENCY:
                events.append(FaultEvent(at, kind, {
                    "delay": round(rng.uniform(0.02, 0.2), 3),
                    "duration": round(rng.uniform(0.2, 1.0), 3),
                }))
            elif kind in (REPLICA_CRASH, REPLICA_STALL):
                events.append(FaultEvent(at, kind, {
                    "replica_index": rng.randrange(max(1, replicas)),
                }))
            elif kind == REPLICA_CRASH_LOOP:
                events.append(FaultEvent(at, kind, {
                    "replica_index": rng.randrange(max(1, replicas)),
                    "count": rng.randint(2, 4),
                }))
            elif kind == APISERVER_RESTART:
                # Dark windows sized to the transport's connection
                # backoff ladder (0.2..3.2s): every refused dial-in
                # retries through within the drill.
                events.append(FaultEvent(at, kind, {
                    "outage": round(rng.uniform(0.2, 1.0), 3),
                }))
            elif kind == APISERVER_BROWNOUT:
                events.append(FaultEvent(at, kind, {
                    "concurrency": rng.randint(1, 4),
                    "duration": round(rng.uniform(0.5, 2.0), 3),
                }))
            else:  # watch_drop / plugin_crash / client_death
                events.append(FaultEvent(at, kind, {}))
        if not events:
            # Degenerate rng path: guarantee at least one flap.
            events = [
                FaultEvent(0.0, CHIP_DOWN,
                           {"chip_index": 0, "reason": "ici-link-down"}),
                FaultEvent(min(0.5, duration), CHIP_UP,
                           {"chip_index": 0, "reason": "recovered"}),
            ]
        return cls(events, seed=seed,
                   description=f"generated from seed {seed}")


def schedule_from_env(
    default_seed: int = 0, **from_seed_kwargs
) -> FaultSchedule:
    """Resolve the schedule the environment asks for:
    ``TPU_DRA_CHAOS_SCHEDULE`` (a ``*.chaos.json`` path) wins; otherwise
    generate from ``TPU_DRA_CHAOS_SEED`` (falling back to
    ``default_seed``)."""
    path = os.environ.get(CHAOS_SCHEDULE_ENV)
    if path:
        return FaultSchedule.from_file(path)
    seed = int(os.environ.get(CHAOS_SEED_ENV, default_seed))
    return FaultSchedule.from_seed(seed, **from_seed_kwargs)


def time_scale_from_env(default: float = 1.0) -> float:
    raw = os.environ.get(CHAOS_TIME_SCALE_ENV, "")
    return float(raw) if raw else default


class ChaosEngine:
    """Dispatches a schedule's events to registered injectors.

    Injectors are plain callables taking the :class:`FaultEvent`; the
    harness registers one per kind it can deliver (``register``). Unhandled
    kinds are counted and skipped — a schedule is allowed to name faults a
    particular harness doesn't wire (e.g. no apiserver in a pure-unit
    soak). Two drive modes:

    - ``run(time_scale=...)``: fire events on their ``at`` timeline
      (scaled), sleeping in between — the soak-test mode;
    - ``step()``: fire the next event immediately — the deterministic
      unit-test mode.
    """

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self._injectors: Dict[str, Callable[[FaultEvent], None]] = {}
        self._cursor = 0
        self.fired: Dict[str, int] = {}
        self.skipped: Dict[str, int] = {}
        self.errors: List[str] = []

    def register(self, kind: str, injector: Callable[[FaultEvent], None]) -> "ChaosEngine":
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind: {kind!r}")
        self._injectors[kind] = injector
        return self

    @property
    def remaining(self) -> int:
        return len(self.schedule.events) - self._cursor

    def _fire(self, ev: FaultEvent) -> None:
        fn = self._injectors.get(ev.kind)
        if fn is None:
            self.skipped[ev.kind] = self.skipped.get(ev.kind, 0) + 1
            return
        log.info("chaos: t=%.3f %s %s", ev.at, ev.kind, ev.params)
        try:
            fn(ev)
            self.fired[ev.kind] = self.fired.get(ev.kind, 0) + 1
        except Exception as e:  # an injector must never kill the drill
            log.exception("chaos injector %s failed", ev.kind)
            self.errors.append(f"{ev.kind}@{ev.at}: {e}")

    def step(self) -> Optional[FaultEvent]:
        """Fire the next event immediately; None when exhausted."""
        if self._cursor >= len(self.schedule.events):
            return None
        ev = self.schedule.events[self._cursor]
        self._cursor += 1
        self._fire(ev)
        return ev

    def run(self, time_scale: float = 1.0, stop=None) -> None:
        """Fire all remaining events on the schedule's timeline, scaled by
        ``time_scale`` (0 = as fast as possible). An optional ``stop``
        event aborts the drill between events (a harness tearing down
        early must not leave this thread sleeping out the timeline)."""
        if stop is None:
            stop = threading.Event()
        start = time.monotonic()
        while self._cursor < len(self.schedule.events):
            ev = self.schedule.events[self._cursor]
            if time_scale > 0:
                delay = ev.at * time_scale - (time.monotonic() - start)
                if delay > 0 and stop.wait(delay):
                    return
            if stop.is_set():
                return
            self._cursor += 1
            self._fire(ev)
