"""Crash tolerance for the serving fabric.

A copy of ``tpu_dra/serving/faults.py`` (framework-free; the port
imports nothing of the JAX package). Three small, separately-testable
pieces the router composes:

- :class:`DispatchJournal` — the write-ahead record of every dispatch.
  An entry is created the first time a request is handed to a replica
  and carries everything needed to reconstruct the sequence WITHOUT the
  engine's cooperation: prompt, emitted-so-far (folded in from the
  completion outbox at evacuations and re-dispatches), tenant, timing
  stamps, and the sampling schedule ``(seed, serial)`` the engine's
  position-keyed folding makes sufficient for token-identical resume of
  a *sampled* sequence on any survivor. Entries survive close() in a
  ``closed`` map so benches can rebuild reference sampling schedules;
  :meth:`snapshot` / :meth:`restore` round-trip the open set through
  plain JSON-able data for the crash-matrix drill (a restarted router
  adopts the journal and replays to exactly-once completions).
- :class:`CircuitBreaker` — per-claim death counting over a sliding
  window. N deaths inside the window opens the circuit: the router
  stops routing to replicas bound to that claim and the autoscaler
  REPLACES the claim instead of hot re-binding a crash-looper. The
  window is time-based, so an opened circuit half-closes on its own
  once the deaths age out.
- :func:`redispatch_backoff` — deterministic jittered exponential
  backoff for re-dispatching a dead replica's sequences, so a
  poisoned request cannot hot-loop the surviving fleet.

Everything here is control-thread-only state (the router's threading
contract); no locks are taken.
"""

from __future__ import annotations

import collections
import time
import zlib
from typing import Deque, Dict, List, Optional

import numpy as np


class ReplicaFault(RuntimeError):
    """An injected (chaos) replica fault. The replica's engine thread
    raises it out of its loop without the loud traceback re-raise real
    bugs get — injected deaths are expected and recovered."""


def redispatch_backoff(
    retries: int,
    base_seconds: float,
    cap_seconds: float,
    token: str,
) -> float:
    """Exponential backoff with deterministic jitter in [0.5x, 1.0x],
    derived from ``token`` (rid + retry count) so tests and seeded
    benches see the same schedule every run."""
    raw = min(cap_seconds, base_seconds * (2.0 ** max(0, retries - 1)))
    h = zlib.crc32(f"{token}|{retries}".encode()) & 0xFFFFFFFF
    return raw * (0.5 + 0.5 * (h / 0xFFFFFFFF))


class JournalEntry:
    """One dispatched request's reconstructable state."""

    __slots__ = (
        "rid", "tenant", "prompt", "max_new", "session", "cost",
        "emitted", "t_submit", "t_first", "t_dispatch", "replica",
        "replicas", "sample_seed", "sample_serial", "retries",
        "trace_ctx",
    )

    def __init__(self, rid: str, tenant: str, prompt, max_new: int,
                 session: Optional[str], cost: float):
        self.rid = rid
        self.tenant = tenant
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new = max_new
        self.session = session
        self.cost = cost
        self.emitted = np.zeros(0, np.int32)
        self.t_submit = 0.0
        self.t_first: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.replica = ""  # the replica currently holding it
        self.replicas: List[str] = []
        self.sample_seed: Optional[int] = None
        self.sample_serial: Optional[int] = None
        self.retries = 0
        # Live-only (NOT snapshotted — trace ctxs are process-local).
        self.trace_ctx = None

    def to_dict(self) -> dict:
        return {
            "rid": self.rid,
            "tenant": self.tenant,
            "prompt": [int(t) for t in self.prompt],
            "max_new": int(self.max_new),
            "session": self.session,
            "cost": float(self.cost),
            "emitted": [int(t) for t in self.emitted],
            "t_submit": float(self.t_submit),
            "t_first": (
                None if self.t_first is None else float(self.t_first)
            ),
            "t_dispatch": (
                None if self.t_dispatch is None
                else float(self.t_dispatch)
            ),
            "replica": self.replica,
            "replicas": list(self.replicas),
            "sample_seed": self.sample_seed,
            "sample_serial": self.sample_serial,
            "retries": int(self.retries),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "JournalEntry":
        e = cls(
            d["rid"], d["tenant"],
            np.asarray(d["prompt"], np.int32),
            int(d["max_new"]), d.get("session"), float(d["cost"]),
        )
        e.emitted = np.asarray(d.get("emitted") or [], np.int32)
        e.t_submit = float(d.get("t_submit") or 0.0)
        e.t_first = d.get("t_first")
        e.t_dispatch = d.get("t_dispatch")
        e.replica = d.get("replica") or ""
        e.replicas = list(d.get("replicas") or [])
        e.sample_seed = d.get("sample_seed")
        e.sample_serial = d.get("sample_serial")
        e.retries = int(d.get("retries") or 0)
        return e


class DispatchJournal:
    """Control-thread-owned dispatch journal: ``record`` at every
    dispatch, ``note_progress`` when an evacuation folds emitted
    tokens back, ``close`` at completion. ``open_entries`` is exactly
    the set a crashed fleet owes its tenants."""

    def __init__(self):
        self.entries: Dict[str, JournalEntry] = {}
        # Closed entries are kept (small: stamps + token ids, no KV)
        # so a restarted router refuses to replay a completed rid and
        # benches can reconstruct the sampling schedule per request.
        self.closed: Dict[str, JournalEntry] = {}

    def record(self, fr, replica_name: str) -> JournalEntry:
        """Journal one dispatch of router request ``fr`` (duck-typed:
        any object with the _FabricReq fields) onto ``replica_name``."""
        e = self.entries.get(fr.rid)
        if e is None:
            e = JournalEntry(
                fr.rid, fr.tenant, fr.prompt, fr.max_new, fr.session,
                fr.cost,
            )
            self.entries[fr.rid] = e
        e.emitted = fr.emitted
        e.t_submit = fr.t_submit
        e.t_first = fr.t_first
        e.t_dispatch = fr.t_dispatch
        e.replica = replica_name
        e.replicas = list(fr.replicas)
        e.sample_seed = fr.sample_seed
        e.sample_serial = fr.sample_serial
        e.retries = getattr(fr, "retries", 0)
        e.trace_ctx = fr.trace_ctx
        return e

    def note_progress(self, rid: str, emitted, t_first) -> None:
        e = self.entries.get(rid)
        if e is None:
            return
        e.emitted = np.asarray(emitted, np.int32)
        if e.t_first is None:
            e.t_first = t_first

    def get(self, rid: str) -> Optional[JournalEntry]:
        return self.entries.get(rid)

    def close(self, rid: str) -> None:
        e = self.entries.pop(rid, None)
        if e is not None:
            self.closed[rid] = e

    def is_closed(self, rid: str) -> bool:
        return rid in self.closed

    def open_entries(self) -> List[JournalEntry]:
        """Open (dispatched, not completed) entries in first-dispatch
        order — the replay order for a restarted router."""
        return sorted(
            self.entries.values(),
            key=lambda e: (e.t_dispatch or 0.0, e.t_submit, e.rid),
        )

    def sample_schedule(self, rid: str) -> Optional[tuple]:
        """``(seed, serial)`` journaled for ``rid`` (open or closed) —
        what a reference engine must pin to reproduce its tokens."""
        e = self.entries.get(rid) or self.closed.get(rid)
        if e is None or e.sample_serial is None:
            return None
        return (e.sample_seed, e.sample_serial)

    # --- crash-matrix snapshot/restore ---

    def snapshot(self) -> dict:
        """JSON-able state: open entries + closed rids. Trace ctxs are
        process-local and excluded (a restarted router re-mints)."""
        return {
            "open": [e.to_dict() for e in self.open_entries()],
            "closed": sorted(self.closed),
        }

    @classmethod
    def restore(cls, snap: dict) -> "DispatchJournal":
        j = cls()
        for d in snap.get("open") or []:
            j.entries[d["rid"]] = JournalEntry.from_dict(d)
        for rid in snap.get("closed") or []:
            # The closed-set marker is what matters for exactly-once;
            # the full entry bodies are not needed across a restart.
            j.closed.setdefault(rid, None)  # type: ignore[arg-type]
        return j


class CircuitBreaker:
    """Per-key (ResourceClaim name) death counting over a sliding
    window. ``max_deaths`` deaths within ``window_seconds`` opens the
    key's circuit; it half-closes by itself once deaths age out of the
    window (the replacement claim gets a fresh key anyway)."""

    def __init__(self, max_deaths: int = 3,
                 window_seconds: float = 30.0,
                 clock=time.monotonic):
        self.max_deaths = max_deaths
        self.window_seconds = window_seconds
        self.clock = clock
        self._deaths: Dict[str, Deque[float]] = {}
        self.opened_total = 0
        self._was_open: Dict[str, bool] = {}

    def _prune(self, key: str, now: float) -> Deque[float]:
        q = self._deaths.setdefault(key, collections.deque())
        horizon = now - self.window_seconds
        while q and q[0] < horizon:
            q.popleft()
        return q

    def record_death(self, key: str) -> bool:
        """Record one death for ``key``; returns True if this death
        OPENED the circuit (edge, not level — for the opened counter)."""
        now = self.clock()
        q = self._prune(key, now)
        q.append(now)
        was = self._was_open.get(key, False)
        open_now = len(q) >= self.max_deaths
        if open_now and not was:
            self.opened_total += 1
        self._was_open[key] = open_now
        return open_now and not was

    def is_open(self, key: str) -> bool:
        if key not in self._deaths:
            return False
        q = self._prune(key, self.clock())
        return len(q) >= self.max_deaths

    def open_keys(self) -> List[str]:
        return [k for k in list(self._deaths) if self.is_open(k)]

    def clear(self, key: str) -> None:
        self._deaths.pop(key, None)
        self._was_open.pop(key, None)

    def snapshot(self) -> dict:
        return {
            "deaths": {k: list(q) for k, q in self._deaths.items()},
            "opened_total": self.opened_total,
        }

    def restore(self, snap: dict) -> None:
        self._deaths = {
            k: collections.deque(v)
            for k, v in (snap.get("deaths") or {}).items()
        }
        self.opened_total = int(snap.get("opened_total") or 0)
        self._was_open = {
            k: len(q) >= self.max_deaths
            for k, q in self._deaths.items()
        }
