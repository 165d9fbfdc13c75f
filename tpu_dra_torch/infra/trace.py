"""Request tracing for the serving tier: spans and a per-process flight
recorder.

The part of ``tpu_dra/infra/trace.py`` that the serving tier calls
(:func:`new_ctx`, :func:`span`, :func:`record_span`) and what those need,
copied (the port imports nothing of the JAX package). Span names, the
``TPU_DRA_TRACE`` switch and the recorder's span dicts are the JAX
module's, so a reader of one process's spans reads the other's alike.

Every serving stage of a request emits a :class:`Span`; spans land in a
bounded in-memory :class:`FlightRecorder` ring per process
(never-blocking, drop-oldest) and stitch back into one timeline by
trace id:

- **in-process**: a thread-ambient current span (``contextvars``, the
  :mod:`~tpu_dra_torch.infra.deadline` idiom) parents nested spans
  without threading a parameter through every signature;
- **per request**: the Router mints a ctx at submit (:func:`new_ctx`)
  and threads it through dispatch, evacuation, migration and
  completion, so each stage is a child span of the request's root.

Tracing is free when off: ``TPU_DRA_TRACE=0`` makes :func:`span` return
one shared no-op object and every recorder call a no-op.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from typing import List, Optional

TRACE_ENV = "TPU_DRA_TRACE"

# Default ring size: ~4k spans is minutes of a busy process's lifecycle
# at a few hundred bytes each — bounded memory.
DEFAULT_RING_SPANS = 4096


def _enabled_from_env() -> bool:
    return os.environ.get(TRACE_ENV, "1") not in ("0", "false", "off")


_enabled = _enabled_from_env()


def enabled() -> bool:
    """Whether tracing is on (module-level flag; ``TPU_DRA_TRACE=0``
    kills it at import, :func:`set_enabled` flips it for tests)."""
    return _enabled


def set_enabled(on: bool) -> bool:
    """Flip the module flag; returns the previous value (callers
    restore it — tests use this instead of re-importing with a
    different env)."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def _ids(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class SpanContext:
    """The propagated identity of a span: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def encode(self) -> str:
        """The wire format: ``<trace_id>:<span_id>``."""
        return f"{self.trace_id}:{self.span_id}"

    @staticmethod
    def decode(raw: str) -> Optional["SpanContext"]:
        """Parse the wire format; None on anything malformed — a
        corrupted context must degrade to 'untraced', never crash."""
        if not raw or ":" not in raw:
            return None
        trace_id, _, span_id = raw.partition(":")
        if not trace_id or not span_id:
            return None
        return SpanContext(trace_id, span_id)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"SpanContext({self.encode()})"


class Span:
    """One timed stage. ``t0``/``t1`` are monotonic; ``wall0`` anchors
    the monotonic window to the wall clock so recorders from different
    processes stitch on a shared axis. Mutation is single-writer (the
    thread that opened the span); the recorder copies on add."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "t0", "t1",
        "wall0", "attrs", "status", "events", "_token",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: str = "",
        attrs: Optional[dict] = None,
    ):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.monotonic()
        self.wall0 = time.time()
        self.t1: Optional[float] = None
        self.attrs: dict = dict(attrs) if attrs else {}
        self.status = "ok"
        self.events: List[dict] = []
        self._token = None

    # --- mutation (owning thread only) ---

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def event(self, name: str, **attrs) -> None:
        """Append a point-in-time marker."""
        ev = {"name": name, "t": time.monotonic() - self.t0}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)

    def set_status(self, status: str) -> None:
        self.status = status

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def end(self) -> None:
        if self.t1 is None:
            self.t1 = time.monotonic()
            RECORDER.add(self)

    # --- context-manager protocol (installs as the ambient span) ---

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        if exc_type is not None and self.status == "ok":
            self.status = f"error: {exc_type.__name__}"
        self.end()
        return None

    # --- export ---

    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else time.monotonic()) - self.t0

    def to_dict(self) -> dict:
        return {
            "pid": os.getpid(),
            "name": self.name,
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "wall0": self.wall0,
            "dur_s": self.duration_s(),
            "status": self.status,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }


class _NoopSpan:
    """The shared do-nothing span handed out while tracing is off (and
    as the ambient default). Every mutator is a no-op; ``context()``
    returns None so propagation sites skip it."""

    __slots__ = ()

    def set_attr(self, key: str, value) -> None:
        pass

    def event(self, name: str, **attrs) -> None:
        pass

    def set_status(self, status: str) -> None:
        pass

    def context(self) -> None:
        return None

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP_SPAN = _NoopSpan()

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "tpu_dra_torch_trace_span", default=NOOP_SPAN
)


def current():
    """The ambient span (``NOOP_SPAN`` when none is open) — the
    :func:`~tpu_dra_torch.infra.deadline.current` idiom for trace
    context."""
    return _CURRENT.get()


def span(
    name: str,
    attrs: Optional[dict] = None,
    ctx: Optional[SpanContext] = None,
    root: bool = False,
):
    """Open a span (use as a context manager, or call ``.end()``).

    Parenting, in precedence order: an explicit ``ctx`` (the new span
    joins THAT trace as a child of the encoded span); else the
    thread-ambient current span; else a fresh root trace. ``root=True``
    skips the ambient parent.

    When tracing is off this returns the shared :data:`NOOP_SPAN` —
    one attribute load and one identity check, no allocation.
    """
    if not _enabled:
        return NOOP_SPAN
    if ctx is not None:
        return Span(name, ctx.trace_id, _ids(8), parent_id=ctx.span_id,
                    attrs=attrs)
    if not root:
        cur = _CURRENT.get()
        if cur is not NOOP_SPAN and isinstance(cur, Span):
            return Span(name, cur.trace_id, _ids(8),
                        parent_id=cur.span_id, attrs=attrs)
    return Span(name, _ids(16), _ids(8), attrs=attrs)


def new_ctx() -> Optional[SpanContext]:
    """Mint a fresh root context (the serving tier's per-Request
    identity, assigned at submit and threaded through dispatch /
    evacuation / completion). None while tracing is off — every
    consumer treats a None ctx as 'untraced'."""
    if not _enabled:
        return None
    return SpanContext(_ids(16), _ids(8))


def record_span(
    name: str,
    t0: float,
    t1: float,
    ctx: Optional[SpanContext] = None,
    self_ctx: Optional[SpanContext] = None,
    wall0: Optional[float] = None,
    attrs: Optional[dict] = None,
    status: str = "ok",
) -> None:
    """Record a RETROACTIVE span from already-taken monotonic stamps
    (the serving tier knows a request's dispatch/first-token times only
    when the completion surfaces — re-timing them live would mean
    touching the engine hot loop). ``ctx`` parents the new span;
    ``self_ctx`` instead fixes the span's OWN identity (a pre-minted
    per-request root). ``wall0`` anchors ``t0`` to the wall clock; when
    omitted it is derived from now."""
    if not _enabled:
        return
    now_m = time.monotonic()
    if self_ctx is not None:
        s = Span(name, self_ctx.trace_id, self_ctx.span_id, attrs=attrs)
    elif ctx is not None:
        s = Span(name, ctx.trace_id, _ids(8), parent_id=ctx.span_id,
                 attrs=attrs)
    else:
        s = Span(name, _ids(16), _ids(8), attrs=attrs)
    s.t0 = t0
    s.t1 = t1
    s.wall0 = wall0 if wall0 is not None else (time.time() - (now_m - t0))
    s.status = status
    RECORDER.add(s)


# --- the per-process flight recorder -----------------------------------


class FlightRecorder:
    """Bounded ring of FINISHED spans. Never blocks the caller beyond a
    short lock, never grows past ``capacity``: when full the oldest
    span is dropped and ``trace_spans_dropped_total`` bumps on the
    bound metrics (plus an internal counter even unbound)."""

    def __init__(self, capacity: int = DEFAULT_RING_SPANS, metrics=None):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: List[dict] = []
        self._head = 0  # index of the oldest entry once the ring wrapped
        self.dropped = 0
        self._metrics = metrics

    def bind_metrics(self, metrics) -> None:
        """Late-bind the process's metrics object (duck-typed: ``inc``)."""
        self._metrics = metrics

    def add(self, span: Span) -> None:
        if not _enabled:
            return
        entry = span.to_dict()
        dropped_one = False
        with self._lock:
            if len(self._ring) < self.capacity:
                self._ring.append(entry)
            else:
                self._ring[self._head] = entry
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1
                dropped_one = True
        if dropped_one and self._metrics is not None:
            # Outside the ring lock; the metrics object has its own.
            self._metrics.inc("trace_spans_dropped_total")

    def spans(self) -> List[dict]:
        """Oldest-first snapshot."""
        with self._lock:
            return self._ring[self._head:] + self._ring[: self._head]

    def clear(self) -> None:
        with self._lock:
            self._ring = []
            self._head = 0
            self.dropped = 0


# The process-global recorder every span lands in.
RECORDER = FlightRecorder()


def reset_for_tests(capacity: int = DEFAULT_RING_SPANS) -> None:
    """Clear the global recorder and restore the env-derived enabled
    flag (test isolation)."""
    global _enabled
    RECORDER.clear()
    RECORDER.capacity = capacity
    RECORDER.bind_metrics(None)
    _enabled = _enabled_from_env()
