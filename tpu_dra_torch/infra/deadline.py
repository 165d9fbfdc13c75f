"""Go-context-style deadline/cancellation budgets.

A copy of ``tpu_dra/infra/deadline.py`` (framework-free; the port
imports nothing of the JAX package). The serving tier's stuck-step
watchdog is a :class:`Budget` (``serving/router.py`` ``_stalled``).

Reference analog: client-go threads a ``context.Context`` from every
kubelet RPC down through the clientset, rate limiters, and lock
acquisition, so a slow or partitioned apiserver consumes *budget*
instead of wall-clock inside a kubelet-facing call. Python has no
ambient context, so this module provides the same contract explicitly:

- :class:`Budget` — a deadline (relative timeout) plus a stop event.
  ``check()`` raises a typed **retriable** error on expiry/cancel;
  ``sleep()`` is the stop-aware, budget-capped replacement for
  ``time.sleep`` in retry loops (it refuses to start a wait the budget
  cannot cover — the attempt after it could never run anyway);
  ``pause()`` is the non-raising variant for poll loops that re-check
  their own conditions.
- A **thread-local current budget** (:func:`current` / ``Budget.
  active()``): a caller activates its budget around a unit of work and
  everything nested underneath consults ``current()`` without every
  intermediate signature growing a parameter. This is the pragmatic
  Python analog of Go's implicit ctx plumbing for a stack where each
  request is served by one thread.

``BudgetExceeded`` subclasses :class:`TimeoutError` on purpose: a
caller treats the resulting error as retriable.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional


class BudgetExceeded(TimeoutError):
    """The operation's deadline budget ran out. Retriable: the caller
    is expected to retry with a fresh budget."""

    retriable = True


class BudgetCancelled(BudgetExceeded):
    """The budget's stop event fired (component shutdown). Kept a
    subclass of :class:`BudgetExceeded` so every ``except
    BudgetExceeded`` path treats shutdown like expiry: give up the
    operation promptly and report retriable."""


class Budget:
    """A deadline + stop-event pair, the unit of time accounting.

    ``timeout=None`` means unbounded (only the stop event can end it).
    Budgets nest: :meth:`child` returns a budget whose deadline is the
    MIN of the parent's and the child's own — a sub-step can tighten
    the deadline, never extend it.
    """

    def __init__(
        self,
        timeout: Optional[float] = None,
        stop: Optional[threading.Event] = None,
        name: str = "",
    ):
        self.name = name
        self.stop = stop if stop is not None else threading.Event()
        self._deadline: Optional[float] = (
            time.monotonic() + timeout if timeout is not None else None
        )

    # --- introspection ---

    def deadline(self) -> Optional[float]:
        """Absolute monotonic deadline (None = unbounded)."""
        return self._deadline

    def remaining(self) -> Optional[float]:
        """Seconds left (clamped at 0.0); None when unbounded."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def expired(self) -> bool:
        return self._deadline is not None and time.monotonic() >= self._deadline

    def cancelled(self) -> bool:
        return self.stop.is_set()

    def _label(self, what: str) -> str:
        parts = [p for p in (self.name, what) if p]
        return " ".join(parts) or "operation"

    # --- enforcement ---

    def check(self, what: str = "") -> None:
        """Raise the typed retriable error if cancelled or expired."""
        if self.cancelled():
            raise BudgetCancelled(f"cancelled while {self._label(what)}")
        if self.expired():
            raise BudgetExceeded(
                f"deadline budget exhausted while {self._label(what)}"
            )

    def sleep(self, seconds: float, what: str = "") -> None:
        """Retry-loop wait: stop-aware and budget-capped.

        Refuses (raises :class:`BudgetExceeded`) when the remaining
        budget cannot cover the wait — sleeping out the tail of a
        budget before an attempt that can never run just delays the
        caller's retriable error. Raises :class:`BudgetCancelled` when
        the stop event fires during the wait.
        """
        self.check(what)
        rem = self.remaining()
        if rem is not None and seconds > rem:
            raise BudgetExceeded(
                f"deadline budget cannot cover a {seconds:.1f}s retry "
                f"wait while {self._label(what)} ({rem:.1f}s left)"
            )
        if self.stop.wait(seconds):
            raise BudgetCancelled(f"cancelled while {self._label(what)}")

    def pause(self, seconds: float) -> None:
        """Poll-loop wait: never raises; wakes early on stop/expiry.

        For loops that re-check their own condition each iteration
        (flock polling, readiness probes) and raise via :meth:`check`
        at the top of the next pass.
        """
        rem = self.remaining()
        if rem is not None:
            seconds = min(seconds, rem)
        if seconds > 0:
            self.stop.wait(seconds)

    def child(self, timeout: Optional[float] = None, name: str = "") -> "Budget":
        """A sub-budget sharing this budget's stop event, with a
        deadline no later than this budget's."""
        b = Budget(timeout=timeout, stop=self.stop, name=name or self.name)
        if self._deadline is not None and (
            b._deadline is None or b._deadline > self._deadline
        ):
            b._deadline = self._deadline
        return b

    # --- thread-local current budget ---

    @contextmanager
    def active(self) -> Iterator["Budget"]:
        """Install this budget as the calling thread's current budget
        for the duration of the block (restoring the previous one on
        exit), so nested layers reach it via :func:`current`."""
        prev = getattr(_ACTIVE, "budget", None)
        _ACTIVE.budget = self
        try:
            yield self
        finally:
            _ACTIVE.budget = prev


_ACTIVE = threading.local()

# The ambient default: unbounded, and its stop event is never set. Poll
# loops waiting on UNLIMITED.stop behave exactly like time.sleep.
UNLIMITED = Budget()


def current() -> Budget:
    """The calling thread's active budget (``UNLIMITED`` when none).

    Layers that can stall consult this instead of sleeping
    unconditionally, so the outer budget bounds every wait nested
    underneath it.
    """
    return getattr(_ACTIVE, "budget", None) or UNLIMITED
