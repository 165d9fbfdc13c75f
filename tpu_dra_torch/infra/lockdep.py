"""Runtime thread-ownership checking for the serving tier's roles.

The part of ``tpu_dra/infra/lockdep.py`` that the serving tier calls,
copied (the port imports nothing of the JAX package): the product hook
:func:`single_owner` and the recorder of who drove each role. The JAX
module's lock-factory shim and its lock-order cycle report are left
out: no test of the port needs them.

Ownership roles: the serving fabric's contract is about *roles*, not
raw thread identity — "the autoscaler ticks on the SAME thread that
drives Router.poll". Product code declares that with
``single_owner(obj, role)`` at each role entry point (Router.poll and
ClaimAutoscaler.tick both declare ``(router, "control")``; a second
distinct thread showing up for the same (object, role) key fails
:func:`check` naming every thread involved).

Zero overhead when off: :func:`single_owner` is a single global read
and a ``None`` check until :func:`install` turns the recorder on.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class LockdepError(AssertionError):
    """An observed ownership violation."""


def _thread_name() -> str:
    """The current thread's name from the registry (no
    threading.current_thread(): that materializes a _DummyThread for an
    unregistered thread)."""
    ident = threading.get_ident()
    t = threading._active.get(ident)
    return t.name if t is not None else f"thread-{ident}"


class _Recorder:
    """Who drove each (object, role) key, guarded by one lock."""

    def __init__(self):
        self._mu = threading.Lock()
        # (id(obj), role) -> {thread_ident: thread_name}; label keeps the
        # object's type for the error message after the obj is gone.
        self.owners: Dict[Tuple[int, str], Dict[int, str]] = {}
        self.owner_labels: Dict[Tuple[int, str], str] = {}

    def note_owner(self, obj, role: str) -> None:
        key = (id(obj), role)
        ident = threading.get_ident()
        with self._mu:
            self.owners.setdefault(key, {})[ident] = _thread_name()
            self.owner_labels.setdefault(
                key, f"{type(obj).__name__} role={role!r}"
            )


_STATE: Optional[_Recorder] = None


def install() -> None:
    """Start recording role owners; idempotent."""
    global _STATE
    if _STATE is None:
        _STATE = _Recorder()


def uninstall() -> None:
    """Drop the recorder."""
    global _STATE
    _STATE = None


def single_owner(obj, role: str) -> None:
    """Declare "the current thread is acting as ``role`` for ``obj``".

    Call at every entry point of a single-owner role (Router.poll and
    ClaimAutoscaler.tick both declare the fabric's control role *keyed
    on the router object*, so an autoscaler ticked from a second thread
    is caught even though each call site is individually consistent).
    No-op unless the recorder is installed.
    """
    rec = _STATE
    if rec is None:
        return
    rec.note_owner(obj, role)


def report() -> dict:
    """The recorded owners as plain data."""
    rec = _STATE
    if rec is None:
        return {"installed": False}
    with rec._mu:
        return {
            "installed": True,
            "owners": [
                {
                    "label": rec.owner_labels[key],
                    "threads": sorted(rec.owners[key].values()),
                }
                for key in sorted(rec.owners, key=lambda k: (k[1], k[0]))
            ],
        }


def check() -> dict:
    """Teardown assertion: every single-owner role was driven by one
    thread. Raises :class:`LockdepError` naming every thread that drove
    a role more than one did; returns :func:`report` otherwise."""
    rec = _STATE
    rep = report()
    if rec is None:
        return rep
    with rec._mu:
        owners = {k: dict(v) for k, v in rec.owners.items()}
        labels = dict(rec.owner_labels)
    problems: List[str] = []
    for key, threads in sorted(owners.items(), key=lambda kv: kv[0][1]):
        if len(threads) > 1:
            problems.append(
                f"single-owner violation: {labels[key]} was driven by "
                f"{len(threads)} threads: "
                + ", ".join(sorted(threads.values()))
            )
    if problems:
        raise LockdepError(
            "runtime lockdep found "
            f"{len(problems)} problem(s):\n  - "
            + "\n  - ".join(problems)
        )
    return rep
