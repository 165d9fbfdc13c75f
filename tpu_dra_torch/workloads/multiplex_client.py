"""Client side of per-process chip multiplexing.

Copy of ``tpu_dra/workloads/multiplex_client.py`` (the port imports
nothing of the JAX package); it carries its own :data:`SOCKET_NAME`,
the name the multiplex daemon (``tpu_dra/plugin/multiplexd.py``)
listens on.

Workload processes in a shared-claim container cooperate through the
claim's control daemon: acquire the chip lease before running device
work, release it after. CDI injects
``TPU_MULTIPLEX_SOCKET_DIR`` + ``TPU_PROCESS_MULTIPLEXING=true`` into
multiplexed containers, so ``auto_lease()`` is a no-op everywhere else —
workloads can call it unconditionally.

    from tpu_dra_torch.workloads.multiplex_client import auto_lease

    with auto_lease() as lease:
        ...  # device work; lease is None when not multiplexed
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# The daemon's socket file inside TPU_MULTIPLEX_SOCKET_DIR.
SOCKET_NAME = "multiplexd.sock"


@dataclass
class Lease:
    chips: List[str] = field(default_factory=list)
    hbm_limits: Dict[str, str] = field(default_factory=dict)
    max_hold_seconds: float = 0.0


class LeaseCooldownError(RuntimeError):
    """Acquire refused: this client was revoked for hogging and is in its
    post-revocation cooldown. ``retry_after`` says when to try again."""

    def __init__(self, retry_after: float, resp: dict):
        super().__init__(f"lease refused for {retry_after}s: {resp}")
        self.retry_after = retry_after


class MultiplexClient:
    def __init__(self, socket_dir: str, client_name: Optional[str] = None):
        self.socket_path = os.path.join(socket_dir, SOCKET_NAME)
        self.client_name = client_name or f"pid-{os.getpid()}"
        self._sock: Optional[socket.socket] = None
        self._file = None
        # Times maybe_yield() actually rotated the lease (released and
        # re-acquired because a peer was waiting at the quantum).
        self.rotations = 0
        # Set when the daemon revoked our lease (async "revoked" event);
        # cleared on the next acquire/release.
        self.revoked = False
        # Lifetime count of revocations this client suffered.
        self.revocations = 0

    def _rpc(self, msg: dict) -> dict:
        if self._sock is None:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.connect(self.socket_path)
            self._file = self._sock.makefile("rb")
        self._sock.sendall(json.dumps(msg).encode() + b"\n")
        while True:
            line = self._file.readline()
            if not line:
                raise ConnectionError("multiplex daemon closed the connection")
            obj = json.loads(line)
            # Async server→client pushes (revocation notices) may arrive
            # interleaved with responses; fold them into client state and
            # keep reading for the actual response.
            if "event" in obj:
                self._handle_event(obj)
                continue
            return obj

    def _handle_event(self, obj: dict) -> None:
        if obj.get("event") == "revoked":
            self.revoked = True
            self.revocations += 1

    def acquire(self) -> Lease:
        """Blocks until this process holds the chip lease. Raises
        :class:`LeaseCooldownError` when refused because a prior hold was
        revoked (the daemon names the retry-after)."""
        resp = self._rpc({"op": "acquire", "client": self.client_name})
        if not resp.get("ok"):
            if "retryAfterSeconds" in resp:
                raise LeaseCooldownError(resp["retryAfterSeconds"], resp)
            raise RuntimeError(f"lease acquire failed: {resp}")
        self.revoked = False
        self._acquired_at = time.monotonic()
        body = resp["lease"]
        return Lease(
            chips=body.get("chips", []),
            hbm_limits=body.get("hbmLimits", {}),
            max_hold_seconds=body.get("maxHoldSeconds", 0.0),
        )

    def maybe_yield(self, lease: Lease) -> Lease:
        """Cooperative time-slice rotation: call between work steps. When
        this process has held the chip past the lease quantum AND another
        client is waiting, release and re-acquire (FIFO puts us behind the
        waiters); otherwise keep the lease. The quantum comes from the
        claim's time-slice interval (or compute-share %) via the daemon —
        this is where a ``sharing: timeSlicing`` claim actually changes
        scheduling behavior."""
        if lease.max_hold_seconds <= 0:
            return lease
        held = time.monotonic() - getattr(self, "_acquired_at", 0.0)
        if not self.revoked and held < lease.max_hold_seconds:
            return lease
        if self.revoked:
            # The daemon already took the lease (we out-held the quantum,
            # e.g. one slow step); nothing to release — re-acquire, waiting
            # out the cooldown if the daemon imposes one.
            self.revoked = False
            lease = self._acquire_through_cooldown()
            self.rotations += 1
            return lease
        waiting = self.status().get("waiting", 0)
        if self.revoked:
            # The status() read drained a revocation event: the lease is
            # already gone, skip the release.
            self.revoked = False
            lease = self._acquire_through_cooldown()
            self.rotations += 1
            return lease
        if waiting == 0:
            # Alone on the chip: restart the quantum rather than paying a
            # pointless release/acquire round-trip.
            self._acquired_at = time.monotonic()
            return lease
        self.release()
        # A revocation can land between the status() read and the release
        # (the daemon's sweeper races us at the quantum boundary); the
        # re-acquire must wait out any cooldown rather than leak a
        # LeaseCooldownError from a cooperative rotation.
        lease = self._acquire_through_cooldown()
        self.rotations += 1
        return lease

    def _acquire_through_cooldown(self) -> Lease:
        while True:
            try:
                return self.acquire()
            except LeaseCooldownError as e:
                time.sleep(min(e.retry_after, 5.0))

    def release(self) -> None:
        was_revoked, self.revoked = self.revoked, False
        resp = self._rpc({"op": "release"})
        if not resp.get("ok"):
            if was_revoked or self.revoked:
                # The daemon revoked us before the release landed; the
                # lease is gone, which is exactly what release wants.
                self.revoked = False
                return
            # The daemon no longer considers us the holder (revoked or
            # double-released) — surface it, silent success would let the
            # workload re-enter device work on stale assumptions.
            raise RuntimeError(f"lease release refused: {resp}")

    def status(self) -> dict:
        return self._rpc({"op": "status"})

    def close(self) -> None:
        if self._sock is not None:
            # Closing the connection releases anything we hold server-side.
            self._sock.close()
            self._sock = None
            self._file = None

    @contextlib.contextmanager
    def lease(self):
        lease = self.acquire()
        try:
            yield lease
        finally:
            self.release()


@contextlib.contextmanager
def auto_lease(environ=os.environ):
    """Hold the chip lease for the block iff this process runs in a
    multiplexed container; yields the Lease or None."""
    if environ.get("TPU_PROCESS_MULTIPLEXING") != "true":
        yield None
        return
    client = MultiplexClient(environ["TPU_MULTIPLEX_SOCKET_DIR"])
    try:
        with client.lease() as lease:
            yield lease
    finally:
        client.close()
