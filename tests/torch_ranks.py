"""Launch the port's workloads as gloo ranks on the CPU, one process a
rank, for the tests of tpu_dra_torch's bootstrap, smokes and
collectives. Every launch has its own timeout: a rank still running at
the deadline is killed, and every process is reaped before the caller
asserts anything.

:func:`free_port` finds a port that is free now; another process can
bind it before the ranks' store does. When a rank's stderr names
EADDRINUSE, :func:`wait` kills the launch's other ranks and starts them
all again on a new port (every argv item and env value that holds the
old one gets the new one), up to RELAUNCHES times; any other failure is
returned as it came. The old port is the one in a ``host:port`` value
of the launch whose port :func:`free_port` handed out.
"""

import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

REPO = Path(__file__).resolve().parent.parent


RELAUNCHES = 3
_HANDED_OUT: set = set()  # ports free_port returned in this process


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    _HANDED_OUT.add(port)
    return port


class Started(NamedTuple):
    """A launch :func:`start` began: what :func:`wait` needs to reap it
    and, on EADDRINUSE, to start it again on another port."""

    t0: float
    procs: list
    argvs: list
    envs: list
    cwd: "str | None"


def _port_in(argvs, envs) -> "str | None":
    """The port the launch's ranks bind: the port of the first
    ``host:port`` argv item or env value whose port :func:`free_port`
    handed out; None if there is none."""
    for text in [a for argv in argvs for a in argv] + [
            v for env in envs for v in env.values()]:
        m = re.fullmatch(r"[\w.\-]+:(\d+)", str(text))
        if m and int(m.group(1)) in _HANDED_OUT:
            return m.group(1)
    return None


def _on_new_port(started: Started) -> Started:
    old = _port_in(started.argvs, started.envs)
    new = f":{free_port()}"
    swap = re.compile(rf":{old}(?!\d)")
    argvs = [[swap.sub(new, a) if isinstance(a, str) else a for a in argv]
             for argv in started.argvs]
    envs = [{k: swap.sub(new, str(v)) for k, v in env.items()}
            for env in started.envs]
    return start(argvs, envs, started.cwd)


def rank_env(rank: int, world: int, coordinator: str, **extra) -> dict:
    """The bootstrap env the slice daemon renders, for one rank."""
    env = {
        "TPU_WORKER_ID": str(rank),
        "JAX_PROCESS_ID": str(rank),
        "JAX_NUM_PROCESSES": str(world),
        "JAX_COORDINATOR_ADDRESS": coordinator,
    }
    env.update({k: str(v) for k, v in extra.items()})
    return env


def start(argvs, envs, cwd=None) -> Started:
    """Start one process per (argv, env) together, without waiting:
    hand the result to :func:`wait`."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("TPU_", "JAX_", "MEGASCALE_", "CD_"))}
    base["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    procs = []
    t0 = time.monotonic()
    for argv, env in zip(argvs, envs):
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env={**base, **env},
            cwd=cwd or str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        ))
    return Started(t0, procs, [list(a) for a in argvs],
                   [dict(e) for e in envs], cwd)


def _kill_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def wait(started: Started, timeout: float = 120.0,
         relaunches: int = RELAUNCHES):
    """Wait for the processes :func:`start` began, up to ``timeout``
    seconds in total from their start, killing any still running.
    Returns [(returncode, stdout, stderr, seconds)] in order; a killed
    process reports returncode None. A rank whose stderr names
    EADDRINUSE restarts the launch on a new port (module docstring),
    with ``timeout`` anew."""
    out = []
    for p in started.procs:
        left = max(0.1, timeout - (time.monotonic() - started.t0))
        try:
            so, se = p.communicate(timeout=left)
            out.append((p.returncode, so, se, time.monotonic() - started.t0))
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            out.append((None, so, se, time.monotonic() - started.t0))
        if ("EADDRINUSE" in (se or "") and relaunches > 0
                and _port_in(started.argvs, started.envs)):
            _kill_all(started.procs)
            return wait(_on_new_port(started), timeout, relaunches - 1)
    for p in started.procs:  # reaped above; make sure none outlives it
        if p.poll() is None:
            p.kill()
            p.wait()
    return out


def launch(argvs, envs, timeout: float = 120.0, cwd=None):
    """Start one process per (argv, env) together; wait for all of them
    up to ``timeout`` seconds in total, killing any still running.
    Returns [(returncode, stdout, stderr, seconds)] in order; a killed
    process reports returncode None."""
    return wait(start(argvs, envs, cwd), timeout)


def last_json(stdout: str) -> str:
    return [ln for ln in stdout.splitlines() if ln.startswith("{")][-1]
