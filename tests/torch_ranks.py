"""Launch the port's workloads as gloo ranks on the CPU, one process a
rank, for the tests of tpu_dra_torch's bootstrap, smokes and
collectives. Every launch has its own timeout: a rank still running at
the deadline is killed, and every process is reaped before the caller
asserts anything."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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


def start(argvs, envs, cwd=None):
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
    return t0, procs


def wait(started, timeout: float = 120.0):
    """Wait for the processes :func:`start` began, up to ``timeout``
    seconds in total from their start, killing any still running.
    Returns [(returncode, stdout, stderr, seconds)] in order; a killed
    process reports returncode None."""
    t0, procs = started
    out = []
    for p in procs:
        left = max(0.1, timeout - (time.monotonic() - t0))
        try:
            so, se = p.communicate(timeout=left)
            out.append((p.returncode, so, se, time.monotonic() - t0))
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            out.append((None, so, se, time.monotonic() - t0))
    for p in procs:  # reaped above; make sure none outlives the test
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
