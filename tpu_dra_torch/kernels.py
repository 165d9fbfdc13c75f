"""Build, load and count the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Builds happen at first
use, from the sources in this checkout, into ``build/torch_kernels/``
at the repository root; a library's file name carries a digest of its
sources and flags, so an edited source rebuilds and an unchanged one is
reused. :func:`build` compiles every missing library at once, one
``nvcc`` process per source, all started together.

``LAUNCHES`` holds one counter per kernel wrapper: the wrapper adds one
where it launches its kernel and nowhere else, so a run can show that a
path went through the kernels (``reset_launches`` before, read after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = ("paged_decode.cu", "decode_mlp.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

LAUNCHES = {"paged_decode_attention": 0, "decode_mlp": 0}

_LOCK = threading.Lock()
_LIBS: dict = {}
_FUNCS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the port's "
        "CUDA kernels build from source at first use"
    )


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest(source)}.so"


def build() -> dict:
    """Compile every source whose library is missing, in parallel.
    Returns ``{source: {"seconds", "log", "cached"}}``; the ptxas report
    (registers, shared memory, spills) is in ``log``. Raises
    RuntimeError naming the failed sources."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    report = {}
    for source in SOURCES:
        target = library_path(source)
        if target.exists():
            report[source] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, target, time.perf_counter(),
        )
    failed = []
    for source, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{source} (rc {proc.returncode}):\n{log[-4000:]}")
            continue
        os.replace(tmp, target)
        report[source] = {"seconds": seconds, "log": log, "cached": False}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def function(source: str, name: str, argtypes: list):
    """The C entry ``name`` of ``source``'s library (built on first use),
    with its argument types declared and an int (cudaError_t) result."""
    key = (source, name)
    with _LOCK:
        fn = _FUNCS.get(key)
        if fn is None:
            lib = _LIBS.get(source)
            if lib is None:
                if not library_path(source).exists():
                    build()
                lib = ctypes.CDLL(str(library_path(source)))
                _LIBS[source] = lib
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FUNCS[key] = fn
        return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
