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
(:func:`count`) where it launches its kernel and nowhere else, so a run
can show that a path went through the kernels (``reset_launches``
before, read after). The counts are exact when several threads launch
at once, as the serving fabric's replica threads do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = (
    "paged_decode.cu", "decode_mlp.cu", "int8mm.cu", "decode.cu",
    "flash_attention.cu", "flash_fwd_sm90.cu", "flash_bwd_sm90.cu",
    "flash_bwd_dq_sm90.cu", "int8mm_sm90.cu", "int8mm_gemv_sm90.cu",
    "decode_mlp_sm90.cu", "sample.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# The paged kernel's int8-pool branch counts apart from its bf16/fp32
# branch, so a run shows which one the path took. "decode_mlp" counts
# every fused decode MLP call, whichever kernel served it;
# "decode_mlp_sm90" counts those of the tensor-core kernel
# (decode_mlp_sm90.cu, bf16 B <= 16), so a run shows how many took that
# route. "flash_fwd" counts
# every flash forward launch, whichever kernel served it;
# "flash_fwd_sm90" counts those of the wgmma kernel (flash_fwd_sm90.cu),
# so a run shows how many took that route; "flash_bwd_dq" and
# "flash_bwd_dq_sm90" (flash_bwd_dq_sm90.cu) likewise for dQ, and
# "flash_bwd_dkv" and "flash_bwd_dkv_sm90" (flash_bwd_sm90.cu) for dK/dV;
# "int8mm" counts every int8 matmul launch, "int8mm_sm90" those of the
# wgmma tile (int8mm_sm90.cu), "int8mm_gemv_sm90" those of the
# tensor-core decode GEMV (int8mm_gemv_sm90.cu, bf16 M <= 64) and
# "int8mm_gemv" those of int8mm.cu's weight-streaming GEMV (fp32 and
# the shapes int8mm_gemv_sm90.cu does not take, M <= 16);
# "sample_pick" counts the fused temperature / top-k pick (sample.cu).
# The decode MLP's halves on a model shard count by source, one counter
# a kernel: "decode_mlp_gate_up" and "decode_mlp_down" (decode_mlp.cu),
# "decode_mlp_sm90_gate_up" and "decode_mlp_sm90_down"
# (decode_mlp_sm90.cu); a fused call counts none of them.
LAUNCHES = {
    "paged_decode_attention": 0,
    "paged_decode_attention_int8": 0,
    "decode_mlp": 0,
    "decode_mlp_sm90": 0,
    "decode_mlp_gate_up": 0,
    "decode_mlp_down": 0,
    "decode_mlp_sm90_gate_up": 0,
    "decode_mlp_sm90_down": 0,
    "int8mm": 0,
    "int8mm_sm90": 0,
    "int8mm_gemv_sm90": 0,
    "int8mm_gemv": 0,
    "decode_attention": 0,
    "flash_fwd": 0,
    "flash_fwd_sm90": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dq_sm90": 0,
    "flash_bwd_dkv": 0,
    "flash_bwd_dkv_sm90": 0,
    "sample_pick": 0,
}

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIBS: dict = {}
_FUNCS: dict = {}


def count(*names: str) -> None:
    """Add one to each named launch counter. A bare ``+= 1`` is a load,
    an add and a store, so two threads launching at once could lose a
    count; the lock keeps every count exact."""
    with _COUNT_LOCK:
        for name in names:
            LAUNCHES[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
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
            log_path = target.with_suffix(".log")
            log = log_path.read_text() if log_path.exists() else ""
            report[source] = {"seconds": 0.0, "log": log, "cached": True}
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


def ptxas_report(log: str) -> dict:
    """Per kernel instantiation of an ``nvcc -Xptxas -v`` log:
    ``{name: {"registers", "smem_bytes", "spill_stores"}}``, names
    demangled with c++filt where the toolkit's host has it."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "smem_bytes": 0,
                         "spill_stores": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(m.group(1)) if m else 0
    cxxfilt = shutil.which("c++filt")
    if not (out and cxxfilt):
        return out
    names = list(out)
    plain = subprocess.run(
        [cxxfilt], input="\n".join(names), capture_output=True, text=True,
    ).stdout.splitlines()
    if len(plain) != len(names):
        return out
    return {p: out[n] for n, p in zip(names, plain)}


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
