"""Weight-only int8 matmul: ``x @ dequant(w_q, scale)``.

Counterpart of ``tpu_dra/workloads/ops/int8mm.py``:

- **cuda**: a hand-written Hopper kernel, the port of the Pallas
  ``_kernel``, at every shape. ``_int8mm_route`` picks it before the
  launch, from the shapes, dtype and alignment alone:

  - ``"gemv_sm90"``, bf16 with M <= 128 (decode, M = slot count),
    K % 4 == 0, N % 16 == 0, x 8-byte and w_q 16-byte aligned (every
    decode projection and lm_head of an engine of up to 128 slots): the
    tensor-core GEMV of ``csrc/int8mm_gemv_sm90.cu`` (mma.sync at
    M <= 16, wgmma at 17 <= M <= 128: 4, 8 or 16 planes of 8 rows),
    planned by :func:`gemv_sm90_plan`;
  - ``"gemv"``, any other M <= 16 (fp32, odd shapes): the
    weight-streaming kernel of ``csrc/int8mm.cu``;
  - ``"sm90"``, bf16 with M > 16 that the GEMV does not take (M > 128,
    or off its alignment), K % 8 == 0, N % 16 == 0 and x, w_q 16-byte
    aligned (every prefill projection and the generate lm_head): the
    wgmma tile of ``csrc/int8mm_sm90.cu``;
  - ``"wmma"``, any other bf16 shape with M > 16: the WMMA tile of
    ``csrc/int8mm.cu``;
  - ``"sgemm"``, fp32 with M > 16: the CUDA-core tile of
    ``csrc/int8mm.cu``.

  bf16 or fp32 activations times the exactly converted int8 weights,
  fp32 accumulation, the per-column scale once on the fp32 sum, one
  rounding;
- **torch**: the twin of ``_xla_int8_matmul`` — the product in x's
  dtype, then times the scale cast to x's dtype;
- **reference**: fp32 ``x @ dequantize_weight``.

``impl="auto"`` launches the kernel for CUDA tensors and takes
``"torch"`` for CPU tensors; a CUDA tensor never falls back. Unlike the
JAX package, which keeps its Pallas kernel opt-in and runs it only on
shapes that tile 128 x 1024 x 1024, no switch and no shape chooses the
plain product on the card. ``_LAST_INT8MM_IMPL`` records the impl of the
latest call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpu_dra_torch import kernels

_LAST_INT8MM_IMPL = None

# The impl ``generate._mm`` asks for on int8 weight-only leaves. "auto"
# everywhere; chip_smoke.py sets it to compare one decode step across
# impls.
MM_IMPL = "auto"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The weight-streaming kernel takes up to 16 rows; its K splits aim at
# this many CTAs per SM, while keeping the fp32 partials' traffic
# (written once, read once) under an eighth of the weight bytes. The
# tensor-core GEMV takes up to 128 (16 planes of 8 rows).
_GEMV_MAX_ROWS = 16
_GEMV_SM90_MAX_ROWS = 128
_CTAS_PER_SM = 4
_K_CHUNK = 256  # csrc/int8mm.cu kChunk
_SM_COUNTS: dict = {}

_INT8MM_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
    ctypes.c_void_p,
]
_INT8MM_SM90_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_void_p,
]
_INT8_GEMV_SM90_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p,
]

# The tensor-core decode GEMV (csrc/int8mm_gemv_sm90.cu): CTAs of 8
# warps on blocks of 128-column slabs, stepping K 16 rows at a time,
# clusters of at most 8 CTAs (the portable size). At 8 planes (wgmma) a
# warp's accumulators take 32 registers a slab of the CTA's block, so a
# block is at most 4 slabs there; at 16 planes 64 a slab, at least 2
# tiles a warp, so at most 2 slabs.
_GEMV_SM90_WARPS = 8
_GEMV_SM90_COLS = 128
_GEMV_SM90_MAX_CLUSTER = 8
_GEMV_SM90_WIDTHS = {1: (1, 2, 4, 8), 2: (1, 2, 4, 8), 4: (1, 2, 4, 8),
                     8: (1, 2, 4), 16: (1, 2)}

def reference_int8_matmul(x, w_q, scale):
    """fp32 oracle: x @ (w_q * scale), rounded once to x's dtype."""
    w = w_q.to(torch.float32) * scale.to(torch.float32).reshape(1, -1)
    return (x.to(torch.float32) @ w).to(x.dtype)


def _torch_int8_matmul(x, w_q, scale):
    y = x @ w_q.to(x.dtype)
    return y * scale.to(x.dtype)


def _sm_count(device) -> int:
    index = device.index if device.index is not None else (
        torch.cuda.current_device()
    )
    sms = _SM_COUNTS.get(index)
    if sms is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _SM_COUNTS[index] = sms
    return sms


def _gemv_plan(m: int, k: int, n: int, w_ptr: int, device) -> tuple:
    """(rows_tile, vec, splits) for the weight-streaming kernel: the
    smallest row tile that covers m (8 above 4, tiled over m), the
    widest per-lane column word that divides n and w's alignment within
    64 accumulators a thread, and enough K splits to fill the card."""
    rows_tile = next(t for t in (1, 2, 4, 8) if m <= t or t == 8)
    vec = next(
        v for v in (16, 8, 4, 1)
        if v * rows_tile <= 64 and n % v == 0 and w_ptr % v == 0
    )
    col_tiles = -(-n // (32 * vec))
    row_tiles = -(-m // rows_tile)
    want = -(-(_CTAS_PER_SM * _sm_count(device)) // (col_tiles * row_tiles))
    cap = max(1, k // (64 * m))
    splits = max(1, min(want, cap, -(-k // _K_CHUNK)))
    return rows_tile, vec, splits


class GemvPlan(NamedTuple):
    """How the tensor-core GEMV covers x [M, K] times w_q [K, N]: grid
    (cluster, col_ctas), a cluster's CTAs along K; a CTA's block of
    warps_n 128-column slabs, its ring's stages warps_k k16 steps each.
    At 1 and 2 planes (mma.sync) warp w takes slab w / warps_k and step
    w % warps_k of every stage; at 4, 8 and 16 (wgmma) a warp carries
    ``tiles`` 16-column tiles (its warpgroup's 64-column blocks) over
    16 tiles columns, the two warpgroups splitting the block's columns
    (warps_n >= 2) or each stage's steps (warps_n = 1)."""

    planes: int  # 8-row planes of x: 1, 2, 4, 8, 16 for M <= 8 ... 128
    warps_n: int  # 128-column slabs a CTA
    warps_k: int  # k16 steps a stage
    cluster: int  # CTAs a cluster, splitting K
    col_ctas: int  # clusters
    cta_steps: int  # k16 steps a CTA (rank r: [r * cta_steps, +cta_steps))
    stages: int  # stages a CTA walks
    tiles: int  # 16-column tiles a warp carries a k16 step

    @property
    def ctas(self) -> int:
        return self.cluster * self.col_ctas


def gemv_sm90_planes(m: int) -> int:
    """8-row planes of x the tensor-core GEMV pads M to: 1, 2, 4, 8 or
    16."""
    return next(p for p in (1, 2, 4, 8, 16) if m <= 8 * p or p == 16)


@functools.lru_cache(maxsize=None)
def gemv_sm90_plan(m: int, k: int, n: int, sm_count: int) -> GemvPlan:
    """The tensor-core GEMV's plan, from the shapes and the SM count
    alone (no device value is read).

    One wave of at most one CTA an SM: on the H100 a CTA streams W at a
    rate its SM sets, so a second CTA on an SM or a second wave only
    lengthens the call. The most CTAs under that cap win; then no
    cluster (its reduction costs cluster barriers and reads across
    SMs), then the widest column blocks (longer runs of each W row a
    stage). A grid of clusters fits only three quarters of the SMs: a
    cluster's CTAs must share a GPC, and fuller grids doubled CTAs up
    on SMs or left clusters waiting (int8mm_ablation.py, phase gemv).
    Column blocks beyond one wave take the widest CTAs the planes allow
    (8 slabs, 4 at 8 planes, 2 at 16) and no cluster."""
    planes = gemv_sm90_planes(m)
    widths = _GEMV_SM90_WIDTHS[planes]
    slabs = -(-n // _GEMV_SM90_COLS)
    steps = -(-k // 16)
    best = None
    for warps_n in widths:
        col_ctas = -(-slabs // warps_n)
        for cluster in range(1, min(_GEMV_SM90_MAX_CLUSTER, steps) + 1):
            cap = sm_count if cluster == 1 else 3 * sm_count // 4
            if col_ctas * cluster > cap:
                break
            key = (col_ctas * cluster, cluster == 1, warps_n)
            if best is None or key > best[0]:
                best = (key, warps_n, cluster)
    warps_n, cluster = (widths[-1], 1) if best is None else best[1:]
    cta_steps = -(-steps // cluster)
    cluster = -(-steps // cta_steps)  # no rank without steps
    warps_k = _GEMV_SM90_WARPS // warps_n
    return GemvPlan(
        planes=planes, warps_n=warps_n, warps_k=warps_k, cluster=cluster,
        col_ctas=-(-slabs // warps_n), cta_steps=cta_steps,
        stages=-(-cta_steps // warps_k),
        tiles=8 if planes <= 2 else max(2, warps_n),
    )


def _int8mm_route(x, w_q) -> str:
    """The kernel that serves x [M, K] times w_q [K, N] on the card:
    "gemv_sm90" (bf16, M <= 128, K % 4 == 0, N % 16 == 0, x 8-byte and
    w_q 16-byte aligned), "gemv" (any other M <= 16), "sgemm" (fp32),
    "sm90" (bf16 whose 16-byte copies the wgmma tile takes: K % 8 == 0,
    N % 16 == 0, x and w_q 16-byte aligned) or "wmma" (any other bf16
    shape)."""
    m, k = x.shape
    n = w_q.shape[1]
    if (m <= _GEMV_SM90_MAX_ROWS and x.dtype == torch.bfloat16
            and k % 4 == 0 and n % 16 == 0 and x.data_ptr() % 8 == 0
            and w_q.data_ptr() % 16 == 0):
        return "gemv_sm90"
    if m <= _GEMV_MAX_ROWS:
        return "gemv"
    if x.dtype == torch.float32:
        return "sgemm"
    if (k % 8 == 0 and n % 16 == 0 and x.data_ptr() % 16 == 0
            and w_q.data_ptr() % 16 == 0):
        return "sm90"
    return "wmma"


def _sm90_rows(m: int, n: int, device) -> int:
    """The wgmma kernel's CTA tile rows: 256 (four warpgroups share each
    converted W tile) once that grid fills half the card, else 128 (twice
    the CTAs on a small grid)."""
    tiles = -(-m // 256) * -(-n // 128)
    return 256 if m > 128 and 2 * tiles >= _sm_count(device) else 128


def _cuda_int8_matmul(x, w_q, scale):
    """Launch the route's kernel (csrc/int8mm_sm90.cu for "sm90",
    csrc/int8mm_gemv_sm90.cu for "gemv_sm90", csrc/int8mm.cu for the
    rest) on x's stream: x [M, K] bf16 or fp32,
    w_q [K, N] int8, scale [N] f32, all contiguous on one device;
    raises on anything else."""
    m, k = x.shape
    n = w_q.shape[1]
    tensors = (x, w_q, scale)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("impl='cuda' needs every input on one CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"impl='cuda' takes bf16 or fp32 activations, got {x.dtype}"
        )
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(
            f"impl='cuda' takes int8 weights and f32 scales, got "
            f"{w_q.dtype}/{scale.dtype}"
        )
    if k < 1:
        raise ValueError("impl='cuda' needs K >= 1")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("impl='cuda' needs contiguous inputs")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    route = _int8mm_route(x, w_q)
    if route == "sm90":
        fn = kernels.function(
            "int8mm_sm90.cu", "tpu_int8_matmul_sm90", _INT8MM_SM90_ARGTYPES
        )
        err = fn(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), m, k, n, _sm90_rows(m, n, x.device), stream)
        kernels.check(err, "int8mm_sm90")
        kernels.count("int8mm_sm90", "int8mm")
        return out
    if route == "gemv_sm90":
        plan = gemv_sm90_plan(m, k, n, _sm_count(x.device))
        fn = kernels.function("int8mm_gemv_sm90.cu", "tpu_int8_gemv_sm90",
                              _INT8_GEMV_SM90_ARGTYPES)
        err = fn(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), m, k, n, plan.warps_n, plan.cluster,
                 plan.cta_steps, stream)
        kernels.check(err, "int8mm_gemv_sm90")
        kernels.count("int8mm_gemv_sm90", "int8mm")
        return out
    partial = None
    rows_tile = vec = splits = 1
    if route == "gemv" and m > 0:
        rows_tile, vec, splits = _gemv_plan(m, k, n, w_q.data_ptr(), x.device)
        if splits > 1:
            partial = torch.empty(
                (splits, m, n), dtype=torch.float32, device=x.device
            )
    elif n % 16 == 0 and w_q.data_ptr() % 16 == 0:
        vec = 16
    x_vec = int(k % 8 == 0 and x.data_ptr() % 16 == 0)
    fn = kernels.function("int8mm.cu", "tpu_int8_matmul", _INT8MM_ARGTYPES)
    err = fn(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        _DTYPE_CODES[x.dtype], m, k, n, rows_tile, vec, splits, x_vec,
        stream,
    )
    kernels.check(err, "int8mm")
    kernels.count("int8mm")
    if route == "gemv":
        kernels.count("int8mm_gemv")
    return out


def int8_matmul(x, w_q, scale, impl: str = "auto"):
    """``x @ dequant(w_q, scale)`` over any leading dims of x.

    x [..., K]; w_q int8 [K, N]; scale f32 [1, N] -> [..., N] in x's
    dtype. impl: "auto" | "cuda" | "torch" | "reference".
    """
    lead = tuple(x.shape[:-1])
    k = x.shape[-1]
    if w_q.ndim != 2 or w_q.shape[0] != k or scale.numel() != w_q.shape[1]:
        raise ValueError(
            f"int8_matmul shapes: x {tuple(x.shape)}, w_q "
            f"{tuple(w_q.shape)}, scale {tuple(scale.shape)}"
        )
    n = w_q.shape[1]
    x2 = x.reshape(-1, k)
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    global _LAST_INT8MM_IMPL
    _LAST_INT8MM_IMPL = impl
    if impl == "cuda":
        out = _cuda_int8_matmul(x2, w_q, scale.reshape(-1))
    elif impl == "torch":
        out = _torch_int8_matmul(x2, w_q, scale)
    elif impl == "reference":
        out = reference_int8_matmul(x2, w_q, scale)
    else:
        raise ValueError(f"unknown int8 matmul impl: {impl!r}")
    return out.reshape(*lead, n)
