"""Fused decode MLP+norm block: ``x + w_down(silu(w_gate(rms(x))) *
w_up(rms(x)))`` for the s=1 decode step.

Counterpart of ``tpu_dra/workloads/ops/decode_mlp.py``:

- **cuda**: a hand-written Hopper kernel, the port of the Pallas
  ``_decode_mlp_kernel``. ``_decode_mlp_route`` picks it before the
  launch, from the dtypes, shapes and alignment alone:

  - ``"sm90"``, bf16 with d and ffn multiples of 8, x and the weights
    contiguous and 16-byte aligned (every bf16 decode step at
    Llama-3-8B widths): the tensor-core kernel of
    ``csrc/decode_mlp_sm90.cu``, planned by :func:`mlp_sm90_plan` —
    two launches (gate/up with the norm and silu·up, down with the
    residual), weights streamed through an mbarrier ring, the K split
    reduced on chip, 1, 2, 4, 8 or 16 planes of 8 rows: mma.sync at 1
    and 2 (xn resident in gate/up), wgmma at 4, 8 and 16 (an RMS-norm
    launch first, whose xn gate/up streams stage by stage as down
    streams act; at 16 the CTA's two warpgroups split the rows of one
    64-column block);
  - ``"simt"``, everything else (fp32, other shapes):
    ``csrc/decode_mlp.cu`` on CUDA cores — gate/up/act in one launch,
    down as fp32 split partials in a second, the residual reduction in
    a third. fp32 stays here: the tensor cores take no fp32 operands,
    and TF32 would miss the fp32 parity bars the twins hold the port
    to; fp32 is the parity dtype, not a serving one.

  A launch takes at most ``ROW_BLOCKS[route]`` rows: 128 on "sm90"
  (the Pallas body's one pass over the weights for the whole batch, up
  to 128 rows), 64 on "simt". A larger batch runs as consecutive blocks
  of that many rows (:func:`row_blocks`), one launch a block, each a
  full pass over the weights. Within a launch each weight byte is read
  once, no float atomics;
- **torch**: the twin of ``_xla_decode_mlp``, the op chain the decode
  step runs off the card (so CPU parity with the JAX engine holds);
- **reference**: the twin of the naive fp32 oracle
  ``reference_decode_mlp``.

On a decode mesh's model shard (``mesh`` with a model axis above 1:
``w_gate``/``w_up`` hold the rank's ffn columns, ``w_down`` all of them)
the block splits at the gather of ``silu(gate)·up``: the gate/up half
(:func:`mlp_gate_up`) writes the rank's act columns, ``gather_model``
joins them, and the down half (:func:`mlp_down`) adds ``act · w_down``
to x. Each half is a C entry point of both sources: the sm90 gate/up
half is planned as the whole ffn's (``mlp_sm90_plan`` at the unsharded
width), so a rank's act columns are the fused kernel's bit for bit, and
the down half is the fused kernel's down launch, so the output is the
fused kernel's bit for bit too. The plain chain splits alike.

``impl="auto"`` launches the kernel for CUDA tensors and takes
``"torch"`` for CPU tensors; a CUDA tensor never falls back. An int8
weight-only tree takes the plain chain under ``"auto"`` on every device,
as the JAX op does: the fused kernel reads plain kernels, so on the card
such a layer's MLP is three int8mm kernel launches plus elementwise ops
(``impl="cuda"`` on an int8 tree raises). ``_LAST_DECODE_MLP_IMPL``
records the impl of the latest call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from tpu_dra_torch import kernels
from tpu_dra_torch.workloads.ops import int8mm
from tpu_dra_torch.workloads.quantize import dequantize_weight

_LAST_DECODE_MLP_IMPL = None

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Down-projection split count: enough (column tile x split) CTAs to give
# every SM a few, never a split shorter than one 256-row staging chunk.
_CTAS_PER_SM = 4
_SM_COUNTS: dict = {}


def _kernels(mlp: dict):
    """(w_gate, w_up, w_down) plain kernels, or None when the tree holds
    anything else (int8 weight-only leaves)."""
    try:
        ws = tuple(mlp[n]["kernel"] for n in ("w_gate", "w_up", "w_down"))
    except (KeyError, TypeError):
        return None
    if any(w.ndim != 2 for w in ws):
        return None
    return ws


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm as the JAX ``generate._rms`` computes it. The one copy in
    the port: generate.py imports it, so the decode MLP's plain chain
    and the rest of the layer share their numerics."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def _mm(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x @ kernel for either weight form: plain ``{"kernel"}``, or int8
    weight-only ``{"kernel_q", "scale"}`` through ops/int8mm.py (the
    CUDA kernel on the card). The JAX ``generate._mm`` and
    ``decode_mlp._matmul`` in one."""
    if "kernel_q" in w:
        return int8mm.int8_matmul(
            x, w["kernel_q"], w["scale"], impl=int8mm.MM_IMPL
        )
    return x @ w["kernel"].to(x.dtype)


def _dense(w: dict) -> torch.Tensor:
    """fp32 kernel of either weight form (the oracle's view)."""
    if "kernel_q" in w:
        return dequantize_weight(w)
    return w["kernel"].to(torch.float32)


def _torch_gate_up(x, norm_scale, mlp, eps):
    """The plain gate/up half: ``silu(rms(x) · w_gate) * (rms(x) ·
    w_up)`` over the columns ``mlp`` holds."""
    h = _rms(x, norm_scale, eps)
    return F.silu(_mm(h, mlp["w_gate"])) * _mm(h, mlp["w_up"])


def _torch_down(x, act, mlp):
    """The plain down half: ``x + act · w_down``."""
    return x + _mm(act, mlp["w_down"])


def _torch_decode_mlp(x, norm_scale, mlp, eps, mesh=None):
    """The residual norm+MLP chain as plain ops, on rows of any leading
    shape: the twin of ``_xla_decode_mlp`` and of the s>1 branch of the
    JAX ``generate._finish_block``. On a decode mesh (parallel/mesh.py)
    ``w_gate``/``w_up`` are this rank's column shards: ``silu(gate)·up``
    is gathered over the model axis before the replicated ``w_down``."""
    act = _torch_gate_up(x, norm_scale, mlp, eps)
    if mesh is not None:
        act = mesh.gather_model(act)
    return _torch_down(x, act, mlp)


def reference_decode_mlp(x, norm_scale, mlp, eps):
    """Naive fp32 oracle (int8 leaves dequantized to fp32)."""
    wg, wu, wd = (_dense(mlp[n]) for n in ("w_gate", "w_up", "w_down"))
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    h = x32 * torch.rsqrt(var + eps) * norm_scale.to(torch.float32)
    gate = h @ wg
    up = h @ wu
    out = (F.silu(gate) * up) @ wd
    return (x32 + out).to(x.dtype)


def _sm_count(device) -> int:
    index = device.index if device.index is not None else (
        torch.cuda.current_device()
    )
    sms = _SM_COUNTS.get(index)
    if sms is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _SM_COUNTS[index] = sms
    return sms


def _splits(device, d: int, ffn: int, vec: int) -> int:
    sms = _sm_count(device)
    col_tiles = -(-d // (32 * vec))
    want = -(-(_CTAS_PER_SM * sms) // col_tiles)
    return max(1, min(want, -(-ffn // 256)))


_MLP_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p,
]
_MLP_SM90_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 + [
    ctypes.c_float, ctypes.c_void_p,
]
_GATE_UP_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_void_p,
]
_DOWN_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p,
]
_SM90_GATE_UP_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p,
]
_SM90_DOWN_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p,
]

# The tensor-core kernel (csrc/decode_mlp_sm90.cu): CTAs of 8 warps, a
# warp a 16-column tile, stages of 16 KB of weights, rings of at most 8
# stages, clusters of at most 8 CTAs (the portable size), at most 227 KB
# less 1 KB of dynamic shared memory a CTA.
_SM90_W_BYTES = 16384
_SM90_WIDTHS = (64, 128)
_SM90_MIN_SLOTS = 3
_SM90_MAX_SLOTS = 8
_SM90_MAX_CLUSTER = 8
_SM90_MAX_SMEM = 232448 - 1024


class MlpPassPlan(NamedTuple):
    """How one pass of the tensor-core kernel covers W [K, N]: grid
    (cluster, col_ctas), a cluster's CTAs along K; a CTA's width columns
    in warps_n 16-column tiles, warps_k warps a tile, each taking every
    warps_k-th k16 step of the stages the CTA walks."""

    width: int  # columns a CTA (64 or 128; 64 at 16 planes)
    warps_n: int  # 16-column tiles a CTA: width / 16
    warps_k: int  # warps splitting a tile's K: 8 / (warps_n * row_groups)
    row_groups: int  # warpgroups splitting the rows: 2 at 16 planes
    cluster: int  # CTAs a cluster, splitting K
    col_ctas: int  # clusters
    cta_steps: int  # k16 steps a CTA (rank r: [r * cta_steps, +cta_steps))
    rows: int  # k rows a stage: 16 KB of weights
    stages: int  # stages a CTA walks
    slots: int  # ring depth
    smem: int  # dynamic shared memory a CTA, bytes

    @property
    def ctas(self) -> int:
        return self.cluster * self.col_ctas


class MlpPlan(NamedTuple):
    """The tensor-core kernel's two launches: gate/up (K = d, N = ffn)
    and down (K = ffn, N = d)."""

    planes: int  # 8-row planes of x: 1, 2, 4, 8, 16 for B <= 8 ... 128
    gate_up: MlpPassPlan
    down: MlpPassPlan


# The most rows a launch of each route's kernel takes; larger batches run
# in blocks of this many rows.
ROW_BLOCKS = {"sm90": 128, "simt": 64}


def row_blocks(b: int, route: str) -> list:
    """The row blocks ``[(lo, hi), ...]`` a call over ``b`` rows
    launches ``route``'s kernel on: consecutive, at most
    ``ROW_BLOCKS[route]`` rows each, as few as that allows."""
    block = ROW_BLOCKS[route]
    return [(lo, min(b, lo + block)) for lo in range(0, b, block)]


def planes_of(b: int) -> int:
    """8-row planes of the tensor-core kernel's B operand for b <= 128
    rows: ceil(b / 8) rounded up to 1, 2, 4, 8 or 16
    (csrc/decode_mlp_sm90.cu planes_of)."""
    return next(p for p in (1, 2, 4, 8, 16) if b <= 8 * p)


def _mlp_pass(planes: int, k: int, n: int, gate_up: bool, width: int,
              cluster: int) -> "MlpPassPlan | None":
    """The pass at (width, cluster) with the deepest ring that fits
    (csrc/decode_mlp_sm90.cu smem_bytes), or None when not even
    _SM90_MIN_SLOTS stages fit or 16 planes meet 128 columns. The warps'
    sums overlay the ring and xn after the loop, so the CTA asks for at
    least their bytes."""
    rows_pad = 8 * planes
    # 4, 8 and 16 planes run wgmma: the B operand streamed in every stage
    # (xn at gate/up too), its rows in swizzled blocks of 64 k (128 bytes
    # a row a block), and 1024 bytes more to align the base. At 16 the
    # warpgroups split the rows of one 64-column block (an accumulator of
    # 128 rows a warpgroup would not fit its registers at gate/up).
    wg = planes >= 4
    row_groups = 2 if planes == 16 else 1
    if row_groups == 2 and width != 64:
        return None
    align = 1024 if wg else 0
    rows = _SM90_W_BYTES // ((2 if gate_up else 1) * width * 2)
    steps = -(-k // 16)
    cta_steps = -(-steps // cluster)
    cluster = -(-steps // cta_steps)  # no rank without steps
    stages = -(-cta_steps // (rows // 16))
    resident_xn = gate_up and not wg
    piece_row = -(-rows // 64) * 128 if wg else 2 * rows + 16
    stage = _SM90_W_BYTES + (0 if resident_xn else rows_pad * piece_row)
    # mma.sync gate/up: xn's rows, then the scale, over the rank's columns
    cols = stages * rows
    resident = rows_pad * (2 * cols + 16) + 2 * cols if resident_xn else 0
    slots = min(_SM90_MAX_SLOTS,
                (_SM90_MAX_SMEM - align - resident) // stage)
    if slots < _SM90_MIN_SLOTS:
        return None
    # A slot of sums a warp, or at 16 planes a tile's two warps' one.
    sums = 8 // row_groups * (2 if gate_up else 1) * rows_pad * 16 * 4
    return MlpPassPlan(
        width=width, warps_n=width // 16,
        warps_k=8 // (width // 16 * row_groups), row_groups=row_groups,
        cluster=cluster, col_ctas=-(-n // width), cta_steps=cta_steps,
        rows=rows, stages=stages, slots=slots,
        smem=max(slots * stage + resident, sums) + align,
    )


def _mlp_pass_plan(planes: int, k: int, n: int, gate_up: bool,
                   sm_count: int) -> "MlpPassPlan | None":
    """One wave of at most one CTA an SM, as the int8 decode GEMV's plan
    (ops/int8mm.py gemv_sm90_plan): the most CTAs under that cap win,
    then no cluster, then the wider CTA. A cluster's CTAs share a GPC:
    the H100 holds 66 clusters of 2 of these CTAs at once (every SM) but
    only 39 of 3 and 30 of 4 (decode_mlp_ablation.py, phase plans), so
    clusters of 2 may fill the card and larger ones three quarters of
    it. Where no plan fits one wave (xn of a long d needs a K split;
    at 16 planes a CTA is 64 columns, so gate/up over ffn = 14336 takes
    224 of them), the fewest CTAs that fit shared memory; None when no
    cluster makes it fit."""
    steps = -(-k // 16)
    best = None
    fallback = None
    for width in _SM90_WIDTHS:
        for cluster in range(1, min(_SM90_MAX_CLUSTER, steps) + 1):
            p = _mlp_pass(planes, k, n, gate_up, width, cluster)
            if p is None:
                continue
            if fallback is None or p.ctas < fallback.ctas:
                fallback = p
            cap = sm_count if p.cluster <= 2 else 3 * sm_count // 4
            if p.ctas > cap:
                continue
            key = (p.ctas, p.cluster == 1, width)
            if best is None or key > best[0]:
                best = (key, p)
    return fallback if best is None else best[1]


@functools.lru_cache(maxsize=None)
def mlp_sm90_plan(b: int, d: int, ffn: int, sm_count: int) -> MlpPlan:
    """The tensor-core kernel's plan for one launch over x [b, d]
    (1 <= b <= 128) and ffn hidden columns, from the shapes and the SM
    count alone (no device value is read). Raises ValueError for a shape
    it does not take."""
    block = ROW_BLOCKS["sm90"]
    if not 1 <= b <= block:
        raise ValueError(f"a launch takes 1 <= b <= {block} rows, got {b}")
    planes = planes_of(b)
    gate_up = _mlp_pass_plan(planes, d, ffn, True, sm_count)
    down = _mlp_pass_plan(planes, ffn, d, False, sm_count)
    if gate_up is None or down is None:
        raise ValueError(f"no sm90 decode MLP plan for b={b}, d={d}, "
                         f"ffn={ffn}")
    return MlpPlan(planes=planes, gate_up=gate_up, down=down)


def shard_gate_up_plan(b: int, d: int, cols: int, ffn: int,
                       sm_count: int) -> MlpPassPlan:
    """The tensor-core gate/up pass over a shard of ``cols`` of ``ffn``
    columns: the whole ffn's pass (its width, K split and ring) over a
    grid of the shard's columns, so every act column sums its products
    in the unsharded kernel's order. Raises ValueError as
    :func:`mlp_sm90_plan`."""
    gu = mlp_sm90_plan(b, d, ffn, sm_count).gate_up
    return gu._replace(col_ctas=-(-cols // gu.width))


def _sm90_route(b: int, d: int, ffn: int, tensors) -> str:
    """"sm90" when the tensor-core kernel takes x [b, d] against an ffn
    of ``ffn`` columns with ``tensors`` (x first, then the weights and
    act it reads), in blocks of at most 128 rows: bf16 throughout,
    b >= 1, d % 8 == 0, ffn % 8 == 0, every tensor contiguous and
    16-byte aligned (so is every row block, d being a multiple of 8),
    and a block's xn rows fit shared memory under some K split; else
    "simt"."""
    if not (
        all(t.dtype == torch.bfloat16 for t in tensors)
        and b >= 1 and d % 8 == 0 and ffn % 8 == 0
        and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in tensors)
    ):
        return "simt"
    planes = planes_of(min(b, ROW_BLOCKS["sm90"]))
    fits = any(
        _mlp_pass(planes, d, ffn, True, width, _SM90_MAX_CLUSTER)
        is not None for width in _SM90_WIDTHS)
    return "sm90" if fits else "simt"


def _decode_mlp_route(x, ws) -> str:
    """The kernel that serves x [B, d] with (w_gate, w_up, w_down) on
    the card: "sm90" (:func:`_sm90_route`) or "simt" (anything else)."""
    b, d = x.shape
    return _sm90_route(b, d, ws[0].shape[1], (x, *ws))


def _gate_up_route(x, wg, wu, ffn: int) -> str:
    """The kernel that serves the gate/up half over a shard of
    ``wg.shape[1]`` of ``ffn`` columns: the route the fused block takes
    at the whole ffn, and "simt" where the shard's columns are not
    multiples of 8."""
    b, d = x.shape
    if wg.shape[1] % 8:
        return "simt"
    return _sm90_route(b, d, ffn, (x, wg, wu))


def _down_route(x, act, wd) -> str:
    """The kernel that serves the down half: the route the fused block
    takes for x [B, d] and an ffn of ``act.shape[1]``."""
    b, d = x.shape
    return _sm90_route(b, d, act.shape[1], (x, act, wd))


def _sm90_decode_mlp(x, norm_scale, wg, wu, wd, eps, out=None):
    """Launch csrc/decode_mlp_sm90.cu's two passes on x's stream over
    x [b <= 128, d], with :func:`mlp_sm90_plan`'s plan, into ``out``
    (a new tensor by default); the caller has checked the route."""
    b, d = x.shape
    ffn = wg.shape[1]
    if norm_scale.data_ptr() % 16:  # the kernel copies it 16 bytes at a time
        norm_scale = norm_scale.clone()
    plan = mlp_sm90_plan(b, d, ffn, _sm_count(x.device))
    act = torch.empty((b, ffn), dtype=x.dtype, device=x.device)
    xn = _xn_scratch(x, plan.planes)  # held until the launch
    if out is None:
        out = torch.empty_like(x)
    fn = kernels.function("decode_mlp_sm90.cu", "tpu_decode_mlp_sm90",
                          _MLP_SM90_ARGTYPES)
    gu, dn = plan.gate_up, plan.down
    err = fn(
        x.data_ptr(), norm_scale.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), act.data_ptr(), _ptr(xn), out.data_ptr(), b, d, ffn,
        gu.width,
        gu.cluster, gu.cta_steps, gu.slots, dn.width, dn.cluster,
        dn.cta_steps, dn.slots, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(err, "decode_mlp_sm90")
    return out


def _xn_scratch(x, planes: int):
    """A new xn [b, d] for the wgmma gate/up pass (4, 8 and 16 planes:
    rms_kernel writes it, gate/up streams it), else None."""
    return torch.empty_like(x) if planes >= 4 else None


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _simt_decode_mlp(x, norm_scale, wg, wu, wd, eps, out=None):
    """Launch csrc/decode_mlp.cu's three kernels on x's stream (any
    dtype, d and ffn it takes, 1 <= B <= 64) into ``out`` (a new tensor
    by default); the caller has checked the inputs."""
    b, d = x.shape
    ffn = wg.shape[1]
    vec = _simt_vec(x, d, ffn, (wg, wu, wd))
    splits = _splits(x.device, d, ffn, vec)
    act = torch.empty((b, ffn), dtype=x.dtype, device=x.device)
    partial = torch.empty((splits, b, d), dtype=torch.float32, device=x.device)
    if out is None:
        out = torch.empty_like(x)
    fn = kernels.function("decode_mlp.cu", "tpu_decode_mlp", _MLP_ARGTYPES)
    err = fn(
        x.data_ptr(), norm_scale.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), act.data_ptr(), partial.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[x.dtype], b, d, ffn, splits, vec, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(err, "decode_mlp")
    return out


def _simt_vec(x, d: int, n: int, ws) -> int:
    """2 when d and n are even and every weight 2-element aligned (the
    kernels then load column pairs), else 1."""
    pair = 2 * x.element_size()
    return 2 if (d % 2 == 0 and n % 2 == 0
                 and all(t.data_ptr() % pair == 0 for t in ws)) else 1


def _check_cuda(x, tensors, what: str) -> None:
    """Every tensor on x's CUDA device, bf16 or fp32 of x's dtype,
    contiguous, and B >= 1 rows (any B: the wrappers launch row blocks);
    raises on anything else."""
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{what} needs every input on one CUDA device")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(
            f"{what} takes bf16 or fp32 inputs of one dtype, got "
            f"{[t.dtype for t in tensors]}"
        )
    if x.shape[0] < 1:
        raise ValueError(f"{what} takes B >= 1 rows, got {x.shape[0]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous inputs")


def _cuda_gate_up(x, norm_scale, wg, wu, eps, ffn: int):
    """Launch the gate/up half on x's stream: act [B, cols] for the
    shard's columns wg/wu [d, cols] of a block ``ffn`` columns wide,
    one launch a row block of its route (:func:`row_blocks`), each
    writing its rows of act. The sm90 route is planned as the whole ffn's
    (``mlp_sm90_plan(rows, d, ffn)``), so each act column is the fused
    kernel's; raises on inputs the kernels do not take."""
    b, d = x.shape
    cols = wg.shape[1]
    _check_cuda(x, (x, norm_scale, wg, wu), "mlp_gate_up")
    if (tuple(norm_scale.shape) != (d,) or tuple(wg.shape) != (d, cols)
            or tuple(wu.shape) != (d, cols)):
        raise ValueError(
            f"mlp_gate_up shapes: x {tuple(x.shape)}, scale "
            f"{tuple(norm_scale.shape)}, w_gate {tuple(wg.shape)}, w_up "
            f"{tuple(wu.shape)}"
        )
    if ffn < cols or ffn % cols:
        raise ValueError(f"mlp_gate_up: a shard of {cols} columns does not "
                         f"divide ffn {ffn}")
    act = torch.empty((b, cols), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if _gate_up_route(x, wg, wu, ffn) == "sm90":
        if norm_scale.data_ptr() % 16:
            norm_scale = norm_scale.clone()
        fn = kernels.function("decode_mlp_sm90.cu",
                              "tpu_decode_mlp_sm90_gate_up",
                              _SM90_GATE_UP_ARGTYPES)
        for lo, hi in row_blocks(b, "sm90"):
            gu = shard_gate_up_plan(hi - lo, d, cols, ffn,
                                    _sm_count(x.device))
            xn = _xn_scratch(x[lo:hi], planes_of(hi - lo))
            err = fn(x[lo:hi].data_ptr(), norm_scale.data_ptr(),
                     wg.data_ptr(), wu.data_ptr(), act[lo:hi].data_ptr(),
                     _ptr(xn), hi - lo, d, cols, gu.width, gu.cluster,
                     gu.cta_steps, gu.slots, float(eps), stream)
            kernels.check(err, "decode_mlp_sm90_gate_up")
            kernels.count("decode_mlp_sm90_gate_up")
        return act
    fn = kernels.function("decode_mlp.cu", "tpu_decode_mlp_gate_up",
                          _GATE_UP_ARGTYPES)
    vec = _simt_vec(x, d, cols, (wg, wu))
    for lo, hi in row_blocks(b, "simt"):
        err = fn(x[lo:hi].data_ptr(), norm_scale.data_ptr(), wg.data_ptr(),
                 wu.data_ptr(), act[lo:hi].data_ptr(), _DTYPE_CODES[x.dtype],
                 hi - lo, d, cols, vec, float(eps), stream)
        kernels.check(err, "decode_mlp_gate_up")
        kernels.count("decode_mlp_gate_up")
    return act


def _cuda_down(x, act, wd):
    """Launch the down half on x's stream: x + act · wd over the
    gathered act [B, ffn], one launch a row block of its route
    (:func:`row_blocks`) reading its rows of act, with the fused
    kernel's plan (sm90) or splits (simt), so its output is the fused
    kernel's; raises on inputs the kernels do not take."""
    b, d = x.shape
    ffn = act.shape[1]
    _check_cuda(x, (x, act, wd), "mlp_down")
    if tuple(act.shape) != (b, ffn) or tuple(wd.shape) != (ffn, d):
        raise ValueError(
            f"mlp_down shapes: x {tuple(x.shape)}, act {tuple(act.shape)}, "
            f"w_down {tuple(wd.shape)}"
        )
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if _down_route(x, act, wd) == "sm90":
        fn = kernels.function("decode_mlp_sm90.cu", "tpu_decode_mlp_sm90_down",
                              _SM90_DOWN_ARGTYPES)
        for lo, hi in row_blocks(b, "sm90"):
            dn = mlp_sm90_plan(hi - lo, d, ffn, _sm_count(x.device)).down
            err = fn(x[lo:hi].data_ptr(), act[lo:hi].data_ptr(),
                     wd.data_ptr(), out[lo:hi].data_ptr(), hi - lo, d, ffn,
                     dn.width, dn.cluster, dn.cta_steps, dn.slots, stream)
            kernels.check(err, "decode_mlp_sm90_down")
            kernels.count("decode_mlp_sm90_down")
        return out
    vec = _simt_vec(x, d, ffn, (wd,))
    splits = _splits(x.device, d, ffn, vec)
    partial = torch.empty((splits, min(b, ROW_BLOCKS["simt"]), d),
                          dtype=torch.float32, device=x.device)
    fn = kernels.function("decode_mlp.cu", "tpu_decode_mlp_down",
                          _DOWN_ARGTYPES)
    for lo, hi in row_blocks(b, "simt"):
        err = fn(x[lo:hi].data_ptr(), act[lo:hi].data_ptr(), wd.data_ptr(),
                 partial.data_ptr(), out[lo:hi].data_ptr(),
                 _DTYPE_CODES[x.dtype], hi - lo, d, ffn, splits, vec, stream)
        kernels.check(err, "decode_mlp_down")
        kernels.count("decode_mlp_down")
    return out


def mlp_gate_up(x, norm_scale, mlp: dict, eps: float, ffn: int = None,
                impl: str = "auto"):
    """The gate/up half of the block: act [b, cols] = ``silu(rms(x) ·
    w_gate) * (rms(x) · w_up)`` for the columns ``mlp``'s ``w_gate`` and
    ``w_up`` hold, a shard of a block ``ffn`` columns wide (default: the
    shard is the whole). impl: "auto" (the kernel on a CUDA tensor, the
    plain half on the CPU) | "cuda" | "torch"."""
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    if impl == "torch":
        return _torch_gate_up(x, norm_scale, mlp, eps)
    if impl != "cuda":
        raise ValueError(f"unknown mlp_gate_up impl: {impl!r}")
    ws = _kernels(mlp)
    if ws is None:
        raise ValueError("the CUDA gate/up half needs plain 2D kernels")
    return _cuda_gate_up(x, norm_scale, ws[0], ws[1], eps,
                         ws[0].shape[1] if ffn is None else ffn)


def mlp_down(x, act, mlp: dict, impl: str = "auto"):
    """The down half of the block: ``x + act · w_down`` over the whole
    act [b, ffn]. impl: "auto" | "cuda" | "torch", as
    :func:`mlp_gate_up`."""
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    if impl == "torch":
        return _torch_down(x, act, mlp)
    if impl != "cuda":
        raise ValueError(f"unknown mlp_down impl: {impl!r}")
    ws = _kernels(mlp)
    if ws is None:
        raise ValueError("the CUDA down half needs plain 2D kernels")
    return _cuda_down(x, act, ws[2])


def _cuda_decode_mlp(x, norm_scale, wg, wu, wd, eps):
    """Launch the route's kernel (csrc/decode_mlp_sm90.cu for "sm90",
    csrc/decode_mlp.cu for "simt") on x's stream, once a row block of
    the route (:func:`row_blocks`), each block writing its rows of one
    output.
    Takes bf16 or fp32 tensors of one dtype, any d and ffn, any B >= 1;
    raises on anything else."""
    b, d = x.shape
    ffn = wg.shape[1]
    _check_cuda(x, (x, norm_scale, wg, wu, wd), "impl='cuda'")
    if (
        tuple(norm_scale.shape) != (d,)
        or tuple(wg.shape) != (d, ffn)
        or tuple(wu.shape) != (d, ffn)
        or tuple(wd.shape) != (ffn, d)
    ):
        raise ValueError(
            f"decode_mlp shapes: x {tuple(x.shape)}, scale "
            f"{tuple(norm_scale.shape)}, w_gate {tuple(wg.shape)}, w_up "
            f"{tuple(wu.shape)}, w_down {tuple(wd.shape)}"
        )
    route = _decode_mlp_route(x, (wg, wu, wd))
    sm90 = route == "sm90"
    launch = _sm90_decode_mlp if sm90 else _simt_decode_mlp
    out = torch.empty_like(x)
    for lo, hi in row_blocks(b, route):
        launch(x[lo:hi], norm_scale, wg, wu, wd, eps, out=out[lo:hi])
        if sm90:
            kernels.count("decode_mlp_sm90")
        kernels.count("decode_mlp")
    return out


def decode_mlp(x, norm_scale, mlp: dict, eps: float, impl: str = "auto",
               mesh=None):
    """The decode step's post-attention block for a [b, d] token batch.

    ``mlp`` is the layer's subtree ({"w_gate", "w_up", "w_down"}, plain
    or int8 weight-only leaves). impl: "auto" | "cuda" | "torch" |
    "reference". The CUDA kernels size their own tiles: the JAX op's
    ``block_f`` (its VMEM tile width) has no counterpart here. ``mesh``:
    the decode mesh whose model axis shards ``w_gate``/``w_up``; over
    more than one model coordinate the block splits at the gather of
    ``silu(gate)·up``: "cuda" runs the kernels' gate/up half, the
    gather and their down half, "torch" the plain halves, and
    "reference" (no gather) raises.
    """
    if x.ndim != 2:
        raise ValueError(
            f"decode_mlp expects [b, d] tokens, got {tuple(x.shape)}"
        )
    shard = mesh is not None and mesh.shape["model"] > 1
    if shard and impl == "reference":
        raise ValueError(
            "decode_mlp impl='reference' on a model shard: the oracle "
            "holds the whole ffn and does not gather"
        )
    if impl == "auto":
        impl = "cuda" if x.is_cuda and _kernels(mlp) is not None else "torch"
    global _LAST_DECODE_MLP_IMPL
    _LAST_DECODE_MLP_IMPL = impl
    if impl == "cuda":
        ws = _kernels(mlp)
        if ws is None:
            raise ValueError(
                "the CUDA decode MLP kernel needs plain 2D kernels "
                "(int8 weight-only trees take impl='torch' or 'auto')"
            )
        if shard:
            ffn = ws[0].shape[1] * mesh.shape["model"]
            act = mesh.gather_model(
                _cuda_gate_up(x, norm_scale, ws[0], ws[1], eps, ffn))
            return _cuda_down(x, act, ws[2])
        return _cuda_decode_mlp(x, norm_scale, *ws, eps=eps)
    if impl == "torch":
        return _torch_decode_mlp(x, norm_scale, mlp, eps, mesh)
    if impl == "reference":
        return reference_decode_mlp(x, norm_scale, mlp, eps)
    raise ValueError(f"unknown decode mlp impl: {impl!r}")
