"""Fused decode MLP+norm block: ``x + w_down(silu(w_gate(rms(x))) *
w_up(rms(x)))`` for the s=1 decode step.

Counterpart of ``tpu_dra/workloads/ops/decode_mlp.py``:

- **cuda**: a hand-written Hopper kernel, the port of the Pallas
  ``_decode_mlp_kernel``. ``_decode_mlp_route`` picks it before the
  launch, from the dtypes, shapes and alignment alone:

  - ``"sm90"``, bf16 with 1 <= B <= 16, d and ffn multiples of 8, x and
    the weights contiguous and 16-byte aligned (every bf16 decode step
    at Llama-3-8B widths): the tensor-core kernel of
    ``csrc/decode_mlp_sm90.cu``, planned by :func:`mlp_sm90_plan` —
    two launches (gate/up with the norm and silu·up, down with the
    residual), weights streamed through an mbarrier ring, the K split
    reduced on chip;
  - ``"simt"``, everything else (fp32, 17 <= B <= 64, other shapes):
    ``csrc/decode_mlp.cu`` on CUDA cores — gate/up/act in one launch,
    down as fp32 split partials in a second, the residual reduction in
    a third.

  Each weight byte is read once, no float atomics;
- **torch**: the twin of ``_xla_decode_mlp``, the op chain the decode
  step runs off the card (so CPU parity with the JAX engine holds);
- **reference**: the twin of the naive fp32 oracle
  ``reference_decode_mlp``.

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


def _torch_decode_mlp(x, norm_scale, mlp, eps):
    """The residual norm+MLP chain as plain ops, on rows of any leading
    shape: the twin of ``_xla_decode_mlp`` and of the s>1 branch of the
    JAX ``generate._finish_block``."""
    h = _rms(x, norm_scale, eps)
    gate = _mm(h, mlp["w_gate"])
    up = _mm(h, mlp["w_up"])
    return x + _mm(F.silu(gate) * up, mlp["w_down"])


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
_MLP_SM90_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
    ctypes.c_float, ctypes.c_void_p,
]

# The tensor-core kernel (csrc/decode_mlp_sm90.cu): CTAs of 8 warps, a
# warp a 16-column tile, stages of 16 KB of weights, rings of at most 8
# stages, clusters of at most 8 CTAs (the portable size), at most 227 KB
# less 1 KB of dynamic shared memory a CTA.
_SM90_MAX_ROWS = 16
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

    width: int  # columns a CTA (64 or 128)
    warps_n: int  # 16-column tiles a CTA: width / 16
    warps_k: int  # warps a tile: 8 / warps_n
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

    planes: int  # 8-row planes of x: 1 for B <= 8, else 2
    gate_up: MlpPassPlan
    down: MlpPassPlan


def _mlp_pass(planes: int, k: int, n: int, gate_up: bool, width: int,
              cluster: int) -> "MlpPassPlan | None":
    """The pass at (width, cluster) with the deepest ring that fits
    (csrc/decode_mlp_sm90.cu smem_bytes), or None when not even
    _SM90_MIN_SLOTS stages fit."""
    rows_pad = 8 * planes
    rows = _SM90_W_BYTES // ((2 if gate_up else 1) * width * 2)
    steps = -(-k // 16)
    cta_steps = -(-steps // cluster)
    cluster = -(-steps // cta_steps)  # no rank without steps
    stages = -(-cta_steps // (rows // 16))
    stage = _SM90_W_BYTES + (0 if gate_up else rows_pad * (2 * rows + 16))
    # gate/up: xn's rows, then the scale, over the rank's columns
    cols = stages * rows
    resident = rows_pad * (2 * cols + 16) + 2 * cols if gate_up else 0
    slots = min(_SM90_MAX_SLOTS, (_SM90_MAX_SMEM - resident) // stage)
    if slots < _SM90_MIN_SLOTS:
        return None
    return MlpPassPlan(
        width=width, warps_n=width // 16, warps_k=8 // (width // 16),
        cluster=cluster, col_ctas=-(-n // width), cta_steps=cta_steps,
        rows=rows, stages=stages, slots=slots,
        smem=slots * stage + resident,
    )


def _mlp_pass_plan(planes: int, k: int, n: int, gate_up: bool,
                   sm_count: int) -> "MlpPassPlan | None":
    """One wave of at most one CTA an SM, as the int8 decode GEMV's plan
    (ops/int8mm.py gemv_sm90_plan): the most CTAs under that cap win,
    then no cluster, then the wider CTA. A cluster's CTAs share a GPC:
    the H100 holds 66 clusters of 2 of these CTAs at once (every SM) but
    only 39 of 3 and 30 of 4 (decode_mlp_ablation.py, phase plans), so
    clusters of 2 may fill the card and larger ones three quarters of
    it. Where no plan fits one wave (xn of a long d needs a K split),
    the fewest CTAs that fit shared memory; None when no cluster makes
    it fit."""
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
    """The tensor-core kernel's plan for x [b, d] and ffn hidden
    columns, from the shapes and the SM count alone (no device value is
    read). Raises ValueError for a shape it does not take."""
    planes = 1 if b <= 8 else 2
    gate_up = _mlp_pass_plan(planes, d, ffn, True, sm_count)
    down = _mlp_pass_plan(planes, ffn, d, False, sm_count)
    if gate_up is None or down is None:
        raise ValueError(f"no sm90 decode MLP plan for b={b}, d={d}, "
                         f"ffn={ffn}")
    return MlpPlan(planes=planes, gate_up=gate_up, down=down)


def _decode_mlp_route(x, ws) -> str:
    """The kernel that serves x [B, d] with (w_gate, w_up, w_down) on
    the card: "sm90" (bf16 throughout, 1 <= B <= 16, d % 8 == 0,
    ffn % 8 == 0, x and the weights contiguous and 16-byte aligned, and
    xn's rows fit shared memory under some K split) or "simt" (anything
    else)."""
    wg, wu, wd = ws
    b, d = x.shape
    ffn = wg.shape[1]
    tensors = (x, wg, wu, wd)
    if not (
        x.dtype == torch.bfloat16
        and all(t.dtype == torch.bfloat16 for t in ws)
        and 1 <= b <= _SM90_MAX_ROWS and d % 8 == 0 and ffn % 8 == 0
        and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in tensors)
    ):
        return "simt"
    planes = 1 if b <= 8 else 2
    fits = any(
        _mlp_pass(planes, d, ffn, True, width, _SM90_MAX_CLUSTER)
        is not None for width in _SM90_WIDTHS)
    return "sm90" if fits else "simt"


def _sm90_decode_mlp(x, norm_scale, wg, wu, wd, eps):
    """Launch csrc/decode_mlp_sm90.cu's two passes on x's stream, with
    :func:`mlp_sm90_plan`'s plan; the caller has checked the route."""
    b, d = x.shape
    ffn = wg.shape[1]
    if norm_scale.data_ptr() % 16:  # the kernel copies it 16 bytes at a time
        norm_scale = norm_scale.clone()
    plan = mlp_sm90_plan(b, d, ffn, _sm_count(x.device))
    act = torch.empty((b, ffn), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    fn = kernels.function("decode_mlp_sm90.cu", "tpu_decode_mlp_sm90",
                          _MLP_SM90_ARGTYPES)
    gu, dn = plan.gate_up, plan.down
    err = fn(
        x.data_ptr(), norm_scale.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), act.data_ptr(), out.data_ptr(), b, d, ffn, gu.width,
        gu.cluster, gu.cta_steps, gu.slots, dn.width, dn.cluster,
        dn.cta_steps, dn.slots, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(err, "decode_mlp_sm90")
    return out


def _simt_decode_mlp(x, norm_scale, wg, wu, wd, eps):
    """Launch csrc/decode_mlp.cu's three kernels on x's stream (any
    dtype, d and ffn it takes, 1 <= B <= 64); the caller has checked
    the inputs."""
    b, d = x.shape
    ffn = wg.shape[1]
    pair = 2 * x.element_size()
    vec = 2 if (
        d % 2 == 0 and ffn % 2 == 0
        and all(t.data_ptr() % pair == 0 for t in (wg, wu, wd))
    ) else 1
    splits = _splits(x.device, d, ffn, vec)
    act = torch.empty((b, ffn), dtype=x.dtype, device=x.device)
    partial = torch.empty((splits, b, d), dtype=torch.float32, device=x.device)
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


def _cuda_decode_mlp(x, norm_scale, wg, wu, wd, eps):
    """Launch the route's kernel (csrc/decode_mlp_sm90.cu for "sm90",
    csrc/decode_mlp.cu for "simt") on x's stream. Takes bf16 or fp32
    tensors of one dtype, any d and ffn, 1 <= B <= 64; raises on
    anything else."""
    b, d = x.shape
    ffn = wg.shape[1]
    tensors = (x, norm_scale, wg, wu, wd)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("impl='cuda' needs every input on one CUDA device")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(
            f"impl='cuda' takes bf16 or fp32 inputs of one dtype, got "
            f"{[t.dtype for t in tensors]}"
        )
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
    if not 1 <= b <= 64:
        raise ValueError(f"impl='cuda' takes 1 <= B <= 64 rows, got {b}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("impl='cuda' needs contiguous inputs")
    if _decode_mlp_route(x, (wg, wu, wd)) == "sm90":
        out = _sm90_decode_mlp(x, norm_scale, wg, wu, wd, eps)
        kernels.LAUNCHES["decode_mlp_sm90"] += 1
    else:
        out = _simt_decode_mlp(x, norm_scale, wg, wu, wd, eps)
    kernels.LAUNCHES["decode_mlp"] += 1
    return out


def decode_mlp(x, norm_scale, mlp: dict, eps: float, impl: str = "auto"):
    """The decode step's post-attention block for a [b, d] token batch.

    ``mlp`` is the layer's subtree ({"w_gate", "w_up", "w_down"}, plain
    or int8 weight-only leaves). impl: "auto" | "cuda" | "torch" |
    "reference". The CUDA kernels size their own tiles: the JAX op's
    ``block_f`` (its VMEM tile width) has no counterpart here.
    """
    if x.ndim != 2:
        raise ValueError(
            f"decode_mlp expects [b, d] tokens, got {tuple(x.shape)}"
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
        return _cuda_decode_mlp(x, norm_scale, *ws, eps=eps)
    if impl == "torch":
        return _torch_decode_mlp(x, norm_scale, mlp, eps)
    if impl == "reference":
        return reference_decode_mlp(x, norm_scale, mlp, eps)
    raise ValueError(f"unknown decode mlp impl: {impl!r}")
