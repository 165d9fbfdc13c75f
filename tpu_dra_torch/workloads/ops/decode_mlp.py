"""Fused decode MLP+norm block: ``x + w_down(silu(w_gate(rms(x))) *
w_up(rms(x)))`` for the s=1 decode step.

Counterpart of ``tpu_dra/workloads/ops/decode_mlp.py``:

- **cuda**: the hand-written Hopper kernel (``csrc/decode_mlp.cu``, the
  port of the Pallas ``_decode_mlp_kernel``): ffn columns spread over
  the SMs, gate/up/act in one launch, down as fp32 split partials in a
  second, the residual reduction in a third — each weight byte read
  once, no float atomics;
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


def _splits(device, d: int, ffn: int, vec: int) -> int:
    index = device.index if device.index is not None else (
        torch.cuda.current_device()
    )
    sms = _SM_COUNTS.get(index)
    if sms is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _SM_COUNTS[index] = sms
    col_tiles = -(-d // (32 * vec))
    want = -(-(_CTAS_PER_SM * sms) // col_tiles)
    return max(1, min(want, -(-ffn // 256)))


_MLP_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p,
]


def _cuda_decode_mlp(x, norm_scale, wg, wu, wd, eps):
    """Launch csrc/decode_mlp.cu on x's stream. Takes bf16 or fp32
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
    kernels.LAUNCHES["decode_mlp"] += 1
    return out


def decode_mlp(x, norm_scale, mlp: dict, eps: float, impl: str = "auto"):
    """The decode step's post-attention block for a [b, d] token batch.

    ``mlp`` is the layer's subtree ({"w_gate", "w_up", "w_down"}, plain
    or int8 weight-only leaves). impl: "auto" | "cuda" | "torch" |
    "reference". The CUDA kernel sizes its own tiles: the JAX op's
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
