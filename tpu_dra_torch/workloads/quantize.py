"""Weight-only int8 and int8 KV quantization for the serving path.

Counterpart of ``tpu_dra/workloads/quantize.py``, op for op: the same
fp32 operations in the same order, and ``torch.round`` rounds half to
even like ``jnp.round``, so the int8 values and the f32 scales are
bit-identical to the JAX package's on the same inputs.

- weights: symmetric per-output-channel int8. Every bare 2D ``{"kernel":
  [in, out]}`` leaf of the Llama tree becomes ``{"kernel_q": int8 [in,
  out], "scale": f32 [1, out]}``; embeddings and norms stay as they are.
  ``generate._mm`` takes either form (int8 leaves go through
  ops/int8mm.py).
- KV: symmetric int8 with one f32 scale per (token, kv head) row; an
  all-zero row gets scale 0, not 1, so zeroed pool tails stay zero in
  the scale pools too.
"""

from __future__ import annotations

import torch


def quantize_weight(kernel: torch.Tensor) -> dict:
    """kernel [in, out] -> {"kernel_q" int8, "scale" f32 [1, out]} with
    kernel_q * scale ~= kernel."""
    if kernel.ndim != 2:
        raise ValueError(f"expected 2D kernel, got shape {tuple(kernel.shape)}")
    k32 = kernel.to(torch.float32)
    absmax = torch.amax(torch.abs(k32), dim=0, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(k32 / scale), -127, 127).to(torch.int8)
    return {"kernel_q": q, "scale": scale}


def quantize_params(params: dict) -> dict:
    """Quantize every bare ``{"kernel": ...}`` node: 2D per (out)
    channel, a scan-stacked 3D ``[L, in, out]`` per (layer, out) channel
    with scale ``[L, 1, out]``. A kernel node with sibling keys (a bias)
    or another rank raises: a quiet skip would leave that projection in
    the model dtype under ``weight_quant="int8"``."""

    def walk(node, path):
        if isinstance(node, dict):
            if "kernel" in node:
                k = node["kernel"]
                if set(node) == {"kernel"} and k.ndim == 2:
                    return quantize_weight(k)
                if set(node) == {"kernel"} and k.ndim == 3:
                    per_layer = [quantize_weight(w) for w in k]
                    return {
                        name: torch.stack([p[name] for p in per_layer])
                        for name in ("kernel_q", "scale")
                    }
                raise ValueError(
                    f"unquantizable kernel node at {'/'.join(path)}: "
                    f"keys={sorted(node)}, ndim={k.ndim} "
                    "(expected a bare 2D/3D {'kernel': ...} leaf)"
                )
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return walk(params, ())


def dequantize_weight(q: dict) -> torch.Tensor:
    """f32 view of a quantized leaf: kernel_q * scale."""
    return q["kernel_q"].to(torch.float32) * q["scale"]


def quantize_kv(x: torch.Tensor) -> tuple:
    """x [..., heads, head_dim] -> (int8 same shape, f32 scale [...,
    heads]); one scale per row over head_dim, 0 for an all-zero row."""
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=-1)
    scale = absmax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 view of a quantized KV block: q * scale per row."""
    return q.to(torch.float32) * scale[..., None]
