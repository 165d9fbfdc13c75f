"""Decoder-layer building blocks shared by the engine's prefill and decode.

Counterpart of the per-layer helpers of ``tpu_dra/workloads/generate.py``
(``_rms``, ``_mm``, ``_project_qkv``, ``_finish_block``): a hand-rolled
replay of the Llama layer over the unrolled parameter tree. ``_rms`` and
``_mm`` live in ops/decode_mlp.py, whose plain chain is also the s>1
MLP here; the s=1 decode step routes its norm+MLP chain through the
fused block — the CUDA kernel on the card, the same plain chain on the
CPU.
"""

from __future__ import annotations

from tpu_dra_torch.workloads.models.llama import LlamaConfig, apply_rope
from tpu_dra_torch.workloads.ops.decode_mlp import (
    _mm,
    _rms,
    _torch_decode_mlp,
    decode_mlp,
)

KV_QUANT_MODES = ("none", "int8")
WEIGHT_QUANT_MODES = ("none", "int8")


def _project_qkv(c: LlamaConfig, lp: dict, x, cos, sin, b: int, s: int):
    """Front half of a decoder layer: pre-norm + roped q/k/v."""
    att = lp["attention"]
    h = _rms(x, lp["attention_norm"]["scale"], c.norm_eps)
    q = _mm(h, att["wq"]).reshape(b, s, c.n_heads, c.head_dim)
    k = _mm(h, att["wk"]).reshape(b, s, c.n_kv_heads, c.head_dim)
    v = _mm(h, att["wv"]).reshape(b, s, c.n_kv_heads, c.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _finish_block(c: LlamaConfig, lp: dict, x, out, b: int, s: int):
    """Back half: attention output projection + residual MLP. The s=1
    decode step takes the fused block (ops/decode_mlp.py)."""
    att = lp["attention"]
    out = out.reshape(b, s, c.n_heads * c.head_dim)
    x = x + _mm(out, att["wo"])
    scale = lp["mlp_norm"]["scale"]
    if s == 1:
        return decode_mlp(
            x[:, 0], scale, lp["mlp"], c.norm_eps, impl=c.decode_mlp_impl
        )[:, None]
    return _torch_decode_mlp(x, scale, lp["mlp"], c.norm_eps)
