"""Llama-3 family: configuration, rotary embeddings and the parameter tree.

Counterpart of ``tpu_dra/workloads/models/llama.py``. This slice serves
greedy decode through the paged engine, so it ports what that path
reads: the config and presets, ``rope_frequencies``/``apply_rope`` (both
fp32, as in JAX), and the parameter tree under flax's names. Weights
keep flax's ``[in, out]`` layout (``x @ w``): the converter then only
copies, and the decode MLP kernel reads ``[d, ffn]`` column slabs with
coalesced loads. The full-sequence forward and the flash attention path
arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    # Layout of the JAX tree this config describes (stacked under
    # nn.scan or unrolled layer_{i}); the port always holds the
    # unrolled tree, so these are carried for the converter and parity.
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "nothing"
    attention_impl: str = "auto"
    attention_block_q: int = 256
    attention_block_k: int = 256
    fused_ce: bool = False
    ce_chunk: int = 256
    decode_impl: str = "auto"
    decode_block_k: int = 256
    # Fused decode MLP (ops/decode_mlp.py): "auto" | "cuda" | "torch" |
    # "reference". The block width is the JAX kernel's VMEM tile: the
    # port ignores it (the CUDA kernel sizes its own tiles) and keeps the
    # field only for parity with the JAX config.
    decode_mlp_impl: str = "auto"
    decode_mlp_block_f: int = 512
    # Paged decode attention (ops/attention.py): "auto" | "cuda" |
    # "torch" | "reference".
    paged_decode_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


LLAMA3_8B = LlamaConfig()

# Hardware-free test config.
TINY_LLAMA = LlamaConfig(
    vocab_size=256,
    dim=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    ffn_dim=128,
    rope_theta=10_000.0,
    scan_layers=True,
    remat=False,
)


def rope_frequencies(config: LlamaConfig, positions: torch.Tensor) -> tuple:
    """cos/sin tables for rotary embeddings; positions [b, s] or [s]."""
    hd = config.head_dim
    exponents = (
        torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device)
        / hd
    )
    inv_freq = 1.0 / (config.rope_theta ** exponents)
    angles = positions.to(torch.float32)[..., None] * inv_freq  # [..., hd/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """x: [b, s, h, hd]; cos/sin: [b, s, hd/2] or [s, hd/2]."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    if cos.ndim == 2:  # [s, hd/2] -> [1, s, 1, hd/2]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.ndim == 3:  # [b, s, hd/2] -> [b, s, 1, hd/2]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _to_module(tree: dict) -> nn.Module:
    """Nested dict -> nested ModuleDict; dicts of tensors become
    ParameterDicts (no grad: this slice serves)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()}
        )
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def _to_tree(module: nn.Module) -> dict:
    if isinstance(module, nn.ParameterDict):
        return {k: v.data for k, v in module.items()}
    return {k: _to_tree(v) for k, v in module.items()}


class LlamaParams(nn.Module):
    """The unrolled parameter tree under flax's names: ``embed/embedding``,
    ``layer_{i}/attention/{wq,wk,wv,wo}/kernel``, ``layer_{i}/
    attention_norm/scale``, ``layer_{i}/mlp/{w_gate,w_up,w_down}/kernel``,
    ``layer_{i}/mlp_norm/scale``, ``final_norm/scale``,
    ``lm_head/kernel`` — so ``state_dict`` keys are the flax paths
    joined by dots. :meth:`tree` hands the decode functions the plain
    nested dict they index."""

    def __init__(self, config: LlamaConfig, tree: dict):
        super().__init__()
        self.config = config
        for name, sub in tree.items():
            self.add_module(name, _to_module(sub))

    def tree(self) -> dict:
        return {name: _to_tree(mod) for name, mod in self.named_children()}


def init_params(
    config: LlamaConfig,
    generator: torch.Generator,
    device: "torch.device | str | None" = None,
) -> LlamaParams:
    """Random weights as flax initialises them: normal(0.02) for every
    kernel and the embedding, ones for the norm scales, in
    ``param_dtype``. Draws run on ``generator``'s device (``device``
    defaults to it), in a fixed order, so a seed fixes the weights."""
    c = config
    device = torch.device(device) if device is not None else generator.device
    hd = c.head_dim

    def normal(*shape):
        return torch.empty(shape, dtype=c.param_dtype, device=device).normal_(
            0.0, 0.02, generator=generator
        )

    def ones(n):
        return torch.ones((n,), dtype=c.param_dtype, device=device)

    tree = {"embed": {"embedding": normal(c.vocab_size, c.dim)}}
    for i in range(c.n_layers):
        tree[f"layer_{i}"] = {
            "attention": {
                "wq": {"kernel": normal(c.dim, c.n_heads * hd)},
                "wk": {"kernel": normal(c.dim, c.n_kv_heads * hd)},
                "wv": {"kernel": normal(c.dim, c.n_kv_heads * hd)},
                "wo": {"kernel": normal(c.n_heads * hd, c.dim)},
            },
            "attention_norm": {"scale": ones(c.dim)},
            "mlp": {
                "w_gate": {"kernel": normal(c.dim, c.ffn_dim)},
                "w_up": {"kernel": normal(c.dim, c.ffn_dim)},
                "w_down": {"kernel": normal(c.ffn_dim, c.dim)},
            },
            "mlp_norm": {"scale": ones(c.dim)},
        }
    tree["final_norm"] = {"scale": ones(c.dim)}
    tree["lm_head"] = {"kernel": normal(c.dim, c.vocab_size)}
    return LlamaParams(c, tree)


def num_params(config: LlamaConfig) -> int:
    c = config
    per_layer = (
        c.dim * c.n_heads * c.head_dim  # wq
        + 2 * c.dim * c.n_kv_heads * c.head_dim  # wk, wv
        + c.n_heads * c.head_dim * c.dim  # wo
        + 3 * c.dim * c.ffn_dim  # gate, up, down
        + 2 * c.dim  # norms
    )
    return (
        c.vocab_size * c.dim  # embed
        + c.n_layers * per_layer
        + c.dim  # final norm
        + c.dim * c.vocab_size  # lm head
    )


def as_tree(
    params: "LlamaParams | dict", device: Optional[torch.device] = None
) -> dict:
    """A LlamaParams module or a nested dict of tensors -> the nested
    dict (detached) the decode functions index, moved to ``device``
    when given."""
    tree = params.tree() if isinstance(params, LlamaParams) else params

    def move(node):
        if isinstance(node, torch.Tensor):
            node = node.detach()
            return node if device is None else node.to(device)
        return {k: move(v) for k, v in node.items()}

    return move(tree)
