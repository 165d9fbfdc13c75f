"""Llama-3 family: configuration, rotary embeddings, the parameter tree
and the full-sequence forward.

Counterpart of ``tpu_dra/workloads/models/llama.py``. The serving paths
read the config, ``rope_frequencies``/``apply_rope`` (both fp32, as in
JAX) and the parameter tree under flax's names. Weights keep flax's
``[in, out]`` layout (``x @ w``): the converter then only copies, and
the decode MLP kernel reads ``[d, ffn]`` column slabs with coalesced
loads. The training path adds the modules of the flax model
(``RMSNorm``, ``LlamaAttention``, ``LlamaMLP``, ``LlamaBlock``,
``Llama``) as stateless ``nn.Module``s that take their flax-named
subtree as the first argument, per-layer remat through
``torch.utils.checkpoint``, and ``train_flops_per_token``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from tpu_dra_torch.workloads.ops.attention import attention
from tpu_dra_torch.workloads.ops.decode_mlp import _mm, _rms


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
    # Per-layer remat (torch.utils.checkpoint, non-reentrant): "nothing"
    # recomputes the whole block in the backward pass; "dots" saves the
    # projection matmul outputs and recomputes the rest, the flash
    # forward included (JAX's policy saves dots, and a pallas_call is
    # not one).
    remat: bool = True
    remat_policy: str = "nothing"
    # Full-sequence attention (ops/attention.py attention): "auto" |
    # "cuda" | "torch" | "reference". The block sizes are the JAX
    # kernels' TPU tiles: the port keeps them for parity and ignores
    # them (its kernels size their own 64-row tiles).
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


def _to_module(tree: dict, trainable: bool) -> nn.Module:
    """Nested dict -> nested ModuleDict; dicts of tensors become
    ParameterDicts, carrying gradients only when ``trainable`` (and only
    floating leaves can)."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=trainable and v.is_floating_point())
            for k, v in tree.items()
        })
    return nn.ModuleDict({k: _to_module(v, trainable) for k, v in tree.items()})


def _to_tree(module: nn.Module, detach: bool) -> dict:
    if isinstance(module, nn.ParameterDict):
        return {k: v.data if detach else v for k, v in module.items()}
    return {k: _to_tree(v, detach) for k, v in module.items()}


class LlamaParams(nn.Module):
    """The unrolled parameter tree under flax's names: ``embed/embedding``,
    ``layer_{i}/attention/{wq,wk,wv,wo}/kernel``, ``layer_{i}/
    attention_norm/scale``, ``layer_{i}/mlp/{w_gate,w_up,w_down}/kernel``,
    ``layer_{i}/mlp_norm/scale``, ``final_norm/scale``,
    ``lm_head/kernel`` — so ``state_dict`` keys are the flax paths
    joined by dots. :meth:`tree` hands the decode functions the plain
    nested dict they index. Serving trees carry no gradients; a
    ``trainable`` tree's parameters do (the Trainer's)."""

    def __init__(self, config: LlamaConfig, tree: dict, trainable: bool = False):
        super().__init__()
        self.config = config
        for name, sub in tree.items():
            self.add_module(name, _to_module(sub, trainable))

    def tree(self, detach: bool = True) -> dict:
        """The nested dict of leaves: detached tensors, or with
        ``detach=False`` the Parameters themselves (so a forward over
        the dict reaches their gradients)."""
        return {
            name: _to_tree(mod, detach) for name, mod in self.named_children()
        }


def init_params(
    config: LlamaConfig,
    generator: torch.Generator,
    device: "torch.device | str | None" = None,
    trainable: bool = False,
) -> LlamaParams:
    """Random weights as flax initialises them: normal(0.02) for every
    kernel and the embedding, ones for the norm scales, in
    ``param_dtype``. Draws run on ``generator``'s device (``device``
    defaults to it), in a fixed order, so a seed fixes the weights.
    ``trainable`` makes every leaf carry gradients."""
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
    return LlamaParams(c, tree, trainable)


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


def train_flops_per_token(config: LlamaConfig, seq: int) -> float:
    """Analytic model FLOPs per trained token: 6 per matmul parameter
    (forward 2, backward 4) plus the causal attention score/value
    matmuls (4 * seq * dim forward at half visibility, tripled for
    training). Recompute under remat does not count, so MFU compares
    across remat policies."""
    c = config
    matmul_params = num_params(c) - c.vocab_size * c.dim  # the lookup
    return 6.0 * matmul_params + 6.0 * c.n_layers * c.dim * seq


# --- the full-sequence forward: the training path -----------------------------


def param_tree(params: "LlamaParams | dict") -> dict:
    """The nested dict a forward indexes: a LlamaParams module's
    Parameters (gradients reach them), or a dict as it is."""
    return params.tree(detach=False) if isinstance(params, LlamaParams) else params


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * scale with fp32 statistics, back in
    x's dtype. forward(p, x), p = {"scale"}."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return _rms(x, p["scale"], self.eps)


class LlamaAttention(nn.Module):
    """Projections, rope and causal GQA attention (ops/attention.py
    ``attention`` with ``config.attention_impl``). forward(p, x, cos,
    sin), p = {wq, wk, wv, wo}/kernel."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config

    def forward(self, p: dict, x, cos, sin) -> torch.Tensor:
        c = self.config
        if c.attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={c.attention_impl!r} (sequence parallelism) "
                f"is not ported yet: ROADMAP Queue A item 11 (parallel "
                f"training)"
            )
        b, s, _ = x.shape
        q = _mm(x, p["wq"]).reshape(b, s, c.n_heads, c.head_dim)
        k = _mm(x, p["wk"]).reshape(b, s, c.n_kv_heads, c.head_dim)
        v = _mm(x, p["wv"]).reshape(b, s, c.n_kv_heads, c.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = attention(
            q, k, v, causal=True, impl=c.attention_impl,
            block_q=c.attention_block_q, block_k=c.attention_block_k,
        )
        return _mm(out.reshape(b, s, c.n_heads * c.head_dim), p["wo"])


class LlamaMLP(nn.Module):
    """SwiGLU: w_down(silu(w_gate x) * w_up x). forward(p, x)."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        gate = _mm(x, p["w_gate"])
        up = _mm(x, p["w_up"])
        return _mm(F.silu(gate) * up, p["w_down"])


class LlamaBlock(nn.Module):
    """Pre-norm attention and MLP, each with its residual. forward(p, x,
    cos, sin), p = one ``layer_{i}`` subtree."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.attention = LlamaAttention(config)
        self.attention_norm = RMSNorm(config.norm_eps)
        self.mlp = LlamaMLP(config)
        self.mlp_norm = RMSNorm(config.norm_eps)

    def forward(self, p: dict, x, cos, sin) -> torch.Tensor:
        x = x + self.attention(
            p["attention"], self.attention_norm(p["attention_norm"], x),
            cos, sin,
        )
        return x + self.mlp(p["mlp"], self.mlp_norm(p["mlp_norm"], x))


def _remat_context(policy: str):
    """checkpoint's context_fn for a remat policy ("nothing" saves
    nothing and recomputes the whole block)."""
    if policy == "nothing":
        return noop_context_fn
    if policy == "dots":
        # Save the 2-D matmul outputs (JAX's dots with no batch dims);
        # the flash kernels are ctypes calls, invisible to the policy,
        # so they always recompute, as the pallas_call does in JAX.
        return functools.partial(
            create_selective_checkpoint_contexts, [torch.ops.aten.mm.default]
        )
    raise ValueError(f"unknown remat_policy: {policy!r}")


class Llama(nn.Module):
    """The full-sequence model. Stateless like the flax module: the
    weights come as ``params`` (a LlamaParams, or its nested dict) on
    each call. forward(tokens [b, s] int, return_hidden=False, params=)
    -> fp32 logits [b, s, vocab], or the final-norm hidden states
    [b, s, dim] in the compute dtype (the fused loss applies the LM head
    itself, ops/loss.py). The port holds the unrolled tree;
    ``scan_layers`` only names the JAX layout."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.block = LlamaBlock(config)
        self.final_norm = RMSNorm(config.norm_eps)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False, *,
                params: "LlamaParams | dict") -> torch.Tensor:
        c = self.config
        tree = param_tree(params)
        emb = tree["embed"]["embedding"]
        x = F.embedding(tokens.to(device=emb.device, dtype=torch.long), emb)
        x = x.to(c.dtype)
        cos, sin = rope_frequencies(
            c, torch.arange(tokens.shape[1], device=x.device)
        )
        context = _remat_context(c.remat_policy) if c.remat else None
        for i in range(c.n_layers):
            block = functools.partial(self.block, tree[f"layer_{i}"])
            if context is None:
                x = block(x, cos, sin)
            else:
                x = checkpoint(block, x, cos, sin, use_reentrant=False,
                               context_fn=context)
        x = self.final_norm(tree["final_norm"], x)
        if return_hidden:
            return x
        return _mm(x, tree["lm_head"]).to(torch.float32)
