"""Mixtral family: configuration, the parameter tree and the
full-sequence forward with its load-balance loss.

Counterpart of ``tpu_dra/workloads/models/mixtral.py``: Llama's
attention (GQA and rope, the port's ``LlamaAttention`` and so the flash
kernels) with the dense SwiGLU MLP replaced by a top-k routed expert
layer with capacity-based dispatch. The routing keeps the reference's
static shapes: dense one-hot dispatch and combine tensors
``[b, s*k, E, C]`` and batched expert products over ``[E, d, f]``
weights, all ``torch.einsum`` (cuBLAS on the card) where JAX has XLA
products. The family trains only: the serving engine runs Llama.

Where the reference's numerics fix the port's:

- the router runs in fp32 on the kernel cast up, as flax's
  ``Dense(dtype=float32)`` does with the bf16 kernel;
- top-k breaks ties toward the lower expert index, as
  ``jax.lax.top_k`` does: a stable descending sort, since
  ``torch.topk`` promises no order among equal values;
- a slot's position in its expert's buffer is an fp32 cumsum, and its
  one-hot is a comparison, so -1 (an expert that no slot so far has
  picked) and positions past capacity give zero rows, as
  ``jax.nn.one_hot`` does (``F.one_hot`` raises on both);
- dispatch and combine are cast to the compute dtype before their
  products (each gate rounded once), and a token's k slots are summed
  in it.

On a training mesh of more than one rank (:mod:`..parallel.mesh`; the
rank's rows and ``sp`` chunk, its parameter blocks) the MoE is this
rank's share of JAX's GSPMD program, which computes what the unsharded
layer computes:

- capacity and positions are the global sequence's: ``capacity`` of the
  whole length, and a slot's position counts, before its own chunk's,
  the slots every earlier ``sp`` chunk of its row gave its expert (one
  all_gather of ``[b, E]`` counts over sp);
- the load-balance loss is ``E * sum(token_frac * prob_frac)`` with both
  fractions means over the global batch, their sums all-reduced over the
  data axes before the product (its backward hands each rank's
  ``probs`` their own share once);
- the router kernel is gathered over fsdp and runs replicated over ep
  and tp; the experts are the rank's ep block gathered over fsdp,
  ``w_gate``/``w_up`` column-parallel and ``w_down`` row-parallel over
  tp; dispatch and combine take the rank's experts only;
- the expert path's input ``x`` and the gates enter through an identity
  whose backward all-reduces over (ep, tp) (the rank's experts and ffn
  columns give only their share of those cotangents), and the combined
  slots' partial sums over (ep, tp) are added in fp32 before the cast
  (over ep a slot is one rank's value plus zeros);
- at ``sp`` above 1 the dispatched buffers are reduce-scattered over sp
  along the capacity (each slot comes from one chunk), the experts run
  on ``C/sp`` slots of every buffer and their outputs are all-gathered
  back, so an expert's gradient sums over sp, by ``train.sum_grads``,
  each slot once.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from tpu_dra_torch.workloads.models.llama import (
    LlamaAttention,
    LlamaConfig,
    LlamaParams,
    RMSNorm,
    _train_mesh,
    _weight,
    param_tree,
    rope_frequencies,
)
from tpu_dra_torch.workloads.ops.decode_mlp import _mm


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32_000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    # The JAX tree's layout (stacked under nn.scan or unrolled); the
    # port always holds the unrolled tree.
    scan_layers: bool = True
    # Per-layer remat through torch.utils.checkpoint: the whole block
    # recomputes in the backward pass (JAX's nothing_saveable).
    remat: bool = True
    # ops/attention.py ``attention``: "auto" | "cuda" | "torch" |
    # "reference", or sequence parallelism on a training mesh: "ring" |
    # "ulysses" (the port's LlamaAttention).
    attention_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def attention_config(self) -> LlamaConfig:
        """The attention sub-module reuses the Llama implementation (the
        JAX block defaults, 256, carried for parity)."""
        return LlamaConfig(
            vocab_size=self.vocab_size,
            dim=self.dim,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            ffn_dim=self.ffn_dim,
            rope_theta=self.rope_theta,
            norm_eps=self.norm_eps,
            dtype=self.dtype,
            param_dtype=self.param_dtype,
            attention_impl=self.attention_impl,
        )

    def capacity(self, seq: int) -> int:
        """Per-expert token-slot capacity for a length-``seq`` sequence."""
        return max(
            1,
            int(math.ceil(self.top_k * seq * self.capacity_factor / self.n_experts)),
        )


MIXTRAL_8X7B = MixtralConfig()

# Hardware-free test config.
TINY_MIXTRAL = MixtralConfig(
    vocab_size=256,
    dim=64,
    n_layers=2,
    n_heads=4,
    n_kv_heads=2,
    ffn_dim=128,
    n_experts=4,
    top_k=2,
    rope_theta=10_000.0,
    remat=False,
)


class MixtralParams(LlamaParams):
    """The unrolled parameter tree under flax's names: ``embed/
    embedding``, ``layer_{i}/attention/{wq,wk,wv,wo}/kernel``,
    ``layer_{i}/attention_norm/scale``, ``layer_{i}/moe/{router/kernel,
    experts_w_gate, experts_w_up, experts_w_down}``, ``layer_{i}/
    moe_norm/scale``, ``final_norm/scale``, ``lm_head/kernel`` — held
    by LlamaParams' machinery, so ``state_dict`` keys are the flax
    paths joined by dots."""


def init_params(
    config: MixtralConfig,
    generator: torch.Generator,
    device: "torch.device | str | None" = None,
    trainable: bool = False,
) -> MixtralParams:
    """Random weights as flax initialises them: normal(0.02) for every
    kernel, expert and the embedding, ones for the norm scales, in
    ``param_dtype``, drawn on ``generator``'s device (``device``
    defaults to it) in a fixed order, so a seed fixes the weights."""
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
            "moe": {
                "router": {"kernel": normal(c.dim, c.n_experts)},
                "experts_w_gate": normal(c.n_experts, c.dim, c.ffn_dim),
                "experts_w_up": normal(c.n_experts, c.dim, c.ffn_dim),
                "experts_w_down": normal(c.n_experts, c.ffn_dim, c.dim),
            },
            "moe_norm": {"scale": ones(c.dim)},
        }
    tree["final_norm"] = {"scale": ones(c.dim)}
    tree["lm_head"] = {"kernel": normal(c.dim, c.vocab_size)}
    return MixtralParams(c, tree, trainable)


def num_params(config: MixtralConfig) -> int:
    c = config
    per_layer = (
        c.dim * c.n_heads * c.head_dim  # wq
        + 2 * c.dim * c.n_kv_heads * c.head_dim  # wk, wv
        + c.n_heads * c.head_dim * c.dim  # wo
        + c.dim * c.n_experts  # router
        + 3 * c.n_experts * c.dim * c.ffn_dim  # experts' gate, up, down
        + 2 * c.dim  # norms
    )
    return (
        c.vocab_size * c.dim  # embed
        + c.n_layers * per_layer
        + c.dim  # final norm
        + c.dim * c.vocab_size  # lm head
    )


def _einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s promotion: both operands in their common dtype."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(equation, a.to(dtype), b.to(dtype))


def top_k(x: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest along the last axis, ties
    broken toward the lower index as ``jax.lax.top_k`` breaks them."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def dispatch_mask(idx: torch.Tensor, n_experts: int, cap: int,
                  block: "tuple | None" = None,
                  earlier: "torch.Tensor | None" = None) -> torch.Tensor:
    """Expert ids ``[b, s, k]`` -> dispatch ``[b, s*k, E, cap]`` fp32:
    slot t (token-major: a token's k slots together, earlier tokens
    first) goes to position ``cumsum - 1`` of its expert's buffer, and
    is dropped (a zero row) past ``cap``. ``block`` = (lo, hi) keeps
    experts lo..hi-1 only (a rank's ep block); ``earlier`` [b, hi-lo]
    counts the slots earlier chunks of each row gave them, where ``idx``
    is one sp chunk of the row."""
    b, s, k = idx.shape
    lo, hi = block or (0, n_experts)
    experts = torch.arange(lo, hi, device=idx.device)
    flat_mask = (idx[..., None] == experts).to(torch.float32).reshape(
        b, s * k, hi - lo)
    position = torch.cumsum(flat_mask, dim=1) - 1.0  # [b, s*k, E]
    if earlier is not None:
        position = position + earlier[:, None, :]
    keep = flat_mask * (position < cap)
    slots = torch.arange(cap, device=idx.device, dtype=torch.float32)
    return keep[..., None] * (position[..., None] == slots)


def earlier_slots(mesh, idx: torch.Tensor, block: tuple) -> torch.Tensor:
    """[b, hi-lo] fp32: the slots the sp chunks before this rank's give
    each expert of ``block`` in each row (one all_gather of the chunks'
    counts over sp; no gradient)."""
    lo, hi = block
    experts = torch.arange(lo, hi, device=idx.device)
    counts = (idx[..., None] == experts).sum(dim=(1, 2)).to(torch.float32)
    every = mesh.all_gather_raw(counts[None], "sp", 0)  # [sp, b, E]
    return every[:mesh.index("sp")].sum(dim=0)


def load_balance(mesh, probs: torch.Tensor, idx: torch.Tensor,
                 n_experts: int) -> torch.Tensor:
    """Switch eq. 4: ``E * sum_e f_e * p_e``, f the share of tokens whose
    top-1 choice is e (no gradient), p the mean probability of e, both
    over the global batch: on a mesh their sums are all-reduced over the
    data axes before the product (the all_reduce's backward is the
    identity: each rank's probs take their own share once)."""
    experts = torch.arange(n_experts, device=probs.device)
    top1 = (idx[..., 0, None] == experts).to(torch.float32)
    if mesh is None:
        token_frac, prob_frac = top1.mean(dim=(0, 1)), probs.mean(dim=(0, 1))
    else:
        # Imported here: parallel.mesh imports convert, which imports
        # this module.
        from tpu_dra_torch.workloads.parallel.mesh import DATA_AXES

        n = top1.shape[0] * top1.shape[1] * mesh.axis_size(DATA_AXES)
        sums = mesh.all_reduce(torch.stack(
            [top1.sum(dim=(0, 1)), probs.sum(dim=(0, 1))]), DATA_AXES) / n
        token_frac, prob_frac = sums[0], sums[1]
    return n_experts * torch.sum(token_frac * prob_frac)


class MixtralRouter(nn.Module):
    """forward(p, x) -> (probs [b, s, E] fp32, gate [b, s, k], idx
    [b, s, k]): the softmax of ``x @ kernel`` in fp32 and its top-k.
    p = {"kernel"}."""

    def __init__(self, config: MixtralConfig):
        super().__init__()
        self.top_k = config.top_k

    def forward(self, p: dict, x: torch.Tensor) -> tuple:
        logits = x.to(torch.float32) @ p["kernel"].to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        gate, idx = top_k(probs, self.top_k)
        return probs, gate, idx


class MixtralMoE(nn.Module):
    """Top-k routed SwiGLU expert layer with capacity-based dispatch.
    forward(p, x [b, s, d]) -> (y [b, s, d] in x's dtype, the layer's
    weighted load-balance loss ``router_aux_weight * aux``), p = one
    ``layer_{i}/moe`` subtree: on a training mesh this rank's blocks,
    ``x`` its rows and sp chunk (see the module docstring)."""

    def __init__(self, config: MixtralConfig):
        super().__init__()
        self.config = config
        self.router = MixtralRouter(config)

    def forward(self, p: dict, x: torch.Tensor) -> tuple:
        from tpu_dra_torch.workloads.parallel.mesh import EXPERT_AXES  # cycle

        c = self.config
        mesh = _train_mesh()
        b, s, d = x.shape
        k, n_exp = c.top_k, c.n_experts
        sp = 1 if mesh is None else mesh.shape["sp"]
        cap = c.capacity(s * sp)  # the global sequence's
        block = (0, n_exp) if mesh is None else mesh.block(n_exp, "ep")
        if cap % sp:
            raise ValueError(f"expert capacity {cap} does not split over "
                             f"sp={sp}")

        def expert(name):
            w = p[name]
            return w if mesh is None else mesh.gather_param(w, f"moe/{name}")

        def partial_grad(t):  # the cotangent of t sums over (ep, tp)
            return t if mesh is None else mesh.all_reduce_grad(t, EXPERT_AXES)

        # Profiler spans (no cost without a profiler): a trace splits the
        # layer's device time into these four.
        with record_function("moe/router"):
            probs, gate, idx = self.router(
                _weight(mesh, p["router"], "moe/router/kernel"), x)
            gate = gate / torch.clamp_min(gate.sum(dim=-1, keepdim=True), 1e-9)
            aux = load_balance(mesh, probs, idx, n_exp)
        with record_function("moe/dispatch"):
            earlier = None if sp == 1 else earlier_slots(mesh, idx, block)
            dispatch = dispatch_mask(idx, n_exp, cap, block, earlier)
            x_slots = torch.repeat_interleave(partial_grad(x), k, dim=1)
            xe = _einsum("btec,btd->ebcd", dispatch.to(c.dtype), x_slots)
            if sp > 1:  # each rank's experts on C/sp slots of every buffer
                xe = mesh.reduce_scatter(xe, "sp", 2)
        with record_function("moe/experts"):
            h = F.silu(_einsum("ebcd,edf->ebcf", xe, expert("experts_w_gate"))) * (
                _einsum("ebcd,edf->ebcf", xe, expert("experts_w_up")))
            ye = _einsum("ebcf,efd->ebcd", h, expert("experts_w_down"))
            if sp > 1:
                ye = mesh.all_gather(ye, "sp", 2)
        with record_function("moe/combine"):
            combine = dispatch * partial_grad(gate).reshape(b, s * k)[
                ..., None, None]
            y_slots = _einsum("ebcd,btec->btd", ye, combine.to(c.dtype))
            if mesh is not None and mesh.axis_size(EXPERT_AXES) > 1:
                y_slots = mesh.all_reduce(y_slots.float(), EXPERT_AXES).to(
                    y_slots.dtype)
            y = y_slots.reshape(b, s, k, d).sum(dim=2)
        return y.to(x.dtype), c.router_aux_weight * aux


class MixtralBlock(nn.Module):
    """Pre-norm attention and MoE, each with its residual. forward(p, x,
    cos, sin) -> (x, the layer's weighted aux loss), p = one
    ``layer_{i}`` subtree."""

    def __init__(self, config: MixtralConfig):
        super().__init__()
        self.attention = LlamaAttention(config.attention_config())
        self.attention_norm = RMSNorm(config.norm_eps)
        self.moe = MixtralMoE(config)
        self.moe_norm = RMSNorm(config.norm_eps)

    def forward(self, p: dict, x, cos, sin) -> tuple:
        # A profiler span around the block, remat's recompute included.
        with record_function("mixtral/block"):
            x = x + self.attention(
                p["attention"], self.attention_norm(p["attention_norm"], x),
                cos, sin,
            )
            y, aux = self.moe(p["moe"], self.moe_norm(p["moe_norm"], x))
            return x + y, aux


class Mixtral(nn.Module):
    """tokens [b, s] int -> fp32 logits [b, s, vocab]. Stateless like the
    flax module: the weights come as ``params`` (a MixtralParams, or its
    nested dict) on each call; :meth:`apply_with_aux` also returns the
    load-balance loss summed over layers."""

    def __init__(self, config: MixtralConfig):
        super().__init__()
        self.config = config
        self.block = MixtralBlock(config)
        self.final_norm = RMSNorm(config.norm_eps)

    def apply_with_aux(self, params: "MixtralParams | dict",
                       tokens: torch.Tensor) -> tuple:
        """(logits, total aux loss): each layer's weighted aux, summed.
        On a training mesh, ``tokens`` are this rank's rows and sp chunk
        and so are the logits (the whole vocab); the aux is the global
        batch's, the same on every rank."""
        c = self.config
        mesh = _train_mesh()
        tree = param_tree(params)
        emb = _weight(mesh, {"kernel": tree["embed"]["embedding"]},
                      "embed/embedding", tp=True)["kernel"]
        x = F.embedding(tokens.to(device=emb.device, dtype=torch.long), emb)
        x = x.to(c.dtype)
        s = tokens.shape[1]
        start = 0 if mesh is None else mesh.index("sp") * s
        cos, sin = rope_frequencies(
            c.attention_config(), torch.arange(start, start + s, device=x.device)
        )
        total = 0.0
        for i in range(c.n_layers):
            block = functools.partial(self.block, tree[f"layer_{i}"])
            if c.remat:
                x, aux = checkpoint(block, x, cos, sin, use_reentrant=False)
            else:
                x, aux = block(x, cos, sin)
            total = total + aux
        x = self.final_norm(tree["final_norm"], x)
        head = _weight(mesh, tree["lm_head"], "lm_head/kernel", tp=True)
        return _mm(x, head).to(torch.float32), total

    def forward(self, tokens: torch.Tensor, *,
                params: "MixtralParams | dict") -> torch.Tensor:
        return self.apply_with_aux(params, tokens)[0]
