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

On a training mesh of more than one rank (the global one of
:mod:`..parallel.context`, which ``Trainer`` sets) the forward is this
rank's share of JAX's GSPMD program, its tokens the rank's rows and
``sp`` chunk, its parameters the rank's blocks (:mod:`..parallel.mesh`
``PARAM_RULES``): each weight is all-gathered over fsdp where it is
used; tp gives a rank ``n_heads/tp`` and ``n_kv_heads/tp`` heads and
``ffn_dim/tp`` columns, ``wq/wk/wv/w_gate/w_up`` column-parallel after
an identity whose backward all-reduces over tp, ``wo/w_down``
row-parallel with an fp32 all-reduce over tp after them; the embedding
and ``lm_head`` gather their tp blocks too (exact, the computation
around them replicated over tp); rope positions start at the rank's
chunk. Attention takes ring or Ulysses sequence parallelism by
``attention_impl``; any other impl with sp above 1 gathers K/V over sp
and runs the rank's queries as the suffix of the keys up to its chunk's
end, as GSPMD gathers the sequence for JAX.
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
from tpu_dra_torch.workloads.parallel.context import get_global_mesh


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
    # "cuda" | "torch" | "reference", or sequence parallelism on a
    # training mesh: "ring" | "ulysses". The block sizes are the JAX
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
    ParameterDicts, and a dict that mixes both (Mixtral's ``moe``) a
    ModuleDict that holds its tensor leaves as its own Parameters. The
    Parameters carry gradients only when ``trainable`` (and only
    floating leaves can)."""

    def param(v):
        return nn.Parameter(v, requires_grad=trainable and v.is_floating_point())

    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: param(v) for k, v in tree.items()})
    node = nn.ModuleDict({k: _to_module(v, trainable) for k, v in tree.items()
                          if not isinstance(v, torch.Tensor)})
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            node.register_parameter(k, param(v))
    return node


def _to_tree(module: nn.Module, detach: bool) -> dict:
    tree = {k: v.data if detach else v
            for k, v in module.named_parameters(recurse=False)}
    tree.update((k, _to_tree(v, detach)) for k, v in module.named_children())
    return tree


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


def _train_mesh():
    """The global training mesh when it spans more than one rank, else
    None (the single-device forward)."""
    mesh = get_global_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def _weight(mesh, p: dict, path: str, tp: bool = False) -> dict:
    """A ``{"kernel"}`` weight as a forward reads it: on a mesh, this
    rank's block gathered over fsdp (and tp with ``tp``)."""
    if mesh is None:
        return p
    return {"kernel": mesh.gather_param(p["kernel"], path, tp)}


def _tp_in(mesh, x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel region: identity, its gradient
    all-reduced over tp (Megatron's f)."""
    return x if mesh is None else mesh.all_reduce_grad(x, "tp")


def _tp_out(mesh, y: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel matmul: the tp partial sums added in
    fp32 (Megatron's g)."""
    if mesh is None or mesh.shape["tp"] == 1:
        return y
    return mesh.all_reduce(y.float(), "tp").to(y.dtype)


class LlamaAttention(nn.Module):
    """Projections, rope and causal GQA attention (ops/attention.py
    ``attention`` with ``config.attention_impl``; ring or Ulysses
    sequence parallelism for "ring" / "ulysses", which fall back to
    ``attention`` without a mesh). forward(p, x, cos, sin), p = {wq, wk,
    wv, wo}/kernel: on a training mesh this rank's blocks."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config

    def forward(self, p: dict, x, cos, sin) -> torch.Tensor:
        c = self.config
        mesh = _train_mesh()
        tp = 1 if mesh is None else mesh.shape["tp"]
        h, kvh = c.n_heads // tp, c.n_kv_heads // tp
        b, s, _ = x.shape
        x = _tp_in(mesh, x)
        q = _mm(x, _weight(mesh, p["wq"], "attention/wq/kernel"))
        k = _mm(x, _weight(mesh, p["wk"], "attention/wk/kernel"))
        v = _mm(x, _weight(mesh, p["wv"], "attention/wv/kernel"))
        q = apply_rope(q.reshape(b, s, h, c.head_dim), cos, sin)
        k = apply_rope(k.reshape(b, s, kvh, c.head_dim), cos, sin)
        v = v.reshape(b, s, kvh, c.head_dim)
        if c.attention_impl == "ulysses":
            from tpu_dra_torch.workloads.parallel.ulysses import (
                ulysses_attention,
            )

            out = ulysses_attention(q, k, v)
        elif c.attention_impl == "ring":
            from tpu_dra_torch.workloads.parallel.ring_attention import (
                ring_attention,
            )

            out = ring_attention(q, k, v)
        else:
            if mesh is not None and mesh.shape["sp"] > 1:
                k, v = _sequence_prefix(mesh, k, v)
            out = attention(
                q, k, v, causal=True, impl=c.attention_impl,
                block_q=c.attention_block_q, block_k=c.attention_block_k,
            )
        y = _mm(out.reshape(b, s, h * c.head_dim),
                _weight(mesh, p["wo"], "attention/wo/kernel"))
        return _tp_out(mesh, y)


def _sequence_prefix(mesh, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """K and V of every position up to the end of this rank's sp chunk:
    gathered over sp as one tensor (the backward reduce-scatters their
    gradients), so the rank's queries are the suffix of the keys and the
    causal offset of the flash kernels places them."""
    kv = mesh.all_gather(torch.stack([k, v]), "sp", 2)
    end = (mesh.index("sp") + 1) * k.shape[1]
    return kv[0, :, :end], kv[1, :, :end]


class LlamaMLP(nn.Module):
    """SwiGLU: w_down(silu(w_gate x) * w_up x). forward(p, x); on a
    training mesh w_gate/w_up column-parallel and w_down row-parallel
    over tp."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config

    def forward(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        mesh = _train_mesh()
        x = _tp_in(mesh, x)
        gate = _mm(x, _weight(mesh, p["w_gate"], "mlp/w_gate/kernel"))
        up = _mm(x, _weight(mesh, p["w_up"], "mlp/w_up/kernel"))
        y = _mm(F.silu(gate) * up,
                _weight(mesh, p["w_down"], "mlp/w_down/kernel"))
        return _tp_out(mesh, y)


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
    ``scan_layers`` only names the JAX layout. On a training mesh,
    ``tokens`` are this rank's rows and sp chunk, and so is the output;
    logits and hidden states span the whole vocab and width."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.block = LlamaBlock(config)
        self.final_norm = RMSNorm(config.norm_eps)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False, *,
                params: "LlamaParams | dict") -> torch.Tensor:
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
            c, torch.arange(start, start + s, device=x.device)
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
        head = _weight(mesh, tree["lm_head"], "lm_head/kernel", tp=True)
        return _mm(x, head).to(torch.float32)
