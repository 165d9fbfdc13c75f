"""KV-cache decoding for Llama: the per-layer helpers the engine shares,
and the fixed-batch ``greedy_generate`` path.

Counterpart of ``tpu_dra/workloads/generate.py``:

- the decoder-layer halves ``_project_qkv``/``_finish_block`` (a
  hand-rolled replay of the Llama layer over the unrolled parameter
  tree; ``_rms`` and ``_mm`` live in ops/decode_mlp.py, whose plain
  chain is also the s>1 MLP here). The s=1 step routes its norm+MLP
  chain through the fused block — the CUDA kernel on the card for plain
  kernels, the plain chain of int8mm launches for an int8 tree;
- ``DecodeCache``/``init_cache``/``forward_chunk``/``greedy_generate``:
  prefill + incremental decode over a contiguous per-layer cache
  ``[b, max_seq, kvh, hd]`` (model dtype, or int8 with per-(token, kv
  head) f32 scales), written in place. The s=1 step attends through
  ops/attention.py ``decode_attention`` (``csrc/decode.cu`` on the
  card).

Only the unrolled, in-place layout is ported: a stacked tree is
unrolled at entry. The JAX stacked layout feeds the newest token's K/V
into the decode step unquantized (``extra_k``/``extra_v``), while its
unrolled layout quantizes that token into the cache first; with an int8
cache the two differ, and this port matches the **unrolled** one.

Over a decode mesh (``parallel/mesh.py`` ``shard_decode_params``, as
JAX's ``greedy_generate`` over decode-sharded params): the tree carries
its mesh, the layers run on this rank's heads and ffn columns with the
config kept (the decode kernels take a shard, the attention planned as
the unsharded heads'; JAX's ``sharded_safe_config`` forces XLA there),
the cache holds its kv heads, and the attention output, ``silu(gate)·up``
(between the MLP's two halves) and the logits are gathered over the
model axis; rows stay whole (replicated over the batch axis).

``DecodeCache.pos`` is a host int: positions, cache slices and the
decode kernel's length are known on the host, so the decode loop needs
no device->host sync; the generated tokens stay on the device and are
copied to the host once, at the end.

Sampling: ``sample_token`` is the temperature / top-k draw with
``jax.random``'s bits (the fused pick of ops/sample.py, ``csrc/sample.cu``
on the card), ``topk_exact`` its ``lax.top_k``-ordered candidates, and
``sample_generate`` / ``sample_generate_unfused`` the sampled twins of
``greedy_generate`` with JAX's ``fold_in(rng, step)`` key schedule.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from tpu_dra_torch.workloads.convert import unroll_tree
from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.models.llama import (
    LlamaConfig,
    apply_rope,
    as_tree,
    rope_frequencies,
)
from tpu_dra_torch.workloads.ops.attention import NEG_INF, decode_attention
from tpu_dra_torch.workloads.ops.decode_mlp import (
    _mm,
    _rms,
    _torch_decode_mlp,
    decode_mlp,
)
# topk_exact lives beside the kernel it feeds; JAX keeps it here.
from tpu_dra_torch.workloads.ops.sample import (  # noqa: F401
    sample_pick,
    topk_exact,
)
from tpu_dra_torch.workloads.parallel.mesh import (
    check_decode_config,
    gather_model,
    local_kv_heads,
    params_mesh,
    with_mesh,
)
from tpu_dra_torch.workloads.quantize import quantize_kv, quantize_params
from tpu_dra_torch.workloads.sampling import MASK32, fold_in

KV_QUANT_MODES = ("none", "int8")
WEIGHT_QUANT_MODES = ("none", "int8")


def _maybe_quantize_params(params: dict, weight_quant: str) -> dict:
    """int8 weight-only on the whole path (prefill, every projection and
    MLP matmul, the logits head): the tree with its 2D kernels quantized
    (quantize.quantize_params), or the tree itself for "none"."""
    if weight_quant == "none":
        return params
    if weight_quant not in WEIGHT_QUANT_MODES:
        raise ValueError(
            f"unknown weight_quant {weight_quant!r}; expected one of "
            f"{WEIGHT_QUANT_MODES}"
        )
    return quantize_params(params)


# The JAX name of the stacked -> ``layer_{i}`` conversion.
unroll_params = unroll_tree


@dataclasses.dataclass
class DecodeCache:
    """Per-layer contiguous KV cache, mutated in place. ``k``/``v``:
    L-lists of ``[b, max_seq, kvh, hd]`` (model dtype, or int8 with
    L-lists of ``[b, max_seq, kvh]`` f32 ``k_scale``/``v_scale``);
    ``pos``: the number of positions written (a host int, the same for
    every layer and row).

    INVARIANT: slots at positions >= pos are zero, scales included.
    ``init_cache`` makes it so and ``forward_chunk`` keeps it (each
    chunk writes exactly [pos, pos+s)); after moving ``pos`` back by
    hand, :meth:`zero_tail` re-establishes it."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    pos: int = 0
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[1]

    def _buffers(self):
        bufs = list(self.k) + list(self.v)
        if self.quantized:
            bufs += list(self.k_scale) + list(self.v_scale)
        return bufs

    def zero_tail(self) -> "DecodeCache":
        """Zero every slot at positions >= pos (values and scales), in
        place; returns the cache itself."""
        for buf in self._buffers():
            buf[:, self.pos:] = 0
        return self

    def tail_is_zero(self) -> bool:
        """Does the zero-tail invariant hold?"""
        return all(
            not bool(buf[:, self.pos:].to(torch.float32).abs().sum() != 0)
            for buf in self._buffers()
        )


def init_cache(
    config: LlamaConfig,
    batch: int,
    max_seq: int,
    kv_quant: str = "none",
    device=None,
    mesh=None,
) -> DecodeCache:
    """A zeroed cache on ``device`` (default: the CUDA device, see
    :func:`.device.resolve_device`), of this rank's kv heads on a decode
    ``mesh``."""
    device = resolve_device(device)
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(
            f"unknown kv_quant {kv_quant!r}; expected one of {KV_QUANT_MODES}"
        )
    quant = kv_quant == "int8"
    kv_dtype = torch.int8 if quant else config.dtype
    kvh = local_kv_heads(mesh, config.n_kv_heads)
    shape = (batch, max_seq, kvh, config.head_dim)
    sshape = (batch, max_seq, kvh)
    L = config.n_layers

    def zeros(shp, dtype):
        return [torch.zeros(shp, dtype=dtype, device=device) for _ in range(L)]

    return DecodeCache(
        k=zeros(shape, kv_dtype),
        v=zeros(shape, kv_dtype),
        k_scale=zeros(sshape, torch.float32) if quant else None,
        v_scale=zeros(sshape, torch.float32) if quant else None,
    )


def _project_qkv(c: LlamaConfig, lp: dict, x, cos, sin, b: int, s: int):
    """Front half of a decoder layer: pre-norm + roped q/k/v, over the
    heads the projections hold (all of them, or a model shard's)."""
    att = lp["attention"]
    h = _rms(x, lp["attention_norm"]["scale"], c.norm_eps)
    q = _mm(h, att["wq"]).reshape(b, s, -1, c.head_dim)
    k = _mm(h, att["wk"]).reshape(b, s, -1, c.head_dim)
    v = _mm(h, att["wv"]).reshape(b, s, -1, c.head_dim)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _finish_block(c: LlamaConfig, lp: dict, x, out, b: int, s: int,
                  mesh=None):
    """Back half: attention output projection + residual MLP. The s=1
    decode step takes the fused block (ops/decode_mlp.py). On a decode
    ``mesh`` the attention output of this rank's heads is gathered over
    the model axis before the replicated ``wo``, and the MLP gathers
    ``silu(gate)·up`` before ``w_down``."""
    att = lp["attention"]
    out = gather_model(mesh, out.reshape(b, s, -1))
    x = x + _mm(out, att["wo"])
    scale = lp["mlp_norm"]["scale"]
    if s == 1:
        return decode_mlp(
            x[:, 0], scale, lp["mlp"], c.norm_eps, impl=c.decode_mlp_impl,
            mesh=mesh,
        )[:, None]
    return _torch_decode_mlp(x, scale, lp["mlp"], c.norm_eps, mesh)


def _key_scale_cols(s: torch.Tensor) -> torch.Tensor:
    """[b, max_seq, kvh] per-key scale -> [b, kvh, 1, 1, max_seq]
    broadcastable against [b, kvh, n_rep, s, max_seq] chunk scores."""
    return s.permute(0, 2, 1)[:, :, None, None, :]


def _attend_chunk_scores(c, qg, ck, ks):
    """Chunk queries [b, s, kvh, n_rep, hd] against a whole single-layer
    cache: fp32 scores, the int8 cache converted to the model dtype and
    its per-key scale on the score columns."""
    kc = ck.to(c.dtype) if ks is not None else ck
    logits = torch.einsum(
        "bqhrd,bkhd->bhrqk", qg.float(), kc.float()
    ) * (c.head_dim ** -0.5)
    if ks is not None:
        logits = logits * _key_scale_cols(ks)
    return logits


def _attend_chunk_values(c, probs, cv, vs):
    """fp32 probabilities times the cache values: an int8 cache's
    per-key v scale folds into the probabilities (fp32) before they are
    rounded to the model dtype for the value contraction."""
    if vs is not None:
        pv = (probs * _key_scale_cols(vs)).to(c.dtype)
        vc = cv.to(c.dtype)
    else:
        pv = probs.to(cv.dtype)
        vc = cv
    return torch.einsum("bhrqk,bkhd->bqhrd", pv.float(), vc.float())


def _write_cache(ck, cv, ks, vs, k, v, pos: int):
    """Write a fresh [b, s, kvh, hd] K/V chunk at ``pos``, in place —
    quantized in flight when the cache is int8 (ks/vs not None)."""
    s = k.shape[1]
    if ks is not None:
        k, ksc = quantize_kv(k)
        v, vsc = quantize_kv(v)
        ks[:, pos:pos + s] = ksc
        vs[:, pos:pos + s] = vsc
    ck[:, pos:pos + s] = k
    cv[:, pos:pos + s] = v


def _block_inplace(c, lp, x, ck, cv, ks, vs, pos: int, mask, cos, sin,
                   b: int, s: int, mesh=None):
    """One decoder layer over its cache: append this chunk's K/V in
    place (quantizing in flight), then attend over the updated buffer.
    The s=1 step attends through ``decode_attention``."""
    q, k, v = _project_qkv(c, lp, x, cos, sin, b, s)
    _write_cache(ck, cv, ks, vs, k, v, pos)
    if s == 1:
        out = decode_attention(
            q[:, 0], ck, cv, pos + 1, k_scale=ks, v_scale=vs,
            impl=c.decode_impl, block_k=c.decode_block_k,
            plan_kv_heads=c.n_kv_heads,
        )[:, None].to(c.dtype)
    else:
        n_rep = c.n_heads // c.n_kv_heads
        qg = q.reshape(b, s, -1, n_rep, c.head_dim)
        logits = _attend_chunk_scores(c, qg, ck, ks)
        logits = torch.where(
            mask[None, None, None], logits, torch.full_like(logits, NEG_INF)
        )
        probs = torch.softmax(logits, dim=-1)
        out = _attend_chunk_values(c, probs, cv, vs).to(c.dtype)
    return _finish_block(c, lp, x, out, b, s, mesh)


def forward_chunk(
    config: LlamaConfig, params: dict, cache: DecodeCache,
    tokens: torch.Tensor,
) -> torch.Tensor:
    """Process ``tokens`` [b, s] at positions ``cache.pos ..
    cache.pos+s-1`` of an unrolled tree: write their K/V into ``cache``
    in place, attend over everything written so far, advance
    ``cache.pos`` and return fp32 logits [b, s, vocab]. Prefill is a
    long chunk; a decode step is s=1 and runs ``decode_attention``.
    Over a tree from ``shard_decode_params`` (its mesh on the tree, the
    cache of this rank's kv heads) the logits are gathered over the model
    axis."""
    c = config
    mesh = params_mesh(params)
    if "layers" in params:
        raise ValueError(
            "forward_chunk takes the unrolled layer_{i} tree; unroll a "
            "stacked tree first (unroll_params)"
        )
    b, s = tokens.shape
    pos = cache.pos
    if pos + s > cache.max_seq:
        raise ValueError(
            f"cache full: pos {pos} + {s} tokens > max_seq {cache.max_seq}"
        )
    dev = tokens.device
    x = params["embed"]["embedding"].to(c.dtype)[tokens.long()]  # [b, s, d]
    positions = pos + torch.arange(s, device=dev)
    cos, sin = rope_frequencies(c, positions)  # [s, hd/2]
    # Key j is visible to query i iff j <= pos + i (prefill chunks only;
    # the s=1 step's mask is decode_attention's length).
    mask = (
        torch.arange(cache.max_seq, device=dev)[None, :] <= positions[:, None]
    )
    for i in range(c.n_layers):
        x = _block_inplace(
            c, params[f"layer_{i}"], x, cache.k[i], cache.v[i],
            cache.k_scale[i] if cache.quantized else None,
            cache.v_scale[i] if cache.quantized else None,
            pos, mask, cos, sin, b, s, mesh,
        )
    cache.pos = pos + s
    x = _rms(x, params["final_norm"]["scale"], c.norm_eps)
    return gather_model(mesh, _mm(x, params["lm_head"]).to(torch.float32))


def _generate(
    config: LlamaConfig,
    params,
    prompt: torch.Tensor,
    max_new_tokens: int,
    max_seq: int,
    pick,
    kv_quant: str = "none",
    weight_quant: str = "none",
    device=None,
) -> torch.Tensor:
    """Prefill + a loop of s=1 steps; ``pick(logits [b, vocab], i)``
    chooses the token of step i. The tokens stay on the device and are
    copied to the host once, at the end. A tree from
    ``shard_decode_params`` runs sharded over its mesh, on ``config``
    itself (the kernels on the rank's shard)."""
    device = resolve_device(device)
    mesh = params_mesh(params)
    if mesh is not None:
        check_decode_config(config, mesh)
    tree = unroll_params(as_tree(params, device))
    tree = with_mesh(_maybe_quantize_params(tree, weight_quant), mesh)
    prompt = torch.as_tensor(prompt, device=device)
    b, s = prompt.shape
    if not max_seq:
        # Auto-sized caches round up to a 64 granule, as the JAX path
        # does: the plain decode loop's block must divide max_seq.
        max_seq = -(-(s + max_new_tokens) // 64) * 64
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if max_seq < s + max_new_tokens:
        raise ValueError(
            f"cache too small: max_seq={max_seq} < prompt {s} + "
            f"max_new_tokens {max_new_tokens}"
        )
    cache = init_cache(config, b, max_seq, kv_quant, device=device,
                       mesh=mesh)
    logits = forward_chunk(config, tree, cache, prompt)
    tok = pick(logits[:, -1], 0).to(prompt.dtype)
    out = [tok]
    for i in range(1, max_new_tokens):
        logits = forward_chunk(config, tree, cache, tok[:, None])
        tok = pick(logits[:, -1], i).to(prompt.dtype)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1).cpu()


def greedy_generate(
    config: LlamaConfig,
    params,
    prompt: torch.Tensor,
    max_new_tokens: int,
    max_seq: int = 0,
    kv_quant: str = "none",
    weight_quant: str = "none",
    device=None,
) -> torch.Tensor:
    """Greedy-decode ``max_new_tokens`` after ``prompt`` [b, s] (int
    token ids); returns [b, s + max_new_tokens] on the host. Runs on
    ``device`` (default: the CUDA device, see
    :func:`.device.resolve_device`). ``kv_quant="int8"`` stores the
    cache int8 with per-(token, kv head) scales; ``weight_quant="int8"``
    runs every matmul of the path (projections, MLP, logits) over the
    int8 weight-only tree. The params may be a LlamaParams, or a nested
    dict in either layout, plain or already quantized, or this rank's
    shard from ``shard_decode_params`` (every rank of its mesh calls
    with the same prompt). Ties go to the lowest id, as ``jnp.argmax``
    does."""
    return _generate(
        config, params, prompt, max_new_tokens, max_seq,
        pick=lambda logits, _i: torch.argmax(logits, dim=-1),
        kv_quant=kv_quant, weight_quant=weight_quant, device=device,
    )


# --- sampling -----------------------------------------------------------------


def _key_tensor(rng, device) -> torch.Tensor:
    """A key's two words as an int64 [2] tensor on ``device``: a torch
    key as it is, or any array of two integers (jax.random.key_data's
    uint32 pair, a list)."""
    if isinstance(rng, torch.Tensor):
        key = rng.to(device=device, dtype=torch.int64)
    else:
        key = torch.as_tensor(
            np.asarray(rng, dtype=np.int64) & MASK32, device=device)
    if tuple(key.shape) != (2,):
        raise ValueError(f"rng is a key of 2 words, got {tuple(key.shape)}")
    return key


def sample_token(
    logits: torch.Tensor,
    rng: torch.Tensor,
    temperature: float,
    top_k: int,
    fold: "int | None" = None,
) -> torch.Tensor:
    """Temperature / top-k draw: [b, vocab] logits -> [b] int32 ids, the
    bits of JAX's ``sample_token(logits, rng, temperature, top_k)`` —
    with ``fold``, of ``sample_token(logits, fold_in(rng, fold), ...)``,
    the fold made inside the kernel. ``top_k > 0`` draws over the k
    candidates (``topk_exact`` order) and maps back through their ids;
    ``top_k == 0`` over the whole vocab. One launch of the fused pick
    (ops/sample.py) on the card; its plain version on the CPU."""
    return sample_pick(
        logits, temperature, top_k, key=_key_tensor(rng, logits.device),
        fold=fold,
    )


def _check_sampling(config: LlamaConfig, temperature: float,
                    top_k: int) -> bool:
    """True when the draw is greedy (temperature <= 0 or top_k == 1)."""
    if not 0 <= top_k <= config.vocab_size:
        raise ValueError(
            f"top_k={top_k} out of range for vocab {config.vocab_size}"
        )
    return temperature <= 0.0 or top_k == 1


def sample_generate(
    config: LlamaConfig,
    params,
    prompt: torch.Tensor,
    max_new_tokens: int,
    rng,
    temperature: float = 1.0,
    top_k: int = 0,
    max_seq: int = 0,
    kv_quant: str = "none",
    weight_quant: str = "none",
    device=None,
) -> torch.Tensor:
    """Temperature / top-k sampling over the same cache machinery: step
    i draws with ``fold_in(rng, i)`` over the [b, vocab] block (one key
    for the batch), the fold and the draw in one launch, and the tokens
    stay on the device until the end. ``rng`` is a key of two words
    (:func:`.sampling.prng_key`, or JAX's key data). ``top_k=0`` samples
    the whole distribution; ``top_k=1`` or ``temperature <= 0`` are
    greedy_generate."""
    if _check_sampling(config, temperature, top_k):
        return greedy_generate(
            config, params, prompt, max_new_tokens, max_seq,
            kv_quant=kv_quant, weight_quant=weight_quant, device=device,
        )
    key = _key_tensor(rng, resolve_device(device))
    return _generate(
        config, params, prompt, max_new_tokens, max_seq,
        pick=lambda logits, i: sample_token(
            logits, key, temperature, top_k, fold=i),
        kv_quant=kv_quant, weight_quant=weight_quant, device=device,
    )


def sample_generate_unfused(
    config: LlamaConfig,
    params,
    prompt: torch.Tensor,
    max_new_tokens: int,
    rng,
    temperature: float = 1.0,
    top_k: int = 0,
    max_seq: int = 0,
    kv_quant: str = "none",
    weight_quant: str = "none",
    device=None,
) -> torch.Tensor:
    """The parity oracle of :func:`sample_generate`: every token goes to
    the host and back before the next step, and each step's key is
    folded by :func:`.sampling.fold_in` (plain torch) before the draw,
    so the same ``rng`` must give identical tokens."""
    if _check_sampling(config, temperature, top_k):
        return greedy_generate(
            config, params, prompt, max_new_tokens, max_seq,
            kv_quant=kv_quant, weight_quant=weight_quant, device=device,
        )
    dev = resolve_device(device)
    key = _key_tensor(rng, dev)

    def pick(logits, i):
        tok = sample_token(logits, fold_in(key, i), temperature, top_k)
        return torch.as_tensor(tok.cpu().numpy(), device=dev)

    return _generate(
        config, params, prompt, max_new_tokens, max_seq, pick=pick,
        kv_quant=kv_quant, weight_quant=weight_quant, device=device,
    )
