"""Ring attention: sequence (context) parallelism over the ``sp`` axis.

Counterpart of ``tpu_dra/workloads/parallel/ring_attention.py``. The
sequence is sharded over ``sp``; each rank holds one query chunk and
passes the K/V chunks around the ring (:meth:`.mesh.TrainMesh.ppermute`,
K and V stacked into one tensor so a step is one send and one receive,
and their backward sends cannot be issued in another order on another
rank), merging the partial results with the log-sum-exp accumulator.
Memory a rank is O(seq/sp).

Causality, as in JAX: rank ``i`` attends chunk ``j`` fully when
``j < i``, causally when ``j == i``, and not at all when ``j > i``. The
port decides the mode on the host, so a skipped chunk launches nothing
(JAX masks it): at sp=2, rank 0 runs one chunk a layer, rank 1 two.

Unlike JAX, which takes the global arrays under ``shard_map``,
``ring_attention`` takes this rank's local block: the rows of its
``(dp, fsdp)`` coordinate and the positions of its ``sp`` chunk.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.workloads.ops.attention import (
    NEG_INF,
    _repeat_kv,
    flash_attention_with_lse,
    sequence_attention,
)
from tpu_dra_torch.workloads.parallel.context import sequence_parallel_plan

AXIS = "sp"


def _pick_block(s: int) -> int:
    for cand in (256, 128, 64):
        if s % cand == 0:
            return cand
    return 0


def _flash_ok(q, k) -> bool:
    """Run each chunk pair through the flash kernels (their plain
    versions off the card) when the local shapes qualify by JAX's rules:
    hd a multiple of 64 and a chunk a whole number of 64-row blocks.
    JAX also asks for a TPU (or interpret mode) and for one kv head's
    chunk to fit the VMEM its kernels pin; the port's kernels pin none."""
    del k
    return q.shape[-1] % 64 == 0 and _pick_block(q.shape[1]) > 0


def _partial_attention(q, k, v, causal: bool, m, l, acc):
    """One chunk pair, full or causal-diagonal, by the online softmax.

    q: [b, sq, h, hd]; k/v: [b, sk, h, hd]; m/l: [b, h, sq]; acc like q
    but fp32. Returns the merged (m, l, acc)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    acc_new = acc * alpha.transpose(1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def _flash_chunk(q, k_cur, v_cur, causal: bool, lse, acc):
    """One chunk pair through the flash kernels; partials merge by
    logsumexp (each flash output is already normalized, so the merged
    accumulator needs no final division). The merge gives the chunk's
    lse a cotangent, which the flash backward folds into its delta."""
    bq, bk = _pick_block(q.shape[1]), _pick_block(k_cur.shape[1])
    out_c, lse_c = flash_attention_with_lse(q, k_cur, v_cur, causal, bq, bk)
    new_lse = torch.logaddexp(lse, lse_c)
    w_prev = torch.exp(lse - new_lse).transpose(1, 2)[..., None]
    w_cur = torch.exp(lse_c - new_lse).transpose(1, 2)[..., None]
    return new_lse, acc * w_prev + out_c.float() * w_cur


class _Tie(torch.autograd.Function):
    """``acc`` itself, with ``kv`` as an input whose gradient is zero: a
    skipped chunk still reaches the loss, so its rotation's backward
    runs and every rank of the ring issues the same backward sends (in
    JAX the masked chunk gives the same zero cotangent)."""

    @staticmethod
    def forward(ctx, acc, kv):
        ctx.kv = (kv.shape, kv.dtype, kv.device)
        return acc.view_as(acc)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _ring_attention_local(q, k, v, *, mesh, axis_name: str):
    """The ring on this rank's chunks: n steps, n - 1 rotations (JAX
    rotates once more to bring the chunks home, which nothing reads)."""
    n = mesh.axis_size(axis_name)
    i = mesh.index(axis_name)
    b, sq, h, hd = q.shape
    use_flash = _flash_ok(q, k)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    n_rep = h // k.shape[2]
    kv = torch.stack([k, v])
    for t in range(n):
        j = (i - t) % n  # the chunk held now
        if j <= i:
            k_cur, v_cur = kv[0], kv[1]
            if use_flash:
                # GQA is native to the kernels: K/V stay at kvh heads, so
                # the ring moves n_rep x fewer bytes.
                m, acc = _flash_chunk(q, k_cur, v_cur, j == i, m, acc)
            else:
                m, l, acc = _partial_attention(
                    q, _repeat_kv(k_cur, n_rep), _repeat_kv(v_cur, n_rep),
                    j == i, m, l, acc)
        elif torch.is_grad_enabled() and kv.requires_grad:
            acc = _Tie.apply(acc, kv)
        if t < n - 1:
            # To the next rank; after this, this rank holds chunk j - 1.
            kv = mesh.ppermute(kv, axis_name, 1)
    if use_flash:
        out = acc  # flash partials are pre-normalized; weights sum to 1
    else:
        out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = AXIS, mesh=None) -> torch.Tensor:
    """Causal ring attention over this rank's block: q [b, s/sp, h, hd],
    k/v [b, s/sp, kvh, hd], the rank's rows and ``sp`` chunk. Falls back
    to single-device attention when no mesh is active or ``sp`` is 1."""
    plan = sequence_parallel_plan(axis_name, mesh)
    if plan is None:
        return sequence_attention(q, k, v)
    return _ring_attention_local(q, k, v, mesh=plan[0], axis_name=axis_name)
