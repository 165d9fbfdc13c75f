"""Paged (block-table) attention for the serving engine.

Counterpart of the paged part of ``tpu_dra/workloads/ops/attention.py``.
The KV cache is a shared pool of fixed-size pages per layer
(``[num_pages, page_size, kvh, hd]``) and each sequence owns a block
table of page ids; see that module for the layout's rationale.

- :func:`paged_decode_attention`: one query per slot. ``impl="cuda"`` is
  the hand-written Hopper kernel (``csrc/paged_decode.cu``, the port of
  the Pallas ``_paged_decode_kernel``); ``"torch"`` is the twin of the
  JAX page walk ``_xla_paged_decode_attention``; ``"reference"`` the
  twin of its fp32 oracle. ``"auto"`` launches the kernel for CUDA
  tensors and takes ``"torch"`` for CPU tensors; a CUDA tensor never
  falls back.
- :func:`paged_multiquery_attention`: s queries per sequence (batched
  prefill). The JAX package has no Pallas kernel for it, so plain
  PyTorch is its port here; a kernel is later work.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_dra_torch import kernels

NEG_INF = -1e30

_LAST_PAGED_IMPL = None  # set per call; tests and the smoke assert on it
_LAST_MULTIQUERY_IMPL = None

# Storage-type codes of csrc/common.cuh.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _group_scale(s):
    """[b, skv, kvh] per-key scale -> [b, kvh, 1, skv] broadcastable
    against grouped [b, kvh, n_rep, skv] scores (None passes through)."""
    return None if s is None else s.permute(0, 2, 1)[:, :, None, :]


def _gather_flat(pool, tables):
    """[P, page, ...] pool through [b, max_pages] tables ->
    [b, max_pages*page, ...]."""
    b, max_pages = tables.shape
    g = pool[tables.long()]  # [b, max_pages, page, ...]
    return g.reshape((b, max_pages * pool.shape[1]) + tuple(pool.shape[2:]))


def reference_paged_decode_attention(
    q, k_pages, v_pages, tables, lengths, k_scale=None, v_scale=None
):
    """Naive fp32 oracle: gather every table entry into a contiguous
    per-sequence view and run a masked softmax. Tests only."""
    b, h, hd = q.shape
    kvh = k_pages.shape[2]
    n_rep = h // kvh
    kf = _gather_flat(k_pages, tables).to(torch.float32)
    vf = _gather_flat(v_pages, tables).to(torch.float32)
    skv = kf.shape[1]
    qg = q.reshape(b, kvh, n_rep, hd).to(torch.float32)
    logits = torch.einsum("bhrd,bkhd->bhrk", qg, kf) * (hd ** -0.5)
    if k_scale is not None:
        logits = logits * _group_scale(_gather_flat(k_scale, tables))
    cols = torch.arange(skv, device=q.device)
    mask = cols[None, None, None, :] < lengths.to(q.device)[:, None, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    # A fully-dead row (length 0) softmaxes NEG_INF uniformly; zero it
    # so dead slots return exactly 0 like the online path.
    probs = torch.where(mask, probs, torch.zeros_like(probs))
    if v_scale is not None:
        probs = probs * _group_scale(_gather_flat(v_scale, tables))
    out = torch.einsum("bhrk,bkhd->bhrd", probs, vf)
    return out.reshape(b, h, hd).to(q.dtype)


def _torch_paged_decode_attention(
    q, k_pages, v_pages, tables, lengths, k_scale, v_scale
):
    """Length-aware block-table walk: a loop over page-sized KV blocks
    up to the longest live sequence's last page, each gathered through
    the per-sequence table, carrying fp32 (m, l, acc). Shorter
    sequences' dead columns (and dead slots entirely) are masked."""
    b, h, hd = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    n_rep = h // kvh
    scale = hd ** -0.5
    qg = q.reshape(b, kvh, n_rep, hd)
    max_len = int(lengths.max()) if b else 0
    num_blocks = -(-max_len // page)
    if num_blocks > tables.shape[1]:
        raise ValueError(
            f"length {max_len} exceeds the block table "
            f"({tables.shape[1]} pages of {page})"
        )
    lens = lengths.to(q.device)[:, None, None, None]
    dev = q.device
    m = torch.full((b, kvh, n_rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, n_rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, n_rep, hd), dtype=torch.float32, device=dev)
    tables_l = tables.long()
    for i in range(num_blocks):
        pids = tables_l[:, i]  # [b]
        kb = k_pages[pids]  # [b, page, kvh, hd]
        vb = v_pages[pids]
        s = torch.einsum(
            "bhrd,bkhd->bhrk", qg.float(), kb.to(qg.dtype).float()
        ) * scale
        if k_scale is not None:
            s = s * _group_scale(k_scale[pids])
        cols = i * page + torch.arange(page, device=dev)
        s = torch.where(
            cols[None, None, None, :] < lens, s, torch.full_like(s, NEG_INF)
        )
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if v_scale is not None:
            p = p * _group_scale(v_scale[pids])
        acc = acc * alpha[..., None] + torch.einsum(
            "bhrk,bkhd->bhrd",
            p.to(qg.dtype).float(), vb.to(qg.dtype).float(),
        )
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    # A slot with no live key never raises m above NEG_INF, so its
    # masked scores exponentiate to 1 and `out` would average whatever
    # its table's pages hold — zero it explicitly (the dead-slot
    # contract). Live slots pass through unchanged.
    out = torch.where(lens > 0, out, torch.zeros_like(out))
    return out.reshape(b, h, hd).to(q.dtype)


_PAGED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p,
]


def _cuda_paged_decode_attention(
    q, k_pages, v_pages, tables, lengths, k_scale, v_scale
):
    """Launch csrc/paged_decode.cu on q's stream. Takes bf16 or fp32
    pools of q's dtype, hd in {64, 128}, n_rep in {1, 2, 4, 8}, any
    page size; raises on anything else. Lengths are read on the device
    only (no host sync): one past max_pages*page turns that slot's
    output into NaN, and the kernel never reads past the table."""
    if k_scale is not None:
        raise NotImplementedError(
            "the CUDA paged-decode kernel takes model-dtype pools; the "
            "int8 K/V branch is not ported yet"
        )
    b, h, hd = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    n_rep = h // kvh
    tensors = (q, k_pages, v_pages, tables, lengths)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("impl='cuda' needs every input on one CUDA device")
    if q.dtype not in _DTYPE_CODES or {k_pages.dtype, v_pages.dtype} != {
        q.dtype
    }:
        raise ValueError(
            f"impl='cuda' takes bf16 or fp32 q and pools of q's dtype, got "
            f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}"
        )
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("impl='cuda' needs int32 tables and lengths")
    if hd not in (64, 128) or n_rep not in (1, 2, 4, 8):
        raise ValueError(
            f"impl='cuda' takes head_dim 64 or 128 and n_rep 1/2/4/8, got "
            f"head_dim {hd}, n_rep {n_rep}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("impl='cuda' needs contiguous inputs")
    out = torch.empty_like(q)
    fn = kernels.function(
        "paged_decode.cu", "tpu_paged_decode_attention", _PAGED_ARGTYPES
    )
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], b, kvh, n_rep, hd, page, tables.shape[1],
        hd ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(err, "paged_decode_attention")
    kernels.LAUNCHES["paged_decode_attention"] += 1
    return out


def paged_decode_attention(
    q, k_pages, v_pages, tables, lengths, k_scale=None, v_scale=None,
    impl: str = "auto",
):
    """Single-query GQA attention over a paged KV pool.

    q: [b, h, hd] (one query per slot); k_pages/v_pages: [num_pages,
    page_size, kvh, hd] shared pools (model dtype, or int8 with
    [num_pages, page_size, kvh] ``k_scale``/``v_scale`` pools on the
    torch/reference paths); tables: [b, max_pages_per_seq] int32 —
    entry j of row i is the page holding positions [j*page, (j+1)*page)
    of slot i; lengths: [b] int32 — keys at positions >= lengths[i] are
    dead (a 0 length gives exact zeros). impl: "auto" | "cuda" |
    "torch" | "reference". Returns [b, h, hd] in q's dtype.
    """
    b, h, hd = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != hd:
        raise ValueError(
            f"paged cache shape mismatch: q {tuple(q.shape)} vs k_pages "
            f"{tuple(k_pages.shape)} v_pages {tuple(v_pages.shape)}"
        )
    kvh = k_pages.shape[2]
    if h % kvh:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({kvh})"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be provided together")
    if tables.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(
            f"tables {tuple(tables.shape)} / lengths "
            f"{tuple(lengths.shape)} do not match batch {b}"
        )
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    global _LAST_PAGED_IMPL
    _LAST_PAGED_IMPL = impl
    if impl == "cuda":
        return _cuda_paged_decode_attention(
            q, k_pages, v_pages, tables, lengths, k_scale, v_scale
        )
    if impl == "torch":
        return _torch_paged_decode_attention(
            q, k_pages, v_pages, tables, lengths, k_scale, v_scale
        )
    if impl == "reference":
        return reference_paged_decode_attention(
            q, k_pages, v_pages, tables, lengths, k_scale, v_scale
        )
    raise ValueError(f"unknown paged decode attention impl: {impl!r}")


def reference_paged_multiquery_attention(
    q, k_pages, v_pages, tables, pos, k_scale=None, v_scale=None
):
    """Naive fp32 oracle: q [b, s, h, hd]; query i of sequence b sits at
    absolute position pos[b] + i and sees keys at positions <= its own.
    Tests only."""
    b, s, h, hd = q.shape
    kvh = k_pages.shape[2]
    n_rep = h // kvh
    kf = _gather_flat(k_pages, tables).to(torch.float32)
    vf = _gather_flat(v_pages, tables).to(torch.float32)
    skv = kf.shape[1]
    qg = q.reshape(b, s, kvh, n_rep, hd).to(torch.float32)
    logits = torch.einsum("bshrd,bkhd->bhrsk", qg, kf) * (hd ** -0.5)
    if k_scale is not None:
        logits = logits * _gather_flat(k_scale, tables).permute(0, 2, 1)[
            :, :, None, None, :
        ]
    dev = q.device
    q_abs = pos.to(dev)[:, None] + torch.arange(s, device=dev)[None]  # [b, s]
    mask = (
        torch.arange(skv, device=dev)[None, None, None, None, :]
        <= q_abs[:, None, None, :, None]
    )
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask, probs, torch.zeros_like(probs))
    if v_scale is not None:
        probs = probs * _gather_flat(v_scale, tables).permute(0, 2, 1)[
            :, :, None, None, :
        ]
    out = torch.einsum("bhrsk,bkhd->bhrsd", probs, vf)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def _torch_paged_multiquery_attention(
    q, k_pages, v_pages, tables, pos, k_scale, v_scale
):
    """Block-table walk over s queries per sequence, carrying fp32
    (m, l, acc) per query: the twin of _xla_paged_multiquery_attention.
    A sequence whose frontier is earlier sees its later blocks fully
    masked — an exact zero contribution."""
    b, s, h, hd = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    n_rep = h // kvh
    scale = hd ** -0.5
    dev = q.device
    qg = q.reshape(b, s, kvh, n_rep, hd)
    pos = pos.to(dev)
    q_abs = pos[:, None] + torch.arange(s, device=dev)[None]  # [b, s]
    num_blocks = -(-(int(pos.max()) + s) // page) if b else 0
    num_blocks = min(num_blocks, tables.shape[1])
    m = torch.full((b, kvh, n_rep, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, n_rep, s), dtype=torch.float32, device=dev)
    acc = torch.zeros(
        (b, kvh, n_rep, s, hd), dtype=torch.float32, device=dev
    )
    tables_l = tables.long()
    for i in range(num_blocks):
        pids = tables_l[:, i]
        kb = k_pages[pids]  # [b, page, kvh, hd]
        vb = v_pages[pids]
        sc = torch.einsum(
            "bshrd,bkhd->bhrsk", qg.float(), kb.to(qg.dtype).float()
        ) * scale
        if k_scale is not None:
            sc = sc * k_scale[pids].permute(0, 2, 1)[:, :, None, None, :]
        cols = i * page + torch.arange(page, device=dev)
        mask = cols[None, None, None, None, :] <= q_abs[:, None, None, :, None]
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if v_scale is not None:
            p = p * v_scale[pids].permute(0, 2, 1)[:, :, None, None, :]
        acc = acc * alpha[..., None] + torch.einsum(
            "bhrsk,bkhd->bhrsd",
            p.to(qg.dtype).float(), vb.to(qg.dtype).float(),
        )
        m = m_new
    # Every query admits at least the key at its own position, so l is
    # strictly positive and no dead-row zeroing is needed.
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)


def paged_multiquery_attention(
    q, k_pages, v_pages, tables, pos, k_scale=None, v_scale=None,
    impl: str = "auto",
):
    """Causal multi-query GQA attention over a paged KV pool, batched
    over sequences with per-sequence chunk starts.

    q: [b, s, h, hd] — query i of sequence b is at absolute position
    pos[b] + i (its K/V already written: write-then-attend); tables:
    [b, max_pages_per_seq] int32; pos: [b] int32. impl: "auto" |
    "torch" | "reference" ("auto" is "torch" on every device: the JAX
    package has no kernel for this op either).
    """
    b, s, h, hd = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != hd:
        raise ValueError(
            f"paged cache shape mismatch: q {tuple(q.shape)} vs k_pages "
            f"{tuple(k_pages.shape)} v_pages {tuple(v_pages.shape)}"
        )
    kvh = k_pages.shape[2]
    if h % kvh:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({kvh})"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be provided together")
    if tables.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(
            f"tables {tuple(tables.shape)} / pos {tuple(pos.shape)} do not "
            f"match batch {b}"
        )
    if impl == "auto":
        impl = "torch"
    global _LAST_MULTIQUERY_IMPL
    _LAST_MULTIQUERY_IMPL = impl
    if impl == "torch":
        return _torch_paged_multiquery_attention(
            q, k_pages, v_pages, tables, pos, k_scale, v_scale
        )
    if impl == "reference":
        return reference_paged_multiquery_attention(
            q, k_pages, v_pages, tables, pos, k_scale, v_scale
        )
    raise ValueError(
        f"unknown paged multiquery attention impl: {impl!r}"
    )
