"""Decode-path attention: the serving engine's paged ops and the
fixed-batch path's contiguous decode.

Counterpart of the decode part of ``tpu_dra/workloads/ops/attention.py``.
The engine's KV cache is a shared pool of fixed-size pages per layer
(``[num_pages, page_size, kvh, hd]``) and each sequence owns a block
table of page ids; see that module for the layout's rationale. Every
op takes a cache of the model dtype or int8 with per-(token, kv head)
f32 scales, dequantized in flight (k_scale on the scores, v_scale on
the probabilities).

- :func:`paged_decode_attention`: one query per slot. ``impl="cuda"`` is
  the hand-written Hopper kernel (``csrc/paged_decode.cu``, the port of
  the Pallas ``_paged_decode_kernel``, both pool types); ``"torch"`` is
  the twin of the JAX page walk ``_xla_paged_decode_attention``;
  ``"reference"`` the twin of its fp32 oracle. ``"auto"`` launches the
  kernel for CUDA tensors and takes ``"torch"`` for CPU tensors; a CUDA
  tensor never falls back. The kernel splits each slot's keys over CTAs
  and merges the splits in a fixed order (:func:`split_plan`);
  ``"torch"`` with ``split_keys`` computes the same split-and-merge in
  plain PyTorch.
- :func:`paged_multiquery_attention`: s queries per sequence (batched
  prefill). The JAX package has no Pallas kernel for it, so plain
  PyTorch is its port here; a kernel is later work.
- :func:`decode_attention`: one query per row over a contiguous cache
  ``[b, max_seq, kvh, hd]`` with one live length (greedy_generate's s=1
  step). ``"cuda"`` is ``csrc/decode.cu``, the port of the Pallas
  ``_decode_kernel``; ``"torch"`` the twin of ``_xla_decode_attention``;
  ``"reference"`` of ``reference_decode_attention``; ``"auto"`` as above.
"""

from __future__ import annotations

import ctypes
import functools

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


# The split plan of csrc/decode_attention.cuh (flash-decoding): the keys
# of each (row, kv head) are cut into `splits` chunks of `chunk`
# positions, one CTA each, aiming at SPLIT_CTAS_PER_SM CTAs an SM.
# A chunk is whole tiles of the kernel's ring (kTile keys); SPLIT_MAX is
# its kMaxSplits (the combine holds one split's values a register).
SPLIT_TILE = 32
SPLIT_MIN_KEYS = 64
SPLIT_MAX = 32
SPLIT_CTAS_PER_SM = 8


def split_plan(batch: int, kvh: int, key_range: int, sm_count: int) -> tuple:
    """(splits, chunk) for the decode kernels: ``chunk`` positions a
    split, ``splits * chunk >= key_range``. Host-known values only (the
    paged kernel's key range is the table's capacity), so planning never
    waits on the device. One split means the kernel writes the output
    itself and no combine runs."""
    key_range = max(int(key_range), 1)
    want = -(-SPLIT_CTAS_PER_SM * sm_count // max(batch * kvh, 1))
    want = min(max(want, 1), SPLIT_MAX)
    chunk = -(-key_range // want)
    chunk = max(SPLIT_MIN_KEYS, -(-chunk // SPLIT_TILE) * SPLIT_TILE)
    return -(-key_range // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _split_workspace(q, splits: int):
    """The kernels' fp32 partials [b, h, splits, hd + 2] (acc, m, l);
    None for a one-split plan."""
    if splits == 1:
        return None
    b, h, hd = q.shape
    return torch.empty(
        (b, h, splits, hd + 2), dtype=torch.float32, device=q.device
    )


def _torch_split_decode(qg, k, v, k_scale, v_scale, lens, chunk: int):
    """The decode kernels' split-and-merge in plain PyTorch. qg [b, kvh,
    n_rep, hd]; k/v [b, R, kvh, hd] (qg's dtype, or int8 with [b, R,
    kvh] scales); keys at positions >= lens[i] are dead. Each split of
    ``chunk`` positions gets its (m, l, acc), as a CTA of
    decode_split_kernel does; splits with no live key are skipped, and
    the rest merge in split order, as decode_combine_kernel does. A row
    with no live key gives exact zeros. Returns fp32 [b, kvh, n_rep,
    hd]."""
    b, R, kvh, hd = k.shape
    splits = max(-(-R // chunk), 1)
    pad = splits * chunk - R
    dev = qg.device

    def cut(x):
        x = torch.nn.functional.pad(x, (0,) * (2 * (x.dim() - 2)) + (0, pad))
        return x.reshape((b, splits, chunk) + tuple(x.shape[2:]))

    kf, vf = cut(k).to(qg.dtype).float(), cut(v).to(qg.dtype).float()
    s = torch.einsum("bhrd,bnkhd->bhrnk", qg.float(), kf) * hd ** -0.5
    if k_scale is not None:
        s = s * cut(k_scale).permute(0, 3, 1, 2)[:, :, None]
    pos = torch.arange(splits * chunk, device=dev).reshape(splits, chunk)
    live = (pos[None] < lens.to(dev)[:, None, None])[:, None, None]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)  # [b, kvh, n_rep, splits]
    p = torch.where(live, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * cut(v_scale).permute(0, 3, 1, 2)[:, :, None]
    acc = torch.einsum("bhrnk,bnkhd->bhrnd", p.to(qg.dtype).float(), vf)
    has = live.any(dim=-1)
    m = torch.where(has, m, torch.full_like(m, NEG_INF))
    w = torch.where(
        has, torch.exp(m - m.amax(dim=-1, keepdim=True)), torch.zeros_like(m)
    )
    l_tot = (l * w).sum(dim=-1)
    acc_tot = (acc * w[..., None]).sum(dim=-2)
    return acc_tot / torch.clamp(l_tot, min=1e-30)[..., None]


def _torch_paged_decode_attention(
    q, k_pages, v_pages, tables, lengths, k_scale, v_scale, split_keys=None
):
    """Length-aware block-table walk: a loop over page-sized KV blocks
    up to the longest live sequence's last page, each gathered through
    the per-sequence table, carrying fp32 (m, l, acc). Shorter
    sequences' dead columns (and dead slots entirely) are masked.

    With ``split_keys``, the kernel's form instead: the table's capacity
    cut into splits of that many positions, merged as the combine
    kernel merges them (:func:`_torch_split_decode`)."""
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
    if split_keys is not None:
        gather = functools.partial(_gather_flat, tables=tables)
        out = _torch_split_decode(
            qg, gather(k_pages), gather(v_pages),
            None if k_scale is None else gather(k_scale),
            None if v_scale is None else gather(v_scale),
            lengths, split_keys,
        )
        return out.reshape(b, h, hd).to(q.dtype)
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


_PAGED_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p,
]


def _check_kv_layout(q, k, v) -> None:
    """The decode kernels read q, K and V in 16-byte vectors and index
    cache rows (all but the last two dims) with 32-bit ints."""
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("impl='cuda' needs 16-byte aligned q, k and v")
    if k.numel() // (k.shape[-1] * k.shape[-2]) >= 2 ** 31:
        raise ValueError("impl='cuda' takes caches of fewer than 2**31 rows")


def _check_kv_dtypes(q, k, v, k_scale, v_scale) -> int:
    """The KV storage code of csrc/decode_attention.cuh: 0 for k/v of
    q's dtype (bf16 or fp32), 1 for int8 k/v with f32 scales; raises
    on anything else."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"impl='cuda' takes bf16 or fp32 q, got {q.dtype}")
    if k_scale is None:
        if {k.dtype, v.dtype} != {q.dtype}:
            raise ValueError(
                f"impl='cuda' takes a cache of q's dtype or int8 with "
                f"scales, got {q.dtype}/{k.dtype}/{v.dtype}"
            )
        return 0
    if {k.dtype, v.dtype} != {torch.int8} or {
        k_scale.dtype, v_scale.dtype
    } != {torch.float32}:
        raise ValueError(
            f"impl='cuda' takes an int8 cache with f32 scales, got "
            f"{k.dtype}/{v.dtype} and {k_scale.dtype}/{v_scale.dtype}"
        )
    return 1


def _cuda_paged_decode_attention(
    q, k_pages, v_pages, tables, lengths, k_scale, v_scale
):
    """Launch csrc/paged_decode.cu on q's stream. Takes bf16 or fp32 q
    with pools of q's dtype, or int8 pools with f32 scale pools
    [P, page, kvh]; hd in {64, 128}, n_rep in {1, 2, 4, 8}, any page
    size; raises on anything else. Lengths are read on the device only
    (no host sync; the split plan covers the table's capacity): one past
    max_pages*page turns that slot's output into NaN, and the kernel
    never reads past the table."""
    b, h, hd = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    n_rep = h // kvh
    tensors = [q, k_pages, v_pages, tables, lengths]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("impl='cuda' needs every input on one CUDA device")
    kv_int8 = _check_kv_dtypes(q, k_pages, v_pages, k_scale, v_scale)
    if kv_int8 and not (
        tuple(k_scale.shape) == tuple(v_scale.shape)
        == tuple(k_pages.shape[:3])
    ):
        raise ValueError(
            f"scale pools {tuple(k_scale.shape)}/{tuple(v_scale.shape)} do "
            f"not match the pools {tuple(k_pages.shape)}"
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
    _check_kv_layout(q, k_pages, v_pages)
    max_pages = tables.shape[1]
    splits, chunk = split_plan(
        b, kvh, max_pages * page, _sm_count(q.device.index)
    )
    out = torch.empty_like(q)
    partial = _split_workspace(q, splits)
    fn = kernels.function(
        "paged_decode.cu", "tpu_paged_decode_attention", _PAGED_ARGTYPES
    )
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if kv_int8 else None,
        v_scale.data_ptr() if kv_int8 else None,
        tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        _DTYPE_CODES[q.dtype], kv_int8, b, kvh, n_rep, hd, page,
        max_pages, splits, chunk, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(err, "paged_decode_attention")
    key = "paged_decode_attention_int8" if kv_int8 else "paged_decode_attention"
    kernels.LAUNCHES[key] += 1
    return out


def paged_decode_attention(
    q, k_pages, v_pages, tables, lengths, k_scale=None, v_scale=None,
    impl: str = "auto", split_keys=None,
):
    """Single-query GQA attention over a paged KV pool.

    q: [b, h, hd] (one query per slot); k_pages/v_pages: [num_pages,
    page_size, kvh, hd] shared pools (model dtype, or int8 with
    [num_pages, page_size, kvh] f32 ``k_scale``/``v_scale`` pools);
    tables: [b, max_pages_per_seq] int32 —
    entry j of row i is the page holding positions [j*page, (j+1)*page)
    of slot i; lengths: [b] int32 — keys at positions >= lengths[i] are
    dead (a 0 length gives exact zeros). impl: "auto" | "cuda" |
    "torch" | "reference". split_keys: with "torch", the kernel's
    split-and-merge form over splits of that many positions (the CUDA
    kernel plans its own splits, :func:`split_plan`). Returns [b, h, hd]
    in q's dtype.
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
    _check_split_keys(split_keys, impl)
    global _LAST_PAGED_IMPL
    _LAST_PAGED_IMPL = impl
    if impl == "cuda":
        return _cuda_paged_decode_attention(
            q, k_pages, v_pages, tables, lengths, k_scale, v_scale
        )
    if impl == "torch":
        return _torch_paged_decode_attention(
            q, k_pages, v_pages, tables, lengths, k_scale, v_scale,
            split_keys,
        )
    if impl == "reference":
        return reference_paged_decode_attention(
            q, k_pages, v_pages, tables, lengths, k_scale, v_scale
        )
    raise ValueError(f"unknown paged decode attention impl: {impl!r}")


def _check_split_keys(split_keys, impl: str) -> None:
    if split_keys is None:
        return
    if impl != "torch":
        raise ValueError(
            f"split_keys selects the plain split form (impl='torch'), "
            f"got impl={impl!r}"
        )
    if isinstance(split_keys, bool) or not isinstance(split_keys, int) or (
        split_keys < 1
    ):
        raise ValueError(
            f"split_keys must be a positive int, got {split_keys!r}"
        )


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


# --- contiguous-cache decode: the fixed-batch greedy_generate path -----------

_LAST_DECODE_IMPL = None


def _decode_block_k(skv: int, block_k: int) -> int:
    """Largest divisor of skv at most block_k: the plain block loop
    slices blocks at i*block_k, so block_k must divide skv."""
    for bk in range(min(block_k, skv), 0, -1):
        if skv % bk == 0:
            return bk
    return 1


def reference_decode_attention(
    q, k, v, length: int, k_scale=None, v_scale=None, extra_k=None,
    extra_v=None,
):
    """Naive fp32 oracle. q [b, h, hd]; k/v [b, skv, kvh, hd] (model
    dtype, or int8 with [b, skv, kvh] scales). Keys [0, cache_len) are
    live, cache_len = length - 1 when ``extra_k``/``extra_v`` ([b, kvh,
    hd]) carry the newest token's K/V outside the cache, else length."""
    b, h, hd = q.shape
    kvh = k.shape[2]
    n_rep = h // kvh
    scale = hd ** -0.5
    cache_len = length - (0 if extra_k is None else 1)
    qg = q.reshape(b, kvh, n_rep, hd).to(torch.float32)
    logits = torch.einsum("bhrd,bkhd->bhrk", qg, k.to(torch.float32)) * scale
    if k_scale is not None:
        logits = logits * _group_scale(k_scale)
    cols = torch.arange(k.shape[1], device=q.device)
    logits = torch.where(
        cols[None, None, None, :] < cache_len, logits,
        torch.full_like(logits, NEG_INF),
    )
    if extra_k is not None:
        el = torch.einsum(
            "bhrd,bhd->bhr", qg, extra_k.to(torch.float32)
        )[..., None] * scale
        logits = torch.cat([logits, el], dim=-1)
    probs = torch.softmax(logits, dim=-1)
    pc = probs[..., : k.shape[1]]
    if v_scale is not None:
        pc = pc * _group_scale(v_scale)
    out = torch.einsum("bhrk,bkhd->bhrd", pc, v.to(torch.float32))
    if extra_v is not None:
        out = out + probs[..., -1:] * extra_v.to(torch.float32)[:, :, None, :]
    return out.reshape(b, h, hd).to(q.dtype)


def _torch_decode_attention(
    q, k, v, length: int, k_scale, v_scale, extra_k, extra_v, block_k: int,
    split_keys=None,
):
    """Length-aware block loop carrying fp32 (m, l, acc): the twin of
    ``_xla_decode_attention``. Blocks past the last live key are never
    touched; the newest token's K/V, when given out of cache, enter as
    one exact online update.

    With ``split_keys``, the kernel's form instead: keys [0, length) cut
    into splits of that many positions, merged as the combine kernel
    merges them (:func:`_torch_split_decode`; no extra_k/extra_v)."""
    b, h, hd = q.shape
    kvh = k.shape[2]
    n_rep = h // kvh
    scale = hd ** -0.5
    qg = q.reshape(b, kvh, n_rep, hd)
    dev = q.device
    if split_keys is not None:
        if extra_k is not None:
            raise ValueError("split_keys takes no extra_k/extra_v")
        cut = (lambda x: None if x is None else x[:, :length])
        out = _torch_split_decode(
            qg, cut(k), cut(v), cut(k_scale), cut(v_scale),
            torch.full((b,), length, dtype=torch.int32, device=dev),
            split_keys,
        )
        return out.reshape(b, h, hd).to(q.dtype)
    cache_len = length - (0 if extra_k is None else 1)
    num_blocks = -(-cache_len // block_k)
    m = torch.full((b, kvh, n_rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, n_rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, n_rep, hd), dtype=torch.float32, device=dev)
    for i in range(num_blocks):
        sl = slice(i * block_k, (i + 1) * block_k)
        s = torch.einsum(
            "bhrd,bkhd->bhrk", qg.float(), k[:, sl].to(qg.dtype).float()
        ) * scale
        if k_scale is not None:
            s = s * _group_scale(k_scale[:, sl])
        cols = i * block_k + torch.arange(block_k, device=dev)
        s = torch.where(
            cols[None, None, None, :] < cache_len, s, torch.full_like(s, NEG_INF)
        )
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        if v_scale is not None:
            p = p * _group_scale(v_scale[:, sl])
        acc = acc * alpha[..., None] + torch.einsum(
            "bhrk,bkhd->bhrd",
            p.to(qg.dtype).float(), v[:, sl].to(qg.dtype).float(),
        )
        m = m_new
    if extra_k is not None:
        se = torch.einsum(
            "bhrd,bhd->bhr", qg.float(), extra_k.to(qg.dtype).float()
        ) * scale
        m_new = torch.maximum(m, se)
        alpha = torch.exp(m - m_new)
        pe = torch.exp(se - m_new)
        l = l * alpha + pe
        acc = acc * alpha[..., None] + (
            pe[..., None] * extra_v.to(torch.float32)[:, :, None]
        )
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


_DECODE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
    ctypes.c_float, ctypes.c_void_p,
]


def _cuda_decode_attention(q, k, v, length: int, k_scale, v_scale):
    """Launch csrc/decode.cu on q's stream. Takes bf16 or fp32 q with a
    cache of q's dtype, or an int8 cache with f32 scales [b, max_seq,
    kvh]; hd in {64, 128}, n_rep in {1, 2, 4, 8}; 0 <= length <=
    max_seq (a host int, checked here); raises on anything else."""
    b, h, hd = q.shape
    max_seq, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    tensors = [q, k, v]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("impl='cuda' needs every input on one CUDA device")
    kv_int8 = _check_kv_dtypes(q, k, v, k_scale, v_scale)
    if kv_int8 and not (
        tuple(k_scale.shape) == tuple(v_scale.shape) == tuple(k.shape[:3])
    ):
        raise ValueError(
            f"scales {tuple(k_scale.shape)}/{tuple(v_scale.shape)} do not "
            f"match the cache {tuple(k.shape)}"
        )
    if hd not in (64, 128) or n_rep not in (1, 2, 4, 8):
        raise ValueError(
            f"impl='cuda' takes head_dim 64 or 128 and n_rep 1/2/4/8, got "
            f"head_dim {hd}, n_rep {n_rep}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("impl='cuda' needs contiguous inputs")
    _check_kv_layout(q, k, v)
    splits, chunk = split_plan(b, kvh, length, _sm_count(q.device.index))
    out = torch.empty_like(q)
    partial = _split_workspace(q, splits)
    fn = kernels.function("decode.cu", "tpu_decode_attention", _DECODE_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if kv_int8 else None,
        v_scale.data_ptr() if kv_int8 else None,
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        _DTYPE_CODES[q.dtype], kv_int8, b, kvh, n_rep, hd, max_seq, length,
        splits, chunk, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(err, "decode_attention")
    kernels.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention(
    q, k, v, length: int, k_scale=None, v_scale=None, extra_k=None,
    extra_v=None, impl: str = "auto", block_k: int = 256, split_keys=None,
):
    """Single-query GQA attention over a contiguous KV cache.

    q: [b, h, hd] (one query per row — the decode step); k/v: [b,
    max_seq, kvh, hd] cache, model dtype or int8 with per-(token, kv
    head) f32 ``k_scale``/``v_scale`` [b, max_seq, kvh]; length: a host
    int — keys at positions >= length are dead (0 gives exact zeros);
    extra_k/extra_v: [b, kvh, hd] newest-token K/V not yet in the cache
    (position length - 1; torch/reference only, as the JAX kernel
    refuses them too). impl: "auto" | "cuda" | "torch" | "reference";
    block_k: the plain loop's block (largest divisor of max_seq at most
    block_k; the kernel takes no block size); split_keys: with "torch",
    the kernel's split-and-merge form over splits of that many positions
    instead of the block loop (the CUDA kernel plans its own splits,
    :func:`split_plan`). Returns [b, h, hd] in q's dtype.
    """
    b, h, hd = q.shape
    if k.shape[0] != b or v.shape != k.shape or k.shape[3] != hd:
        raise ValueError(
            f"decode cache shape mismatch: q {tuple(q.shape)} vs k "
            f"{tuple(k.shape)} v {tuple(v.shape)}"
        )
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({kvh})"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be provided together")
    if (extra_k is None) != (extra_v is None):
        raise ValueError("extra_k and extra_v must be provided together")
    length = int(length)
    if not 0 <= length <= k.shape[1] + (0 if extra_k is None else 1):
        raise ValueError(
            f"length {length} outside the cache (max_seq {k.shape[1]})"
        )
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    _check_split_keys(split_keys, impl)
    global _LAST_DECODE_IMPL
    _LAST_DECODE_IMPL = impl
    if impl == "cuda":
        if extra_k is not None:
            raise ValueError(
                "the CUDA decode kernel does not take extra_k/extra_v; "
                "write the newest K/V into the cache first (the unrolled "
                "layout does) or use impl='torch'"
            )
        return _cuda_decode_attention(q, k, v, length, k_scale, v_scale)
    if impl == "torch":
        return _torch_decode_attention(
            q, k, v, length, k_scale, v_scale, extra_k, extra_v,
            _decode_block_k(k.shape[1], block_k), split_keys,
        )
    if impl == "reference":
        return reference_decode_attention(
            q, k, v, length, k_scale, v_scale, extra_k, extra_v
        )
    raise ValueError(f"unknown decode attention impl: {impl!r}")


# --- full-sequence flash attention: the training path ------------------------
#
# Counterpart of the flash part of the JAX module (:49-651). Public
# layouts are JAX's: q [b, sq, h, hd], k/v [b, skv, kvh, hd], lse
# [b, h, sq] natural-log. GQA stays logical: the plain versions contract
# grouped q [b, sq, kvh, n_rep, hd] against k/v as they are, and the
# kernels index each kv head's tiles for its n_rep query heads. The
# JAX block sizes (attention_block_q/k) are TPU VMEM tiles: the port
# takes them for parity and ignores them; the kernels size their own
# tiles (64 rows and keys in flash_attention.cu; 128 in
# flash_fwd_sm90.cu; 128 keys against 64-row query tiles in
# flash_bwd_sm90.cu; 128 rows against 64-key tiles in
# flash_bwd_dq_sm90.cu), and the plain forward walks keys in 64-key tiles:
# the online softmax gives the same result for any key tiling, up to
# fp32 summation order.

# exp2 softmax domain, as in the JAX kernels: log2 e folds into the
# score scale, and lse stays natural-log at the boundary.
LOG2_E = 1.4426950408889634
LN_2 = 0.6931471805599453
FLASH_TILE = 64  # the plain forward's key tile


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, kvh, hd] -> [b, s, kvh * n_rep, hd] (logical)."""
    if n_rep == 1:
        return x
    b, s, kvh, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kvh, n_rep, hd).reshape(
        b, s, kvh * n_rep, hd
    )


def _causal_mask(sq: int, skv: int, device) -> torch.Tensor:
    """[sq, skv] bool: query row i (the last sq positions of skv) sees
    key j when j <= i + (skv - sq)."""
    return (
        torch.arange(skv, device=device)[None, :]
        <= torch.arange(sq, device=device)[:, None] + (skv - sq)
    )


def _reference_logits(q, k, causal: bool) -> torch.Tensor:
    """fp32 [b, h, sq, skv] scaled logits, masked entries NEG_INF."""
    kr = _repeat_kv(k, q.shape[2] // k.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * (
        q.shape[-1] ** -0.5
    )
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q.device)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    return logits


def reference_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """The fp32-softmax oracle (JAX ``reference_attention``): q [b, sq,
    h, hd]; k/v [b, skv, kvh, hd] -> [b, sq, h, hd] in q's dtype. Plain
    autograd ops, so it differentiates too."""
    probs = torch.softmax(_reference_logits(q, k, causal), dim=-1)
    vr = _repeat_kv(v, q.shape[2] // k.shape[2])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), vr.float())
    return out.to(q.dtype)


def reference_attention_with_lse(q, k, v, causal: bool):
    """(out, lse [b, h, sq]): the oracle of the joint primitive."""
    logits = _reference_logits(q, k, causal)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    vr = _repeat_kv(v, q.shape[2] // k.shape[2])
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), vr.float())
    return out.to(q.dtype), lse


def _validate_flash_shapes(q, k, v) -> None:
    """The flash path's contract, the same on every device (the kernels'
    own): h % kvh == 0, hd a multiple of 16 up to 128, 1 <= sq <= skv,
    k and v alike, one floating dtype (bf16 or fp32). Raises ValueError.
    Unlike JAX, no divisibility by block sizes: ragged edges are masked
    in the kernels."""
    b, sq, h, hd = q.shape
    bk, skv, kvh, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape) or bk != b or hdk != hd:
        raise ValueError(
            f"flash attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)},"
            f" v {tuple(v.shape)}"
        )
    if h % kvh:
        raise ValueError(
            f"query heads ({h}) must be a multiple of kv heads ({kvh})"
        )
    if hd % 16 or not 16 <= hd <= 128:
        raise ValueError(
            f"flash attention takes a head dim that is a multiple of 16 up "
            f"to 128; got {hd} (use impl='reference')"
        )
    if not 1 <= sq <= skv:
        raise ValueError(f"flash attention needs 1 <= sq <= skv; got {sq}, {skv}")
    if {q.dtype, k.dtype, v.dtype} - _DTYPE_CODES.keys() or len(
        {q.dtype, k.dtype, v.dtype}
    ) != 1:
        raise ValueError(
            f"flash attention takes bf16 or fp32 q/k/v of one dtype, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}"
        )


def _group(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """[b, s, h, hd] -> [b, s, kvh, n_rep, hd] (a view)."""
    b, s, h, hd = x.shape
    return x.reshape(b, s, kvh, h // kvh, hd)


def _scores2(q, k, causal: bool) -> torch.Tensor:
    """fp32 [b, kvh, n_rep, sq, skv] scores in the exp2 domain, s = dot *
    (scale * log2 e), masked entries NEG_INF — the kernels' s."""
    kvh = k.shape[2]
    s = torch.einsum(
        "bqgrd,bkgd->bgrqk", _group(q, kvh).float(), k.float()
    ) * (q.shape[-1] ** -0.5 * LOG2_E)
    if causal:
        s = torch.where(
            _causal_mask(q.shape[1], k.shape[1], q.device), s,
            torch.full_like(s, NEG_INF),
        )
    return s


def _torch_flash_fwd(q, k, v, causal: bool):
    """Plain version of the forward kernels, ``csrc/flash_fwd_sm90.cu``
    and ``csrc/flash_attention.cu`` flash_fwd_kernel (JAX
    ``_flash_kernel``): an online softmax over key tiles of FLASH_TILE in
    the exp2 domain, fp32 (m, l, acc), p rounded to v's dtype for P.V.
    Returns (out [b, sq, h, hd] in q's dtype, lse [b, h, sq] f32)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    qg = _group(q, kvh).float()
    mask = _causal_mask(sq, skv, q.device) if causal else None
    sc = hd ** -0.5 * LOG2_E
    dev = q.device
    m = torch.full((b, kvh, n_rep, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, n_rep, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, n_rep, sq, hd), dtype=torch.float32, device=dev)
    for j0 in range(0, skv, FLASH_TILE):
        sl = slice(j0, j0 + FLASH_TILE)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k[:, sl].float()) * sc
        if mask is not None:
            s = torch.where(mask[:, sl], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp2(s - m_new[..., None])
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p.to(v.dtype).float(), v[:, sl].float()
        )
        m = m_new
    denom = torch.clamp(l, min=1e-30)
    out = (acc / denom[..., None]).to(q.dtype)  # [b, kvh, n_rep, sq, hd]
    lse = (m + torch.log2(denom)) * LN_2
    return (
        out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd),
        lse.reshape(b, h, sq),
    )


def _p_and_ds(q, k, v, do, lse, delta, causal: bool):
    """The backward kernels' shared tile math over whole rows: p =
    exp2(s - lse log2 e) and dS = p (dO.V^T - delta), both fp32
    [b, kvh, n_rep, sq, skv]."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    n_rep = h // kvh
    p = torch.exp2(
        _scores2(q, k, causal)
        - (lse.float() * LOG2_E).reshape(b, kvh, n_rep, sq)[..., None]
    )
    dp = torch.einsum("bqgrd,bkgd->bgrqk", _group(do, kvh).float(), v.float())
    ds = p * (dp - delta.float().reshape(b, kvh, n_rep, sq)[..., None])
    return p, ds


def _torch_flash_bwd_dq(q, k, v, do, lse, delta, causal: bool):
    """Plain version of the dQ kernels, ``csrc/flash_bwd_dq_sm90.cu``
    and ``csrc/flash_attention.cu`` flash_bwd_dq_kernel (JAX
    ``_flash_bwd_dq_kernel``): P rebuilt from lse, dS rounded to q's
    dtype for dS.K, scale applied to the fp32 sum. do is already in q's
    dtype; lse and delta are [b, h, sq] f32. Returns dq [b, sq, h, hd]."""
    b, sq, h, hd = q.shape
    _, ds = _p_and_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum(
        "bgrqk,bkgd->bqgrd", ds.to(q.dtype).float(), k.float()
    ) * (hd ** -0.5)
    return dq.reshape(b, sq, h, hd).to(q.dtype)


def _torch_flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool):
    """Plain version of the dK/dV kernels, ``csrc/flash_bwd_sm90.cu``
    and ``csrc/flash_attention.cu`` flash_bwd_dkv_kernel (JAX
    ``_flash_bwd_dkv_kernel``): dV = sum over all n_rep heads' rows of
    P^T.dO with P rounded to dO's dtype, dK = scale * dS^T.Q with dS
    rounded to q's dtype, fp32 sums. Returns (dk, dv) [b, skv, kvh, hd]."""
    kvh = k.shape[2]
    p, ds = _p_and_ds(q, k, v, do, lse, delta, causal)
    dv = torch.einsum(
        "bgrqk,bqgrd->bkgd", p.to(do.dtype).float(), _group(do, kvh).float()
    )
    dk = torch.einsum(
        "bgrqk,bqgrd->bkgd", ds.to(q.dtype).float(), _group(q, kvh).float()
    ) * (q.shape[-1] ** -0.5)
    return dk.to(k.dtype), dv.to(v.dtype)


_FLASH_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_void_p,
]
_FLASH_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
]
_FLASH_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
]


def _check_flash_cuda(tensors, dtype, rows) -> None:
    """Every tensor on one CUDA device, contiguous and 16-byte aligned;
    the model tensors in ``dtype`` and the row statistics (``rows``)
    f32. Raises ValueError."""
    dev = tensors[0].device
    for t in list(tensors) + list(rows):
        if not (t.is_cuda and t.device == dev):
            raise ValueError("the flash kernels need every input on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the flash kernels need contiguous, 16-byte aligned inputs")
    if any(t.dtype != dtype for t in tensors) or any(
        t.dtype != torch.float32 for t in rows
    ):
        raise ValueError(
            f"the flash kernels take q/k/v/dO of one dtype ({dtype}) and f32 "
            f"lse/delta"
        )


def _flash_dims(q, k, causal: bool) -> tuple:
    b, sq, h, hd = q.shape
    return (_DTYPE_CODES[q.dtype], b, sq, k.shape[1], h, k.shape[2], hd,
            int(bool(causal)))


# The forward's two kernels: (source, C entry), both taking
# _FLASH_FWD_ARGTYPES.
_FLASH_FWD_KERNELS = {
    "sm90": ("flash_fwd_sm90.cu", "tpu_flash_fwd_sm90"),
    "wmma": ("flash_attention.cu", "tpu_flash_fwd"),
}


def _flash_fwd_route(q) -> str:
    """The forward kernel that serves ``q``, chosen from its dtype and
    head dim before the launch: "sm90" (``csrc/flash_fwd_sm90.cu``,
    wgmma with a cp.async K/V ring) for bf16 at hd 64 or 128, else
    "wmma" (``csrc/flash_attention.cu`` flash_fwd_kernel; fp32 keeps its
    bits on CUDA cores there)."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128):
        return "sm90"
    return "wmma"


# The dQ backward's two kernels: (source, C entry), both taking
# _FLASH_DQ_ARGTYPES.
_FLASH_DQ_KERNELS = {
    "sm90": ("flash_bwd_dq_sm90.cu", "tpu_flash_bwd_dq_sm90"),
    "wmma": ("flash_attention.cu", "tpu_flash_bwd_dq"),
}


def _flash_bwd_dq_route(q) -> str:
    """The dQ kernel that serves ``q``, chosen like
    :func:`_flash_fwd_route`: "sm90" (``csrc/flash_bwd_dq_sm90.cu``,
    wgmma with queries as the M dimension and a cp.async K/V ring) for
    bf16 at hd 64 or 128, else "wmma" (``csrc/flash_attention.cu``
    flash_bwd_dq_kernel; fp32 keeps its bits on CUDA cores there)."""
    return _flash_fwd_route(q)


# The dK/dV backward's two kernels: (source, C entry), both taking
# _FLASH_DKV_ARGTYPES.
_FLASH_DKV_KERNELS = {
    "sm90": ("flash_bwd_sm90.cu", "tpu_flash_bwd_dkv_sm90"),
    "wmma": ("flash_attention.cu", "tpu_flash_bwd_dkv"),
}


def _flash_bwd_dkv_route(q) -> str:
    """The dK/dV kernel that serves ``q``, chosen like
    :func:`_flash_fwd_route`: "sm90" (``csrc/flash_bwd_sm90.cu``, wgmma
    with keys as the M dimension and a cp.async Q/dO ring) for bf16 at
    hd 64 or 128, else "wmma" (``csrc/flash_attention.cu``
    flash_bwd_dkv_kernel; fp32 keeps its bits on CUDA cores there)."""
    return _flash_fwd_route(q)


def _cuda_flash_fwd(q, k, v, causal: bool):
    """Launch the forward kernel of :func:`_flash_fwd_route` on q's
    stream: (out, lse [b, h, sq] f32). A failed launch raises; the other
    kernel is never tried."""
    _validate_flash_shapes(q, k, v)
    _check_flash_cuda((q, k, v), q.dtype, ())
    b, sq, h, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    route = _flash_fwd_route(q)
    source, entry = _FLASH_FWD_KERNELS[route]
    fn = kernels.function(source, entry, _FLASH_FWD_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_flash_dims(q, k, causal), hd ** -0.5 * LOG2_E,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(err, entry)
    if route == "sm90":
        kernels.LAUNCHES["flash_fwd_sm90"] += 1
    kernels.LAUNCHES["flash_fwd"] += 1
    return out, lse


def _cuda_flash_bwd_dq(q, k, v, do, lse, delta, causal: bool):
    """Launch the dQ kernel of :func:`_flash_bwd_dq_route` on q's
    stream: dq like q. A failed launch raises; the other kernel is never
    tried."""
    _validate_flash_shapes(q, k, v)
    _check_flash_cuda((q, k, v, do), q.dtype, (lse, delta))
    hd = q.shape[-1]
    dq = torch.empty_like(q)
    route = _flash_bwd_dq_route(q)
    source, entry = _FLASH_DQ_KERNELS[route]
    fn = kernels.function(source, entry, _FLASH_DQ_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_flash_dims(q, k, causal), hd ** -0.5 * LOG2_E, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(err, entry)
    if route == "sm90":
        kernels.LAUNCHES["flash_bwd_dq_sm90"] += 1
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _cuda_flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool):
    """Launch the dK/dV kernel of :func:`_flash_bwd_dkv_route` on q's
    stream: (dk, dv) like k, v. A failed launch raises; the other kernel
    is never tried."""
    _validate_flash_shapes(q, k, v)
    _check_flash_cuda((q, k, v, do), q.dtype, (lse, delta))
    hd = q.shape[-1]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    route = _flash_bwd_dkv_route(q)
    source, entry = _FLASH_DKV_KERNELS[route]
    fn = kernels.function(source, entry, _FLASH_DKV_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_flash_dims(q, k, causal), hd ** -0.5 * LOG2_E, hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(err, entry)
    if route == "sm90":
        kernels.LAUNCHES["flash_bwd_dkv_sm90"] += 1
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _flash_impls(q, impl: str):
    """The three functions of ``impl`` ("cuda" or "torch")."""
    if impl == "cuda":
        if not q.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        return _cuda_flash_fwd, _cuda_flash_bwd_dq, _cuda_flash_bwd_dkv
    if impl == "torch":
        return _torch_flash_fwd, _torch_flash_bwd_dq, _torch_flash_bwd_dkv
    raise ValueError(f"unknown flash impl: {impl!r}")


class _FlashAttentionWithLse(torch.autograd.Function):
    """(out, lse) with a backward for both outputs: the JAX custom_vjp
    ``flash_attention_with_lse`` (:567-602). The forward saves q, k, v,
    out and lse; the backward forms delta = rowsum(dO . O) in fp32
    outside the kernels, folds the lse cotangent in as delta - g_lse, and
    runs the dQ and dK/dV functions of the same impl on dO cast to q's
    dtype. Unlike JAX, suffix queries (sq < skv) take the same backward
    (both kernels carry the causal offset)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, impl):
        fwd, ctx.bwd_dq, ctx.bwd_dkv = _flash_impls(q, impl)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        out, lse = fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        delta = (g_out.float() * out.float()).sum(dim=-1).transpose(1, 2)
        if g_lse is not None:
            delta = delta - g_lse.float()
        delta = delta.contiguous()
        do = g_out.to(q.dtype).contiguous()
        dq = ctx.bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = ctx.bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal: bool = True, block_q: int = 256,
                             block_k: int = 256, impl: str = "auto"):
    """(out [b, sq, h, hd], lse [b, h, sq]) with gradients for both.
    impl: "auto" (the kernels for CUDA tensors, their plain versions for
    CPU tensors) | "cuda" | "torch". block_q/block_k: the JAX TPU tiles,
    taken for parity and ignored."""
    del block_q, block_k
    _validate_flash_shapes(q, k, v)
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _FlashAttentionWithLse.apply(q, k, v, bool(causal), impl)


def _flash_attention(q, k, v, causal: bool = True, block_q: int = 256,
                     block_k: int = 256, impl: str = "auto"):
    """Out-only view of :func:`flash_attention_with_lse` (the unused lse
    gets no cotangent)."""
    return flash_attention_with_lse(q, k, v, causal, block_q, block_k, impl)[0]


def attention(q, k, v, causal: bool = True, impl: str = "auto",
              block_q: int = 256, block_k: int = 256) -> torch.Tensor:
    """q [b, sq, h, hd]; k/v [b, skv, kvh, hd] -> [b, sq, h, hd].

    impl: "auto" | "cuda" | "torch" | "reference". "auto" launches the
    flash kernels for CUDA tensors and takes their plain versions for CPU
    tensors, both through one autograd.Function; a shape outside
    :func:`_validate_flash_shapes` raises on every device (no quiet
    fallback). "reference" is the fp32-softmax oracle."""
    if impl == "reference":
        return reference_attention(q, k, v, causal)
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown attention impl: {impl!r}")
    return _flash_attention(q, k, v, causal, block_q, block_k, impl)
