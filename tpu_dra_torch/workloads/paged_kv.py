"""Paged KV cache: the serving engine's memory layer.

Counterpart of ``tpu_dra/workloads/paged_kv.py`` (see its docstring for
the vLLM-style layout): per layer one shared ``[num_pages, page_size,
kvh, hd]`` K pool and one V pool, block tables owned by the engine, and
a ref-counted LIFO free list (:class:`PageAllocator`, a line-for-line
twin of the JAX one — it holds no arrays). Page 0 is the reserved
scratch page: never handed out, it absorbs inactive slots' writes.

One deliberate difference: pool writes happen **in place**
(``pool[pids, offs] = k``, ``pool[ids] = 0``). JAX arrays are immutable,
so the reference rebuilds the pool tuple on every write; torch tensors
are not, and rewriting a multi-gigabyte pool per token would double its
memory. :class:`PagedKVCache` therefore holds mutable lists of pools and
:func:`zero_pages` returns the same object it was given.

INVARIANT (per page), as in the reference: an allocated page's slots at
positions beyond the owning sequence's length are zero, and free pages
are entirely zero (:func:`zero_pages` re-establishes it on free; the
scratch page is exempt). :func:`tail_is_zero` / :func:`pages_are_zero`
check it. :func:`zero_page_tail` (with :func:`copy_page_prefix`, the
masked copy it is made of) re-establishes it on the kept boundary page
after a speculative rewind. :func:`copy_page` is the copy-on-write
fork of a shared page.

KV extents (:class:`KVExtent`, :func:`serialize_extent`,
:func:`graft_extent`) lift a sequence's pages off one cache and graft
them into another — the unit of live prefill→decode migration. The
payload is CPU torch tensors where the reference's is numpy (numpy has
no bfloat16; ``convert.extent_from_numpy`` carries a JAX extent across
bit for bit).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.generate import KV_QUANT_MODES
from tpu_dra_torch.workloads.models.llama import LlamaConfig
from tpu_dra_torch.workloads.parallel.mesh import local_kv_heads

# Page id 0 is the poison scratch page (see module doc).
SCRATCH_PAGE = 0


class PageExhaustedError(RuntimeError):
    """alloc() found the free list empty. The engine's reservation-gated
    admission makes this unreachable in normal operation."""


class PageAllocator:
    """Host-side ref-counted free list over ``num_pages`` pages.

    ``reserve``/``unreserve`` implement admission control: the engine
    reserves a sequence's worst-case page count up front, so an admitted
    sequence can always grow to its limit.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"need >= 2 pages (page {SCRATCH_PAGE} is reserved "
                f"scratch), got {num_pages}"
            )
        self.num_pages = num_pages
        # LIFO free list: recently-freed (and freshly-zeroed) pages are
        # reused first, keeping the touched working set small.
        self._free = list(range(num_pages - 1, SCRATCH_PAGE, -1))
        self._ref = [0] * num_pages
        self._multi: set = set()  # pages with refcount > 1
        self._reserved = 0
        self._min_free = len(self._free)
        # Lifetime count of alloc() calls that found the list empty.
        self.exhausted = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def reserved_pages(self) -> int:
        return self._reserved

    def can_reserve(self, n: int) -> bool:
        return self.free_pages - self._reserved >= n

    def reserve(self, n: int) -> bool:
        """Set aside ``n`` pages of admission headroom (no physical pages
        move). False when the unreserved free pool is too small."""
        if not self.can_reserve(n):
            return False
        self._reserved += n
        return True

    def unreserve(self, n: int) -> None:
        if n > self._reserved:
            raise ValueError(
                f"unreserve({n}) exceeds outstanding reservation "
                f"{self._reserved}"
            )
        self._reserved -= n

    def alloc(self) -> int:
        """Pop a free page (refcount 1)."""
        if not self._free:
            self.exhausted += 1
            raise PageExhaustedError(
                f"page pool exhausted ({self.num_pages} pages, "
                f"{self._reserved} reserved)"
            )
        page = self._free.pop()
        self._ref[page] = 1
        if len(self._free) < self._min_free:
            self._min_free = len(self._free)
        return page

    def incref(self, page: int) -> None:
        if self._ref[page] < 1:
            raise ValueError(f"incref of unallocated page {page}")
        self._ref[page] += 1
        self._multi.add(page)

    def decref(self, page: int) -> bool:
        """Drop one reference; True when the page was freed."""
        if page == SCRATCH_PAGE:
            raise ValueError("scratch page is never allocated or freed")
        if self._ref[page] < 1:
            raise ValueError(f"decref of unallocated page {page}")
        self._ref[page] -= 1
        if self._ref[page] <= 1:
            self._multi.discard(page)
        if self._ref[page] == 0:
            self._free.append(page)
            return True
        return False

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def shared_extra(self, discount=None) -> int:
        """Total extra references across all pages (see the reference):
        ``r - 1`` per page of effective refcount ``r``."""
        total = 0
        for page in self._multi:
            eff = self._ref[page] - (
                discount.get(page, 0) if discount else 0
            )
            if eff > 1:
                total += eff - 1
        return total

    @property
    def min_free(self) -> int:
        """Low-water mark of the free list."""
        return self._min_free


@dataclasses.dataclass
class PagedKVCache:
    """Device half of the paged cache: per-layer page pools, mutated in
    place. ``k``/``v``: L-lists of ``[num_pages, page_size, kvh, hd]``
    (model dtype, or int8 with L-lists of ``[num_pages, page_size,
    kvh]`` f32 ``k_scale``/``v_scale``)."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_pages(self) -> int:
        return self.k[0].shape[0]

    @property
    def page_size(self) -> int:
        return self.k[0].shape[1]

    @property
    def n_layers(self) -> int:
        return len(self.k)

    def _pools(self):
        pools = [("k", self.k), ("v", self.v)]
        if self.quantized:
            pools += [("k_scale", self.k_scale), ("v_scale", self.v_scale)]
        return pools


def init_paged_cache(
    config: LlamaConfig,
    num_pages: int,
    page_size: int,
    kv_quant: str = "none",
    device=None,
    mesh=None,
) -> PagedKVCache:
    """Zeroed pools for every layer on ``device`` (default: the CUDA
    device, see :func:`.device.resolve_device`). On a decode ``mesh``
    (parallel/mesh.py) the pools, values and int8 scales, hold this
    rank's kv heads (``decode_pool_sharding``); page ids are the same on
    every rank, so every page operation below stays rank-local."""
    device = resolve_device(device)
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(
            f"unknown kv_quant {kv_quant!r}; expected one of {KV_QUANT_MODES}"
        )
    quant = kv_quant == "int8"
    kv_dtype = torch.int8 if quant else config.dtype
    kvh = local_kv_heads(mesh, config.n_kv_heads)
    shape = (num_pages, page_size, kvh, config.head_dim)
    sshape = (num_pages, page_size, kvh)
    L = config.n_layers

    def zeros(shp, dtype):
        return [torch.zeros(shp, dtype=dtype, device=device) for _ in range(L)]

    return PagedKVCache(
        k=zeros(shape, kv_dtype),
        v=zeros(shape, kv_dtype),
        k_scale=zeros(sshape, torch.float32) if quant else None,
        v_scale=zeros(sshape, torch.float32) if quant else None,
    )


def zero_pages(cache: PagedKVCache, page_ids) -> PagedKVCache:
    """Zero the listed pages in every pool (values AND scales), in place
    — the free-side half of the per-page zero-tail invariant. Returns
    ``cache`` itself."""
    ids = list(page_ids)
    if not ids:
        return cache
    idx = torch.as_tensor(ids, dtype=torch.long, device=cache.k[0].device)
    for _, pool in cache._pools():
        for layer in pool:
            layer[idx] = 0
    return cache


def copy_page(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy page ``src`` onto ``dst`` in every pool (values AND scales,
    every layer), in place — the copy-on-write fork: a sequence about to
    write into a page another table still references writes into its
    private copy, and an int8 copy dequantizes as its parent does.
    Returns ``cache`` itself."""
    for _, pool in cache._pools():
        for layer in pool:
            layer[dst] = layer[src]
    return cache


def copy_page_prefix(cache: PagedKVCache, src: int, dst: int,
                     upto: int) -> PagedKVCache:
    """Copy positions ``[0, upto)`` of page ``src`` into ``dst`` and zero
    the rest of ``dst``, in every pool (values AND scales, every layer),
    in place — the frozen-prefix fork: ``dst``'s tail honours the
    zero-tail invariant whatever ``src`` holds past ``upto``. Returns
    ``cache`` itself."""
    page = cache.page_size
    if not 0 <= upto <= page:
        raise ValueError(f"upto={upto} outside a page of {page}")
    for _, pool in cache._pools():
        for layer in pool:
            if src != dst:
                layer[dst, :upto] = layer[src, :upto]
            layer[dst, upto:] = 0
    return cache


def zero_page_tail(cache: PagedKVCache, page_id: int,
                   start: int) -> PagedKVCache:
    """Zero positions ``[start, page_size)`` of one page in every pool,
    in place — the speculative-rewind half of the zero-tail invariant:
    rejected draft K/V written past the accepted length is wiped from
    the kept boundary page (pages wholly past it are freed and
    batch-zeroed by :func:`zero_pages`). The frozen-prefix fork with
    src == dst, as in the reference."""
    return copy_page_prefix(cache, page_id, page_id, start)


def tail_is_zero(cache: PagedKVCache, pages, length: int) -> bool:
    """Does the per-page zero-tail invariant hold for a sequence owning
    ``pages`` with ``length`` positions written? Host/test helper."""
    page = cache.page_size
    for j, pid in enumerate(pages):
        lo = max(0, min(page, length - j * page))
        if lo >= page:
            continue
        for _, pool in cache._pools():
            for layer in pool:
                if bool(layer[pid, lo:].to(torch.float32).abs().sum() != 0):
                    return False
    return True


def pages_are_zero(cache: PagedKVCache, page_ids) -> bool:
    """True when every listed page is entirely zero in every pool."""
    for pid in page_ids:
        for _, pool in cache._pools():
            for layer in pool:
                if bool(layer[pid].to(torch.float32).abs().sum() != 0):
                    return False
    return True


# --- KV extents: ship a sequence's pages between caches ------------------


@dataclasses.dataclass
class KVExtent:
    """A sequence's KV state lifted off its cache — the transferable
    unit behind live prefill→decode migration.

    ``slots[i]`` describes position range ``[i*page_size,
    (i+1)*page_size)`` of the sequence: either ``("page", source_id)``
    for a page carried BY ID (a shared-prefix page both caches can
    already reach — grafting increfs it instead of copying), or
    ``("payload", j)`` for a page whose content rides in ``payload``
    at row ``j``. ``payload`` maps pool name ("k"/"v" and, in int8
    mode, "k_scale"/"v_scale") to an L-tuple of CPU tensors of shape
    ``[n_payload, page_size, ...]`` in the pool's dtype — full pages
    including their zero tails, so the zero-tail invariant transfers
    with the content. The reference's payload is numpy, which has no
    bfloat16; :func:`~.convert.extent_from_numpy` converts one."""

    page_size: int
    length: int
    quantized: bool
    slots: tuple  # of ("page", id) | ("payload", row)
    payload: dict  # pool name -> L-tuple of [n_payload, page, ...] tensors

    @property
    def n_pages(self) -> int:
        return len(self.slots)

    @property
    def n_payload_pages(self) -> int:
        return sum(1 for kind, _ in self.slots if kind == "payload")

    @property
    def n_shared_pages(self) -> int:
        return self.n_pages - self.n_payload_pages

    @property
    def nbytes(self) -> int:
        return sum(
            layer.numel() * layer.element_size()
            for pool in self.payload.values() for layer in pool
        )


def serialize_extent(
    cache: PagedKVCache, pages, length: int, by_id=(), gather=None
) -> KVExtent:
    """Gather a sequence's block-table extent off ``cache`` into host
    memory. ``pages`` is the ordered page-id list covering ``length``
    written positions; ids in ``by_id`` are carried by reference, the
    rest as full-page payload — one gather per pool per layer and one
    copy to the host per pool. ``gather``, when given, maps each pool's
    stacked payload ``[L, n_payload, page, kvh, ...]`` on the device
    before the host copy: a sharded engine gathers its kv-head blocks
    into the whole heads there. The caller must have flushed any
    deferred page zeroing first: a payload page is copied verbatim,
    zero tail and all."""
    pages = [int(p) for p in pages]
    by_id = set(int(p) for p in by_id)
    if length > len(pages) * cache.page_size:
        raise ValueError(
            f"length {length} exceeds {len(pages)} pages of "
            f"{cache.page_size}"
        )
    slots = []
    rows = []
    for pid in pages:
        if pid in by_id:
            slots.append(("page", pid))
        else:
            slots.append(("payload", len(rows)))
            rows.append(pid)
    payload: Dict[str, tuple] = {}
    ids = torch.as_tensor(rows, dtype=torch.long, device=cache.k[0].device)
    for name, pool in cache._pools():
        if rows:
            host = torch.stack([layer.index_select(0, ids) for layer in pool])
            if gather is not None:
                host = gather(host)
            payload[name] = tuple(host.cpu().unbind(0))
        else:
            payload[name] = ()
    return KVExtent(
        page_size=cache.page_size,
        length=length,
        quantized=cache.quantized,
        slots=tuple(slots),
        payload=payload,
    )


def head_block(extent: KVExtent, lo: int, n: int,
               kv_heads: int) -> KVExtent:
    """The extent of kv heads ``[lo, lo + n)`` of a whole-heads extent
    (every pool's payload cut along its head dim, 2): what a rank whose
    pools hold those heads grafts. A payload that does not hold
    ``kv_heads`` heads raises ValueError."""
    payload = {}
    for name, layers in extent.payload.items():
        for layer in layers:
            if layer.ndim < 3 or layer.shape[2] != kv_heads:
                raise ValueError(
                    f"extent payload {name!r} is {tuple(layer.shape)}: "
                    f"want {kv_heads} kv heads on dim 2")
        payload[name] = tuple(layer.narrow(2, lo, n) for layer in layers)
    return dataclasses.replace(extent, payload=payload)


def _check_payload(cache: PagedKVCache, extent: KVExtent) -> None:
    """Every pool's payload must be L layers of ``[n_payload, ...]`` in
    the pool's page shape and dtype: a silent cast or a short payload
    would graft other content than was lifted."""
    n = extent.n_payload_pages
    if not n:
        return
    for name, pool in cache._pools():
        layers = extent.payload.get(name, ())
        if len(layers) != len(pool):
            raise ValueError(
                f"extent payload {name!r} has {len(layers)} layers, the "
                f"cache {len(pool)}"
            )
        want = (n,) + tuple(pool[0].shape[1:])
        for layer in layers:
            if tuple(layer.shape) != want or layer.dtype != pool[0].dtype:
                raise ValueError(
                    f"extent payload {name!r} is {tuple(layer.shape)} "
                    f"{layer.dtype}, the cache's pages {want} "
                    f"{pool[0].dtype}"
                )


def graft_extent(
    cache: PagedKVCache,
    allocator: PageAllocator,
    extent: KVExtent,
    *,
    alloc=None,
    id_map=None,
    attach=None,
):
    """Materialize ``extent`` into ``cache``/``allocator``: by-id slots
    are INCREF'd (through ``id_map`` when the destination knows the
    shared pages under different ids), payload slots get fresh pages via
    ``alloc`` (defaults to ``allocator.alloc`` — the engine passes a
    callable that also burns its admission reservation) and one scatter
    per pool per layer writes their content, in place. ``attach`` maps
    slot INDEX -> destination page id the importer already holds
    equivalent content for (a registered shared prefix): those slots
    incref the destination page instead of copying, payload or not.
    Returns ``(cache, pages)`` — the same cache object — with ``pages``
    the sequence's ordered block table. On any failure nothing is left
    allocated or increfed."""
    if extent.page_size != cache.page_size:
        raise ValueError(
            f"extent page_size {extent.page_size} != cache "
            f"{cache.page_size}"
        )
    if extent.quantized != cache.quantized:
        raise ValueError("extent/cache kv-quantization modes differ")
    _check_payload(cache, extent)
    alloc = alloc or allocator.alloc
    id_map = id_map or {}
    attach = attach or {}
    pages = []
    increfed = []
    fresh = []
    rows = []  # (payload row, fresh page) scatter pairs
    try:
        for i, (kind, val) in enumerate(extent.slots):
            if i in attach:
                pid = int(attach[i])
                allocator.incref(pid)
                increfed.append(pid)
            elif kind == "page":
                pid = int(id_map.get(val, val))
                allocator.incref(pid)
                increfed.append(pid)
            else:
                pid = alloc()
                fresh.append(pid)
                rows.append(val)
            pages.append(pid)
    except BaseException:
        for pid in increfed:
            allocator.decref(pid)
        for pid in fresh:
            allocator.decref(pid)
        raise
    if fresh:
        device = cache.k[0].device
        dst = torch.as_tensor(fresh, dtype=torch.long, device=device)
        sel = torch.as_tensor(rows, dtype=torch.long)
        for name, pool in cache._pools():
            for layer, prows in zip(pool, extent.payload[name]):
                layer[dst] = prows.index_select(0, sel.to(prows.device)).to(
                    device)
    return cache, pages
