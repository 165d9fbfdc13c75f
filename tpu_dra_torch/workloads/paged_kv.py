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
check it. Extents, page copies and copy-on-write forks come with later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.generate import KV_QUANT_MODES
from tpu_dra_torch.workloads.models.llama import LlamaConfig

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
) -> PagedKVCache:
    """Zeroed pools for every layer on ``device`` (default: the CUDA
    device, see :func:`.device.resolve_device`)."""
    device = resolve_device(device)
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(
            f"unknown kv_quant {kv_quant!r}; expected one of {KV_QUANT_MODES}"
        )
    quant = kv_quant == "int8"
    kv_dtype = torch.int8 if quant else config.dtype
    shape = (num_pages, page_size, config.n_kv_heads, config.head_dim)
    sshape = (num_pages, page_size, config.n_kv_heads)
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
