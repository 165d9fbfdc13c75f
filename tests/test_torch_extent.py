"""The port's KV extents (paged_kv.KVExtent, serialize_extent,
graft_extent) held to the JAX ones on the CPU.

- the round-trip property of tests/test_paged_kv.py over fp32, bf16 and
  int8 pools (random page counts and lengths, one ending exactly at a
  page boundary): the grafted copy is bit-identical, keeps the
  zero-tail invariant, and both allocators' ledgers balance;
- a shared page carried by id, ``attach`` increfing a destination page,
  the rollback on exhaustion, and the validation messages;
- the kv-head blocks a sharded engine's export gathers and its import
  cuts (``serialize_extent``'s ``gather``, ``head_block``);
- across the frameworks: the same numpy-seeded pools serialized by JAX
  and by the port give the same slots and payload bytes, and an extent
  lifted by one grafts into the other's cache bit for bit
  (``convert.extent_from_numpy``, ``torch_twin.extent_to_numpy``).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_twin import extent_to_numpy  # noqa: E402

from tpu_dra.workloads import paged_kv as JP  # noqa: E402
from tpu_dra.workloads.models.llama import TINY_LLAMA as JAX_TINY  # noqa: E402
from tpu_dra_torch.workloads import paged_kv as TP  # noqa: E402
from tpu_dra_torch.workloads.convert import (  # noqa: E402
    _bits_leaf,
    extent_from_numpy,
)
from tpu_dra_torch.workloads.models.llama import TINY_LLAMA  # noqa: E402

CFG = dataclasses.replace(
    TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32)
MODES = [("none", torch.float32), ("none", torch.bfloat16),
         ("int8", torch.float32)]
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _cache(kv="none", dtype=torch.float32, num_pages=8, page=4):
    cfg = dataclasses.replace(CFG, dtype=dtype)
    return TP.init_paged_cache(cfg, num_pages, page, kv_quant=kv,
                               device="cpu")


def _fill_pages(cache, pages, length, seed=0):
    """Write ``length`` positions of random K/V (and scales) into the
    page list, per layer, in tests/test_paged_kv.py's draw order."""
    rng = np.random.default_rng(seed)
    page = cache.page_size
    for pos in range(length):
        pid, off = pages[pos // page], pos % page
        for _, pool in cache._pools():
            for layer in pool:
                val = rng.normal(size=layer.shape[2:]).astype(np.float32)
                layer[pid, off] = torch.from_numpy(val + 1.0).to(layer.dtype)
    return cache


def _pages_equal(src, src_pages, dst, dst_pages) -> bool:
    sids = torch.as_tensor(list(src_pages))
    dids = torch.as_tensor(list(dst_pages))
    return all(
        torch.equal(sl[sids], dl[dids])
        for (_, sp), (_, dp) in zip(src._pools(), dst._pools())
        for sl, dl in zip(sp, dp)
    )


def _bits(a) -> np.ndarray:
    """The raw bytes of a tensor or numpy array, as uint8."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    return np.ascontiguousarray(a).view(np.uint8).ravel()


# --- the round trip, as tests/test_paged_kv.py -------------------------------


@pytest.mark.parametrize("kv,dtype", MODES)
def test_kv_extent_roundtrip_property(kv, dtype):
    rng = np.random.default_rng(17)
    page = 4
    for trial in range(6):
        n_pages = int(rng.integers(2, 5))
        length = int(
            rng.integers((n_pages - 1) * page + 1, n_pages * page + 1))
        if trial == 0:
            length = n_pages * page  # ends exactly at a page boundary
        src = _cache(kv, dtype)
        sa = TP.PageAllocator(8)
        pages = [sa.alloc() for _ in range(n_pages)]
        src = _fill_pages(src, pages, length, seed=trial)
        ext = TP.serialize_extent(src, pages, length)
        assert ext.n_payload_pages == n_pages and ext.n_shared_pages == 0
        assert ext.length == length and ext.nbytes > 0
        assert all(t.device.type == "cpu" and t.dtype == pool[0].dtype
                   for name, pool in src._pools()
                   for t in ext.payload[name])

        dst = _cache(kv, dtype)
        da = TP.PageAllocator(8)
        free_before = da.free_pages
        out, dpages = TP.graft_extent(dst, da, ext)
        assert out is dst  # in place
        assert len(dpages) == n_pages
        assert da.free_pages == free_before - n_pages
        assert all(da.refcount(p) == 1 for p in dpages)
        assert _pages_equal(src, pages, dst, dpages)
        assert TP.tail_is_zero(dst, dpages, length)

        for p in pages:
            assert sa.decref(p)  # freed on the first release...
        assert sa.free_pages == 8 - 1  # ...and the ledger is whole
        with pytest.raises(ValueError):
            sa.decref(pages[0])


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_kv_extent_shared_prefix_carried_by_id(kv):
    cache = _cache(kv, num_pages=6)
    a = TP.PageAllocator(6)
    prefix, tail = a.alloc(), a.alloc()
    a.incref(prefix)  # a registered shared prefix: refcount 2
    cache = _fill_pages(cache, [prefix, tail], length=6)
    ext = TP.serialize_extent(cache, [prefix, tail], 6, by_id=[prefix])
    assert ext.n_shared_pages == 1 and ext.n_payload_pages == 1
    assert ext.slots == (("page", prefix), ("payload", 0))
    rc, free_before = a.refcount(prefix), a.free_pages
    cache2, pages = TP.graft_extent(cache, a, ext)
    assert pages[0] == prefix  # carried by reference, never copied
    assert a.refcount(prefix) == rc + 1
    assert a.free_pages == free_before - 1  # only the tail page allocs
    assert _pages_equal(cache, [tail], cache2, [pages[1]])
    assert TP.tail_is_zero(cache2, pages, 6)


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_kv_extent_attach_increfs_destination_page(kv):
    src = _cache(kv, num_pages=6)
    sa = TP.PageAllocator(6)
    spages = [sa.alloc(), sa.alloc()]
    src = _fill_pages(src, spages, length=8, seed=3)
    ext = TP.serialize_extent(src, spages, 8)

    dst = _cache(kv, num_pages=6)
    da = TP.PageAllocator(6)
    held = da.alloc()
    # The same draw order as the source's first page: equal content.
    dst = _fill_pages(dst, [held], length=4, seed=3)
    free_before = da.free_pages
    dst2, pages = TP.graft_extent(dst, da, ext, attach={0: held})
    assert pages[0] == held and da.refcount(held) == 2
    assert da.free_pages == free_before - 1  # only slot 1 allocated
    assert _pages_equal(src, spages, dst2, pages)
    assert TP.tail_is_zero(dst2, pages, 8)


@pytest.mark.parametrize("kv", ["none", "int8"])
def test_kv_extent_graft_failure_releases_everything(kv):
    cache = _cache(kv, num_pages=6)
    a = TP.PageAllocator(6)
    spages = [a.alloc() for _ in range(3)]
    a.alloc()  # pin one page: exactly one free page remains
    cache = _fill_pages(cache, spages, length=12, seed=5)
    ext = TP.serialize_extent(cache, spages, 12, by_id=[spages[0]])
    assert ext.n_payload_pages == 2
    rc, free_before = a.refcount(spages[0]), a.free_pages
    assert free_before == 1
    with pytest.raises(TP.PageExhaustedError):
        TP.graft_extent(cache, a, ext)
    assert a.refcount(spages[0]) == rc
    assert a.free_pages == free_before


@pytest.mark.parametrize("kv,dtype", MODES)
def test_head_blocks_of_an_extent_reassemble_and_graft(kv, dtype):
    """What a sharded engine does across its model axis, in one process:
    ``serialize_extent``'s ``gather`` sees each pool's stacked payload
    [L, n, page, kvh, ...] before the host copy (a gather over the heads
    is there), and ``head_block`` cuts a whole extent into kv-head
    blocks that concatenate back to it bit for bit and graft into a
    cache holding those heads alone; a payload of another head count is
    refused."""
    src = _cache(kv, dtype)
    pages = [1, 3]
    src = _fill_pages(src, pages, 7, seed=5)
    seen = []

    def gather(x):
        seen.append(tuple(x.shape))
        return x

    whole = TP.serialize_extent(src, pages, 7, gather=gather)
    kvh = CFG.n_kv_heads
    assert [s[3] for s in seen] == [kvh] * len(src._pools())
    blocks = [TP.head_block(whole, j, 1, kvh) for j in range(kvh)]
    for name, layers in whole.payload.items():
        for i, layer in enumerate(layers):
            cat = torch.cat([b.payload[name][i] for b in blocks], dim=2)
            assert np.array_equal(_bits(cat), _bits(layer)), name
    half = dataclasses.replace(CFG, n_kv_heads=1, dtype=dtype)
    dst = TP.init_paged_cache(half, 8, 4, kv_quant=kv, device="cpu")
    _, dpages = TP.graft_extent(dst, TP.PageAllocator(8), blocks[1])
    for name, pool in dst._pools():
        for i, layer in enumerate(pool):
            got = layer[torch.as_tensor(dpages)]
            assert np.array_equal(_bits(got),
                                  _bits(blocks[1].payload[name][i])), name
    with pytest.raises(ValueError, match="want 4 kv heads on dim 2"):
        TP.head_block(whole, 0, 1, 4)


def test_kv_extent_validates_shape_and_mode():
    cache = _cache(num_pages=4)
    with pytest.raises(ValueError, match="exceeds"):
        TP.serialize_extent(cache, [1], 5)
    a = TP.PageAllocator(4)
    p = a.alloc()
    ext = TP.serialize_extent(_fill_pages(cache, [p], 3), [p], 3)
    with pytest.raises(ValueError, match="quantization"):
        TP.graft_extent(_cache("int8", num_pages=4), TP.PageAllocator(4),
                        ext)
    with pytest.raises(ValueError, match="page_size"):
        TP.graft_extent(_cache(num_pages=4, page=8), TP.PageAllocator(4),
                        ext)
    # A payload in another dtype would be cast silently by the scatter.
    da = TP.PageAllocator(4)
    with pytest.raises(ValueError, match="payload"):
        TP.graft_extent(_cache(dtype=torch.bfloat16, num_pages=4), da, ext)
    assert da.free_pages == 3  # refused before any allocation


# --- across the frameworks ---------------------------------------------------


def _twin_caches(kv, dtype, seed, num_pages=8, page=4):
    """A JAX cache and a port cache holding the same numpy-seeded
    pools, every page (scratch included) random."""
    jcfg = dataclasses.replace(JAX_TINY, dtype=JAX_DTYPE[dtype],
                               param_dtype=jnp.float32)
    jc = JP.init_paged_cache(jcfg, num_pages=num_pages, page_size=page,
                             kv_quant=kv)
    tc = _cache(kv, dtype, num_pages, page)
    rng = np.random.default_rng(seed)
    out = {}
    for (name, jpool), (_, tpool) in zip(jc._pools(), tc._pools()):
        layers = []
        for jl, tl in zip(jpool, tpool):
            if jl.dtype == jnp.int8:
                a = rng.integers(-127, 128, jl.shape).astype(np.int8)
            else:
                a = rng.normal(size=jl.shape).astype(np.float32)
                a = a.astype(jl.dtype)
            layers.append(jnp.asarray(a))
            tl.copy_(_bits_leaf(a, "cpu"))
        out[name] = tuple(layers)
    return JP.PagedKVCache(**out), tc


@pytest.mark.parametrize("kv,dtype", MODES)
def test_serialize_payload_bytes_equal_jax(kv, dtype):
    jc, tc = _twin_caches(kv, dtype, seed=21)
    pages, length, by_id = [5, 2, 7, 3], 14, [2]
    je = JP.serialize_extent(jc, pages, length, by_id=by_id)
    te = TP.serialize_extent(tc, pages, length, by_id=by_id)
    assert (te.page_size, te.length, te.quantized, te.slots) == (
        je.page_size, je.length, je.quantized, je.slots)
    assert (te.n_pages, te.n_payload_pages, te.n_shared_pages) == (
        je.n_pages, je.n_payload_pages, je.n_shared_pages)
    assert te.nbytes == je.nbytes
    assert sorted(te.payload) == sorted(je.payload)
    for name in je.payload:
        assert len(te.payload[name]) == len(je.payload[name])
        for tl, jl in zip(te.payload[name], je.payload[name]):
            assert np.array_equal(_bits(tl), _bits(jl)), name


@pytest.mark.parametrize("kv,dtype", MODES)
def test_jax_extent_grafts_into_port_bit_identical(kv, dtype):
    """A JAX extent carried by extent_from_numpy grafts into a port
    cache exactly as JAX grafts it into its own: the same pages, and
    every pool of the port cache equal to JAX's bit for bit."""
    src_j, _ = _twin_caches(kv, dtype, seed=4)
    ext_j = JP.serialize_extent(src_j, [3, 6, 1], 11, by_id=[6])
    ext_t = extent_from_numpy(ext_j, device="cpu")
    assert ext_t.slots == ext_j.slots and ext_t.nbytes == ext_j.nbytes
    dst_j, dst_t = _twin_caches(kv, dtype, seed=9, num_pages=12)
    ja, ta = JP.PageAllocator(12), TP.PageAllocator(12)
    for a in (ja, ta):
        for _ in range(6):
            a.alloc()  # page 6 lives, so the by-id slot can incref it
    dst_j, jpages = JP.graft_extent(dst_j, ja, ext_j, id_map={6: 6})
    dst_t, tpages = TP.graft_extent(dst_t, ta, ext_t, id_map={6: 6})
    assert tpages == jpages
    assert (list(ta._free), list(ta._ref)) == (list(ja._free), list(ja._ref))
    for (_, jp), (_, tp) in zip(dst_j._pools(), dst_t._pools()):
        for jl, tl in zip(jp, tp):
            assert np.array_equal(_bits(tl), _bits(np.asarray(jl)))


@pytest.mark.parametrize("kv,dtype", MODES)
def test_port_extent_grafts_into_jax_bit_identical(kv, dtype):
    _, src_t = _twin_caches(kv, dtype, seed=13)
    ext_t = TP.serialize_extent(src_t, [2, 4], 7)
    ext_j = extent_to_numpy(ext_t)
    dst_j, dst_t = _twin_caches(kv, dtype, seed=14)
    dst_j, jpages = JP.graft_extent(dst_j, JP.PageAllocator(8), ext_j)
    dst_t, tpages = TP.graft_extent(dst_t, TP.PageAllocator(8), ext_t)
    assert tpages == jpages
    for (_, jp), (_, tp) in zip(dst_j._pools(), dst_t._pools()):
        for jl, tl in zip(jp, tp):
            assert np.array_equal(_bits(tl), _bits(np.asarray(jl)))
