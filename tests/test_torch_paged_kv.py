"""The port's paged KV layer held to the JAX one on the CPU.

- the allocator twin: the same op sequence on both allocators leaves
  the same free list, refcounts, reservations and counters;
- paged_decode_attention: the torch page walk and the fp32 reference
  against JAX's xla walk, its reference and the Pallas kernel in
  interpret mode, at fp32, hd=64, page 4 — ragged lengths, a length-0
  slot (exact zeros), lengths of k*page and k*page+1 — atol 1e-5;
- paged_multiquery_attention against JAX's xla walk, atol 1e-5;
- the pool helpers (zero_pages, tail_is_zero, pages_are_zero).

Inputs are made with numpy from a seed and handed to both sides.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads import paged_kv as JP  # noqa: E402
from tpu_dra.workloads.ops import attention as JA  # noqa: E402
from tpu_dra_torch.workloads import paged_kv as TP  # noqa: E402
from tpu_dra_torch.workloads.ops import attention as TA  # noqa: E402

ATOL = 1e-5


# --- allocator twin -----------------------------------------------------------


def _alloc_state(a):
    return (
        list(a._free), list(a._ref), a.reserved_pages, a.exhausted,
        a.min_free, sorted(a._multi), a.shared_extra(),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_twin_same_op_sequence(seed):
    rng = np.random.default_rng(seed)
    ja, ta = JP.PageAllocator(12), TP.PageAllocator(12)
    held = []
    for _ in range(300):
        op = rng.integers(0, 5)
        n = int(rng.integers(1, 4))
        outcomes = []
        for a in (ja, ta):
            try:
                if op == 0:
                    outcomes.append(("alloc", a.alloc()))
                elif op == 1 and held:
                    outcomes.append(("decref", a.decref(held[-1])))
                elif op == 2 and held:
                    a.incref(held[0])
                    outcomes.append(("incref", None))
                elif op == 3:
                    outcomes.append(("reserve", a.reserve(n)))
                else:
                    a.unreserve(1)
                    outcomes.append(("unreserve", None))
            except (RuntimeError, ValueError) as e:
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[0] == outcomes[1]
        kind, val = outcomes[0]
        if kind == "alloc":
            held.append(val)
        elif kind == "decref" and ja.refcount(held[-1]) == 0:
            held.pop()
        assert _alloc_state(ja) == _alloc_state(ta)
    assert ta.exhausted == ja.exhausted


def test_allocator_refuses_scratch_and_tiny_pools():
    with pytest.raises(ValueError, match="reserved"):
        TP.PageAllocator(1)
    a = TP.PageAllocator(4)
    with pytest.raises(ValueError, match="scratch"):
        a.decref(TP.SCRATCH_PAGE)
    with pytest.raises(ValueError, match="unallocated"):
        a.incref(2)


# --- paged decode attention ------------------------------------------------


def _paged_inputs(seed, b, num_pages, page, kvh, hd, lengths, n_rep=2,
                  quant=False):
    """numpy inputs: pools, disjoint shuffled tables, given lengths."""
    rng = np.random.default_rng(seed)
    max_pages = (num_pages - 1) // b
    perm = rng.permutation(np.arange(1, num_pages))
    tables = np.zeros((b, max_pages), np.int32)
    for i in range(b):
        tables[i] = perm[i * max_pages:(i + 1) * max_pages]
    q = rng.standard_normal((b, n_rep * kvh, hd)).astype(np.float32)
    if quant:
        kp = rng.integers(-127, 128, (num_pages, page, kvh, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, (num_pages, page, kvh, hd)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (num_pages, page, kvh)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (num_pages, page, kvh)).astype(np.float32)
    else:
        kp = rng.standard_normal((num_pages, page, kvh, hd)).astype(np.float32)
        vp = rng.standard_normal((num_pages, page, kvh, hd)).astype(np.float32)
        ks = vs = None
    return q, kp, vp, ks, vs, tables, np.asarray(lengths, np.int32)


def _jax(*arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _torch(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


@pytest.fixture()
def interpret_mode(monkeypatch):
    monkeypatch.setattr(JA, "_INTERPRET", True)
    yield


PAGE = 4
# Ragged, a dead slot, k*page and k*page+1 (page 4).
LENGTH_CASES = {
    "ragged": [7, 13, 2, 21],
    "dead_slot": [0, 9, 24, 1],
    "page_multiples": [4, 8, 16, 24],
    "page_plus_one": [5, 9, 17, 1],
}


@pytest.mark.parametrize("case", sorted(LENGTH_CASES))
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_decode_matches_jax(interpret_mode, case, quant):
    lengths = LENGTH_CASES[case]
    q, kp, vp, ks, vs, tables, lens = _paged_inputs(
        sum(lengths), b=4, num_pages=25, page=PAGE, kvh=2, hd=64,
        lengths=lengths, quant=quant,
    )
    jargs = _jax(q, kp, vp, tables, lens)
    jsc = dict(zip(("k_scale", "v_scale"), _jax(ks, vs)))
    want = {
        impl: np.asarray(
            JA.paged_decode_attention(*jargs, **jsc, impl=impl)
        )
        for impl in ("xla", "reference", "pallas")
    }
    targs = _torch(q, kp, vp, tables, lens)
    tsc = dict(zip(("k_scale", "v_scale"), _torch(ks, vs)))
    for impl in ("torch", "reference"):
        got = TA.paged_decode_attention(*targs, **tsc, impl=impl).numpy()
        assert TA._LAST_PAGED_IMPL == impl
        for jimpl, ref in want.items():
            np.testing.assert_allclose(
                got, ref, atol=ATOL, rtol=0, err_msg=f"{impl} vs {jimpl}"
            )
        for i, n in enumerate(lengths):
            if n == 0:
                assert np.all(got[i] == 0.0), "a dead slot must be exact 0"


def test_paged_decode_auto_is_torch_on_cpu_and_cuda_refuses_cpu():
    q, kp, vp, _, _, tables, lens = _paged_inputs(
        0, b=2, num_pages=9, page=PAGE, kvh=2, hd=64, lengths=[3, 6]
    )
    args = _torch(q, kp, vp, tables, lens)
    TA.paged_decode_attention(*args)
    assert TA._LAST_PAGED_IMPL == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        TA.paged_decode_attention(*args, impl="cuda")


def test_paged_decode_shape_checks_mirror_jax():
    q, kp, vp, _, _, tables, lens = _paged_inputs(
        1, b=2, num_pages=9, page=PAGE, kvh=2, hd=64, lengths=[3, 6]
    )
    kpt, vpt, tt, lt = _torch(kp, vp, tables, lens)
    with pytest.raises(ValueError, match="shape mismatch"):
        TA.paged_decode_attention(torch.zeros(2, 4, 32), kpt, vpt, tt, lt)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        TA.paged_decode_attention(torch.zeros(2, 3, 64), kpt, vpt, tt, lt)
    with pytest.raises(ValueError, match="together"):
        TA.paged_decode_attention(
            torch.from_numpy(q), kpt, vpt, tt, lt,
            k_scale=torch.zeros(9, PAGE, 2),
        )
    with pytest.raises(ValueError, match="unknown paged"):
        TA.paged_decode_attention(
            torch.from_numpy(q), kpt, vpt, tt, lt, impl="bogus"
        )


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_multiquery_matches_jax(quant):
    b, s = 3, 5
    q, kp, vp, ks, vs, tables, _ = _paged_inputs(
        7, b=b, num_pages=25, page=PAGE, kvh=2, hd=64, lengths=[0] * b,
        quant=quant,
    )
    rng = np.random.default_rng(8)
    qm = rng.standard_normal((b, s, 4, 64)).astype(np.float32)
    pos = np.array([0, 7, 12], np.int32)
    jsc = dict(zip(("k_scale", "v_scale"), _jax(ks, vs)))
    tsc = dict(zip(("k_scale", "v_scale"), _torch(ks, vs)))
    want_x = np.asarray(JA.paged_multiquery_attention(
        *_jax(qm, kp, vp, tables, pos), **jsc, impl="xla"
    ))
    want_r = np.asarray(JA.paged_multiquery_attention(
        *_jax(qm, kp, vp, tables, pos), **jsc, impl="reference"
    ))
    targs = _torch(qm, kp, vp, tables, pos)
    got = TA.paged_multiquery_attention(*targs, **tsc).numpy()
    assert TA._LAST_MULTIQUERY_IMPL == "torch"
    ref = TA.paged_multiquery_attention(*targs, **tsc, impl="reference")
    np.testing.assert_allclose(got, want_x, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ref.numpy(), want_r, atol=ATOL, rtol=0)


# --- pools -----------------------------------------------------------------


def test_pool_helpers_twin():
    import dataclasses

    from tpu_dra.workloads.models.llama import TINY_LLAMA as JT
    from tpu_dra_torch.workloads.models.llama import TINY_LLAMA as TT

    jcfg = dataclasses.replace(JT, dtype=jnp.float32)
    tcfg = dataclasses.replace(TT, dtype=torch.float32)
    jc = JP.init_paged_cache(jcfg, 6, PAGE)
    tc = TP.init_paged_cache(tcfg, 6, PAGE, device="cpu")
    assert tc.num_pages == jc.num_pages and tc.page_size == jc.page_size
    assert tc.n_layers == jc.n_layers and not tc.quantized
    rng = np.random.default_rng(0)
    data = rng.standard_normal(
        (tc.n_layers, 2) + tuple(tc.k[0].shape)
    ).astype(np.float32)
    # Sequence on pages [2, 4] holding 5 positions: zero-tail everywhere.
    data[:, :, 2:5] = 0.0
    data[:, :, 4, 1:] = 0.0
    jc = JP.PagedKVCache(
        k=tuple(jnp.asarray(d[0]) for d in data),
        v=tuple(jnp.asarray(d[1]) for d in data),
    )
    for layer in range(tc.n_layers):
        tc.k[layer].copy_(torch.from_numpy(data[layer, 0]))
        tc.v[layer].copy_(torch.from_numpy(data[layer, 1]))
    for pages, length in (([2, 4], 5), ([1, 4], 5), ([2, 4], 4)):
        assert TP.tail_is_zero(tc, pages, length) == JP.tail_is_zero(
            jc, pages, length
        )
    for ids in ([2, 3], [1], [5, 3]):
        assert TP.pages_are_zero(tc, ids) == JP.pages_are_zero(jc, ids)
    same = TP.zero_pages(tc, [1, 5])
    assert same is tc  # in place
    jc = JP.zero_pages(jc, [1, 5])
    for layer in range(tc.n_layers):
        np.testing.assert_array_equal(tc.k[layer].numpy(), np.asarray(jc.k[layer]))
        np.testing.assert_array_equal(tc.v[layer].numpy(), np.asarray(jc.v[layer]))
    assert TP.pages_are_zero(tc, [1, 5])
    with pytest.raises(ValueError, match="kv_quant"):
        TP.init_paged_cache(
            tcfg, 4, PAGE, kv_quant="int4", device="cpu"
        )
    q8 = TP.init_paged_cache(
        tcfg, 4, PAGE, kv_quant="int8", device="cpu"
    )
    assert q8.quantized and q8.k[0].dtype == torch.int8
    assert tuple(q8.k_scale[0].shape) == (4, PAGE, tcfg.n_kv_heads)
