"""Copy-on-write prefix sharing in the torch engine, held to the JAX
engine on the CPU.

TINY_LLAMA at fp32 with the flax weights converted in-process; the JAX
engine and the port's step through the same trace in lockstep
(tests/torch_twin.py), and after every step their block tables,
allocator (free list, refcounts, low-water mark), prefix registry (in
LRU order) and sharing counters must be equal, and at the end their
tokens. These are the twins of tests/test_engine.py's prefix tests
(the COW fleet, registration alone, fork then evict the parent, the
shared page never zeroed while referenced, the drain under COW), with
sharing also under speculation, sampling and an int8 cache. Port-only
cases: ``copy_page`` against JAX's, a prefix id whose tokens do not
match, LRU eviction, admission shedding the registry's pins, fused ==
unfused under sharing, and the plain paged attention over a block
table whose slots alias the same pages.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_twin import (  # noqa: E402
    JCFG,
    SAMPLED,
    SPEC_EC,
    TCFG,
    Twin,
    assert_same_state,
    assert_same_tokens,
    fleet_trace,
    make_params,
    peak_pages,
    requests,
)

from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra.workloads import paged_kv as JP  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402
from tpu_dra_torch.workloads import paged_kv as TP  # noqa: E402
from tpu_dra_torch.workloads.ops import attention as TA  # noqa: E402
from tpu_dra_torch.workloads.quantize import quantize_kv  # noqa: E402

PROMPT = np.arange(1, 19, dtype=np.int32)  # 18 tokens, prefix 16


@pytest.fixture(scope="module")
def params():
    return make_params()


def _spec_ec(**kw):
    return dict(SPEC_EC, **kw)


# --- copy_page ---------------------------------------------------------------


def _pools(quant: bool, seed=0, pages=6, page=4):
    """The same random pools as a JAX and a torch cache."""
    rng = np.random.default_rng(seed)
    L, kvh, hd = TCFG.n_layers, TCFG.n_kv_heads, TCFG.head_dim
    shape = (L, pages, page, kvh, hd)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.random(shape[:-1]).astype(np.float32)
        vs = rng.random(shape[:-1]).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        ks = vs = None
    j = JP.PagedKVCache(
        k=tuple(jnp.asarray(x) for x in k), v=tuple(jnp.asarray(x) for x in v),
        k_scale=None if ks is None else tuple(jnp.asarray(x) for x in ks),
        v_scale=None if vs is None else tuple(jnp.asarray(x) for x in vs),
    )
    t = TP.PagedKVCache(
        k=[torch.from_numpy(x.copy()) for x in k],
        v=[torch.from_numpy(x.copy()) for x in v],
        k_scale=None if ks is None else [torch.from_numpy(x.copy())
                                         for x in ks],
        v_scale=None if vs is None else [torch.from_numpy(x.copy())
                                         for x in vs],
    )
    return j, t


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_copy_page_bit_identical_to_jax(quant):
    jc, tc = _pools(quant)
    for src, dst in ((3, 1), (1, 5), (2, 2)):
        jc = JP.copy_page(jc, src, dst)
        assert TP.copy_page(tc, src, dst) is tc  # in place
    assert len(tc._pools()) == (4 if quant else 2)
    for (_, jpool), (_, tpool) in zip(jc._pools(), tc._pools()):
        for jl, tl in zip(jpool, tpool):
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # Page 1 now holds page 3's values and scales.
    for _, pool in tc._pools():
        for layer in pool:
            assert torch.equal(layer[1], layer[3])


# --- the JAX engine's prefix tests, twinned ----------------------------------

FLEET_CASES = [{}, {"spec_k": 4}, SAMPLED, {"kv_quant": "int8"}]
FLEET_IDS = ["greedy", "spec", "sampled", "kv8"]


@pytest.mark.parametrize("kw", FLEET_CASES, ids=FLEET_IDS)
def test_cow_fleet_matches_jax_and_saves_pages(params, kw):
    """tests/test_engine.py:708, and under speculation, sampling and an
    int8 cache: the shared fleet's tokens equal the private fleet's and
    JAX's, step by step the allocator and registry equal JAX's, peak
    pages fall, and the pool ends whole with every page zero."""
    ec = _spec_ec(max_slots=3, max_pages_per_seq=10, **kw)
    private = Twin(params, ec)
    p_j, p_t = private.run(fleet_trace(PROMPT, 3, share=False))
    shared = Twin(params, ec)
    s_j, s_t = shared.run(fleet_trace(PROMPT, 3, share=True))
    assert_same_tokens(s_j, s_t)
    assert_same_tokens(p_t, s_t)
    assert_same_tokens(p_j, p_t)
    eng = shared.t
    assert peak_pages(eng) < peak_pages(private.t)
    assert eng.prefix_attached == 2
    assert eng.cow_copies == 0  # 16 tokens of 4-token pages: no boundary
    assert eng.prefix_saved_hw > 0
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    assert eng.allocator.reserved_pages == 0
    assert TP.pages_are_zero(eng.cache, range(1, eng.allocator.num_pages))
    if kw.get("spec_k"):
        assert eng.spec_proposed > 0


def test_registration_alone_reports_zero_shared_pages(params):
    """tests/test_engine.py:738: the registry's own pins are no
    saving; co-resident sharers move the high-water."""
    tw = Twin(params, _spec_ec(max_slots=3, max_pages_per_seq=10))
    tw.add([("lone", PROMPT, 8, {"prefix_id": "sys", "prefix_len": 16})])
    while tw.t.busy and not tw.t._prefix_registry:
        tw.step()
    assert tw.t._prefix_registry
    assert tw.t._track_shared() == tw.j._track_shared() == 0
    while tw.t.busy:
        tw.step()
    assert tw.t.prefix_saved_hw == 0
    jd, td = tw.run(fleet_trace(PROMPT, 3))
    assert_same_tokens(jd, td)
    assert tw.t.prefix_attached >= 2 and tw.t.prefix_saved_hw >= 1


def test_fork_then_evict_parent_leaves_child_valid(params):
    """tests/test_engine.py:768: the registering parent finishes while
    its sharer decodes; the child still matches the private run."""
    ec = _spec_ec(max_slots=2, max_pages_per_seq=12)
    share = {"prefix_id": "sys", "prefix_len": 16}
    trace = [("parent", PROMPT, 1, share), ("child", PROMPT, 14, share)]
    jd, td = Twin(params, ec).run(trace)
    assert_same_tokens(jd, td)
    _, ref = Twin(params, ec).run([(r, p, n, {}) for r, p, n, _ in trace])
    assert_same_tokens(ref, td)


def test_drain_under_cow_resume_reattaches_and_matches(params):
    """tests/test_engine.py:790: a drain over a shared fleet flushes
    the registry and frees every page; on resume the first sharer
    re-registers and the rest re-attach, token-identical to the
    undrained run and to JAX."""
    ec = _spec_ec(max_slots=3, max_pages_per_seq=12)
    _, ref = Twin(params, ec).run(fleet_trace(PROMPT, 3, max_new=16))
    gates = (JE.EventGate(), TE.EventGate())
    tw = Twin(params, ec, gates=gates)
    tw.add(fleet_trace(PROMPT, 3, max_new=16))
    tw.step(4)
    assert any(s is not None for s in tw.t._slots)
    before = tw.t.prefix_attached
    assert before >= 2
    for g in gates:
        g.revoke()
    tw.step()
    assert tw.t.allocator.free_pages == tw.t.allocator.num_pages - 1
    assert not tw.t._prefix_registry
    for g in gates:
        g.restore()
    jd, td = tw.run()
    assert tw.t.prefix_attached > before
    assert_same_tokens(jd, td)
    assert_same_tokens(ref, td)


def test_shared_page_not_zeroed_while_referenced(params):
    """tests/test_engine.py:823: releasing one sharer queues no page
    that the registry or another table still references."""
    tw = Twin(params, _spec_ec(max_slots=2, max_pages_per_seq=12))
    share = {"prefix_id": "sys", "prefix_len": 16}
    tw.add([("parent", PROMPT, 1, share), ("child", PROMPT, 12, share)])
    while tw.t.busy and "parent" not in tw.t.completed:
        tw.step()
    live = {pg for e in tw.t._prefix_registry.values() for pg in e.pages}
    assert live
    assert not live & set(tw.t._pending_zero)
    held = {pg for s in tw.t._slots if s is not None for pg in s.pages}
    assert not held & set(tw.t._pending_zero)
    jd, td = tw.run()
    assert_same_tokens(jd, td)
    assert len(td) == 2


def test_mid_page_prefix_freezes_boundary_and_forks_once(params):
    """A prefix ending mid-page (14 of 4-token pages): the boundary is
    frozen into a private copy whose tail is zero, every sharer forks it
    once, and the counts match JAX's."""
    ec = _spec_ec(max_slots=3, max_pages_per_seq=10)
    tw = Twin(params, ec)
    tw.add(fleet_trace(PROMPT, 3, prefix_len=14))
    while not tw.t._prefix_registry:
        tw.step()
    (entry,) = tw.t._prefix_registry.values()
    assert entry.length == 14 and len(entry.pages) == 4
    frozen = entry.pages[-1]
    assert TP.tail_is_zero(tw.t.cache, [frozen], 2)
    jd, td = tw.run()
    assert_same_tokens(jd, td)
    assert tw.t.prefix_attached == 2 and tw.t.cow_copies == 2
    _, ref = Twin(params, ec).run(fleet_trace(PROMPT, 3, share=False))
    assert_same_tokens(ref, td)


# --- port-only cases ---------------------------------------------------------


def test_prefix_id_with_other_tokens_shares_nothing(params):
    """The id is a hint: a request naming a registered prefix whose
    tokens differ prefills privately."""
    other = PROMPT.copy()
    other[3] += 1
    share = {"prefix_id": "sys", "prefix_len": 16}
    trace = [("a", PROMPT, 6, share), ("b", other, 6, share)]
    tw = Twin(params, _spec_ec(max_slots=2))
    jd, td = tw.run(trace)
    assert_same_tokens(jd, td)
    assert tw.t.prefix_attached == 0 and tw.t.cow_copies == 0
    _, ref = Twin(params, _spec_ec(max_slots=2)).run(
        [(r, p, n, {}) for r, p, n, _ in trace])
    assert_same_tokens(ref, td)


def test_lru_keeps_one_entry_at_cap_one(params):
    """prefix_cache_entries=1 with two ids: registering the second
    evicts the first, and a later sharer of the first registers it
    again; registry order and tokens as JAX's."""
    second = PROMPT[::-1].copy()
    tw = Twin(params, _spec_ec(max_slots=1, prefix_cache_entries=1))
    tw.add([("a", PROMPT, 2, {"prefix_id": "A", "prefix_len": 8}),
            ("b", second, 2, {"prefix_id": "B", "prefix_len": 8})])
    seen = []
    while tw.t.busy:
        tw.step()
        keys = list(tw.t._prefix_registry)
        assert len(keys) <= 1
        if keys and (not seen or seen[-1] != keys):
            seen.append(keys)
    assert seen == [["A"], ["B"]]
    jd, td = tw.run([("a2", PROMPT, 2, {"prefix_id": "A",
                                        "prefix_len": 8})])
    assert_same_tokens(jd, td)
    assert tw.t.prefix_attached == 0  # "A" was evicted, re-registered


def test_admission_sheds_prefix_pins_under_page_pressure(params):
    """A pool the registry's pins would make too small for the next
    request: admission evicts the entry instead of blocking, as JAX's."""
    ec = _spec_ec(max_slots=1, max_pages_per_seq=10, num_pages=11)
    tw = Twin(params, ec)
    tw.add([("a", PROMPT, 4, {"prefix_id": "A", "prefix_len": 16})])
    while tw.t.busy:
        tw.step()
    assert list(tw.t._prefix_registry) == ["A"]
    pinned = tw.t.allocator.num_pages - 1 - tw.t.allocator.free_pages
    assert pinned == 4
    # 18 + 12 + 3 positions: 9 pages of 4, more than the 6 unpinned.
    tw.add([("b", PROMPT[::-1].copy(), 12, {})])
    tw.step()
    assert not tw.t._prefix_registry
    assert tw.t._slots[0] is not None
    jd, td = tw.run()
    assert_same_tokens(jd, td)


@pytest.mark.parametrize("kw", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_fused_matches_unfused_and_contiguous_under_sharing(params, kw):
    """The fused chunk feeds device copies of the tables between
    chunks; a fork or attach that left them stale would read the shared
    page. Fused, unfused and the contiguous engine (where sharing is a
    no-op) give the same tokens on a mid-page shared fleet."""
    trace = fleet_trace(PROMPT, 3, max_new=12, prefix_len=14)
    ec = _spec_ec(max_slots=3, max_pages_per_seq=10, **kw)
    out = {}
    for label, extra in (("fused", {}), ("unfused", {"fused": False}),
                         ("contiguous", {"contiguous": True})):
        eng = TE.Engine(TCFG, params[1],
                        TE.EngineConfig(**ec, **extra), device="cpu")
        out[label] = eng.run(requests(TE, trace))
        if label == "contiguous":
            assert eng.prefix_attached == eng.cow_copies == 0
        else:
            assert eng.prefix_attached == 2 and eng.cow_copies == 2
    for label in ("unfused", "contiguous"):
        assert_same_tokens(out["fused"], out[label])


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_plain_paged_attention_aliased_table_bit_identical(quant):
    """All slots alias the same leading pages, then each slot reads
    private copies of them (copy_page): the plain paged attention reads
    the same numbers in the same order, so the outputs are equal bit
    for bit."""
    g = torch.Generator().manual_seed(3)
    b, page, shared, tail, kvh, n_rep, hd = 4, 4, 3, 2, 2, 2, 16
    pages = 1 + shared + b * (tail + shared)
    kp = torch.randn(pages, page, kvh, hd, generator=g)
    vp = torch.randn(pages, page, kvh, hd, generator=g)
    cache = TP.PagedKVCache(k=[kp], v=[vp])
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        cache = TP.PagedKVCache(k=[kq], v=[vq], k_scale=[ks], v_scale=[vs])
    q = torch.randn(b, kvh * n_rep, hd, generator=g)
    aliased = torch.zeros(b, shared + tail + 1, dtype=torch.int32)
    private = aliased.clone()
    nxt = 1 + shared
    for s in range(b):
        aliased[s, :shared] = torch.arange(1, 1 + shared)
        for j in range(shared):
            TP.copy_page(cache, 1 + j, nxt)
            private[s, j] = nxt
            nxt += 1
        for j in range(shared, shared + tail):
            aliased[s, j] = private[s, j] = nxt
            nxt += 1
    lengths = torch.tensor([shared * page + 1, 13, 17, 20], dtype=torch.int32)
    scales = ({"k_scale": cache.k_scale[0], "v_scale": cache.v_scale[0]}
              if quant else {})
    args = (q, cache.k[0], cache.v[0])
    one = TA.paged_decode_attention(*args, aliased, lengths, **scales,
                                    impl="torch")
    two = TA.paged_decode_attention(*args, private, lengths, **scales,
                                    impl="torch")
    assert torch.equal(one, two)
    assert not torch.equal(aliased, private)


def test_shared_pages_keep_state_equal_to_jax_every_step(params):
    """A mixed trace (two prefixes, one private request) stepped in
    lockstep: tables, refcounts and the registry equal JAX's after every
    step (Twin.step asserts it), and the tokens at the end."""
    rng = np.random.default_rng(21)
    sys_a, sys_b = PROMPT, rng.integers(1, JCFG.vocab_size, 18).astype(
        np.int32)
    trace = []
    for i in range(5):
        base = (sys_a, sys_b)[i % 2]
        prompt = np.concatenate([base[:14], rng.integers(
            1, JCFG.vocab_size, 2 + i).astype(np.int32)])
        trace.append((f"m{i}", prompt, 5 + i,
                      {"prefix_id": "AB"[i % 2], "prefix_len": 14}))
    trace.append(("solo", rng.integers(1, JCFG.vocab_size, 9).astype(
        np.int32), 6, {}))
    tw = Twin(params, _spec_ec(max_slots=3, max_pages_per_seq=10))
    jd, td = tw.run(trace)
    assert_same_tokens(jd, td)
    assert tw.t.prefix_attached > 0
    assert_same_state(tw.j, tw.t)
