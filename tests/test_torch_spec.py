"""Speculative decoding in the torch engine, held to the JAX engine on
the CPU.

TINY_LLAMA at fp32 with converted weights; the twins of
tests/test_engine.py's speculative tests. The port's spec engine
(draft, one verify pass of spec_k + 1 positions, acceptance on the
device, host rewind) must give the same tokens as its own per-token
oracle (``fused=False, contiguous=True``), greedy and sampled, with any
draft source — and the same tokens and the same proposed/accepted
counts as the JAX spec engine. A rejection-heavy trace rewinds with no
leaked page and every freed page zero. The draft sources are copies of
the JAX ones and propose the same tokens; the page-tail helpers match
JAX's.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra.workloads import paged_kv as JP  # noqa: E402
from tpu_dra.workloads import specdraft as JS  # noqa: E402
from tpu_dra.workloads.models.llama import TINY_LLAMA as JAX_TINY  # noqa: E402
from tpu_dra.workloads.models.llama import Llama  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402
from tpu_dra_torch.workloads import paged_kv as TP  # noqa: E402
from tpu_dra_torch.workloads import specdraft as TS  # noqa: E402
from tpu_dra_torch.workloads.convert import params_from_numpy  # noqa: E402
from tpu_dra_torch.workloads.models.llama import TINY_LLAMA  # noqa: E402

JCFG = dataclasses.replace(
    JAX_TINY, dtype=jnp.float32, param_dtype=jnp.float32
)
TCFG = dataclasses.replace(
    TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32
)
EC = dict(page_size=4, max_slots=3, max_pages_per_seq=16, scan_chunk=3,
          prefill_chunk=8)
SAMPLED = dict(temperature=0.8, top_k=8, sample_seed=11)


@pytest.fixture(scope="module")
def jax_params():
    return Llama(JCFG).init_params(jax.random.PRNGKey(7), batch=2, seq=8)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    return params_from_numpy(tree, TCFG, device="cpu")


def _lookup_trace(n=4, seed=3, max_new=16):
    """Repetitive prompts: the n-gram proposer has real structure."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(1, JCFG.vocab_size, 5).astype(np.int32)
        out.append((f"lk{i}", np.tile(motif, 4)[:18], max_new))
    return out


def _random_trace(n=5, seed=29, max_prompt=14, max_new=9):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(
            1, JCFG.vocab_size, rng.integers(2, max_prompt + 1)
        ).astype(np.int32)
        out.append((f"r{i}", prompt, int(rng.integers(1, max_new + 1))))
    return out


def _torch_engine(params, draft=None, **kw):
    return TE.Engine(TCFG, params, TE.EngineConfig(**{**EC, **kw}),
                     device="cpu", draft_source=draft)


def _torch_run(params, trace, draft=None, **kw):
    eng = _torch_engine(params, draft, **kw)
    return eng, eng.run([
        TE.Request(rid=r, prompt=p, max_new_tokens=n) for r, p, n in trace
    ])


def _jax_run(params, trace, draft=None, **kw):
    eng = JE.Engine(JCFG, params, JE.EngineConfig(**{**EC, **kw}),
                    draft_source=draft)
    return eng, eng.run([
        JE.Request(rid=r, prompt=p, max_new_tokens=n) for r, p, n in trace
    ])


def _same_tokens(a, b):
    assert set(a) == set(b)
    for rid in a:
        assert np.array_equal(a[rid].tokens, b[rid].tokens), rid


def _leak_free_and_zero(eng):
    alloc = eng.allocator
    assert alloc.free_pages == alloc.num_pages - 1, "rewind leaked pages"
    assert alloc.reserved_pages == 0
    assert TP.pages_are_zero(eng.cache, range(1, alloc.num_pages)), (
        "rewind left unzeroed pages")


CASES = {
    "greedy": ({}, _lookup_trace),
    "sampled": (SAMPLED, _lookup_trace),
    "w8kv8_greedy": ({"kv_quant": "int8", "weight_quant": "int8"},
                     _lookup_trace),
    "rejection_heavy": ({}, _random_trace),
    "rejection_heavy_sampled": (SAMPLED, _random_trace),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_engine_matches_oracle_and_jax(jax_params, torch_params, case):
    kw, trace_fn = CASES[case]
    trace = trace_fn()
    eng, spec = _torch_run(torch_params, trace, spec_k=4, **kw)
    _, oracle = _torch_run(torch_params, trace, fused=False,
                           contiguous=True, **kw)
    _same_tokens(spec, oracle)
    jeng, jspec = _jax_run(jax_params, trace, spec_k=4, **kw)
    _same_tokens(spec, jspec)
    assert (eng.spec_proposed, eng.spec_accepted) == (
        jeng.spec_proposed, jeng.spec_accepted)
    assert eng.spec_proposed > 0 and eng.verify_passes > 0
    if trace_fn is _lookup_trace and not kw.get("temperature"):
        assert eng.spec_accepted > 0, "no draft was accepted"
    _leak_free_and_zero(eng)


def test_spec_rejection_heavy_trace_rewinds(torch_params):
    """Random prompts: most drafts are rejected, so most verify passes
    rewind — pages past the accepted length leave the table, the
    boundary page's tail is zeroed — and the pool still ends whole."""
    eng, _ = _torch_run(torch_params, _random_trace(), spec_k=4)
    assert eng.spec_accepted < eng.spec_proposed / 2
    _leak_free_and_zero(eng)


@pytest.mark.parametrize("tokens", [np.full(8, 1, np.int32),
                                    np.arange(3, 11, dtype=np.int32)],
                         ids=["always_one", "ramp"])
def test_spec_adversarial_static_draft_cannot_change_tokens(
    jax_params, torch_params, tokens
):
    trace = _random_trace(4, seed=37)
    eng, spec = _torch_run(torch_params, trace, TS.StaticDraft(tokens),
                           spec_k=3)
    _, oracle = _torch_run(torch_params, trace, fused=False,
                           contiguous=True)
    _same_tokens(spec, oracle)
    jeng, jspec = _jax_run(jax_params, trace, JS.StaticDraft(tokens),
                           spec_k=3)
    _same_tokens(spec, jspec)
    assert eng.spec_proposed == jeng.spec_proposed
    _leak_free_and_zero(eng)


def test_spec_out_of_vocab_drafts_cut_at_first_bad_id(torch_params):
    """Drafts [5, vocab, 7]: only [5] reaches the verify pass each time,
    and the tokens are the oracle's."""
    trace = _random_trace(3, seed=41)
    bad = TS.StaticDraft(np.array([5, TCFG.vocab_size, 7], np.int32))
    eng, spec = _torch_run(torch_params, trace, bad, spec_k=3)
    _, oracle = _torch_run(torch_params, trace, fused=False,
                           contiguous=True)
    _same_tokens(spec, oracle)
    # At most the one good draft per live slot and verify pass.
    assert 0 < eng.spec_proposed <= eng.verify_passes * EC["max_slots"]


def test_spec_draft_cap_leaves_one_token_for_the_verify(torch_params):
    """A sequence with r tokens left gets at most r - 1 drafts: every
    request ends at exactly its max_new_tokens, and one-token requests
    are never drafted for."""
    calls = []

    class Recording(TS.StaticDraft):
        def propose(self, history, k):
            calls.append(k)
            return super().propose(history, k)

    trace = [("one", np.arange(1, 6, dtype=np.int32), 1),
             ("two", np.arange(1, 6, dtype=np.int32), 2),
             ("many", np.arange(1, 6, dtype=np.int32), 9)]
    eng, done = _torch_run(torch_params, trace,
                           Recording(np.arange(1, 9, dtype=np.int32)),
                           spec_k=4)
    assert [len(done[r].tokens) for r, _, _ in trace] == [1, 2, 9]
    assert calls and max(calls) <= 4 and min(calls) >= 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("order", [1, 3])
def test_ngram_draft_proposals_match_jax(seed, order):
    rng = np.random.default_rng(seed)
    motif = rng.integers(1, 50, 6)
    for _ in range(20):
        n = int(rng.integers(1, 40))
        history = np.concatenate(
            [np.tile(motif, 6)[: n], rng.integers(1, 50, 3)]
        ).astype(np.int32)
        k = int(rng.integers(0, 6))
        want = JS.NgramDraft(order).propose(history, k)
        got = TS.NgramDraft(order).propose(history, k)
        assert got.dtype == np.int32 and np.array_equal(want, got)
    assert isinstance(TS.NgramDraft(order), TS.DraftSource)


def test_ngram_draft_refuses_order_zero():
    with pytest.raises(ValueError, match="order"):
        TS.NgramDraft(0)


def test_default_draft_source_is_ngram_of_the_lookup_order(torch_params):
    eng = _torch_engine(torch_params, spec_k=2, spec_lookup_order=2)
    assert isinstance(eng._draft, TS.NgramDraft) and eng._draft.order == 2
    assert _torch_engine(torch_params)._draft is None


@pytest.mark.parametrize(
    "kw, match",
    [({"spec_k": 2, "fused": False}, "requires fused"),
     ({"spec_k": 2, "sharded": True}, "sharded"),
     ({"spec_k": -1}, ">= 0")],
    ids=["unfused", "sharded", "negative"],
)
def test_spec_config_refusals(torch_params, kw, match):
    with pytest.raises(ValueError, match=match):
        _torch_engine(torch_params, **kw)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_zero_page_tail_and_copy_page_prefix_match_jax(kv_quant):
    rng = np.random.default_rng(5)
    jcache = JP.init_paged_cache(JCFG, 5, 4, kv_quant=kv_quant)
    tcache = TP.init_paged_cache(TCFG, 5, 4, kv_quant=kv_quant,
                                 device="cpu")
    fills = {}
    for name, pool in jcache._pools():
        fills[name] = [
            rng.integers(-100, 100, np.shape(p)).astype(np.asarray(p).dtype)
            for p in pool
        ]
    jcache = JP.PagedKVCache(**{
        name: tuple(jnp.asarray(a) for a in arrs)
        for name, arrs in fills.items()
    })
    for name, pool in tcache._pools():
        for layer, arr in zip(pool, fills[name]):
            layer.copy_(torch.from_numpy(arr))
    jcache = JP.zero_page_tail(jcache, 2, 3)
    assert TP.zero_page_tail(tcache, 2, 3) is tcache
    jcache = JP.copy_page_prefix(jcache, 1, 4, 2)
    TP.copy_page_prefix(tcache, 1, 4, 2)
    for (name, jpool), (_, tpool) in zip(jcache._pools(), tcache._pools()):
        for jl, tl in zip(jpool, tpool):
            assert np.array_equal(np.asarray(jl), tl.numpy()), name
    assert TP.tail_is_zero(tcache, [2], 3)
    assert TP.tail_is_zero(tcache, [4], 2)
    with pytest.raises(ValueError, match="upto"):
        TP.copy_page_prefix(tcache, 1, 2, 5)
