"""The torch serving engine held to the JAX engine on the CPU.

The same seeded trace, on TINY_LLAMA at fp32 with the same weights (the
flax tree converted in-process), goes through the JAX ``Engine`` and the
port's ``Engine(device="cpu")``: greedy and sampled tokens must be
identical for every request, with fp32 pools and under
``kv_quant="int8"``, ``weight_quant="int8"`` and both. Within the port:
fused == unfused, paged == contiguous, sampled tokens do not depend on
the chunking or the admission order (the (seed, serial, position) key
schedule), the allocator ends leak-free with every freed page zero
(scale pools included), and ``sharded`` without a process group is the
unsharded engine on a (1, 1) mesh. Speculative decoding:
tests/test_torch_spec.py; prefix sharing: tests/test_torch_prefix.py;
lease gates, the drain and metrics: tests/test_torch_drain.py.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra.workloads.generate import unroll_params  # noqa: E402
from tpu_dra.workloads.models.llama import TINY_LLAMA as JAX_TINY  # noqa: E402
from tpu_dra.workloads.models.llama import Llama  # noqa: E402
from tpu_dra.workloads.paged_kv import init_paged_cache as jax_init_cache  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402
from tpu_dra_torch.workloads import paged_kv as TP  # noqa: E402
from tpu_dra_torch.workloads.convert import params_from_numpy  # noqa: E402
from tpu_dra_torch.workloads.models.llama import TINY_LLAMA  # noqa: E402
from tpu_dra_torch.workloads.ops import attention as TA  # noqa: E402
from tpu_dra_torch.workloads.ops import decode_mlp as TDM  # noqa: E402

JCFG = dataclasses.replace(
    JAX_TINY, dtype=jnp.float32, param_dtype=jnp.float32
)
TCFG = dataclasses.replace(
    TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32
)

EC = dict(
    page_size=4, max_slots=3, max_pages_per_seq=10, scan_chunk=3,
    prefill_chunk=8,
)


@pytest.fixture(scope="module")
def jax_params():
    return Llama(JCFG).init_params(jax.random.PRNGKey(7), batch=2, seq=8)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    return params_from_numpy(tree, TCFG, device="cpu")


def _trace(n=6, seed=11, max_prompt=14, max_new=9):
    """(rid, prompt, max_new) triples, as tests/test_engine.py draws them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(
            1, JCFG.vocab_size, rng.integers(2, max_prompt + 1)
        ).astype(np.int32)
        out.append((f"r{i}", prompt, int(rng.integers(1, max_new + 1))))
    return out


def _torch_run(params, trace=None, **kw):
    eng = TE.Engine(
        TCFG, params, TE.EngineConfig(**{**EC, **kw}), device="cpu"
    )
    done = eng.run([
        TE.Request(rid=r, prompt=p, max_new_tokens=n)
        for r, p, n in (trace or _trace())
    ])
    return eng, done


@pytest.fixture(scope="module")
def jax_done(jax_params):
    eng = JE.Engine(JCFG, jax_params, JE.EngineConfig(**EC))
    return eng.run([
        JE.Request(rid=r, prompt=p, max_new_tokens=n) for r, p, n in _trace()
    ])


def test_greedy_tokens_identical_to_jax_engine(jax_done, torch_params):
    eng, done = _torch_run(torch_params)
    assert sorted(done) == sorted(jax_done)
    for rid, _prompt, n in _trace():
        assert len(done[rid].tokens) == n
        assert np.array_equal(done[rid].tokens, jax_done[rid].tokens), rid
    # The CPU engine ran the plain twins of both kernels.
    assert TA._LAST_PAGED_IMPL == "torch"
    assert TDM._LAST_DECODE_MLP_IMPL == "torch"
    assert eng.decode_steps > 0


QUANT_CASES = [
    {"kv_quant": "int8"}, {"weight_quant": "int8"},
    {"kv_quant": "int8", "weight_quant": "int8"},
]
QUANT_IDS = ["kv8", "w8", "w8kv8"]


@pytest.mark.parametrize("kw", QUANT_CASES, ids=QUANT_IDS)
def test_int8_greedy_tokens_identical_to_jax_engine(jax_params, torch_params,
                                                    kw):
    want = JE.Engine(JCFG, jax_params, JE.EngineConfig(**{**EC, **kw})).run([
        JE.Request(rid=r, prompt=p, max_new_tokens=n) for r, p, n in _trace()
    ])
    eng, done = _torch_run(torch_params, **kw)
    for rid, _prompt, n in _trace():
        assert len(done[rid].tokens) == n
        assert np.array_equal(done[rid].tokens, want[rid].tokens), rid
    assert eng.cache.quantized == (kw.get("kv_quant") == "int8")
    lm_head = eng.params["lm_head"]
    assert ("kernel_q" in lm_head) == (kw.get("weight_quant") == "int8")


@pytest.mark.parametrize("kw", QUANT_CASES, ids=QUANT_IDS)
def test_int8_fused_unfused_contiguous_and_leak_free(torch_params, kw):
    eng, paged = _torch_run(torch_params, **kw)
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    assert eng.allocator.reserved_pages == 0
    # Every pool, the scale pools included, is zero on every freed page.
    assert TP.pages_are_zero(eng.cache, range(1, eng.allocator.num_pages))
    if eng.cache.quantized:
        assert len(eng.cache._pools()) == 4
    _, unfused = _torch_run(torch_params, fused=False, **kw)
    _, contiguous = _torch_run(torch_params, contiguous=True, **kw)
    for rid in paged:
        for other in (unfused, contiguous):
            assert np.array_equal(paged[rid].tokens, other[rid].tokens), rid


def test_prefill_batch_int8_pools_match_jax(jax_params, torch_params):
    """One batched prefill bucket into int8 pools: logits to 1e-4, the
    written int8 K/V bit-identical to JAX's, their scales to 1e-6."""
    tables, starts, valids, tokens = _prefill_bucket()
    jcache = jax_init_cache(JCFG, 9, 4, kv_quant="int8")
    jcache, jlogits = JE._prefill_batch(
        JCFG, True, unroll_params(jax_params), jcache,
        *map(jnp.asarray, (tables, starts, tokens, valids)),
    )
    tcache = TP.init_paged_cache(TCFG, 9, 4, kv_quant="int8", device="cpu")
    tlogits = TE._prefill_batch(
        TCFG, torch_params.tree(), tcache,
        *map(torch.from_numpy, (tables, starts, tokens, valids)),
    )
    np.testing.assert_allclose(
        tlogits[:2].numpy(), np.asarray(jlogits)[:2], atol=1e-4, rtol=0
    )
    for layer in range(TCFG.n_layers):
        for jp, tp in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
            assert tp[layer].dtype == torch.int8
            np.testing.assert_array_equal(
                tp[layer][1:].numpy(), np.asarray(jp[layer])[1:]
            )
        for jp, tp in ((jcache.k_scale, tcache.k_scale),
                       (jcache.v_scale, tcache.v_scale)):
            np.testing.assert_allclose(
                tp[layer][1:].numpy(), np.asarray(jp[layer])[1:],
                atol=1e-6, rtol=0,
            )


def _prefill_bucket():
    """(tables, starts, valids, tokens) of one bucket: two rows, one
    idle pad row, pages 1-8 of a 9-page pool of 4-token pages."""
    rng = np.random.default_rng(3)
    tables = np.zeros((4, 4), np.int32)
    tables[0] = [1, 2, 3, 4]
    tables[1] = [5, 6, 7, 8]
    starts = np.zeros((4,), np.int32)
    valids = np.array([8, 5, 0, 0], np.int32)
    tokens = rng.integers(1, 256, (4, 8)).astype(np.int32)
    tokens[1, 5:] = 0
    tokens[2:] = 0
    return tables, starts, valids, tokens


def test_prefill_batch_logits_and_pools_match_jax(jax_params, torch_params):
    """One batched prefill bucket (two rows, one idle pad row) from
    zeroed pools: logits to 1e-4, written K/V to 1e-5."""
    rng = np.random.default_rng(3)
    P, page, M = 9, 4, 4
    tables = np.zeros((4, M), np.int32)
    tables[0] = [1, 2, 3, 4]
    tables[1] = [5, 6, 7, 8]
    starts = np.array([0, 0, 0, 0], np.int32)
    valids = np.array([8, 5, 0, 0], np.int32)
    tokens = rng.integers(1, 256, (4, 8)).astype(np.int32)
    tokens[1, 5:] = 0
    tokens[2:] = 0

    jcache = jax_init_cache(JCFG, P, page)
    jcache, jlogits = JE._prefill_batch(
        JCFG, False, unroll_params(jax_params), jcache,
        jnp.asarray(tables), jnp.asarray(starts), jnp.asarray(tokens),
        jnp.asarray(valids),
    )
    tcache = TP.init_paged_cache(TCFG, P, page, device="cpu")
    tlogits = TE._prefill_batch(
        TCFG, torch_params.tree(), tcache, torch.from_numpy(tables),
        torch.from_numpy(starts), torch.from_numpy(tokens),
        torch.from_numpy(valids),
    )
    np.testing.assert_allclose(
        tlogits[:2].numpy(), np.asarray(jlogits)[:2], atol=1e-4, rtol=0
    )
    for layer in range(TCFG.n_layers):
        for jp, tp in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
            np.testing.assert_allclose(
                tp[layer][1:].numpy(), np.asarray(jp[layer])[1:],
                atol=1e-5, rtol=0,
            )


def test_fused_matches_unfused_and_paged_matches_contiguous(torch_params):
    _, paged = _torch_run(torch_params)
    _, oracle = _torch_run(torch_params, fused=False, contiguous=True)
    _, unfused = _torch_run(torch_params, fused=False)
    _, contiguous = _torch_run(torch_params, contiguous=True)
    for rid in paged:
        for other in (oracle, unfused, contiguous):
            assert np.array_equal(paged[rid].tokens, other[rid].tokens), rid


def test_allocator_leak_free_and_pages_zero_after_run(torch_params):
    eng, done = _torch_run(torch_params)
    assert len(done) == len(_trace())
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    assert eng.allocator.reserved_pages == 0
    assert TP.pages_are_zero(eng.cache, range(1, eng.allocator.num_pages))
    assert not eng.busy
    for c in done.values():
        assert c.t_submit <= c.t_first_token <= c.t_done


def test_serial_prefill_rows_give_the_same_tokens(torch_params):
    """prefill_batch=1 (one row per bucket) changes the schedule, not
    the tokens."""
    _, batched = _torch_run(torch_params)
    _, serial = _torch_run(torch_params, prefill_batch=1)
    for rid in batched:
        assert np.array_equal(batched[rid].tokens, serial[rid].tokens), rid


@pytest.mark.parametrize("kw", [{"sharded": True}], ids=["sharded"])
def test_unported_knobs_raise(torch_params, jax_done, kw):
    """Every EngineConfig knob is ported now: ``sharded=True`` without a
    process group builds a (1, 1) mesh, keeps the config (and so the
    kernels), issues no collective and gives the unsharded tokens (the
    multi-rank meshes: tests/test_torch_sharded.py)."""
    eng, done = _torch_run(torch_params, **kw)
    assert eng.mesh.shape == {"batch": 1, "model": 1}
    assert eng.config is TCFG
    assert sum(eng.mesh.collectives.values()) == 0
    for rid, _prompt, _n in _trace():
        assert np.array_equal(done[rid].tokens, jax_done[rid].tokens), rid


@pytest.mark.parametrize(
    "kw", [{"kv_quant": "int4"}, {"weight_quant": "fp8"}, {"scan_chunk": 0}]
)
def test_bad_knob_values_raise_value_error(torch_params, kw):
    with pytest.raises(ValueError):
        TE.Engine(
            TCFG, torch_params, TE.EngineConfig(**{**EC, **kw}),
            device="cpu",
        )


def test_engine_defaults_to_cuda_and_raises_without_it(
    torch_params, monkeypatch
):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.Engine(TCFG, torch_params, TE.EngineConfig(**EC))
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.Engine(TCFG, torch_params, TE.EngineConfig(**EC), device="cuda")


def test_weights_and_cache_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"final_norm": {"scale": np.ones(TCFG.dim, np.float32)}}
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(tree, TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.init_paged_cache(TCFG, 4, 2)
    cpu = params_from_numpy(tree, TCFG, device="cpu").tree()
    assert cpu["final_norm"]["scale"].device.type == "cpu"
    cache = TP.init_paged_cache(TCFG, 4, 2, device="cpu")
    assert cache.k[0].device.type == "cpu"


def test_duplicate_and_oversized_requests_raise(torch_params):
    eng = TE.Engine(TCFG, torch_params, TE.EngineConfig(**EC), device="cpu")
    eng.add_request(
        TE.Request(rid="a", prompt=np.ones(3, np.int32), max_new_tokens=2)
    )
    with pytest.raises(ValueError, match="duplicate"):
        eng.add_request(
            TE.Request(rid="a", prompt=np.ones(3, np.int32), max_new_tokens=2)
        )
    with pytest.raises(ValueError, match="page budget"):
        eng.add_request(
            TE.Request(rid="b", prompt=np.ones(30, np.int32),
                       max_new_tokens=10)
        )


def test_device_state_reused_between_chunks(torch_params):
    """A steady decode stretch feeds each chunk's lengths/last tokens to
    the next on the device: no re-upload until host bookkeeping changes
    (a page allocation here)."""
    eng = TE.Engine(
        TCFG, torch_params,
        TE.EngineConfig(**{**EC, "page_size": 16, "max_pages_per_seq": 4}),
        device="cpu",
    )
    uploads = {"n": 0}
    real = eng._upload

    def counting(arr):
        uploads["n"] += 1
        return real(arr)

    eng._upload = counting
    eng.add_request(
        TE.Request(rid="s", prompt=np.arange(1, 5, dtype=np.int32),
                   max_new_tokens=40)
    )
    eng.step()  # admit + prefill (4 uploads) + first chunk (4 uploads)
    after_first = uploads["n"]
    chunks = 0
    while eng.busy:
        eng.step()
        chunks += 1
    # Positions 4..44 cross page boundaries at 16 and 32 only: two
    # re-uploads of the 4-array state, not one per chunk.
    assert chunks >= 10
    assert uploads["n"] - after_first == 2 * 4
    assert len(eng.completed["s"].tokens) == 40


# --- sampling ------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=8, sample_seed=5)


def _jax_run(jax_params, trace=None, **kw):
    return JE.Engine(JCFG, jax_params, JE.EngineConfig(**{**EC, **kw})).run([
        JE.Request(rid=r, prompt=p, max_new_tokens=n)
        for r, p, n in (trace or _trace())
    ])


@pytest.mark.parametrize("kw", [{}] + QUANT_CASES, ids=["f32"] + QUANT_IDS)
def test_sampled_tokens_identical_to_jax_engine(jax_params, torch_params,
                                                kw):
    want = _jax_run(jax_params, **SAMPLED, **kw)
    eng, done = _torch_run(torch_params, **SAMPLED, **kw)
    for rid, _prompt, n in _trace():
        assert len(done[rid].tokens) == n
        assert np.array_equal(done[rid].tokens, want[rid].tokens), rid
    assert eng.ec.sampling() == (0.8, 8)


def test_sampled_fused_matches_unfused_contiguous_oracle(torch_params):
    eng, fused = _torch_run(torch_params, **SAMPLED)
    _, oracle = _torch_run(torch_params, fused=False, contiguous=True,
                           **SAMPLED)
    for rid in fused:
        assert np.array_equal(fused[rid].tokens, oracle[rid].tokens), rid
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1
    assert TP.pages_are_zero(eng.cache, range(1, eng.allocator.num_pages))


def test_sampled_engine_samples_and_the_seed_matters(torch_params):
    _, greedy = _torch_run(torch_params)
    _, s5 = _torch_run(torch_params, **SAMPLED)
    _, s6 = _torch_run(torch_params, **{**SAMPLED, "sample_seed": 6})
    _, s5b = _torch_run(torch_params, **SAMPLED)
    assert any(not np.array_equal(greedy[r].tokens, s5[r].tokens)
               for r in greedy), "sampling degenerated to greedy"
    assert any(not np.array_equal(s5[r].tokens, s6[r].tokens)
               for r in s5), "different seeds gave identical tokens"
    for rid in s5:
        assert np.array_equal(s5[rid].tokens, s5b[rid].tokens), rid


@pytest.mark.parametrize(
    "kw",
    [{"scan_chunk": 1}, {"scan_chunk": 8}, {"prefill_chunk": 2},
     {"prefill_chunk": 16, "prefill_batch": 1}],
    ids=["scan1", "scan8", "prefill2", "prefill16_serial"],
)
def test_sampled_tokens_do_not_depend_on_chunking(torch_params, kw):
    """The key is a function of (seed, serial, position): chunk lengths
    and prefill buckets change the schedule, never the draw."""
    _, base = _torch_run(torch_params, **SAMPLED)
    _, other = _torch_run(torch_params, **SAMPLED, **kw)
    for rid in base:
        assert np.array_equal(base[rid].tokens, other[rid].tokens), rid


def test_pinned_sample_serial_survives_admission_order(torch_params):
    trace = _trace()
    serial = {rid: 40 + i for i, (rid, _, _) in enumerate(trace)}

    def run(order):
        eng = TE.Engine(TCFG, torch_params,
                        TE.EngineConfig(**{**EC, **SAMPLED}), device="cpu")
        return eng.run([
            TE.Request(rid=r, prompt=p, max_new_tokens=n,
                       sample_serial=serial[r], sample_seed=5)
            for r, p, n in order
        ])

    forward, backward = run(trace), run(trace[::-1])
    for rid in forward:
        assert np.array_equal(forward[rid].tokens, backward[rid].tokens), rid
    # Unpinned, the admission serial keys the draw: the order shows.
    _, unpinned = _torch_run(torch_params, trace=trace[::-1], **SAMPLED)
    _, in_order = _torch_run(torch_params, trace=trace, **SAMPLED)
    assert any(not np.array_equal(unpinned[r].tokens, in_order[r].tokens)
               for r in in_order)


def test_pinned_sample_seed_must_match_the_engine(torch_params):
    eng = TE.Engine(TCFG, torch_params, TE.EngineConfig(**{**EC, **SAMPLED}),
                    device="cpu")
    with pytest.raises(ValueError, match="sample_seed"):
        eng.add_request(TE.Request(
            rid="x", prompt=np.ones(3, np.int32), max_new_tokens=2,
            sample_seed=6,
        ))


@pytest.mark.parametrize("kw", [{"temperature": 0.7, "top_k": 3},
                                {"spec_k": 2}],
                         ids=["temperature", "spec_k"])
def test_sampling_and_spec_knobs_construct_and_serve(torch_params, kw):
    """The knobs this engine used to refuse now serve a request."""
    eng, done = _torch_run(torch_params, trace=_trace(n=2), **kw)
    assert len(done) == 2
    assert eng.allocator.free_pages == eng.allocator.num_pages - 1
