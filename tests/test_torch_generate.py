"""The port's fixed-batch decode path held to the JAX one on the CPU.

TINY_LLAMA at fp32 with the same weights (the flax tree converted
in-process). The port takes only the unrolled layout, so JAX gets the
unrolled tree too (``scan_layers=False``): with an int8 cache the JAX
stacked layout feeds the newest token unquantized, the unrolled one
quantizes it first, and the port matches the unrolled one. For each of
the four (kv_quant, weight_quant) combinations:

- ``forward_chunk`` prefill logits, and the s=1 step after it, within
  1e-4 of JAX's, with the cache written the same way;
- ``greedy_generate`` tokens identical to JAX's.

Within the port: the paged ``Engine`` and ``greedy_generate`` agree on
>= 0.99 of a lone request's tokens (the twin of
tests/test_engine.py::test_engine_matches_fixed_batch_greedy_generate).

Sampling: ``sample_generate`` draws the same tokens as JAX's for the
kwargs of tests/test_workloads.py::test_fused_sampler_parity (int8 KV
included), equals the port's ``sample_generate_unfused``, and its
degenerate modes (top_k=1, temperature 0, temperature 1e-4) are greedy.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads import generate as JG  # noqa: E402
from tpu_dra.workloads.models import llama as JL  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402
from tpu_dra_torch.workloads import generate as TG  # noqa: E402
from tpu_dra_torch.workloads import sampling as TS  # noqa: E402
from tpu_dra_torch.workloads.convert import params_from_numpy  # noqa: E402
from tpu_dra_torch.workloads.models import llama as TL  # noqa: E402
from tpu_dra_torch.workloads.ops import attention as TA  # noqa: E402

JCFG = dataclasses.replace(
    JL.TINY_LLAMA, dtype=jnp.float32, param_dtype=jnp.float32,
    scan_layers=False,
)
TCFG = dataclasses.replace(
    TL.TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32
)
COMBOS = [("none", "none"), ("int8", "none"), ("none", "int8"),
          ("int8", "int8")]
IDS = ["bf", "kv8", "w8", "w8kv8"]


@pytest.fixture(scope="module")
def jax_params():
    return JL.Llama(JCFG).init_params(jax.random.PRNGKey(21), batch=2, seq=8)


@pytest.fixture(scope="module")
def torch_params(jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    return params_from_numpy(tree, TCFG, device="cpu")


def _prompt(b=2, s=11, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(1, JCFG.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("kv_quant,weight_quant", COMBOS, ids=IDS)
def test_forward_chunk_matches_jax(jax_params, torch_params, kv_quant,
                                   weight_quant):
    prompt = _prompt()
    jp = JG._maybe_quantize_params(jax_params, weight_quant)
    jcache = JG.init_cache(JCFG, 2, 32, stacked=False, kv_quant=kv_quant)
    jcache, jlogits = JG.forward_chunk(JCFG, jp, jcache, jnp.asarray(prompt))
    tp = TG._maybe_quantize_params(torch_params.tree(), weight_quant)
    tcache = TG.init_cache(TCFG, 2, 32, kv_quant=kv_quant, device="cpu")
    tlogits = TG.forward_chunk(TCFG, tp, tcache, torch.from_numpy(prompt))
    assert tcache.pos == int(jcache.pos) == prompt.shape[1]
    np.testing.assert_allclose(
        tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0
    )
    for layer in range(TCFG.n_layers):
        np.testing.assert_allclose(
            tcache.k[layer].float().numpy(),
            np.asarray(jcache.k[layer]).astype(np.float32),
            atol=1e-5 if kv_quant == "none" else 0, rtol=0,
        )
    assert tcache.tail_is_zero() and bool(jcache.tail_is_zero())
    # One s=1 step on top: decode_attention over the written cache.
    nxt = np.argmax(np.asarray(jlogits)[:, -1], axis=-1).astype(np.int32)
    jcache, jstep = JG.forward_chunk(
        JCFG, jp, jcache, jnp.asarray(nxt)[:, None]
    )
    tstep = TG.forward_chunk(
        TCFG, tp, tcache, torch.from_numpy(nxt)[:, None]
    )
    assert TA._LAST_DECODE_IMPL == "torch"
    np.testing.assert_allclose(
        tstep.numpy(), np.asarray(jstep), atol=1e-4, rtol=0
    )


@pytest.mark.parametrize("kv_quant,weight_quant", COMBOS, ids=IDS)
def test_greedy_tokens_identical_to_jax(jax_params, torch_params, kv_quant,
                                        weight_quant):
    prompt = _prompt(b=3, s=9, seed=6)
    want = np.asarray(JG.greedy_generate(
        JCFG, jax_params, jnp.asarray(prompt), max_new_tokens=12,
        kv_quant=kv_quant, weight_quant=weight_quant,
    ))
    got = TG.greedy_generate(
        TCFG, torch_params, prompt, max_new_tokens=12, kv_quant=kv_quant,
        weight_quant=weight_quant, device="cpu",
    )
    assert got.device.type == "cpu" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_matches_fixed_batch_greedy_generate(torch_params):
    prompt = np.arange(1, 11, dtype=np.int32)
    new = 12
    eng = TE.Engine(
        TCFG, torch_params,
        TE.EngineConfig(page_size=4, max_slots=3, max_pages_per_seq=10,
                        scan_chunk=3, prefill_chunk=8),
        device="cpu",
    )
    done = eng.run([TE.Request(rid="solo", prompt=prompt, max_new_tokens=new)])
    want = TG.greedy_generate(
        TCFG, torch_params, prompt[None], max_new_tokens=new, device="cpu"
    )[0, len(prompt):].numpy()
    agree = float(np.mean(done["solo"].tokens == want))
    assert agree >= 0.99, f"engine vs greedy_generate agreement {agree}"


def test_cache_helpers_and_errors(torch_params):
    cache = TG.init_cache(TCFG, 2, 16, kv_quant="int8", device="cpu")
    assert cache.quantized and cache.k[0].dtype == torch.int8
    assert tuple(cache.k_scale[0].shape) == (2, 16, TCFG.n_kv_heads)
    TG.forward_chunk(TCFG, torch_params.tree(), cache,
                     torch.from_numpy(_prompt(s=6)))
    assert cache.pos == 6 and cache.tail_is_zero()
    assert float(cache.k_scale[0][:, :6].abs().sum()) > 0
    cache.pos = 3  # a rewind leaves stale rows behind pos...
    assert not cache.tail_is_zero()
    assert cache.zero_tail() is cache and cache.tail_is_zero()  # ...wiped
    with pytest.raises(ValueError, match="cache full"):
        TG.forward_chunk(TCFG, torch_params.tree(), cache,
                         torch.ones((2, 14), dtype=torch.int32))
    with pytest.raises(ValueError, match="kv_quant"):
        TG.init_cache(TCFG, 1, 8, kv_quant="int4", device="cpu")
    with pytest.raises(ValueError, match="weight_quant"):
        TG.greedy_generate(TCFG, torch_params, _prompt(), 2,
                           weight_quant="fp8", device="cpu")
    with pytest.raises(ValueError, match="too small"):
        TG.greedy_generate(TCFG, torch_params, _prompt(), 8, max_seq=12,
                           device="cpu")
    with pytest.raises(ValueError, match="unrolled"):
        TG.forward_chunk(TCFG, {"layers": {}}, cache,
                         torch.ones((2, 1), dtype=torch.int32))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_stacked_layout_int8_divergence_and_port_follows_unrolled(kv_quant):
    """A stacked tree: the port unrolls it, so its decode step matches
    JAX's unrolled layout. JAX's own stacked layout feeds the newest
    token's K/V to the step unquantized, so with an int8 cache the two
    JAX layouts differ beyond 1e-4 in the first step's logits, and
    agree within 1e-5 without it."""
    jcfg = dataclasses.replace(JCFG, scan_layers=True)
    stacked = JL.Llama(jcfg).init_params(jax.random.PRNGKey(21), batch=2,
                                         seq=8)
    unrolled = JG.unroll_params(stacked)
    tp = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, stacked), TCFG, device="cpu"
    ).tree()
    prompt = _prompt(b=3, s=9, seed=6)
    step = np.array([[5], [7], [9]], np.int32)

    def jax_step(params, stacked_layout):
        cache = JG.init_cache(jcfg, 3, 32, stacked=stacked_layout,
                              kv_quant=kv_quant)
        cache, _ = JG.forward_chunk(jcfg, params, cache, jnp.asarray(prompt))
        return np.asarray(
            JG.forward_chunk(jcfg, params, cache, jnp.asarray(step))[1]
        )

    want_stacked = jax_step(stacked, True)
    want_unrolled = jax_step(unrolled, False)
    cache = TG.init_cache(TCFG, 3, 32, kv_quant=kv_quant, device="cpu")
    TG.forward_chunk(TCFG, tp, cache, torch.from_numpy(prompt))
    got = TG.forward_chunk(TCFG, tp, cache, torch.from_numpy(step)).numpy()
    np.testing.assert_allclose(got, want_unrolled, atol=1e-4, rtol=0)
    layouts_gap = float(np.abs(want_stacked - want_unrolled).max())
    if kv_quant == "int8":
        assert layouts_gap > 1e-4, layouts_gap
    else:
        assert layouts_gap <= 1e-5, layouts_gap


SAMPLE_KWARGS = [
    {"temperature": 0.8, "top_k": 8},
    {"temperature": 1.3, "top_k": 3},
    {"temperature": 1.0, "top_k": 0},
    {"temperature": 0.8, "top_k": 8, "kv_quant": "int8"},
]
SAMPLE_IDS = ["t0.8_k8", "t1.3_k3", "t1.0_full", "t0.8_k8_kv8"]


def _sample_prompt():
    """tests/test_workloads.py's prompt: two rows of 0..5."""
    return np.tile(np.arange(6, dtype=np.int32)[None], (2, 1))


@pytest.mark.parametrize("kw", SAMPLE_KWARGS, ids=SAMPLE_IDS)
def test_sample_generate_tokens_identical_to_jax(jax_params, torch_params,
                                                 kw):
    rng = jax.random.PRNGKey(42)
    prompt = _sample_prompt()
    want = np.asarray(JG.sample_generate(
        JCFG, jax_params, jnp.asarray(prompt), max_new_tokens=6, rng=rng,
        **kw))
    got = TG.sample_generate(
        TCFG, torch_params, prompt, 6,
        rng=np.asarray(jax.random.key_data(rng)), device="cpu", **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw", SAMPLE_KWARGS, ids=SAMPLE_IDS)
def test_sample_generate_fused_matches_unfused(torch_params, kw):
    key = TS.prng_key(42)
    prompt = _prompt(b=3, s=7, seed=9)
    fused = TG.sample_generate(TCFG, torch_params, prompt, 10, rng=key,
                               device="cpu", **kw)
    unfused = TG.sample_generate_unfused(TCFG, torch_params, prompt, 10,
                                         rng=key, device="cpu", **kw)
    assert torch.equal(fused, unfused)
    assert torch.equal(fused[:, :7], torch.from_numpy(prompt))


def test_sample_generate_modes(torch_params):
    """top_k=1 and temperature 0 are greedy_generate; a temperature of
    1e-4 collapses onto the argmax; a warm draw stays in the vocab and
    leaves the prompt alone; the seed matters."""
    prompt = _sample_prompt()
    key = TS.prng_key(42)
    greedy = TG.greedy_generate(TCFG, torch_params, prompt, 6, device="cpu")
    for kw in ({"top_k": 1}, {"temperature": 0.0}, {"temperature": 1e-4}):
        for fn in (TG.sample_generate, TG.sample_generate_unfused):
            out = fn(TCFG, torch_params, prompt, 6, rng=key, device="cpu",
                     **kw)
            assert torch.equal(out, greedy), (fn.__name__, kw)
    hot = TG.sample_generate(TCFG, torch_params, prompt, 6, rng=key,
                             temperature=1.0, top_k=8, device="cpu")
    other = TG.sample_generate(TCFG, torch_params, prompt, 6,
                               rng=TS.prng_key(43), temperature=1.0,
                               top_k=8, device="cpu")
    assert hot.shape == (2, 12) and torch.equal(hot[:, :6], greedy[:, :6])
    assert int(hot.min()) >= 0 and int(hot.max()) < TCFG.vocab_size
    assert not torch.equal(hot, other)
    with pytest.raises(ValueError, match="top_k"):
        TG.sample_generate(TCFG, torch_params, prompt, 2, rng=key,
                           top_k=TCFG.vocab_size + 1, device="cpu")
    with pytest.raises(ValueError, match="2 words"):
        TG.sample_generate(TCFG, torch_params, prompt, 2, rng=[1, 2, 3],
                           device="cpu")
