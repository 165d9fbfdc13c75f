"""The port's sampler held to jax.random and the JAX sampler on the CPU.

``tpu_dra_torch/workloads/sampling.py`` reproduces the bits of
``jax.random`` (Threefry-2x32, partitionable): key data of fold_in
chains, ``random_bits`` and ``uniform`` are bit-identical to JAX's. The
Gumbel noise goes through two logs, where ``torch.log`` and XLA's may
differ by an ulp each: it is held within 2 ulps of max(|g|, 1) (the
scale at which it meets a score; measured max 2 over 1M draws).
``topk_exact`` is ``lax.top_k`` (values and indices, ties to the lower
index). ``sample_token`` and the engine's ``_pick_tokens`` /
``_pick_tokens_batched`` draw the same tokens as JAX's jitted functions
over seeded logits for top_k in {0, 1, 3, 8, 40}. The kernel wrapper's
plain path and its refusals are checked here; the kernel itself on the
card (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra.workloads import generate as JG  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402
from tpu_dra_torch.workloads import generate as TG  # noqa: E402
from tpu_dra_torch.workloads import sampling as S  # noqa: E402
from tpu_dra_torch.workloads.ops import sample as OS  # noqa: E402

SEEDS = [0, 1, 5, 2**31 - 1]
DATA = [0, 1, 17, 2**32 - 1]
TOPKS = [0, 1, 3, 8, 40]
F32_TINY = float(np.finfo(np.float32).tiny)


def _jkey(seed, *folds):
    key = jax.random.PRNGKey(seed)
    for d in folds:
        key = jax.random.fold_in(key, d)
    return key


def _tkey(seed, *folds):
    key = S.prng_key(seed)
    for d in folds:
        key = S.fold_in(key, d)
    return key


def _key_data(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", DATA)
def test_fold_in_chain_key_data_matches_jax(seed, data):
    assert np.array_equal(_key_data(jax.random.PRNGKey(seed)),
                          S.prng_key(seed).numpy())
    for chain in ((data,), (data, 3), (7, data, data)):
        assert np.array_equal(
            _key_data(_jkey(seed, *chain)), _tkey(seed, *chain).numpy()
        ), chain


def test_batched_fold_in_matches_per_key_fold_in():
    keys = torch.stack([_tkey(5, s) for s in range(4)])  # [4, 2]
    data = torch.tensor([0, 9, 2**31, 2**32 - 1])
    got = S.fold_in(keys, data)
    for i in range(4):
        want = _key_data(_jkey(5, i, int(data[i])))
        assert np.array_equal(got[i].numpy(), want)


def test_threefry_takes_python_ints():
    words = S.threefry2x32(11, 22, 0, 33)
    tens = S.threefry2x32(*(torch.tensor(v) for v in (11, 22, 0, 33)))
    assert words == tuple(int(t) for t in tens)


@pytest.mark.parametrize("shape", [(7,), (7, 33), (3, 4, 5), (2, 1000)])
def test_random_bits_and_uniform_bit_identical(shape):
    jk, tk = _jkey(5, 3, 17), _tkey(5, 3, 17)
    jb = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    assert np.array_equal(jb, S.random_bits(tk, shape).numpy())
    ju = np.asarray(jax.random.uniform(jk, shape, minval=F32_TINY,
                                       maxval=1.0))
    tu = S.uniform(tk, shape).numpy()
    assert tu.dtype == np.float32
    assert np.array_equal(ju.view(np.int32), tu.view(np.int32))
    ju = np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0))
    tu = S.uniform(tk, shape, minval=-2.0, maxval=3.0).numpy()
    assert np.array_equal(ju.view(np.int32), tu.view(np.int32))


@pytest.mark.parametrize("seed", [0, 9])
def test_gumbel_within_two_ulps_of_its_scale(seed):
    jg = np.asarray(jax.random.gumbel(_jkey(seed, 1), (20, 4096)))
    tg = S.gumbel(_tkey(seed, 1), (20, 4096)).numpy()
    scale = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    err = np.abs(jg.astype(np.float64) - tg) / scale
    assert err.max() <= 2.0, err.max()
    # Most draws agree to the bit: only the logs differ.
    assert np.mean(jg == tg) > 0.5


@pytest.mark.parametrize("temperature", [0.8, 1.3, 1e-4])
def test_full_vocab_perturbed_scores_are_jits_fma(temperature):
    """A whole-row draw: jitted XLA fuses ``noise + logits /
    temperature`` into one FMA with the f32 reciprocal; the port's
    ``perturbed_scores`` gives the same bits for the same noise, where
    the unfused sum differs in about a quarter of the elements."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 50000)) * 3).astype(np.float32)
    g = rng.gumbel(size=(4, 50000)).astype(np.float32)
    want = np.asarray(jax.jit(lambda l, n: n + l / temperature)(x, g))
    got = S.perturbed_scores(torch.from_numpy(x),
                             OS.inv_temperature(temperature),
                             torch.from_numpy(g)).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_fma_f32_rounds_once():
    rng = np.random.default_rng(3)
    bits = rng.integers(0x30000000, 0x50000000, (2, 200000))
    a, c = bits.astype(np.int32).view(np.float32)
    c = c * np.where(rng.random(200000) < 0.5, -1, 1).astype(np.float32)
    want = np.asarray(jax.jit(lambda u, w: u * np.float32(1.25) + w)(a, c))
    got = S.fma_f32(torch.from_numpy(a), 1.25, torch.from_numpy(c)).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))


def test_categorical_matches_jax():
    rng = np.random.default_rng(0)
    for seed in range(10):
        logits = (rng.standard_normal((6, 300)) * 2).astype(np.float32)
        jc = np.asarray(jax.random.categorical(
            _jkey(seed), jnp.asarray(logits), axis=-1))
        tc = S.categorical(_tkey(seed), torch.from_numpy(logits)).numpy()
        assert np.array_equal(jc, tc), seed


def _topk_rows():
    rng = np.random.default_rng(1)
    normal = rng.standard_normal((8, 1024)).astype(np.float32)
    two_stage = rng.standard_normal((4, 8 * 1024)).astype(np.float32)
    narrow = rng.standard_normal((3, 100)).astype(np.float32)
    bf16 = torch.from_numpy(
        rng.standard_normal((8, 2048)).astype(np.float32)
    ).to(torch.bfloat16).float().numpy()
    return {
        "8x1024": normal, "4x8192_two_stage": two_stage, "3x100": narrow,
        "zeros": np.zeros((2, 2048), np.float32), "bf16_ties": bf16,
    }


@pytest.mark.parametrize("name", list(_topk_rows()))
@pytest.mark.parametrize("k", [1, 5, 40, 64])
def test_topk_exact_matches_lax_top_k(name, k):
    x = _topk_rows()[name]
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    jv2, ji2 = JG.topk_exact(jnp.asarray(x), k)
    tv, ti = TG.topk_exact(torch.from_numpy(x), k)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(ji2), ti.numpy())


def _logits(rng, b, vocab, ties=False):
    x = (rng.standard_normal((b, vocab)) * 3).astype(np.float32)
    if ties:  # bf16-rounded: equal values at the top of a row
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


@pytest.mark.parametrize("top_k", TOPKS)
@pytest.mark.parametrize("temperature", [0.8, 1.3])
def test_sample_token_identical_to_jax(top_k, temperature):
    """60 draws of [4, vocab] blocks (240 tokens) per case, half of them
    on bf16-rounded logits; JAX jitted (its engine and scan path)."""
    rng = np.random.default_rng(top_k * 10 + int(temperature * 10))
    jfn = jax.jit(functools.partial(
        JG.sample_token, temperature=temperature, top_k=top_k))
    for trial in range(60):
        x = _logits(rng, 4, (64, 257, 1024)[trial % 3], ties=trial % 2)
        key = _jkey(trial, 3)
        want = np.asarray(jfn(jnp.asarray(x), key))
        got = TG.sample_token(torch.from_numpy(x), _key_data(key),
                              temperature, top_k)
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy()), trial
        # The fold inside the pick equals folding the key first.
        folded = TG.sample_token(
            torch.from_numpy(x), _key_data(_jkey(trial)), temperature,
            top_k, fold=3)
        assert torch.equal(folded, got)


@pytest.mark.parametrize("top_k", TOPKS)
def test_engine_pick_tokens_identical_to_jax(top_k):
    """The engine's per-slot keys fold(fold(PRNGKey(seed), serial),
    position): 50 steps x 5 slots (250 tokens) per case."""
    sampling = (0.8, top_k)
    rng = np.random.default_rng(100 + top_k)
    jfn = jax.jit(functools.partial(JE._pick_tokens, sampling),
                  static_argnums=(3,))
    for trial in range(50):
        x = _logits(rng, 5, 256, ties=trial % 2)
        seeds = rng.integers(0, 50, 5).astype(np.int32)
        pos = rng.integers(0, 4000, 5).astype(np.int32)
        sample_seed = int(rng.integers(0, 2**31 - 1))
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(seeds),
                              jnp.asarray(pos), jnp.int32,
                              jnp.int32(sample_seed)))
        got = TE._pick_tokens(
            sampling, torch.from_numpy(x), torch.from_numpy(seeds),
            torch.from_numpy(pos), torch.int32,
            torch.tensor(sample_seed, dtype=torch.int32),
        )
        assert np.array_equal(want, got.numpy()), trial


@pytest.mark.parametrize("top_k", TOPKS)
def test_engine_pick_tokens_batched_identical_to_jax(top_k):
    """The verify pass's picks over [B, S] positions: 20 blocks of
    3 x 5 (300 tokens) per case; every position's pick equals the
    single-step pick at that position."""
    sampling = (1.1, top_k)
    rng = np.random.default_rng(200 + top_k)
    jfn = jax.jit(functools.partial(JE._pick_tokens_batched, sampling),
                  static_argnums=(3,))
    for trial in range(20):
        x = _logits(rng, 15, 256, ties=trial % 2).reshape(3, 5, 256)
        seeds = rng.integers(0, 50, 3).astype(np.int32)
        pos = (rng.integers(0, 4000, 3)[:, None]
               + np.arange(5)[None]).astype(np.int32)
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(seeds),
                              jnp.asarray(pos), jnp.int32, jnp.int32(7)))
        seed_t = torch.tensor(7, dtype=torch.int32)
        got = TE._pick_tokens_batched(
            sampling, torch.from_numpy(x), torch.from_numpy(seeds),
            torch.from_numpy(pos), torch.int32, seed_t,
        )
        assert np.array_equal(want, got.numpy()), trial
        one = TE._pick_tokens(
            sampling, torch.from_numpy(x[:, 2]), torch.from_numpy(seeds),
            torch.from_numpy(pos[:, 2]), torch.int32, seed_t,
        )
        assert torch.equal(one, got[:, 2])


def test_greedy_pick_tokens_is_argmax():
    x = torch.from_numpy(_logits(np.random.default_rng(3), 4, 256, True))
    got = TE._pick_tokens(None, x, None, None, torch.int32, None)
    assert torch.equal(got, torch.argmax(x, -1).to(torch.int32))


def test_sample_pick_candidates_are_topk_exact():
    x = torch.from_numpy(_logits(np.random.default_rng(4), 6, 500, True))
    ids, vals, idx = OS.sample_pick(
        x, 0.7, 12, key=S.prng_key(3), fold=2, candidates=True)
    want_v, want_i = OS.topk_exact(x * OS.inv_temperature(0.7), 12)
    assert torch.equal(vals, want_v) and torch.equal(idx, want_i.int())
    assert all(int(ids[r]) in idx[r].tolist() for r in range(6))


def test_inv_temperature_is_the_f32_reciprocal():
    for t in (0.8, 1.3, 1e-4, 2.0):
        inv = OS.inv_temperature(t)
        assert np.float32(inv) == np.float32(1) / np.float32(t)
        x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
        jitted = np.asarray(jax.jit(lambda a: a / t)(jnp.asarray(x)))
        assert np.array_equal(jitted, (torch.from_numpy(x) * inv).numpy())


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(), "needs key"),
        (dict(key=torch.zeros(2, dtype=torch.int64),
              seed=torch.tensor(0, dtype=torch.int32)), "not both"),
        (dict(key=torch.zeros(3, dtype=torch.int64)), "2 words"),
        (dict(seed=torch.tensor(0, dtype=torch.int32),
              serials=torch.zeros(2, dtype=torch.int32),
              positions=torch.zeros(3, dtype=torch.int32)), "rows layout"),
    ],
    ids=["no_key", "both_layouts", "bad_key", "rows_mismatch"],
)
def test_sample_pick_refuses_bad_layouts(kw, match):
    with pytest.raises(ValueError, match=match):
        OS.sample_pick(torch.zeros(3, 10), 1.0, 2, **kw)


def test_sample_pick_refuses_bad_arguments():
    key = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="temperature"):
        OS.sample_pick(torch.zeros(2, 10), 0.0, 2, key=key)
    with pytest.raises(ValueError, match="top_k"):
        OS.sample_pick(torch.zeros(2, 10), 1.0, 11, key=key)
    with pytest.raises(ValueError, match="CUDA"):
        OS.sample_pick(torch.zeros(2, 10), 1.0, 2, key=key, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        OS.sample_pick(torch.zeros(2, 10), 1.0, 2, key=key, impl="nope")
