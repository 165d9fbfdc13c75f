"""The port's contiguous-cache decode attention held to the JAX op on the
CPU: ``torch`` and ``reference`` against JAX's ``xla`` path, its
``reference`` oracle and the Pallas ``_decode_kernel`` in interpret
mode, at fp32, atol 1e-5, on the same numpy-seeded inputs — fp32 and
int8 caches, lengths 0, 1, block_k, block_k + 1 and max_seq, n_rep 1
and 4 — the split-and-merge form of the CUDA kernel (``split_keys``:
splits of block_k, of a length that is not a multiple of it and of
more than max_seq; lengths 0, 1, a split boundary +-1 and max_seq),
the host split plan, and the ``extra_k``/``extra_v`` update of the
torch path. A
length of 0 gives exact zeros on the online paths (both oracles average
the masked row instead, on both sides).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads.ops import attention as JA  # noqa: E402
from tpu_dra_torch.workloads.ops import attention as TA  # noqa: E402

ATOL = 1e-5
MAX_SEQ = 64
BLOCK_K = 16
LENGTHS = [0, 1, BLOCK_K, BLOCK_K + 1, MAX_SEQ]


def _inputs(seed, n_rep, quant, b=2, kvh=2, hd=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh * n_rep, hd)).astype(np.float32)
    shape = (b, MAX_SEQ, kvh, hd)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)
        return q, k, v, {"k_scale": ks, "v_scale": vs}
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, {}


def _conv(fn, q, k, v, scales):
    return fn(q), fn(k), fn(v), {n: fn(a) for n, a in scales.items()}


@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_decode_attention_matches_jax(monkeypatch, n_rep, quant):
    monkeypatch.setattr(JA, "_INTERPRET", True)
    arrs = _inputs(n_rep + 10 * quant, n_rep, quant)
    jq, jk, jv, jsc = _conv(jnp.asarray, *arrs)
    tq, tk, tv, tsc = _conv(torch.from_numpy, *arrs)
    for length in LENGTHS:
        want = {
            impl: np.asarray(JA.decode_attention(
                jq, jk, jv, jnp.int32(length), **jsc, impl=impl,
                block_k=BLOCK_K,
            ))
            for impl in ("xla", "pallas", "reference")
        }
        got = TA.decode_attention(
            tq, tk, tv, length, **tsc, impl="torch", block_k=BLOCK_K
        ).numpy()
        assert TA._LAST_DECODE_IMPL == "torch"
        ref = TA.decode_attention(tq, tk, tv, length, **tsc,
                                  impl="reference").numpy()
        np.testing.assert_allclose(ref, want["reference"], atol=ATOL, rtol=0)
        for jimpl in ("xla", "pallas"):
            np.testing.assert_allclose(
                got, want[jimpl], atol=ATOL, rtol=0,
                err_msg=f"torch vs {jimpl} at length {length}",
            )
        if length == 0:
            assert np.all(got == 0.0), "length 0 must give exact zeros"
        else:
            np.testing.assert_allclose(got, want["reference"], atol=ATOL,
                                       rtol=0)
            np.testing.assert_allclose(ref, got, atol=ATOL, rtol=0)


@pytest.mark.parametrize("split_keys", [BLOCK_K, 24, 2 * MAX_SEQ],
                         ids=["block", "not_block_multiple", "over_max_seq"])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_decode_attention_split_form_matches_jax(monkeypatch, split_keys,
                                                 n_rep, quant):
    """The kernel's split-and-merge, in plain PyTorch, held to the JAX
    op at lengths 0 (exact zeros), 1, a split boundary -1/0/+1 and
    max_seq."""
    monkeypatch.setattr(JA, "_INTERPRET", True)
    arrs = _inputs(split_keys + n_rep + 10 * quant, n_rep, quant)
    jq, jk, jv, jsc = _conv(jnp.asarray, *arrs)
    tq, tk, tv, tsc = _conv(torch.from_numpy, *arrs)
    lengths = sorted({0, 1, MAX_SEQ} | {
        min(split_keys + d, MAX_SEQ) for d in (-1, 0, 1)})
    for length in lengths:
        got = TA.decode_attention(
            tq, tk, tv, length, **tsc, impl="torch", split_keys=split_keys
        ).numpy()
        impls = ("xla", "pallas") + (("reference",) if length else ())
        for jimpl in impls:
            want = np.asarray(JA.decode_attention(
                jq, jk, jv, jnp.int32(length), **jsc, impl=jimpl,
                block_k=BLOCK_K,
            ))
            np.testing.assert_allclose(
                got, want, atol=ATOL, rtol=0,
                err_msg=f"split {split_keys} vs {jimpl} at length {length}",
            )
        if length == 0:
            assert np.all(got == 0.0), "length 0 must give exact zeros"


@pytest.mark.parametrize("b,kvh,key_range,sms,want", [
    (8, 8, 512, 132, (8, 64)),       # greedy_generate at b=8, 512 live
    (8, 8, 1024, 132, (16, 64)),     # the engine's table: 64 pages of 16
    (1, 8, 8192, 132, (32, 256)),    # one long row: SPLIT_MAX splits
    (8, 8, 0, 132, (1, 64)),         # length 0: one split writes zeros
    (8, 8, 64, 132, (1, 64)),        # a short row: no combine
    (1, 1, 100, 1, (2, 64)),
    (64, 8, 4096, 132, (3, 1376)),   # many rows: few long splits
])
def test_split_plan(b, kvh, key_range, sms, want):
    splits, chunk = TA.split_plan(b, kvh, key_range, sms)
    assert (splits, chunk) == want
    assert splits * chunk >= key_range and (splits - 1) * chunk < max(
        key_range, 1)
    assert chunk % TA.SPLIT_TILE == 0 and chunk >= TA.SPLIT_MIN_KEYS
    assert 1 <= splits <= TA.SPLIT_MAX


def test_split_keys_refusals():
    q, k, v, _ = _inputs(4, 2, False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="split_keys selects"):
        TA.decode_attention(tq, tk, tv, 5, impl="reference", split_keys=8)
    with pytest.raises(ValueError, match="positive int"):
        TA.decode_attention(tq, tk, tv, 5, split_keys=0)
    with pytest.raises(ValueError, match="no extra_k"):
        TA.decode_attention(tq, tk, tv, 5, extra_k=tk[:, 0],
                            extra_v=tv[:, 0], split_keys=8)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_extra_kv_update_matches_jax(quant):
    """The newest token's K/V out of cache (the stacked layout's step):
    one exact online update on the torch path."""
    q, k, v, scales = _inputs(7, 4, quant)
    rng = np.random.default_rng(8)
    ek = rng.standard_normal((2, 2, 64)).astype(np.float32)
    ev = rng.standard_normal((2, 2, 64)).astype(np.float32)
    jq, jk, jv, jsc = _conv(jnp.asarray, q, k, v, scales)
    tq, tk, tv, tsc = _conv(torch.from_numpy, q, k, v, scales)
    for length in (1, BLOCK_K + 1, MAX_SEQ):
        for impl, jimpl in (("torch", "xla"), ("reference", "reference")):
            want = np.asarray(JA.decode_attention(
                jq, jk, jv, jnp.int32(length), **jsc, extra_k=jnp.asarray(ek),
                extra_v=jnp.asarray(ev), impl=jimpl, block_k=BLOCK_K,
            ))
            got = TA.decode_attention(
                tq, tk, tv, length, **tsc, extra_k=torch.from_numpy(ek),
                extra_v=torch.from_numpy(ev), impl=impl, block_k=BLOCK_K,
            ).numpy()
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_dispatch_and_errors():
    q, k, v, _ = _inputs(3, 2, False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    TA.decode_attention(tq, tk, tv, 5)
    assert TA._LAST_DECODE_IMPL == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        TA.decode_attention(tq, tk, tv, 5, impl="cuda")
    with pytest.raises(ValueError, match="extra_k"):
        TA.decode_attention(tq, tk, tv, 5, extra_k=tk[:, 0], extra_v=tv[:, 0],
                            impl="cuda")
    with pytest.raises(ValueError, match="outside the cache"):
        TA.decode_attention(tq, tk, tv, MAX_SEQ + 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        TA.decode_attention(tq[..., :32], tk, tv, 5)
    with pytest.raises(ValueError, match="together"):
        TA.decode_attention(tq, tk, tv, 5, k_scale=tk[..., 0])
    with pytest.raises(ValueError, match="unknown decode attention"):
        TA.decode_attention(tq, tk, tv, 5, impl="bogus")
    assert TA._decode_block_k(64, 256) == 64
    assert TA._decode_block_k(96, 64) == 48
