"""The port's paged_prefill_attention held to JAX's
(tests/test_paged_kv.py test_paged_prefill_attention_matches_causal_reference
and test_paged_multiquery_row_matches_single_sequence_prefill_op): the
same fp32 chunk over the same scattered block table, fp32 or int8
pools, within 1e-5 of JAX's op and 1e-4 of causal attention over the
contiguous prefix; and a batch row of the port's multiquery op within
2e-6 of the one-sequence op."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads.ops import attention as JA  # noqa: E402
from tpu_dra.workloads.quantize import dequantize_kv, quantize_kv  # noqa: E402
from tpu_dra_torch.workloads.ops import attention as TA  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _chunk(quant: bool):
    """tests/test_paged_kv.py's inputs: a 5-query chunk at position 6
    over pages [2, 1, 3] of 4 tokens, 2 kv heads of 64."""
    page, kvh, hd, pos, s = 4, 2, 64, 6, 5
    ks = jax.random.split(jax.random.PRNGKey(3), 3)
    total = pos + s
    k_all = jax.random.normal(ks[0], (1, total, kvh, hd), jnp.float32)
    v_all = jax.random.normal(ks[1], (1, total, kvh, hd), jnp.float32)
    q = jax.random.normal(ks[2], (s, 2 * kvh, hd), jnp.float32)
    num_pages = -(-total // page) + 2
    table = np.array([2, 1, 3], np.int32)  # scattered on purpose
    dtype = jnp.int8 if quant else jnp.float32
    kp = np.zeros((num_pages, page, kvh, hd), dtype)
    vp = np.zeros((num_pages, page, kvh, hd), dtype)
    ksc = vsc = None
    if quant:
        k8, k8s = quantize_kv(k_all)
        v8, v8s = quantize_kv(v_all)
        k_all, v_all = dequantize_kv(k8, k8s), dequantize_kv(v8, v8s)
        k_src, v_src = np.asarray(k8), np.asarray(v8)
        ksc = np.zeros((num_pages, page, kvh), np.float32)
        vsc = np.zeros((num_pages, page, kvh), np.float32)
    else:
        k_src, v_src = np.asarray(k_all), np.asarray(v_all)
    for p in range(total):
        pid, off = table[p // page], p % page
        kp[pid, off], vp[pid, off] = k_src[0, p], v_src[0, p]
        if quant:
            ksc[pid, off] = np.asarray(k8s)[0, p]
            vsc[pid, off] = np.asarray(v8s)[0, p]
    return q, kp, vp, ksc, vsc, table, pos, k_all, v_all


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_paged_prefill_attention_matches_jax(quant):
    q, kp, vp, ksc, vsc, table, pos, k_all, v_all = _chunk(quant)
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    want = JA.paged_prefill_attention(
        q, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.int32(pos), k_scale=j(ksc), v_scale=j(vsc))
    t = lambda x: None if x is None else _t(x)  # noqa: E731
    got = TA.paged_prefill_attention(
        _t(q), _t(kp), _t(vp), _t(table), pos, k_scale=t(ksc),
        v_scale=t(vsc))
    assert got.dtype == torch.float32 and got.shape == tuple(q.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    ref = TA.reference_attention(_t(q)[None], _t(k_all), _t(v_all),
                                 causal=True)[0]
    assert float((got - ref).abs().max()) < 1e-4
    # pos as a 0-dim tensor, as the JAX op takes a traced scalar.
    again = TA.paged_prefill_attention(
        _t(q), _t(kp), _t(vp), _t(table), torch.tensor(pos, dtype=torch.int32),
        k_scale=t(ksc), v_scale=t(vsc))
    assert torch.equal(again, got)


def test_paged_multiquery_row_matches_single_sequence_prefill_op():
    rng = np.random.default_rng(11)
    num_pages, page, kvh, hd, b, s = 13, 4, 2, 64, 3, 3
    kp = _t(rng.standard_normal((num_pages, page, kvh, hd), np.float32))
    vp = _t(rng.standard_normal((num_pages, page, kvh, hd), np.float32))
    tables = _t(rng.permutation(np.arange(1, num_pages))[:12]
                .reshape(b, 4).astype(np.int32))
    q = _t(rng.standard_normal((b, s, 2 * kvh, hd), np.float32))
    pos = torch.tensor([1, 4, 7], dtype=torch.int32)
    batched = TA.paged_multiquery_attention(q, kp, vp, tables, pos)
    for i in range(b):
        single = TA.paged_prefill_attention(q[i], kp, vp, tables[i], pos[i])
        assert float((batched[i] - single).abs().max()) <= 2e-6, i


def test_paged_prefill_attention_validates_shapes():
    q = torch.zeros(3, 4, 64)
    kp = torch.zeros(5, 4, 2, 64)
    table = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape mismatch"):
        TA.paged_prefill_attention(q, kp, torch.zeros(5, 4, 2, 32), table, 0)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        TA.paged_prefill_attention(torch.zeros(3, 3, 64), kp, kp, table, 0)
    with pytest.raises(ValueError, match="together"):
        TA.paged_prefill_attention(q, kp, kp, table, 0,
                                   k_scale=torch.zeros(5, 4, 2))
    with pytest.raises(ValueError, match="max_pages"):
        TA.paged_prefill_attention(q, kp, kp, table[None], 0)
