"""The decode attention at the head dims and query-group sizes the card's
kernels take beyond Llama-3-8B's (hd 16-256 in steps of 16, any n_rep),
held to the JAX op on the CPU.

- The port's plain paged walk and contiguous block loop (the kernels'
  plain versions, and the port's path on the CPU) against JAX's ``xla``
  path at fp32, atol 1e-5, on the same numpy-seeded inputs: hd in {16,
  32, 96, 192, 256} x n_rep in {3, 16}, an fp32 cache and an int8 cache
  with f32 scales; at n_rep 16 the kernels' split-and-merge form
  (``split_keys``) too. Lengths: a dead row, 1, a block boundary +1 and
  the capacity.
- One small case a layout against the Pallas kernel in interpret mode,
  at hd 192 (paged) and 256 (contiguous), the head dims past 128 that
  the Pallas kernels take.
- The kernels' shape contract: hd 8, 40 and 272 raise ValueError under
  ``impl="cuda"`` on the CPU, before any device check; hd 16 and 256 at
  n_rep 3 and 32 pass it and reach the device check. The row groups
  and the split plan over groups are pinned.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads.ops import attention as JA  # noqa: E402
from tpu_dra_torch.workloads.ops import attention as TA  # noqa: E402

ATOL = 1e-5
KVH = 2
PAGE = 4
MAX_SEQ = 32
BLOCK_K = 8
# A dead row, one key, a block boundary + 1, the capacity.
LENGTHS = [0, 1, BLOCK_K + 1, MAX_SEQ]
# JAX's xla paths under one jit a shape (the length is traced), so a case
# costs one compile and not one per eager op.
JAX_PAGED = jax.jit(functools.partial(JA.paged_decode_attention, impl="xla"))
JAX_DECODE = jax.jit(functools.partial(JA.decode_attention, impl="xla",
                                       block_k=BLOCK_K))


def _cache(rng, shape, quant):
    """fp32 values, or int8 values and f32 scales over shape[:-1]."""
    if quant:
        return (rng.integers(-127, 128, shape).astype(np.int8),
                rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32))
    return rng.standard_normal(shape).astype(np.float32), None


def _contiguous(seed, hd, n_rep, quant, b=len(LENGTHS)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, KVH * n_rep, hd)).astype(np.float32)
    k, ks = _cache(rng, (b, MAX_SEQ, KVH, hd), quant)
    v, vs = _cache(rng, (b, MAX_SEQ, KVH, hd), quant)
    return q, k, v, ({"k_scale": ks, "v_scale": vs} if quant else {})


def _paged(seed, hd, n_rep, quant, lengths=LENGTHS):
    """Pools of one page more than the rows need, shuffled tables."""
    rng = np.random.default_rng(seed)
    b, per = len(lengths), MAX_SEQ // PAGE
    num_pages = 1 + b * per
    tables = (rng.permutation(num_pages - 1) + 1).reshape(b, per)
    q = rng.standard_normal((b, KVH * n_rep, hd)).astype(np.float32)
    kp, ks = _cache(rng, (num_pages, PAGE, KVH, hd), quant)
    vp, vs = _cache(rng, (num_pages, PAGE, KVH, hd), quant)
    sc = {"k_scale": ks, "v_scale": vs} if quant else {}
    return (q, kp, vp, tables.astype(np.int32),
            np.asarray(lengths, np.int32)), sc


def _to(fn, args, sc):
    return [fn(a) for a in args], {n: fn(a) for n, a in sc.items()}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("n_rep", [3, 16])
@pytest.mark.parametrize("hd", [16, 32, 96, 192, 256])
def test_plain_decode_matches_jax_xla_at_every_head_dim_and_group(
        hd, n_rep, quant):
    seed = hd + n_rep + 7 * quant
    # Paged: every row at once (lengths per row).
    args, sc = _paged(seed, hd, n_rep, quant)
    jargs, jsc = _to(jnp.asarray, args, sc)
    targs, tsc = _to(torch.from_numpy, args, sc)
    want = np.asarray(JAX_PAGED(*jargs, **jsc))
    forms = {"walk": {}}
    if n_rep == 16:
        forms["split"] = {"split_keys": 3 * PAGE}
    for form, kw in forms.items():
        got = TA.paged_decode_attention(*targs, **tsc, impl="torch",
                                        **kw).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=f"paged {form}")
        assert np.all(got[0] == 0.0), "a dead row must be exact 0"
    # Contiguous: one length a call.
    q, k, v, sc = _contiguous(seed + 1, hd, n_rep, quant)
    (jq, jk, jv), jsc = _to(jnp.asarray, (q, k, v), sc)
    (tq, tk, tv), tsc = _to(torch.from_numpy, (q, k, v), sc)
    for length in LENGTHS:
        want = np.asarray(JAX_DECODE(jq, jk, jv, jnp.int32(length), **jsc))
        forms = {"loop": {"block_k": BLOCK_K}}
        if n_rep == 16:
            forms["split"] = {"split_keys": 12}
        for form, kw in forms.items():
            got = TA.decode_attention(tq, tk, tv, length, **tsc,
                                      impl="torch", **kw).numpy()
            np.testing.assert_allclose(
                got, want, atol=ATOL, rtol=0,
                err_msg=f"contiguous {form} at length {length}")
            if length == 0:
                assert np.all(got == 0.0), "length 0 must give exact zeros"


@pytest.mark.parametrize("layout,hd", [("paged", 192), ("contiguous", 256)])
def test_plain_decode_matches_the_pallas_kernel_past_hd_128(
        monkeypatch, layout, hd):
    """The Pallas kernels take every head dim that is a multiple of 64;
    at 192 and 256 (one small case each, interpret mode) the port's
    plain versions hold to them."""
    monkeypatch.setattr(JA, "_INTERPRET", True)
    if layout == "paged":
        args, sc = _paged(hd, hd, 3, False, lengths=[0, 9])
        jargs, _ = _to(jnp.asarray, args, sc)
        want = np.asarray(JA.paged_decode_attention(*jargs, impl="pallas"))
        got = TA.paged_decode_attention(
            *map(torch.from_numpy, args), impl="torch").numpy()
    else:
        q, k, v, _ = _contiguous(hd, hd, 3, False, b=1)
        want = np.asarray(JA.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(13),
            impl="pallas", block_k=MAX_SEQ))
        got = TA.decode_attention(*map(torch.from_numpy, (q, k, v)), 13,
                                  impl="torch").numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _calls(hd, n_rep):
    """The paged and the contiguous call at (hd, n_rep) on CPU tensors."""
    args, _ = _paged(0, hd, n_rep, False, lengths=[3, 9])
    targs = [torch.from_numpy(a) for a in args]
    q, k, v, _ = _contiguous(0, hd, n_rep, False, b=2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    return {
        "paged": lambda: TA.paged_decode_attention(*targs, impl="cuda"),
        "contiguous": lambda: TA.decode_attention(tq, tk, tv, 5,
                                                  impl="cuda"),
    }


@pytest.mark.parametrize("hd", [8, 40, 272])
def test_cuda_impl_refuses_head_dims_outside_the_kernels_on_every_device(hd):
    """Not a multiple of 16, or past 256: ValueError naming the shape,
    raised before the device check (these tensors are on the CPU)."""
    for layout, call in _calls(hd, 2).items():
        with pytest.raises(ValueError, match=f"head dim {hd}"):
            call()
    with pytest.raises(ValueError, match="multiple of 16 from 16 to 256"):
        TA._validate_decode_shapes(torch.zeros(1, 2, hd))


@pytest.mark.parametrize("hd,n_rep", [(16, 3), (16, 32), (256, 3),
                                      (256, 32)])
def test_cuda_impl_takes_the_grid_and_then_needs_the_card(hd, n_rep):
    """hd 16 and 256 at n_rep 3 and 32 pass the shape contract; on CPU
    tensors the next check, the device's, refuses them."""
    TA._validate_decode_shapes(torch.zeros(2, 2 * n_rep, hd))
    for layout, call in _calls(hd, n_rep).items():
        with pytest.raises(ValueError, match="CUDA device"):
            call()


@pytest.mark.parametrize("n_rep,want", [
    (1, (2, 1)), (2, (2, 1)), (3, (4, 1)), (4, (4, 1)), (5, (8, 1)),
    (7, (8, 1)), (8, (8, 1)), (12, (8, 2)), (16, (8, 2)), (32, (8, 4)),
])
def test_decode_row_groups(n_rep, want):
    rows, groups = TA.decode_groups(n_rep)
    assert (rows, groups) == want
    assert rows * groups >= n_rep > rows * (groups - 1)


@pytest.mark.parametrize("b,kvh,n_rep,key_range,want", [
    (8, 8, 4, 512, (8, 64)),     # Llama-3-8B: one group, the plan as before
    (8, 8, 3, 512, (8, 64)),     # Llama-3.2-3B: n_rep 3 in one group of 4
    (8, 1, 32, 512, (8, 64)),    # MQA: 4 groups count as 4 kv heads
    (8, 2, 16, 8192, (32, 256)),
])
def test_split_plan_counts_row_groups(b, kvh, n_rep, key_range, want):
    groups = TA.decode_groups(n_rep)[1]
    assert TA.split_plan(b, kvh * groups, key_range, 132) == want
