"""The port's weight-only int8 matmul held to the JAX op on the CPU.

``torch`` (the twin of ``_xla_int8_matmul``) against JAX's XLA path and
against the Pallas kernel in interpret mode at its tileable shape
(128 x 1024 x 1024, as tests/test_workloads.py runs it), fp32, on the
same numpy-seeded inputs quantized by JAX: atol = rtol = 1e-5. Leading
dims reshape as in JAX; M in {1, 3, 8} (decode) and {24, 130}
(prefill-like). ``reference`` is the fp32 oracle. On CPU tensors
``auto`` is ``torch`` and ``cuda`` raises. The kernel route
(``_int8mm_route``) and the wgmma tile's rows (``_sm90_rows``) are
chosen from shapes, dtype and alignment alone, so they are tested here.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads.ops import int8mm as JI  # noqa: E402
from tpu_dra.workloads.quantize import quantize_weight  # noqa: E402
from tpu_dra_torch.workloads.ops import int8mm as TI  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, m, k, n, lead=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(((m,) if lead is None else lead) + (k,))
    w = rng.standard_normal((k, n)) * 0.05
    q = quantize_weight(jnp.asarray(w.astype(np.float32)))
    return (
        x.astype(np.float32), np.array(q["kernel_q"]), np.array(q["scale"])
    )


def _port(x, w_q, scale, impl):
    return TI.int8_matmul(
        torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale),
        impl=impl,
    ).numpy()


@pytest.mark.parametrize("m", [1, 3, 8, 24, 130])
def test_torch_matches_jax_xla(m):
    x, w_q, scale = _inputs(m, m, 96, 160)
    want = np.asarray(JI._xla_int8_matmul(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale)
    ))
    got = _port(x, w_q, scale, "torch")
    assert TI._LAST_INT8MM_IMPL == "torch"
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(_port(x, w_q, scale, "reference"), want, **TOL)


def test_torch_matches_pallas_interpret(monkeypatch):
    monkeypatch.setattr(JI, "_INTERPRET", True)
    x, w_q, scale = _inputs(0, 128, 1024, 1024)
    want = np.asarray(JI.int8_matmul(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale)
    ))
    np.testing.assert_allclose(_port(x, w_q, scale, "torch"), want, **TOL)


def test_leading_dims_reshape_like_jax():
    x, w_q, scale = _inputs(1, None, 64, 48, lead=(2, 3))
    want = np.asarray(JI.int8_matmul(
        jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale)
    ))
    got = _port(x, w_q, scale, "auto")
    assert got.shape == (2, 3, 48) and TI._LAST_INT8MM_IMPL == "torch"
    np.testing.assert_allclose(got, want, **TOL)


def test_cuda_refuses_cpu_tensors_and_bad_shapes():
    x, w_q, scale = _inputs(2, 4, 32, 16)
    tx, tw, ts = map(torch.from_numpy, (x, w_q, scale))
    with pytest.raises(ValueError, match="CUDA"):
        TI.int8_matmul(tx, tw, ts, impl="cuda")
    with pytest.raises(ValueError, match="shapes"):
        TI.int8_matmul(tx[:, :31], tw, ts)
    with pytest.raises(ValueError, match="unknown int8"):
        TI.int8_matmul(tx, tw, ts, impl="bogus")


def _aligned(shape, dtype, offset=0):
    """A contiguous tensor whose data starts ``offset`` elements past a
    64-byte-aligned allocation."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + offset + 64, dtype=dtype)
    skip = (-buf.data_ptr() % 64) // buf.element_size()
    return buf[skip + offset: skip + offset + n].view(shape)


@pytest.mark.parametrize("m,k,n,dtype,x_off,w_off,route", [
    (1, 64, 128, torch.bfloat16, 0, 0, "gemv"),
    (16, 64, 128, torch.bfloat16, 0, 0, "gemv"),
    (16, 64, 128, torch.float32, 0, 0, "gemv"),
    (17, 64, 128, torch.bfloat16, 0, 0, "sm90"),
    (1024, 4096, 14336, torch.bfloat16, 0, 0, "sm90"),
    (17, 136, 144, torch.bfloat16, 0, 0, "sm90"),
    (17, 130, 128, torch.bfloat16, 0, 0, "wmma"),
    (17, 64, 300, torch.bfloat16, 0, 0, "wmma"),
    (17, 64, 136, torch.bfloat16, 0, 0, "wmma"),
    (17, 64, 128, torch.bfloat16, 1, 0, "wmma"),
    (17, 64, 128, torch.bfloat16, 0, 8, "wmma"),
    (17, 64, 128, torch.float32, 0, 0, "sgemm"),
    (1024, 130, 300, torch.float32, 0, 0, "sgemm"),
], ids=["m1", "m16", "m16_fp32", "m17", "prefill", "ragged_aligned",
        "k130", "n300", "n136", "x_unaligned", "w_unaligned", "m17_fp32",
        "fp32_unaligned"])
def test_int8mm_route(m, k, n, dtype, x_off, w_off, route):
    """gemv for M <= 16; sgemm for fp32 above; sm90 for bf16 with K % 8
    == 0, N % 16 == 0 and x, w_q 16-byte aligned; wmma for the rest."""
    x = _aligned((m, k), dtype, x_off)
    w_q = _aligned((k, n), torch.int8, w_off)
    assert TI._int8mm_route(x, w_q) == route


@pytest.mark.parametrize("m,n,rows", [
    (1024, 14336, 256), (2048, 128256, 256), (1024, 4096, 256),
    (256, 14336, 256), (512, 4096, 128), (1024, 1024, 128),
    (2048, 1024, 128), (128, 14336, 128), (17, 4096, 128),
])
def test_sm90_rows_follow_the_grid(monkeypatch, m, n, rows):
    """256-row tiles once their grid fills half of 132 SMs, else 128."""
    monkeypatch.setattr(TI, "_sm_count", lambda device: 132)
    assert TI._sm90_rows(m, n, None) == rows
