"""The port's weight-only int8 matmul held to the JAX op on the CPU.

``torch`` (the twin of ``_xla_int8_matmul``) against JAX's XLA path and
against the Pallas kernel in interpret mode at its tileable shape
(128 x 1024 x 1024, as tests/test_workloads.py runs it), fp32, on the
same numpy-seeded inputs quantized by JAX: atol = rtol = 1e-5. Leading
dims reshape as in JAX; M in {1, 3, 8}. ``reference`` is the fp32
oracle. On CPU tensors ``auto`` is ``torch`` and ``cuda`` raises.
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


@pytest.mark.parametrize("m", [1, 3, 8])
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
