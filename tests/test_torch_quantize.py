"""The port's int8 quantization held to the JAX one on the CPU, bit for
bit: ``quantize_weight``, ``quantize_params`` (2D leaves, scan-stacked
3D leaves, a zero column, the error on a kernel node with a bias) and
``quantize_kv`` (an all-zero row gets scale 0) give the same int8 values
and the same f32 scales on the same numpy arrays. A tree quantized by
JAX and converted with ``params_from_numpy`` equals the port's own
quantization of the converted fp32 tree.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads import quantize as JQ  # noqa: E402
from tpu_dra.workloads.models import llama as JL  # noqa: E402
from tpu_dra_torch.workloads import quantize as TQ  # noqa: E402
from tpu_dra_torch.workloads.convert import params_from_numpy  # noqa: E402
from tpu_dra_torch.workloads.models import llama as TL  # noqa: E402


def _same(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    assert tuple(t.shape) == j.shape
    assert str(t.dtype).split(".")[-1] == j.dtype.name
    np.testing.assert_array_equal(t.numpy(), j)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("shape", [(64, 96), (17, 300), (256, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_weight_bit_identical(shape, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * rng.uniform(0.001, 3.0)).astype(
        np.float32
    )
    w[:, shape[1] // 2] = 0.0  # an all-zero column: scale 1, zeros
    # Column 0 has scale exactly 1: 2.5 and 3.5 sit on .5 steps and
    # round half to even.
    w[:3, 0] = [127.0, 2.5, 3.5]
    w[3:, 0] = 1.0
    want = JQ.quantize_weight(jnp.asarray(w))
    got = TQ.quantize_weight(torch.from_numpy(w))
    _same(got["kernel_q"], want["kernel_q"])
    _same(got["scale"], want["scale"])
    assert got["kernel_q"][:3, 0].tolist() == [127, 2, 4]
    assert float(got["scale"][0, shape[1] // 2]) == 1.0
    _same(TQ.dequantize_weight(got), JQ.dequantize_weight(want))
    with pytest.raises(ValueError, match="2D"):
        TQ.quantize_weight(torch.zeros(3, 4, 5))


def test_quantize_weight_bf16_input_bit_identical():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((48, 80)).astype(np.float32)
    jw = jnp.asarray(w, dtype=jnp.bfloat16)
    tw = torch.from_numpy(np.asarray(jw).astype(np.float32)).to(torch.bfloat16)
    want = JQ.quantize_weight(jw)
    got = TQ.quantize_weight(tw)
    _same(got["kernel_q"], want["kernel_q"])
    _same(got["scale"], want["scale"])


def test_quantize_params_2d_3d_and_bias_error():
    rng = np.random.default_rng(3)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {
        "embed": {"embedding": arr(16, 8)},
        "layer_0": {"mlp": {"w_up": {"kernel": arr(8, 12)}},
                    "norm": {"scale": arr(8)}},
        "layers": {"block": {"wq": {"kernel": arr(3, 8, 6)}}},
    }
    tree["layers"]["block"]["wq"]["kernel"][1, :, 2] = 0.0
    want = _flat(JQ.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = _flat(TQ.quantize_params(
        jax.tree_util.tree_map(torch.from_numpy, tree)
    ))
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k])
    assert got["layers/block/wq/scale"].shape == (3, 1, 6)
    bad = {"proj": {"kernel": torch.zeros(4, 4), "bias": torch.zeros(4)}}
    with pytest.raises(ValueError, match="unquantizable kernel node at proj"):
        TQ.quantize_params(bad)
    with pytest.raises(ValueError, match="unquantizable"):
        JQ.quantize_params(
            {"proj": {"kernel": jnp.zeros((4, 4)), "bias": jnp.zeros(4)}}
        )
    with pytest.raises(ValueError, match="unquantizable"):
        TQ.quantize_params({"proj": {"kernel": torch.zeros(4)}})


@pytest.mark.parametrize("shape", [(3, 5, 2, 64), (7, 4, 128)])
def test_quantize_kv_bit_identical_and_zero_row_scale_zero(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 4.0).astype(np.float32)
    x[0, 1] = 0.0  # all-zero rows: scale 0, not 1
    jq, js = JQ.quantize_kv(jnp.asarray(x))
    tq, ts = TQ.quantize_kv(torch.from_numpy(x))
    _same(tq, jq)
    _same(ts, js)
    assert torch.all(ts[0, 1] == 0) and torch.all(tq[0, 1] == 0)
    _same(TQ.dequantize_kv(tq, ts), JQ.dequantize_kv(jq, js))


def test_converted_jax_quantized_tree_equals_port_quantization():
    """JAX quantize_params -> params_from_numpy == params_from_numpy of
    the fp32 tree -> the port's quantize_params, bit for bit, in both
    layouts."""
    for scan in (True, False):
        jcfg = dataclasses.replace(
            JL.TINY_LLAMA, dtype=jnp.float32, param_dtype=jnp.float32,
            scan_layers=scan,
        )
        tcfg = dataclasses.replace(
            TL.TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32
        )
        params = JL.Llama(jcfg).init_params(
            jax.random.PRNGKey(4), batch=1, seq=4
        )
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        from_jax = _flat(params_from_numpy(
            to_np(JQ.quantize_params(params)), tcfg, device="cpu"
        ).tree())
        ported = _flat(TQ.quantize_params(params_from_numpy(
            to_np(params), tcfg, device="cpu"
        ).tree()))
        assert sorted(from_jax) == sorted(ported)
        assert any(k.endswith("kernel_q") for k in ported)
        for k in ported:
            assert from_jax[k].dtype == ported[k].dtype, k
            assert torch.equal(from_jax[k], ported[k]), k
        assert from_jax["lm_head/kernel_q"].dtype == torch.int8
        assert from_jax["lm_head/scale"].dtype == torch.float32
