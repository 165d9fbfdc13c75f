"""The port's Llama pieces held to the JAX ones on the CPU: rotary
embeddings, RMS norm, the weight converter (both JAX layouts, and bf16
through float32 bit-exactly), the parameter tree's names, and the
decoder-layer halves ``_project_qkv`` / ``_finish_block`` for s = 1
(the fused decode MLP) and s > 1."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads import generate as JG  # noqa: E402
from tpu_dra.workloads.models import llama as JL  # noqa: E402
from tpu_dra_torch.workloads import generate as TG  # noqa: E402
from tpu_dra_torch.workloads.convert import (  # noqa: E402
    params_from_numpy,
    unroll_tree,
)
from tpu_dra_torch.workloads.models import llama as TL  # noqa: E402

JCFG = dataclasses.replace(
    JL.TINY_LLAMA, dtype=jnp.float32, param_dtype=jnp.float32
)
TCFG = dataclasses.replace(
    TL.TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32
)
ATOL = 1e-5


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def stacked():
    return JL.Llama(JCFG).init_params(jax.random.PRNGKey(3), batch=1, seq=4)


def test_config_fields_and_presets_mirror_jax():
    jf = [f.name for f in dataclasses.fields(JL.LlamaConfig)]
    tf = [f.name for f in dataclasses.fields(TL.LlamaConfig)]
    assert jf == tf
    for name in ("LLAMA3_8B", "TINY_LLAMA"):
        jc, tc = getattr(JL, name), getattr(TL, name)
        for f in jf:
            if f in ("dtype", "param_dtype"):
                assert str(getattr(tc, f)).split(".")[-1] == jnp.dtype(
                    getattr(jc, f)
                ).name
            else:
                assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert tc.head_dim == jc.head_dim
        assert TL.num_params(tc) == JL.num_params(jc)


@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_rope_frequencies_and_apply_rope_twin(shape):
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4000, shape).astype(np.int32)
    jcos, jsin = JL.rope_frequencies(JCFG, jnp.asarray(pos))
    tcos, tsin = TL.rope_frequencies(TCFG, torch.from_numpy(pos))
    # Angles reach ~4000 rad: fp32 cos/sin of large arguments differ by
    # argument-reduction ulps between libraries.
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=2e-4)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=2e-4)
    b, s = (1,) + shape if len(shape) == 1 else shape
    x = rng.standard_normal((b, s, 4, TCFG.head_dim)).astype(np.float32)
    # Same tables on both sides: apply_rope itself must agree to ulps.
    cos = np.array(jcos)
    sin = np.array(jsin)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = TL.apply_rope(
        torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert got.dtype == torch.float32


def test_rms_twin():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 64)).astype(np.float32)
    s = rng.standard_normal((64,)).astype(np.float32)
    want = JG._rms(jnp.asarray(x), jnp.asarray(s), 1e-5)
    got = TG._rms(torch.from_numpy(x), torch.from_numpy(s), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_converter_stacked_and_unrolled_give_the_same_tree(stacked):
    from_stacked = params_from_numpy(
        _np_tree(stacked), TCFG, device="cpu"
    ).tree()
    unrolled = _np_tree(JG.unroll_params(stacked))
    from_unrolled = params_from_numpy(unrolled, TCFG, device="cpu").tree()
    fs, fu = _flat(from_stacked), _flat(from_unrolled)
    assert sorted(fs) == sorted(fu) == sorted(_flat(unrolled))
    for k in fs:
        assert torch.equal(fs[k], fu[k]), k
        np.testing.assert_array_equal(fs[k].numpy(), _flat(unrolled)[k])
    # state_dict keys are the flax paths joined by dots.
    module = params_from_numpy(unrolled, TCFG, device="cpu")
    assert sorted(module.state_dict()) == sorted(
        k.replace("/", ".") for k in fs
    )


def test_converter_bf16_is_bit_exact():
    cfg = dataclasses.replace(JL.TINY_LLAMA, scan_layers=False)
    params = JL.Llama(cfg).init_params(jax.random.PRNGKey(5), batch=1, seq=4)
    tree = _np_tree(params)
    conv = _flat(
        params_from_numpy(tree, TL.TINY_LLAMA, device="cpu").tree()
    )
    for k, arr in _flat(jax.tree_util.tree_map(np.asarray, tree)).items():
        assert arr.dtype.name == "bfloat16"
        t = conv[k]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t.to(torch.float32).numpy(), arr.astype(np.float32)
        )


def test_init_params_names_shapes_and_statistics():
    jtree = _flat(_np_tree(JG.unroll_params(
        JL.Llama(JCFG).init_params(jax.random.PRNGKey(0), batch=1, seq=4)
    )))
    p1 = TL.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    p2 = TL.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    t1, t2 = _flat(p1.tree()), _flat(p2.tree())
    assert sorted(t1) == sorted(jtree)
    for k, arr in jtree.items():
        assert tuple(t1[k].shape) == arr.shape, k
        assert torch.equal(t1[k], t2[k]), k  # a seed fixes the weights
        if k.endswith("scale"):
            assert torch.all(t1[k] == 1.0), k
        else:
            assert abs(float(t1[k].std()) - 0.02) < 0.004, k
    big = TL.init_params(
        dataclasses.replace(TCFG, param_dtype=torch.bfloat16),
        torch.Generator().manual_seed(0),
    )
    assert big.tree()["lm_head"]["kernel"].dtype == torch.bfloat16


@pytest.fixture(scope="module")
def layer_params(stacked):
    jp = JG.unroll_params(stacked)
    tp = params_from_numpy(_np_tree(stacked), TCFG, device="cpu").tree()
    return jp["layer_1"], tp["layer_1"]


@pytest.mark.parametrize("s", [1, 5])
def test_project_qkv_and_finish_block_twins(layer_params, s):
    jlp, tlp = layer_params
    b = 3
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, TCFG.dim)).astype(np.float32)
    pos = (rng.integers(0, 50, (b, 1)) + np.arange(s)[None]).astype(np.int32)
    jcos, jsin = JL.rope_frequencies(JCFG, jnp.asarray(pos))
    cos, sin = np.array(jcos), np.array(jsin)
    jq, jk, jv = JG._project_qkv(
        JCFG, jlp, jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), b, s
    )
    tq, tk, tv = TG._project_qkv(
        TCFG, tlp, torch.from_numpy(x), torch.from_numpy(cos),
        torch.from_numpy(sin), b, s,
    )
    for j, t in ((jq, tq), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    att = rng.standard_normal(
        (b, s, TCFG.n_heads, TCFG.head_dim)
    ).astype(np.float32)
    want = JG._finish_block(JCFG, jlp, jnp.asarray(x), jnp.asarray(att), b, s)
    got = TG._finish_block(
        TCFG, tlp, torch.from_numpy(x), torch.from_numpy(att), b, s
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_unroll_tree_is_identity_on_unrolled():
    tree = {"layer_0": {"a": np.zeros(2)}, "embed": {"embedding": np.ones(3)}}
    assert unroll_tree(tree) is tree
