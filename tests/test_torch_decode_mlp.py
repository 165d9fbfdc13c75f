"""The port's fused decode MLP held to the JAX op on the CPU.

``torch`` (the twin of ``_xla_decode_mlp``) and ``reference`` (the twin
of the fp32 oracle) against JAX's xla, reference and Pallas-interpret
paths at d=256, ffn=512, B=4, fp32, on the same numpy-seeded inputs.
The bar is the one tests/test_workloads.py holds the Pallas kernel to:
relative error below 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads.ops import attention as JA  # noqa: E402
from tpu_dra.workloads.ops import decode_mlp as JDM  # noqa: E402
from tpu_dra_torch.workloads.ops import decode_mlp as TDM  # noqa: E402
from tpu_dra_torch.workloads.quantize import quantize_params  # noqa: E402

EPS = 1e-5
REL = 1e-5


def _inputs(seed, b=4, d=256, f=512):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d)).astype(np.float32)
    scale = rng.standard_normal((d,)).astype(np.float32)
    ws = {
        "w_gate": rng.standard_normal((d, f)).astype(np.float32),
        "w_up": rng.standard_normal((d, f)).astype(np.float32),
        "w_down": rng.standard_normal((f, d)).astype(np.float32),
    }
    return x, scale, ws


def _tree(ws, conv):
    return {k: {"kernel": conv(v)} for k, v in ws.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_mlp_matches_jax(monkeypatch, seed):
    monkeypatch.setattr(JA, "_INTERPRET", True)
    x, scale, ws = _inputs(seed)
    jx, js, jt = jnp.asarray(x), jnp.asarray(scale), _tree(ws, jnp.asarray)
    want = {
        "xla": JDM.decode_mlp(jx, js, jt, EPS, impl="xla"),
        "reference": JDM.decode_mlp(jx, js, jt, EPS, impl="reference"),
        "pallas": JDM.decode_mlp(jx, js, jt, EPS, impl="pallas", block_f=128),
    }
    tx, ts, tt = (
        torch.from_numpy(x), torch.from_numpy(scale),
        _tree(ws, torch.from_numpy),
    )
    for impl in ("torch", "reference"):
        got = TDM.decode_mlp(tx, ts, tt, EPS, impl=impl).numpy()
        assert TDM._LAST_DECODE_MLP_IMPL == impl
        for jimpl, ref in want.items():
            ref = np.asarray(ref)
            rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
            assert rel < REL, f"{impl} vs {jimpl}: rel err {rel}"


def test_decode_mlp_dispatch_and_errors():
    x, scale, ws = _inputs(3, b=2, d=64, f=96)
    tx, ts, tt = (
        torch.from_numpy(x), torch.from_numpy(scale),
        _tree(ws, torch.from_numpy),
    )
    TDM._LAST_DECODE_MLP_IMPL = None
    out = TDM.decode_mlp(tx, ts, tt, EPS)
    assert TDM._LAST_DECODE_MLP_IMPL == "torch"
    assert out.shape == tx.shape and out.dtype == tx.dtype
    with pytest.raises(ValueError, match="CUDA"):
        TDM.decode_mlp(tx, ts, tt, EPS, impl="cuda")
    with pytest.raises(ValueError, match="unknown decode mlp"):
        TDM.decode_mlp(tx, ts, tt, EPS, impl="bogus")
    with pytest.raises(ValueError, match=r"\[b, d\]"):
        TDM.decode_mlp(tx[None], ts, tt, EPS)
    # An int8 weight-only tree takes the plain chain (three int8
    # matmuls) under "auto"; the fused kernel refuses it.
    int8_tree = quantize_params(tt)
    got = TDM.decode_mlp(tx, ts, int8_tree, EPS)
    assert TDM._LAST_DECODE_MLP_IMPL == "torch"
    ref = TDM.decode_mlp(tx, ts, int8_tree, EPS, impl="reference")
    rel = float((got - ref).abs().max() / ref.abs().max())
    assert rel < REL, rel
    with pytest.raises(ValueError, match="plain 2D"):
        TDM.decode_mlp(tx, ts, int8_tree, EPS, impl="cuda")


def test_decode_mlp_bf16_torch_rounds_like_the_op_chain():
    """At bf16 the torch path still agrees with the fp32 oracle at the
    tolerance the card's kernel check uses (2e-2)."""
    x, scale, ws = _inputs(4, b=3, d=128, f=256)
    bf = torch.bfloat16
    tx = torch.from_numpy(x).to(bf)
    ts = torch.from_numpy(scale).to(bf)
    tt = _tree(ws, lambda a: (torch.from_numpy(a) * 0.05).to(bf))
    got = TDM.decode_mlp(tx, ts, tt, EPS, impl="torch").float()
    ref = TDM.decode_mlp(tx, ts, tt, EPS, impl="reference").float()
    assert got.dtype == torch.float32 and ref.shape == got.shape
    assert float((got - ref).abs().max()) <= 2e-2 * (1 + float(ref.abs().max()))
