"""The port's flash attention held to the JAX package's on the CPU: the
plain versions of the three kernels through the port's
autograd.Function against JAX ``_flash_attention`` /
``flash_attention_with_lse`` running its Pallas kernels in interpret
mode (as tests/test_flash_attention.py runs them). Inputs are fp32 from
numpy seeds; tolerances are JAX's own: outputs and lse 1e-5, gradients
5e-4 (sums taken in other block orders)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads.ops import attention as JA  # noqa: E402
from tpu_dra_torch.workloads.ops import attention as TA  # noqa: E402

# The backward node of the port's flash autograd.Function: a tensor with
# it as grad_fn came through the flash path (not the reference oracle).
FLASH_NODE = "_FlashAttentionWithLseBackward"


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(JA, "_INTERPRET", True)


def _inputs(seed, b, sq, skv, h, kvh, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd), dtype=np.float32)
    k = rng.standard_normal((b, skv, kvh, hd), dtype=np.float32)
    v = rng.standard_normal((b, skv, kvh, hd), dtype=np.float32)
    g = rng.standard_normal((b, sq, h, hd), dtype=np.float32)
    g_lse = rng.standard_normal((b, h, sq), dtype=np.float32)
    return q, k, v, g, g_lse


def _torch_grads(q, k, v, g, g_lse, causal):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out, lse = TA.flash_attention_with_lse(tq, tk, tv, causal)
    assert type(out.grad_fn).__name__ == FLASH_NODE
    loss = (out * torch.from_numpy(g)).sum()
    if g_lse is not None:
        loss = loss + (lse * torch.from_numpy(g_lse)).sum()
    loss.backward()
    return out.detach().numpy(), lse.detach().numpy(), [
        t.grad.numpy() for t in (tq, tk, tv)
    ]


CASES = [
    # b, sq, skv, h, kvh, hd, causal, block_q, block_k, with g_lse
    (2, 128, 128, 4, 4, 64, True, 64, 64, False),
    (2, 128, 128, 4, 4, 64, False, 64, 64, True),
    (1, 256, 256, 8, 2, 64, True, 64, 64, True),  # GQA
    (2, 128, 128, 4, 1, 128, True, 64, 64, False),  # MQA, head dim 128
    (1, 128, 128, 4, 2, 64, True, 32, 64, True),  # block_q != block_k
    (1, 64, 256, 4, 4, 64, True, 64, 64, False),  # suffix queries
]


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,bq,bk,with_lse", CASES)
def test_flash_twin_fwd_lse_and_grads(b, sq, skv, h, kvh, hd, causal, bq, bk,
                                      with_lse):
    q, k, v, g, g_lse = _inputs(sq + h + hd, b, sq, skv, h, kvh, hd)
    g_lse = g_lse if with_lse else None
    with jax.default_matmul_precision("highest"):
        (j_out, j_lse), vjp = jax.vjp(
            lambda q, k, v: JA.flash_attention_with_lse(q, k, v, causal, bq, bk),
            *(jnp.asarray(a) for a in (q, k, v)),
        )
        j_grads = vjp((jnp.asarray(g), jnp.asarray(
            g_lse if with_lse else np.zeros((b, h, sq), np.float32))))
    out, lse, grads = _torch_grads(q, k, v, g, g_lse, causal)
    np.testing.assert_allclose(out, np.asarray(j_out), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lse, np.asarray(j_lse), atol=1e-5, rtol=1e-5)
    for got, want, name in zip(grads, j_grads, "qkv"):
        np.testing.assert_allclose(
            got, np.asarray(want), atol=5e-4, rtol=5e-4, err_msg=f"d{name}"
        )


def test_plain_kernels_and_attention_dispatch_match_jax():
    """Each plain version at its own boundary against the JAX kernels'
    wrappers, and ``attention`` (auto on the CPU, out only) against JAX
    ``attention(impl="pallas")`` and the reference oracles."""
    b, s, h, kvh, hd = 1, 128, 4, 2, 64
    q, k, v, g, _ = _inputs(7, b, s, s, h, kvh, hd)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    with jax.default_matmul_precision("highest"):
        jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
        j_out, j_lse = JA._flash_attention_fwd_impl(jq, jk, jv, True, 64, 64)
        j_dq, j_dk, j_dv = JA._flash_attention_bwd_impl(
            jq, jk, jv, j_out, j_lse, jg, True, 64, 64
        )
        j_att = JA.attention(jq, jk, jv, True, "pallas", 64, 64)
        j_ref = JA.reference_attention(jq, jk, jv, True)
        j_ref_out, j_ref_lse = JA.reference_attention_with_lse(jq, jk, jv, True)
    out, lse = TA._torch_flash_fwd(tq, tk, tv, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(j_lse).reshape(b, h, s), atol=1e-5
    )
    delta = (tg * out).sum(-1).transpose(1, 2).contiguous()
    dq = TA._torch_flash_bwd_dq(tq, tk, tv, tg, lse, delta, True)
    dk, dv = TA._torch_flash_bwd_dkv(tq, tk, tv, tg, lse, delta, True)
    for got, want, name in ((dq, j_dq, "dq"), (dk, j_dk, "dk"), (dv, j_dv, "dv")):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), atol=5e-4, rtol=5e-4, err_msg=name
        )
    att = TA.attention(tq.clone().requires_grad_(), tk, tv, causal=True,
                       impl="auto")
    assert type(att.grad_fn).__name__ == FLASH_NODE
    np.testing.assert_allclose(att.detach().numpy(), np.asarray(j_att),
                               atol=1e-5)
    np.testing.assert_allclose(
        TA.attention(tq, tk, tv, True, impl="reference").numpy(),
        np.asarray(j_ref), atol=1e-5,
    )
    r_out, r_lse = TA.reference_attention_with_lse(tq, tk, tv, True)
    np.testing.assert_allclose(r_out.numpy(), np.asarray(j_ref_out), atol=1e-5)
    np.testing.assert_allclose(r_lse.numpy(), np.asarray(j_ref_lse), atol=1e-5)


def test_flash_shape_contract_raises_on_every_device():
    """Shapes the kernels do not take raise on the CPU too (the same
    predicate as on the card: no quiet fallback); ragged lengths and
    hd 16 are in the contract."""
    def qkv(s, h, kvh, hd, skv=None):
        return (torch.zeros(1, s, h, hd), torch.zeros(1, skv or s, kvh, hd),
                torch.zeros(1, skv or s, kvh, hd))

    for bad in (qkv(8, 4, 2, 256), qkv(8, 4, 2, 24), qkv(8, 3, 2, 64),
                qkv(16, 4, 2, 64, skv=8)):
        with pytest.raises(ValueError):
            TA.attention(*bad, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        TA.attention(*qkv(8, 4, 2, 64), causal=True, impl="cuda")
    with pytest.raises(ValueError, match="unknown"):
        TA.attention(*qkv(8, 4, 2, 64), impl="pallas")
    out = TA.attention(*qkv(13, 4, 2, 16), causal=True)
    assert out.shape == (1, 13, 4, 16) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.float32, 128, "wmma"), (torch.float32, 64, "wmma"),
    (torch.bfloat16, 48, "wmma"), (torch.bfloat16, 16, "wmma"),
])
def test_forward_kernel_route_follows_dtype_and_head_dim(dtype, hd, route):
    """On the card the forward's kernel is chosen from dtype and head dim
    alone: the wgmma kernel for bf16 at hd 64/128, the WMMA kernel
    otherwise (fp32 keeps its bits on CUDA cores)."""
    assert TA._flash_fwd_route(torch.zeros(1, 3, 2, hd, dtype=dtype)) == route


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.float32, 128, "wmma"), (torch.float32, 64, "wmma"),
    (torch.bfloat16, 48, "wmma"), (torch.bfloat16, 16, "wmma"),
])
def test_dkv_kernel_route_follows_dtype_and_head_dim(dtype, hd, route):
    """The dK/dV kernel is chosen the same way: the wgmma kernel
    (flash_bwd_sm90.cu) for bf16 at hd 64/128, the WMMA kernel
    otherwise."""
    q = torch.zeros(1, 3, 2, hd, dtype=dtype)
    assert TA._flash_bwd_dkv_route(q) == route


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "sm90"), (torch.bfloat16, 128, "sm90"),
    (torch.float32, 128, "wmma"), (torch.float32, 64, "wmma"),
    (torch.bfloat16, 48, "wmma"), (torch.bfloat16, 16, "wmma"),
])
def test_dq_kernel_route_follows_dtype_and_head_dim(dtype, hd, route):
    """The dQ kernel is chosen the same way: the wgmma kernel
    (flash_bwd_dq_sm90.cu) for bf16 at hd 64/128, the WMMA kernel
    otherwise."""
    q = torch.zeros(1, 3, 2, hd, dtype=dtype)
    assert TA._flash_bwd_dq_route(q) == route
