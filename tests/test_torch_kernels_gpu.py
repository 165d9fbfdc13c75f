"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and nvcc: they carry the
``gpu`` marker and skip elsewhere (the check happens inside a fixture,
so every pytest worker collects the same tests). On the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py sets up JAX, which the card's
machine does not have; these tests import no JAX.)

Tolerances: at fp32 the kernels repeat the plain versions' arithmetic
in another summation order, so they agree to 1e-5; at bf16 both are
held to the fp32 reference at rtol 2e-2 plus, per row (one head of one
slot, one token of the MLP), an atol of two bf16 ulps of that row's
largest |reference|: the kernel rounds p and act where the Pallas
kernel does, the plain chain rounds every intermediate, and an output
near zero that is a difference of two O(1) sums carries the absolute
error of those sums. A row of zeros must come out exactly zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_dra_torch import kernels
from tpu_dra_torch.workloads.ops import attention as TA
from tpu_dra_torch.workloads.ops import decode_mlp as TDM

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_bf16_close(got, ref, rtol=2e-2):
    """Every element within two bf16 ulps of its row's largest |ref|
    plus rtol * |ref| — the bar chip_smoke.py holds the kernels to."""
    got, ref = got.float(), ref.float()
    top = ref.abs().amax(dim=-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    atol = torch.where(top > 0, 2 * ulp, torch.zeros_like(top))
    bad = (got - ref).abs() > atol + rtol * ref.abs()
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements outside the per-row bf16 bar; max "
        f"|err| {float((got - ref).abs().max())}"
    )


def _paged(seed, b, page, kvh, n_rep, hd, lengths, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    max_pages = max(1, -(-max(lengths) // page))
    num_pages = 1 + b * max_pages
    perm = torch.randperm(num_pages - 1, generator=g) + 1
    tables = perm.reshape(b, max_pages).to(torch.int32)
    q = torch.randn(b, kvh * n_rep, hd, generator=g)
    kp = torch.randn(num_pages, page, kvh, hd, generator=g)
    vp = torch.randn(num_pages, page, kvh, hd, generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(device=device, dtype=dtype) if t.is_floating_point()
            else t.to(device) for t in (q, kp, vp, tables, lens)]


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("page", [1, 4, 16, 48])
def test_paged_decode_kernel_fp32_matches_plain(cuda_device, hd, n_rep, page):
    lengths = [0, 1, page, page + 1, 3 * page - 1, 77, 255, 512, 1000]
    args = _paged(hd + n_rep + page, len(lengths), page, 2, n_rep, hd,
                  lengths,
                  torch.float32, cuda_device)
    got = TA.paged_decode_attention(*args, impl="cuda")
    want = TA.paged_decode_attention(*args, impl="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.all(got[0] == 0)


def test_paged_decode_kernel_bf16_8b_shape(cuda_device):
    lengths = [0, 1, 15, 16, 17, 255, 512, 1000]
    args = _paged(0, 8, 16, 8, 4, 128, lengths, torch.bfloat16, cuda_device)
    got = TA.paged_decode_attention(*args, impl="cuda").float()
    ref = TA.paged_decode_attention(*args, impl="reference").float()
    plain = TA.paged_decode_attention(*args, impl="torch").float()
    _assert_bf16_close(got, ref)
    _assert_bf16_close(plain, ref)
    _assert_bf16_close(got, plain)
    assert torch.all(got[0] == 0)


def _mlp(seed, b, d, ffn, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, d, generator=g)
    scale = 1 + 0.1 * torch.randn(d, generator=g)
    tree = {
        "w_gate": {"kernel": 0.02 * torch.randn(d, ffn, generator=g)},
        "w_up": {"kernel": 0.02 * torch.randn(d, ffn, generator=g)},
        "w_down": {"kernel": 0.02 * torch.randn(ffn, d, generator=g)},
    }
    conv = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    return conv(x), conv(scale), {
        k: {"kernel": conv(v["kernel"])} for k, v in tree.items()
    }


@pytest.mark.parametrize(
    "b,d,ffn",
    [(1, 64, 128), (3, 256, 512), (8, 130, 300), (13, 96, 77), (64, 64, 96)],
)
def test_decode_mlp_kernel_fp32_matches_plain(cuda_device, b, d, ffn):
    x, scale, tree = _mlp(b + d, b, d, ffn, torch.float32, cuda_device)
    got = TDM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
    want = TDM.decode_mlp(x, scale, tree, 1e-5, impl="reference")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b", [1, 8])
def test_decode_mlp_kernel_bf16_8b_shape(cuda_device, b):
    x, scale, tree = _mlp(b, b, 4096, 14336, torch.bfloat16, cuda_device)
    got = TDM.decode_mlp(x, scale, tree, 1e-5, impl="cuda").float()
    ref = TDM.decode_mlp(x, scale, tree, 1e-5, impl="reference").float()
    plain = TDM.decode_mlp(x, scale, tree, 1e-5, impl="torch").float()
    _assert_bf16_close(got, ref)
    _assert_bf16_close(plain, ref)
    _assert_bf16_close(got, plain)
    again = TDM.decode_mlp(x, scale, tree, 1e-5, impl="cuda").float()
    assert torch.equal(got, again), "reruns must give identical bits"


def test_launch_counters_count_launches(cuda_device):
    kernels.reset_launches()
    args = _paged(1, 2, 4, 2, 2, 64, [3, 9], torch.float32, cuda_device)
    TA.paged_decode_attention(*args)  # auto -> cuda for CUDA tensors
    assert TA._LAST_PAGED_IMPL == "cuda"
    TA.paged_decode_attention(*args, impl="torch")
    x, scale, tree = _mlp(2, 2, 64, 128, torch.float32, cuda_device)
    TDM.decode_mlp(x, scale, tree, 1e-5)
    TDM.decode_mlp(x, scale, tree, 1e-5)
    assert TDM._LAST_DECODE_MLP_IMPL == "cuda"
    assert kernels.LAUNCHES == {
        "paged_decode_attention": 1, "decode_mlp": 2,
    }


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    q, kp, vp, tables, lens = _paged(
        3, 2, 4, 2, 2, 64, [3, 9], torch.float32, cuda_device
    )
    with pytest.raises(ValueError, match="head_dim"):
        TA.paged_decode_attention(
            q[..., :32].contiguous(), kp[..., :32].contiguous(),
            vp[..., :32].contiguous(), tables, lens, impl="cuda",
        )
    with pytest.raises(ValueError, match="int32"):
        TA.paged_decode_attention(q, kp, vp, tables.long(), lens, impl="cuda")
    with pytest.raises(NotImplementedError, match="int8"):
        TA.paged_decode_attention(
            q, kp, vp, tables, lens, k_scale=kp[..., 0], v_scale=kp[..., 0],
            impl="cuda",
        )
    # A length past the block table poisons only its own slot.
    over = TA.paged_decode_attention(
        q, kp, vp, tables, torch.tensor([3, 13], dtype=torch.int32,
                                        device=cuda_device), impl="cuda",
    )
    assert torch.isfinite(over[0]).all() and torch.isnan(over[1]).all()
    x, scale, tree = _mlp(4, 65, 64, 96, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="B <= 64"):
        TDM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
    with pytest.raises(ValueError, match="dtype"):
        TDM.decode_mlp(x[:4].half(), scale, tree, 1e-5, impl="cuda")


def test_tiny_engine_on_the_card_matches_the_cpu_engine(cuda_device):
    """fp32 TINY_LLAMA: the card's engine (both kernels) gives the CPU
    engine's greedy tokens."""
    from tpu_dra_torch.workloads.engine import Engine, EngineConfig, Request
    from tpu_dra_torch.workloads.models.llama import TINY_LLAMA, init_params

    cfg = dataclasses.replace(
        TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32,
        n_heads=4, n_kv_heads=2, dim=256,
    )
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    trace = [
        (f"r{i}", rng.integers(1, 256, rng.integers(3, 30)).astype(np.int32),
         int(rng.integers(4, 12)))
        for i in range(5)
    ]
    ec = EngineConfig(page_size=4, max_slots=3, max_pages_per_seq=12,
                      scan_chunk=3, prefill_chunk=8)
    out = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launches()
        eng = Engine(cfg, params, ec, device=dev)
        out[dev] = eng.run([
            Request(rid=r, prompt=p, max_new_tokens=n) for r, p, n in trace
        ])
        if dev == "cuda":
            assert kernels.LAUNCHES["paged_decode_attention"] == (
                cfg.n_layers * eng.decode_steps
            )
            assert kernels.LAUNCHES["decode_mlp"] == cfg.n_layers * (
                eng.decode_steps + eng.prefill_single_token_buckets
            )
    agree = np.mean([
        np.mean(out["cpu"][r].tokens == out["cuda"][r].tokens)
        for r, _, _ in trace
    ])
    assert agree >= 0.97, agree
