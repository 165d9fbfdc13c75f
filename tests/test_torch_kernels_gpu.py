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
import functools

import numpy as np
import pytest
import torch

from tpu_dra_torch import kernels
from tpu_dra_torch.workloads.ops import attention as TA
from tpu_dra_torch.workloads.ops import decode_mlp as TDM
from tpu_dra_torch.workloads.ops import int8mm as TI
from tpu_dra_torch.workloads.ops import sample as TSP
from tpu_dra_torch.workloads.quantize import quantize_kv, quantize_weight

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_bf16_close(got, ref, rtol=2e-2, atol_floor=0.0):
    """Every element within two bf16 ulps of its row's largest |ref|
    plus rtol * |ref| — the bar chip_smoke.py holds the kernels to; a
    gradient's atol is never below ``atol_floor``, a number or a tensor
    like ``ref`` (chip_smoke.py bf16_row_atol says why)."""
    got, ref = got.float(), ref.float()
    top = ref.abs().amax(dim=-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    atol = torch.where(top > 0, 2 * ulp, torch.zeros_like(top))
    atol = torch.clamp(atol, min=atol_floor)
    bad = (got - ref).abs() > atol + rtol * ref.abs()
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements outside the per-row bf16 bar; max "
        f"|err| {float((got - ref).abs().max())}"
    )


def _paged(seed, b, page, kvh, n_rep, hd, lengths, dtype, device,
           int8=False):
    """(q, k_pages, v_pages, tables, lengths) plus, with ``int8``, the
    pools quantized per (token, kv head) and their scale pools."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    max_pages = max(1, -(-max(lengths) // page))
    num_pages = 1 + b * max_pages
    perm = torch.randperm(num_pages - 1, generator=g) + 1
    tables = perm.reshape(b, max_pages).to(torch.int32)
    q = torch.randn(b, kvh * n_rep, hd, generator=g)
    kp = torch.randn(num_pages, page, kvh, hd, generator=g)
    vp = torch.randn(num_pages, page, kvh, hd, generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32)
    args = [q.to(device=device, dtype=dtype)]
    if int8:
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        args += [kq, vq]
        extra = {"k_scale": ks.to(device), "v_scale": vs.to(device)}
    else:
        args += [kp.to(dtype), vp.to(dtype)]
        extra = {}
    args = [t.to(device) for t in args] + [tables.to(device), lens.to(device)]
    return (args, extra) if int8 else args


def _chunk(b, kvh, key_range):
    """The keys a split of the decode kernels' plan holds."""
    return TA.split_plan(b, kvh, key_range, TA._sm_count(0))[1]


def _paged_split(args, scales=None):
    """The paged plain split form with the kernel's plan."""
    q, kp, _, tables = args[:4]
    chunk = _chunk(q.shape[0], kp.shape[2], tables.shape[1] * kp.shape[1])
    return TA.paged_decode_attention(*args, **(scales or {}), impl="torch",
                                     split_keys=chunk)


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
    split = _paged_split(args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, split, atol=1e-5, rtol=1e-5)
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


def _mlp_weights(tree):
    return tuple(tree[n]["kernel"] for n in ("w_gate", "w_up", "w_down"))


@pytest.mark.parametrize("b", [1, 8, 13, 16])
def test_decode_mlp_kernel_bf16_8b_shape(cuda_device, b):
    """bf16 at 8B widths takes the tensor-core kernel
    (decode_mlp_sm90.cu) at every decode row count."""
    x, scale, tree = _mlp(b, b, 4096, 14336, torch.bfloat16, cuda_device)
    assert TDM._decode_mlp_route(x, _mlp_weights(tree)) == "sm90"
    kernels.reset_launches()
    got = TDM.decode_mlp(x, scale, tree, 1e-5, impl="cuda").float()
    ref = TDM.decode_mlp(x, scale, tree, 1e-5, impl="reference").float()
    plain = TDM.decode_mlp(x, scale, tree, 1e-5, impl="torch").float()
    _assert_bf16_close(got, ref)
    _assert_bf16_close(plain, ref)
    _assert_bf16_close(got, plain)
    again = TDM.decode_mlp(x, scale, tree, 1e-5, impl="cuda").float()
    assert torch.equal(got, again), "reruns must give identical bits"
    assert kernels.LAUNCHES["decode_mlp_sm90"] == 2
    assert kernels.LAUNCHES["decode_mlp"] == 2


@pytest.mark.parametrize("b,d,ffn,dtype", [
    (8, 256, 512, torch.float32), (16, 4096, 1024, torch.float32),
    (17, 256, 512, torch.bfloat16), (32, 4096, 1024, torch.bfloat16),
])
def test_decode_mlp_simt_route_serves_fp32_and_wide_batches(
        cuda_device, b, d, ffn, dtype):
    """fp32 and B = 17 / 32 take decode_mlp.cu (CUDA cores): the
    tensor-core kernel launches never."""
    x, scale, tree = _mlp(b + d, b, d, ffn, dtype, cuda_device)
    assert TDM._decode_mlp_route(x, _mlp_weights(tree)) == "simt"
    kernels.reset_launches()
    got = TDM.decode_mlp(x, scale, tree, 1e-5, impl="cuda")
    ref = TDM.decode_mlp(x, scale, tree, 1e-5, impl="reference")
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        _assert_bf16_close(got, ref)
    assert kernels.LAUNCHES["decode_mlp"] == 1
    assert kernels.LAUNCHES["decode_mlp_sm90"] == 0


@pytest.mark.parametrize("b,d,ffn", [(3, 64, 128), (13, 256, 512),
                                     (8, 136, 200), (16, 4096, 1024)])
def test_decode_mlp_sm90_small_and_ragged_shapes(cuda_device, b, d, ffn):
    """The tensor-core kernel at TINY widths and at shapes whose K and N
    do not fill a stage or a CTA's columns, against the fp32 reference
    and the plain chain."""
    x, scale, tree = _mlp(b * d, b, d, ffn, torch.bfloat16, cuda_device)
    assert TDM._decode_mlp_route(x, _mlp_weights(tree)) == "sm90"
    got = TDM.decode_mlp(x, scale, tree, 1e-5, impl="cuda").float()
    ref = TDM.decode_mlp(x, scale, tree, 1e-5, impl="reference").float()
    plain = TDM.decode_mlp(x, scale, tree, 1e-5, impl="torch").float()
    torch.cuda.synchronize()
    _assert_bf16_close(got, ref)
    _assert_bf16_close(got, plain)


def test_launch_counters_count_launches(cuda_device):
    kernels.reset_launches()
    args = _paged(1, 2, 4, 2, 2, 64, [3, 9], torch.float32, cuda_device)
    TA.paged_decode_attention(*args)  # auto -> cuda for CUDA tensors
    assert TA._LAST_PAGED_IMPL == "cuda"
    TA.paged_decode_attention(*args, impl="torch")
    args8, scales = _paged(1, 2, 4, 2, 2, 64, [3, 9], torch.float32,
                           cuda_device, int8=True)
    TA.paged_decode_attention(*args8, **scales)
    x, scale, tree = _mlp(2, 2, 64, 128, torch.float32, cuda_device)
    TDM.decode_mlp(x, scale, tree, 1e-5)
    TDM.decode_mlp(x, scale, tree, 1e-5)
    assert TDM._LAST_DECODE_MLP_IMPL == "cuda"
    x, w_q, w_s = _int8mm(5, 3, 64, 96, torch.float32, cuda_device)
    TI.int8_matmul(x, w_q, w_s)
    assert TI._LAST_INT8MM_IMPL == "cuda"
    TI.int8_matmul(x, w_q, w_s, impl="torch")
    q, k, v, _ = _contig(6, 2, 64, 2, 2, 64, torch.float32, cuda_device)
    TA.decode_attention(q, k, v, 10)
    assert TA._LAST_DECODE_IMPL == "cuda"
    q, k, v, _ = _flash(8, 1, 64, 64, 2, 1, 64, torch.float32, cuda_device)
    TA.attention(q, k, v, causal=True)  # auto -> the forward kernel
    TA.attention(q, k, v, causal=True, impl="torch")
    logits = torch.randn(3, 100, device=cuda_device)
    key = torch.tensor([0, 1], dtype=torch.int64, device=cuda_device)
    TSP.sample_pick(logits, 0.9, 5, key=key)  # auto -> the pick kernel
    assert TSP._LAST_SAMPLE_IMPL == "cuda"
    TSP.sample_pick(logits, 0.9, 5, key=key, impl="torch")
    assert kernels.LAUNCHES == {
        "paged_decode_attention": 1, "paged_decode_attention_int8": 1,
        "decode_mlp": 2, "decode_mlp_sm90": 0, "int8mm": 1,
        "int8mm_sm90": 0,
        "int8mm_gemv_sm90": 0, "int8mm_gemv": 1,
        "decode_attention": 1,
        "flash_fwd": 1, "flash_fwd_sm90": 0, "flash_bwd_dq": 0,
        "flash_bwd_dq_sm90": 0, "flash_bwd_dkv": 0, "flash_bwd_dkv_sm90": 0,
        "sample_pick": 1,
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
    with pytest.raises(ValueError, match="int8 cache with f32 scales"):
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
    # The tensor-core route: bf16 operands of another shape or dtype are
    # refused before any launch, and its C entry refuses a plan it does
    # not take (a cluster of 9) or an unaligned pointer.
    x, scale, tree = _mlp(5, 8, 256, 512, torch.bfloat16, cuda_device)
    assert TDM._decode_mlp_route(x, _mlp_weights(tree)) == "sm90"
    kernels.reset_launches()
    with pytest.raises(ValueError, match="shapes"):
        TDM.decode_mlp(x[:, :128].contiguous(), scale, tree, 1e-5,
                       impl="cuda")
    bad = dict(tree, w_up={"kernel": tree["w_up"]["kernel"].float()})
    with pytest.raises(ValueError, match="dtype"):
        TDM.decode_mlp(x, scale, bad, 1e-5, impl="cuda")
    fn = kernels.function("decode_mlp_sm90.cu", "tpu_decode_mlp_sm90",
                          TDM._MLP_SM90_ARGTYPES)
    act = torch.empty(8, 512, dtype=torch.bfloat16, device=cuda_device)
    out = torch.empty_like(x)
    wg, wu, wd = _mlp_weights(tree)
    plan = TDM.mlp_sm90_plan(8, 256, 512, 132)
    gu, dn = plan.gate_up, plan.down
    args = [x.data_ptr(), scale.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            wd.data_ptr(), act.data_ptr(), out.data_ptr(), 8, 256, 512,
            gu.width, gu.cluster, gu.cta_steps, gu.slots, dn.width,
            dn.cluster, dn.cta_steps, dn.slots, 1e-5,
            torch.cuda.current_stream().cuda_stream]
    assert fn(*args) == 0
    for i, v in ((11, 9), (10, 96), (13, 9), (0, x.data_ptr() + 2)):
        wrong = list(args)
        wrong[i] = v
        with pytest.raises(RuntimeError, match="cudaError"):
            kernels.check(fn(*wrong), "decode_mlp_sm90")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_mlp_sm90"] == 0


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
            assert kernels.LAUNCHES["decode_mlp_sm90"] == 0  # fp32
    agree = np.mean([
        np.mean(out["cpu"][r].tokens == out["cuda"][r].tokens)
        for r, _, _ in trace
    ])
    assert agree >= 0.97, agree


# --- int8 paged branch, int8 matmul, contiguous decode ------------------


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("page", [1, 16])
def test_paged_decode_int8_kernel_fp32_matches_plain(cuda_device, hd, n_rep,
                                                     page):
    lengths = [0, 1, page, page + 1, 3 * page - 1, 77, 255, 512, 1000]
    args, scales = _paged(hd + n_rep + page, len(lengths), page, 2, n_rep,
                          hd, lengths, torch.float32, cuda_device, int8=True)
    got = TA.paged_decode_attention(*args, **scales, impl="cuda")
    want = TA.paged_decode_attention(*args, **scales, impl="torch")
    split = _paged_split(args, scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, split, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert torch.all(got[0] == 0)


def test_paged_decode_int8_kernel_bf16_8b_shape(cuda_device):
    lengths = [0, 1, 15, 16, 17, 255, 512, 1000]
    args, scales = _paged(0, 8, 16, 8, 4, 128, lengths, torch.bfloat16,
                          cuda_device, int8=True)
    got = TA.paged_decode_attention(*args, **scales, impl="cuda").float()
    ref = TA.paged_decode_attention(*args, **scales, impl="reference").float()
    plain = TA.paged_decode_attention(*args, **scales, impl="torch").float()
    _assert_bf16_close(got, ref)
    _assert_bf16_close(plain, ref)
    _assert_bf16_close(got, plain)
    assert torch.all(got[0] == 0)


def _int8mm(seed, m, k, n, dtype, device, zero_col=None):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(m, k, generator=g)
    w = 0.02 * torch.randn(k, n, generator=g)
    if zero_col is not None:
        w[:, zero_col] = 0.0
    q = quantize_weight(w)
    return (x.to(device=device, dtype=dtype), q["kernel_q"].to(device),
            q["scale"].to(device))


@pytest.mark.parametrize("m", [1, 2, 3, 8, 13, 16, 17, 40, 130])
@pytest.mark.parametrize("k,n", [(64, 96), (130, 300), (77, 33), (512, 256)])
def test_int8mm_kernel_fp32_matches_plain(cuda_device, m, k, n):
    x, w_q, w_s = _int8mm(m + k + n, m, k, n, torch.float32, cuda_device)
    got = TI.int8_matmul(x, w_q, w_s, impl="cuda")
    want = TI.int8_matmul(x, w_q, w_s, impl="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m", [1, 8, 1024])
@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096), (4096, 1024)])
def test_int8mm_kernel_bf16_8b_shapes(cuda_device, m, k, n):
    """The wrapper at Llama-3-8B shapes: the tensor-core GEMV at
    M <= 16, the wgmma tile at M = 1024."""
    x, w_q, w_s = _int8mm(m, m, k, n, torch.bfloat16, cuda_device,
                          zero_col=n // 2)
    route = "gemv_sm90" if m <= 16 else "sm90"
    assert TI._int8mm_route(x, w_q) == route
    kernels.reset_launches()
    got = TI.int8_matmul(x, w_q, w_s, impl="cuda").float()
    assert kernels.LAUNCHES[f"int8mm_{route}"] == kernels.LAUNCHES["int8mm"]
    ref = TI.int8_matmul(x, w_q, w_s, impl="reference").float()
    plain = TI.int8_matmul(x, w_q, w_s, impl="torch").float()
    _assert_bf16_close(got, ref)
    _assert_bf16_close(plain, ref)
    _assert_bf16_close(got, plain)
    assert torch.all(got[:, n // 2] == 0), "an all-zero column gives zeros"
    again = TI.int8_matmul(x, w_q, w_s, impl="cuda").float()
    assert torch.equal(got, again), "reruns must give identical bits"


def _wmma_int8mm(x, w_q, w_s):
    """int8mm.cu's WMMA tile, launched directly as the wrapper launches
    it for the bf16 shapes the wgmma tile does not take."""
    m, k = x.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    fn = kernels.function("int8mm.cu", "tpu_int8_matmul",
                          TI._INT8MM_ARGTYPES)
    kernels.check(fn(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
                     out.data_ptr(), None, 1, m, k, n, 1, 16, 1, 1,
                     torch.cuda.current_stream().cuda_stream), "int8mm wmma")
    return out


@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096), (4096, 1024),
                                 (4096, 4096)])
def test_int8mm_wmma_tile_bf16_8b_shapes(cuda_device, k, n):
    """The WMMA tile at the Llama-3-8B prefill shapes (M = 1024), within
    the per-row bar of the plain version and the fp32 reference."""
    m = 1024
    x, w_q, w_s = _int8mm(m + k, m, k, n, torch.bfloat16, cuda_device,
                          zero_col=n // 2)
    got = _wmma_int8mm(x, w_q, w_s).float()
    again = _wmma_int8mm(x, w_q, w_s).float()
    ref = TI.int8_matmul(x, w_q, w_s, impl="reference").float()
    plain = TI.int8_matmul(x, w_q, w_s, impl="torch").float()
    torch.cuda.synchronize()
    _assert_bf16_close(got, ref)
    _assert_bf16_close(got, plain)
    assert torch.all(got[:, n // 2] == 0), "an all-zero column gives zeros"
    assert torch.equal(got, again), "reruns must give identical bits"


def _gemv_int8mm(x, w_q, w_s):
    """int8mm.cu's weight-streaming GEMV, launched directly with the
    wrapper's plan: it served every decode product before
    int8mm_gemv_sm90.cu and still serves fp32 and the shapes that kernel
    does not take."""
    m, k = x.shape
    n = w_q.shape[1]
    rows_tile, vec, splits = TI._gemv_plan(m, k, n, w_q.data_ptr(),
                                           x.device)
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    partial = (torch.empty(splits, m, n, dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    fn = kernels.function("int8mm.cu", "tpu_int8_matmul",
                          TI._INT8MM_ARGTYPES)
    kernels.check(fn(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
                     out.data_ptr(),
                     None if partial is None else partial.data_ptr(),
                     TI._DTYPE_CODES[x.dtype], m, k, n, rows_tile, vec,
                     splits, int(k % 8 == 0 and x.data_ptr() % 16 == 0),
                     torch.cuda.current_stream().cuda_stream), "int8mm gemv")
    return out


@functools.lru_cache(maxsize=1)
def _decode_weights(k, n):
    """One int8 weight [k, n] quantized on the card from normal(0.02),
    with an all-zero column at n // 3 (kept while a shape's cases run)."""
    g = torch.Generator(device="cuda").manual_seed(k + n)
    w = torch.empty(k, n, device="cuda").normal_(0.0, 0.02, generator=g)
    w[:, n // 3] = 0.0
    q = quantize_weight(w)
    return q["kernel_q"], q["scale"]


DECODE_KN = [(4096, 14336), (4096, 4096), (4096, 1024), (14336, 4096),
             (4096, 128256)]


@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 13, 16])
@pytest.mark.parametrize("k,n", DECODE_KN)
def test_int8mm_gemv_sm90_decode_shapes(cuda_device, m, k, n):
    """bf16 with M <= 16 at every Llama-3-8B decode projection takes the
    tensor-core GEMV (int8mm_gemv_sm90.cu) in one launch: within the
    per-row bar of the plain version and the fp32 reference, all-zero
    columns exact, reruns bit-identical. int8mm.cu's GEMV, launched
    directly on the same inputs, holds the same bar."""
    w_q, w_s = _decode_weights(k, n)
    g = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
    assert TI._int8mm_route(x, w_q) == "gemv_sm90"
    kernels.reset_launches()
    got = TI.int8_matmul(x, w_q, w_s, impl="cuda")
    assert kernels.LAUNCHES["int8mm_gemv_sm90"] == 1
    assert kernels.LAUNCHES["int8mm"] == 1
    assert kernels.LAUNCHES["int8mm_gemv"] == 0
    again = TI.int8_matmul(x, w_q, w_s, impl="cuda")
    old = _gemv_int8mm(x, w_q, w_s)
    ref = TI.int8_matmul(x, w_q, w_s, impl="reference")
    plain = TI.int8_matmul(x, w_q, w_s, impl="torch")
    torch.cuda.synchronize()
    for out in (got, old):
        _assert_bf16_close(out, ref)
        _assert_bf16_close(out, plain)
        assert torch.all(out[:, n // 3] == 0), "an all-zero column gives 0"
    assert torch.equal(got, again), "reruns must give identical bits"


SM90_INT8MM_M = [17, 64, 127, 128, 129, 1024, 2048]
SM90_INT8MM_KN = [(64, 128), (136, 144), (4096, 1024), (4096, 4096),
                  (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("m", SM90_INT8MM_M)
@pytest.mark.parametrize("k,n", SM90_INT8MM_KN)
def test_int8mm_sm90_bf16_matches_plain(cuda_device, m, k, n):
    """bf16 with M > 16 takes the wgmma tile (int8mm_sm90.cu), within
    the per-row bar of the plain version and the fp32 reference; the
    ragged edges of M (17, 127, 129), K (136) and N (144) included."""
    x, w_q, w_s = _int8mm(7 * m + k + n, m, k, n, torch.bfloat16,
                          cuda_device, zero_col=n // 3)
    assert TI._int8mm_route(x, w_q) == "sm90"
    kernels.reset_launches()
    got = TI.int8_matmul(x, w_q, w_s, impl="cuda")
    assert kernels.LAUNCHES["int8mm_sm90"] == kernels.LAUNCHES["int8mm"] == 1
    assert kernels.LAUNCHES["int8mm_gemv"] == 0
    again = TI.int8_matmul(x, w_q, w_s, impl="cuda")
    ref = TI.int8_matmul(x, w_q, w_s, impl="reference")
    plain = TI.int8_matmul(x, w_q, w_s, impl="torch")
    torch.cuda.synchronize()
    _assert_bf16_close(got, ref)
    _assert_bf16_close(got, plain)
    assert torch.all(got[:, n // 3] == 0), "an all-zero column gives zeros"
    assert torch.equal(got, again), "reruns must give identical bits"


@pytest.mark.parametrize("rows", [128, 256])
@pytest.mark.parametrize("m,k,n", [(17, 64, 128), (300, 200, 400),
                                   (1024, 4096, 1024)])
def test_int8mm_sm90_both_tiles_match_the_reference(cuda_device, rows, m, k,
                                                     n):
    """Each CTA tile the wrapper can pick (_sm90_rows), launched
    directly, within the bar of the fp32 reference."""
    x, w_q, w_s = _int8mm(m + k, m, k, n, torch.bfloat16, cuda_device,
                          zero_col=n // 3)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=cuda_device)
    fn = kernels.function("int8mm_sm90.cu", "tpu_int8_matmul_sm90",
                          TI._INT8MM_SM90_ARGTYPES)
    kernels.check(fn(x.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
                     out.data_ptr(), m, k, n, rows,
                     torch.cuda.current_stream().cuda_stream), "int8mm_sm90")
    ref = TI.int8_matmul(x, w_q, w_s, impl="reference")
    torch.cuda.synchronize()
    _assert_bf16_close(out, ref)
    assert torch.all(out[:, n // 3] == 0)


@pytest.mark.parametrize("case", ["k130", "n300", "x_offset"])
def test_int8mm_unaligned_bf16_takes_wmma(cuda_device, case):
    """bf16 shapes the wgmma tile does not take (K % 8, N % 16, x not
    16-byte aligned) run on int8mm.cu's WMMA tile and still match."""
    m = 200
    k = 130 if case == "k130" else 256
    n = 300 if case == "n300" else 256
    x, w_q, w_s = _int8mm(k + n, m, k, n, torch.bfloat16, cuda_device,
                          zero_col=n // 3)
    if case == "x_offset":
        buf = torch.empty(m * k + 1, dtype=torch.bfloat16, device=cuda_device)
        buf[1:].copy_(x.reshape(-1))
        x = buf[1:].view(m, k)
    assert TI._int8mm_route(x, w_q) == "wmma"
    kernels.reset_launches()
    got = TI.int8_matmul(x, w_q, w_s, impl="cuda")
    assert kernels.LAUNCHES["int8mm"] == 1
    assert kernels.LAUNCHES["int8mm_sm90"] == 0
    assert kernels.LAUNCHES["int8mm_gemv"] == 0
    ref = TI.int8_matmul(x, w_q, w_s, impl="reference")
    plain = TI.int8_matmul(x, w_q, w_s, impl="torch")
    torch.cuda.synchronize()
    _assert_bf16_close(got, ref)
    _assert_bf16_close(got, plain)
    assert torch.all(got[:, n // 3] == 0)


def test_int8mm_leading_dims(cuda_device):
    x, w_q, w_s = _int8mm(9, 12, 64, 80, torch.float32, cuda_device)
    got = TI.int8_matmul(x.reshape(3, 4, 64), w_q, w_s, impl="cuda")
    assert got.shape == (3, 4, 80)
    want = TI.int8_matmul(x, w_q, w_s, impl="torch").reshape(3, 4, 80)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _contig(seed, b, max_seq, kvh, n_rep, hd, dtype, device, int8=False):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, kvh * n_rep, hd, generator=g)
    k = torch.randn(b, max_seq, kvh, hd, generator=g)
    v = torch.randn(b, max_seq, kvh, hd, generator=g)
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = {"k_scale": ks.to(device), "v_scale": vs.to(device)}
    else:
        k, v, scales = k.to(dtype), v.to(dtype), {}
    return q.to(device=device, dtype=dtype), k.to(device), v.to(device), scales


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_decode_kernel_fp32_matches_plain(cuda_device, hd, n_rep, int8):
    max_seq = 1024
    q, k, v, scales = _contig(hd + n_rep, 3, max_seq, 2, n_rep, hd,
                              torch.float32, cuda_device, int8=int8)
    for length in (0, 1, 255, 256, 257, 1000, max_seq):
        got = TA.decode_attention(q, k, v, length, **scales, impl="cuda")
        want = TA.decode_attention(q, k, v, length, **scales, impl="torch")
        split = TA.decode_attention(q, k, v, length, **scales, impl="torch",
                                    split_keys=_chunk(3, 2, length))
        torch.cuda.synchronize()
        torch.testing.assert_close(got, split, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        if length == 0:
            assert torch.all(got == 0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_kernel_bf16_8b_shape(cuda_device, int8):
    q, k, v, scales = _contig(1, 8, 1024, 8, 4, 128, torch.bfloat16,
                              cuda_device, int8=int8)
    for length in (1, 255, 256, 257, 1000):
        got = TA.decode_attention(q, k, v, length, **scales, impl="cuda")
        ref = TA.decode_attention(q, k, v, length, **scales,
                                  impl="reference")
        plain = TA.decode_attention(q, k, v, length, **scales, impl="torch")
        _assert_bf16_close(got.float(), ref.float())
        _assert_bf16_close(plain.float(), ref.float())
        _assert_bf16_close(got.float(), plain.float())


# --- the split-key decode body (decode_attention.cuh) ----------------------

LONG = 8192


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_paged_decode_long_row_and_split_boundaries(cuda_device, int8):
    """One slot of 8192 keys at the 8B heads (the most splits), and
    lengths on either side of a split boundary: fp32 within 1e-5 of the
    plain split form, bf16 within the per-row bar of the reference."""
    chunk = _chunk(1, 8, LONG)
    for dtype in (torch.float32, torch.bfloat16):
        out = _paged(7, 1, 16, 8, 4, 128, [LONG], dtype, cuda_device,
                     int8=int8)
        args, scales = out if int8 else (out, {})
        for n in (1, chunk - 1, chunk, chunk + 1, 3 * chunk, LONG - 1, LONG):
            args[4].fill_(n)
            got = TA.paged_decode_attention(*args, **scales, impl="cuda")
            if dtype == torch.float32:
                torch.testing.assert_close(got, _paged_split(args, scales),
                                           atol=1e-5, rtol=1e-5)
            else:
                _assert_bf16_close(got, TA.paged_decode_attention(
                    *args, **scales, impl="reference"))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_long_row_and_split_boundaries(cuda_device, int8):
    """The contiguous kernel's counterpart: b=1, max_seq 8192."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, scales = _contig(8, 1, LONG, 8, 4, 128, dtype, cuda_device,
                                  int8=int8)
        chunk = _chunk(1, 8, LONG)
        for n in (1, 63, 64, 65, chunk + 1, 3 * chunk, LONG - 1, LONG):
            got = TA.decode_attention(q, k, v, n, **scales, impl="cuda")
            if dtype == torch.float32:
                want = TA.decode_attention(q, k, v, n, **scales, impl="torch",
                                           split_keys=_chunk(1, 8, n))
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            else:
                _assert_bf16_close(got, TA.decode_attention(
                    q, k, v, n, **scales, impl="reference"))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_decode_kernels_rerun_bit_identical(cuda_device, int8, paged):
    """No atomics: the combine merges the splits in a fixed order."""
    if paged:
        out = _paged(9, 8, 16, 8, 4, 128, [0, 1, 63, 64, 65, 512, 1000, 1024],
                     torch.bfloat16, cuda_device, int8=int8)
        args, scales = out if int8 else (out, {})
        call = lambda: TA.paged_decode_attention(*args, **scales, impl="cuda")
    else:
        q, k, v, scales = _contig(9, 8, 1024, 8, 4, 128, torch.bfloat16,
                                  cuda_device, int8=int8)
        call = lambda: TA.decode_attention(q, k, v, 777, **scales,
                                           impl="cuda")
    first = call()
    for _ in range(3):
        assert torch.equal(call(), first), "reruns must give identical bits"


def test_paged_decode_overflow_is_nan_with_many_splits(cuda_device):
    q, kp, vp, tables, lens = _paged(10, 4, 16, 8, 4, 128, [1000] * 4,
                                     torch.float32, cuda_device)
    cap = tables.shape[1] * 16
    assert TA.split_plan(4, 8, cap, TA._sm_count(0))[0] > 1
    lens.copy_(torch.tensor([0, cap, cap + 1, 5], dtype=torch.int32))
    got = TA.paged_decode_attention(q, kp, vp, tables, lens, impl="cuda")
    assert torch.all(got[0] == 0)
    assert torch.isfinite(got[1]).all() and torch.isfinite(got[3]).all()
    assert torch.isnan(got[2]).all()


def test_paged_decode_plan_reads_no_device_value(cuda_device):
    """The engine's decode loop stays free of host syncs: the split plan
    comes from host-known values only."""
    out = _paged(11, 8, 16, 8, 4, 128, [5, 17, 100, 512, 1000, 3, 64, 0],
                 torch.bfloat16, cuda_device, int8=True)
    args, scales = out
    TA.paged_decode_attention(*args, **scales, impl="cuda")  # build, load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = TA.paged_decode_attention(*args, **scales, impl="cuda")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_bf16_close(got, TA.paged_decode_attention(*args, **scales,
                                                      impl="reference"))


def test_new_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v, _ = _contig(2, 2, 64, 2, 2, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="extra_k"):
        TA.decode_attention(q, k, v, 5, extra_k=k[:, 0], extra_v=v[:, 0],
                            impl="cuda")
    with pytest.raises(ValueError, match="outside the cache"):
        TA.decode_attention(q, k, v, 65, impl="cuda")
    with pytest.raises(ValueError, match="q's dtype"):
        TA.decode_attention(q, k.half(), v.half(), 5, impl="cuda")
    x, w_q, w_s = _int8mm(3, 4, 64, 96, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="int8 weights"):
        TI.int8_matmul(x, w_q.float(), w_s, impl="cuda")
    with pytest.raises(ValueError, match="bf16 or fp32"):
        TI.int8_matmul(x.half(), w_q, w_s, impl="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        TI.int8_matmul(x.t().contiguous().t(), w_q, w_s, impl="cuda")


def test_tiny_int8_paths_on_the_card_match_the_cpu(cuda_device):
    """fp32 TINY_LLAMA with int8 weights and KV: the card's engine
    (int8mm + the int8 paged branch) and greedy_generate (int8mm + the
    contiguous decode kernel, all four quant combinations) give the CPU
    paths' greedy tokens exactly."""
    from tpu_dra_torch.workloads.engine import Engine, EngineConfig, Request
    from tpu_dra_torch.workloads.generate import greedy_generate
    from tpu_dra_torch.workloads.models.llama import TINY_LLAMA, init_params

    cfg = dataclasses.replace(
        TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32, dim=256,
    )
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(6)
    trace = [
        (f"r{i}", rng.integers(1, 256, rng.integers(3, 30)).astype(np.int32),
         int(rng.integers(4, 12)))
        for i in range(5)
    ]
    ec = EngineConfig(page_size=4, max_slots=3, max_pages_per_seq=12,
                      scan_chunk=3, prefill_chunk=8, kv_quant="int8",
                      weight_quant="int8")
    out = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_launches()
        eng = Engine(cfg, params, ec, device=dev)
        out[dev] = eng.run([
            Request(rid=r, prompt=p, max_new_tokens=n) for r, p, n in trace
        ])
        if dev == "cuda":
            assert kernels.LAUNCHES["paged_decode_attention_int8"] == (
                cfg.n_layers * eng.decode_steps
            )
            assert kernels.LAUNCHES["int8mm"] == (
                (7 * cfg.n_layers + 1)
                * (eng.decode_steps + eng.prefill_buckets)
            )
            assert kernels.LAUNCHES["decode_mlp"] == 0
    for r, _, _ in trace:
        assert np.array_equal(out["cpu"][r].tokens, out["cuda"][r].tokens), r
    prompt = rng.integers(1, 256, (3, 20)).astype(np.int32)
    for kvq in ("none", "int8"):
        for wq in ("none", "int8"):
            kernels.reset_launches()
            got = greedy_generate(cfg, params, prompt, 10, kv_quant=kvq,
                                  weight_quant=wq, device="cuda")
            assert kernels.LAUNCHES["decode_attention"] == cfg.n_layers * 9
            want = greedy_generate(cfg, params, prompt, 10, kv_quant=kvq,
                                   weight_quant=wq, device="cpu")
            assert torch.equal(got, want), (kvq, wq)


# --- flash attention (training path) -----------------------------------------


def _flash(seed, b, sq, skv, h, kvh, hd, dtype, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, do = (torch.randn(b, sq, h, hd, generator=g) for _ in range(2))
    k, v = (torch.randn(b, skv, kvh, hd, generator=g) for _ in range(2))
    return [t.to(device=device, dtype=dtype) for t in (q, k, v, do)]


def _flash_all(q, k, v, do, causal, impl):
    """(out, lse, dq, dk, dv) of one impl's three functions on the same
    inputs; the backward pair takes the plain forward's lse and delta."""
    fwd = TA._cuda_flash_fwd if impl == "cuda" else TA._torch_flash_fwd
    dq_fn, dkv_fn = (
        (TA._cuda_flash_bwd_dq, TA._cuda_flash_bwd_dkv) if impl == "cuda"
        else (TA._torch_flash_bwd_dq, TA._torch_flash_bwd_dkv)
    )
    out, lse = fwd(q, k, v, causal)
    o_p, lse_p = TA._torch_flash_fwd(q, k, v, causal)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq = dq_fn(q, k, v, do, lse_p, delta, causal)
    dk, dv = dkv_fn(q, k, v, do, lse_p, delta, causal)
    return out, lse, dq, dk, dv


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd", [
    (1, 64, 64, 2, 1, 16), (2, 100, 130, 4, 2, 64), (1, 77, 77, 8, 8, 48),
    (2, 128, 128, 8, 2, 128), (1, 1, 65, 4, 1, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_fp32_match_plain(cuda_device, b, sq, skv, h, kvh, hd,
                                        causal):
    ins = _flash(sq + hd, b, sq, skv, h, kvh, hd, torch.float32, cuda_device)
    got = _flash_all(*ins, causal, "cuda")
    want = _flash_all(*ins, causal, "torch")
    for g, w, name in zip(got, want, ("out", "lse", "dq", "dk", "dv")):
        bar = 1e-5 if name in ("out", "lse") else 1e-4
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= bar * top, name
    again = _flash_all(*ins, causal, "cuda")
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("sq,skv,causal", [(1000, 1000, True),
                                          (512, 2048, True),
                                          (256, 256, False)])
def test_flash_kernels_bf16_8b_heads(cuda_device, sq, skv, causal):
    ins = _flash(7, 2, sq, skv, 32, 8, 128, torch.bfloat16, cuda_device)
    got = _flash_all(*ins, causal, "cuda")
    want = _flash_all(*ins, causal, "torch")
    _assert_bf16_close(got[0], want[0])
    for g, w in zip(got[2:], want[2:]):
        _assert_bf16_close(g, w, atol_floor=1e-5 * float(w.abs().max()))
    assert float((got[1] - want[1]).abs().max()) <= 1e-5 * float(
        want[1].abs().max())


# The wgmma forward (flash_fwd_sm90.cu): ragged query tiles (1, 65, 127,
# 129, 1000 rows against 128-row CTAs and 128-key tiles) and suffix
# queries, both head dims, GQA from none to 8 query heads a kv head.
SM90_LENGTHS = [(1, 1), (65, 65), (127, 127), (129, 129), (1000, 1000),
                (512, 2048)]


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,skv", SM90_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("b", [1, 2])
def test_flash_fwd_sm90_bf16_matches_plain(cuda_device, hd, sq, skv, causal,
                                           n_rep, b):
    q, k, v, _ = _flash(sq + skv + hd + n_rep, b, sq, skv, 2 * n_rep, 2, hd,
                        torch.bfloat16, cuda_device)
    assert TA._flash_fwd_route(q) == "sm90"
    kernels.reset_launches()
    out, lse = TA._cuda_flash_fwd(q, k, v, causal)
    again = TA._cuda_flash_fwd(q, k, v, causal)
    assert kernels.LAUNCHES["flash_fwd_sm90"] == 2
    o_p, lse_p = TA._torch_flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    _assert_bf16_close(out, o_p)
    assert float((lse - lse_p).abs().max()) <= 1e-5 * float(
        lse_p.abs().max())
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


def _dk_term_scale(q, k, v, do, lse, delta, causal):
    """Per element of dK, the sum of the magnitudes of the fp32 terms it
    is summed from: scale * sum over rows of p (|dP| + |delta|) |q|. dS =
    p (dP - delta) cancels to rounding noise where a row sees one key
    (with sq = skv = 1, dK is 0 but for that noise), so dK's atol is
    never below 1e-5 of this."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    p, _ = TA._p_and_ds(q, k, v, do, lse, delta, causal)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", TA._group(do, kvh).float(),
                      v.float())
    terms = p * (dp.abs() + delta.float().abs().reshape(
        b, kvh, h // kvh, sq)[..., None])
    return torch.einsum("bgrqk,bqgrd->bkgd", terms,
                        TA._group(q, kvh).float().abs()) * hd ** -0.5


# The wgmma dK/dV backward (flash_bwd_sm90.cu): the same lengths against
# 128-key CTAs and 64-row query tiles, with and without an lse
# cotangent folded into delta.
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,skv", SM90_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("with_glse", [False, True], ids=["delta", "glse"])
def test_flash_bwd_dkv_sm90_bf16_matches_plain(cuda_device, hd, sq, skv,
                                               causal, n_rep, b, with_glse):
    h = 2 * n_rep
    q, k, v, do = _flash(sq + skv + hd + n_rep, b, sq, skv, h, 2, hd,
                         torch.bfloat16, cuda_device)
    assert TA._flash_bwd_dkv_route(q) == "sm90"
    o_p, lse_p = TA._torch_flash_fwd(q, k, v, causal)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2)
    if with_glse:
        g = torch.Generator(device="cpu").manual_seed(sq + hd)
        delta = delta - torch.randn(b, h, sq, generator=g).to(cuda_device)
    bwd = (q, k, v, do, lse_p, delta.contiguous(), causal)
    kernels.reset_launches()
    dk, dv = TA._cuda_flash_bwd_dkv(*bwd)
    again = TA._cuda_flash_bwd_dkv(*bwd)
    assert kernels.LAUNCHES["flash_bwd_dkv_sm90"] == 2
    assert kernels.LAUNCHES["flash_bwd_dkv"] == 2
    dk_p, dv_p = TA._torch_flash_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    _assert_bf16_close(dv, dv_p, atol_floor=1e-5 * float(
        dv_p.float().abs().max()))
    _assert_bf16_close(dk, dk_p, atol_floor=torch.clamp(
        1e-5 * _dk_term_scale(*bwd), min=1e-5 * float(
            dk_p.float().abs().max())))
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


def _dq_term_scale(q, k, v, do, lse, delta, causal):
    """Per element of dQ, the sum of the magnitudes of the fp32 terms it
    is summed from: scale * sum over keys of p (|dO|.|V| + |delta|) |k|,
    dP = dO.V counted by its own terms' magnitudes (its rounding error
    scales with those, while dP itself can cancel to near 0). dS = p (dP
    - delta) cancels to rounding noise where a row sees one key (with
    sq = skv = 1, dQ is 0 but for that noise), so dQ's atol is never
    below 1e-5 of this."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    p, _ = TA._p_and_ds(q, k, v, do, lse, delta, causal)
    dp_mag = torch.einsum("bqgrd,bkgd->bgrqk",
                          TA._group(do, kvh).float().abs(), v.float().abs())
    terms = p * (dp_mag + delta.float().abs().reshape(
        b, kvh, h // kvh, sq)[..., None])
    dq = torch.einsum("bgrqk,bkgd->bqgrd", terms, k.float().abs())
    return dq.reshape(b, sq, h, hd) * hd ** -0.5


# The wgmma dQ backward (flash_bwd_dq_sm90.cu): the same lengths against
# 128-row CTAs and 64-key tiles, with and without an lse cotangent
# folded into delta.
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,skv", SM90_LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("with_glse", [False, True], ids=["delta", "glse"])
def test_flash_bwd_dq_sm90_bf16_matches_plain(cuda_device, hd, sq, skv,
                                              causal, n_rep, b, with_glse):
    h = 2 * n_rep
    q, k, v, do = _flash(sq + skv + hd + n_rep, b, sq, skv, h, 2, hd,
                         torch.bfloat16, cuda_device)
    assert TA._flash_bwd_dq_route(q) == "sm90"
    o_p, lse_p = TA._torch_flash_fwd(q, k, v, causal)
    delta = (do.float() * o_p.float()).sum(-1).transpose(1, 2)
    if with_glse:
        g = torch.Generator(device="cpu").manual_seed(sq + hd)
        delta = delta - torch.randn(b, h, sq, generator=g).to(cuda_device)
    bwd = (q, k, v, do, lse_p, delta.contiguous(), causal)
    kernels.reset_launches()
    dq = TA._cuda_flash_bwd_dq(*bwd)
    again = TA._cuda_flash_bwd_dq(*bwd)
    assert kernels.LAUNCHES["flash_bwd_dq_sm90"] == 2
    assert kernels.LAUNCHES["flash_bwd_dq"] == 2
    dq_p = TA._torch_flash_bwd_dq(*bwd)
    torch.cuda.synchronize()
    _assert_bf16_close(dq, dq_p, atol_floor=torch.clamp(
        1e-5 * _dq_term_scale(*bwd), min=1e-5 * float(
            dq_p.float().abs().max())))
    assert torch.equal(dq, again)


def test_flash_fwd_route_follows_dtype_and_head_dim(cuda_device):
    """bf16 at hd 128 launches the wgmma forward and dQ kernels; fp32 and
    hd 48 the WMMA flash_fwd_kernel and flash_bwd_dq_kernel. "flash_fwd"
    and "flash_bwd_dq" count both."""
    for dtype, hd, sm90 in ((torch.bfloat16, 128, 1), (torch.float32, 128, 0),
                            (torch.bfloat16, 48, 0)):
        q, k, v, do = _flash(hd, 1, 70, 70, 4, 2, hd, dtype, cuda_device)
        q.requires_grad_()
        kernels.reset_launches()
        out = TA.attention(q, k, v, causal=True)
        assert kernels.LAUNCHES["flash_fwd"] == 1
        assert kernels.LAUNCHES["flash_fwd_sm90"] == sm90, (dtype, hd)
        out.backward(do)
        assert kernels.LAUNCHES["flash_bwd_dq"] == 1
        assert kernels.LAUNCHES["flash_bwd_dq_sm90"] == sm90, (dtype, hd)


def test_flash_autograd_function_on_the_card_matches_the_cpu(cuda_device):
    """The autograd.Function end to end (out, lse and a g_lse cotangent):
    kernels on the card against the plain versions on the CPU, fp32."""
    ins = _flash(3, 2, 96, 96, 4, 2, 64, torch.float32, "cpu")
    g_lse = torch.randn(2, 4, 96, generator=torch.Generator().manual_seed(4))
    grads = {}
    for dev in ("cpu", "cuda"):
        q, k, v = (t.detach().to(dev).requires_grad_() for t in ins[:3])
        kernels.reset_launches()
        out, lse = TA.flash_attention_with_lse(q, k, v, True)
        assert type(out.grad_fn).__name__ == "_FlashAttentionWithLseBackward"
        ((out * ins[3].to(dev)).sum() + (lse * g_lse.to(dev)).sum()).backward()
        n = int(dev == "cuda")  # the CPU runs the plain versions
        assert {k_: kernels.LAUNCHES[k_] for k_ in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")} == dict.fromkeys(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), n)
        grads[dev] = [t.detach().cpu() for t in (out, lse, q.grad, k.grad,
                                                 v.grad)]
    for g, w in zip(grads["cuda"], grads["cpu"]):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_flash_refuses_on_the_card_without_falling_back(cuda_device):
    q = torch.zeros(1, 8, 4, 256, device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 256, device=cuda_device, dtype=torch.bfloat16)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="head dim"):
        TA.attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        TA._cuda_flash_fwd(q[..., :128], k[..., :128], k[..., :128], True)
    assert kernels.LAUNCHES["flash_fwd"] == 0


def test_one_train_step_launches_each_flash_kernel_per_layer(cuda_device):
    """One Trainer step (remat "nothing"): 2L forwards (the recompute is
    the second), L dQ and L dK/dV, and no other kernel."""
    from tpu_dra_torch.workloads import train as TT
    from tpu_dra_torch.workloads.models.llama import TINY_LLAMA

    cfg = dataclasses.replace(TINY_LLAMA, remat=True, dtype=torch.bfloat16)
    trainer = TT.Trainer(cfg, device=cuda_device)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(0).integers(0, 256, (2, 40)).astype(np.int32)
    kernels.reset_launches()
    state, loss = trainer.make_train_step()(state, tokens)
    assert np.isfinite(float(loss))
    L = cfg.n_layers
    assert kernels.LAUNCHES == {
        **{k: 0 for k in kernels.LAUNCHES},
        "flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
    }


# --- the fused pick (csrc/sample.cu) ----------------------------------------


def _pick_logits(seed, rows, vocab, ties, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(rows, vocab, generator=g) * 3
    if ties:  # bf16-rounded: equal values at the top of every row
        x = x.to(torch.bfloat16).float()
    return x.to(device)


def _rows_keys(rows, device, per=1):
    serials = torch.arange(rows // per, dtype=torch.int32) * 7 + 3
    positions = torch.arange(rows, dtype=torch.int32) * 13 + 100
    seed = torch.tensor(11, dtype=torch.int32)
    return dict(seed=seed.to(device), serials=serials.to(device),
                positions=positions.to(device), rows_per_serial=per)


@pytest.mark.parametrize("ties", [False, True], ids=["normal", "bf16_ties"])
@pytest.mark.parametrize("temperature,top_k",
                         [(0.8, 40), (1.3, 8), (1.0, 0), (0.7, 1), (1.0, 512),
                          (1.1, 1024)])
@pytest.mark.parametrize("layout", ["rows", "block", "rows_per_5"])
def test_sample_pick_matches_plain(cuda_device, layout, temperature, top_k,
                                   ties):
    """The kernel and its plain version on the same card inputs draw the
    same tokens from the same candidates; so does the plain version on
    the CPU (its logs may round apart by an ulp: tokens are the gate),
    checked on the unrounded logits to keep the CPU's share short."""
    rows, vocab = 40, 128256
    x = _pick_logits(top_k + int(ties), rows, vocab, ties, cuda_device)
    if layout == "block":
        kw = dict(key=torch.tensor([5, 77], dtype=torch.int64,
                                   device=cuda_device), fold=3)
    else:
        kw = _rows_keys(rows, cuda_device, 5 if layout == "rows_per_5" else 1)
    kernels.reset_launches()
    got = TSP.sample_pick(x, temperature, top_k, impl="cuda",
                          candidates=True, **kw)
    assert kernels.LAUNCHES["sample_pick"] == 1
    plain = TSP.sample_pick(x, temperature, top_k, impl="torch",
                            candidates=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], plain[0])
    if top_k:
        assert torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2])
    if not ties:
        cpu_kw = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                  for k, v in kw.items()}
        cpu = TSP.sample_pick(x.cpu(), temperature, top_k, **cpu_kw)
        assert torch.equal(got[0].cpu(), cpu)


def test_sample_pick_all_equal_rows_take_the_lowest_ids(cuda_device):
    x = torch.zeros(4, 5000, device=cuda_device)
    ids, vals, idx = TSP.sample_pick(
        x, 1.0, 64, key=torch.tensor([1, 2], dtype=torch.int64,
                                     device=cuda_device),
        impl="cuda", candidates=True)
    want = torch.arange(64, dtype=torch.int32, device=cuda_device)
    assert all(torch.equal(idx[r], want) for r in range(4))
    plain = TSP.sample_pick(
        x, 1.0, 64, key=torch.tensor([1, 2], dtype=torch.int64,
                                     device=cuda_device), impl="torch")
    assert torch.equal(ids, plain)


def test_sample_pick_refuses_on_the_card_without_falling_back(cuda_device):
    x = torch.zeros(2, 3000, device=cuda_device)
    key = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="top_k"):
        TSP.sample_pick(x, 1.0, TSP.MAX_TOP_K + 1, key=key)
    with pytest.raises(ValueError, match="float32"):
        TSP.sample_pick(x.to(torch.bfloat16), 1.0, 8, key=key)
    with pytest.raises(ValueError, match="int64"):
        TSP.sample_pick(x, 1.0, 8, key=key.int())
