"""The port's weight-only int8 matmul held to the JAX op on the CPU.

``torch`` (the twin of ``_xla_int8_matmul``) against JAX's XLA path and
against the Pallas kernel in interpret mode at its tileable shape
(128 x 1024 x 1024, as tests/test_workloads.py runs it), fp32, on the
same numpy-seeded inputs quantized by JAX: atol = rtol = 1e-5. Leading
dims reshape as in JAX; M in {1, 3, 8} (decode) and {24, 130}
(prefill-like). ``reference`` is the fp32 oracle. On CPU tensors
``auto`` is ``torch`` and ``cuda`` raises. The kernel route
(``_int8mm_route``), the wgmma tile's rows (``_sm90_rows``) and the
decode GEMV's plan (``gemv_sm90_plan``) are chosen from shapes, dtype,
alignment and the SM count alone, so they are tested here; so are a
model of the GEMV's fragment and shared-memory maps and of its int8 ->
bf16 conversion, written out from csrc/int8mm_gemv_sm90.cu (float64
against x @ W, bit for bit against bf16), since the kernel itself runs
only on the card. The decode rows (M in {1, 8, 13, 16}) are held to
JAX's ``int8_matmul`` in fp32 (1e-5 of the largest |output|) and bf16
(two bf16 ulps of each row's largest |output| plus rtol 2e-2, the bar
chip_smoke.py holds the kernels to).
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
    64-byte-aligned allocation (its values are never read)."""
    n = int(np.prod(shape))
    buf = torch.empty(n + offset + 64, dtype=dtype)
    skip = (-buf.data_ptr() % 64) // buf.element_size()
    return buf[skip + offset: skip + offset + n].view(shape)


# The Llama-3-8B decode projections (K, N): gate/up, wq/wo, wk/wv,
# down, the lm_head.
DECODE_KN = [(4096, 14336), (4096, 4096), (4096, 1024), (14336, 4096),
             (4096, 128256)]


@pytest.mark.parametrize("m,k,n,dtype,x_off,w_off,route", [
    (1, 64, 128, torch.bfloat16, 0, 0, "gemv_sm90"),
    (16, 64, 128, torch.bfloat16, 0, 0, "gemv_sm90"),
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
] + [
    (m, k, n, torch.bfloat16, 0, 0, "gemv_sm90")
    for m in (1, 8, 13, 16) for k, n in DECODE_KN
] + [
    (8, 4096, 14336, torch.float32, 0, 0, "gemv"),
    (1, 4096, 1024, torch.float32, 0, 0, "gemv"),
    (8, 4096, 14336, torch.bfloat16, 0, 8, "gemv"),
    (8, 4096, 1032, torch.bfloat16, 0, 0, "gemv"),
    (8, 4098, 1024, torch.bfloat16, 0, 0, "gemv"),
    (8, 4096, 1024, torch.bfloat16, 2, 0, "gemv"),
    (8, 4096, 1024, torch.bfloat16, 4, 0, "gemv_sm90"),
    (17, 4096, 14336, torch.bfloat16, 0, 0, "sm90"),
], ids=["m1", "m16", "m16_fp32", "m17", "prefill", "ragged_aligned",
        "k130", "n300", "n136", "x_unaligned", "w_unaligned", "m17_fp32",
        "fp32_unaligned"] + [
    f"decode_m{m}_{k}x{n}" for m in (1, 8, 13, 16) for k, n in DECODE_KN
] + ["decode_fp32", "decode_fp32_m1", "decode_w_unaligned",
     "decode_n_odd", "decode_k_odd", "decode_x_4byte", "decode_x_8byte",
     "decode_m17"])
def test_int8mm_route(m, k, n, dtype, x_off, w_off, route):
    """gemv_sm90 for bf16 with M <= 16, K % 4 == 0, N % 16 == 0, x 8-byte
    and w_q 16-byte aligned; gemv for any other M <= 16; sgemm for fp32
    above; sm90 for bf16 with K % 8 == 0, N % 16 == 0 and x, w_q 16-byte
    aligned; wmma for the rest."""
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


# --- the decode GEMV (csrc/int8mm_gemv_sm90.cu) --------------------------

PLAN_SHAPES = [(m, k, n) for m in (1, 8, 13, 16) for k, n in DECODE_KN] + [
    (m, k, n) for m in (1, 9) for k, n in (
        (64, 96), (100, 48), (1000, 336), (4100, 1040), (16, 16),
        (4, 2048), (40960, 128), (4096, 1024 * 140))]


def _cta_steps_of(plan, steps):
    """The k16 steps of every CTA of a cluster, rank by rank, as the
    kernel walks them: stage s, warp slot wk of rank r takes step
    r * cta_steps + warps_k * s + wk while below its rank's end."""
    out = []
    for rank in range(plan.cluster):
        begin = rank * plan.cta_steps
        end = min(steps, begin + plan.cta_steps)
        out.append([begin + plan.warps_k * s + wk
                    for s in range(plan.stages) for wk in range(plan.warps_k)
                    if begin + plan.warps_k * s + wk < end])
    return out


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES,
                         ids=[f"m{m}_{k}x{n}" for m, k, n in PLAN_SHAPES])
def test_gemv_sm90_plan_covers_every_column_and_k_once(m, k, n):
    """Every 128-column slab belongs to one CTA column (no CTA column
    past N), the ranks' K ranges tile [0, K) in rank order and the
    warps of a rank cover its k16 steps once; the cluster is portable
    (<= 8)."""
    plan = TI.gemv_sm90_plan(m, k, n, 132)
    assert plan.planes == (1 if m <= 8 else 2)
    assert plan.warps_n * plan.warps_k == 8 and plan.warps_n in (1, 2, 4, 8)
    assert 1 <= plan.cluster <= 8
    slabs = -(-n // 128)
    cols = [y * plan.warps_n + sn for y in range(plan.col_ctas)
            for sn in range(plan.warps_n)]
    assert sorted(c for c in cols if c < slabs) == list(range(slabs))
    assert (plan.col_ctas - 1) * plan.warps_n < slabs
    steps = -(-k // 16)
    per_rank = _cta_steps_of(plan, steps)
    assert all(per_rank), "a rank without steps"
    assert [s for r in per_rank for s in r] == list(range(steps))


@pytest.mark.parametrize("m", [1, 8, 13, 16])
def test_gemv_sm90_plan_fills_one_wave(m):
    """One wave of at most one CTA an SM (clusters within three
    quarters of the SMs), at least 96 CTAs at gate/up, wq/wo, down and
    the lm_head and 64 at wk/wv (the old GEMV's grid held 32 there)."""
    for k, n in DECODE_KN:
        plan = TI.gemv_sm90_plan(m, k, n, 132)
        assert plan.ctas <= (132 if plan.cluster == 1 else 99), (k, n, plan)
        assert plan.ctas >= (64 if n == 1024 else 96), (k, n, plan)


def test_gemv_sm90_plan_reads_only_its_arguments(monkeypatch):
    """The plan is a function of (M, K, N, SM count): no device query."""
    monkeypatch.setattr(TI, "_sm_count", None)
    TI.gemv_sm90_plan.cache_clear()
    small = TI.gemv_sm90_plan(8, 4096, 14336, 66)
    assert small.ctas <= 66 and small == TI.gemv_sm90_plan(8, 4096, 14336, 66)


def _bf16_bits(values):
    """Round-to-nearest-even bf16 bits of float64 values (exact here)."""
    f = np.asarray(values, dtype=np.float32).view(np.uint32).astype(np.uint64)
    return ((f + 0x7FFF + ((f >> 16) & 1)) >> 16).astype(np.uint32)


def _i8_f32_bits(u, i):
    """common.cuh i8_f32_bits: byte i of the flipped word u under the
    exponent of 2^23, less 2^23 + 128, as fp32 bits."""
    placed = ((u >> (8 * i)) & 0xFF) | 0x4B000000
    return (placed.astype(np.uint32).view(np.float32)
            - np.float32(8388736.0)).view(np.uint32)


def _pack_upper_halves(lo, hi):
    return (lo >> 16) | (hi & 0xFFFF0000)


def test_int8_to_bf16_conversion_is_exact():
    """The kernel's conversion (common.cuh) on every int8 value in every
    byte position and row pairing gives the bf16 bits of the value."""
    v = np.arange(-128, 128, dtype=np.int64)
    rng = np.random.default_rng(3)
    for i in range(4):
        others = rng.integers(0, 256, (256, 3))
        b = np.insert(others, i, v & 0xFF, axis=1)
        word = (b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24)
        u = (word ^ 0x80808080).astype(np.uint32)
        got = _pack_upper_halves(_i8_f32_bits(u, i),
                                 _i8_f32_bits(u[::-1], i))
        assert np.array_equal(got & 0xFFFF, _bf16_bits(v))
        assert np.array_equal(got >> 16, _bf16_bits(v[::-1]))


def _gemv_model(x, w, plan):
    """The kernel's arithmetic, lane by lane, in float64: each warp's
    16-byte row pieces u[r] (rows 4t + r of a k16 step, columns 16 g ..
    16 g + 15 of its slab), the A fragments a0..a3 of tile j built from
    bytes j and 8 + j, the B fragments from x[8 p + g][4t .. 4t+3], the
    PTX m16n8k16 product (A row-major, B column-major, C 16 x 8), and
    the epilogue's float4 stores of c0..c3 into red[row][column]."""
    m, k = x.shape
    n = w.shape[1]
    steps = -(-k // 16)
    kp = np.zeros((16 * steps + 16, n + 128 * plan.warps_n))
    kp[:k, :n] = w
    xp = np.zeros((8 * plan.planes, 16 * steps + 16))
    xp[:m, :k] = x
    out = np.zeros((8 * plan.planes, kp.shape[1]))
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for slab in range(-(-n // 128)):
        c0 = 128 * slab
        for step in range(steps):
            k0 = 16 * step
            u = {(g, t): kp[k0 + 4 * t: k0 + 4 * t + 4, c0 + 16 * g:
                            c0 + 16 * g + 16] for g, t in lanes}
            for p in range(plan.planes):
                xs = {(g, t): xp[8 * p + g, k0 + 4 * t: k0 + 4 * t + 4]
                      for g, t in lanes}
                for j in range(8):
                    a = np.zeros((16, 16))
                    b = np.zeros((16, 8))
                    for g, t in lanes:
                        reg = u[g, t]
                        for h in range(2):
                            a[g, 2 * t + h] = reg[h, j]  # a0
                            a[g + 8, 2 * t + h] = reg[h, 8 + j]  # a1
                            a[g, 2 * t + 8 + h] = reg[2 + h, j]  # a2
                            a[g + 8, 2 * t + 8 + h] = reg[2 + h, 8 + j]  # a3
                            b[2 * t + h, g] = xs[g, t][h]  # b0
                            b[2 * t + 8 + h, g] = xs[g, t][2 + h]  # b1
                    d = a @ b
                    for g, t in lanes:
                        c = (d[g, 2 * t], d[g, 2 * t + 1], d[g + 8, 2 * t],
                             d[g + 8, 2 * t + 1])
                        for h in range(2):  # rows 8 p + 2 t + h
                            for q in range(4):  # float4 q: 4 columns
                                if j // 4 == q % 2:
                                    col = c0 + 16 * g + 4 * q + j % 4
                                    out[8 * p + 2 * t + h, col] += c[
                                        2 * (q // 2) + h]
    return out[:m, :n]


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (8, 48, 256), (16, 32, 384),
                                   (13, 20, 128)])
def test_gemv_fragment_maps_compute_x_times_w(m, k, n):
    """The lane/register maps of the GEMV, run in float64 on random
    integer tiles, give x @ W exactly (K ragged at 20 and 48)."""
    rng = np.random.default_rng(m * 1000 + k)
    x = rng.integers(-8, 9, (m, k)).astype(np.float64)
    w = rng.integers(-128, 128, (k, n)).astype(np.float64)
    plan = TI.gemv_sm90_plan(m, k, n, 132)
    np.testing.assert_array_equal(_gemv_model(x, w, plan), x @ w)


@pytest.mark.parametrize("warps_n", [1, 2, 4, 8])
def test_gemv_shared_memory_maps(warps_n):
    """Each W chunk a thread copies lands where the lane that needs it
    reads (the copy and read swizzles agree), every chunk of a stage is
    copied once, a quarter-warp's 16-byte reads hit 8 distinct bank
    groups, and each x piece is read from where it was copied."""
    warps_k = 8 // warps_n
    width = 128 * warps_n
    chunks = width // 16

    def swz(r, ch):
        return r * width + ((ch ^ (2 * ((r // 4) % 4))) << 4)

    written = {}
    for tid in range(256):
        for j in range(4):  # kChunks
            r = tid // chunks + j * (256 // chunks)
            ch = tid % chunks
            assert (r, ch) not in written
            written[(r, ch)] = swz(r, ch)
    assert len(written) == 16 * warps_k * chunks
    assert len(set(written.values())) == len(written)
    for warp in range(8):
        sn, wk = warp // warps_k, warp % warps_k
        for r in range(4):
            offs = []
            for lane in range(32):
                g, t = lane // 4, lane % 4
                read = ((16 * wk + 4 * t) * width
                        + (((8 * sn + g) ^ (2 * t)) << 4) + r * width)
                assert read == written[(16 * wk + 4 * t + r, 8 * sn + g)]
                offs.append(read)
            for quarter in range(4):
                banks = {o // 16 % 8 for o in offs[8 * quarter:
                                                   8 * quarter + 8]}
                assert len(banks) == 8
    for planes in (1, 2):
        for i in range(warps_k * planes * 32):  # copy side
            j, p, l = i // (32 * planes), (i // 32) % planes, i % 32
            assert (j * planes + p) * 32 + l == i
            read = (j * planes * 32 + l) * 8 + p * 256  # warp j, lane l
            assert read == 8 * i


def _bf16_row_bar(got, want):
    """Two bf16 ulps of each row's largest |want| plus rtol 2e-2."""
    top = np.abs(want).max(axis=-1, keepdims=True)
    ulp = np.where(top > 0, np.exp2(np.floor(np.log2(np.where(
        top > 0, top, 1))) - 7), 0)
    assert np.all(np.abs(got - want) <= 2 * ulp + 2e-2 * np.abs(want))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 8, 13, 16])
def test_decode_rows_match_jax(m, dtype):
    """The port's int8 product at decode row counts against JAX's
    int8_matmul on the same numpy-seeded inputs: fp32 within 1e-5 of
    the largest |output|, bf16 within the per-row bf16 bar."""
    x, w_q, scale = _inputs(40 + m, m, 256, 384)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = np.asarray(JI.int8_matmul(
        jx, jnp.asarray(w_q), jnp.asarray(scale))).astype(np.float32)
    got = TI.int8_matmul(tx, torch.from_numpy(w_q),
                         torch.from_numpy(scale)).float().numpy()
    assert got.shape == want.shape == (m, 384)
    if dtype == "fp32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        _bf16_row_bar(got, want)
