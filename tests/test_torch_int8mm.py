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


@pytest.mark.parametrize("m", [1, 3, 8, 24, 32, 64, 96, 128, 130])
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
    (17, 64, 128, torch.bfloat16, 0, 0, "gemv_sm90"),
    (1024, 4096, 14336, torch.bfloat16, 0, 0, "sm90"),
    (17, 136, 144, torch.bfloat16, 0, 0, "gemv_sm90"),
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
    (17, 4096, 14336, torch.bfloat16, 0, 0, "gemv_sm90"),
] + [
    (m, k, n, torch.bfloat16, 0, 0, "gemv_sm90")
    for m in (24, 32, 33, 48, 64) for k, n in DECODE_KN
] + [
    (65, 4096, 14336, torch.bfloat16, 0, 0, "gemv_sm90"),
    (32, 4096, 14336, torch.float32, 0, 0, "sgemm"),
    (64, 4096, 14336, torch.bfloat16, 2, 0, "wmma"),
    (64, 4096, 14336, torch.bfloat16, 4, 0, "gemv_sm90"),
    (64, 136, 144, torch.bfloat16, 0, 0, "gemv_sm90"),
    (48, 4098, 1024, torch.bfloat16, 0, 0, "wmma"),
] + [
    (m, k, n, torch.bfloat16, 0, 0, "gemv_sm90")
    for m in (96, 128) for k, n in DECODE_KN
] + [
    (129, 4096, 14336, torch.bfloat16, 0, 0, "sm90"),
    (129, 4096, 1024, torch.bfloat16, 0, 0, "sm90"),
    (96, 4096, 14336, torch.bfloat16, 2, 0, "wmma"),
    (128, 4096, 14336, torch.float32, 0, 0, "sgemm"),
], ids=["m1", "m16", "m16_fp32", "m17", "prefill", "ragged_aligned",
        "k130", "n300", "n136", "x_unaligned", "w_unaligned", "m17_fp32",
        "fp32_unaligned"] + [
    f"decode_m{m}_{k}x{n}" for m in (1, 8, 13, 16) for k, n in DECODE_KN
] + ["decode_fp32", "decode_fp32_m1", "decode_w_unaligned",
     "decode_n_odd", "decode_k_odd", "decode_x_4byte", "decode_x_8byte",
     "decode_m17"] + [
    f"wide_m{m}_{k}x{n}" for m in (24, 32, 33, 48, 64) for k, n in DECODE_KN
] + ["m65", "m32_fp32", "wide_x_4byte", "wide_x_8byte", "wide_ragged",
     "wide_k_odd"] + [
    f"wide128_m{m}_{k}x{n}" for m in (96, 128) for k, n in DECODE_KN
] + ["m129", "m129_wk", "wide128_x_4byte", "m128_fp32"])
def test_int8mm_route(m, k, n, dtype, x_off, w_off, route):
    """gemv_sm90 for bf16 with M <= 128, K % 4 == 0, N % 16 == 0, x
    8-byte and w_q 16-byte aligned; gemv for any other M <= 16; sgemm
    for fp32 above; sm90 for bf16 with K % 8 == 0, N % 16 == 0 and x,
    w_q 16-byte aligned; wmma for the rest. Since the GEMV's wgmma body,
    bf16 at 17 <= M <= 128 (a w8 engine of 17-128 slots decoding) takes
    gemv_sm90, the m17 and m65 cases included; M = 129 takes the tile."""
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

PLAN_SHAPES = [(m, k, n) for m in (1, 8, 13, 16, 17, 32, 33, 64, 65, 96,
                                    128)
               for k, n in DECODE_KN] + [
    (m, k, n) for m in (1, 9, 17, 33) for k, n in (
        (64, 96), (100, 48), (1000, 336), (4100, 1040), (16, 16),
        (4, 2048), (40960, 128), (4096, 1024 * 140))]


def _cta_steps_of(plan, steps):
    """The k16 steps of every CTA of a cluster, rank by rank, as the
    kernel walks them: stage s, step slot wk of rank r takes step
    r * cta_steps + warps_k * s + wk while below its rank's end (at 4
    and 8 planes slot wk is share wk % shares' step (wk // shares) of
    the stage: the same set)."""
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
    assert plan.planes == next(p for p in (1, 2, 4, 8, 16) if m <= 8 * p)
    assert plan.warps_n * plan.warps_k == 8 and plan.warps_n in (1, 2, 4, 8)
    assert 1 <= plan.cluster <= 8
    if plan.planes <= 2:
        assert plan.tiles == 8
    else:
        # A warpgroup's 64-column blocks: 2 a warp at one slab (the two
        # warpgroups split the steps), else one a slab, at most 4 at 8
        # planes (32 accumulator registers a slab) and 2 at 16 (64); the
        # warps of each share of the steps cover the block's columns
        # once.
        assert plan.tiles == max(2, plan.warps_n)
        assert plan.tiles <= {4: 8, 8: 4, 16: 2}[plan.planes]
        units = 128 * plan.warps_n // (16 * plan.tiles)
        assert (units, 8 // units) in ((4, 2), (8, 1))
    slabs = -(-n // 128)
    cols = [y * plan.warps_n + sn for y in range(plan.col_ctas)
            for sn in range(plan.warps_n)]
    assert sorted(c for c in cols if c < slabs) == list(range(slabs))
    assert (plan.col_ctas - 1) * plan.warps_n < slabs
    steps = -(-k // 16)
    per_rank = _cta_steps_of(plan, steps)
    assert all(per_rank), "a rank without steps"
    assert [s for r in per_rank for s in r] == list(range(steps))


@pytest.mark.parametrize("m", [1, 8, 13, 16, 17, 32, 33, 64, 65, 96, 128])
def test_gemv_sm90_plan_fills_one_wave(m):
    """One wave of at most one CTA an SM (clusters within three
    quarters of the SMs), at least 96 CTAs at gate/up, wq/wo, down and
    the lm_head and 64 at wk/wv (the old GEMV's grid held 32 there).
    At 8 planes the lm_head's 1002 slabs take the widest block the
    planes allow (4 slabs) in two waves of whole CTAs, at 16 planes (2
    slabs) in four. At 16 planes gate/up takes 112 one-slab CTAs, down
    and wq/wo 16 two-slab columns in clusters of 6, wk/wv 8 one-slab
    columns in clusters of 8."""
    for k, n in DECODE_KN:
        plan = TI.gemv_sm90_plan(m, k, n, 132)
        if plan.planes >= 8 and n == 128256:
            want = (4, 1, 251) if plan.planes == 8 else (2, 1, 501)
            assert (plan.warps_n, plan.cluster, plan.ctas) == want
            continue
        if plan.planes == 16:
            assert (plan.warps_n, plan.cluster, plan.ctas) == {
                (4096, 14336): (1, 1, 112), (4096, 4096): (2, 6, 96),
                (4096, 1024): (1, 8, 64), (14336, 4096): (2, 6, 96),
            }[(k, n)]
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


# --- the decode GEMV's wgmma body (4, 8, 16 planes, 17 <= M <= 128) -----

def _forced_plan(m, k, n, warps_n, cluster):
    """The wrapper's plan with its block width and cluster replaced, as
    the kernel takes any such plan (the model runs every width)."""
    steps = -(-k // 16)
    cta_steps = -(-steps // cluster)
    planes = TI.gemv_sm90_planes(m)
    return TI.GemvPlan(
        planes=planes, warps_n=warps_n, warps_k=8 // warps_n,
        cluster=-(-steps // cta_steps), col_ctas=-(-(-(-n // 128)) // warps_n),
        cta_steps=cta_steps, stages=-(-cta_steps // (8 // warps_n)),
        tiles=max(2, warps_n))


def _wg_w_offset(r, ch, width):
    """Where 16-byte W chunk ch of stage row r sits (the .cu's w_off)."""
    return r * width + ((ch ^ (2 * ((r // 2) % 4))) << 4)


def _wg_x_offset(m, p, warps_k, kn):
    """Where x piece p (4 k) of row m sits in the stage, past W (x_off)."""
    return ((p // 16) * (kn * 128) + m * 128
            + ((((p % 16) // 2) ^ (m % 8)) << 4) + 8 * (p % 2))


def _wg_b_address(j, nn, kk, kn):
    """The byte the wgmma B descriptor of stage step j reads for x row
    nn, k kk: start kWBytes-relative block (j // 4) plus 32 (j % 4),
    8-row groups 1024 bytes apart (sbo), the 128-byte swizzle applied to
    the address (its bits 4-6 XOR bits 7-9; the block is 1024-aligned)."""
    logical = (j // 4) * (kn * 128) + nn * 128 + (j % 4) * 32 + 2 * kk
    return logical ^ (((logical >> 7) & 7) << 4)


def _wgmma_model(x, w, plan):
    """The wgmma body's arithmetic in float64, written out from
    csrc/int8mm_gemv_sm90.cu: every CTA's ring stages filled by the
    threads' copies (W chunks and x pieces at their swizzled offsets,
    zeros past K, M and N), each lane's W words read at its address,
    A fragments (a0..a3 of tile b from bytes b and TILES + b of rows 2t,
    2t + 1, 2t + 8, 2t + 9), x^T read through the B descriptor, the PTX
    m64nNk16 product, the accumulator fragment stored into red, the
    shares and the cluster's ranks summed in order, scaled columns."""
    m, k = x.shape
    n = w.shape[1]
    kn = 8 * plan.planes
    tiles = plan.tiles
    cw = 16 * tiles
    width = 128 * plan.warps_n
    warps_k = plan.warps_k
    units = width // cw
    shares = 8 // units
    k_steps = 8 // tiles
    steps = -(-k // 16)
    w_bytes = 16 * warps_k * width
    assert w_bytes == 16384
    out = np.zeros((m, n))
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for y in range(plan.col_ctas):
        col0 = y * width
        reds = []
        for rank in range(plan.cluster):
            begin = rank * plan.cta_steps
            end = min(steps, begin + plan.cta_steps)
            k_end = min(k, 16 * end)
            n_stages = max(0, -(-(end - begin) // warps_k))
            # acc[warp, b, A row of the warp's 16, x row]
            acc = np.zeros((8, tiles, 16, kn))
            for s in range(n_stages):
                wst = np.zeros(w_bytes, dtype=np.int64)
                xst = np.zeros(kn * 128 * -(-warps_k // 4) // 2)
                chunks = width // 16
                for tid in range(256):
                    ch = tid % chunks
                    for j in range(4):
                        r = tid // chunks + j * (256 // chunks)
                        row = 16 * (begin + warps_k * s) + r
                        off = _wg_w_offset(r, ch, width)
                        if col0 + 16 * ch < n and row < k_end:
                            seg = np.zeros(16, dtype=np.int64)
                            cols = w[row, col0 + 16 * ch: col0 + 16 * ch + 16]
                            seg[:len(cols)] = cols
                            wst[off: off + 16] = seg
                for i in range(kn * 4 * warps_k):
                    mm, p = i // (4 * warps_k), i % (4 * warps_k)
                    kk = 16 * (begin + warps_k * s) + 4 * p
                    off = _wg_x_offset(mm, p, warps_k, kn)
                    assert off % 8 == 0
                    if mm < m and kk < k_end:
                        xst[off // 2: off // 2 + 4] = x[mm, kk: kk + 4]
                for warp in range(8):
                    u, wk = warp % units, warp // units
                    for i in range(k_steps):
                        j = wk + shares * i
                        bmat = np.zeros((16, kn))
                        for nn in range(kn):
                            for kk in range(16):
                                bmat[kk, nn] = xst[_wg_b_address(
                                    j, nn, kk, kn) // 2]
                        a_tiles = np.zeros((tiles, 16, 16))
                        for g, t in lanes:
                            colb = u * cw + 2 * tiles * g
                            base = (2 * t * width
                                    + (((colb // 16) ^ (2 * t)) << 4)
                                    + colb % 16)
                            rows = []
                            for r in range(4):
                                addr = base + (16 * j + r % 2
                                               + 8 * (r // 2)) * width
                                rows.append(wst[addr: addr + 2 * tiles])
                            for b in range(tiles):
                                for h in range(2):
                                    a_tiles[b, g, 2 * t + h] = rows[h][b]
                                    a_tiles[b, g + 8, 2 * t + h] = (
                                        rows[h][tiles + b])
                                    a_tiles[b, g, 2 * t + 8 + h] = (
                                        rows[2 + h][b])
                                    a_tiles[b, g + 8, 2 * t + 8 + h] = (
                                        rows[2 + h][tiles + b])
                        for b in range(tiles):
                            acc[warp, b] += a_tiles[b] @ bmat
            # red[warp][row][column of its cw]: lane (g, t), element
            # 4p + e of tile b is A row g + 8 (e // 2), x row
            # 8p + 2t + e % 2; A row g is column 2 tiles g + b, row g + 8
            # column 2 tiles g + tiles + b.
            red = np.zeros((8, kn, cw))
            for warp in range(8):
                for g, t in lanes:
                    for p in range(plan.planes):
                        for h in range(2):
                            for c in range(tiles // 2):
                                for e in range(4):
                                    yy = 4 * c + e
                                    b, hi = yy % tiles, yy // tiles
                                    red[warp, 8 * p + 2 * t + h,
                                        2 * tiles * g + 4 * c + e] = acc[
                                        warp, b, g + 8 * hi, 8 * p + 2 * t + h]
            summed = red[:units].copy()
            for sh in range(1, shares):
                summed += red[sh * units: (sh + 1) * units]
            reds.append(summed)
        total = reds[0].copy()
        for r in reds[1:]:
            total += r
        for uu in range(units):
            for c in range(cw):
                col = col0 + uu * cw + c
                if col < n:
                    out[:, col] = total[uu, :m, c]
    return out


WG_MODEL_SHAPES = [(17, 48, 128), (32, 64, 256), (33, 20, 128),
                   (64, 96, 384), (65, 20, 128), (128, 40, 256)]


# (M, K, N, warps_n): the wrapper's plan (None) and every block width
# the planes allow (8 slabs at 4 planes only, 1 and 2 at 16).
WG_MODEL_CASES = [
    (m, k, n, warps_n) for m, k, n in WG_MODEL_SHAPES
    for warps_n in (None, 1, 2, 4, 8)
    if not (m > 32 and warps_n == 8) and not (m > 64 and warps_n == 4)]


@pytest.mark.parametrize("m,k,n,warps_n", WG_MODEL_CASES, ids=[
    f"m{m}_{k}x{n}_" + ("plan" if w is None else f"{w}slabs")
    for m, k, n, w in WG_MODEL_CASES])
def test_gemv_wgmma_maps_compute_x_times_w(m, k, n, warps_n):
    """The wgmma body's lane, register and shared-memory maps, run in
    float64 on random integer tiles, give x @ W exactly: under the
    wrapper's plan and at every block width the planes allow (1 slab:
    the warpgroups split each stage's steps; 2 and 4: one 64-column
    block a slab; 8 at 4 planes; 1 and 2 at 16 planes, M = 65 and 128),
    K ragged at 20, 40 and 48, two ranks a cluster where K has two k16
    steps or more."""
    plan = TI.gemv_sm90_plan(m, k, n, 132)
    if warps_n is not None:
        plan = _forced_plan(m, k, n, warps_n, min(2, -(-k // 16)))
    assert plan.planes in (4, 8, 16)
    rng = np.random.default_rng(m * 1000 + k)
    x = rng.integers(-8, 9, (m, k)).astype(np.float64)
    w = rng.integers(-128, 128, (k, n)).astype(np.float64)
    np.testing.assert_array_equal(_wgmma_model(x, w, plan), x @ w)


@pytest.mark.parametrize("warps_n", [1, 2, 4, 8])
def test_gemv_wgmma_shared_memory_maps(warps_n):
    """At 4 and 8 planes: each W chunk a thread copies lands where the
    lanes that need it read (copy and read swizzles agree, every chunk
    of a stage copied once); a warp's W reads hit every bank once a
    wavefront (4-byte words: 32 lanes; 8 bytes: 16; 16 bytes: 8); every
    x piece lands where the B descriptor reads its 4 k, no two pieces
    overlap, and each block of x is 1024-byte aligned in the stage."""
    warps_k = 8 // warps_n
    width = 128 * warps_n
    chunks = width // 16
    tiles = max(2, warps_n)
    cw = 16 * tiles
    units = width // cw
    shares = 8 // units
    written = {}
    for tid in range(256):
        for j in range(4):
            r = tid // chunks + j * (256 // chunks)
            ch = tid % chunks
            assert (r, ch) not in written
            written[(r, ch)] = _wg_w_offset(r, ch, width)
    assert len(written) == 16 * warps_k * chunks
    assert len(set(written.values())) == len(written)
    where = {off + b: (r, 16 * ch + b) for (r, ch), off in written.items()
             for b in range(16)}
    lane_bytes = 2 * tiles
    per_wave = {4: 32, 8: 16, 16: 8}[lane_bytes]
    for warp in range(8):
        u, wk = warp % units, warp // units
        for i in range(8 // tiles):
            j = wk + shares * i
            for r in range(4):
                row = 16 * j + r % 2 + 8 * (r // 2)  # less 2t
                offs = []
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    colb = u * cw + 2 * tiles * g
                    addr = ((2 * t + row) * width
                            + (((colb // 16) ^ (2 * t)) << 4) + colb % 16)
                    for b in range(lane_bytes):
                        assert where[addr + b] == (row + 2 * t, colb + b)
                    offs.append(addr)
                for wave in range(0, 32, per_wave):
                    banks = [(o // 4 + q) % 32 for o in offs[wave:
                                                             wave + per_wave]
                             for q in range(lane_bytes // 4)]
                    assert len(set(banks)) == 32
    for planes in (4, 8, 16):
        if planes == 16 and warps_n > 2:
            continue
        kn = 8 * planes
        assert (kn * 128) % 1024 == 0 and 16384 % 1024 == 0
        # The CTA's shared memory (smem_bytes): 1 KB to align the ring,
        # then the ring (5 stages, 4 at 16 planes: wg_ring) or the warps'
        # sums, whichever is larger, within the 227 KB less the static
        # barriers' 1 KB that a CTA may ask for.
        if warps_n in TI._GEMV_SM90_WIDTHS[planes]:
            stage = 16384 + kn * 128 * -(-warps_k // 4)
            ring = (4 if planes == 16 else 5) * stage
            sums = 8 * kn * cw * 4
            assert 1024 + max(ring, sums) <= 232448 - 1024
        # A thread's pieces h (i = tid + 256 h) share p and step rows by
        # 64 / warps_k, a multiple of 8: the .cu's x_off0 + h x_rstep 128.
        rstep = 64 // warps_k
        assert rstep % 8 == 0
        for i in range(kn * 4 * warps_k):
            tid, h = i % 256, i // 256
            m0, p0 = tid // (4 * warps_k), tid % (4 * warps_k)
            assert (i // (4 * warps_k), i % (4 * warps_k)) == (
                m0 + h * rstep, p0)
            assert _wg_x_offset(m0 + h * rstep, p0, warps_k, kn) == (
                _wg_x_offset(m0, p0, warps_k, kn) + h * rstep * 128)
        seen = set()
        for i in range(kn * 4 * warps_k):
            mm, p = i // (4 * warps_k), i % (4 * warps_k)
            off = _wg_x_offset(mm, p, warps_k, kn)
            assert off not in seen
            seen.add(off)
            for e in range(4):  # piece p holds k 4p .. 4p + 3 of row mm
                kk = 4 * p + e
                assert _wg_b_address(kk // 16, mm, kk % 16, kn) == off + 2 * e
