"""The port's fused decode MLP held to the JAX op on the CPU.

``torch`` (the twin of ``_xla_decode_mlp``) and ``reference`` (the twin
of the fp32 oracle) against JAX's xla, reference and Pallas-interpret
paths at d=256, ffn=512, B in {4, 1, 8, 13, 16, 32, 64, 96, 128, 200}
(96 and 128: one launch of the card's tensor-core kernel at 16 planes,
two blocks of its fp32 kernel; 200: two blocks of 128 rows), fp32 and
bf16, on the same
numpy-seeded inputs. The fp32 bar is the one
tests/test_workloads.py holds the Pallas kernel to: relative error
below 1e-5. The bf16 bar is 2e-2 of the largest |output|: the plain
chain rounds gate and up to bf16 before silu, the Pallas body keeps
them in fp32.

The tensor-core kernel (csrc/decode_mlp_sm90.cu) runs only on the card;
here its plan (``mlp_sm90_plan``), its route (``_decode_mlp_route``), the
row blocks a call launches (``row_blocks``) and a numpy model of its
data movement (copies into the swizzled ring, ldmatrix.trans and
B-fragment lane maps over 1, 2, 4 or 8 planes of rows, the m16n8k16
product, the wgmma descriptors at 4, 8 and 16 planes with the two
warpgroups' row halves at 16, the warp and cluster reductions) are
held to x @ W and to the Pallas body.
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


BF16_REL = 2e-2


def _twin_case(seed, b, dtype):
    """The port's torch and reference impls against JAX's xla,
    reference and Pallas-interpret paths on one input, in fp32 (bar
    REL) or bf16 (bar BF16_REL), both relative to the largest
    |output|."""
    x, scale, ws = _inputs(seed, b=b)
    if dtype == "bf16":
        ws = {k: v * np.float32(0.05) for k, v in ws.items()}
    jconv = (jnp.asarray if dtype == "fp32"
             else lambda a: jnp.asarray(a).astype(jnp.bfloat16))
    tconv = (torch.from_numpy if dtype == "fp32"
             else lambda a: torch.from_numpy(a).to(torch.bfloat16))
    jx, js, jt = jconv(x), jconv(scale), _tree(ws, jconv)
    want = {
        "xla": JDM.decode_mlp(jx, js, jt, EPS, impl="xla"),
        "reference": JDM.decode_mlp(jx, js, jt, EPS, impl="reference"),
        "pallas": JDM.decode_mlp(jx, js, jt, EPS, impl="pallas", block_f=128),
    }
    tx, ts, tt = tconv(x), tconv(scale), _tree(ws, tconv)
    bar = REL if dtype == "fp32" else BF16_REL
    for impl in ("torch", "reference"):
        got = TDM.decode_mlp(tx, ts, tt, EPS, impl=impl).float().numpy()
        assert TDM._LAST_DECODE_MLP_IMPL == impl
        for jimpl, ref in want.items():
            ref = np.asarray(ref.astype(jnp.float32))
            rel = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
            assert rel < bar, f"{dtype} b={b} {impl} vs {jimpl}: rel {rel}"


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_mlp_matches_jax(monkeypatch, seed):
    """At B = 4, at the tensor-core kernel's row counts 1, 8, 13, 16,
    32, 64, 96 and 128, and at 200 (two row blocks on the card), fp32
    and bf16."""
    monkeypatch.setattr(JA, "_INTERPRET", True)
    for b in (4, 1, 8, 13, 16, 32, 64, 96, 128, 200):
        for dtype in ("fp32", "bf16"):
            _twin_case(seed, b, dtype)


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


# --- the tensor-core kernel (csrc/decode_mlp_sm90.cu): plan, route and a
# model of its data movement ------------------------------------------

PLAN_SHAPES = [(b, d, f) for b in (1, 8, 13, 16, 17, 32, 64, 65, 96, 128)
               for d, f in ((4096, 14336), (64, 128))]
PLANES = {1: 1, 8: 1, 13: 2, 16: 2, 17: 4, 32: 4, 64: 8, 65: 16, 96: 16,
          128: 16}


def _rank_steps(pp, steps):
    """The k16 steps each (rank, warp slot) of a pass takes, as the
    kernel walks them: stage s, step j = wk + warps_k i of the stage's
    rows / 16, while below its rank's end."""
    sps = pp.rows // 16
    out = []
    for rank in range(pp.cluster):
        begin = rank * pp.cta_steps
        end = min(steps, begin + pp.cta_steps)
        out.append(sorted(
            begin + sps * s + wk + pp.warps_k * i
            for s in range(pp.stages) for wk in range(pp.warps_k)
            for i in range(sps // pp.warps_k)
            if begin + sps * s + wk + pp.warps_k * i < end))
    return out


@pytest.mark.parametrize("b,d,ffn", PLAN_SHAPES,
                         ids=[f"b{b}_{d}x{f}" for b, d, f in PLAN_SHAPES])
def test_mlp_sm90_plan_covers_every_column_and_k_once(b, d, ffn):
    """Each pass: every 16-column tile of N belongs to one warp of one
    CTA column, the ranks' K ranges tile [0, ceil(K / 16)) k16 steps in
    rank order and each warp slot takes its share of every stage once
    (at 16 planes each of the two row groups takes every step of its
    rows); the ring and xn's rows fit shared memory, and so do the
    warps' sums that overlay them (at 16 planes a tile's two warps share
    a slot); a cluster is portable; at most one CTA an SM."""
    plan = TDM.mlp_sm90_plan(b, d, ffn, 132)
    assert plan.planes == PLANES[b] == TDM.planes_of(b)
    for pp, k, n, gate_up in ((plan.gate_up, d, ffn, True),
                              (plan.down, ffn, d, False)):
        assert pp.width in (64, 128) and pp.warps_n == pp.width // 16
        assert pp.row_groups == (2 if plan.planes == 16 else 1)
        if pp.row_groups == 2:
            assert pp.width == 64 and pp.warps_k == 1
        assert pp.warps_n * pp.warps_k * pp.row_groups == 8
        assert pp.rows == 16384 // ((2 if gate_up else 1) * pp.width * 2)
        assert (pp.rows // 16) % pp.warps_k == 0
        assert 1 <= pp.cluster <= 8 and 3 <= pp.slots <= 8
        assert pp.smem <= 232448 - 1024
        assert pp.smem >= (8 // pp.row_groups * (2 if gate_up else 1) * 8
                           * plan.planes * 64)
        tiles = [y * pp.width + 16 * sn for y in range(pp.col_ctas)
                 for sn in range(pp.warps_n)]
        assert [c for c in tiles if c < n] == list(range(0, n, 16))
        assert (pp.col_ctas - 1) * pp.width < n
        steps = -(-k // 16)
        per_rank = _rank_steps(pp, steps)
        assert all(per_rank), "a rank without steps"
        assert [s for r in per_rank for s in r] == list(range(steps))


@pytest.mark.parametrize("b", [1, 8, 13, 16, 65, 96, 128])
def test_mlp_sm90_plan_fills_one_wave(b):
    """At Llama-3-8B widths each pass is one wave of at most one CTA an
    SM (grids of clusters larger than 2 within three quarters of the
    SMs): gate/up on 112 CTAs of 128 columns, down on 128 CTAs of 64
    columns in clusters of 2, its K split in halves. At 16 planes (65 to
    128 rows) a CTA is 64 columns, so down keeps its one wave and
    gate/up takes the fewest CTAs there are, 224 (ffn / 64, no K split:
    1.7 waves of one CTA an SM)."""
    plan = TDM.mlp_sm90_plan(b, 4096, 14336, 132)
    assert plan.down.ctas <= 132 and plan.down.cluster <= 2
    assert plan.down.ctas == 128 and plan.down.cluster == 2
    if plan.planes == 16:
        assert plan.gate_up.ctas == 224 and plan.gate_up.cluster == 1
        assert plan.gate_up.width == plan.down.width == 64
        return
    assert plan.gate_up.ctas <= 132
    assert plan.gate_up.ctas == 112 and plan.gate_up.cluster == 1


def test_mlp_sm90_plan_refuses_more_rows_than_a_launch_takes():
    """A plan is one launch's: 1..128 rows; larger batches are planned
    a row block at a time."""
    for b in (0, 129, 200):
        with pytest.raises(ValueError, match="rows"):
            TDM.mlp_sm90_plan(b, 4096, 14336, 132)
    assert TDM.mlp_sm90_plan(128, 4096, 14336, 132).planes == 16


def test_mlp_sm90_plan_reads_only_its_arguments(monkeypatch):
    """The plan is a function of (B, d, ffn, SM count): no device
    query."""
    monkeypatch.setattr(TDM, "_sm_count", None)
    TDM.mlp_sm90_plan.cache_clear()
    small = TDM.mlp_sm90_plan(8, 4096, 14336, 66)
    assert small.down.ctas <= 66
    # No gate/up grid of 128-column CTAs fits 66 SMs: the fewest CTAs.
    assert small.gate_up.ctas == 112 and small.gate_up.cluster == 1
    assert small == TDM.mlp_sm90_plan(8, 4096, 14336, 66)


def _route_tensors(b, d, ffn, dtype=torch.bfloat16, offset=0):
    """x [b, d] (``offset`` elements into its buffer) and the three
    weights, on the CPU."""
    buf = torch.zeros(b * d + offset, dtype=dtype)
    x = buf[offset:].view(b, d)
    ws = (torch.zeros(d, ffn, dtype=dtype), torch.zeros(d, ffn, dtype=dtype),
          torch.zeros(ffn, d, dtype=dtype))
    return x, ws


ROUTE_CASES = [
    ("bf16_b1", dict(b=1, d=256, ffn=512), "sm90"),
    ("bf16_b16", dict(b=16, d=256, ffn=512), "sm90"),
    ("bf16_tiny_llama", dict(b=3, d=64, ffn=128), "sm90"),
    ("bf16_b17", dict(b=17, d=256, ffn=512), "sm90"),
    ("bf16_b32", dict(b=32, d=256, ffn=512), "sm90"),
    ("bf16_b64", dict(b=64, d=256, ffn=512), "sm90"),
    ("bf16_b128_row_blocks", dict(b=128, d=256, ffn=512), "sm90"),
    ("bf16_b96", dict(b=96, d=256, ffn=512), "sm90"),
    ("bf16_b200_row_blocks", dict(b=200, d=256, ffn=512), "sm90"),
    ("fp32_b8", dict(b=8, d=256, ffn=512, dtype=torch.float32), "simt"),
    ("fp32_b16", dict(b=16, d=256, ffn=512, dtype=torch.float32), "simt"),
    ("fp32_b32", dict(b=32, d=256, ffn=512, dtype=torch.float32), "simt"),
    ("x_unaligned", dict(b=8, d=256, ffn=512, offset=1), "simt"),
    ("x_8_bytes_off", dict(b=8, d=256, ffn=512, offset=4), "simt"),
    ("x_16_bytes_off", dict(b=8, d=256, ffn=512, offset=8), "sm90"),
    ("d_odd", dict(b=8, d=100, ffn=512), "simt"),
    ("ffn_odd", dict(b=8, d=256, ffn=300), "simt"),
]


@pytest.mark.parametrize("dims,want", [c[1:] for c in ROUTE_CASES],
                         ids=[c[0] for c in ROUTE_CASES])
def test_decode_mlp_route(dims, want):
    """sm90 for bf16 at any B (in blocks of 128 rows), d and ffn
    multiples of 8, x and the weights 16-byte aligned; simt for fp32
    and the rest."""
    x, ws = _route_tensors(**dims)
    assert TDM._decode_mlp_route(x, ws) == want


def test_decode_mlp_route_needs_contiguous_bf16_weights():
    x, (wg, wu, wd) = _route_tensors(8, 256, 512)
    assert TDM._decode_mlp_route(x, (wg, wu, wd)) == "sm90"
    assert TDM._decode_mlp_route(x, (wg, wu, wd.t().contiguous().t())) == (
        "simt")
    assert TDM._decode_mlp_route(x, (wg, wu.float(), wd)) == "simt"
    # xn of a d too long for shared memory under any K split.
    x, ws = _route_tensors(16, 131072, 8)
    assert TDM._decode_mlp_route(x, ws) == "simt"


# b: the row blocks of each route (sm90: 128 rows a launch, simt: 64).
ROW_BLOCK_CASES = {
    1: {"sm90": [(0, 1)], "simt": [(0, 1)]},
    64: {"sm90": [(0, 64)], "simt": [(0, 64)]},
    65: {"sm90": [(0, 65)], "simt": [(0, 64), (64, 65)]},
    96: {"sm90": [(0, 96)], "simt": [(0, 64), (64, 96)]},
    128: {"sm90": [(0, 128)], "simt": [(0, 64), (64, 128)]},
    129: {"sm90": [(0, 128), (128, 129)],
          "simt": [(0, 64), (64, 128), (128, 129)]},
    200: {"sm90": [(0, 128), (128, 200)],
          "simt": [(0, 64), (64, 128), (128, 192), (192, 200)]},
}
# C entry: argument positions of (x, the output, the batch) and, at the
# down half, of act.
_ENTRY_ARGS = {
    "tpu_decode_mlp_sm90": (0, 7, 8, None),
    "tpu_decode_mlp": (0, 7, 9, None),
    "tpu_decode_mlp_sm90_gate_up": (0, 4, 6, None),
    "tpu_decode_mlp_gate_up": (0, 4, 6, None),
    "tpu_decode_mlp_sm90_down": (0, 3, 4, 1),
    "tpu_decode_mlp_down": (0, 4, 6, 1),
}


def _row_of(ptr, t):
    """The row of the [rows, cols] tensor t that ``ptr`` points at."""
    off = ptr - t.data_ptr()
    assert off % (t.stride(0) * t.element_size()) == 0, off
    return off // (t.stride(0) * t.element_size())


@pytest.mark.parametrize("b", sorted(ROW_BLOCK_CASES))
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "sm90"),
                                         (torch.float32, "simt")])
def test_decode_mlp_runs_row_blocks_of_64(monkeypatch, b, dtype, route):
    """A call over B rows launches its route's C entry once a block of
    consecutive rows, at most 128 on sm90 (the tensor-core kernel at 16
    planes) and 64 on simt (decode_mlp.cu): x, the output and (down
    half) act at the block's first row, the block's rows as the batch,
    one launch counted a block. So do the fused block and both halves on
    a model shard (gate/up writes act block by block, down reads it so).
    The C entries are stood in for by a recorder on CPU tensors."""
    assert TDM.row_blocks(b, route) == ROW_BLOCK_CASES[b][route]
    x, scale, ws = _inputs(40 + b, b=b, d=64, f=128)
    conv = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    tx, ts, tt = conv(x), conv(scale), _tree(ws, conv)
    wg, wu, wd = (tt[n]["kernel"] for n in ("w_gate", "w_up", "w_down"))
    calls = []

    def function(source, entry, argtypes):
        assert len(argtypes) > max(i for i in _ENTRY_ARGS[entry] if i)

        def fn(*args):
            calls.append((entry, args))
            return 0
        return fn

    monkeypatch.setattr(TDM, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(TDM, "_sm_count", lambda device: 132)
    monkeypatch.setattr(TDM.kernels, "function", function)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    assert TDM._decode_mlp_route(tx, (wg, wu, wd)) == route
    blocks = ROW_BLOCK_CASES[b][route]
    TDM.kernels.reset_launches()
    out = TDM._cuda_decode_mlp(tx, ts, wg, wu, wd, EPS)
    act = TDM._cuda_gate_up(tx, ts, wg, wu, EPS, wg.shape[1])
    half = TDM._cuda_down(tx, act, wd)
    prefix = "decode_mlp_sm90" if route == "sm90" else "decode_mlp"
    entries = [f"tpu_{prefix}", f"tpu_{prefix}_gate_up", f"tpu_{prefix}_down"]
    assert [e for e, _ in calls] == [e for e in entries for _ in blocks]
    for i, (entry, args) in enumerate(calls):
        lo, hi = blocks[i % len(blocks)]
        xi, oi, bi, ai = _ENTRY_ARGS[entry]
        dest = (out, act, half)[i // len(blocks)]
        assert (_row_of(args[xi], tx), _row_of(args[oi], dest),
                args[bi]) == (lo, lo, hi - lo), (entry, i)
        if ai is not None:
            assert _row_of(args[ai], act) == lo
    n = len(blocks)
    want = {"decode_mlp": n, "decode_mlp_sm90": n if route == "sm90" else 0,
            f"{prefix}_gate_up": n, f"{prefix}_down": n}
    assert {k: TDM.kernels.LAUNCHES[k] for k in want} == want


def _bf16(a):
    """float32 values rounded to bf16 (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        torch.bfloat16).float().numpy()


_LANES = np.arange(32)
_G, _T = _LANES // 4, _LANES % 4


def _b_chunk(wg, rows_pad, row_bytes, r, c):
    """Byte offset of 16-byte chunk c (8 k) of row r of a B operand
    (csrc/decode_mlp_sm90.cu b_chunk): rows of row_bytes at mma.sync, at
    wgmma K-major 128-byte-swizzled blocks of 64 k."""
    if wg:
        return (c // 8) * (rows_pad * 128) + r * 128 + (((c % 8) ^ (r % 8))
                                                        << 4)
    return r * row_bytes + 16 * c


def _pass_model(pp, planes, mats, operand, m_rows, k, n, acc_dtype):
    """One pass of csrc/decode_mlp_sm90.cu, CTA by CTA and lane by lane:
    returns the finished sums [m_rows, n] of each matrix in ``mats``
    (W [k, n]) against ``operand`` [m_rows, k] (xn at gate/up, act at
    down). Shared memory is modelled as one value per bf16 slot of each
    stage's byte image: the copies place 16-byte chunks where the
    kernel's threads do (swizzled), and the sums meet warps, then ranks,
    in order. At 1 and 2 planes the warps read A by the
    ldmatrix.x4.trans lane map and B by the ldmatrix.x4 (.x2) lane map,
    the products follow PTX m16n8k16; at 4 and 8 planes the operand's
    piece of each stage (xn's too, streamed as act's) is copied in
    K-major swizzled rows, each warpgroup reads A and B through its
    wgmma descriptors (A: the MN-major W block, transpose-A; B: the
    piece), and its m64nNk16 accumulator fragment lands in each warp's
    slot of the sums; at 16 planes the two warpgroups take one 64-column
    block, every k16 step and a half of the rows each (B from 64 rows x
    128 bytes on for the second), and a tile's two warps fill one
    slot."""
    gate_up = len(mats) == 2
    wg = planes >= 4
    rows_pad = 8 * planes
    split = pp.row_groups == 2  # the warpgroups split the rows
    wg_rows = rows_pad // pp.row_groups  # a warpgroup's rows
    rows = pp.rows
    sps = rows // 16
    steps = -(-k // 16)
    w_bytes = 16384
    p_row = -(-rows // 64) * 128 if wg else 2 * rows + 16
    cpr = pp.width // 8
    r_step = 256 // cpr
    tid = np.arange(256)
    ch, r0 = tid % cpr, tid // cpr
    q, rr = _LANES // 8, _LANES % 8
    wg_n = pp.width // 64
    out = np.zeros((len(mats), m_rows, n), dtype=np.float64)
    for y in range(pp.col_ctas):
        col0 = y * pp.width
        red = {}  # rank -> [warp slot, mat, row, 16]
        for rank in range(pp.cluster):
            begin = rank * pp.cta_steps
            end = min(steps, begin + pp.cta_steps)
            k_begin, k_end = 16 * begin, min(k, 16 * end)
            n_stages = -(-(end - begin) // sps) if end > begin else 0
            kc = n_stages * rows // 8
            xs_row = 16 * kc + 16
            xs = np.zeros((-(-kc // 8) * rows_pad * 128 if wg
                           else rows_pad * xs_row) // 2)
            if gate_up and not wg:  # the prologue's xn rows, by chunk
                for r in range(m_rows):
                    for c in range(kc):
                        kk = k_begin + 8 * c
                        if kk < k_end:
                            dst = _b_chunk(wg, rows_pad, xs_row, r, c) // 2
                            xs[dst:dst + 8] = operand[r, kk:kk + 8]
            acc = np.zeros((8, len(mats), planes, 16, 8), dtype=acc_dtype)
            dw = np.zeros((2, len(mats), 64, wg_rows), dtype=acc_dtype)
            for s in range(n_stages):
                img = np.zeros((w_bytes + rows_pad * p_row) // 2)
                for j in range(4):  # a thread's W chunks
                    mat = j // (4 // len(mats))
                    r = r0 + (j % (4 // len(mats))) * r_step
                    row = k_begin + s * rows + r
                    dst = (mat * rows * pp.width * 2 + (ch // 8) * rows * 128
                           + r * 128 + (((ch % 8) ^ (r % 8)) << 4))
                    for e in range(8):
                        col = col0 + 8 * ch + e
                        ok = (col0 + 8 * ch < n) & (row < k_end)
                        img[dst // 2 + e] = np.where(
                            ok, mats[mat][np.minimum(row, k - 1),
                                          np.minimum(col, n - 1)], 0.0)
                if not gate_up or wg:  # act's (xn's) piece of the stage
                    # thread tid: chunk tid % p_cpr of rows tid / p_cpr
                    # + j * 256 / p_cpr, j < ceil(rows_pad * 16 / 256)
                    p_cpr = rows // 8
                    written = set()
                    for tid_ in range(256):
                        for j in range(-(-rows_pad * 16 // 256)):
                            pr = tid_ // p_cpr + j * (256 // p_cpr)
                            c = tid_ % p_cpr
                            if pr >= rows_pad:
                                continue
                            assert (pr, c) not in written
                            written.add((pr, c))
                            kk = k_begin + s * rows + 8 * c
                            dst = (w_bytes + _b_chunk(wg, rows_pad, p_row,
                                                      pr, c)) // 2
                            img[dst:dst + 8] = (
                                operand[pr, kk:kk + 8]
                                if pr < m_rows and kk < k_end else 0.0)
                    assert len(written) == rows_pad * p_cpr
                if wg:  # each warpgroup's wgmma products
                    for wgi in range(2):
                        cb, kh = wgi % wg_n, wgi // wg_n
                        if split:  # block 0, every step, rows of half wgi
                            cb, kh = 0, 0
                        for i in range(sps // pp.warps_k):
                            jj = kh + pp.warps_k * i
                            kq = np.arange(16)
                            kr = 16 * jj + kq  # the stage's k rows
                            src, b0 = img, w_bytes  # the stage's piece
                            kk = 16 * jj + kq
                            nr = wgi * wg_rows * split + np.arange(wg_rows)
                            b_addr = (b0 + (kk[:, None] // 64)
                                      * (rows_pad * 128) + nr[None, :] * 128
                                      + ((((kk[:, None] % 64) // 8)
                                          ^ (nr[None, :] % 8)) << 4)
                                      + (kk[:, None] % 8) * 2) // 2
                            bmat = src[b_addr]  # 16 x wg_rows
                            mc = np.arange(64)
                            for mat in range(len(mats)):
                                a_addr = (mat * rows * pp.width * 2
                                          + cb * rows * 128
                                          + kr[None, :] * 128
                                          + (((mc[:, None] // 8)
                                              ^ (kr[None, :] % 8)) << 4)
                                          + (mc[:, None] % 8) * 2) // 2
                                amat = img[a_addr]  # 64 x 16
                                dw[wgi, mat] = (dw[wgi, mat] + amat @ bmat
                                                ).astype(acc_dtype)
                    continue
                for warp in range(8):
                    sn, wk = warp // pp.warps_k, warp % pp.warps_k
                    a_lane = ((sn // 4) * rows * 128 + (rr + 8 * (q // 2))
                              * 128 + (((2 * (sn % 4) + q % 2) ^ rr) << 4))
                    for i in range(4 // len(mats)):
                        jj = wk + pp.warps_k * i
                        # ldmatrix.x4 (x2 at one plane): lane l addresses
                        # row 8 (p + q / 2) + l % 8 at k chunk q % 2; lane
                        # (g, t) gets elements 2t, 2t + 1 of the row lane
                        # 8 q' + g gave, for each matrix q'.
                        bmat = np.zeros((planes, 16, 8))
                        for p in range(0, planes, 2):
                            mats_ = 2 if planes == 1 else 4
                            lrow = 8 * (p + q // 2) + rr
                            if gate_up:
                                addr = (xs_row * lrow + 16 * (q % 2)
                                        + 2 * (s * rows + 16 * jj)) // 2
                                src = xs
                            else:
                                addr = (w_bytes + lrow * p_row + 16 * (q % 2)
                                        + 32 * jj) // 2
                                src = img
                            for mq in range(mats_):
                                ld = src[addr[8 * mq + _G][:, None]
                                         + np.arange(8)]  # lane rows
                                for h in range(2):
                                    bmat[p + mq // 2, 2 * _T + h + 8 * (
                                        mq % 2), _G] = ld[np.arange(32),
                                                          2 * _T + h]
                        for mat in range(len(mats)):
                            addr = (mat * rows * pp.width * 2 + jj * 2048
                                    + a_lane) // 2
                            ld = img[addr[:, None] + np.arange(8)]  # 32 x 8
                            a = np.zeros((16, 16))
                            for h in range(2):
                                a[_G, 2 * _T + h] = ld[2 * _T + h, _G]
                                a[_G + 8, 2 * _T + h] = ld[8 + 2 * _T + h, _G]
                                a[_G, 2 * _T + 8 + h] = ld[16 + 2 * _T + h, _G]
                                a[_G + 8, 2 * _T + 8 + h] = ld[
                                    24 + 2 * _T + h, _G]
                            for p in range(planes):
                                acc[warp, mat, p] = (
                                    acc[warp, mat, p] + a @ bmat[p]
                                ).astype(acc_dtype)
            # The epilogue's stores: lane (g, t) c0..c3 at red[w][mat][row]
            # [column] (at wgmma, warp w of warpgroup (cb, kh) holds rows
            # 16 w .. 16 w + 15 of its m64 product: the tile 4 cb + w's
            # columns, slot (4 cb + w) warps_k + kh; at 16 planes slot w,
            # the warpgroup's rows), then the warps of a tile in order.
            rd = np.zeros((8, len(mats), rows_pad, 16), dtype=acc_dtype)
            for warp in range(8):
                if wg:
                    wgi, w = warp // 4, warp % 4
                    cb, kh = wgi % wg_n, wgi // wg_n
                    slot = (4 * cb + w) * pp.warps_k + kh
                    r0_ = 0
                    if split:
                        slot, r0_ = w, wgi * wg_rows
                    rd[slot][:, r0_:r0_ + wg_rows] = dw[wgi][
                        :, 16 * w:16 * w + 16, :].transpose(0, 2, 1)
                    continue
                for mat in range(len(mats)):
                    for p in range(planes):
                        d_ = acc[warp, mat, p]
                        rd[warp, mat, 8 * p + 2 * _T, _G] = d_[_G, 2 * _T]
                        rd[warp, mat, 8 * p + 2 * _T + 1, _G] = d_[
                            _G, 2 * _T + 1]
                        rd[warp, mat, 8 * p + 2 * _T, _G + 8] = d_[
                            _G + 8, 2 * _T]
                        rd[warp, mat, 8 * p + 2 * _T + 1, _G + 8] = d_[
                            _G + 8, 2 * _T + 1]
            for sn in range(pp.warps_n):
                w0 = sn * pp.warps_k
                for i in range(1, pp.warps_k):
                    rd[w0] = (rd[w0] + rd[w0 + i]).astype(acc_dtype)
            red[rank] = rd
        for sn in range(pp.warps_n):
            for c in range(16):
                col = col0 + 16 * sn + c
                if col >= n:
                    continue
                v = np.zeros((len(mats), m_rows), dtype=acc_dtype)
                for rank in range(pp.cluster):
                    v = (v + red[rank][sn * pp.warps_k, :, :m_rows, c]
                         ).astype(acc_dtype)
                out[:, :, col] = v
    return out


MODEL_CASES = [(1, 64, 128, 132), (8, 48, 96, 132), (16, 32, 64, 132),
               (13, 80, 40, 132), (8, 256, 512, 8), (13, 256, 512, 8),
               (17, 80, 40, 132), (32, 48, 96, 132), (64, 80, 40, 132),
               (64, 208, 72, 132), (96, 80, 40, 132), (128, 208, 72, 132),
               (128, 256, 512, 8)]


@pytest.mark.parametrize("m,k,n,sms", MODEL_CASES,
                         ids=[f"m{m}_{k}x{n}_sm{s}" for m, k, n, s in
                              MODEL_CASES])
def test_mlp_sm90_fragment_maps_compute_x_times_w(m, k, n, sms):
    """Both passes' lane/register maps, run in float64 on random integer
    tiles under the wrapper's plan (one stage or several, clusters, K
    ragged at 40, 80 and 208 columns, N ragged at 40 and 72; 1, 2, 4,
    8 and 16 planes of rows, 96 rows padding 16 planes), give x @ W
    exactly."""
    rng = np.random.default_rng(m * 1000 + k + sms)
    x = rng.integers(-8, 9, (m, k)).astype(np.float64)
    w0 = rng.integers(-64, 65, (k, n)).astype(np.float64)
    w1 = rng.integers(-64, 65, (k, n)).astype(np.float64)
    plan = TDM.mlp_sm90_plan(m, k, n, sms)
    got = _pass_model(plan.gate_up, plan.planes, (w0, w1), x, m, k, n,
                      np.float64)
    np.testing.assert_array_equal(got[0], x @ w0)
    np.testing.assert_array_equal(got[1], x @ w1)
    # The down pass over the same shapes (its plan for K = k, N = n).
    down = TDM._mlp_pass_plan(plan.planes, k, n, False, sms)
    got = _pass_model(down, plan.planes, (w0,), x, m, k, n, np.float64)
    np.testing.assert_array_equal(got[0], x @ w0)


def _kernel_mlp_model(x, scale, wg, wu, wd, eps, plan):
    """The whole bf16 block as the kernel computes it: xn = bf16(x32 *
    rsqrt(mean(x32^2) + eps) * scale32), fp32 gate/up sums through the
    gate/up pass, act = bf16(silu(g) * u), fp32 down sums, out = bf16(x32
    + sum)."""
    b, d = x.shape
    ffn = wg.shape[1]
    x32 = x.astype(np.float32)
    rstd = (np.float32(1) / np.sqrt(
        (x32 * x32).sum(-1, keepdims=True, dtype=np.float32) / np.float32(d)
        + np.float32(eps))).astype(np.float32)
    xn = _bf16(x32 * rstd * scale.astype(np.float32))
    g, u = _pass_model(plan.gate_up, plan.planes, (wg, wu), xn, b, d, ffn,
                       np.float32).astype(np.float32)
    act = _bf16(g / (np.float32(1) + np.exp(-g)) * u)
    (s,) = _pass_model(plan.down, plan.planes, (wd,), act, b, ffn, d,
                       np.float32).astype(np.float32)
    return _bf16(x32 + s)


@pytest.mark.parametrize("b", [1, 8, 13, 16, 32, 64, 96, 128])
def test_mlp_sm90_model_reproduces_the_pallas_body_at_bf16(monkeypatch, b):
    """The kernel's model at bf16 (d = 256, ffn = 512, the wrapper's
    plan on 132 SMs) against the JAX Pallas body in interpret mode
    (block_f = 128) on the same bf16 inputs: within one bf16 ulp of the
    output's largest magnitude (both round xn, act and out once; they
    sum in other orders)."""
    monkeypatch.setattr(JA, "_INTERPRET", True)
    x, scale, ws = _inputs(20 + b, b=b)
    x, scale = _bf16(x), _bf16(scale)
    ws = {key: _bf16(v * np.float32(0.05)) for key, v in ws.items()}
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = np.asarray(JDM.decode_mlp(
        bf(x), bf(scale), _tree(ws, bf), EPS, impl="pallas", block_f=128,
    ).astype(jnp.float32))
    plan = TDM.mlp_sm90_plan(b, 256, 512, 132)
    got = _kernel_mlp_model(x, scale, ws["w_gate"], ws["w_up"],
                            ws["w_down"], EPS, plan)
    top = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert float(np.abs(got - want).max()) <= ulp, (
        float(np.abs(got - want).max()), ulp)
