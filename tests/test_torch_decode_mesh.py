"""The port's decode mesh (tpu_dra_torch/workloads/parallel/mesh.py)
held to JAX's (tpu_dra/workloads/parallel/mesh.py), in one process: the
shape ladder, the parameter, pool and data specs, ``sharded_safe_config``
and the (1, 1) mesh that no process group gives. Twins of
tests/test_workloads.py's decode-mesh tests; the multi-rank twins run as
gloo ranks in tests/test_torch_sharded.py."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads.models.llama import LLAMA3_8B as JAX_8B  # noqa: E402
from tpu_dra.workloads.models.llama import TINY_LLAMA as JAX_TINY  # noqa: E402
from tpu_dra.workloads.models.llama import Llama  # noqa: E402
from tpu_dra.workloads.parallel import mesh as JM  # noqa: E402
from tpu_dra.workloads.quantize import quantize_params as jax_quantize  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402
from tpu_dra_torch.workloads.convert import params_from_numpy  # noqa: E402
from tpu_dra_torch.workloads.generate import greedy_generate  # noqa: E402
from tpu_dra_torch.workloads.models.llama import LLAMA3_8B, TINY_LLAMA  # noqa: E402
from tpu_dra_torch.workloads.ops import decode_mlp as TDM  # noqa: E402
from tpu_dra_torch.workloads.parallel import mesh as TM  # noqa: E402

KV8 = dict(n_kv_heads=8, n_heads=8, ffn_dim=128, vocab_size=256)
CONFIGS = {
    "none": (None, None),
    "tiny": (JAX_TINY, TINY_LLAMA),
    "kv8": (dataclasses.replace(JAX_TINY, **KV8),
            dataclasses.replace(TINY_LLAMA, **KV8)),
    "llama3_8b": (JAX_8B, LLAMA3_8B),
}
TCFG = dataclasses.replace(TINY_LLAMA, dtype=torch.float32,
                           param_dtype=torch.float32)
JCFG = dataclasses.replace(JAX_TINY, dtype=jnp.float32,
                           param_dtype=jnp.float32)
MESH_SHAPES = [(1, 1), (1, 2), (2, 2), (4, 2), (2, 4)]


def _jax_mesh(b, m):
    return JM.Mesh(np.array(jax.devices()[: b * m]).reshape(b, m),
                   JM.DECODE_AXES)


def _port_mesh(b, m):
    """A spec-only view of a (b, m) mesh: coordinates, no groups."""
    return TM.DecodeMesh((b, m), list(range(b * m)), 0, "cpu")


@pytest.fixture(scope="module")
def jax_params():
    return Llama(JCFG).init_params(jax.random.PRNGKey(7), batch=2, seq=8)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_mesh_shape_equals_jax(name):
    jcfg, tcfg = CONFIGS[name]
    for n in range(1, 17):
        assert TM.decode_mesh_shape(n, tcfg) == JM.decode_mesh_shape(
            n, jcfg), (name, n)


def _leaf_paths(node, path=()):
    if isinstance(node, dict) or hasattr(node, "items"):
        for k, v in node.items():
            yield from _leaf_paths(v, path + (k,))
    else:
        yield path, node


@pytest.mark.parametrize("layout", ["stacked", "unrolled", "int8",
                                    "int8_unrolled"])
def test_decode_param_spec_equals_jax_on_every_leaf(jax_params, layout):
    from tpu_dra.workloads.generate import unroll_params

    params = jax_params
    if layout.endswith("unrolled"):
        params = unroll_params(params)
    if layout.startswith("int8"):
        params = jax_quantize(params)
    want = {}

    def record(path, leaf):
        want[JM._flatten_path(path)] = tuple(
            JM.decode_param_spec(JM._flatten_path(path), leaf))

    jax.tree_util.tree_map_with_path(record, params)
    tree = jax.tree_util.tree_map(np.asarray, params)
    got = {TM._flatten_path(p): TM.decode_param_spec(TM._flatten_path(p), v)
           for p, v in _leaf_paths(tree)}
    assert got == want
    assert any("model" in spec for spec in got.values())
    if layout.startswith("int8"):
        q = [p for p in got if p.endswith("w_up/kernel_q")]
        s = [p for p in got if p.endswith("w_up/scale")]
        assert q and s and all("model" in got[p] for p in q)
        assert all(got[p] == () for p in s)


def test_decode_param_shardings_tree_of_converted_weights(jax_params):
    """The port's spec tree over the converted (unrolled) weights equals
    JAX's sharding tree over its unrolled tree, leaf for leaf."""
    from tpu_dra.workloads.generate import unroll_params

    want = {}
    jax.tree_util.tree_map_with_path(
        lambda p, s: want.__setitem__(JM._flatten_path(p), tuple(s.spec)),
        JM.decode_param_shardings(_jax_mesh(1, 2), unroll_params(jax_params)),
        is_leaf=lambda x: hasattr(x, "spec"))
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params),
                             TCFG, device="cpu")
    got = {}

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                got["/".join(path + (k,))] = v

    walk(TM.decode_param_shardings(_port_mesh(1, 2), port))
    assert got == want


def test_sharded_safe_config_identity_at_1x1_and_plain_beyond():
    """The port keeps its config over (1, 1) and (1, 2), so each op's
    "auto" picks the kernel on a CUDA tensor and the plain version on
    the CPU; JAX keeps it at (1, 1) and forces XLA on the same four
    fields over (1, 2) (a Pallas call has no partitioning rule) — a
    deliberate divergence."""
    mesh1 = _port_mesh(1, 1)
    assert TM.sharded_safe_config(TINY_LLAMA, mesh1) is TINY_LLAMA
    assert JM.sharded_safe_config(JAX_TINY, _jax_mesh(1, 1)) is JAX_TINY
    assert TM.sharded_safe_config(TINY_LLAMA, _port_mesh(1, 2)) is TINY_LLAMA
    jsafe = JM.sharded_safe_config(JAX_TINY, _jax_mesh(1, 2))
    jchanged = {f.name for f in dataclasses.fields(jsafe)
                if getattr(jsafe, f.name) != getattr(JAX_TINY, f.name)}
    assert jchanged == {"attention_impl", "decode_impl", "decode_mlp_impl",
                        "paged_decode_impl"}
    assert all(getattr(jsafe, f) == "xla" for f in jchanged)
    assert all(getattr(TINY_LLAMA, f) == "auto" for f in jchanged)


@pytest.mark.parametrize("shape", MESH_SHAPES,
                         ids=[f"{b}x{m}" for b, m in MESH_SHAPES])
def test_pool_and_data_specs_equal_jax(shape):
    jmesh, tmesh = _jax_mesh(*shape), _port_mesh(*shape)
    assert dict(jmesh.shape) == tmesh.shape
    for batch in range(1, 9):
        assert TM.decode_data_sharding(tmesh, batch) == tuple(
            JM.decode_data_sharding(jmesh, batch).spec), batch
    for kvh in range(1, 9):
        for ndim in (3, 4):
            assert TM.decode_pool_sharding(tmesh, kvh, ndim) == tuple(
                JM.decode_pool_sharding(jmesh, kvh, ndim).spec), (kvh, ndim)
        want = kvh // shape[1] if kvh % shape[1] == 0 else kvh
        assert TM.local_kv_heads(tmesh, kvh) == want


def test_no_process_group_gives_a_1x1_mesh_that_copies_nothing(jax_params):
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params),
                             TCFG, device="cpu")
    mesh = TM.build_decode_mesh(TCFG, device="cpu")
    assert mesh.shape == {"batch": 1, "model": 1} and mesh.coords == (0, 0)
    assert mesh.group is mesh.model_group is mesh.batch_group is None
    shard = TM.shard_decode_params(mesh, port)
    tree = port.tree()
    assert TM.params_mesh(shard) is mesh
    assert shard["lm_head"]["kernel"].data_ptr() == (
        tree["lm_head"]["kernel"].data_ptr())
    x = torch.ones(2, 3)
    assert mesh.gather_model(x) is x and mesh.gather_batch(x) is x
    assert mesh.agree(1.5, False) == (1.5, False)
    # greedy_generate over the (1, 1) shard: JAX's (1, 1) tokens.
    from tpu_dra.workloads.generate import greedy_generate as jax_greedy

    prompt = np.tile(np.arange(8, dtype=np.int32)[None], (2, 1))
    want = np.asarray(jax.jit(lambda p, t: jax_greedy(
        JCFG, p, t, max_new_tokens=8))(JM.shard_decode_params(
            JM.build_decode_mesh(JCFG, jax.devices()[:1]), jax_params),
            jnp.asarray(prompt)))
    got = greedy_generate(TCFG, shard, torch.from_numpy(prompt), 8,
                          device="cpu")
    assert np.array_equal(got.numpy(), want)
    assert sum(mesh.collectives.values()) == 0


def test_ranks_outside_the_mesh_and_bad_splits_are_refused():
    outside = TM.DecodeMesh((1, 2), [0, 1], 2, "cpu")
    assert not outside.member
    with pytest.raises(ValueError, match="outside the 1x2 decode mesh"):
        TM.shard_decode_params(outside, {"lm_head": {
            "kernel": torch.zeros(4, 6)}})
    odd = TM.DecodeMesh((1, 4), [0, 1, 2, 3], 1, "cpu")
    with pytest.raises(ValueError, match="does not split"):
        TM.shard_decode_params(odd, {"lm_head": {"kernel": torch.zeros(4, 6)}})
    with pytest.raises(ValueError, match="do not split"):
        TM.check_decode_config(TINY_LLAMA, odd)  # 2 kv heads over 4
    with pytest.raises(ValueError):
        TM.build_decode_mesh(TCFG, ranks=[0, 0], device="cpu")


def test_shard_cuts_contiguous_column_blocks_and_int8_scales():
    """Model coordinate j holds columns [j n/m, (j+1) n/m) of every
    column-parallel leaf, an int8 leaf's scale cut with its kernel;
    replicated leaves are the full tensors."""
    from tpu_dra_torch.workloads.quantize import quantize_params

    g = torch.Generator().manual_seed(0)
    tree = {"layer_0": {"attention": {
        "wq": {"kernel": torch.randn(4, 8, generator=g)},
        "wo": {"kernel": torch.randn(8, 4, generator=g)}},
        "mlp": {"w_up": {"kernel": torch.randn(4, 6, generator=g)}}},
        "lm_head": {"kernel": torch.randn(4, 10, generator=g)}}
    q = quantize_params(tree)
    for j in range(2):
        mesh = TM.DecodeMesh((1, 2), [0, 1], j, "cpu")
        shard = TM.shard_decode_params(mesh, tree)
        assert torch.equal(shard["layer_0"]["attention"]["wq"]["kernel"],
                           tree["layer_0"]["attention"]["wq"]["kernel"][
                               :, 4 * j:4 * j + 4])
        assert torch.equal(shard["lm_head"]["kernel"],
                           tree["lm_head"]["kernel"][:, 5 * j:5 * j + 5])
        assert shard["layer_0"]["attention"]["wo"]["kernel"].data_ptr() == (
            tree["layer_0"]["attention"]["wo"]["kernel"].data_ptr())
        qs = TM.shard_decode_params(mesh, q)["layer_0"]["mlp"]["w_up"]
        full = q["layer_0"]["mlp"]["w_up"]
        assert torch.equal(qs["kernel_q"],
                           full["kernel_q"][:, 3 * j:3 * j + 3])
        assert torch.equal(qs["scale"], full["scale"][:, 3 * j:3 * j + 3])
        assert qs["kernel_q"].is_contiguous() and qs["scale"].is_contiguous()
    # On one device an int8 leaf is not copied.
    one = TM.shard_decode_params(_port_mesh(1, 1), q)
    assert one["layer_0"]["mlp"]["w_up"]["kernel_q"].data_ptr() == q[
        "layer_0"]["mlp"]["w_up"]["kernel_q"].data_ptr()


class _ShardPair:
    """A (1, 2) mesh seen from coordinate 0 whose model gather appends
    coordinate 1's act, computed by the plain gate/up half over its own
    column block: the split route without a process group."""

    shape = {"batch": 1, "model": 2}

    def __init__(self, x, scale, other, eps):
        self.other = TDM._torch_gate_up(x, scale, other, eps)
        self.gathered = []

    def gather_model(self, act, dim=-1):
        self.gathered.append(act)
        return torch.cat([act, self.other], dim=dim)


def _column_blocks(mlp, m):
    n = mlp["w_gate"]["kernel"].shape[1] // m
    return [dict(mlp, **{k: {"kernel": mlp[k]["kernel"][:, j * n:(j + 1) * n]
                             .contiguous()} for k in ("w_gate", "w_up")})
            for j in range(m)]


def test_decode_mlp_takes_only_the_plain_chain_on_a_model_shard():
    """On a model shard ``decode_mlp`` takes the split route: on the CPU
    ("auto" and "torch") the plain gate/up half, the model gather, then
    the plain down half — the unsharded chain's output; "cuda" on a CPU
    tensor raises as at world 1; "reference" (no gather) raises."""
    g = torch.Generator().manual_seed(3)
    x, scale = torch.randn(3, 8, generator=g), 1 + torch.randn(8, generator=g)
    mlp = {"w_gate": {"kernel": torch.randn(8, 12, generator=g)},
           "w_up": {"kernel": torch.randn(8, 12, generator=g)},
           "w_down": {"kernel": torch.randn(12, 8, generator=g)}}
    whole = TDM.decode_mlp(x, scale, mlp, 1e-5, impl="torch")
    mine, other = _column_blocks(mlp, 2)
    for impl in ("auto", "torch"):
        mesh = _ShardPair(x, scale, other, 1e-5)
        got = TDM.decode_mlp(x, scale, mine, 1e-5, impl=impl, mesh=mesh)
        assert TDM._LAST_DECODE_MLP_IMPL == "torch"
        assert [tuple(a.shape) for a in mesh.gathered] == [(3, 6)]
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)
    mesh = _ShardPair(x, scale, other, 1e-5)
    with pytest.raises(ValueError, match="CUDA device"):
        TDM.decode_mlp(x, scale, mine, 1e-5, impl="cuda", mesh=mesh)
    with pytest.raises(ValueError, match="CUDA device"):
        TDM.decode_mlp(x, scale, mlp, 1e-5, impl="cuda")  # world 1 alike
    with pytest.raises(ValueError, match="model shard"):
        TDM.decode_mlp(x, scale, mine, 1e-5, impl="reference", mesh=mesh)
    assert not mesh.gathered


@pytest.mark.parametrize("m", [2, 4])
def test_plain_halves_over_column_blocks_match_jax_decode_mlp(jax_params, m):
    """The two plain halves, the gate/up half over each of m column
    blocks of layer 0's MLP and the down half over their concatenation,
    are JAX's ``decode_mlp(impl="xla")`` at fp32 within 1e-5."""
    from tpu_dra.workloads.ops.decode_mlp import decode_mlp as jax_decode_mlp

    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params),
                             TCFG, device="cpu").tree()
    layer = port["layer_0"]
    mlp, scale = layer["mlp"], layer["mlp_norm"]["scale"]
    x = np.random.default_rng(5).standard_normal(
        (3, TCFG.dim)).astype(np.float32)
    xt = torch.from_numpy(x)
    act = torch.cat([TDM.mlp_gate_up(xt, scale, blk, TCFG.norm_eps)
                     for blk in _column_blocks(mlp, m)], dim=-1)
    got = TDM.mlp_down(xt, act, mlp)
    # Layer 0 of the JAX tree (stacked over layers), as converted.
    jmlp = {k: {"kernel": jnp.asarray(v["kernel"].numpy())}
            for k, v in mlp.items()}
    want = np.asarray(jax_decode_mlp(
        jnp.asarray(x), jnp.asarray(scale.numpy()), jmlp, JCFG.norm_eps,
        impl="xla"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [1, 3, 8, 16])
@pytest.mark.parametrize("m", [2, 4])
def test_shard_gate_up_plan_keeps_the_unsharded_k_split(b, m):
    """The sm90 gate/up half of a shard of ffn / m columns at Llama-3-8B
    widths on an H100's 132 SMs is the unsharded pass (its width, K
    split and ring) over a grid of the shard's columns, where the
    shard's own plan would sum in another order."""
    d, ffn, sms = LLAMA3_8B.dim, LLAMA3_8B.ffn_dim, 132
    whole = TDM.mlp_sm90_plan(b, d, ffn, sms).gate_up
    plan = TDM.shard_gate_up_plan(b, d, ffn // m, ffn, sms)
    assert plan._replace(col_ctas=whole.col_ctas) == whole
    assert plan.col_ctas == -(-(ffn // m) // plan.width)
    own = TDM.mlp_sm90_plan(b, d, ffn // m, sms).gate_up
    assert (own.width, own.warps_k, own.cluster, own.cta_steps) != (
        plan.width, plan.warps_k, plan.cluster, plan.cta_steps)


@pytest.mark.parametrize("b,key_range", [(1, 40), (3, 640), (8, 1024),
                                         (8, 8192)])
@pytest.mark.parametrize("m", [2, 4])
def test_shard_decode_split_plan_is_the_unsharded_one(b, key_range, m):
    """A rank of a model axis of m holds kvh / m kv heads; planned with
    the unsharded count (``plan_kv_heads``, as the engine and
    greedy_generate pass it) its split plan is the unsharded call's on
    an H100's 132 SMs, so its heads combine their splits alike."""
    from tpu_dra_torch.workloads.ops import attention as TA

    kvh, sms = LLAMA3_8B.n_kv_heads, 132
    planned = TA._plan_kv_heads(kvh, kvh // m)
    assert TA.split_plan(b, planned, key_range, sms) == TA.split_plan(
        b, kvh, key_range, sms)
    assert TA._plan_kv_heads(None, kvh // m) == kvh // m
    if (b, key_range) == (8, 8192):  # where the shard's own count differs
        assert TA.split_plan(b, kvh // m, key_range, sms) != TA.split_plan(
            b, kvh, key_range, sms)


def test_plan_kv_heads_must_be_a_multiple_of_the_heads_given():
    from tpu_dra_torch.workloads.ops import attention as TA

    q = torch.zeros(1, 4, 8)
    pools = torch.zeros(3, 2, 2, 8)
    tables = torch.ones(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    cache = torch.zeros(1, 4, 2, 8)
    for bad in (3, 1, True, 2.0):
        with pytest.raises(ValueError, match="plan_kv_heads"):
            TA.paged_decode_attention(q, pools, pools, tables, lens,
                                      plan_kv_heads=bad)
        with pytest.raises(ValueError, match="plan_kv_heads"):
            TA.decode_attention(q, cache, cache, 1, plan_kv_heads=bad)
    # On the CPU the plain versions take the planning count and ignore it.
    assert torch.equal(
        TA.paged_decode_attention(q, pools, pools, tables, lens,
                                  plan_kv_heads=8),
        TA.paged_decode_attention(q, pools, pools, tables, lens))


def test_sharded_engine_world_one_is_the_unsharded_engine(jax_params):
    """No process group: the engine's mesh is (1, 1), its config is the
    caller's (kernels kept), it issues no collective and its tokens are
    the unsharded engine's."""
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params),
                             TCFG, device="cpu")
    ec = dict(page_size=4, max_slots=3, max_pages_per_seq=10, scan_chunk=3,
              prefill_chunk=8)
    rng = np.random.default_rng(11)
    reqs = [(f"r{i}", rng.integers(1, 256, int(rng.integers(2, 15))).astype(
        np.int32), int(rng.integers(1, 10))) for i in range(6)]
    runs = {}
    for sharded in (False, True):
        eng = TE.Engine(TCFG, port, TE.EngineConfig(**ec, sharded=sharded),
                        device="cpu")
        runs[sharded] = eng.run([TE.Request(rid=r, prompt=p,
                                            max_new_tokens=n)
                                 for r, p, n in reqs])
    assert eng.mesh.shape == {"batch": 1, "model": 1}
    assert eng.config is TCFG and eng._rows is None
    assert sum(eng.mesh.collectives.values()) == 0
    for rid, *_ in reqs:
        assert np.array_equal(runs[True][rid].tokens, runs[False][rid].tokens)
    # The cross-replica methods work as unsharded over one rank.
    assert eng.evacuate() == []
