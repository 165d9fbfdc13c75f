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
    mesh1 = _port_mesh(1, 1)
    assert TM.sharded_safe_config(TINY_LLAMA, mesh1) is TINY_LLAMA
    assert JM.sharded_safe_config(JAX_TINY, _jax_mesh(1, 1)) is JAX_TINY
    safe = TM.sharded_safe_config(TINY_LLAMA, _port_mesh(1, 2))
    jsafe = JM.sharded_safe_config(JAX_TINY, _jax_mesh(1, 2))
    changed = {f.name for f in dataclasses.fields(safe)
               if getattr(safe, f.name) != getattr(TINY_LLAMA, f.name)}
    jchanged = {f.name for f in dataclasses.fields(jsafe)
                if getattr(jsafe, f.name) != getattr(JAX_TINY, f.name)}
    assert changed == jchanged == {"attention_impl", "decode_impl",
                                   "decode_mlp_impl", "paged_decode_impl"}
    # JAX's XLA path is the port's plain PyTorch one.
    assert all(getattr(jsafe, f) == "xla" for f in jchanged)
    assert all(getattr(safe, f) == "torch" for f in changed)


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


def test_decode_mlp_takes_only_the_plain_chain_on_a_model_shard():
    mesh = _port_mesh(1, 2)
    x = torch.ones(2, 4)
    mlp = {n: {"kernel": torch.ones(4, 4)} for n in ("w_gate", "w_up",
                                                     "w_down")}
    for impl in ("auto", "cuda", "reference"):
        with pytest.raises(ValueError, match="model shard"):
            TDM.decode_mlp(x, torch.ones(4), mlp, 1e-5, impl=impl, mesh=mesh)


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
