"""Sharded decode over gloo ranks on the CPU, held to JAX's sharded
engine and ``greedy_generate`` over ``shard_decode_params``.

The parent runs JAX's ``Engine(sharded=True)`` (conftest's 8 CPU devices
give a (4, 2) mesh) and its ``greedy_generate`` on the (1, 2) mesh, on
TINY_LLAMA fp32; the same weights reach the ranks through
``convert.params_to_numpy`` and an .npz. One launch a world size, every
case in it (tests/torch_sharded_rank.py), started before the JAX
references are computed so the two overlap:

- world 2, mesh (1, 2): the engine greedy, sampled (T 0.8, top-k 8,
  seed 5), with a shared prefix, and with int8 weights and KV;
  ``greedy_generate``; a skewed fake clock a rank with staggered
  arrivals; the column-parallel leaves' local shapes; ``spec_k`` with
  ``sharded`` refused;
- world 2 again, launched once JAX's sharded engine has written its
  exports: the cross-replica methods at fp32, bf16 and int8 KV —
  ``export_sequence`` gives every rank the whole extent, bit for bit the
  one a world-1 engine exports (and JAX's bookkeeping, its payload
  within rounding: the frameworks' prefill K/V differ in the last bits);
  imports from world 1 into world 2, from world 2 into world 1, from
  JAX into world 2 and from world 2 into JAX resume token-identical to
  the unmigrated run; ``evacuate`` under a skewed clock a rank gives the
  same list on both ranks, and a world-1 engine's on rank 0's clock;
- world 4, mesh (2, 2): the engine greedy with ``max_slots=4`` (the rows
  split over the batch axis) and 3 (they replicate); ``greedy_generate``
  with rows replicated; a mesh over ranks 0-2 (its (1, 2) prefix: the
  ranks outside it refused, the two inside giving JAX's tokens);
- ``python -m tpu_dra_torch.workloads.shardbench`` as 2 ranks from
  config dirs the slice daemon's renderer wrote, and in-process at world
  1: JAX shardbench's keys and verdicts.

Every rank's tokens must be JAX's, identical."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_sharded_rank as RK  # noqa: E402
from tests.torch_ranks import free_port, last_json, rank_env, start, wait  # noqa: E402
from torch_twin import to_jax, to_port  # noqa: E402
from tpu_dra.computedomain.daemon.bootstrap import (  # noqa: E402
    render_bootstrap_env,
    write_bootstrap_files,
)
from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra.workloads.generate import greedy_generate as jax_greedy  # noqa: E402
from tpu_dra.workloads.models.llama import TINY_LLAMA as JAX_TINY  # noqa: E402
from tpu_dra.workloads.models.llama import Llama  # noqa: E402
from tpu_dra.workloads.parallel import mesh as JM  # noqa: E402
from tpu_dra_torch.workloads import shardbench as TS  # noqa: E402
from tpu_dra_torch.workloads.convert import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
)
from tpu_dra_torch.workloads.models.llama import TINY_LLAMA  # noqa: E402

JCFG = dataclasses.replace(JAX_TINY, dtype=jnp.float32,
                           param_dtype=jnp.float32)
TCFG = dataclasses.replace(TINY_LLAMA, dtype=torch.float32,
                           param_dtype=torch.float32)
CASES = {
    2: ["greedy", "sampled", "prefix", "w8kv8", "skew", "generate",
        "shapes", "spec_refused"],
    4: ["greedy", "slots4", "generate", "prefix_mesh", "shapes"],
}
#: The cross-replica cases, one world-2 launch started after JAX's
#: exports are written.
MIGRATE_CASES = [f"migrate_{m}" for m in RK.MIGRATE_MODES] + ["evacuate"]
TIMEOUT_S = 150
# The keys JAX's shardbench prints over its two devices.
SHARDBENCH_KEYS = {"mesh_shapes", "greedy_parity_1x1", "greedy_seconds_1x1",
                   "greedy_parity_1x2", "greedy_seconds_1x2",
                   "engine_parity_greedy", "engine_parity_sampled", "ok"}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _jax_engine(params, case: str) -> dict:
    kw, name = RK.ENGINE_CASES[case]
    reqs = [JE.Request(rid=r, prompt=p, max_new_tokens=n,
                       **{k: v for k, v in x.items() if k != "arrival_s"})
            for r, p, n, x in RK.trace(name)]
    eng = JE.Engine(JCFG, params,
                    JE.EngineConfig(**{**RK.EC, **kw, "sharded": True}))
    assert eng.mesh is not None and eng.mesh.shape["model"] == 2
    return {rid: c.tokens.tolist() for rid, c in eng.run(reqs).items()}


def _jax_migrate(jparams, mode: str, root) -> dict:
    """JAX's sharded engine on the migrate trace: ``MIGRATE_RID``
    exported once it decodes (written to ``root/jax_<mode>.npz`` for the
    ranks), and the unmigrated run's tokens."""
    dtype, kw = RK.MIGRATE_MODES[mode]
    jcfg = dataclasses.replace(JCFG, dtype=getattr(jnp, dtype),
                               param_dtype=getattr(jnp, dtype))
    params = jax.tree_util.tree_map(lambda a: a.astype(jcfg.param_dtype),
                                    jparams)

    def engine():
        return JE.Engine(jcfg, params, JE.EngineConfig(
            **{**RK.EC, **kw, "sharded": True}))

    def reqs():
        return [JE.Request(rid=r, prompt=p, max_new_tokens=n)
                for r, p, n, _ in RK.trace("migrate")]

    eng = engine()
    for r in reqs():
        eng.add_request(r)
    while RK.MIGRATE_RID not in eng.decoding_rids():
        eng.step()
    sx = eng.export_sequence(RK.MIGRATE_RID)
    RK.save_extent(root / f"jax_{mode}.npz", to_port(sx))
    return {"sx": sx, "engine": engine,
            "unmigrated": {rid: c.tokens.tolist()
                           for rid, c in engine().run(reqs()).items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX references, {world: [per-rank (rc, json or None, stderr)]})."""
    jparams = Llama(JCFG).init_params(jax.random.PRNGKey(7), batch=2, seq=8)
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             TCFG, device="cpu")
    weights = tmp_path_factory.mktemp("sharded") / "weights.npz"
    np.savez(weights, **_flat(params_to_numpy(port)))
    started = {}
    try:
        for world, cases in CASES.items():
            coord = f"127.0.0.1:{free_port()}"
            argv = ["tests/torch_sharded_rank.py", str(weights), *cases]
            started[world] = start([argv] * world, [
                rank_env(r, world, coord) for r in range(world)])
        started["shardbench"] = start([
            ["-m", "tpu_dra_torch.workloads.shardbench", "--device", "cpu",
             "--config-dir", d]
            for d in _rendered_dirs(weights.parent, 2)], [{}, {}])
        refs = {"migrate": {m: _jax_migrate(jparams, m, weights.parent)
                            for m in RK.MIGRATE_MODES}}
        coord = f"127.0.0.1:{free_port()}"
        started["migrate"] = start(
            [["tests/torch_sharded_rank.py", str(weights),
              *MIGRATE_CASES]] * 2,
            [rank_env(r, 2, coord) for r in range(2)])
        refs.update({case: _jax_engine(jparams, case)
                for case in ("greedy", "sampled", "prefix", "w8kv8",
                             "slots4")})
        # The skew trace is the mixed trace with arrivals: the same
        # requests, so the same tokens.
        refs["skew"] = refs["greedy"]
        mesh = JM.build_decode_mesh(JCFG, jax.devices()[:2])
        assert dict(mesh.shape) == {"batch": 1, "model": 2}
        refs["generate"] = np.asarray(jax_greedy(
            JCFG, JM.shard_decode_params(mesh, jparams),
            jnp.asarray(RK.generate_prompt()), max_new_tokens=8)).tolist()
    finally:
        results = {world: wait(s, TIMEOUT_S) for world, s in started.items()}
    ranks = {
        world: [(rc, json.loads(last_json(out)) if rc == 0 and out.strip()
                 else None, err)
                for rc, out, err, _ in res]
        for world, res in results.items()
    }
    refs["root"] = weights.parent
    return refs, ranks


def _rendered_dirs(root, n: int) -> list:
    """Config dirs as the slice daemon writes them; the coordinator is
    daemon-0's DNS name, which only peers.json maps (to 127.0.0.1)."""
    port = free_port()
    peers = [{"index": i, "nodeName": f"node-{i}", "ipAddress": "127.0.0.1",
              "status": "Ready"} for i in range(n)]
    dirs = []
    for i in range(n):
        env = render_bootstrap_env(i, n, "v5litepod-8", "2x4", peers,
                                   coordinator_port=port)
        d = root / f"cd-{i}"
        write_bootstrap_files(str(d), env, peers)
        dirs.append(str(d))
    return dirs


def _ranks(runs, world):
    _, ranks = runs
    for rank, (rc, _, err) in enumerate(ranks[world]):
        assert rc == 0, (world, rank, rc, err[-3000:])
    return [out for _, out, _ in ranks[world]]


@pytest.mark.parametrize("world", sorted(CASES))
def test_every_rank_completes_every_case(runs, world):
    outs = _ranks(runs, world)
    assert [o["rank"] for o in outs] == list(range(world))
    for o in outs:
        assert o["world"] == world
        assert set(CASES[world]) <= set(o)


ENGINE_PARAMS = [(2, "greedy"), (2, "sampled"), (2, "prefix"), (2, "w8kv8"),
                 (2, "skew"), (4, "greedy"), (4, "slots4")]


@pytest.mark.parametrize("world,case", ENGINE_PARAMS,
                         ids=[f"world{w}-{c}" for w, c in ENGINE_PARAMS])
def test_sharded_engine_token_identical_to_jax(runs, world, case):
    refs, _ = runs
    want = refs[case]
    for o in _ranks(runs, world):
        got = o[case]
        assert got["tokens"] == want, (o["rank"], case)
        assert got["allocator_whole"]
        b, m = {2: (1, 2), 4: (2, 2)}[world]
        assert got["mesh"] == {"batch": b, "model": m}
        # Each rank's pools hold its kv heads: TINY's 2 over 2.
        assert got["pool_shape"][2] == 1
        assert got["collectives"]["model"] > 0
        assert got["collectives"]["clock"] > 0
    if case == "prefix":
        assert all(o[case]["prefix_attached"] >= 1
                   for o in _ranks(runs, world))


@pytest.mark.parametrize("world", sorted(CASES))
def test_sharded_greedy_generate_token_identical_to_jax(runs, world):
    refs, _ = runs
    for o in _ranks(runs, world):
        assert o["generate"]["tokens"] == refs["generate"], o["rank"]
        assert o["generate"]["mesh"]["model"] == 2
        assert set(o["generate"]["collectives"]) == {"model"}


def test_rows_split_over_the_batch_axis_only_when_slots_tile(runs):
    outs = _ranks(runs, 4)
    # (2, 2): max_slots 4 splits into two row blocks, gathered over the
    # batch axis; max_slots 3 does not tile and every rank holds all rows.
    assert [o["slots4"]["rows"] for o in outs] == [[0, 2], [0, 2], [2, 4],
                                                   [2, 4]]
    assert all(o["slots4"]["collectives"]["decode/batch"] > 0 for o in outs)
    assert all(o["greedy"]["rows"] is None for o in outs)
    assert all(not k.endswith("batch") for o in outs
               for k in o["greedy"]["collectives"])


@pytest.mark.parametrize("world", sorted(CASES))
def test_column_parallel_leaves_hold_local_shapes(runs, world):
    """The twin of tests/test_engine.py's model-sharded params test: the
    column-parallel leaves hold 1/m of their columns, the model coordinate
    j its contiguous block; the rest are whole."""
    c = TCFG
    hd = c.head_dim
    want = {
        "wq": [c.dim, c.n_heads * hd // 2],
        "wk": [c.dim, c.n_kv_heads * hd // 2],
        "wv": [c.dim, c.n_kv_heads * hd // 2],
        "wo": [c.n_heads * hd, c.dim],
        "w_gate": [c.dim, c.ffn_dim // 2], "w_up": [c.dim, c.ffn_dim // 2],
        "w_down": [c.ffn_dim, c.dim], "lm_head": [c.dim, c.vocab_size // 2],
        "embed": [c.vocab_size, c.dim],
        "w_up_q": [c.dim, c.ffn_dim // 2], "w_up_scale": [1, c.ffn_dim // 2],
    }
    for o in _ranks(runs, world):
        got = o["shapes"]
        assert got["shapes"] == want
        assert got["w_up_block_exact"]
        assert got["w_up_scale_block_exact"]
        assert got["coords"] == list(divmod(o["rank"], 2))


def test_skewed_clocks_make_the_same_decisions(runs):
    """Rank 1's clock runs 1000 s ahead at twice the rate: the engine
    acts on rank 0's readings, so both stamp the same submit times and
    admit the staggered arrivals at the same steps."""
    outs = _ranks(runs, 2)
    assert outs[0]["skew"]["t_submit"] == outs[1]["skew"]["t_submit"]
    assert all(t < 1000.0 for t in outs[1]["skew"]["t_submit"].values())
    assert outs[0]["skew"]["prefill_buckets"] == outs[1]["skew"][
        "prefill_buckets"] > 1


def test_spec_and_cross_replica_methods_refused_at_world_two(runs):
    """``spec_k`` with ``sharded`` stays refused, as JAX refuses it; the
    cross-replica methods run at world 2 (the cases below)."""
    for o in _ranks(runs, 2):
        assert "spec_k with sharded=True is not supported" in o["spec_refused"]
    for o in _ranks(runs, "migrate"):
        assert set(MIGRATE_CASES) <= set(o)
        assert o["world"] == 2


def _port_extent(runs, mode: str, rank: int):
    refs, _ = runs
    return RK.load_extent(refs["root"] / f"port_{mode}_rank{rank}.npz")


@pytest.mark.parametrize("mode", sorted(RK.MIGRATE_MODES))
def test_world_two_export_is_the_whole_extent(runs, mode):
    """Every rank exports the whole extent: bit for bit the extent a
    world-1 engine exports for the same sequence, the same on both ranks,
    and JAX's sharded export's slots, length and tokens, its payload
    within rounding (the frameworks' prefill K/V differ in the last bits,
    as tests/test_torch_migrate.py ``_same_extent`` holds them at fp32:
    1e-5 here too, two bf16 ulps of a layer's largest value in bf16, one
    int8 code and 1e-5 on the f32 scales at kv8)."""
    refs, _ = runs
    outs = [o[f"migrate_{mode}"] for o in _ranks(runs, "migrate")]
    kvh = TCFG.n_kv_heads
    for o in outs:
        assert o["same_as_world1"]
        assert o["pool_shapes"]["k"][2] == kvh  # whole heads, not 1 of 2
    x0, x1 = _port_extent(runs, mode, 0), _port_extent(runs, mode, 1)
    assert RK.extent_bits(x0.extent) == RK.extent_bits(x1.extent)
    jsx = refs["migrate"][mode]["sx"]
    assert (x0.kv_len, x0.emitted.tolist(), x0.sample_serial) == (
        jsx.kv_len, jsx.emitted.tolist(), jsx.sample_serial)
    assert x0.extent.slots == tuple(
        (str(k), int(v)) for k, v in jsx.extent.slots)
    assert x0.extent.quantized == (mode == "kv8")
    jport = to_port(jsx).extent
    assert sorted(jport.payload) == sorted(x0.extent.payload)
    for name, layers in jport.payload.items():
        for jl, tl in zip(layers, x0.extent.payload[name]):
            assert jl.dtype == tl.dtype and jl.shape == tl.shape
            if name in ("k", "v") and mode == "kv8":
                # int8 codes: a rounding apart moves a code by one.
                assert (jl.int() - tl.int()).abs().max() <= 1, name
            elif mode == "bf16":
                # Two bf16 ulps of the layer's largest value: a rounding
                # apart in layer 0 moves layer 1's K/V by more than one.
                np.testing.assert_allclose(
                    tl.float().numpy(), jl.float().numpy(), rtol=8e-3,
                    atol=2 * 2.0 ** -8 * float(jl.float().abs().max()),
                    err_msg=name)
            else:
                np.testing.assert_allclose(
                    tl.float().numpy(), jl.float().numpy(), rtol=1e-5,
                    atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", sorted(RK.MIGRATE_MODES))
def test_world_two_imports_resume_token_identical(runs, mode):
    """World 1 -> world 2, world 2 -> world 1 and JAX -> world 2 on every
    rank, and the port's world-2 export -> JAX's sharded engine: the
    migrated sequence's emitted + resumed tokens are the unmigrated
    run's (JAX's and the port's), the source's other requests finish as
    unmigrated, and every allocator ends whole."""
    refs, _ = runs
    ref = refs["migrate"][mode]
    want = ref["unmigrated"]
    rid = RK.MIGRATE_RID
    for o in _ranks(runs, "migrate"):
        got = o[f"migrate_{mode}"]
        assert got["unmigrated"] == want
        assert got["w2_from_w1"] == got["w1_from_w2"] == got[
            "w2_from_jax"] == want[rid]
        for rest in got["rest"]:
            assert rest == {r: t for r, t in want.items() if r != rid}
        assert all(got["allocator_whole"])
    port = _port_extent(runs, mode, 0)
    eng = ref["engine"]()
    assert eng.import_sequence(to_jax(port))
    done = eng.run()
    assert port.emitted.tolist() + done[rid].tokens.tolist() == want[rid]
    a = eng.allocator
    assert a.free_pages == a.num_pages - 1


def test_world_two_evacuate_agrees_under_skewed_clocks(runs):
    """Rank 1's clock runs 1000 s ahead at twice the rate: both ranks
    drain at the agreed clock and hand back the same evacuees (rids,
    emitted tokens, submit times), a world-1 engine's on rank 0's clock,
    and leave the engine empty and its allocator whole."""
    outs = [o["evacuate"] for o in _ranks(runs, "migrate")]
    assert outs[0]["sharded"]["evacuees"] == outs[1]["sharded"]["evacuees"]
    assert outs[0]["sharded"] == outs[0]["world1"]
    assert outs[0]["sharded"]["evacuees"]  # something was in flight
    assert any(e[1] for e in outs[0]["sharded"]["evacuees"])
    for o in outs:
        assert not o["sharded"]["busy"] and o["sharded"]["allocator_whole"]


def test_mesh_over_a_prefix_of_the_ranks(runs):
    refs, _ = runs
    outs = _ranks(runs, 4)
    for o in outs:
        res = o["prefix_mesh"]
        assert res["mesh"] == {"batch": 1, "model": 2}
        if o["rank"] < 2:
            assert res["member"] and res["tokens"] == refs["generate"]
        else:
            assert not res["member"]
            assert "outside the 1x2 decode mesh" in res["refused"]


def test_shardbench_two_ranks_from_rendered_dirs(runs):
    """Rank 0 prints JAX's keys with JAX's verdicts over the (1, 2)
    mesh; rank 1 prints nothing and exits 0."""
    _, ranks = runs
    (rc0, report, err0), (rc1, quiet, err1) = ranks["shardbench"]
    assert rc0 == 0 and rc1 == 0, (err0[-3000:], err1[-3000:])
    assert quiet is None
    assert SHARDBENCH_KEYS <= set(report)
    assert report["ok"] and report["ranks_agree"]
    assert report["mesh_shapes"] == [{"batch": 1, "model": 1},
                                     {"batch": 1, "model": 2}]
    assert report["greedy_parity_1x1"] and report["greedy_parity_1x2"]
    # JAX reports len(plain): 6 requests each, all token-identical.
    assert report["engine_parity_greedy"] == report[
        "engine_parity_sampled"] == 6
    assert report["local_shapes"]["lm_head"] == [TCFG.dim,
                                                 TCFG.vocab_size // 2]
    steps = report["engine_greedy"]["decode_steps"]
    # 2 gathers a layer and the logits' one, each decode step and each
    # prefill bucket.
    passes = steps + report["engine_greedy"]["prefill_buckets"]
    got = report["engine_greedy"]["collectives"]
    assert got["model"] + got["decode/model"] == passes * (
        2 * TCFG.n_layers + 1)
    assert report["engine_greedy"]["decode_collectives_per_step"][
        "model"] == 2 * TCFG.n_layers + 1
    # The port's live migration across the mesh: the whole extent, one
    # gather a pool (k and v), bit for bit the unsharded export.
    mig = report["migrate"]
    assert mig["imported"] and mig["lossless"] and mig["same_sequence"]
    assert mig["extent_bit_identical"]  # the CPU's matmuls round alike
    assert mig["tokens_identical"] and mig["export_gathers"] == 2


def test_shardbench_reports_both_ranks_launches(runs):
    """Rank 0 reports every rank's sharded runs (the kept config: the
    kernels on the card, the plain versions on the CPU): on the CPU no
    kernel launches, no plain call counts as one on the card, and each
    engine arm's decode steps are the same on both ranks."""
    _, ranks = runs
    report = ranks["shardbench"][0][1]
    by_rank = report["launches_by_rank"]
    assert len(by_rank) == 2
    for rank_runs in by_rank:
        assert set(rank_runs) == {"greedy_1x1", "greedy_1x2",
                                  "engine_greedy", "engine_sampled"}
        for run in rank_runs.values():
            assert run["launches"] == {} and run["plain_on_card"] == {}
        assert rank_runs["engine_greedy"]["decode_steps"] == report[
            "engine_greedy"]["decode_steps"]
        assert "reckoned_launches" not in rank_runs["engine_greedy"]
    assert "kernel_shard_check" not in report  # the card's only
    assert "engine_bf16" not in report


def test_shardbench_world_one_in_process(capsys, monkeypatch):
    for k in ("TPU_WORKER_ID", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
              "JAX_COORDINATOR_ADDRESS", "CD_CONFIG_DIR"):
        monkeypatch.delenv(k, raising=False)
    assert TS.main(["--device", "cpu"]) == 0
    report = json.loads(last_json(capsys.readouterr().out))
    assert report["ok"] and report["world"] == 1
    assert report["mesh_shapes"] == [{"batch": 1, "model": 1}] * 2
    assert report["greedy_parity_1x1"]
    assert report["engine_parity_greedy"] == report[
        "engine_parity_sampled"] == 6
    assert report["engine_greedy"]["collectives"] == {}
    mig = report["migrate"]
    assert mig["lossless"] and mig["extent_bit_identical"]
    assert mig["tokens_identical"] and mig["export_gathers"] == 0
