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
  ``sharded`` refused; the cross-replica methods refused;
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
        refs = {case: _jax_engine(jparams, case)
                for case in ("greedy", "sampled", "prefix", "w8kv8",
                             "slots4")}
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
    for o in _ranks(runs, 2):
        assert "spec_k with sharded=True is not supported" in o["spec_refused"]
        for case in ("greedy", "sampled"):
            assert "item 8b" in o[case]["evacuate"]


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
