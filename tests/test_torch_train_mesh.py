"""The training half of the port's mesh (tpu_dra_torch/workloads/
parallel/mesh.py) held to JAX's (tpu_dra/workloads/parallel/mesh.py):
``param_spec`` over every rule and a stacked leaf (the twin of
tests/test_workloads.py test_param_spec_rules), ``MeshConfig`` and
``for_device_count``, ``batch_sharding`` / ``replicated``, the rank
layout of ``build_mesh`` against JAX's device array, each rank's blocks
of TINY_LLAMA's and TINY_MIXTRAL's trees against JAX's addressable
shards, and, over 8 gloo ranks on the CPU (tests/torch_mesh_rank.py,
one launch): each rank's process groups, the ``shard_train_params`` /
``gather_train_params`` round trips, and each differentiable
collective's forward and backward against its conjugate."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from tests import torch_mesh_rank as RK  # noqa: E402
from tests.torch_ranks import free_port, last_json, rank_env, start, wait  # noqa: E402
from tpu_dra.workloads.parallel import mesh as JM  # noqa: E402
from tpu_dra_torch.workloads import train as TT  # noqa: E402
from tpu_dra_torch.workloads.models import mixtral  # noqa: E402
from tpu_dra_torch.workloads.models.llama import TINY_LLAMA, init_params  # noqa: E402
from tpu_dra_torch.workloads.parallel import mesh as TM  # noqa: E402

WORLD = 8
TIMEOUT_S = 300  # the launch; only a hang reaches it

SPEC_PATHS = [
    "layers/block/attention/wq/kernel", "layers/block/attention/wk/kernel",
    "layers/block/attention/wv/kernel", "layers/block/attention/wo/kernel",
    "layers/block/mlp/w_gate/kernel", "layers/block/mlp/w_up/kernel",
    "layers/block/mlp/w_down/kernel", "embed/embedding", "lm_head/kernel",
    "final_norm/scale", "layers/block/attention_norm/scale",
    "layer_3/mlp_norm/scale", "layers/block/moe/experts/w_gate",
    "layers/block/moe/experts/w_up", "layers/block/moe/experts/w_down",
    "layers/block/moe/router/kernel", "layer_0/attention/wq/kernel_q",
    "layer_0/attention/wq/scale", "lm_head/kernel_q", "some/other/leaf",
]


@pytest.fixture(scope="module")
def ranks():
    coordinator = f"127.0.0.1:{free_port()}"
    results = wait(start([["tests/torch_mesh_rank.py"]] * WORLD,
                         [rank_env(r, WORLD, coordinator)
                          for r in range(WORLD)]), TIMEOUT_S)
    out = []
    for rank, (rc, so, se, _) in enumerate(results):
        assert rc == 0, (rank, rc, se[-3000:])
        out.append(json.loads(last_json(so)))
    return out


def test_param_spec_rules_match_jax():
    class FakeArr:
        ndim = 5

    # tests/test_workloads.py test_param_spec_rules, on the port.
    assert TM.param_spec("layers/block/attention/wq/kernel") == ("fsdp", "tp")
    assert TM.param_spec("layers/block/attention/wo/kernel") == ("tp", "fsdp")
    assert TM.param_spec("layers/block/mlp/w_gate/kernel") == ("fsdp", "tp")
    assert TM.param_spec("embed/embedding") == ("tp", "fsdp")
    assert TM.param_spec("final_norm/scale") == ()
    assert TM.param_spec("lm_head/kernel") == ("fsdp", "tp")
    for path in SPEC_PATHS:
        for value in (None, FakeArr()):
            assert TM.param_spec(path, value) == tuple(
                JM.param_spec(path, value)), path
    assert TM.batch_sharding(None) == tuple(JM.P(("dp", "fsdp"), "sp"))
    assert TM.replicated(None) == tuple(JM.P())
    assert TM.AXES == JM.AXES


def test_mesh_config_matches_jax():
    assert TT.MeshConfig is TM.MeshConfig  # train.MeshConfig still imports
    for n in range(1, 65):
        j, t = JM.MeshConfig.for_device_count(n), TM.MeshConfig.for_device_count(n)
        assert (t.dp, t.fsdp, t.sp, t.tp, t.ep, t.pp, t.size) == (
            j.dp, j.fsdp, j.sp, j.tp, j.ep, j.pp, j.size), n
    for mod in (JM, TM):
        with pytest.raises(ValueError, match="at least one device"):
            mod.MeshConfig.for_device_count(0)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        TM.build_mesh(TM.MeshConfig(fsdp=2), device="cpu")
    one = TM.build_mesh(TM.MeshConfig(), device="cpu")
    assert one.size == 1 and one.groups == {}


@pytest.mark.parametrize("kw", [dict(fsdp=2, sp=2, tp=2), dict(dp=2, sp=4),
                                dict(pp=2, dp=2, ep=2), dict(fsdp=8)])
def test_rank_layout_matches_jax_device_array(kw):
    jmesh = JM.build_mesh(JM.MeshConfig(**kw))
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(WORLD):
        pos = tuple(int(i) for i in np.argwhere(ids == r)[0])
        coords = TM.TrainMesh(TM.MeshConfig(**kw), r, "cpu").coords
        assert tuple(coords[a] for a in TM.AXES) == pos, (kw, r)


@pytest.mark.parametrize("kw", [dict(fsdp=2, sp=2, tp=2), dict(fsdp=4, tp=2),
                                dict(dp=2, fsdp=2, tp=2),
                                dict(ep=2, fsdp=2, tp=2, model="mixtral"),
                                dict(ep=4, tp=2, model="mixtral")])
def test_shard_blocks_reassemble_and_moments_follow(kw):
    """Every rank's blocks (cut without a group) are the bits of JAX's
    addressable shard of that rank's device under ``param_shardings``
    and put back by spec give the full tree; an AdamState's moments are
    cut as their parameters. TINY_LLAMA, or TINY_MIXTRAL with its
    experts over ep."""
    kw = dict(kw)
    moe = kw.pop("model", "llama") == "mixtral"
    config = TM.MeshConfig(**kw)
    init = mixtral.init_params if moe else init_params
    params = init(mixtral.TINY_MIXTRAL if moe else TINY_LLAMA,
                  torch.Generator().manual_seed(5), "cpu", trainable=True)
    full = {n: p.detach() for n, p in params.named_parameters()}
    meshes = [TM.TrainMesh(config, r, "cpu") for r in range(WORLD)]
    blocks = [dict(TM.shard_train_params(m, params).named_parameters())
              for m in meshes]
    state = TT.AdamState(count=torch.zeros((), dtype=torch.int32),
                         mu={n: t.float() + 1 for n, t in full.items()},
                         nu={n: t * 2 for n, t in full.items()})
    jmesh = JM.build_mesh(JM.MeshConfig(**kw))
    for name, t in full.items():
        spec = TM.param_spec(name.replace(".", "/"), t)
        jarr = jax.device_put(t.float().numpy(), JM.NamedSharding(
            jmesh, JM.param_spec(name.replace(".", "/"), t)))
        shards = {s.device.id: np.asarray(s.data)
                  for s in jarr.addressable_shards}
        for r, m in enumerate(meshes):
            want = t
            for d, entry in enumerate(spec):
                lo, hi = m.block(t.shape[d], entry)
                want = want.narrow(d, lo, hi - lo)
            assert torch.equal(blocks[r][name].detach(), want), (name, r)
            np.testing.assert_array_equal(
                blocks[r][name].detach().float().numpy(), shards[r],
                err_msg=f"{name} rank {r}")
            assert blocks[r][name].requires_grad
            cut = TM.shard_opt_state(m, state)
            assert torch.equal(cut.mu[name], want.float() + 1)
            assert torch.equal(cut.nu[name], want * 2)


def _lines(outs, mesh: str, axes) -> dict:
    """rank -> the ranks of its line over ``axes`` (coordinate order)."""
    keys = {o["rank"]: RK.line_key(o[mesh]["coords"], axes) for o in outs}
    return {r: sorted(q for q in keys if keys[q] == k) for r, k in keys.items()}


def test_groups_are_the_lines_of_the_layout(ranks):
    for mesh, kw in RK.MESHES.items():
        config = TM.MeshConfig(**kw)
        for o in ranks:
            m = TM.TrainMesh(config, o["rank"], "cpu")
            assert o[mesh]["coords"] == m.coords
            want = {"+".join(m.live(a)) for a in TM.GROUP_AXES if m.live(a)}
            assert set(o[mesh]["groups"]) == want
            for name, members in o[mesh]["groups"].items():
                line = _lines(ranks, mesh, tuple(name.split("+")))[o["rank"]]
                assert members == line == o[mesh]["lines"][name], (mesh, name)


def test_shard_gather_round_trip(ranks):
    for o in ranks:
        assert o["round_trip_exact"] and o["local_requires_grad"]
        shapes = o["local_shapes"]
        assert shapes["embed.embedding"] == [128, 32]  # vocab/tp, d/fsdp
        assert shapes["layer_0.attention.wq.kernel"] == [32, 32]
        assert shapes["layer_0.attention.wk.kernel"] == [32, 16]
        assert shapes["layer_0.mlp.w_down.kernel"] == [64, 32]
        assert shapes["lm_head.kernel"] == [32, 128]
        assert shapes["final_norm.scale"] == [64]
        # TINY_MIXTRAL over dp=2, ep=2, tp=2: the experts over ep and tp.
        assert o["moe_round_trip_exact"]
        moe = o["moe_local_shapes"]
        assert moe["layer_0.moe.experts_w_gate"] == [2, 64, 64]
        assert moe["layer_0.moe.experts_w_down"] == [2, 64, 64]
        assert moe["layer_0.moe.router.kernel"] == [64, 4]


def _blocks(a: np.ndarray, n: int, dim: int) -> list:
    return np.split(a, n, axis=dim)


@pytest.mark.parametrize("name", list(RK.COLLECTIVES))
def test_collective_and_its_conjugate(ranks, name):
    mesh, method, axes, kw, _, side = RK.COLLECTIVES[name]
    res = {o["rank"]: {k: np.array(v) for k, v in o["collectives"][name].items()}
           for o in ranks}
    lines = _lines(ranks, mesh, axes)
    for r, got in res.items():
        line = lines[r]
        n, i = len(line), line.index(r)
        xs = [res[q]["x"] for q in line]
        ys = [res[q]["y"] for q in line]
        if method == "all_gather":
            d = kw["dim"]
            want_out = np.concatenate(xs, axis=d)
            want_grad = (_blocks(got["y"], n, d)[i] if kw.get("replicated")
                         else _blocks(sum(ys), n, d)[i])
        elif method == "reduce_scatter":
            d = kw["dim"]
            want_out = _blocks(sum(xs), n, d)[i]
            want_grad = np.concatenate(ys, axis=d)
        elif method == "all_reduce":
            want_out, want_grad = sum(xs), got["y"]
        elif method == "all_reduce_grad":
            want_out, want_grad = got["x"], sum(ys)
        elif method == "ppermute":
            s = kw["shift"]
            want_out = xs[(i - s) % n]
            want_grad = ys[(i + s) % n]
        else:  # all_to_all: slot j <-> rank j
            want_out = np.stack([xs[j][i] for j in range(n)])
            want_grad = np.stack([ys[j][i] for j in range(n)])
        np.testing.assert_array_equal(got["out"], want_out, err_msg=f"{name} {r}")
        np.testing.assert_array_equal(got["grad"], want_grad,
                                      err_msg=f"{name} {r}")
    # The backward is the forward's adjoint, <C x, y> = <x, C* y> summed
    # over the ranks, where a side replicated over a line of n counts
    # once, not n times (the f/g pair and the replicated gather are
    # conjugate only so).
    n = len(lines[0])
    lhs = sum(float((v["out"] * v["y"]).sum()) for v in res.values())
    rhs = sum(float((v["x"] * v["grad"]).sum()) for v in res.values())
    assert lhs / (n if side == "out" else 1) == pytest.approx(
        rhs / (n if side == "in" else 1), rel=1e-12)
    # Counted under the op issued (f's backward issues an all_reduce).
    op = "all_reduce" if method == "all_reduce_grad" else method
    assert any(k.startswith(op + ":") for k in ranks[0]["counts"][mesh])
