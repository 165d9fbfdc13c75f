"""The pipeline relay over pp (tpu_dra_torch/workloads/parallel/
pipeline.py) and the Trainer at pp above 1, over gloo ranks on the CPU,
held to JAX's on conftest's 8 CPU devices: the twins of
tests/test_moe_pipeline.py's pipeline tests.

- ``partition_stages``' shapes and refusal, and the unrolled tree's
  stage names (in-process);
- ``pipeline_apply`` of ``tanh(x @ w)`` stages at pp=4 x tp=2, 4
  microbatches (8 ranks): the output within 1e-5 of the sequential fold
  and of JAX's ``pipeline_apply``, each rank's stage's row of the
  gradient of ``sum(out ** 2)`` within 1e-5 of the fold's;
- ``pipelined_llama_forward`` of TINY_LLAMA fp32 at pp=2 x dp=2 x tp=2,
  2 microbatches (the same 8 ranks): the logits within 1e-4 of JAX's
  pipelined and unpipelined logits; the gradients of ``mean(logits **
  2)`` nonzero in every layer, within rtol 1e-5 of the port's
  unpipelined gradients and of JAX's pipelined ones, ``embed`` the same
  on every rank;
- a batch the microbatches do not split refused (the same 8 ranks);
- the Trainer at ``MeshConfig(pp=2, dp=2, tp=2)`` (the same 8 ranks)
  and Mixtral's at ``pp=2, ep=2`` (4 ranks), from JAX's ``init_state``:
  three losses within rtol 1e-5 of JAX's Trainer on the same mesh and
  bit for bit the port's on the mesh without pp (4 and 2 ranks), no
  collective issued over pp; ``train --distributed --mesh pp=2`` as 2
  ranks;
- ``python -m tpu_dra_torch.workloads.pipestep`` as 2 ranks: the
  pipelined step against the unpipelined one on each rank.

Every launch is started before the JAX references are computed, so the
two overlap (tests/torch_pipeline_rank.py, tests/torch_train_rank.py)."""

import ast
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_pipeline_rank as PR  # noqa: E402
from tests import torch_train_rank as RK  # noqa: E402
from tests.torch_ranks import free_port, last_json, rank_env, start, wait  # noqa: E402
from tests.torch_train_twin import _jax_losses, _np, _save_state  # noqa: E402
from tpu_dra.workloads import train as JT  # noqa: E402
from tpu_dra.workloads.models import mixtral as JMX  # noqa: E402
from tpu_dra.workloads.models.llama import TINY_LLAMA as JAX_TINY  # noqa: E402
from tpu_dra.workloads.models.llama import Llama as JLlama  # noqa: E402
from tpu_dra.workloads.parallel import mesh as JM  # noqa: E402
from tpu_dra.workloads.parallel import pipeline as JP  # noqa: E402
from tpu_dra.workloads.parallel.context import set_global_mesh as jax_mesh  # noqa: E402
from tpu_dra_torch.workloads.convert import params_from_numpy  # noqa: E402
from tpu_dra_torch.workloads.models.llama import TINY_LLAMA, Llama  # noqa: E402
from tpu_dra_torch.workloads.parallel import (  # noqa: E402
    partition_stages,
    stage_layer_names,
)
from tpu_dra_torch.workloads.parallel.context import set_global_mesh  # noqa: E402
from tpu_dra_torch.workloads.parallel.mesh import MeshConfig, TrainMesh  # noqa: E402

LAUNCHES = {
    8: ["apply", "llama", "refusals", "pp_dp_tp"],
    4: ["dp_tp", "moe_pp_ep"],
    2: ["moe_ep"],
}
#: ``train --distributed`` with a pp axis, as 2 ranks.
CLI = ["-m", "tpu_dra_torch.workloads.train", "--distributed", "--mesh",
       "pp=2", "--device", "cpu", "--steps", "2", "--seq", "16"]
#: The pipeline's own CLI: one pipelined step of the tiny preset (bf16)
#: as 2 ranks, against the unpipelined step on each.
PIPE_CLI = ["-m", "tpu_dra_torch.workloads.pipestep", "--device", "cpu",
            "--seq", "32"]
TIMEOUT_S = 300  # a launch; only a hang reaches it
JCFG = dataclasses.replace(JAX_TINY, dtype=jnp.float32,
                           param_dtype=jnp.float32)
TCFG = dataclasses.replace(TINY_LLAMA, dtype=torch.float32,
                           param_dtype=torch.float32)


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_apply() -> dict:
    """JAX's pipeline_apply at pp=4 x tp=2 on the ranks' inputs."""
    ws, x = PR.apply_inputs()
    mesh = JM.build_mesh(JM.MeshConfig(pp=4, tp=2))

    def out(ws):
        return JP.pipeline_apply(lambda w, x: jnp.tanh(x @ w[0]),
                                 ws.reshape(4, 1, *ws.shape[1:]),
                                 jnp.asarray(x), mesh=mesh, n_microbatches=4)

    with jax.default_matmul_precision("highest"):
        return {"out": np.asarray(out(jnp.asarray(ws)))}


def _jax_llama(jparams) -> dict:
    """JAX's pipelined logits and gradients at pp=2 x dp=2 x tp=2, and
    its unpipelined logits."""
    mesh = JM.build_mesh(JM.MeshConfig(**PR.LLAMA_MESH))
    tokens = jnp.asarray(PR.llama_tokens())

    def forward(p):
        return JP.pipelined_llama_forward(JCFG, p, tokens, mesh=mesh,
                                          n_microbatches=2)

    with jax.default_matmul_precision("highest"):
        logits = np.asarray(jax.jit(forward)(jparams))
        grads = jax.jit(jax.grad(lambda p: jnp.mean(forward(p) ** 2)))(
            jparams)
        plain = np.asarray(JLlama(JCFG).apply({"params": jparams}, tokens))
    return {"logits": logits, "plain": plain,
            "grads": {n: p.detach().numpy() for n, p in params_from_numpy(
                _np(grads), TCFG, device="cpu").named_parameters()}}


def _port_plain(jparams) -> dict:
    """The port's unpipelined forward and gradients on one device."""
    params = params_from_numpy(_np(jparams), TCFG, device="cpu",
                               trainable=True)
    set_global_mesh(None)
    logits = Llama(TCFG)(torch.from_numpy(PR.llama_tokens()), params=params)
    (logits ** 2).mean().backward()
    return {"logits": logits.detach().numpy(),
            "grads": {n: p.grad.numpy() for n, p in
                      params.named_parameters()}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's starting states and weights written, every launch started,
    then JAX's references and the port's unpipelined run (overlapping
    the ranks), then the ranks' results."""
    root = tmp_path_factory.mktemp("pipeline")
    lr = JT.TrainConfig(learning_rate=1e-3)
    devices = jax.devices()
    jtrainers = {
        "pp_dp_tp": JT.Trainer(JCFG, JM.MeshConfig(pp=2, dp=2, tp=2), lr,
                               devices),
        "moe_pp_ep": JT.Trainer(
            dataclasses.replace(JMX.TINY_MIXTRAL, dtype=jnp.float32,
                                param_dtype=jnp.float32),
            JM.MeshConfig(pp=2, ep=2), lr, devices[:4]),
    }
    jstates = {"pp_dp_tp": jtrainers["pp_dp_tp"].init_state(batch=4, seq=16),
               "moe_pp_ep": jtrainers["moe_pp_ep"].init_state(batch=4,
                                                              seq=16)}
    _save_state(root / "state_pp_fp32.npz", _np(jstates["pp_dp_tp"]))
    _save_state(root / "state_moe_pp_fp32.npz", _np(jstates["moe_pp_ep"]))
    jparams = JLlama(JCFG).init_params(jax.random.PRNGKey(0), batch=4,
                                       seq=16)
    np.savez(root / "llama.npz", **_flat(_np(jparams)))
    started = {}
    try:
        for world, cases in LAUNCHES.items():
            coordinator = f"127.0.0.1:{free_port()}"
            started[world] = start(
                [["tests/torch_pipeline_rank.py", str(root), *cases]] * world,
                [rank_env(r, world, coordinator) for r in range(world)])
        coordinator = f"127.0.0.1:{free_port()}"
        started["cli"] = start([CLI] * 2, [rank_env(r, 2, coordinator)
                                           for r in range(2)])
        coordinator = f"127.0.0.1:{free_port()}"
        started["pipe_cli"] = start([PIPE_CLI] * 2, [
            rank_env(r, 2, coordinator) for r in range(2)])
        refs = {"apply": _jax_apply(), "llama": _jax_llama(jparams)}
        refs["losses"] = {
            "pp_dp_tp": _jax_losses(jtrainers["pp_dp_tp"],
                                    jstates["pp_dp_tp"], RK.TOKENS["b4"], 3),
            "moe_pp_ep": _jax_losses(jtrainers["moe_pp_ep"],
                                     jstates["moe_pp_ep"], RK.TOKENS["r4"],
                                     3),
        }
        jax_mesh(None)
        refs["port_plain"] = _port_plain(jparams)
    finally:
        results = {w: wait(st, TIMEOUT_S) for w, st in started.items()}
    ranks = {}
    for world, res in results.items():
        ranks[world] = []
        for rank, (rc, so, se, _) in enumerate(res):
            assert rc == 0, (world, rank, rc, se[-3000:])
            ranks[world].append(  # train's CLI prints a Python dict
                ast.literal_eval(last_json(so)) if world == "cli"
                else json.loads(last_json(so)))
    return {"root": root, "refs": refs, "ranks": ranks}


def _case(run, name: str) -> list:
    world = next(w for w, cases in LAUNCHES.items() if name in cases)
    return [r[name] for r in run["ranks"][world]]


# --- in-process --------------------------------------------------------------


def test_partition_stages_shapes():
    params = {"w": torch.zeros(4, 3, 5)}
    staged = partition_stages(params, 2)
    assert staged["w"].shape == (2, 2, 3, 5)
    w = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    np.testing.assert_array_equal(
        partition_stages({"w": torch.from_numpy(w)}, 2)["w"].numpy(),
        np.asarray(JP.partition_stages({"w": jnp.asarray(w)}, 2)["w"]))
    with pytest.raises(ValueError, match="not divisible by 2 stages"):
        partition_stages({"w": torch.zeros(3, 2)}, 2)


def test_stage_layer_names_cut_the_unrolled_tree():
    """Stage s of pp names layers [s·L/pp, (s+1)·L/pp), whatever the
    other axes; JAX's stacked cut gives each stage the same layers."""
    config = MeshConfig(pp=2, tp=2)
    names = [stage_layer_names(4, TrainMesh(config, r, "cpu"))
             for r in range(config.size)]
    assert names == [["layer_0", "layer_1"]] * 2 + [["layer_2",
                                                     "layer_3"]] * 2
    w = np.arange(4)
    assert np.asarray(JP.partition_stages({"w": jnp.asarray(w)}, 2)[
        "w"]).tolist() == [[0, 1], [2, 3]]
    assert stage_layer_names(3, TrainMesh(MeshConfig(), 0, "cpu")) == [
        "layer_0", "layer_1", "layer_2"]
    with pytest.raises(ValueError, match="layer count 3 not divisible"):
        stage_layer_names(3, TrainMesh(config, 0, "cpu"))


def test_pipelined_forward_refuses_the_unrolled_jax_layout():
    cfg = dataclasses.replace(TCFG, scan_layers=False)
    from tpu_dra_torch.workloads.parallel import pipelined_llama_forward

    with pytest.raises(ValueError, match="scan_layers=True"):
        pipelined_llama_forward(cfg, {}, torch.zeros(2, 4, dtype=torch.long),
                                mesh=TrainMesh(MeshConfig(), 0, "cpu"),
                                n_microbatches=1)


# --- the relay on 8 ranks ----------------------------------------------------


def test_pipeline_apply_matches_sequential_and_jax(run):
    ws, x = PR.apply_inputs()
    wt = torch.from_numpy(ws).requires_grad_(True)
    want = torch.from_numpy(x)
    for i in range(4):
        want = torch.tanh(want @ wt[i])
    (want ** 2).sum().backward()
    outs = _case(run, "apply")
    for o in outs:
        got = np.asarray(o["out"], np.float32)
        np.testing.assert_allclose(got, want.detach().numpy(), atol=1e-5)
        np.testing.assert_allclose(got, run["refs"]["apply"]["out"],
                                   atol=1e-5)
        # The stage dim is sharded over pp: a rank's gradient is its
        # stage's row of the fold's, zero elsewhere.
        grad, stage = np.asarray(o["grad"], np.float32), o["coords"]["pp"]
        np.testing.assert_allclose(grad[stage], wt.grad.numpy()[stage],
                                   atol=1e-5)
        assert not np.delete(grad, stage, axis=0).any()
        # 7 ticks: 6 hand-offs forward and 6 inverse shifts backward; the
        # outputs' sum over pp (x takes no gradient here).
        assert o["collectives"] == {"ppermute:pp": 12, "all_reduce:pp": 1}
    assert all(o["out"] == outs[0]["out"] for o in outs)


def test_pipelined_llama_forward_matches_jax_and_unpipelined(run):
    refs = run["refs"]
    first = None
    for r in range(8):
        got = np.load(run["root"] / f"llama_logits_rank{r}.npy")
        for want in (refs["llama"]["logits"], refs["llama"]["plain"],
                     refs["port_plain"]["logits"]):
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        if first is None:
            first = got
        np.testing.assert_array_equal(got, first)


def test_pipelined_llama_gradients_reach_every_stage(run):
    """Each rank holds its stage's layers' gradients and the whole
    gradient of embed, final_norm and lm_head; over the ranks every
    layer is covered and nonzero; every leaf within rtol 1e-5 of the
    unpipelined port's and of JAX's pipelined gradient."""
    refs = run["refs"]
    plain, jgrads = refs["port_plain"]["grads"], refs["llama"]["grads"]
    shared = ("embed.embedding", "final_norm.scale", "lm_head.kernel")
    seen, embeds = set(), []
    outs = _case(run, "llama")
    for r, o in enumerate(outs):
        stage = o["coords"]["pp"]
        layers = {f"layer_{i}" for i in range(stage, stage + 1)}
        with np.load(run["root"] / f"llama_grads_rank{r}.npz") as f:
            grads = {k: f[k] for k in f.files}
        assert {n.split(".")[0] for n in grads} == layers | {
            s.split(".")[0] for s in shared}, sorted(grads)
        for name, g in grads.items():
            for want in (plain[name], jgrads[name]):
                np.testing.assert_allclose(
                    g, want, rtol=1e-5,
                    atol=1e-5 * float(np.abs(want).max()), err_msg=name)
            if name.startswith("layer_"):
                assert np.abs(g).sum() > 0, name
                seen.add(name)
        embeds.append(grads["embed.embedding"])
        # Two hand-offs forward, two inverse shifts backward; the
        # outputs' sum forward and the input's gradient sum backward.
        assert o["collectives"] == {"ppermute:pp": 4, "all_reduce:pp": 2}
    assert seen == {n for n in plain if n.startswith("layer_")}
    for e in embeds[1:]:
        np.testing.assert_array_equal(e, embeds[0])


def test_pipeline_rejects_bad_microbatching(run):
    for o in _case(run, "refusals"):
        assert o["microbatches"] == "batch 5 not divisible by 2 microbatches"
        assert o["stages"] == "layer count 3 not divisible by 2 stages"


# --- the Trainer at pp above 1 -----------------------------------------------


def _losses(run, name: str) -> list:
    per_rank = [r["losses"] for r in _case(run, name)]
    assert all(p == per_rank[0] for p in per_rank), per_rank
    return per_rank[0]


@pytest.mark.parametrize("pp_case,flat_case", [
    ("pp_dp_tp", "dp_tp"), ("moe_pp_ep", "moe_ep")])
def test_trainer_at_pp_two_matches_jax_and_the_mesh_without_pp(
        run, pp_case, flat_case):
    """JAX's Trainer never pipelines: at pp=2 its step is replicated
    over pp. The port's losses are JAX's on the same mesh within rtol
    1e-5, and bit for bit the port's on the mesh without pp; no
    collective is issued over pp, and the parameters are not cut by
    it."""
    got = _losses(run, pp_case)
    np.testing.assert_allclose(got, run["refs"]["losses"][pp_case],
                               rtol=1e-5)
    assert got == _losses(run, flat_case)
    assert got[2] < got[1] < got[0]
    for o in _case(run, pp_case):
        assert o["mesh"]["pp"] == 2
        assert not any(k.split("/")[-1].endswith(":pp") or "+pp" in k
                       for k in o["collectives"]), o["collectives"]
    flat = _case(run, flat_case)[0]
    assert _case(run, pp_case)[0]["local_wq"] == flat["local_wq"]


def test_train_cli_runs_with_a_pp_axis(run):
    outs = run["ranks"]["cli"]
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert o["ok"] and o["mesh"] == {"pp": 2} and o["batch"] == 1
        assert all(np.isfinite(o["losses"]))
    assert outs[0]["losses"] == outs[1]["losses"]


def test_pipeline_cli_step_against_the_unpipelined_step(run):
    """``python -m tpu_dra_torch.workloads.pipestep`` as 2 ranks of
    TINY_LLAMA (bf16): the same loss on both, the unpipelined loss's
    within bf16's rounding, rank i's layer i with gradients, every
    leaf's cosine to the unpipelined gradient near 1, and the cosines of
    the leaves whole on every rank the same on both."""
    outs = run["ranks"]["pipe_cli"]
    assert outs[0]["loss"] == outs[1]["loss"]
    for r, o in enumerate(outs):
        assert o["ok"] and o["rank"] == r and o["mesh"] == {"pp": 2}
        assert o["stage_layers"] == [f"layer_{r}"]
        assert o["layer_grads_nonzero"] == {f"layer_{r}": True}
        assert abs(o["loss"] - o["unpipelined_loss"]) <= 1e-2 * abs(
            o["unpipelined_loss"])
        assert min(o["leaf_cosines"].values()) > 0.999, o["leaf_cosines"]
        assert {k: v["count"] for k, v in o["collectives"].items()} == {
            "ppermute:pp": 4, "all_reduce:pp": 2}
    assert [{n: c for n, c in o["leaf_cosines"].items()
             if not n.startswith("layer_")} for o in outs] == [
        {n: c for n, c in outs[0]["leaf_cosines"].items()
         if not n.startswith("layer_")}] * 2
