"""Sharded Llama training over gloo ranks on the CPU, held to JAX's
sharded ``Trainer`` on conftest's 8 CPU devices and to the port's own
single-device ``Trainer`` (tests/torch_train_rank.py; one launch of 8
ranks and one of 4, started together before the JAX steps run):

- the twin of tests/test_workloads.py test_trainer_full_sharded_step:
  TINY_LLAMA with ring attention on ``MeshConfig(fsdp=2, sp=2, tp=2)``,
  learning rate 1e-3, two steps on its [4, 16] batch, from JAX's
  ``init_state`` carried over by ``convert.train_state_from_numpy``; fp32:
  the losses within rtol 1e-5 of JAX's sharded losses and of the port's
  single-device ones, step 1's gathered gradients within rtol 1e-5 of
  the single-device port's, the parameters after two steps within a
  tolerance scaled by the learning rate (Adam's first steps are about
  lr · sign(g), so an element whose gradient rounds across zero moves
  by up to 2 lr a step); bf16: rtol 2e-2 and falling, as JAX asserts;
  fp32 with remat: the losses of the run without it;
- the twin of test_llama_ulysses_impl_trains (:267) at sp=2, tp=2 (bf16,
  JAX's default TrainConfig): rtol 2e-2 of JAX's loss and the port's
  single-device loss;
- dp=2 x fsdp=2 with remat, dp=2 x sp=2 with attention "auto" (K/V
  gathered over sp, suffix queries) and sp=2 x tp=2 with the fused
  loss: the single-device port's losses within rtol 1e-5.

Every rank of a run gives the same losses, bit for bit."""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests import torch_train_rank as RK  # noqa: E402
from tests.torch_ranks import free_port, last_json, rank_env, start, wait  # noqa: E402
from tests.torch_train_twin import (  # noqa: E402
    _jax_losses,
    _np,
    _port_single,
    _save_state,
)
from tpu_dra.workloads import train as JT  # noqa: E402
from tpu_dra.workloads.models.llama import TINY_LLAMA as JAX_TINY  # noqa: E402
from tpu_dra.workloads.parallel import mesh as JM  # noqa: E402
from tpu_dra.workloads.parallel.context import set_global_mesh as jax_mesh  # noqa: E402

LAUNCHES = {
    8: ["full_fp32", "full_bf16", "full_remat"],
    4: ["ulysses", "dp_fsdp_remat", "sp_auto", "fused_tp"],
}
TIMEOUT_S = 300  # a launch; only a hang reaches it
FULL_MESH = dict(dp=1, fsdp=2, sp=2, tp=2)


def _jcfg(dtype, impl):
    return dataclasses.replace(JAX_TINY, dtype=dtype, param_dtype=dtype,
                               attention_impl=impl)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's three starting states written, both launches started, then
    JAX's sharded steps and the port's single-device runs (overlapping
    the ranks), then the ranks' results."""
    root = tmp_path_factory.mktemp("train_sharded")
    jtrainers, jstates = {}, {}
    for name, dtype, impl, mc, devices, batch in (
        ("fp32", jnp.float32, "ring", FULL_MESH, None, 4),
        ("bf16", jnp.bfloat16, "ring", FULL_MESH, None, 4),
        ("ulysses_bf16", jnp.bfloat16, "ulysses",
         dict(dp=1, fsdp=1, sp=2, tp=2), jax.devices()[:4], 2),
    ):
        lr = 1e-3 if name != "ulysses_bf16" else 3e-4
        jtrainers[name] = JT.Trainer(
            _jcfg(dtype, impl), mesh_config=JM.MeshConfig(**mc),
            train_config=JT.TrainConfig(learning_rate=lr), devices=devices)
        jstates[name] = jtrainers[name].init_state(batch=batch, seq=16)
        _save_state(root / f"state_{name}.npz", _np(jstates[name]))
    started = {}
    for world, cases in LAUNCHES.items():
        coordinator = f"127.0.0.1:{free_port()}"
        started[world] = start(
            [["tests/torch_train_rank.py", str(root), *cases]] * world,
            [rank_env(r, world, coordinator) for r in range(world)])
    try:
        jax_losses = {
            "full_fp32": _jax_losses(jtrainers["fp32"], jstates["fp32"],
                                     RK.TOKENS["b4"], 2),
            "full_bf16": _jax_losses(jtrainers["bf16"], jstates["bf16"],
                                     RK.TOKENS["b4"], 2),
            "ulysses": _jax_losses(jtrainers["ulysses_bf16"],
                                   jstates["ulysses_bf16"], RK.TOKENS["b2"],
                                   1),
        }
        jax_mesh(None)
        single = {name: _port_single(name, root) for name in (
            "full_fp32", "full_bf16", "ulysses", "fused_tp")}
    finally:
        results = {world: wait(st, TIMEOUT_S) for world, st in started.items()}
    ranks = {}
    for world, res in results.items():
        ranks[world] = []
        for rank, (rc, so, se, _) in enumerate(res):
            assert rc == 0, (world, rank, rc, se[-3000:])
            ranks[world].append(json.loads(last_json(so)))
    return {"root": root, "jax": jax_losses, "single": single, "ranks": ranks}


def _losses(run, name: str) -> list:
    """The case's losses, asserted the same on every rank."""
    world = next(w for w, cases in LAUNCHES.items() if name in cases)
    per_rank = [r[name]["losses"] for r in run["ranks"][world]]
    assert all(p == per_rank[0] for p in per_rank), per_rank
    return per_rank[0]


def test_full_sharded_fp32_matches_jax_and_one_device(run):
    got = _losses(run, "full_fp32")
    np.testing.assert_allclose(got, run["jax"]["full_fp32"], rtol=1e-5)
    np.testing.assert_allclose(got, run["single"]["full_fp32"]["losses"],
                               rtol=1e-5)
    assert got[1] < got[0]
    r0 = run["ranks"][8][0]["full_fp32"]
    assert r0["mesh"] == {"fsdp": 2, "sp": 2, "tp": 2}
    assert r0["local_wq"] == [32, 32]  # [d/fsdp, heads*hd/tp]
    assert r0["step"] == 2 and r0["count"] == 2
    # JAX's state_shardings: wq over (fsdp, tp), its moments alike, the
    # count and the step replicated.
    assert r0["specs"] == {"wq": ["fsdp", "tp"], "wq_mu": ["fsdp", "tp"],
                           "embed": ["tp", "fsdp"], "norm": [None],
                           "count": [], "step": []}
    kinds = {k.split("/")[-1] for k in r0["collectives"]}
    assert {"all_gather:fsdp", "all_gather:tp", "reduce_scatter:fsdp",
            "ppermute:sp", "all_reduce:tp", "all_reduce:fsdp+sp"} <= kinds


def test_full_sharded_fp32_gradients_and_parameters(run):
    single = run["single"]["full_fp32"]
    np.testing.assert_allclose(
        np.load(run["root"] / "full_fp32_logits.npy"), single["logits"],
        rtol=1e-5, atol=1e-6)  # make_forward's global logits
    lr = RK.CASES["full_fp32"].lr
    with np.load(run["root"] / "full_fp32_grads.npz") as f:
        grads = {k.replace("/", "."): f[k] for k in f.files}
    with np.load(run["root"] / "full_fp32_params.npz") as f:
        params = {k.replace("/", "."): f[k] for k in f.files}
    assert sorted(grads) == sorted(single["grads"]) == sorted(params)
    for name, want in single["grads"].items():
        np.testing.assert_allclose(grads[name], want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)
    for name, want in single["params"].items():
        np.testing.assert_allclose(params[name], want, rtol=1e-5,
                                   atol=2 * lr * 2, err_msg=name)
        moved = np.abs(params[name] - want) > 1e-5 * np.abs(want) + 1e-6
        assert moved.mean() < 0.01, name  # sign flips are rare


def test_full_sharded_bf16_and_remat(run):
    got = _losses(run, "full_bf16")
    np.testing.assert_allclose(got, run["jax"]["full_bf16"], rtol=2e-2)
    np.testing.assert_allclose(got, run["single"]["full_bf16"]["losses"],
                               rtol=2e-2)
    assert got[1] < got[0]  # it learns the repeated batch, as JAX asserts
    np.testing.assert_allclose(_losses(run, "full_remat"),
                               _losses(run, "full_fp32"), rtol=1e-6)


def test_ulysses_trains_like_jax(run):
    got = _losses(run, "ulysses")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, run["jax"]["ulysses"], rtol=2e-2)
    np.testing.assert_allclose(got, run["single"]["ulysses"]["losses"],
                               rtol=2e-2)
    kinds = {k.split("/")[-1] for k in
             run["ranks"][4][0]["ulysses"]["collectives"]}
    assert "all_to_all:sp" in kinds and "all_reduce:tp" in kinds


@pytest.mark.parametrize("name,kind", [
    ("dp_fsdp_remat", "all_reduce:dp+fsdp"),
    ("sp_auto", "reduce_scatter:sp"),
    ("fused_tp", "all_gather:tp"),
])
def test_other_meshes_match_one_device(run, name, kind):
    want = (run["single"]["fused_tp"] if name == "fused_tp"
            else run["single"]["full_fp32"])["losses"]
    np.testing.assert_allclose(_losses(run, name), want, rtol=1e-5)
    kinds = {k.split("/")[-1] for k in
             run["ranks"][4][0][name]["collectives"]}
    assert kind in kinds, kinds
