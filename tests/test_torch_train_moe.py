"""Mixtral on a training mesh over gloo ranks on the CPU, held to JAX's
sharded ``Trainer`` on conftest's 8 CPU devices and to the port's own
single-device ``Trainer`` (tests/torch_train_rank.py: one launch of 8
ranks, one of 4 and one of 2, plus ``train --distributed --model
tiny-moe`` as 2 ranks, all started together before the JAX steps run).
TINY_MIXTRAL, learning rate 1e-3, two steps on a seeded [4, 16] batch,
from JAX's ``init_state`` carried over by
``convert.train_state_from_numpy``, fp32 unless stated:

- ``MeshConfig(dp=2, ep=2, tp=2)``, the twin of tests/test_moe_pipeline.py
  test_mixtral_trainer_ep_step: the losses within rtol 1e-5 of JAX's
  sharded losses and of the port's single-device ones; step 1's
  gathered gradients of every leaf, router and experts included, within
  rtol 1e-5 of the single-device port's;
- ``MeshConfig(ep=4, tp=2)``'s forward, the twin of
  test_mixtral_ep_sharded_matches_single_device: the global logits
  within 1e-5 of JAX's sharded forward at fp32, within JAX's 2e-2 at
  bf16;
- ``MeshConfig(fsdp=2, sp=2, ep=2)`` with ring attention and
  ``capacity_factor=0.5``: the same bars as the first. Beside it, numpy
  on JAX's own routing of this batch shows that a capacity or a cumsum
  local to an sp chunk would dispatch otherwise, and that the port's
  ``dispatch_mask`` over the chunks, with the earlier chunks' counts,
  gives the global dispatch;
- Ulysses at ``sp=2, tp=2``, bf16, 4 ranks: rtol 2e-2 of JAX's losses;
- ``train --distributed --model tiny-moe`` at a world of 2 (JAX's
  default mesh, fsdp=2) and a dense Llama at ``ep=2`` (replicated over
  ep): the single-device port's losses within rtol 1e-5.

Every rank of a run gives the same losses, bit for bit."""

import ast
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
from tpu_dra.workloads.generate import unroll_params  # noqa: E402
from tpu_dra.workloads.models import mixtral as JMX  # noqa: E402
from tpu_dra.workloads.parallel import mesh as JM  # noqa: E402
from tpu_dra.workloads.parallel.context import set_global_mesh as jax_mesh  # noqa: E402
from tpu_dra_torch.workloads import train as TT  # noqa: E402
from tpu_dra_torch.workloads.models import mixtral as TMX  # noqa: E402

LAUNCHES = {
    8: ["moe_dp_ep_tp", "moe_ep4_fwd", "moe_ep4_fwd_bf16", "moe_fsdp_sp_ep"],
    4: ["moe_ulysses"],
    2: ["llama_ep2"],
}
#: ``train --distributed`` as the driver starts it on each host.
CLI = ["-m", "tpu_dra_torch.workloads.train", "--distributed", "--model",
       "tiny-moe", "--device", "cpu", "--steps", "2", "--seq", "16"]
TIMEOUT_S = 300  # a launch; only a hang reaches it
TOKENS = RK.TOKENS["r4"]


def _jcfg(dtype, **kw):
    return dataclasses.replace(JMX.TINY_MIXTRAL, dtype=dtype,
                               param_dtype=dtype, **kw)


def _jax_forward(trainer, state, tokens) -> np.ndarray:
    jax_mesh(trainer.mesh)
    with trainer.mesh, jax.default_matmul_precision("highest"):
        out = trainer.make_forward()(state["params"], jnp.asarray(tokens))
    return np.asarray(out)


def _cli_single() -> list:
    """``train --model tiny-moe`` on one device: its seeded weights and
    batch (np.random.default_rng(1), one row a data shard of the world-2
    mesh), JAX's default learning rate."""
    trainer = TT.Trainer(TMX.TINY_MIXTRAL, TT.MeshConfig(), device="cpu")
    state, step = trainer.init_state(), trainer.make_train_step()
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, TMX.TINY_MIXTRAL.vocab_size, (2, 16)).astype(np.int32))
    losses = []
    for _ in range(2):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's starting states written, every launch started, then JAX's
    sharded steps and forwards and the port's single-device runs
    (overlapping the ranks), then the ranks' results."""
    root = tmp_path_factory.mktemp("train_moe")
    f32, bf16 = jnp.float32, jnp.bfloat16
    lr = JT.TrainConfig(learning_rate=1e-3)
    devices = jax.devices()
    jtrainers = {
        "moe_dp_ep_tp": JT.Trainer(_jcfg(f32), JM.MeshConfig(dp=2, ep=2, tp=2),
                                   lr, devices),
        "moe_ep4_fwd": JT.Trainer(_jcfg(f32), JM.MeshConfig(ep=4, tp=2), lr,
                                  devices),
        "moe_ep4_fwd_bf16": JT.Trainer(_jcfg(bf16), JM.MeshConfig(ep=4, tp=2),
                                       lr, devices),
        "moe_fsdp_sp_ep": JT.Trainer(
            _jcfg(f32, attention_impl="ring", capacity_factor=0.5),
            JM.MeshConfig(fsdp=2, sp=2, ep=2), lr, devices),
        "moe_ulysses": JT.Trainer(_jcfg(bf16, attention_impl="ulysses"),
                                  JM.MeshConfig(sp=2, tp=2), lr, devices[:4]),
    }
    jstates = {name: t.init_state(batch=4, seq=16)
               for name, t in jtrainers.items()}
    # The weights are the seed's whatever the mesh: one state a dtype.
    _save_state(root / "state_moe_fp32.npz", _np(jstates["moe_dp_ep_tp"]))
    _save_state(root / "state_moe_bf16.npz", _np(jstates["moe_ulysses"]))
    started = {}
    for world, cases in LAUNCHES.items():
        coordinator = f"127.0.0.1:{free_port()}"
        started[world] = start(
            [["tests/torch_train_rank.py", str(root), *cases]] * world,
            [rank_env(r, world, coordinator) for r in range(world)])
    coordinator = f"127.0.0.1:{free_port()}"
    started["cli"] = start([CLI] * 2, [rank_env(r, 2, coordinator)
                                       for r in range(2)])
    try:
        jax_out = {
            name: _jax_forward(jtrainers[name], jstates[name], TOKENS)
            for name in ("moe_ep4_fwd", "moe_ep4_fwd_bf16")}
        jax_out.update({
            name: _jax_losses(jtrainers[name], jstates[name], TOKENS, 2)
            for name in ("moe_dp_ep_tp", "moe_fsdp_sp_ep", "moe_ulysses")})
        jax_mesh(None)
        single = {name: _port_single(name, root) for name in (
            "moe_dp_ep_tp", "moe_fsdp_sp_ep", "moe_ulysses", "llama_ep2")}
        single["cli"] = {"losses": _cli_single()}
    finally:
        results = {world: wait(st, TIMEOUT_S) for world, st in started.items()}
    ranks = {}
    for world, res in results.items():
        ranks[world] = []
        for rank, (rc, so, se, _) in enumerate(res):
            assert rc == 0, (world, rank, rc, se[-3000:])
            line = last_json(so)
            ranks[world].append(json.loads(line) if world != "cli"
                                else ast.literal_eval(line))
    return {"root": root, "jax": jax_out, "single": single, "ranks": ranks}


def _losses(run, name: str) -> list:
    """The case's losses, asserted the same on every rank."""
    world = next(w for w, cases in LAUNCHES.items() if name in cases)
    per_rank = [r[name]["losses"] for r in run["ranks"][world]]
    assert all(p == per_rank[0] for p in per_rank), per_rank
    return per_rank[0]


def _assert_gradients(run, name: str) -> None:
    """Step 1's gradients, gathered whole on the mesh, against the
    single-device port's, every leaf."""
    single = run["single"][name]["grads"]
    with np.load(run["root"] / f"{name}_grads.npz") as f:
        grads = {k.replace("/", "."): f[k] for k in f.files}
    assert sorted(grads) == sorted(single)
    assert any(".moe.router." in n for n in grads)
    assert any(".moe.experts_w_down" in n for n in grads)
    for leaf, want in single.items():
        np.testing.assert_allclose(grads[leaf], want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=leaf)


def test_dp_ep_tp_matches_jax_and_one_device(run):
    got = _losses(run, "moe_dp_ep_tp")
    np.testing.assert_allclose(got, run["jax"]["moe_dp_ep_tp"], rtol=1e-5)
    np.testing.assert_allclose(got, run["single"]["moe_dp_ep_tp"]["losses"],
                               rtol=1e-5)
    assert got[1] < got[0]
    _assert_gradients(run, "moe_dp_ep_tp")
    r0 = run["ranks"][8][0]["moe_dp_ep_tp"]
    assert r0["mesh"] == {"dp": 2, "ep": 2, "tp": 2}
    # [E/ep, d, ffn/tp] and [E/ep, ffn/tp, d]; the router whole.
    assert r0["local_moe"] == {
        "layer_0.moe.experts_w_gate": [2, 64, 64],
        "layer_0.moe.experts_w_up": [2, 64, 64],
        "layer_0.moe.experts_w_down": [2, 64, 64],
        "layer_0.moe.router.kernel": [64, 4]}
    kinds = {k.split("/")[-1] for k in r0["collectives"]}
    assert {"all_reduce:ep+tp", "all_reduce:dp", "all_gather:tp"} <= kinds


def test_ep4_forward_matches_jax(run):
    for name, tol in (("moe_ep4_fwd", 1e-5), ("moe_ep4_fwd_bf16", 2e-2)):
        got = np.load(run["root"] / f"{name}_logits.npy")
        assert got.shape == (4, 16, 256)
        np.testing.assert_allclose(got, run["jax"][name], rtol=tol, atol=tol,
                                   err_msg=name)
    assert run["ranks"][8][0]["moe_ep4_fwd"]["local_moe"][
        "layer_0.moe.experts_w_up"] == [1, 64, 64]


def test_fsdp_sp_ep_tight_capacity_matches_jax_and_one_device(run):
    got = _losses(run, "moe_fsdp_sp_ep")
    np.testing.assert_allclose(got, run["jax"]["moe_fsdp_sp_ep"], rtol=1e-5)
    np.testing.assert_allclose(
        got, run["single"]["moe_fsdp_sp_ep"]["losses"], rtol=1e-5)
    _assert_gradients(run, "moe_fsdp_sp_ep")
    kinds = {k.split("/")[-1] for k in
             run["ranks"][8][0]["moe_fsdp_sp_ep"]["collectives"]}
    assert {"all_gather:sp", "reduce_scatter:sp", "ppermute:sp",
            "all_reduce:ep", "reduce_scatter:fsdp"} <= kinds


def _jax_routes(cfg, np_params, tokens) -> list:
    """JAX's top-k expert ids [b, s, k] of each layer: its router's
    logits captured from the unrolled model, then its softmax and
    top_k."""
    model = JMX.Mixtral(dataclasses.replace(cfg, scan_layers=False))
    params = unroll_params(np_params)
    with jax.default_matmul_precision("highest"):
        _, state = model.apply({"params": params}, jnp.asarray(tokens),
                               capture_intermediates=True,
                               mutable=["intermediates"])
    inter = state["intermediates"]
    out = []
    for i in range(cfg.n_layers):
        logits = inter[f"layer_{i}"]["moe"]["router"]["__call__"][0]
        out.append(np.array(jax.lax.top_k(jax.nn.softmax(logits), cfg.top_k)[1]))
    return out


def _kept(idx: np.ndarray, n_exp: int, cap: int, chunks: int) -> np.ndarray:
    """The slots [b, s*k, E] a dispatch keeps when positions count within
    each of ``chunks`` chunks of a row, up to ``cap``."""
    b, s, k = idx.shape
    parts = []
    for chunk in np.split(idx, chunks, axis=1):
        flat = (chunk[..., None] == np.arange(n_exp)).reshape(b, -1, n_exp)
        position = np.cumsum(flat, axis=1) - 1
        parts.append(flat & (position < cap))
    return np.concatenate(parts, axis=1)


def test_sp_capacity_and_positions_are_the_global_sequence(tmp_path):
    """Trap of sequence parallelism: a rank sees s/sp positions. On JAX's
    routing of the tight-capacity batch, a chunk-local cumsum and a
    chunk-local capacity each keep other slots than the global dispatch;
    the port's dispatch_mask, chunk by chunk with the earlier chunks'
    counts, gives the global dispatch bit for bit."""
    jcfg = _jcfg(jnp.float32, capacity_factor=0.5)
    trainer = JT.Trainer(jcfg, JM.MeshConfig(), devices=jax.devices()[:1])
    params = _np(trainer.init_state(batch=4, seq=16)["params"])
    routes = _jax_routes(jcfg, params, TOKENS)
    n_exp, sp, s = jcfg.n_experts, 2, TOKENS.shape[1]
    cap, local_cap = jcfg.capacity(s), jcfg.capacity(s // sp)
    assert (cap, local_cap) == (4, 2)
    for idx in routes:
        kept = _kept(idx, n_exp, cap, 1)
        assert kept.sum() < kept.size // n_exp  # the capacity drops slots
        assert (_kept(idx, n_exp, cap, sp) != kept).any()  # local cumsum
        assert (_kept(idx, n_exp, local_cap, 1) != kept).any()  # local cap
        want = TMX.dispatch_mask(torch.from_numpy(idx), n_exp, cap)
        got, earlier = [], torch.zeros(idx.shape[0], n_exp)
        for chunk in np.split(idx, sp, axis=1):
            chunk = torch.from_numpy(chunk)
            got.append(TMX.dispatch_mask(chunk, n_exp, cap, None, earlier))
            earlier = earlier + (chunk[..., None] == torch.arange(n_exp)).sum(
                dim=(1, 2))
        assert torch.equal(torch.cat(got, dim=1), want)
        # An ep block of the experts is its columns of the whole dispatch.
        assert torch.equal(TMX.dispatch_mask(torch.from_numpy(idx), n_exp,
                                             cap, (2, 4)), want[:, :, 2:])
    jax_mesh(None)


def test_ulysses_moe_trains_like_jax(run):
    got = _losses(run, "moe_ulysses")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, run["jax"]["moe_ulysses"], rtol=2e-2)
    np.testing.assert_allclose(got, run["single"]["moe_ulysses"]["losses"],
                               rtol=2e-2)
    kinds = {k.split("/")[-1] for k in
             run["ranks"][4][0]["moe_ulysses"]["collectives"]}
    assert {"all_to_all:sp", "all_reduce:tp", "reduce_scatter:sp"} <= kinds


def test_default_mesh_and_dense_ep_match_one_device(run):
    cli = run["ranks"]["cli"]
    assert cli[0]["losses"] == cli[1]["losses"]
    assert cli[0]["mesh"] == {"fsdp": 2} and cli[0]["batch"] == 2
    np.testing.assert_allclose(cli[0]["losses"], run["single"]["cli"]["losses"],
                               rtol=1e-5)
    got = _losses(run, "llama_ep2")
    np.testing.assert_allclose(got, run["single"]["llama_ep2"]["losses"],
                               rtol=1e-5)
    assert run["ranks"][2][0]["llama_ep2"]["mesh"] == {"ep": 2}
