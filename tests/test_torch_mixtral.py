"""The port's Mixtral held to the JAX package's on the CPU.

The twin config (vocab 256, dim 256, 2 layers, 4 heads over 2 kv heads,
hd 64 so that JAX's flash shape check passes at its 256 blocks, ffn
512, 4 experts, top-2, fp32) runs at s = 256: JAX with its Pallas flash
kernels in interpret mode, the port with the flash kernels' plain
versions through their autograd.Function, on weights converted by
``params_from_numpy``. Bars:

- the MoE layer: output within 1e-5 of max|y|, the aux loss within 1e-6
  relative, top-k indices identical, at the default capacity and at one
  that drops slots;
- the model: loss within 1e-5 relative, each gradient leaf within 1e-4
  of its own largest |g|;
- three Trainer steps: losses within 1e-4 relative of JAX's Trainer;
- the converter: stacked and unrolled trees give the same tensors, bf16
  bit for bit.

The single-device cases of tests/test_moe_pipeline.py run here against
the same JAX calls.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from tpu_dra.workloads import generate as JG  # noqa: E402
from tpu_dra.workloads import train as JT  # noqa: E402
from tpu_dra.workloads.models import mixtral as JM  # noqa: E402
from tpu_dra.workloads.ops import attention as JA  # noqa: E402
from tpu_dra.workloads.parallel.mesh import MeshConfig as JMesh  # noqa: E402
from tpu_dra_torch.workloads import train as TT  # noqa: E402
from tpu_dra_torch.workloads.convert import (  # noqa: E402
    opt_state_from_numpy,
    params_from_numpy,
    params_to_numpy,
)
from tpu_dra_torch.workloads.models import build_model  # noqa: E402
from tpu_dra_torch.workloads.models import mixtral as TM  # noqa: E402
from tpu_dra_torch.workloads.ops import attention as TA  # noqa: E402

TWIN = dict(dim=256, ffn_dim=512)
JCFG = dataclasses.replace(
    JM.TINY_MIXTRAL, dtype=jnp.float32, param_dtype=jnp.float32, **TWIN
)
TCFG = dataclasses.replace(
    TM.TINY_MIXTRAL, dtype=torch.float32, param_dtype=torch.float32, **TWIN
)
SEQ = 256
# The Trainer twin: TINY_MIXTRAL itself (hd 16: JAX takes XLA attention,
# the port its flash path), in fp32.
JTINY = dataclasses.replace(
    JM.TINY_MIXTRAL, dtype=jnp.float32, param_dtype=jnp.float32
)
TTINY = dataclasses.replace(
    TM.TINY_MIXTRAL, dtype=torch.float32, param_dtype=torch.float32
)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(JA, "_INTERPRET", True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _init(jcfg, seed, batch=1, seq=8):
    """JAX Mixtral weights under jit (flax's eager init is op by op)."""
    return jax.jit(lambda r: JM.Mixtral(jcfg).init_params(r, batch, seq))(
        jax.random.PRNGKey(seed))


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def twin_params():
    """The twin's JAX weights (stacked layout) as numpy."""
    return _np(_init(JCFG, 0))


def _moe_params(np_params, layer=0):
    """(JAX numpy subtree, the port's tensor subtree) of one layer's MoE."""
    jp = JG.unroll_params(np_params)[f"layer_{layer}"]["moe"]
    tp = params_from_numpy(np_params, TCFG, device="cpu").tree()
    return jp, tp[f"layer_{layer}"]["moe"]


def _jax_moe(cfg, params, x):
    """(y, the sown weighted aux, top-k indices) of the JAX layer, under
    jit; the indices are the JAX router's own ops (MixtralMoE keeps them
    internal)."""
    def run(params, x):
        y, sown = JM.MixtralMoE(cfg).apply(
            {"params": params}, x, mutable=["aux_loss"])
        probs = jax.nn.softmax(
            x.astype(jnp.float32)
            @ params["router"]["kernel"].astype(jnp.float32), axis=-1)
        return y, sown["aux_loss"]["moe"][0], jax.lax.top_k(probs,
                                                            cfg.top_k)[1]

    with jax.default_matmul_precision("highest"):
        y, aux, idx = jax.jit(run)(params, jnp.asarray(x))
    return np.asarray(y), float(aux), np.asarray(idx)


def _torch_moe(cfg, params, x):
    layer = TM.MixtralMoE(cfg)
    xt = torch.from_numpy(np.asarray(x))
    _, _, idx = layer.router(params["router"], xt)
    y, aux = layer(params, xt)
    return y.detach().numpy(), float(aux), idx.numpy()


def _assert_moe_close(jcfg, tcfg, jp, tp, x):
    jy, jaux, jidx = _jax_moe(jcfg, jp, x)
    ty, taux, tidx = _torch_moe(tcfg, tp, x)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_allclose(ty, jy, rtol=0,
                               atol=1e-5 * float(np.abs(jy).max()))
    assert abs(taux - jaux) <= 1e-6 * abs(jaux)
    return ty, tidx


# --- the configuration and the parameter tree ---------------------------------


def test_config_fields_presets_and_capacity_mirror_jax():
    jf = [f.name for f in dataclasses.fields(JM.MixtralConfig)]
    assert jf == [f.name for f in dataclasses.fields(TM.MixtralConfig)]
    for name in ("MIXTRAL_8X7B", "TINY_MIXTRAL"):
        jc, tc = getattr(JM, name), getattr(TM, name)
        for f in jf:
            want = getattr(jc, f)
            if f in ("dtype", "param_dtype"):
                want = getattr(torch, jnp.dtype(want).name)
            assert getattr(tc, f) == want, (name, f)
        for s in (1, 7, 256, 2048):
            assert tc.capacity(s) == jc.capacity(s)
        ja, ta = jc.attention_config(), tc.attention_config()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "ffn_dim", "rope_theta", "norm_eps", "attention_block_q",
                  "attention_block_k", "head_dim"):
            assert getattr(ta, f) == getattr(ja, f), (name, f)
    assert isinstance(build_model(TM.MIXTRAL_8X7B), TM.Mixtral)


def test_param_names_shapes_and_count_match_the_unrolled_flax_tree():
    jcfg = dataclasses.replace(JM.TINY_MIXTRAL, scan_layers=False)
    jparams = _init(jcfg, 1)
    jtree = _flat(_np(jparams))
    tparams = TM.init_params(TM.TINY_MIXTRAL, torch.Generator().manual_seed(1))
    tshapes = {n: tuple(p.shape) for n, p in tparams.named_parameters()}
    assert tshapes == {n: a.shape for n, a in jtree.items()}
    assert all(p.dtype == torch.bfloat16 for p in tparams.parameters())
    assert TM.num_params(TM.TINY_MIXTRAL) == sum(a.size for a in jtree.values())
    assert list(tparams.state_dict()) == list(tshapes)
    # The optimizer's global norm adds leaves in the order of
    # jax.tree.leaves over the unrolled flax tree.
    paths = [".".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert TT._flax_order(tshapes) == paths


def test_converter_stacked_and_unrolled_give_the_same_bf16_bits():
    stacked = _np(_init(JM.TINY_MIXTRAL, 2))
    assert stacked["layers"]["block"]["moe"]["experts_w_gate"].shape == (
        2, 4, 64, 128)
    unrolled = JG.unroll_params(stacked)
    a = params_from_numpy(stacked, TM.TINY_MIXTRAL, device="cpu")
    b = params_from_numpy(unrolled, TM.TINY_MIXTRAL, device="cpu")
    assert isinstance(a, TM.MixtralParams) and isinstance(b, TM.MixtralParams)
    want = _flat(unrolled)
    got_a = dict(a.named_parameters())
    got_b = dict(b.named_parameters())
    assert set(got_a) == set(got_b) == set(want)
    for name, w in want.items():
        bits = w.view(np.uint16)
        for got in (got_a[name], got_b[name]):
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  bits), name
    back = _flat(params_to_numpy(a))
    for name, w in want.items():
        assert np.array_equal(back[name], w.astype(np.float32)), name


# --- the MoE layer --------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5],
                         ids=["default_capacity", "drops_slots"])
def test_moe_layer_matches_jax(twin_params, capacity_factor):
    jcfg = dataclasses.replace(JCFG, capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(TCFG, capacity_factor=capacity_factor)
    jp, tp = _moe_params(twin_params)
    x = np.random.default_rng(3).standard_normal((2, SEQ, 256)).astype(
        np.float32)
    _, idx = _assert_moe_close(jcfg, tcfg, jp, tp, x)
    loads = np.stack([(idx == e).sum(axis=(1, 2)) for e in range(4)])
    cap = tcfg.capacity(SEQ)
    # The dropping case must drop; the default must not hide a drop.
    assert (loads.max() > cap) == (capacity_factor < 1), (loads, cap)


def _forced_router(dim, n_experts, column0):
    """A router kernel whose first input row dominates: with x[..., 0]
    = 10 every token ranks the experts by ``column0``."""
    w = np.random.default_rng(4).standard_normal((dim, n_experts)) * 1e-3
    w[0] = column0
    return w.astype(np.float32)


def _forced_inputs(tcfg, column0, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 32, tcfg.dim)).astype(np.float32)
    x[..., 0] = 10.0
    def f(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    jp = {
        "router": {"kernel": _forced_router(tcfg.dim, tcfg.n_experts, column0)},
        "experts_w_gate": f(tcfg.n_experts, tcfg.dim, tcfg.ffn_dim),
        "experts_w_up": f(tcfg.n_experts, tcfg.dim, tcfg.ffn_dim),
        "experts_w_down": f(tcfg.n_experts, tcfg.ffn_dim, tcfg.dim),
    }
    tp = {"router": {"kernel": torch.from_numpy(jp["router"]["kernel"])},
          **{k: torch.from_numpy(v) for k, v in jp.items() if k != "router"}}
    return x, jp, tp


def test_positions_minus_one_and_past_capacity_give_zero_rows():
    """Every token picks experts 0 and 1: their positions run past the
    capacity, experts 2 and 3 keep position -1 throughout. F.one_hot
    rejects both; the comparison gives JAX's zero rows."""
    jcfg = dataclasses.replace(JCFG, dim=32, ffn_dim=64)
    tcfg = dataclasses.replace(TCFG, dim=32, ffn_dim=64)
    x, jp, tp = _forced_inputs(tcfg, [1.0, 0.9, -1.0, -1.0])
    ty, idx = _assert_moe_close(jcfg, tcfg, jp, tp, x)
    assert set(np.unique(idx)) == {0, 1}

    cap = tcfg.capacity(32)
    tidx = torch.from_numpy(idx)
    dispatch = TM.dispatch_mask(tidx, 4, cap)
    flat = F.one_hot(tidx, 4).float().reshape(2, 64, 4)
    position = torch.cumsum(flat, dim=1) - 1
    assert float(position.min()) == -1 and float(position.max()) >= cap
    with pytest.raises(RuntimeError):
        F.one_hot(position.long(), cap)
    want = (flat * (position < cap)).numpy()[..., None] * np.asarray(
        jax.nn.one_hot(jnp.asarray(position.numpy()).astype(jnp.int32), cap))
    np.testing.assert_array_equal(dispatch.numpy(), want)
    assert float(dispatch[:, :, 2:].abs().sum()) == 0.0
    assert float(dispatch.sum()) == 2 * 2 * cap  # two full buffers a row
    # Tokens past both buffers pass nothing through the layer.
    assert float(np.abs(ty[:, -1]).max()) == 0.0


def test_router_tie_takes_the_lower_index():
    """Experts 1, 2 and 3 tie exactly for every token, expert 0 trails:
    top-2 is (1, 2), as jax.lax.top_k breaks ties."""
    jcfg = dataclasses.replace(JCFG, dim=32, ffn_dim=64)
    tcfg = dataclasses.replace(TCFG, dim=32, ffn_dim=64)
    x, jp, tp = _forced_inputs(tcfg, [-1.0, 0.5, 0.5, 0.5])
    w = jp["router"]["kernel"]
    w[1:, 2] = w[1:, 1]
    w[1:, 3] = w[1:, 1]
    tp["router"]["kernel"] = torch.from_numpy(w)
    probs, _, _ = TM.MixtralRouter(tcfg)(tp["router"], torch.from_numpy(x))
    assert torch.equal(probs[..., 1], probs[..., 2])
    assert torch.equal(probs[..., 1], probs[..., 3])
    _, idx = _assert_moe_close(jcfg, tcfg, jp, tp, x)
    assert (idx[..., 0] == 1).all() and (idx[..., 1] == 2).all()


# --- the single-device cases of tests/test_moe_pipeline.py ----------------------


def _jax_init_moe(jcfg, x, seed=0):
    return _np(jax.jit(JM.MixtralMoE(jcfg).init)(jax.random.PRNGKey(seed),
                                                 jnp.asarray(x))["params"])


def _torch_tree(np_tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in np_tree.items()}


def test_mixtral_forward_shapes_finite_against_jax():
    """TINY_MIXTRAL as it is (bf16): logits [2, 16, 256] fp32 and finite,
    the aux loss in (0, 1); against JAX's apply_with_aux at bf16's bar
    (the logits within 2 % of their largest magnitude, aux 1 %)."""
    jparams = _init(JM.TINY_MIXTRAL, 0, batch=2, seq=16)
    tokens = np.ones((2, 16), dtype=np.int32)
    jlogits, jaux = jax.jit(JM.Mixtral(JM.TINY_MIXTRAL).apply_with_aux)(
        jparams, jnp.asarray(tokens))
    model = build_model(TM.TINY_MIXTRAL)
    params = params_from_numpy(_np(jparams), TM.TINY_MIXTRAL, device="cpu")
    with torch.no_grad():
        logits, aux = model.apply_with_aux(params, torch.from_numpy(tokens))
    assert logits.shape == (2, 16, TM.TINY_MIXTRAL.vocab_size)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    assert 0.0 < float(aux) < 1.0
    jl = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), jl, rtol=0,
                               atol=2e-2 * float(np.abs(jl).max()))
    assert abs(float(aux) - float(jaux)) <= 1e-2 * float(jaux)


def test_single_expert_moe_equals_dense_swiglu():
    jcfg = JM.MixtralConfig(dim=32, ffn_dim=64, n_experts=1, top_k=1,
                            capacity_factor=1.0, dtype=jnp.float32,
                            param_dtype=jnp.float32)
    tcfg = TM.MixtralConfig(dim=32, ffn_dim=64, n_experts=1, top_k=1,
                            capacity_factor=1.0, dtype=torch.float32,
                            param_dtype=torch.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 8, 32)))
    jp = _jax_init_moe(jcfg, x)
    tp = _torch_tree(jp)
    ty, _ = _assert_moe_close(jcfg, tcfg, jp, tp, x)
    xt = torch.from_numpy(x)
    wg, wu, wd = (tp[k][0] for k in ("experts_w_gate", "experts_w_up",
                                     "experts_w_down"))
    want = (F.silu(xt @ wg) * (xt @ wu)) @ wd
    np.testing.assert_allclose(ty, want.numpy(), atol=1e-5)


def test_moe_capacity_headroom_is_a_noop():
    base = dict(dim=16, ffn_dim=16, n_experts=4, top_k=2)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (1, 8, 16)))
    jp = _jax_init_moe(JM.MixtralConfig(
        capacity_factor=4.0, dtype=jnp.float32, param_dtype=jnp.float32,
        **base), x)
    tp = _torch_tree(jp)
    outs = []
    for cf in (4.0, 8.0):
        jcfg = JM.MixtralConfig(capacity_factor=cf, dtype=jnp.float32,
                                param_dtype=jnp.float32, **base)
        tcfg = TM.MixtralConfig(capacity_factor=cf, dtype=torch.float32,
                                param_dtype=torch.float32, **base)
        outs.append(_assert_moe_close(jcfg, tcfg, jp, tp, x)[0])
    assert np.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-6)


def test_moe_capacity_drops_tokens():
    base = dict(dim=16, ffn_dim=16, n_experts=2, top_k=1)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 16, 16)))
    jp = _jax_init_moe(JM.MixtralConfig(
        capacity_factor=4.0, dtype=jnp.float32, param_dtype=jnp.float32,
        **base), x)
    tp = _torch_tree(jp)
    outs = {}
    for name, cf in (("tight", 0.125), ("loose", 4.0)):
        jcfg = JM.MixtralConfig(capacity_factor=cf, dtype=jnp.float32,
                                param_dtype=jnp.float32, **base)
        tcfg = TM.MixtralConfig(capacity_factor=cf, dtype=torch.float32,
                                param_dtype=torch.float32, **base)
        outs[name] = _assert_moe_close(jcfg, tcfg, jp, tp, x)[0]
    assert np.isfinite(outs["tight"]).all()
    assert float(np.abs(outs["tight"] - outs["loose"]).max()) > 1e-6
    assert int((np.abs(outs["tight"][0]).sum(axis=-1) == 0.0).sum()) > 0


# --- the model and the trainer ----------------------------------------------------


def test_loss_and_grads_match_jax_flash_path(twin_params, monkeypatch):
    tokens = _tokens(1, 2, SEQ)
    model = JM.Mixtral(JCFG)
    assert JA._pallas_ok(jnp.zeros((2, SEQ, 4, 64)), jnp.zeros((2, SEQ, 2, 64)),
                         256, 256)
    with jax.default_matmul_precision("highest"):
        j_loss, j_grads = jax.value_and_grad(
            lambda p: JT.loss_fn(model, p, jnp.asarray(tokens)))(
                jax.tree_util.tree_map(jnp.asarray, twin_params))
    j_grads = _flat(JG.unroll_params(_np(j_grads)))

    calls = dict.fromkeys(("fwd", "bwd_dq", "bwd_dkv"), 0)
    for name in calls:
        def counted(*args, _fn=getattr(TA, f"_torch_flash_{name}"), _n=name):
            calls[_n] += 1
            return _fn(*args)

        monkeypatch.setattr(TA, f"_torch_flash_{name}", counted)
    params = params_from_numpy(twin_params, TCFG, device="cpu", trainable=True)
    loss = TT.loss_fn(build_model(TCFG), params, torch.from_numpy(tokens))
    loss.backward()
    L = TCFG.n_layers
    assert not TCFG.remat
    assert calls == {"fwd": L, "bwd_dq": L, "bwd_dkv": L}
    t_loss = float(loss.detach())
    assert abs(t_loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    t_grads = {n: p.grad.numpy() for n, p in params.named_parameters()}
    assert set(t_grads) == set(j_grads)
    for name, w in j_grads.items():
        np.testing.assert_allclose(t_grads[name], w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)
    # The aux branch adds to the loss and reaches the routers.
    assert float(np.abs(t_grads["layer_0.moe.router.kernel"]).max()) > 0


def test_remat_gives_equal_loss_and_grads(twin_params):
    tokens = torch.from_numpy(_tokens(6, 1, 64))
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(TCFG, remat=remat)
        params = params_from_numpy(twin_params, cfg, device="cpu",
                                   trainable=True)
        loss = TT.loss_fn(build_model(cfg), params, tokens)
        loss.backward()
        runs.append((float(loss.detach()), {n: p.grad for n, p in
                                   params.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for name, g in g0.items():
        np.testing.assert_allclose(g1[name].numpy(), g.numpy(), rtol=0,
                                   atol=1e-6 * float(g.abs().max()),
                                   err_msg=name)


def test_trainer_three_steps_match_jax_trainer():
    jt = JT.Trainer(JTINY, JMesh(), devices=jax.devices()[:1])
    jstate = jt.init_state(jax.random.PRNGKey(0), batch=2, seq=64)
    tt = TT.Trainer(TTINY, device="cpu")
    tstate = {
        "params": params_from_numpy(_np(jstate["params"]), TTINY,
                                    device="cpu", trainable=True),
        "opt_state": opt_state_from_numpy(_np(jstate["opt_state"]), TTINY,
                                          device="cpu"),
        "step": 0,
    }
    tokens = _tokens(8, 2, 64)
    jstep, tstep = jt.make_train_step(), tt.make_train_step()
    j_losses, t_losses = [], []
    with jax.default_matmul_precision("highest"):
        for _ in range(3):
            jstate, jl = jstep(jstate, jnp.asarray(tokens))
            tstate, tl = tstep(tstate, tokens)
            j_losses.append(float(jl))
            t_losses.append(float(tl))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_losses[2] < t_losses[1] < t_losses[0]
    assert tstate["step"] == 3 and int(tstate["opt_state"].count) == 3
    fresh = TT.Trainer(TTINY, device="cpu").init_state(
        torch.Generator().manual_seed(0))
    assert isinstance(fresh["params"], TM.MixtralParams)
    assert set(fresh["opt_state"].mu) == set(tstate["opt_state"].mu)


def test_unported_paths_and_the_device_rule():
    """pp, ep and the other axes pass ``check_mesh`` (the mesh then
    needs its world: the ranks are tests/test_torch_train_moe.py's and,
    for pp, tests/test_torch_pipeline.py's); experts, heads or widths the
    mesh does not split raise ValueError."""
    for mesh in (TT.MeshConfig(pp=2), TT.MeshConfig(pp=2, ep=2),
                 TT.MeshConfig(ep=2), TT.MeshConfig(ep=4, tp=2),
                 TT.MeshConfig(dp=2, fsdp=2, sp=2, tp=2, ep=2)):
        TT.check_mesh(TTINY, mesh)
    for mesh, what in ((TT.MeshConfig(ep=3), "ep must split the 4 experts"),
                       (TT.MeshConfig(tp=8), "tp must split"),
                       (TT.MeshConfig(fsdp=128), "fsdp the width 64")):
        with pytest.raises(ValueError, match=what):
            TT.Trainer(TTINY, mesh, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.Trainer(TTINY)


def test_main_trains_tiny_moe_on_the_cpu(capsys):
    assert TT.main(["--model", "tiny-moe", "--steps", "2", "--seq", "16",
                    "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "'ok': True" in out and "'device': 'cpu'" in out
