"""The port's training path held to the JAX package's on the CPU.

The twin config (vocab 256, dim 256, 2 layers, 4 heads over 2 kv heads,
hd 64 so that JAX's flash shape check passes, ffn 512, fp32, blocks 32)
runs JAX ``loss_fn`` under ``jax.value_and_grad`` with its Pallas
kernels in interpret mode, and the port's ``loss_fn`` with the flash
kernels' plain versions through their autograd.Function, on weights
converted by ``params_from_numpy``. Loss within 1e-5 relative, each
gradient leaf within 1e-4 of its own largest |g|. The optimizer is held
to optax's ``make_optimizer(TrainConfig())`` to 1e-7 (mu, nu, count,
params) in fp32 and in bf16 parameters; the Trainer's losses to JAX's
Trainer within 1e-4 relative.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from tpu_dra.workloads import train as JT  # noqa: E402
from tpu_dra.workloads.models import llama as JL  # noqa: E402
from tpu_dra.workloads.models import mixtral as JM  # noqa: E402
from tpu_dra.workloads.ops import attention as JA  # noqa: E402
from tpu_dra.workloads.parallel.mesh import MeshConfig as JMesh  # noqa: E402
from tpu_dra_torch.workloads import train as TT  # noqa: E402
from tpu_dra_torch.workloads.convert import (  # noqa: E402
    opt_state_from_numpy,
    params_from_numpy,
    params_to_numpy,
    unroll_tree,
)
from tpu_dra_torch.workloads.models import build_model  # noqa: E402
from tpu_dra_torch.workloads.models import llama as TL  # noqa: E402
from tpu_dra_torch.workloads.ops import attention as TA  # noqa: E402

TWIN = dict(dim=256, ffn_dim=512, attention_block_q=32, attention_block_k=32)
JCFG = dataclasses.replace(
    JL.TINY_LLAMA, dtype=jnp.float32, param_dtype=jnp.float32, **TWIN
)
TCFG = dataclasses.replace(
    TL.TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32, **TWIN
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


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _jax_loss_and_grads(jcfg, params, tokens):
    model = JL.Llama(jcfg)
    with jax.default_matmul_precision("highest"):
        loss, grads = jax.value_and_grad(
            lambda p: JT.loss_fn(model, p, jnp.asarray(tokens))
        )(params)
    return float(loss), _flat(unroll_tree(_np(grads)))


def _torch_loss_and_grads(tcfg, np_params, tokens):
    params = params_from_numpy(np_params, tcfg, device="cpu", trainable=True)
    loss = TT.loss_fn(build_model(tcfg), params, torch.from_numpy(tokens))
    loss.backward()
    return float(loss.detach()), {
        n: p.grad.numpy() for n, p in params.named_parameters()
    }


def _assert_grads_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        top = float(np.abs(w).max())
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * top,
                                   err_msg=name)


@pytest.fixture(scope="module")
def twin_params():
    return JL.Llama(JCFG).init_params(jax.random.PRNGKey(0), batch=1, seq=8)


def test_loss_and_grads_match_jax_flash_path(twin_params, monkeypatch):
    tokens = _tokens(1, 2, 64)
    j_loss, j_grads = _jax_loss_and_grads(JCFG, twin_params, tokens)
    assert JA._pallas_ok(
        jnp.zeros((2, 64, 4, 64)), jnp.zeros((2, 64, 2, 64)), 32, 32
    )
    calls = dict.fromkeys(("fwd", "bwd_dq", "bwd_dkv"), 0)
    for name in calls:
        def counted(*args, _fn=getattr(TA, f"_torch_flash_{name}"), _n=name):
            calls[_n] += 1
            return _fn(*args)

        monkeypatch.setattr(TA, f"_torch_flash_{name}", counted)
    t_loss, t_grads = _torch_loss_and_grads(TCFG, _np(twin_params), tokens)
    # The flash path's plain versions, once per layer each, as the
    # kernels run on the card (the twin, like TINY_LLAMA, has no remat).
    L = TCFG.n_layers
    assert not TCFG.remat
    assert calls == {"fwd": L, "bwd_dq": L, "bwd_dkv": L}
    assert abs(t_loss - j_loss) <= 1e-5 * abs(j_loss)
    _assert_grads_close(t_grads, j_grads)


def test_fused_ce_loss_and_grads_match_jax_on_tiny():
    """fused_ce with a chunk (5) that does not divide s = 12: JAX takes
    its XLA attention (hd 16 fails its kernel shape check), the port its
    flash path (hd 16 is in the kernels' contract)."""
    jcfg = dataclasses.replace(
        JL.TINY_LLAMA, dtype=jnp.float32, param_dtype=jnp.float32,
        fused_ce=True, ce_chunk=5,
    )
    tcfg = dataclasses.replace(
        TL.TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32,
        fused_ce=True, ce_chunk=5,
    )
    params = JL.Llama(jcfg).init_params(jax.random.PRNGKey(2), batch=1, seq=8)
    tokens = _tokens(3, 2, 12)
    j_loss, j_grads = _jax_loss_and_grads(jcfg, params, tokens)
    t_loss, t_grads = _torch_loss_and_grads(tcfg, _np(params), tokens)
    assert abs(t_loss - j_loss) <= 1e-5 * abs(j_loss)
    _assert_grads_close(t_grads, j_grads)


def test_remat_policies_give_equal_loss_and_grads(twin_params):
    tokens = _tokens(4, 2, 64)
    runs = {
        name: _torch_loss_and_grads(
            dataclasses.replace(TCFG, remat=remat, remat_policy=policy),
            _np(twin_params), tokens,
        )
        for name, remat, policy in (("off", False, "nothing"),
                                    ("nothing", True, "nothing"),
                                    ("dots", True, "dots"))
    }
    loss0, grads0 = runs["off"]
    for name in ("nothing", "dots"):
        loss, grads = runs[name]
        assert abs(loss - loss0) <= 1e-6 * abs(loss0), name
        for leaf, g in grads0.items():
            np.testing.assert_allclose(
                grads[leaf], g, rtol=0, atol=1e-6 * float(np.abs(g).max()),
                err_msg=f"{name} {leaf}",
            )
    with pytest.raises(ValueError, match="remat_policy"):
        _torch_loss_and_grads(
            dataclasses.replace(TCFG, remat=True, remat_policy="everything"),
            _np(twin_params), tokens[:, :8],
        )


def _opt_twin(dtype_j, dtype_t, grad_scale, steps=3, seed=5):
    """Yields (optax state and params, port state and params, gradients)
    after each of ``steps`` updates on the same numpy gradients (the
    port updates in place: check each before the next)."""
    cfg = dataclasses.replace(TL.TINY_LLAMA, param_dtype=dtype_t)
    rng = np.random.default_rng(seed)
    tparams = TL.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    np_params = params_to_numpy(tparams)  # unrolled, float32
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype_j),
                                     np_params)
    tparams = params_from_numpy(np_params, cfg, device="cpu", trainable=True)
    opt = JT.make_optimizer(JT.TrainConfig())
    jstate = opt.init(jparams)
    topt = TT.make_optimizer(TT.TrainConfig())
    tstate = topt.init(tparams)
    for _ in range(steps):
        np_grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * grad_scale).astype(
                np.float32), np_params)
        jgrads = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype_j),
                                        np_grads)
        updates, jstate = opt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = {n: torch.from_numpy(a).to(dtype_t)
                  for n, a in _flat(np_grads).items()}
        tstate = topt.update(tgrads, tstate, tparams)
        yield jstate, jparams, tstate, tparams, jgrads


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtypes,grad_scale,clipped", [
    ((jnp.float32, torch.float32), 1e-4, False),
    ((jnp.float32, torch.float32), 1e-2, True),
    ((jnp.bfloat16, torch.bfloat16), 1e-4, False),
])
def test_optimizer_matches_optax(dtypes, grad_scale, clipped):
    for jstate, jparams, tstate, tparams, jgrads in _opt_twin(*dtypes,
                                                               grad_scale):
        norm = float(optax.global_norm(jgrads))
        assert (norm >= 1.0) == clipped, norm
        adam = jstate[1][0]
        assert int(adam.count) == int(tstate.count)
        assert tstate.count.dtype == torch.int32
        for name, want in _flat(adam.mu).items():
            assert tstate.mu[name].dtype == torch.float32
            np.testing.assert_allclose(tstate.mu[name].numpy(), _f32(want),
                                       rtol=0, atol=1e-7, err_msg=name)
        for name, want in _flat(adam.nu).items():
            assert tstate.nu[name].dtype == dtypes[1]
            np.testing.assert_allclose(tstate.nu[name].float().numpy(),
                                       _f32(want), rtol=0, atol=1e-7,
                                       err_msg=name)
        for name, p in tparams.named_parameters():
            np.testing.assert_allclose(p.detach().float().numpy(),
                                       _f32(_flat(jparams)[name]), rtol=0,
                                       atol=1e-7, err_msg=name)


def test_opt_state_from_numpy_resumes_a_jax_state_exactly():
    """A stacked (scan) JAX state after one optax step converts bit for
    bit, and one more step from it matches optax's."""
    jcfg = dataclasses.replace(JL.TINY_LLAMA, param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TL.TINY_LLAMA, param_dtype=torch.bfloat16)
    jparams = JL.Llama(jcfg).init_params(jax.random.PRNGKey(6), batch=1, seq=4)
    opt = JT.make_optimizer(JT.TrainConfig())
    rng = np.random.default_rng(6)
    grads = [
        jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape) * 1e-4,
                                  jnp.bfloat16), jparams)
        for _ in range(2)
    ]
    jstate = opt.init(jparams)
    updates, jstate = opt.update(grads[0], jstate, jparams)
    jparams = optax.apply_updates(jparams, updates)

    tparams = params_from_numpy(_np(jparams), tcfg, device="cpu",
                                trainable=True)
    tstate = opt_state_from_numpy(_np(jstate), tcfg, device="cpu")
    adam = jstate[1][0]
    assert int(tstate.count) == 1
    for name, want in _flat(unroll_tree(_np(adam.mu))).items():
        assert np.array_equal(tstate.mu[name].numpy(), want.astype(np.float32))
    for name, want in _flat(unroll_tree(_np(adam.nu))).items():
        assert np.array_equal(tstate.nu[name].float().numpy(),
                              want.astype(np.float32))

    updates, jstate = opt.update(grads[1], jstate, jparams)
    jparams = optax.apply_updates(jparams, updates)
    tgrads = {n: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
              for n, a in _flat(unroll_tree(_np(grads[1]))).items()}
    tstate = TT.make_optimizer(TT.TrainConfig()).update(tgrads, tstate,
                                                        tparams)
    for name, p in tparams.named_parameters():
        want = _flat(unroll_tree(_np(jparams)))[name].astype(np.float32)
        np.testing.assert_allclose(p.detach().float().numpy(), want, rtol=0,
                                   atol=1e-7, err_msg=name)


def test_trainer_three_steps_match_jax_trainer():
    """The twin of test_trainer_full_sharded_step on one device: JAX's
    Trainer and the port's from the same state (the port's built by
    params_from_numpy and opt_state_from_numpy), 3 steps on one batch."""
    jt = JT.Trainer(JCFG, JMesh(), devices=jax.devices()[:1])
    jstate = jt.init_state(jax.random.PRNGKey(0), batch=2, seq=64)
    tt = TT.Trainer(TCFG, device="cpu")
    tstate = {
        "params": params_from_numpy(_np(jstate["params"]), TCFG,
                                    device="cpu", trainable=True),
        "opt_state": opt_state_from_numpy(_np(jstate["opt_state"]), TCFG,
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
    logits = tt.make_forward()(tstate["params"], tokens)
    assert logits.shape == (2, 64, 256) and logits.dtype == torch.float32


def test_unported_paths_raise_and_name_the_roadmap():
    with pytest.raises(NotImplementedError,
                       match=r"item 11 \(parallel training\)"):
        TT.Trainer(TCFG, TT.MeshConfig(fsdp=2), device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 10 \(Mixtral\)"):
        build_model(JM.TINY_MIXTRAL)
    with pytest.raises(NotImplementedError,
                       match=r"item 9 \(bootstrap and collective smokes\)"):
        TT.main(["--distributed", "--device", "cpu"])
    with pytest.raises(NotImplementedError,
                       match=r"item 11 \(parallel training\)"):
        TL.Llama(dataclasses.replace(TCFG, attention_impl="ring"))(
            torch.zeros((1, 4), dtype=torch.int32),
            params=TL.init_params(TCFG, torch.Generator().manual_seed(0),
                                  "cpu"))
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.Trainer(TCFG)


def test_flops_per_token_and_main_on_the_cpu(capsys):
    for jc, tc in ((JL.LLAMA3_8B, TL.LLAMA3_8B), (JCFG, TCFG)):
        assert TL.train_flops_per_token(tc, 2048) == JL.train_flops_per_token(
            jc, 2048)
    assert TT.main(["--model", "tiny", "--steps", "2", "--seq", "16",
                    "--device", "cpu"]) == 0
    assert "'ok': True" in capsys.readouterr().out
