"""Helpers shared by the sharded-training twin tests
(tests/test_torch_train_sharded.py, tests/test_torch_train_moe.py): a
JAX training state written for the ranks (tests/torch_train_rank.py
``load_state`` reads it), JAX's sharded steps, and the port's
single-device run of a rank case."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import torch_train_rank as RK
from tpu_dra.workloads.parallel.context import set_global_mesh as jax_mesh
from tpu_dra_torch.workloads import train as TT
from tpu_dra_torch.workloads.convert import _find_adam
from tpu_dra_torch.workloads.parallel.context import set_global_mesh


def _flat(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:  # bf16 goes as float32, which holds it exactly
            out[prefix + k] = np.asarray(v).astype(np.float32)
    return out


def _save_state(path, state) -> None:
    adam = _find_adam(state["opt_state"])
    np.savez(path, **_flat(state["params"], "params/"),
             **_flat(adam.mu, "opt/mu/"), **_flat(adam.nu, "opt/nu/"),
             **{"opt/count": np.asarray(adam.count)})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_losses(trainer, state, tokens, steps: int) -> list:
    jax_mesh(trainer.mesh)  # its ring/Ulysses read the global mesh
    step = trainer.make_train_step()
    out = []
    with jax.default_matmul_precision("highest"):
        for _ in range(steps):
            state, loss = step(state, jnp.asarray(tokens))
            out.append(float(loss))
    return out


def _port_single(name: str, root) -> dict:
    """The case's config on one device, from the same JAX state (or the
    same seed): its losses, step-1 gradients and final parameters."""
    case = RK.CASES[name]
    cfg = RK.config_of(case)
    if cfg.attention_impl in ("ring", "ulysses"):
        cfg = dataclasses.replace(cfg, attention_impl="auto")
    trainer = TT.Trainer(cfg, TT.MeshConfig(),
                         TT.TrainConfig(learning_rate=case.lr), device="cpu")
    state = (trainer.init_state() if case.state == "seed" else
             RK.load_state(root / f"state_{case.state}.npz", cfg,
                           trainer.mesh))
    seen = []
    update = trainer.optimizer.update

    def spy(grads, opt_state, params):
        if not seen:
            seen.append({n: g.clone() for n, g in grads.items()})
        return update(grads, opt_state, params)

    trainer.optimizer.update = spy
    logits = trainer.make_forward()(
        state["params"], torch.from_numpy(RK.TOKENS[case.tokens]))
    step = trainer.make_train_step()
    losses = []
    for _ in range(case.steps):
        state, loss = step(state, torch.from_numpy(RK.TOKENS[case.tokens]))
        losses.append(float(loss))
    set_global_mesh(None)
    params = {n: p.detach().float().numpy()
              for n, p in state["params"].named_parameters()}
    return {"losses": losses, "grads": {n: g.float().numpy()
                                        for n, g in seen[0].items()},
            "params": params, "logits": logits.float().numpy()}
