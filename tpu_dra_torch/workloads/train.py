"""Single-device training for the Llama family.

Counterpart of ``tpu_dra/workloads/train.py`` on one device: bf16
parameters, the port's own AdamW with fp32 first moments, the
materialised-logits or fused cross-entropy loss, and a ``Trainer`` with
``init_state`` / ``make_train_step`` / ``make_forward``. A mesh with any
axis above 1 (FSDP, TP, SP, ring or Ulysses attention) is ROADMAP Queue
A item 11 (parallel training); ``--distributed`` bootstrap is item 9
(bootstrap and collective smokes).

The optimizer is optax's ``chain(clip_by_global_norm(grad_clip),
adamw(lr, b1, b2, eps=1e-8, weight_decay, mu_dtype=float32))`` (optax
0.2.6) op for op, dtypes included, so a step matches JAX's to the bit
where the arithmetic allows. Two details that ``torch.optim.AdamW`` and
``clip_grad_norm_`` get differently, and must stay as they are:

- the second moment ``nu`` is kept in the parameter dtype (optax's
  ``zeros_like(params)``; bf16 for bf16 parameters), the first moment
  ``mu`` in fp32, the step count in int32;
- clipping keeps ``g`` when ``norm < max_norm`` and otherwise takes
  ``g / norm * max_norm``, with no epsilon; the norm is the root of the
  sum of the per-leaf sums of squares, each in the leaf's dtype, added
  in the order of the flax tree's leaves.

Python floats that JAX treats as weakly typed are rounded to the dtype
of the tensor they meet before the operation (``_scalar``), as XLA does.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.models import build_model
from tpu_dra_torch.workloads.models.llama import (
    LlamaParams,
    init_params,
    param_tree,
)
from tpu_dra_torch.workloads.ops.loss import fused_next_token_xent

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The JAX mesh axes, kept so a config names its layout; the port
    trains on one device, so every axis must be 1."""

    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.sp * self.tp * self.ep * self.pp


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState`` keyed by parameter name (the flax path
    joined by dots): count int32 [], mu fp32, nu in the parameter
    dtype."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as JAX's weak type meets ``like``: rounded to its
    dtype first. A 0-dim CPU tensor enters a CUDA op as a scalar."""
    return torch.tensor(value, dtype=like.dtype)


def _flax_order(names) -> list:
    """Parameter names in the order of ``jax.tree.leaves`` over the
    unrolled flax tree: keys sorted level by level."""
    return sorted(names, key=lambda n: n.split("."))


class AdamW:
    """The optax chain of :func:`make_optimizer` over a LlamaParams tree
    and a dict of its gradients by parameter name. ``update`` writes the
    new parameters in place (no second copy of the weights) and returns
    the new state; the old state's tensors are updated in place too."""

    EPS = 1e-8  # optax adamw's default, outside the square root

    def __init__(self, config: TrainConfig):
        self.config = config

    def init(self, params: LlamaParams) -> AdamState:
        named = dict(params.named_parameters())
        first = next(iter(named.values()))
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=first.device),
            mu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in named.items()},
            nu={n: torch.zeros_like(p) for n, p in named.items()},
        )

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """optax ``global_norm``: sqrt of the sum over leaves (flax
        order) of sum(g * g), each in the leaf's dtype."""
        total = None
        for name in _flax_order(grads):
            g = grads[name]
            sq = (g * g).sum()
            total = sq if total is None else total + sq
        return torch.sqrt(total)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamState,
               params: LlamaParams) -> AdamState:
        c = self.config
        named = dict(params.named_parameters())
        if set(grads) != set(named):
            raise ValueError(
                f"gradients and parameters name different leaves: "
                f"{sorted(set(grads) ^ set(named))[:5]}"
            )
        g_norm = self.global_norm(grads)
        keep = bool(g_norm < c.grad_clip)
        count = state.count + 1
        bc1 = 1 - torch.tensor(c.beta1, dtype=torch.float32) ** count.float()
        bc2 = 1 - torch.tensor(c.beta2, dtype=torch.float32) ** count.float()
        for name, p in named.items():
            g = grads[name]
            if not keep:  # clip_by_global_norm
                g = (g / g_norm.to(g.dtype)) * _scalar(c.grad_clip, g)
            mu, nu = state.mu[name], state.nu[name]
            # scale_by_adam: the moments, their bias correction, the step.
            mu.mul_(_scalar(c.beta1, mu)).add_(_scalar(1 - c.beta1, g) * g)
            nu.mul_(_scalar(c.beta2, nu)).add_(_scalar(1 - c.beta2, g) * (g * g))
            mu_hat = mu / bc1.to(device=mu.device, dtype=mu.dtype)
            nu_hat = nu / bc2.to(device=nu.device, dtype=nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat) + _scalar(self.EPS, nu_hat))
            del mu_hat, nu_hat
            # add_decayed_weights (every leaf: optax adamw's mask=None),
            # scale_by_learning_rate, apply_updates.
            u.add_(_scalar(c.weight_decay, p) * p)
            u.mul_(_scalar(-c.learning_rate, u))
            p.copy_(p + u)
            del u, g
        return AdamState(count=count, mu=state.mu, nu=state.nu)


def make_optimizer(config: TrainConfig) -> AdamW:
    return AdamW(config)


def loss_fn(model, params, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy over [b, s] int tokens: the fp32 logits
    path, or with ``config.fused_ce`` the chunked head (ops/loss.py).
    The MoE branch (aux loss) waits for Mixtral, ROADMAP Queue A item
    10 (Mixtral)."""
    c = model.config
    if c.fused_ce:
        hidden = model(tokens, return_hidden=True, params=params)
        return fused_next_token_xent(
            hidden, param_tree(params)["lm_head"]["kernel"], tokens,
            chunk=c.ce_chunk,
        )
    logits = model(tokens, params=params)  # [b, s, v] fp32
    targets = tokens[:, 1:].to(device=logits.device, dtype=torch.long)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -ll.mean()


class Trainer:
    """Owns the model, the optimizer and the train/forward steps on one
    device (the CUDA device unless ``device`` says otherwise)."""

    def __init__(
        self,
        model_config,
        mesh_config: Optional[MeshConfig] = None,
        train_config: TrainConfig = TrainConfig(),
        device=None,
    ):
        if mesh_config is not None and mesh_config.size > 1:
            raise NotImplementedError(
                f"{mesh_config}: sharded training is not ported yet: "
                f"ROADMAP Queue A item 11 (parallel training); the port "
                f"trains on one device"
            )
        self.model_config = model_config
        self.model = build_model(model_config)
        self.mesh_config = mesh_config or MeshConfig()
        self.train_config = train_config
        self.optimizer = make_optimizer(train_config)
        self.device = resolve_device(device)

    def init_state(self, rng: Optional[torch.Generator] = None,
                   batch: int = 1, seq: int = 8) -> Dict:
        """Fresh trainable parameters (drawn on ``rng``'s device, then
        moved to the trainer's) and optimizer state. ``batch``/``seq``
        are JAX's tracing shapes; torch needs none."""
        del batch, seq
        rng = rng or torch.Generator(device=self.device).manual_seed(0)
        params = init_params(self.model_config, rng, trainable=True)
        params.to(self.device)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0}

    def make_train_step(self) -> Callable:
        """(state, tokens [b, s]) -> (state, loss): one forward and
        backward, then the optimizer, which updates the parameters in
        place."""
        model, opt, device = self.model, self.optimizer, self.device

        def train_step(state, tokens):
            params = state["params"]
            tokens = torch.as_tensor(tokens, device=device)
            params.zero_grad(set_to_none=True)
            # Spans for a profiler trace (no cost without one); the
            # backward runs on autograd's thread, outside any span here.
            with record_function("train_step/forward"):
                loss = loss_fn(model, params, tokens)
            loss.backward()
            with record_function("train_step/optimizer"):
                grads = {n: p.grad for n, p in params.named_parameters()}
                opt_state = opt.update(grads, state["opt_state"], params)
                del grads
            params.zero_grad(set_to_none=True)
            return (
                {"params": params, "opt_state": opt_state,
                 "step": state["step"] + 1},
                loss.detach(),
            )

        return train_step

    def make_forward(self) -> Callable:
        model, device = self.model, self.device

        @torch.no_grad()
        def forward(params, tokens):
            return model(torch.as_tensor(tokens, device=device), params=params)

        return forward


# --- CLI ----------------------------------------------------------------------

MODEL_PRESETS = {
    "llama3-8b": "LLAMA3_8B",
    "tiny": "TINY_LLAMA",
}


def main(argv=None) -> int:
    import argparse

    from tpu_dra_torch.workloads import models as models_mod

    p = argparse.ArgumentParser("tpu-dra-torch-train")
    p.add_argument("--model", choices=sorted(MODEL_PRESETS), default="tiny")

    def positive_int(v):
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return n

    def nonnegative_int(v):
        n = int(v)
        if n < 0:
            raise argparse.ArgumentTypeError("must be >= 0")
        return n

    p.add_argument("--steps", type=positive_int, default=10)
    p.add_argument(
        "--batch", type=nonnegative_int, default=0,
        help="global batch (0: one, the single device's data shard)",
    )
    p.add_argument("--seq", type=positive_int, default=512)
    p.add_argument(
        "--distributed", action="store_true",
        help="multi-host bootstrap (not ported: ROADMAP Queue A item 9, "
             "bootstrap and collective smokes)",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA device; 'cpu' for the "
             "plain PyTorch path)",
    )
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if args.distributed:
        raise NotImplementedError(
            "--distributed bootstrap is not ported yet: ROADMAP Queue A "
            "item 9 (bootstrap and collective smokes)"
        )
    model_config = getattr(models_mod, MODEL_PRESETS[args.model])
    trainer = Trainer(model_config, device=args.device)
    batch = args.batch or 1
    state = trainer.init_state(batch=batch, seq=args.seq)
    step = trainer.make_train_step()
    tokens = torch.from_numpy(
        np.random.default_rng(1)
        .integers(0, model_config.vocab_size, (batch, args.seq))
        .astype(np.int32)
    )
    loss = None
    t0 = time.monotonic()
    for _ in range(args.steps):
        state, loss = step(state, tokens)
    loss = float(loss)  # waits for the device
    dt = time.monotonic() - t0
    tok_per_s = args.steps * batch * args.seq / dt if dt > 0 else 0.0
    log.info(
        "trained %d steps (%s, batch=%d seq=%d, %s): loss=%.4f, %.0f tok/s",
        args.steps, args.model, batch, args.seq, trainer.device, loss,
        tok_per_s,
    )
    print({"ok": loss == loss, "steps": args.steps, "loss": loss,
           "tok_per_s": tok_per_s, "device": str(trainer.device)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
