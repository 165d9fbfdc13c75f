"""Training for the Llama and Mixtral families, on one device or a mesh.

Counterpart of ``tpu_dra/workloads/train.py``: bf16 parameters, the
port's own AdamW with fp32 first moments, the materialised-logits or
fused cross-entropy loss (plus Mixtral's load-balance loss), and a
``Trainer`` with ``init_state`` / ``state_shardings`` /
``make_train_step`` / ``make_forward``. ``--distributed`` joins the
slice's process group from the driver-rendered env (:mod:`.bootstrap`)
and trains on JAX's default mesh for the world,
``MeshConfig.for_device_count``, with JAX's default batch of one row a
``(dp, fsdp)`` shard.

Llama and Mixtral train on a mesh of any ``dp``, ``fsdp``, ``sp``,
``tp`` and ``ep`` (:mod:`.parallel.mesh`), one rank a mesh slot, with
attention "auto", "ring" or "ulysses". Every rank holds its blocks of
the parameters and moments and takes its rows and ``sp`` chunk of the
global batch (the ranks of an ep line the same ones); a step is JAX's
GSPMD step with its collectives written out: the loss is the global
mean (the log-likelihood sum and count all-reduced over the data axes)
plus Mixtral's load-balance loss, already the global batch's, a
gradient is summed over the data axes its leaf is not sharded over, the
clipping norm adds each leaf's squares over the axes it is sharded
over, and AdamW updates the local blocks with no communication. A dense
Llama at ``ep`` above 1 is replicated over ep, as JAX's rules name no
ep dim for its leaves. At ``pp`` above 1 the step runs replicated over
pp, as JAX's Trainer does (it never pipelines: no rule names pp, so no
gradient sums over it, the batch rows stay split over ``(dp, fsdp)``
only and the clip norm takes nothing over it); the pipelined forward is
:func:`.parallel.pipeline.pipelined_llama_forward`.

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
import torch.distributed as dist
from torch.profiler import record_function

from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.models import build_model, mixtral
from tpu_dra_torch.workloads.models.llama import (
    LlamaParams,
    init_params,
    param_tree,
)
from tpu_dra_torch.workloads.ops.loss import (
    fused_next_token_xent,
    fused_xent_sum,
)
from tpu_dra_torch.workloads.parallel.context import set_global_mesh
from tpu_dra_torch.workloads.parallel.mesh import (
    BATCH_AXES,
    DATA_AXES,
    MeshConfig,
    TrainMesh,
    build_mesh,
    param_shardings,
    param_spec,
    replicated,
    shard_train_params,
    spec_axes,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0


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


def _path(name: str) -> str:
    """A parameter name (flax path joined by dots) as a spec path."""
    return name.replace(".", "/")


class AdamW:
    """The optax chain of :func:`make_optimizer` over a parameter module
    (LlamaParams, or its MixtralParams subclass) and a dict of its
    gradients by parameter name. ``update`` writes the new parameters in
    place (no second copy of the weights) and returns the new state; the
    old state's tensors are updated in place too. On a ``mesh`` the
    parameters, gradients and moments are this rank's blocks: only the
    clipping norm communicates."""

    EPS = 1e-8  # optax adamw's default, outside the square root

    def __init__(self, config: TrainConfig, mesh: Optional[TrainMesh] = None):
        self.config = config
        self.mesh = mesh

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
        order) of sum(g * g), each in the leaf's dtype. On a mesh each
        leaf's sum over its block is all-reduced (in fp32) over the axes
        the leaf is sharded over, one all_reduce an axis set, so a
        replicated leaf counts once."""
        sq = {name: (g * g).sum() for name, g in grads.items()}
        if self.mesh is not None and self.mesh.size > 1:
            by_axes: Dict[tuple, list] = {}
            for name in sorted(sq):
                axes = self.mesh.live(spec_axes(param_spec(_path(name))))
                if axes:
                    by_axes.setdefault(axes, []).append(name)
            for axes, names in by_axes.items():
                summed = self.mesh.all_reduce_raw(
                    torch.stack([sq[n].float() for n in names]), axes,
                    inplace=True)
                for n, v in zip(names, summed):
                    sq[n] = v.to(sq[n].dtype)
        total = None
        for name in _flax_order(grads):
            total = sq[name] if total is None else total + sq[name]
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


def make_optimizer(config: TrainConfig,
                   mesh: Optional[TrainMesh] = None) -> AdamW:
    return AdamW(config, mesh)


#: The largest all_reduce of summed gradients (a leaf above it goes
#: alone): bounds the bucket and, over gloo, its pinned host copy.
GRAD_BUCKET_BYTES = 256 * 2**20


def sum_grads(mesh: TrainMesh, grads: Dict[str, torch.Tensor]) -> None:
    """Sum each gradient, in place, over the data axes (dp, fsdp, sp) its
    leaf is not sharded over: the contributions of the other rows and
    positions (an fsdp-sharded leaf's came in its gather's
    reduce_scatter). Leaves of one axis set and dtype go in buckets of
    up to GRAD_BUCKET_BYTES, one all_reduce a bucket, in name order on
    every rank."""
    buckets: Dict[tuple, list] = {}
    for name in sorted(grads):
        sharded = spec_axes(param_spec(_path(name)))
        axes = mesh.live(tuple(a for a in DATA_AXES if a not in sharded))
        if not axes:
            continue
        g = grads[name]
        runs = buckets.setdefault((axes, g.dtype), [[]])
        if runs[-1] and sum(grads[n].nbytes for n in runs[-1]) + g.nbytes \
                > GRAD_BUCKET_BYTES:
            runs.append([])
        runs[-1].append(name)
    for (axes, _), runs in buckets.items():
        for names in runs:
            flat = mesh.all_reduce_raw(
                torch.cat([grads[n].reshape(-1) for n in names]), axes,
                inplace=True)
            offset = 0
            for n in names:
                g = grads[n]
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            del flat


def _sharded_loss(model, params, tokens: torch.Tensor,
                  mesh: TrainMesh) -> torch.Tensor:
    """The global mean next-token loss of the global [B, S] ``tokens`` on
    this rank's rows and sp chunk: a chunk's last target is the next
    chunk's first token, the sequence's last position has none. The
    log-likelihood sum and the count are all-reduced over the data axes
    (the backward passes the gradient through: every rank's sum enters
    the mean once). A model with ``apply_with_aux`` (Mixtral) adds its
    load-balance loss once: it is already the global batch's."""
    b, s = tokens.shape
    r0, r1 = mesh.block(b, BATCH_AXES)
    c0, c1 = mesh.block(s, "sp")
    local = tokens[r0:r1, c0:c1]
    targets = tokens[r0:r1, c0 + 1:c1 + 1].to(torch.long)
    n = targets.shape[1]
    aux = 0.0
    if getattr(model.config, "fused_ce", False):
        hidden = model(local, return_hidden=True, params=params)
        head = mesh.gather_param(param_tree(params)["lm_head"]["kernel"],
                                 "lm_head/kernel", tp=True)
        nll = fused_xent_sum(hidden, head, targets,
                             chunk=model.config.ce_chunk)
    else:
        if hasattr(model, "apply_with_aux"):
            logits, aux = model.apply_with_aux(params, local)
        else:
            logits = model(local, params=params)
        logp = torch.log_softmax(logits[:, :n], dim=-1)
        nll = -torch.gather(logp, -1, targets.to(logp.device)[..., None]).sum()
    count = torch.tensor(float(targets.numel()), device=nll.device)
    total = mesh.all_reduce(torch.stack([nll, count]), DATA_AXES)
    return total[0] / total[1] + aux


def loss_fn(model, params, tokens: torch.Tensor,
            mesh: Optional[TrainMesh] = None) -> torch.Tensor:
    """Next-token cross entropy over [b, s] int tokens, in JAX's order of
    branches: a model with ``apply_with_aux`` (Mixtral) adds its summed
    load-balance loss to the fp32 logits' loss; otherwise
    ``config.fused_ce`` takes the chunked head (ops/loss.py), else the
    fp32 logits path. On a ``mesh`` above one device ``tokens`` is the
    global batch and the loss its global mean."""
    if mesh is not None and mesh.size > 1:
        return _sharded_loss(model, params, tokens, mesh)
    aux = 0.0
    if hasattr(model, "apply_with_aux"):
        logits, aux = model.apply_with_aux(params, tokens)
    elif model.config.fused_ce:
        hidden = model(tokens, return_hidden=True, params=params)
        return fused_next_token_xent(
            hidden, param_tree(params)["lm_head"]["kernel"], tokens,
            chunk=model.config.ce_chunk,
        )
    else:
        logits = model(tokens, params=params)  # [b, s, v] fp32
    return next_token_loss(logits, tokens) + aux


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of fp32 logits [b, s, vocab] over
    [b, s] int tokens on one device."""
    targets = tokens[:, 1:].to(device=logits.device, dtype=torch.long)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -ll.mean()


def check_mesh(model_config, mesh_config: MeshConfig) -> None:
    """Refuse a mesh the port does not train on: heads, kv heads, ffn or
    vocab that tp does not split by whole blocks, a width fsdp does not,
    or experts ep does not (ValueError). Any pp passes: the step is
    replicated over it."""
    c, tp = model_config, mesh_config.tp
    if c.n_heads % tp or c.n_kv_heads % tp or c.ffn_dim % tp \
            or c.vocab_size % tp or c.dim % mesh_config.fsdp:
        raise ValueError(
            f"{mesh_config}: tp must split {c.n_heads} heads, "
            f"{c.n_kv_heads} kv heads, ffn {c.ffn_dim} and vocab "
            f"{c.vocab_size}, fsdp the width {c.dim}")
    if isinstance(c, mixtral.MixtralConfig) and c.n_experts % mesh_config.ep:
        raise ValueError(
            f"{mesh_config}: ep must split the {c.n_experts} experts")


class Trainer:
    """Owns the model, the mesh, the optimizer and the train/forward
    steps. The mesh defaults to JAX's: ``MeshConfig.for_device_count``
    of the process group's world (one device without a group); this
    rank's tensors live on the CUDA device unless ``device`` says
    otherwise. The mesh becomes the global one (parallel/context.py)."""

    def __init__(
        self,
        model_config,
        mesh_config: Optional[MeshConfig] = None,
        train_config: TrainConfig = TrainConfig(),
        device=None,
    ):
        if mesh_config is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            mesh_config = MeshConfig.for_device_count(world)
        check_mesh(model_config, mesh_config)
        self.model_config = model_config
        self.model = build_model(model_config)
        self.mesh_config = mesh_config
        self.train_config = train_config
        self.device = resolve_device(device)
        self.mesh = build_mesh(mesh_config, device=self.device)
        set_global_mesh(self.mesh)
        self.optimizer = make_optimizer(train_config, self.mesh)

    def init_state(self, rng: Optional[torch.Generator] = None,
                   batch: int = 1, seq: int = 8) -> Dict:
        """Fresh trainable parameters (drawn whole on ``rng``'s device,
        on every rank alike, then cut to this rank's blocks and moved to
        the trainer's device) and optimizer state: a sharded trainer
        starts from the single-device trainer's weights. ``batch``/``seq``
        are JAX's tracing shapes; torch needs none."""
        del batch, seq
        rng = rng or torch.Generator(device=self.device).manual_seed(0)
        init = (mixtral.init_params
                if isinstance(self.model_config, mixtral.MixtralConfig)
                else init_params)
        params = shard_train_params(
            self.mesh, init(self.model_config, rng, trainable=True))
        params.to(self.device)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": 0}

    def state_shardings(self, state: Dict) -> Dict:
        """The spec tree of ``state``: parameters by ``param_spec``; the
        moments mirror their parameter's spec, the count and the step
        are replicated."""
        params, opt = state["params"], state["opt_state"]

        def opt_sharding(name, leaf):
            if leaf.ndim == 0:
                return replicated(self.mesh)
            return param_spec(_path(name), leaf)

        return {
            "params": param_shardings(self.mesh, params),
            "opt_state": AdamState(
                count=replicated(self.mesh),
                mu={n: opt_sharding(n, t) for n, t in opt.mu.items()},
                nu={n: opt_sharding(n, t) for n, t in opt.nu.items()},
            ),
            "step": replicated(self.mesh),
        }

    def make_train_step(self) -> Callable:
        """(state, tokens [b, s]) -> (state, loss): one forward and
        backward, then the optimizer, which updates the parameters in
        place. On a mesh ``tokens`` is the global batch on every rank and
        the loss its global mean, the same on every rank."""
        model, opt, device, mesh = (self.model, self.optimizer, self.device,
                                    self.mesh)

        def train_step(state, tokens):
            params = state["params"]
            tokens = torch.as_tensor(tokens, device=device)
            params.zero_grad(set_to_none=True)
            # Spans for a profiler trace (no cost without one); the
            # backward runs on autograd's thread, outside any span here.
            with record_function("train_step/forward"), \
                    mesh.in_phase("forward"):
                loss = loss_fn(model, params, tokens, mesh)
            with mesh.in_phase("backward"):
                loss.backward()
            with record_function("train_step/optimizer"):
                grads = {n: p.grad for n, p in params.named_parameters()}
                with mesh.in_phase("grads"):
                    sum_grads(mesh, grads)
                with mesh.in_phase("optimizer"):
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
        """(params, tokens [b, s]) -> fp32 logits [b, s, vocab]; on a
        mesh, the global logits of the global batch on every rank."""
        model, device, mesh = self.model, self.device, self.mesh

        @torch.no_grad()
        def forward(params, tokens):
            tokens = torch.as_tensor(tokens, device=device)
            if mesh.size == 1:
                return model(tokens, params=params)
            r0, r1 = mesh.block(tokens.shape[0], BATCH_AXES)
            c0, c1 = mesh.block(tokens.shape[1], "sp")
            logits = model(tokens[r0:r1, c0:c1], params=params)
            logits = mesh.all_gather_raw(logits, "sp", 1)
            return mesh.all_gather_raw(logits, BATCH_AXES, 0)

        return forward


# --- CLI ----------------------------------------------------------------------

MODEL_PRESETS = {
    "llama3-8b": "LLAMA3_8B",
    "tiny": "TINY_LLAMA",
    "mixtral-8x7b": "MIXTRAL_8X7B",
    "tiny-moe": "TINY_MIXTRAL",
}


def main(argv=None) -> int:
    import argparse

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
        help="global batch (0: one per (dp, fsdp) data shard)",
    )
    p.add_argument("--seq", type=positive_int, default=512)
    p.add_argument(
        "--distributed", action="store_true",
        help="initialize torch.distributed from the driver-injected slice "
             "env",
    )
    p.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA device; 'cpu' for the "
             "plain PyTorch path)",
    )
    p.add_argument(
        "--mesh", type=mesh_flag, default=None,
        help="mesh axes, e.g. 'sp=2' or 'fsdp=2,tp=2' (default: JAX's "
             "MeshConfig.for_device_count of the world)",
    )
    p.add_argument(
        "--attention", default=None,
        choices=("auto", "cuda", "torch", "reference", "ring", "ulysses"),
        help="the model's attention_impl (default: the preset's)",
    )
    p.add_argument("--layers", type=nonnegative_int, default=0,
                   help="cut the preset to this many layers (0: keep)")
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                   help="process group backend (default: NCCL for CUDA, "
                        "gloo for the CPU)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    if not args.distributed:
        return _train(args, args.mesh)
    from tpu_dra_torch.workloads.bootstrap import initialize_from_env, shutdown

    slice_env = initialize_from_env(device=args.device, backend=args.backend)
    log.info("slice bootstrap: %s", slice_env)
    try:
        # JAX's default mesh over every device of the slice, one a rank.
        return _train(args, args.mesh or MeshConfig.for_device_count(
            slice_env.num_processes))
    finally:
        shutdown()


def mesh_flag(text: str) -> MeshConfig:
    """'axis=n,...' -> MeshConfig."""
    try:
        return MeshConfig(**{a.strip(): int(n) for a, n in (
            part.split("=") for part in text.split(",") if part.strip())})
    except (TypeError, ValueError) as e:
        raise ValueError(f"--mesh {text!r}: want axis=n,... over "
                         f"dp, fsdp, sp, tp, ep, pp") from e


def _train(args, mesh_config: Optional[MeshConfig]) -> int:
    from tpu_dra_torch import kernels
    from tpu_dra_torch.workloads import models as models_mod

    model_config = getattr(models_mod, MODEL_PRESETS[args.model])
    if args.layers:
        model_config = dataclasses.replace(model_config, n_layers=args.layers)
    if args.attention:
        model_config = dataclasses.replace(model_config,
                                           attention_impl=args.attention)
    trainer = Trainer(model_config, mesh_config=mesh_config,
                      device=args.device)
    mesh = trainer.mesh
    batch = args.batch or mesh.shape["dp"] * mesh.shape["fsdp"]
    state = trainer.init_state(batch=batch, seq=args.seq)
    step = trainer.make_train_step()
    tokens = torch.from_numpy(
        np.random.default_rng(1)
        .integers(0, model_config.vocab_size, (batch, args.seq))
        .astype(np.int32)
    )
    losses, step_ms, launches = [], [], []
    for _ in range(args.steps):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        state, loss = step(state, tokens)
        losses.append(float(loss))  # waits for the device
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k: n - before.get(k, 0)
                         for k, n in kernels.LAUNCHES.items()
                         if n != before.get(k, 0)})
    loss = losses[-1]
    tok_per_s = args.steps * batch * args.seq / (sum(step_ms) / 1e3)
    log.info(
        "trained %d steps (%s, batch=%d seq=%d, %s, %r): loss=%.4f, "
        "%.0f tok/s", args.steps, args.model, batch, args.seq,
        trainer.device, mesh, loss, tok_per_s,
    )
    collectives = {}
    for key, n in mesh.collectives.items():
        kind = key.split("/", 1)[-1]
        c = collectives.setdefault(kind, {"count": 0, "ms": 0.0, "mb": 0.0,
                                          "staged": 0})
        c["count"] += n
        c["ms"] += mesh.seconds[key] * 1e3
        c["mb"] += mesh.bytes[key] / 1e6
        c["staged"] += mesh.staged[key]
    peak_gb = (torch.cuda.max_memory_allocated(trainer.device) / 1e9
               if trainer.device.type == "cuda" else None)
    print({"ok": loss == loss, "steps": args.steps, "loss": loss,
           "losses": losses, "step_ms": step_ms, "tok_per_s": tok_per_s,
           "peak_memory_gb": peak_gb,
           "device": str(trainer.device), "rank": mesh.rank,
           "mesh": {a: n for a, n in mesh.shape.items() if n > 1},
           "batch": batch, "launches_per_step": launches,
           "collectives": collectives})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
