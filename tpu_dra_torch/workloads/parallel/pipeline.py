"""Pipeline parallelism: the GPipe microbatch relay over the ``pp`` axis.

Counterpart of ``tpu_dra/workloads/parallel/pipeline.py``, with JAX's
names. JAX runs the relay as a ``lax.scan`` over ``n_microbatches + pp -
1`` ticks inside a ``shard_map`` over ``pp`` and lets XLA derive the
backward from the scan and ``ppermute`` transposes. The port is
multi-controller (:mod:`.mesh`): every rank of the training mesh runs
the same ticks on its own stage, and the collectives JAX's transpose
would insert are the conjugate backwards of :class:`.mesh.TrainMesh`'s
differentiable collectives:

- the input enters through ``all_reduce_grad`` over pp (forward
  identity, backward all_reduce): shard_map transposes a replicated
  input (``in_specs`` ``P(None)``) into the sum of the stages'
  cotangents, and only stage 0 reads it;
- stage hand-off is ``ppermute`` over pp, the cyclic shift ``(i, (i + 1)
  % pp)``, whose backward is the inverse shift;
- the last stage's outputs reach every rank through ``all_reduce`` over
  pp of ``where(last stage, outs, 0)``, whose backward is the identity:
  the loss downstream is replicated over pp.

Every rank computes every tick, the bubble ticks on zeros, as JAX does,
and picks its stage's input with a tensor ``where`` on a 0-d mask, never
a host ``if`` on its coordinate: every rank's graph then holds every
tick's ``ppermute``, so every rank's backward runs every tick's inverse
shift and no peer's send is left waiting. Decisions that depend only on
the tick (which microbatch is fed, which output is stored) are the same
on every rank and stay on the host. The last tick's hand-off feeds
nothing and is not issued.

``stage_fn`` must keep the shape and dtype of its input block (true of
transformer layer stacks). Inside :func:`pipelined_llama_forward` the
stage runs with no global mesh: the tree is whole on every rank, as JAX
replicates ``embed``, ``final_norm`` and ``lm_head`` and feeds the stage
whole operands (``P(None)`` over every axis but pp), so the work of a
stage is replicated over the other axes of the mesh.

``python -m tpu_dra_torch.workloads.pipestep`` runs one pipelined step
of a preset against the unpipelined one.
"""

from __future__ import annotations

import contextlib
from collections.abc import Mapping
from typing import Any, Callable, List

import torch
import torch.nn.functional as F

from tpu_dra_torch.workloads.parallel.context import (
    get_global_mesh,
    set_global_mesh,
)


def _tree_map(fn, node):
    if isinstance(node, Mapping):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_tree_map(fn, v) for v in node)
    return fn(node)


def _stage_count_error(n_layers: int, n_stages: int) -> ValueError:
    return ValueError(
        f"layer count {n_layers} not divisible by {n_stages} stages")


def partition_stages(layer_params: Any, n_stages: int) -> Any:
    """Reshape a stacked-layer tree ``[L, ...]`` into stage-major
    ``[n_stages, L/n_stages, ...]`` (the leading dim is the stage)."""

    def reshape(a):
        if a.shape[0] % n_stages:
            raise _stage_count_error(a.shape[0], n_stages)
        return a.reshape(n_stages, a.shape[0] // n_stages, *a.shape[1:])

    return _tree_map(reshape, layer_params)


def stage_layer_names(n_layers: int, mesh, axis: str = "pp") -> List[str]:
    """The port's unrolled tree cut by stage: the ``layer_{i}`` names of
    this rank's stage ``s = mesh.index(axis)``, ``i`` in ``[s·L/pp,
    (s+1)·L/pp)``."""
    pp = mesh.axis_size(axis)
    if n_layers % pp:
        raise _stage_count_error(n_layers, pp)
    per, s = n_layers // pp, mesh.index(axis)
    return [f"layer_{i}" for i in range(s * per, (s + 1) * per)]


def _relay(stage_fn: Callable, stage: Any, x: torch.Tensor, *extra,
           mesh, axis: str, n_microbatches: int) -> torch.Tensor:
    """The relay with ``stage`` this rank's own stage parameters."""
    pp = mesh.axis_size(axis)
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(
            f"batch {batch} not divisible by {n_microbatches} microbatches")
    idx = mesh.index(axis)
    xs = mesh.all_reduce_grad(x, axis).reshape(
        n_microbatches, batch // n_microbatches, *x.shape[1:])
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == pp - 1, device=x.device)
    zeros = xs.new_zeros(xs.shape[1:])
    n_steps = n_microbatches + pp - 1
    state, outs = zeros, []
    for t in range(n_steps):
        # Stage 0 feeds microbatch t (zeros in the drain bubble); later
        # stages take the relayed activation.
        fed = xs[t] if t < n_microbatches else zeros
        y = stage_fn(stage, torch.where(first, fed, state), *extra)
        # The last stage finishes microbatch t - (pp - 1) at tick t.
        if t >= pp - 1:
            outs.append(y)
        if t < n_steps - 1:
            state = mesh.ppermute(y, axis, 1)
    outs = torch.stack(outs)
    # Only the last stage holds real outputs: the sum hands them to all.
    outs = mesh.all_reduce(torch.where(last, outs, torch.zeros_like(outs)),
                           axis)
    return outs.reshape(batch, *x.shape[1:])


def pipeline_apply(
    stage_fn: Callable,
    stage_params: Any,
    x: torch.Tensor,
    *extra: Any,
    mesh,
    axis: str = "pp",
    n_microbatches: int,
) -> torch.Tensor:
    """Run ``x`` through the ``pp`` pipelined stages of ``stage_fn`` on
    the training ``mesh`` (:func:`.mesh.build_mesh`).

    - ``stage_params``: a tree of tensors with a leading ``[pp, ...]``
      stage dim (see :func:`partition_stages`); this rank's stage is
      entry ``mesh.index(axis)``, and ``stage_fn(stage, x_mb, *extra)``
      gets it without the stage dim.
    - ``x``: ``[batch, ...]``, the same on every rank; split into
      ``n_microbatches`` along batch, ``batch % n_microbatches == 0``.
    - ``extra``: stage-invariant side inputs (the RoPE tables).

    Returns ``stage_fn`` applied by every stage in sequence, microbatch-
    pipelined, on every rank: tick ``t`` has stage ``i`` working
    microbatch ``t - i`` while ``ppermute`` relays activations around
    the stage ring."""
    idx = mesh.index(axis)
    stage = _tree_map(lambda a: a[idx], stage_params)
    return _relay(stage_fn, stage, x, *extra, mesh=mesh, axis=axis,
                  n_microbatches=n_microbatches)


@contextlib.contextmanager
def _no_global_mesh():
    """The model's modules run their single-device forward inside."""
    outer = get_global_mesh()
    set_global_mesh(None)
    try:
        yield
    finally:
        set_global_mesh(outer)


def pipelined_llama_forward(
    config,
    params,
    tokens: torch.Tensor,
    *,
    mesh,
    axis: str = "pp",
    n_microbatches: int,
) -> torch.Tensor:
    """Llama forward with the decoder stack pipelined over ``axis``:
    the embedding and RoPE for positions ``0..s-1``, this rank's stage
    of layers (:func:`stage_layer_names`) through ``LlamaBlock`` in
    order on each tick of the relay, then the final norm and
    ``lm_head`` -> fp32 logits ``[b, s, vocab]`` on every rank.

    ``params``: the port's unrolled tree (a LlamaParams or its nested
    dict), whole on every rank; ``tokens`` ``[b, s]``, the same on every
    rank. Numerically the unpipelined forward (same modules, same order,
    no remat); only this stage's layers get gradients, and ``embed``,
    ``final_norm`` and ``lm_head`` get the whole gradient on every rank.
    Requires ``config.scan_layers`` (JAX re-cuts its stacked layers into
    stages) and ``config.n_layers % pp == 0``."""
    from tpu_dra_torch.workloads.models.llama import (
        LlamaBlock,
        RMSNorm,
        param_tree,
        rope_frequencies,
    )
    from tpu_dra_torch.workloads.ops.decode_mlp import _mm

    c = config
    if not c.scan_layers:
        raise ValueError("pipelined forward needs scan_layers=True")
    names = stage_layer_names(c.n_layers, mesh, axis)
    tree = param_tree(params)
    emb = tree["embed"]["embedding"]
    block = LlamaBlock(c)

    def stage_fn(layers, x, cos, sin):
        for p in layers:
            x = block(p, x, cos, sin)
        return x

    with _no_global_mesh():
        x = F.embedding(tokens.to(device=emb.device, dtype=torch.long), emb)
        x = x.to(c.dtype)
        cos, sin = rope_frequencies(
            c, torch.arange(tokens.shape[1], device=x.device))
        x = _relay(stage_fn, [tree[n] for n in names], x, cos, sin,
                   mesh=mesh, axis=axis, n_microbatches=n_microbatches)
        x = RMSNorm(c.norm_eps)(tree["final_norm"], x)
        return _mm(x, tree["lm_head"]).to(torch.float32)

