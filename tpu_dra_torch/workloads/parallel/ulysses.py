"""Ulysses-style all-to-all sequence parallelism.

Counterpart of ``tpu_dra/workloads/parallel/ulysses.py``, the complement
of ring attention on the long-context axis: one all_to_all re-shards the
activations from sequence-sharded to head-sharded, full-sequence
attention runs locally on a head group (so the flash kernels apply
unchanged), and a second all_to_all restores sequence sharding. Two
collectives a layer of O(b·s·h·d/n) each, against the ring's n
point-to-point steps.

Constraint: n_heads (after GQA expansion) must be divisible by the
``sp`` axis size. As with ring attention, the port takes this rank's
local block, not the global arrays.
"""

from __future__ import annotations

import torch

from tpu_dra_torch.workloads.ops.attention import (
    _repeat_kv,
    sequence_attention,
)
from tpu_dra_torch.workloads.parallel.context import sequence_parallel_plan

AXIS = "sp"


def _seq_to_heads(mesh, x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """[b, s/n, h, hd] -> [b, s, h/n, hd]: head group j to rank j, the
    chunks received concatenated in rank order."""
    n = mesh.axis_size(axis_name)
    b, s, h, hd = x.shape
    x = x.reshape(b, s, n, h // n, hd).permute(2, 0, 1, 3, 4).contiguous()
    x = mesh.all_to_all(x, axis_name)  # [n (source chunk), b, s, h/n, hd]
    return x.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, hd)


def _heads_to_seq(mesh, x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """[b, s, h/n, hd] -> [b, s/n, h, hd]: chunk j to rank j, the head
    groups received concatenated in rank order."""
    n = mesh.axis_size(axis_name)
    b, s_all, hl, hd = x.shape
    s = s_all // n
    x = x.reshape(b, n, s, hl, hd).permute(1, 0, 2, 3, 4).contiguous()
    x = mesh.all_to_all(x, axis_name)  # [n (source heads), b, s, h/n, hd]
    return x.permute(1, 2, 0, 3, 4).reshape(b, s, n * hl, hd)


def _ulysses_local(q, k, v, *, mesh, axis_name: str):
    """Per-rank body: [b, s/n, h, hd] -> attention -> [b, s/n, h, hd]."""
    q, k, v = (_seq_to_heads(mesh, t, axis_name) for t in (q, k, v))
    out = sequence_attention(q, k, v)
    return _heads_to_seq(mesh, out, axis_name)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = AXIS, mesh=None) -> torch.Tensor:
    """Causal attention with all-to-all sequence parallelism over this
    rank's block (q [b, s/sp, h, hd]). Falls back to single-device
    attention when no mesh is active or ``sp`` is 1."""
    plan = sequence_parallel_plan(axis_name, mesh)
    if plan is None:
        return sequence_attention(q, k, v)
    mesh = plan[0]
    n = mesh.shape[axis_name]
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses attention needs n_heads ({q.shape[2]}) divisible by "
            f"the {axis_name} axis ({n})"
        )
    if k.shape[2] % n:
        # KV heads don't split evenly: materialize the GQA repeat up front.
        # Costs n_rep in collective volume — only the fallback.
        n_rep = q.shape[2] // k.shape[2]
        k = _repeat_kv(k, n_rep)
        v = _repeat_kv(v, n_rep)
    # else: exchange the un-repeated K/V (kvh/n heads a rank) and let the
    # local attention resolve GQA by head grouping — n_rep x less volume.
    return _ulysses_local(q, k, v, mesh=mesh, axis_name=axis_name)
