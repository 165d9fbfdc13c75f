"""Global mesh context.

Counterpart of ``tpu_dra/workloads/parallel/context.py``. The active
training mesh (:class:`.mesh.TrainMesh`) is process-global state, one
mesh a training job, as in JAX: the model's sharded forward, ring and
Ulysses attention look it up here instead of threading it through every
module. ``Trainer`` sets it; tests reset it with
``set_global_mesh(None)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

_mesh = None


def set_global_mesh(mesh) -> None:
    global _mesh
    _mesh = mesh


def get_global_mesh():
    return _mesh


def sequence_parallel_plan(axis_name: str, mesh=None) -> Optional[Tuple]:
    """Shared preamble of the sequence-parallel attention impls (ring,
    Ulysses): the active mesh (``mesh``, else the global one) and the
    [batch, seq, head, dim] spec of their inputs, as a tuple of axis
    names, with the batch axes. None when no mesh is active or the axis
    has size 1: the caller falls back to single-device attention."""
    mesh = mesh or get_global_mesh()
    if mesh is None or mesh.shape.get(axis_name, 1) == 1:
        return None
    batch_axes = tuple(a for a in ("dp", "fsdp") if a in mesh.shape)
    spec = (batch_axes or None, axis_name, None, None)
    return mesh, spec, batch_axes
