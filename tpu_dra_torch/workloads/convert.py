"""JAX parameter tree -> the port's unrolled torch tree.

``params_from_numpy`` takes the flax tree of a Llama or a Mixtral as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)`` on the JAX side) in either layout — scan-stacked
``layers/block/...`` leaves with a leading ``L`` axis (Mixtral's
experts ``[L, E, d, f]``), or unrolled ``layer_{i}`` subtrees — and
returns the unrolled tree (this is the port's copy of
``generate.unroll_params``), cast to ``config.param_dtype`` on
``device``, in the family's parameter module.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` refuses; they go through float32, which holds
every bf16 value exactly, so the copy is bit-exact.

A tree that JAX's ``quantize_params`` made carries its int8 weight-only
leaves ``{"kernel_q": int8 [in, out], "scale": f32 [1, out]}`` across
as they are (int8 and f32, not cast to ``param_dtype``), so it equals
the port's own ``quantize.quantize_params`` of the converted fp32 tree
bit for bit.

For training, ``params_from_numpy(..., trainable=True)`` gives a tree
whose leaves carry gradients, ``opt_state_from_numpy`` turns optax's
AdamW state into the port's (so a step resumed from a JAX checkpoint
matches JAX's), and ``params_to_numpy`` goes back the other way.
``train_state_from_numpy`` is the one path from a JAX training state to
a Trainer's: both converted, then cut to a mesh rank's blocks
(``parallel.mesh.shard_train_params`` / ``shard_opt_state``).

``extent_from_numpy`` is the state counterpart: a JAX ``KVExtent``
(numpy payload) becomes the port's :class:`~.paged_kv.KVExtent`, bf16
pages carried through their 16-bit patterns, not through float32.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.models.llama import LlamaConfig, LlamaParams
from tpu_dra_torch.workloads.models.mixtral import MixtralConfig, MixtralParams


def _leaf(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    # A copy: JAX hands out read-only buffers, and the port's tensors
    # must own their memory.
    return torch.tensor(arr).to(device=device, dtype=dtype)


def _map(node, fn):
    if isinstance(node, Mapping):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node)


def unroll_tree(tree: dict) -> dict:
    """Stacked tree -> ``layer_{i}`` layout by slicing every ``[L, ...]``
    leaf of the scanned block; identity for unrolled trees."""
    if "layers" not in tree:
        return tree
    block = tree["layers"]["block"]
    first = block
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i in range(first.shape[0]):
        out[f"layer_{i}"] = _map(block, lambda leaf, i=i: leaf[i])
    return out


def _convert(node, dtype: torch.dtype, device):
    if not isinstance(node, Mapping):
        return _leaf(node, dtype, device)
    if "kernel_q" in node:  # int8 weight-only leaf: keep its types
        return {
            "kernel_q": _leaf(node["kernel_q"], torch.int8, device),
            "scale": _leaf(node["scale"], torch.float32, device),
        }
    return {k: _convert(v, dtype, device) for k, v in node.items()}


def params_from_numpy(
    tree: dict, config: "LlamaConfig | MixtralConfig", device=None,
    trainable: bool = False,
) -> LlamaParams:
    """Nested dicts of numpy arrays (either JAX layout) -> the family's
    parameter module (LlamaParams, MixtralParams) holding the unrolled
    tree in ``config.param_dtype`` on ``device`` (default: the CUDA
    device, see :func:`.device.resolve_device`); int8 weight-only leaves
    keep int8 and f32. ``trainable`` makes the floating leaves carry
    gradients."""
    device = resolve_device(device)
    module = MixtralParams if isinstance(config, MixtralConfig) else LlamaParams
    return module(
        config, _convert(unroll_tree(tree), config.param_dtype, device),
        trainable,
    )


def params_to_numpy(params: "LlamaParams | dict") -> dict:
    """The unrolled tree as nested dicts of numpy arrays: float leaves
    as float32 (every bf16 value exactly), others in their own type."""
    tree = params.tree() if isinstance(params, LlamaParams) else params

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    return _map(tree, leaf)


def _flat_names(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat_names(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _find_adam(state):
    """The ScaleByAdamState (anything with count, mu and nu) inside
    optax's nested chain state."""
    if all(hasattr(state, a) for a in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _find_adam(sub)
            if found is not None:
                return found
    return None


def opt_state_from_numpy(
    state, config: "LlamaConfig | MixtralConfig", device=None
) -> "AdamState":
    """optax's state for ``make_optimizer`` — ``(EmptyState(),
    (ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState()))``
    with numpy leaves (``jax.tree_util.tree_map(np.asarray, state)``),
    mu and nu in either JAX layout — -> the port's AdamState: count
    int32, mu fp32, nu in ``config.param_dtype``, keyed by parameter
    name."""
    # Imported here: train imports parallel.mesh, which imports this
    # module.
    from tpu_dra_torch.workloads.train import AdamState

    device = resolve_device(device)
    adam = _find_adam(state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the state")
    return AdamState(
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                           device=device),
        mu={n: _leaf(a, torch.float32, device)
            for n, a in _flat_names(unroll_tree(adam.mu)).items()},
        nu={n: _leaf(a, config.param_dtype, device)
            for n, a in _flat_names(unroll_tree(adam.nu)).items()},
    )


def train_state_from_numpy(params, opt_state, config, mesh=None,
                           device=None, step: int = 0) -> dict:
    """A JAX training state (its params and optax state as numpy trees,
    either layout) -> a Trainer's state on ``device``: trainable
    parameters and AdamW state, cut to this rank's blocks of ``mesh``
    (a ``parallel.mesh.TrainMesh``; whole without one)."""
    from tpu_dra_torch.workloads.parallel.mesh import (
        shard_opt_state,
        shard_train_params,
    )

    p = params_from_numpy(params, config, device=device, trainable=True)
    o = opt_state_from_numpy(opt_state, config, device=device)
    if mesh is not None:
        p, o = shard_train_params(mesh, p), shard_opt_state(mesh, o)
    return {"params": p, "opt_state": o, "step": step}


def _bits_leaf(arr, device) -> torch.Tensor:
    """A numpy array -> a tensor of the same dtype and bits on
    ``device``; ml_dtypes bfloat16 goes through its 16-bit pattern.
    A copy: JAX hands out read-only buffers."""
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(arr).to(device)


def extent_from_numpy(extent, device=None):
    """A JAX ``paged_kv.KVExtent`` (payload: pool name -> L-tuple of
    numpy arrays) -> the port's ``KVExtent`` with its payload on
    ``device`` (default: the CUDA device, see
    :func:`.device.resolve_device`), bit for bit."""
    # Imported here: paged_kv imports generate, which imports this
    # module.
    from tpu_dra_torch.workloads.paged_kv import KVExtent

    device = resolve_device(device)
    return KVExtent(
        page_size=int(extent.page_size),
        length=int(extent.length),
        quantized=bool(extent.quantized),
        slots=tuple((str(kind), int(val)) for kind, val in extent.slots),
        payload={
            name: tuple(_bits_leaf(a, device) for a in layers)
            for name, layers in extent.payload.items()
        },
    )
