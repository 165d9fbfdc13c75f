"""JAX parameter tree -> the port's unrolled torch tree.

``params_from_numpy`` takes the flax tree as nested dicts of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the JAX side)
in either layout — scan-stacked ``layers/block/...`` leaves with a
leading ``L`` axis, or unrolled ``layer_{i}`` subtrees — and returns
the unrolled tree (this is the port's copy of
``generate.unroll_params``), cast to ``config.param_dtype`` on
``device``.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` refuses; they go through float32, which holds
every bf16 value exactly, so the copy is bit-exact.

A tree that JAX's ``quantize_params`` made carries its int8 weight-only
leaves ``{"kernel_q": int8 [in, out], "scale": f32 [1, out]}`` across
as they are (int8 and f32, not cast to ``param_dtype``), so it equals
the port's own ``quantize.quantize_params`` of the converted fp32 tree
bit for bit.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.models.llama import LlamaConfig, LlamaParams


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
    tree: dict, config: LlamaConfig, device=None
) -> LlamaParams:
    """Nested dicts of numpy arrays (either JAX layout) -> LlamaParams
    holding the unrolled tree in ``config.param_dtype`` on ``device``
    (default: the CUDA device, see :func:`.device.resolve_device`);
    int8 weight-only leaves keep int8 and f32."""
    device = resolve_device(device)
    return LlamaParams(
        config, _convert(unroll_tree(tree), config.param_dtype, device)
    )
