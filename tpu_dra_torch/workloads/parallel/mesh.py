"""The (batch x model) decode mesh over a torch.distributed group.

Counterpart of the decode half of ``tpu_dra/workloads/parallel/mesh.py``
(``DECODE_AXES`` through ``decode_pool_sharding``), with JAX's names.
JAX compiles one GSPMD program over every chip the rendered env
exposes. The port is multi-controller, as JAX is on a multi-host
slice: every rank of the default process group (joined by
:func:`.bootstrap.rendezvous` / :func:`.bootstrap.initialize_from_env`)
runs the same engine on the same requests, its host decisions the same
on every rank, and only the device math is sharded.

EXACTNESS CONTRACT (the reference's): sharded decode is
TOKEN-IDENTICAL to unsharded decode, so the model axis shards only
non-contracted dimensions:

- ``wq``/``wk``/``wv`` by heads, ``w_gate``/``w_up`` by ffn columns,
  ``lm_head`` by vocab, and the KV pools by kv heads;
- ``wo``, ``w_down``, ``embed`` and the norms stay replicated;
- their inputs arrive by ``all_gather`` over the model axis — the
  attention output before ``wo``, ``silu(gate)·up`` before ``w_down``
  (three gathers a layer with the logits' one) and the ``lm_head``
  logits — and never by an all-reduce, so every output element is one
  full-length dot product.

Shards are contiguous: model coordinate ``j`` holds columns
``[j·n/m, (j+1)·n/m)`` of a sharded leaf, so with GQA its q heads
``[j·h/m, ...)`` use exactly its kv heads ``[j·kvh/m, ...)``, and a
gather concatenates the shards in the unsharded column order. An int8
weight-only leaf's per-column ``scale`` takes its ``kernel_q``'s column
slice (JAX replicates it and lets GSPMD slice it).

The batch axis splits the engine's decode rows (``decode_data_sharding``)
when ``max_slots`` tiles it, and the pools are replicated over it
(``decode_pool_sharding``): each decode step gathers the new position's
K/V rows over the batch axis before the pool write, and each chunk its
tokens. Prefill runs replicated over the batch axis, as in JAX.

Specs are tuples of axis names or None, ``()`` meaning replicated: the
tuples of JAX's ``PartitionSpec``s. With no process group, or a world of
one, the mesh is (1, 1): it builds no group and issues no collective,
so the single-card path launches exactly what the unsharded engine
launches.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import time
from collections.abc import Mapping
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_dra_torch.workloads.convert import unroll_tree
from tpu_dra_torch.workloads.device import resolve_device
from tpu_dra_torch.workloads.models.llama import as_tree

DECODE_AXES = ("batch", "model")

DECODE_PARAM_RULES: List[Tuple[str, tuple]] = [
    (r".*(wq|wk|wv).*kernel$", (None, "model")),  # [d, heads*hd]
    (r".*(w_gate|w_up).*kernel$", (None, "model")),  # [d, ffn]
    (r".*lm_head.*kernel$", (None, "model")),  # [d, vocab]
    # wo / w_down / embed / norms / quant scales: replicated (see the
    # exactness contract above).
]

#: The impls ``sharded_safe_config`` forces on a mesh of more than one
#: device: the plain PyTorch version of every kernel-capable op.
PLAIN_IMPLS = dict(
    attention_impl="torch", decode_impl="torch", decode_mlp_impl="torch",
    paged_decode_impl="torch",
)


def _flatten_path(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def decode_mesh_shape(n_devices: int, config=None) -> Tuple[int, int]:
    """(batch, model) axis sizes for ``n_devices`` ranks: the ladder
    (2, n/2) at 8+, (2, 2) at 4, (1, 2) at 2, (1, 1) on one, with the
    model axis clamped down by steps of 1 to the largest value that
    divides the device count and every dimension it shards (kv heads,
    ffn, vocab), the remainder folded into batch: 12 devices with 8 kv
    heads land on (3, 4), not on a batch-only mesh."""
    if n_devices >= 8:
        b_axis, m_axis = 2, n_devices // 2
    elif n_devices >= 4:
        b_axis, m_axis = 2, 2
    elif n_devices >= 2:
        b_axis, m_axis = 1, 2
    else:
        b_axis, m_axis = 1, 1
    if config is not None:
        while m_axis > 1 and (
            n_devices % m_axis
            or config.n_kv_heads % m_axis
            or config.ffn_dim % m_axis
            or config.vocab_size % m_axis
        ):
            m_axis -= 1
        b_axis = n_devices // m_axis
    return b_axis, m_axis


class DecodeMesh:
    """This rank's view of the decode mesh: the axis sizes (``shape``,
    as JAX's ``Mesh.shape``), the global ranks it covers in row-major
    (batch, model) order, this rank's coordinates (None for a rank
    outside the mesh), the device its tensors live on, and the process
    subgroups of its model row, its batch column and the whole mesh
    (None where an axis has size 1).

    ``collectives`` counts the collectives issued, by kind (``model``,
    ``batch``, ``clock``), the kind prefixed ``<phase>/`` for those
    issued inside :meth:`in_phase` (the engine's ``decode/``);
    ``gather_seconds`` and ``gather_bytes`` the host seconds and
    received bytes of the gathers, under the same keys."""

    def __init__(self, shape: Tuple[int, int], ranks: Sequence[int],
                 rank: int, device, groups: Optional[dict] = None):
        b, m = shape
        self.shape = {"batch": b, "model": m}
        self.axis_names = DECODE_AXES
        self.ranks = tuple(ranks)
        self.rank = rank
        self.device = torch.device(device)
        self.coords = (
            divmod(self.ranks.index(rank), m) if rank in self.ranks else None
        )
        groups = groups or {}
        self.model_group = groups.get("model")
        self.batch_group = groups.get("batch")
        self.group = groups.get("mesh")
        self.collectives: collections.Counter = collections.Counter()
        self.gather_seconds: collections.Counter = collections.Counter()
        self.gather_bytes: collections.Counter = collections.Counter()
        self.phase: Optional[str] = None

    def __repr__(self) -> str:
        return (f"DecodeMesh(batch={self.shape['batch']}, "
                f"model={self.shape['model']}, rank={self.rank}, "
                f"coords={self.coords})")

    @property
    def size(self) -> int:
        return self.shape["batch"] * self.shape["model"]

    @property
    def member(self) -> bool:
        return self.coords is not None

    def require_member(self) -> None:
        if not self.member:
            raise ValueError(
                f"rank {self.rank} is outside the {self.shape['batch']}x"
                f"{self.shape['model']} decode mesh over ranks "
                f"{list(self.ranks)}: it holds no shard and takes no part "
                f"in sharded decode"
            )

    def row_block(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of the ``n`` batch rows this rank's batch coordinate
        holds when they split over the batch axis."""
        b = self.shape["batch"]
        i = self.coords[0]
        return i * n // b, (i + 1) * n // b

    @contextlib.contextmanager
    def in_phase(self, phase: str):
        """Count the collectives issued inside under ``<phase>/<kind>``."""
        outer, self.phase = self.phase, phase
        try:
            yield
        finally:
            self.phase = outer

    def _key(self, kind: str) -> str:
        return kind if self.phase is None else f"{self.phase}/{kind}"

    def _gather(self, axis: str, group, n: int, x: torch.Tensor,
                dim: int) -> torch.Tensor:
        if n == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        t0 = time.perf_counter()
        dist.all_gather(parts, x, group=group)
        key = self._key(axis)
        self.gather_seconds[key] += time.perf_counter() - t0
        self.gather_bytes[key] += x.numel() * x.element_size() * n
        self.collectives[key] += 1
        return torch.cat(parts, dim=dim)

    def gather_model(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The model row's shards of ``x`` concatenated along ``dim`` in
        model-coordinate order (the unsharded column order); ``x`` itself
        on a model axis of 1."""
        return self._gather("model", self.model_group, self.shape["model"],
                            x, dim)

    def gather_batch(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The batch column's row blocks of ``x`` concatenated along
        ``dim`` in batch-coordinate order; ``x`` itself on a batch axis
        of 1."""
        return self._gather("batch", self.batch_group, self.shape["batch"],
                            x, dim)

    def agree(self, now: float, ready: bool = True) -> Tuple[float, bool]:
        """One clock reading and gate state for every rank of the mesh:
        the first rank's ``now``, and ``ready`` only when every rank's
        gate is ready. Host decisions read these, so every rank admits,
        stalls and schedules alike whatever its own clock says. One
        all_gather over the mesh; the values themselves on a mesh of
        one."""
        if self.size == 1:
            return now, ready
        host = dist.get_backend(self.group) == "gloo"
        mine = torch.tensor([now, float(ready)], dtype=torch.float64,
                            device="cpu" if host else self.device)
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        self.collectives[self._key("clock")] += 1
        rows = torch.stack(parts).cpu().tolist()
        return rows[0][0], all(r[1] != 0.0 for r in rows)


def build_decode_mesh(config=None, ranks: Optional[Sequence[int]] = None,
                      device=None) -> DecodeMesh:
    """(batch x model) decode mesh over the ranks of the default process
    group (``ranks``, default all of them, in order); a count that the
    shape does not tile uses the largest usable prefix, as JAX does with
    devices. Every rank of the default group must call it with the same
    ``ranks``: it creates one subgroup a model row, one a batch column
    and one for the mesh, in that order, and a rank outside the prefix
    takes part in creating them and gets a mesh whose ``coords`` are
    None (:meth:`DecodeMesh.require_member` then refuses it). Without a
    process group, or over one rank, the mesh is (1, 1) and no group is
    created. ``device``: where this rank's tensors live (default: the
    CUDA device)."""
    device = resolve_device(device)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if not ranks or len(set(ranks)) != len(ranks) or not all(
            0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world "
                         f"of {world}")
    b, m = decode_mesh_shape(len(ranks), config)
    used = ranks[: b * m]
    groups = {}
    if b * m > 1:
        rows = [dist.new_group(used[i * m:(i + 1) * m]) for i in range(b)] \
            if m > 1 else None
        cols = [dist.new_group(used[j::m]) for j in range(m)] \
            if b > 1 else None
        groups["mesh"] = dist.new_group(used)
        if rank in used:
            i, j = divmod(used.index(rank), m)
            groups["model"] = rows[i] if rows else None
            groups["batch"] = cols[j] if cols else None
    return DecodeMesh((b, m), used, rank, device, groups)


def sharded_safe_config(config, mesh: DecodeMesh):
    """The config for decode on ``mesh``: over more than one device,
    every kernel-capable op (``attention_impl``, ``decode_impl``,
    ``decode_mlp_impl``, ``paged_decode_impl``) takes its plain PyTorch
    version, as JAX takes XLA's (its Pallas calls have no partitioning
    rule; here the fused MLP kernel cannot run between a column-parallel
    ``up`` and a replicated ``down``). On a (1, 1) mesh the config itself
    comes back, so a single card keeps its kernels."""
    if mesh.size <= 1:
        return config
    return dataclasses.replace(config, **PLAIN_IMPLS)


def decode_param_spec(path: str, value=None) -> tuple:
    """Decode-mesh spec of one parameter leaf by path: int8 weight-only
    ``kernel_q`` leaves take their plain kernel's spec; their per-column
    scales are replicated here, as in JAX (``shard_decode_params`` cuts
    them with their kernel). Leaves of more dims than the rule (a
    stacked layer axis) get leading Nones."""
    path = re.sub(r"/kernel_q$", "/kernel", path)
    for pattern, spec in DECODE_PARAM_RULES:
        if re.fullmatch(pattern, path):
            if value is not None and getattr(value, "ndim", 0) > len(spec):
                return (None,) * (value.ndim - len(spec)) + spec
            return spec
    return ()


def _map_with_path(node, fn, path=()):
    if isinstance(node, Mapping):
        return {k: _map_with_path(v, fn, path + (k,)) for k, v in node.items()}
    return fn(path, node)


def decode_param_shardings(mesh: DecodeMesh, params):
    """The spec tree of a decode parameter tree (either layout)."""
    del mesh  # the specs name axes; the mesh sizes them
    return _map_with_path(
        as_tree(params),
        lambda path, leaf: decode_param_spec(_flatten_path(path), leaf))


class ShardedParams(dict):
    """This rank's shard of a decode parameter tree (the unrolled
    layout) and the mesh it belongs to: ``greedy_generate``,
    ``forward_chunk`` and the engine read the mesh off the tree, as JAX
    reads the shardings off its arrays."""

    def __init__(self, tree: dict, mesh: DecodeMesh):
        super().__init__(tree)
        self.mesh = mesh


def params_mesh(params) -> Optional[DecodeMesh]:
    """The mesh a tree from :func:`shard_decode_params` carries, else
    None."""
    return getattr(params, "mesh", None)


def with_mesh(tree: dict, mesh: Optional[DecodeMesh]) -> dict:
    """A shard's tree carrying ``mesh`` again after a rebuild (device
    move, quantization); ``tree`` itself without a mesh."""
    return tree if mesh is None else ShardedParams(tree, mesh)


def _column_block(t: torch.Tensor, spec: tuple, mesh: DecodeMesh,
                  path: str) -> torch.Tensor:
    m = mesh.shape["model"]
    if m == 1:
        return t
    j = mesh.coords[1]
    for d, axis in enumerate(spec):
        if axis != "model":
            continue
        n = t.shape[d]
        if n % m:
            raise ValueError(
                f"{path}: dim {d} of {tuple(t.shape)} does not split over "
                f"a model axis of {m}")
        t = t.narrow(d, j * (n // m), n // m).contiguous()
    return t


def shard_decode_params(mesh: DecodeMesh, params) -> ShardedParams:
    """This rank's shard of ``params`` (a LlamaParams, or a nested dict
    in either layout, plain or int8 weight-only), unrolled, as a
    :class:`ShardedParams` carrying ``mesh``: the contiguous column block
    of each model-sharded leaf (an int8 leaf's scale cut with its
    kernel), every other leaf as it is. On a (1, 1) mesh nothing is
    copied. A rank outside the mesh raises ValueError."""
    mesh.require_member()

    def walk(node, path):
        if isinstance(node, Mapping) and "kernel_q" in node:
            spec = decode_param_spec(f"{path}/kernel_q", node["kernel_q"])
            return {k: _column_block(v, spec, mesh, f"{path}/{k}")
                    for k, v in node.items()}
        if isinstance(node, Mapping):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        return _column_block(node, decode_param_spec(path, node), mesh, path)

    return with_mesh(walk(unroll_tree(as_tree(params)), ""), mesh)


def decode_data_sharding(mesh: DecodeMesh, batch: int) -> tuple:
    """Spec of batch-leading decode arrays (tokens, lengths, block
    tables, active masks, q rows): split over the batch axis when it
    tiles ``batch``, replicated otherwise (an odd slot count still
    runs)."""
    return ("batch",) if batch % mesh.shape["batch"] == 0 else ()


def decode_pool_sharding(mesh: DecodeMesh, kv_heads: int, ndim: int) -> tuple:
    """Spec of the paged KV pools ([P, page, kvh, hd] values, [P, page,
    kvh] int8 scales): the kv-head axis over the model axis (exact:
    heads are independent until the replicated ``wo``), replicated when
    ``kv_heads`` does not tile it."""
    if kv_heads % mesh.shape["model"] == 0:
        return (None, None, "model", None) if ndim == 4 else (
            None, None, "model")
    return ()


def local_kv_heads(mesh: Optional[DecodeMesh], kv_heads: int) -> int:
    """The kv heads of this rank's pools and caches."""
    if mesh is None or "model" not in decode_pool_sharding(mesh, kv_heads, 4):
        return kv_heads
    return kv_heads // mesh.shape["model"]


def check_decode_config(config, mesh: Optional[DecodeMesh]) -> None:
    """Refuse a config whose heads do not split over the mesh's model
    axis by whole kv heads (the column shards of ``wk``/``wv`` must be
    the pools' kv heads)."""
    if mesh is None:
        return
    mesh.require_member()
    m = mesh.shape["model"]
    if config.n_kv_heads % m or config.n_heads % m:
        raise ValueError(
            f"{config.n_heads} heads over {config.n_kv_heads} kv heads do "
            f"not split over a model axis of {m}")


def gather_model(mesh: Optional[DecodeMesh], x: torch.Tensor,
                 dim: int = -1) -> torch.Tensor:
    """:meth:`DecodeMesh.gather_model`, the identity without a mesh."""
    return x if mesh is None else mesh.gather_model(x, dim)
