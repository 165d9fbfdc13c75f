"""Device meshes over a torch.distributed group: the training mesh and
the (batch x model) decode mesh.

Counterpart of ``tpu_dra/workloads/parallel/mesh.py``, with JAX's names.
JAX compiles one GSPMD program over every chip the rendered env exposes
and lets XLA insert the collectives. The port is multi-controller, as
JAX is on a multi-host slice: every rank of the default process group
(joined by :func:`.bootstrap.rendezvous` /
:func:`.bootstrap.initialize_from_env`) runs the same program on its own
shards, plain tensors whose layout a spec tuple names, and every
collective GSPMD would insert, forward and backward, is written out.
Specs are tuples of axis names or None, ``()`` meaning replicated: the
tuples of JAX's ``PartitionSpec``s.

TRAINING MESH (JAX's ``AXES`` through ``replicated``). Ranks lie
row-major over ``(pp, dp, fsdp, ep, sp, tp)``, tp innermost, as JAX
lays out devices. Parameters shard by ``PARAM_RULES``: a dim named
``fsdp`` is cut over fsdp, one named ``tp`` over tp, one named ``ep``
(an expert leaf's leading dim) over ep (contiguous blocks in coordinate
order), and a leaf is replicated over every other axis; the batch rows
split over ``(dp, fsdp)`` and the sequence over ``sp``, so the ranks of
an ep line hold the same rows and ep splits experts, not tokens.
:class:`TrainMesh` holds one process group a line of each axis set the
step needs and the differentiable collectives, each an
``autograd.Function`` with its conjugate backward:

- ``all_gather``: backward reduce_scatter (the gathered value's
  consumers differ over the line, so their gradients add up), or with
  ``replicated=True`` this rank's block of the gradient (the consumers
  are replicated over the line, every rank holds the whole gradient);
- ``reduce_scatter``: backward all_gather;
- ``all_reduce`` (forward all_reduce, backward identity) and
  ``all_reduce_grad`` (forward identity, backward all_reduce): the
  Megatron g/f pair around a tensor-parallel region;
- ``ppermute``: backward the inverse permutation;
- ``all_to_all``: backward the reverse all_to_all.

On a gloo group, collectives that gloo does not run on CUDA tensors
(``reduce_scatter``, ``ppermute``, ``all_to_all``) are staged through
pinned host memory by the mesh and counted under ``staged``; gloo stages
``all_reduce`` and ``all_gather`` of CUDA tensors itself.

DECODE MESH (JAX's ``DECODE_AXES`` through ``decode_pool_sharding``).
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

With no process group, or a world of one, either mesh has size 1: it
builds no group and issues no collective, so the single-card path
launches exactly what the unsharded program launches.
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

# --- the training mesh ---------------------------------------------------------

AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

#: The batch rows split over these axes (JAX's ``batch_sharding``).
BATCH_AXES = ("dp", "fsdp")
#: The data axes: each holds other rows or positions, and no parameter
#: is sharded over dp or sp. The loss sums over them; a gradient is
#: summed over those its leaf is not sharded over.
DATA_AXES = ("dp", "fsdp", "sp")
#: The axes over which the MoE's expert path holds partial sums: its
#: experts over ep, the ffn columns of each over tp.
EXPERT_AXES = ("ep", "tp")
#: The axis sets a rank's process groups cover, besides each single
#: axis: the batch rows, the data axes (the loss; the gradients of
#: leaves not sharded over fsdp), the data axes but fsdp (the gradients
#: of fsdp-sharded leaves), fsdp with tp (the norm of a leaf sharded
#: over both), the expert axes (the MoE's partial sums) and those with
#: fsdp (the norm of an expert leaf).
GROUP_AXES = tuple((a,) for a in AXES) + (
    BATCH_AXES, DATA_AXES, ("dp", "sp"), ("fsdp", "tp"), EXPERT_AXES,
    ("fsdp",) + EXPERT_AXES)
#: Collectives gloo runs on CUDA tensors itself (it copies them through
#: pinned host memory); the mesh stages the others there.
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather"})


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.sp * self.tp * self.ep * self.pp

    @classmethod
    def for_device_count(cls, n: int) -> "MeshConfig":
        """JAX's default factorization: prefer fsdp, then tp (4, else 2)
        when n is strictly above its square: 4 -> fsdp 4, 8 -> fsdp 4 x
        tp 2, 32 -> fsdp 8 x tp 4."""
        if n <= 0:
            raise ValueError("need at least one device")
        tp = 1
        for cand in (4, 2):
            # Only give tp a slice of the mesh when enough devices remain
            # for a meaningful fsdp group (n strictly above cand^2).
            if n % cand == 0 and n > cand * cand:
                tp = cand
                break
        return cls(fsdp=n // tp, tp=tp)


def _axes(entry) -> tuple:
    """The axes of one spec entry: None, a name, or a tuple of names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: tuple) -> tuple:
    """Every axis a spec names, in its order."""
    return tuple(a for entry in spec for a in _axes(entry))


def _coords(config: MeshConfig, rank: int) -> dict:
    """A rank's coordinates: ranks lie row-major over AXES, tp
    innermost."""
    coords = {}
    for a in reversed(AXES):
        rank, coords[a] = divmod(rank, getattr(config, a))
    return {a: coords[a] for a in AXES}


def _line_key(coords: dict, axes: tuple) -> tuple:
    """The coordinates off ``axes``: equal for the ranks of one line."""
    return tuple(coords[a] for a in AXES if a not in axes)


class TrainMesh:
    """This rank's view of the training mesh: the axis sizes (``shape``,
    as JAX's ``Mesh.shape``), its coordinates, the device its tensors
    live on, and the process group of its line over each axis set of
    ``GROUP_AXES`` whose size is above 1 (an axis set is reduced to its
    axes of size above 1 first, so equal lines share one group).

    ``collectives`` counts the collectives issued by kind,
    ``<op>:<axes>`` (``all_gather:fsdp``, ``all_reduce:dp+fsdp+sp``),
    prefixed ``<phase>/`` inside :meth:`in_phase`; ``seconds`` and
    ``bytes`` hold their host seconds and the bytes of their larger
    buffer, and ``staged`` those staged through pinned host memory,
    under the same keys."""

    def __init__(self, config: MeshConfig, rank: int, device,
                 groups: Optional[dict] = None):
        self.config = config
        self.shape = {a: getattr(config, a) for a in AXES}
        self.rank = rank
        self.device = torch.device(device)
        self.coords = _coords(config, rank)
        self.groups = groups or {}
        self.collectives: collections.Counter = collections.Counter()
        self.seconds: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        self.staged: collections.Counter = collections.Counter()
        self.phase: Optional[str] = None

    def __repr__(self) -> str:
        live = ", ".join(f"{a}={n}" for a, n in self.shape.items() if n > 1)
        return f"TrainMesh({live or 'size 1'}, rank={self.rank})"

    @property
    def size(self) -> int:
        return self.config.size

    def live(self, axes) -> tuple:
        """``axes`` (a name or names) reduced to those of size above 1,
        in mesh order."""
        axes = _axes(axes)
        return tuple(a for a in AXES if a in axes and self.shape[a] > 1)

    def axis_size(self, axes) -> int:
        n = 1
        for a in self.live(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's row-major coordinate over ``axes``: its place in
        the line's group, and the block of a dim sharded over them."""
        i = 0
        for a in self.live(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def line(self, axes) -> list:
        """The global ranks of this rank's line over ``axes``, in
        coordinate order."""
        key = _line_key(self.coords, self.live(axes))
        return [r for r in range(self.size)
                if _line_key(_coords(self.config, r), self.live(axes)) == key]

    def block(self, n: int, axes) -> Tuple[int, int]:
        """[lo, hi) of this rank's block of ``n`` split over ``axes``."""
        k = self.axis_size(axes)
        if n % k:
            raise ValueError(f"{n} does not split over {axes} of size {k}")
        i = self.index(axes)
        return i * (n // k), (i + 1) * (n // k)

    @contextlib.contextmanager
    def in_phase(self, phase: str):
        """Count the collectives issued inside under ``<phase>/<kind>``."""
        outer, self.phase = self.phase, phase
        try:
            yield
        finally:
            self.phase = outer

    def _issue(self, op: str, axes: tuple, x: torch.Tensor, run,
               nbytes: int) -> torch.Tensor:
        """``run(x, group)`` for the collective ``op`` over ``axes``,
        counted and timed; through pinned host memory where gloo does not
        take ``x``'s CUDA tensors."""
        group = self.groups[axes]
        kind = f"{op}:{'+'.join(axes)}"
        key = kind if self.phase is None else f"{self.phase}/{kind}"
        t0 = time.perf_counter()
        if x.is_cuda and op not in GLOO_CUDA_OPS and \
                dist.get_backend(group) == "gloo":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            out = run(host, group).to(x.device)
            self.staged[key] += 1
        else:
            out = run(x, group)
        self.seconds[key] += time.perf_counter() - t0
        self.bytes[key] += nbytes
        self.collectives[key] += 1
        return out

    # --- the raw collectives (no autograd) -----------------------------------

    def all_gather_raw(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        axes, n = self.live(axes), self.axis_size(axes)
        if n == 1:
            return x

        def run(x, group):
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
            return torch.cat(parts, dim)

        return self._issue("all_gather", axes, x.contiguous(), run,
                           x.nbytes * n)

    def reduce_scatter_raw(self, x: torch.Tensor, axes,
                           dim: int) -> torch.Tensor:
        axes, n = self.live(axes), self.axis_size(axes)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} of size {n}")
        lead = x.movedim(dim, 0).contiguous()

        def run(x, group):
            out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, group=group)
            return out

        return self._issue("reduce_scatter", axes, lead, run,
                           lead.nbytes).movedim(0, dim)

    def all_reduce_raw(self, x: torch.Tensor, axes,
                       inplace: bool = False) -> torch.Tensor:
        """The sum over the line; ``inplace`` sums into ``x`` itself (a
        contiguous tensor nothing else reads)."""
        axes = self.live(axes)
        if not axes:
            return x

        def run(x, group):
            dist.all_reduce(x, group=group)
            return x

        if not inplace:
            x = x.clone(memory_format=torch.contiguous_format)
        out = self._issue("all_reduce", axes, x, run, x.nbytes)
        if out is not x:  # staged: copy the sum back
            x.copy_(out)
        return x

    def ppermute_raw(self, x: torch.Tensor, axes, shift: int) -> torch.Tensor:
        """Send ``x`` to the rank ``shift`` places on along the line
        (cyclically) and return what the rank ``shift`` places back
        sent."""
        axes, n = self.live(axes), self.axis_size(axes)
        if n == 1:
            return x
        line, i = self.line(axes), self.index(axes)
        dst, src = line[(i + shift) % n], line[(i - shift) % n]

        def run(x, group):
            out = torch.empty_like(x)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, dst, group),
                    dist.P2POp(dist.irecv, out, src, group)]):
                req.wait()
            return out

        return self._issue("ppermute", axes, x.contiguous(), run, x.nbytes)

    def all_to_all_raw(self, x: torch.Tensor, axes) -> torch.Tensor:
        """x [n, ...]: slot j goes to the line's rank j; slot j of the
        result is what rank j sent this rank."""
        axes, n = self.live(axes), self.axis_size(axes)
        if n == 1:
            return x
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {axes} needs a leading dim "
                             f"of {n}, got {tuple(x.shape)}")

        def run(x, group):
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=group)
            return out

        return self._issue("all_to_all", axes, x.contiguous(), run, x.nbytes)

    def split(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim`` (no communication)."""
        lo, hi = self.block(x.shape[dim], axes)
        return x.narrow(dim, lo, hi - lo)

    # --- the differentiable collectives --------------------------------------

    def all_gather(self, x: torch.Tensor, axes, dim: int,
                   replicated: bool = False) -> torch.Tensor:
        if self.axis_size(axes) == 1:
            return x
        return _AllGather.apply(x, self, self.live(axes), dim, replicated)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        if self.axis_size(axes) == 1:
            return x
        return _ReduceScatter.apply(x, self, self.live(axes), dim)

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Forward all_reduce, backward identity (Megatron's g)."""
        if self.axis_size(axes) == 1:
            return x
        return _AllReduce.apply(x, self, self.live(axes))

    def all_reduce_grad(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Forward identity, backward all_reduce (Megatron's f)."""
        if self.axis_size(axes) == 1:
            return x
        return _AllReduceGrad.apply(x, self, self.live(axes))

    def ppermute(self, x: torch.Tensor, axes, shift: int = 1) -> torch.Tensor:
        if self.axis_size(axes) == 1:
            return x
        return _PPermute.apply(x, self, self.live(axes), shift)

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        if self.axis_size(axes) == 1:
            return x
        return _AllToAll.apply(x, self, self.live(axes))

    # --- parameters and data -------------------------------------------------

    def gather_param(self, w: torch.Tensor, path: str,
                     tp: bool = False) -> torch.Tensor:
        """The leaf at ``path``, this rank's block ``w`` of it, gathered
        over fsdp (and with ``tp`` over tp too) for a forward: the fsdp
        gather's backward reduce-scatters (each rank's rows add their
        part), the tp gather's takes this rank's block (the computation
        that reads the whole leaf is replicated over tp)."""
        for d, entry in enumerate(param_spec(path, w)):
            for a in _axes(entry):
                if a == "fsdp" or (a == "tp" and tp):
                    w = self.all_gather(w, a, d, replicated=a == "tp")
        return w


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, replicated):
        ctx.args = (mesh, axes, dim, replicated)
        return mesh.all_gather_raw(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, replicated = ctx.args
        g = (mesh.split(g, axes, dim).contiguous() if replicated
             else mesh.reduce_scatter_raw(g, axes, dim))
        return g, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return mesh.reduce_scatter_raw(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return mesh.all_gather_raw(g, axes, dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce_raw(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.all_reduce_raw(g, axes), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, shift):
        ctx.args = (mesh, axes, shift)
        return mesh.ppermute_raw(x, axes, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, shift = ctx.args
        return mesh.ppermute_raw(g, axes, -shift), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return mesh.all_to_all_raw(x, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return mesh.all_to_all_raw(g, axes), None, None


def build_mesh(config: MeshConfig, device=None) -> TrainMesh:
    """The training mesh of ``config`` over every rank of the default
    process group (or over this process alone when there is none): its
    size must be the world's, as JAX's ``build_mesh`` asks for one device
    a mesh slot. Every rank must call it alike: it creates, for each axis
    set of ``GROUP_AXES`` (reduced to its axes of size above 1, each
    distinct set once), one subgroup a line, in order, as
    :func:`build_decode_mesh` does. ``device``: where this rank's tensors
    live (default: the CUDA device)."""
    device = resolve_device(device)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if config.size != world:
        raise ValueError(f"mesh config {config} needs {config.size} devices, "
                         f"have {world}")
    mesh = TrainMesh(config, rank, device)
    for axes in dict.fromkeys(mesh.live(a) for a in GROUP_AXES):
        if not axes:
            continue
        lines = {}
        for r in range(world):
            lines.setdefault(_line_key(_coords(config, r), axes), []).append(r)
        for ranks in lines.values():
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.groups[axes] = group
    return mesh


# Parameter path (regex) -> spec. Weights shard the contraction/feature
# dims over fsdp and the parallel dims (heads, ffn hidden, vocab) over
# tp; biases and norms are replicated.
PARAM_RULES: List[Tuple[str, tuple]] = [
    # MoE expert weights carry a leading expert dim sharded over ep
    # (matched before the generic w_gate/w_up/w_down rules).
    (r".*experts.*(w_gate|w_up)$", ("ep", "fsdp", "tp")),  # [E, d, ffn]
    (r".*experts.*w_down$", ("ep", "tp", "fsdp")),  # [E, ffn, d]
    (r".*router.*kernel$", ("fsdp", None)),  # [d, E]
    (r".*embed.*embedding$", ("tp", "fsdp")),  # [vocab, d]
    (r".*(wq|wk|wv).*kernel$", ("fsdp", "tp")),  # [d, heads*hd]
    (r".*wo.*kernel$", ("tp", "fsdp")),  # [heads*hd, d]
    (r".*(w_gate|w_up).*kernel$", ("fsdp", "tp")),  # [d, ffn]
    (r".*w_down.*kernel$", ("tp", "fsdp")),  # [ffn, d]
    (r".*lm_head.*kernel$", ("fsdp", "tp")),  # [d, vocab]
    (r".*(norm|scale).*", ()),  # replicated
]


def param_spec(path: str, value=None) -> tuple:
    """Training spec of one parameter leaf by path (``/``-joined flax
    names). int8 weight-only ``kernel_q`` leaves take their plain
    kernel's spec; the small per-channel scale falls through to
    replicated. Leaves of more dims than the rule (a stacked layer axis)
    get leading Nones."""
    path = re.sub(r"/kernel_q$", "/kernel", path)
    for pattern, spec in PARAM_RULES:
        if re.fullmatch(pattern, path):
            if value is not None and getattr(value, "ndim", 0) > len(spec):
                return (None,) * (value.ndim - len(spec)) + spec
            return spec
    return ()


def param_shardings(mesh: TrainMesh, params) -> dict:
    """The spec tree of a parameter tree (either layout)."""
    del mesh  # the specs name axes; the mesh sizes them
    return _map_with_path(
        as_tree(params),
        lambda path, leaf: param_spec(_flatten_path(path), leaf))


def batch_sharding(mesh: TrainMesh) -> tuple:
    """Spec of the [batch, seq] tokens: rows over (dp, fsdp), positions
    over sp."""
    del mesh
    return (BATCH_AXES, "sp")


def replicated(mesh: TrainMesh) -> tuple:
    del mesh
    return ()


def _leaf_block(t: torch.Tensor, spec: tuple, mesh: TrainMesh,
                path: str) -> torch.Tensor:
    for d, entry in enumerate(spec):
        n = mesh.axis_size(entry)
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"{path}: dim {d} of {tuple(t.shape)} does not "
                             f"split over {entry} of size {n}")
        t = mesh.split(t, entry, d)
    return t


def shard_train_params(mesh: TrainMesh, params):
    """This rank's blocks of a full parameter tree by ``param_spec``: a
    dim named fsdp cut over fsdp, one named tp over tp, one named ep
    over ep, every other dim and leaf whole. A LlamaParams (or
    MixtralParams) gives the same kind of module, its leaves carrying
    gradients as the input's did; a nested dict gives a nested dict. Cut leaves are copies (the full
    tree can go); on a mesh of one nothing is copied."""
    from tpu_dra_torch.workloads.models.llama import LlamaParams

    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        block = _leaf_block(node, param_spec(path, node), mesh, path)
        return block if block is node else block.clone()

    if mesh.size == 1:
        return params
    if isinstance(params, LlamaParams):
        trainable = any(p.requires_grad for p in params.parameters())
        return type(params)(params.config, walk(params.tree(), ""),
                            trainable)
    return walk(params, "")


def shard_opt_state(mesh: TrainMesh, state):
    """This rank's blocks of an AdamState of full moments (keyed by
    parameter name): each moment cut as its parameter is; the count
    whole."""
    def cut(moments):
        return {n: _leaf_block(t, param_spec(n.replace(".", "/"), t), mesh,
                               n).clone() for n, t in moments.items()}

    if mesh.size == 1:
        return state
    return state._replace(mu=cut(state.mu), nu=cut(state.nu))


def gather_train_params(mesh: TrainMesh, params) -> dict:
    """The full tree (nested dict of detached tensors) from every rank's
    blocks: each leaf all-gathered over the axes its spec names. Every
    rank of the mesh must call it alike (its collectives are the
    mesh's)."""
    def walk(node, path):
        if isinstance(node, Mapping):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        t = node.detach()
        for d, entry in enumerate(param_spec(path, t)):
            t = mesh.all_gather_raw(t, entry, d)
        return t

    return walk(as_tree(params), "")


# --- the decode mesh -----------------------------------------------------------

DECODE_AXES = ("batch", "model")

DECODE_PARAM_RULES: List[Tuple[str, tuple]] = [
    (r".*(wq|wk|wv).*kernel$", (None, "model")),  # [d, heads*hd]
    (r".*(w_gate|w_up).*kernel$", (None, "model")),  # [d, ffn]
    (r".*lm_head.*kernel$", (None, "model")),  # [d, vocab]
    # wo / w_down / embed / norms / quant scales: replicated (see the
    # exactness contract above).
]

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
    """The config for decode on ``mesh``: ``config`` itself, over any
    mesh. JAX forces XLA on a mesh of more than one device, since a
    Pallas call has no GSPMD partitioning rule; here every rank runs its
    own ops on its own shard, so each kernel-capable op keeps its impl
    ("auto": the kernel on a CUDA tensor, the plain version on the CPU).
    The decode attention kernels take the rank's heads as they are
    (planned as the unsharded heads', ``plan_kv_heads``), and the fused
    MLP splits at the gather of ``silu(gate)·up`` (ops/decode_mlp.py)."""
    return config


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


def kv_head_block(mesh: Optional[DecodeMesh], kv_heads: int) -> Tuple[int, int]:
    """(first, count) of the kv heads this rank's pools and caches hold."""
    n = local_kv_heads(mesh, kv_heads)
    return (0, kv_heads) if n == kv_heads else (mesh.coords[1] * n, n)


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
