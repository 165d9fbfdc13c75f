"""One gloo rank of the training-mesh tests (tests/test_torch_train_mesh.py).

Run as ``python tests/torch_mesh_rank.py`` in the env the slice daemon
renders (tests/torch_ranks.py ``rank_env``) at a world of 8: it builds
the meshes of ``MESHES`` over the group, and prints one JSON line with,
for each mesh, this rank's coordinates and the ranks of each of its
groups, the shard/gather round trip of TINY_LLAMA's parameters (and of
TINY_MIXTRAL's on the ep mesh), and for
each differentiable collective of ``COLLECTIVES`` its input, output,
cotangent and gradient (inputs from ``rank_input``, so the parent can
reckon every rank's). No JAX import: the ranks are the port's.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MESHES = {
    "fsdp_sp_tp": dict(fsdp=2, sp=2, tp=2),
    "dp_sp4": dict(dp=2, sp=4),
    "dp_ep_tp": dict(dp=2, ep=2, tp=2),
}

#: name -> (mesh, method, axes, keyword arguments, the input's shape,
#: the side replicated over the line: "out" (the consumers are: the
#: cotangent is the same on every rank of the line), "in" (the input
#: is), or None)
COLLECTIVES = {
    "all_gather_fsdp": ("fsdp_sp_tp", "all_gather", "fsdp",
                        {"dim": 1}, (2, 3), None),
    "all_gather_tp_replicated": ("fsdp_sp_tp", "all_gather", "tp",
                                 {"dim": 0, "replicated": True}, (2, 3),
                                 "out"),
    "reduce_scatter_sp": ("dp_sp4", "reduce_scatter", "sp", {"dim": 0},
                          (8, 3), None),
    "all_reduce_data": ("fsdp_sp_tp", "all_reduce", ("dp", "fsdp", "sp"),
                        {}, (2, 3), "out"),
    "all_reduce_grad_tp": ("fsdp_sp_tp", "all_reduce_grad", "tp", {},
                           (2, 3), "in"),
    "ppermute_sp": ("dp_sp4", "ppermute", "sp", {"shift": 1}, (2, 3), None),
    "ppermute_sp_back2": ("dp_sp4", "ppermute", "sp", {"shift": -2}, (2, 3),
                          None),
    "all_to_all_sp": ("dp_sp4", "all_to_all", "sp", {}, (4, 2, 3), None),
    # The MoE's pair over its expert axes.
    "all_reduce_experts": ("dp_ep_tp", "all_reduce", ("ep", "tp"), {},
                           (2, 3), "out"),
    "all_reduce_grad_experts": ("dp_ep_tp", "all_reduce_grad", ("ep", "tp"),
                                {}, (2, 3), "in"),
}


def rank_input(rank: int, shape: tuple, salt: int) -> np.ndarray:
    """A float64 array that names its rank, salt and position."""
    n = int(np.prod(shape))
    return (1000.0 * rank + 100.0 * salt
            + np.arange(n, dtype=np.float64)).reshape(shape)


def line_key(coords: dict, axes) -> tuple:
    """The coordinates off ``axes``: equal for the ranks of one line."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(v for a, v in sorted(coords.items()) if a not in axes)


def main() -> int:
    import torch
    import torch.distributed as dist

    from tpu_dra_torch.workloads.bootstrap import initialize_from_env, shutdown
    from tpu_dra_torch.workloads.models import mixtral
    from tpu_dra_torch.workloads.models.llama import TINY_LLAMA, init_params
    from tpu_dra_torch.workloads.parallel import mesh as M

    se = initialize_from_env(device="cpu")
    rank = se.worker_id
    out = {"rank": rank}
    try:
        meshes = {name: M.build_mesh(M.MeshConfig(**kw), device="cpu")
                  for name, kw in MESHES.items()}
        for name, mesh in meshes.items():
            out[name] = {
                "coords": mesh.coords,
                "groups": {"+".join(axes): dist.get_process_group_ranks(g)
                           for axes, g in mesh.groups.items()},
                "lines": {"+".join(axes): mesh.line(axes)
                          for axes in mesh.groups},
            }
        # The shard/gather round trips and the local shapes.
        def round_trip(mesh, params):
            local = M.shard_train_params(mesh, params)
            back = M.gather_train_params(mesh, local)
            flat_full = dict(params.named_parameters())
            flat_back = {}

            def walk(node, prefix):
                for k, v in node.items():
                    if isinstance(v, dict):
                        walk(v, f"{prefix}{k}.")
                    else:
                        flat_back[prefix + k] = v

            walk(back, "")
            exact = sorted(flat_back) == sorted(flat_full) and all(
                torch.equal(flat_back[n], flat_full[n].detach())
                for n in flat_full)
            return local, exact

        local, out["round_trip_exact"] = round_trip(
            meshes["fsdp_sp_tp"], init_params(
                TINY_LLAMA, torch.Generator().manual_seed(3), "cpu",
                trainable=True))
        out["local_shapes"] = {n: list(p.shape)
                               for n, p in local.named_parameters()}
        out["local_requires_grad"] = all(
            p.requires_grad for p in local.parameters())
        moe, out["moe_round_trip_exact"] = round_trip(
            meshes["dp_ep_tp"], mixtral.init_params(
                mixtral.TINY_MIXTRAL, torch.Generator().manual_seed(3), "cpu",
                trainable=True))
        out["moe_local_shapes"] = {n: list(p.shape)
                                   for n, p in moe.named_parameters()}
        # Each differentiable collective: forward, and the gradient of
        # sum(out * y) for a cotangent y.
        res = {}
        for i, (name, (mname, method, axes, kw, shape, side)) in enumerate(
                COLLECTIVES.items()):
            m = meshes[mname]
            first = min(r for r in range(8) if line_key(
                M.TrainMesh(m.config, r, "cpu").coords, axes)
                == line_key(m.coords, axes))
            x = torch.tensor(rank_input(first if side == "in" else rank,
                                        shape, i), requires_grad=True)
            fwd = getattr(m, method)(x, axes, **kw)
            y = torch.tensor(rank_input(first if side == "out" else rank,
                                        tuple(fwd.shape), i + 50))
            (fwd * y).sum().backward()
            res[name] = {"x": x.detach().tolist(), "out": fwd.tolist(),
                         "y": y.tolist(), "grad": x.grad.tolist()}
        out["collectives"] = res
        out["counts"] = {name: dict(m.collectives)
                         for name, m in meshes.items()}
    finally:
        shutdown()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
