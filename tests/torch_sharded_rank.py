"""One gloo rank of the sharded-decode twins (tests/test_torch_sharded.py).

Run as ``python tests/torch_sharded_rank.py WEIGHTS.npz CASE [CASE ...]``
in the env the slice daemon renders (tests/torch_ranks.py
``rank_env``): it joins the group (``bootstrap.initialize_from_env``),
loads the TINY_LLAMA fp32 weights the parent wrote
(``convert.params_to_numpy`` flattened into an .npz), runs each case on
the CPU and prints one JSON line of results. The traces are defined here,
in numpy, so the parent feeds JAX the same requests. No JAX import: the
ranks are the port's.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

EC = dict(page_size=4, max_slots=3, max_pages_per_seq=12, scan_chunk=3,
          prefill_chunk=8)
SAMPLED = {"temperature": 0.8, "top_k": 8, "sample_seed": 5}
PREFIX_LEN = 14
SKEW_ARRIVAL_S = 0.05  # request i arrives at i x this, on the engine clock

#: case -> (EngineConfig overrides, trace name) of the engine cases
ENGINE_CASES = {
    "greedy": ({}, "mixed"),
    "sampled": (SAMPLED, "mixed"),
    "prefix": ({}, "prefix"),
    "w8kv8": ({"weight_quant": "int8", "kv_quant": "int8"}, "mixed"),
    "slots4": ({"max_slots": 4}, "mixed"),
    "skew": ({}, "skew"),
}

#: mode -> (model dtype, EngineConfig overrides) of the migration cases
#: (``migrate_<mode>``): export and import between world 1 and world 2.
MIGRATE_MODES = {
    "fp32": ("float32", {}),
    "bf16": ("bfloat16", {}),
    "kv8": ("float32", {"kv_quant": "int8"}),
}
MIGRATE_RID = "m0"
#: Steps the ``evacuate`` case takes before it evacuates.
EVACUATE_AFTER = 4


def trace(name: str, vocab: int = 256) -> list:
    """(rid, prompt, max_new, extra Request fields) of a named trace."""
    rng = np.random.default_rng(11)
    if name == "prefix":
        shared = rng.integers(1, vocab, PREFIX_LEN + 6).astype(np.int32)
        out = []
        for i in range(5):
            suffix = rng.integers(1, vocab, int(rng.integers(2, 9)))
            out.append((f"p{i}", np.concatenate(
                [shared, suffix.astype(np.int32)]), 8,
                {"prefix_id": "sys", "prefix_len": PREFIX_LEN}))
        return out
    if name == "migrate":
        return [(f"m{i}", rng.integers(1, vocab, n).astype(np.int32), 9, {})
                for i, n in enumerate((13, 6, 10))]
    out = []
    for i in range(6):
        prompt = rng.integers(1, vocab, int(rng.integers(2, 15)))
        extra = {"arrival_s": i * SKEW_ARRIVAL_S} if name == "skew" else {}
        out.append((f"r{i}", prompt.astype(np.int32),
                    int(rng.integers(1, 10)), extra))
    return out


def generate_prompt() -> np.ndarray:
    """tests/test_workloads.py's sharded greedy prompt: [2, 8]."""
    return np.tile(np.arange(8, dtype=np.int32)[None], (2, 1))


class SkewedClock:
    """A fake clock a rank of its own: ``offset`` + ``rate`` x 0.01 s a
    read. Ranks that acted on their own readings would admit the
    staggered arrivals at different steps."""

    def __init__(self, offset: float, rate: float):
        self.offset, self.rate, self.reads = offset, rate, 0

    def __call__(self) -> float:
        self.reads += 1
        return self.offset + self.rate * 0.01 * self.reads


def _load(path: str, dtype: str = "float32"):
    import torch

    from tpu_dra_torch.workloads.convert import params_from_numpy
    from tpu_dra_torch.workloads.models.llama import TINY_LLAMA

    cfg = dataclasses.replace(TINY_LLAMA, dtype=getattr(torch, dtype),
                              param_dtype=getattr(torch, dtype))
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return cfg, params_from_numpy(tree, cfg, device="cpu")


def save_extent(path, sx) -> None:
    """A port SequenceExtent to an .npz: its payload bit for bit (bf16
    as its 16-bit pattern) and its bookkeeping as JSON."""
    import torch

    arrays, bf16 = {}, []
    for name, layers in sx.extent.payload.items():
        for i, t in enumerate(layers):
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
                bf16.append(name)
            arrays[f"{name}/{i}"] = t.numpy()
    e = sx.extent
    meta = {"rid": sx.req.rid, "prompt": [int(x) for x in sx.req.prompt],
            "max_new": int(sx.req.max_new_tokens),
            "emitted": [int(x) for x in sx.emitted], "kv_len": int(sx.kv_len),
            "t_submit": sx.t_submit, "t_first": sx.t_first,
            "sample_seed": int(sx.sample_seed),
            "sample_serial": int(sx.sample_serial),
            "page_size": e.page_size, "length": e.length,
            "quantized": e.quantized, "slots": [list(x) for x in e.slots],
            "layers": {n: len(ls) for n, ls in e.payload.items()},
            "bf16": sorted(set(bf16))}
    np.savez(path, meta=np.array(json.dumps(meta)), **arrays)


def load_extent(path):
    """The port SequenceExtent :func:`save_extent` wrote."""
    import torch

    from tpu_dra_torch.workloads import engine as E
    from tpu_dra_torch.workloads.paged_kv import KVExtent

    with np.load(path) as f:
        meta = json.loads(str(f["meta"]))
        payload = {}
        for name, n in meta["layers"].items():
            layers = [torch.from_numpy(f[f"{name}/{i}"].copy())
                      for i in range(n)]
            if name in meta["bf16"]:
                layers = [t.view(torch.bfloat16) for t in layers]
            payload[name] = tuple(layers)
    extent = KVExtent(page_size=meta["page_size"], length=meta["length"],
                      quantized=meta["quantized"],
                      slots=tuple((k, int(v)) for k, v in meta["slots"]),
                      payload=payload)
    req = E.Request(rid=meta["rid"], prompt=np.asarray(meta["prompt"],
                                                       np.int32),
                    max_new_tokens=meta["max_new"])
    return E.SequenceExtent(
        req=req, emitted=np.asarray(meta["emitted"], np.int32),
        extent=extent, kv_len=meta["kv_len"], t_submit=meta["t_submit"],
        t_first=meta["t_first"], sample_seed=meta["sample_seed"],
        sample_serial=meta["sample_serial"])


def extent_bits(extent) -> dict:
    """pool name -> L-list of the payload's bytes: equal dicts are equal
    extents bit for bit."""
    import torch

    return {name: [t.detach().cpu().contiguous().view(-1).view(
        torch.uint8).numpy().tobytes() for t in layers]
        for name, layers in extent.payload.items()}


def _migrate_case(E, weights: str, mode: str, rank: int) -> dict:
    """Export ``MIGRATE_RID`` once it decodes, from an unsharded engine
    (world 1) and from the sharded one (world 2), then import each into
    an engine of the other world and JAX's export (``root/
    jax_<mode>.npz``) into a sharded one, each run to the end."""
    dtype, kw = MIGRATE_MODES[mode]
    cfg, params = _load(weights, dtype)
    root = Path(weights).parent

    def engine(sharded: bool):
        return E.Engine(cfg, params, E.EngineConfig(
            **{**EC, **kw, "sharded": sharded}), device="cpu")

    def requests():
        return [E.Request(rid=r, prompt=p, max_new_tokens=n)
                for r, p, n, _ in trace("migrate")]

    def exported(sharded: bool):
        eng = engine(sharded)
        for r in requests():
            eng.add_request(r)
        steps = 0
        while MIGRATE_RID not in eng.decoding_rids():
            eng.step()
            steps += 1
        sx = eng.export_sequence(MIGRATE_RID)
        rest = {rid: c.tokens.tolist() for rid, c in eng.run().items()}
        return sx, rest, steps, _whole(eng)

    def resumed(sharded: bool, sx):
        eng = engine(sharded)
        assert eng.import_sequence(sx)
        done = eng.run()
        return (sx.emitted.tolist() + done[sx.req.rid].tokens.tolist(),
                _whole(eng))

    x1, rest1, steps1, whole1 = exported(False)
    x2, rest2, steps2, whole2 = exported(True)
    unmigrated = {rid: c.tokens.tolist()
                  for rid, c in engine(False).run(requests()).items()}
    w2_from_w1, whole3 = resumed(True, x1)
    w1_from_w2, whole4 = resumed(False, x2)
    from_jax, whole5 = resumed(True, load_extent(root / f"jax_{mode}.npz"))
    save_extent(root / f"port_{mode}_rank{rank}.npz", x2)
    return {
        "kv_len": x2.kv_len, "slots": [list(x) for x in x2.extent.slots],
        "emitted": x2.emitted.tolist(), "steps": [steps1, steps2],
        "pool_shapes": {n: list(ls[0].shape)
                        for n, ls in x2.extent.payload.items()},
        "same_as_world1": extent_bits(x1.extent) == extent_bits(x2.extent)
        and (x1.kv_len, x1.emitted.tolist(), x1.extent.slots,
             x1.sample_serial) == (x2.kv_len, x2.emitted.tolist(),
                                   x2.extent.slots, x2.sample_serial),
        "unmigrated": unmigrated, "rest": [rest1, rest2],
        "w2_from_w1": w2_from_w1, "w1_from_w2": w1_from_w2,
        "w2_from_jax": from_jax,
        "allocator_whole": [whole1, whole2, whole3, whole4, whole5],
    }


def _whole(eng) -> bool:
    a = eng.allocator
    return a.free_pages == a.num_pages - 1 and a.reserved_pages == 0


def _evacuate_case(E, cfg, params, rank: int) -> dict:
    """The skew trace on a sharded engine, each rank on its own skewed
    clock, evacuated after ``EVACUATE_AFTER`` steps; and on an unsharded
    engine on rank 0's clock (the clock the mesh agrees on)."""
    out = {}
    for name, sharded, skew in (("sharded", True, rank), ("world1", False, 0)):
        eng = E.Engine(cfg, params,
                       E.EngineConfig(**{**EC, "sharded": sharded}),
                       device="cpu",
                       clock=SkewedClock(offset=1000.0 * skew,
                                         rate=1.0 + skew))
        for r, p, n, x in trace("skew"):
            eng.add_request(E.Request(rid=r, prompt=p, max_new_tokens=n,
                                      **x))
        for _ in range(EVACUATE_AFTER):
            eng.step()
        evacuees = eng.evacuate()
        out[name] = {
            "evacuees": [[e.req.rid, e.emitted.tolist(), e.t_submit]
                         for e in evacuees],
            "busy": eng.busy, "allocator_whole": _whole(eng),
            "completed": {rid: c.tokens.tolist()
                          for rid, c in eng.completed.items()},
        }
    return out


def _engine_case(E, cfg, params, case: str, rank: int) -> dict:
    kw, name = ENGINE_CASES[case]
    clock = {}
    if case == "skew":
        clock = {"clock": SkewedClock(offset=1000.0 * rank, rate=1.0 + rank)}
    eng = E.Engine(cfg, params, E.EngineConfig(**{**EC, **kw, "sharded": True}),
                   device="cpu", **clock)
    done = eng.run([E.Request(rid=r, prompt=p, max_new_tokens=n, **x)
                    for r, p, n, x in trace(name)])
    out = {
        "tokens": {rid: c.tokens.tolist() for rid, c in done.items()},
        "mesh": eng.mesh.shape, "rows": eng._rows,
        "collectives": dict(eng.mesh.collectives),
        "pool_shape": list(eng.cache.k[0].shape),
        "allocator_whole": eng.allocator.free_pages
        == eng.allocator.num_pages - 1,
        "prefix_attached": eng.prefix_attached,
    }
    if case == "skew":
        out["t_submit"] = {rid: c.t_submit for rid, c in done.items()}
        out["prefill_buckets"] = eng.prefill_buckets
    return out


def _shapes(M, cfg, params) -> dict:
    import torch

    from tpu_dra_torch.workloads.models.llama import as_tree
    from tpu_dra_torch.workloads.quantize import quantize_params

    mesh = M.build_decode_mesh(cfg, device="cpu")
    shard = M.shard_decode_params(mesh, params)
    full8 = quantize_params(as_tree(params))
    q8 = M.shard_decode_params(mesh, full8)
    leaf = {
        "wq": shard["layer_0"]["attention"]["wq"]["kernel"],
        "wk": shard["layer_0"]["attention"]["wk"]["kernel"],
        "wv": shard["layer_0"]["attention"]["wv"]["kernel"],
        "wo": shard["layer_0"]["attention"]["wo"]["kernel"],
        "w_gate": shard["layer_0"]["mlp"]["w_gate"]["kernel"],
        "w_up": shard["layer_0"]["mlp"]["w_up"]["kernel"],
        "w_down": shard["layer_0"]["mlp"]["w_down"]["kernel"],
        "lm_head": shard["lm_head"]["kernel"],
        "embed": shard["embed"]["embedding"],
        "w_up_q": q8["layer_0"]["mlp"]["w_up"]["kernel_q"],
        "w_up_scale": q8["layer_0"]["mlp"]["w_up"]["scale"],
    }
    full = as_tree(params)
    j, m = mesh.coords[1], mesh.shape["model"]
    n = cfg.ffn_dim // m
    return {
        "shapes": {k: list(v.shape) for k, v in leaf.items()},
        "w_up_block_exact": bool((leaf["w_up"] == full["layer_0"]["mlp"][
            "w_up"]["kernel"][:, j * n:(j + 1) * n]).all()),
        "w_up_scale_block_exact": bool(torch.equal(
            leaf["w_up_scale"],
            full8["layer_0"]["mlp"]["w_up"]["scale"][:, j * n:(j + 1) * n])),
        "coords": list(mesh.coords),
    }


def main(argv) -> int:
    import torch

    from tpu_dra_torch.workloads import engine as E
    from tpu_dra_torch.workloads.bootstrap import initialize_from_env, shutdown
    from tpu_dra_torch.workloads.generate import greedy_generate
    from tpu_dra_torch.workloads.parallel import mesh as M

    weights, cases = argv[0], argv[1:]
    se = initialize_from_env(device="cpu")
    cfg, params = _load(weights)
    out = {"rank": se.worker_id, "world": se.num_processes}
    try:
        for case in cases:
            if case in ENGINE_CASES:
                out[case] = _engine_case(E, cfg, params, case, se.worker_id)
            elif case == "generate":
                mesh = M.build_decode_mesh(cfg, device="cpu")
                got = greedy_generate(cfg, M.shard_decode_params(mesh, params),
                                      torch.from_numpy(generate_prompt()), 8,
                                      device="cpu")
                out[case] = {"tokens": got.tolist(), "mesh": mesh.shape,
                             "collectives": dict(mesh.collectives)}
            elif case == "prefix_mesh":
                # A mesh over the first three ranks uses the (1, 2) prefix;
                # the ranks outside it hold no shard and issue nothing.
                mesh = M.build_decode_mesh(None, ranks=[0, 1, 2], device="cpu")
                res = {"mesh": mesh.shape, "member": mesh.member}
                if mesh.member:
                    got = greedy_generate(
                        cfg, M.shard_decode_params(mesh, params),
                        torch.from_numpy(generate_prompt()), 8, device="cpu")
                    res["tokens"] = got.tolist()
                else:
                    try:
                        M.shard_decode_params(mesh, params)
                        res["refused"] = None
                    except ValueError as e:
                        res["refused"] = str(e)
                out[case] = res
            elif case.startswith("migrate_"):
                out[case] = _migrate_case(E, weights, case[len("migrate_"):],
                                          se.worker_id)
            elif case == "evacuate":
                out[case] = _evacuate_case(E, cfg, params, se.worker_id)
            elif case == "shapes":
                out[case] = _shapes(M, cfg, params)
            elif case == "spec_refused":
                try:
                    E.Engine(cfg, params, E.EngineConfig(
                        **EC, spec_k=2, sharded=True), device="cpu")
                    out[case] = None
                except ValueError as e:
                    out[case] = str(e)
            else:
                raise ValueError(f"unknown case {case!r}")
    finally:
        shutdown()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
