"""Mesh-sharded decode smoke: sharded decode is token-identical.

Counterpart of ``tpu_dra/workloads/shardbench.py``, with its asserts and
JSON keys. JAX forces two CPU devices into one process; torch has no such
thing, so this CLI joins the slice group from the rendered env
(``--config-dir``, ``--device``, as ``rendezvous_smoke.py`` does; one
process a rank) and checks parity at the world it finds:

1. the decode mesh ladder degrades gracefully: 1 device -> (1, 1),
   2 devices -> (1, 2), and the model axis clamps to divide TINY_LLAMA's
   kv heads / ffn / vocab ((4, 2) at 8);
2. **greedy path parity**: ``greedy_generate`` over
   ``shard_decode_params`` on this rank's own (1, 1) mesh and on the
   world's mesh is token-identical to the unsharded run;
3. **engine parity**: a continuous-batching trace with
   ``EngineConfig(sharded=True)`` — weights, KV pools and decode rows
   sharded — completes token-identical to the unsharded engine, greedy
   and sampled (temperature 0.8, top-k 8, seed 5);
4. the sharded params really are sharded: some leaf's spec names the
   model axis, and over a model axis of m the column-parallel leaves
   hold 1/m of their columns;
5. **live migration** (the port's, beside JAX's checks): the greedy
   trace's first decoding sequence exported from the sharded engine
   (every rank holds the whole extent, its own kv-head block of it its
   pool pages bit for bit, and so are the pages an import into a fresh
   sharded engine grafts) is the extent the unsharded engine exports at
   the same step, bit for bit where the matmuls round alike (the CPU)
   and within ``MIGRATE_FP32_REL`` of the largest value otherwise; the
   imported sequence finishes token-identical to the unmigrated run
   (``migrate``: the extent's MB, export and import ms).

Each unsharded reference runs the config the sharded run ends up with
(``sharded_safe_config``), so the comparison isolates the sharding. Over
several ranks every rank also checks that all ranks' tokens agree, and
reports the cosine of the sharded against the unsharded logits of the
prefill and first decode step (``greedy_logit_cosine_<b>x<m>``) and
whether its column block of an fp32 product is bit for bit the same
columns of the full product (``column_slice_bit_identical``).
Over gloo with CUDA tensors it also reports the device copies one
model-axis gather makes, from a ``torch.profiler`` trace
(``gather_copies``: gloo stages the tensors through host memory).
Rank 0 prints one JSON line; every rank exits nonzero on any violation.
``--fallback-cosine`` admits a ``greedy_generate`` token difference when
that call's prefill and first decode step logits agree to that cosine
(recorded, never silent); without it its tokens must be identical. The
engine's tokens must be identical either way.

    python -m tpu_dra_torch.workloads.shardbench --config-dir D --device cpu
    # two ranks sharing one card:
    python -m tpu_dra_torch.workloads.shardbench --config-dir D \\
        --device cuda:0 --backend gloo --model llama3-8b --layers 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

SAMPLED = {"temperature": 0.8, "top_k": 8, "sample_seed": 5}
NEW_TOKENS = 12  # greedy_generate's, as JAX's shardbench


def _trace(vocab: int, seed: int = 3, n: int = 6):
    """JAX shardbench's trace: n mixed-length requests."""
    from tpu_dra_torch.workloads.engine import Request

    rng = np.random.default_rng(seed)
    return [
        Request(
            rid=f"r{i}",
            prompt=rng.integers(1, vocab, int(rng.integers(2, 12))).astype(
                np.int32),
            max_new_tokens=int(rng.integers(1, 8)),
        )
        for i in range(n)
    ]


def _engine_config(**kw):
    from tpu_dra_torch.workloads.engine import EngineConfig

    base = dict(page_size=4, max_slots=3, max_pages_per_seq=10,
                scan_chunk=3, prefill_chunk=5)
    base.update(kw)
    return EngineConfig(**base)


def _model(name: str, layers: int):
    import torch

    from tpu_dra_torch.workloads.models.llama import LLAMA3_8B, TINY_LLAMA

    base = {"tiny": TINY_LLAMA, "llama3-8b": LLAMA3_8B}[name]
    cfg = dataclasses.replace(base, dtype=torch.float32,
                              param_dtype=torch.float32)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def _cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def first_step_cosine(cfg, params, sharded, prompt, device) -> float:
    """Cosine of the prefill's and the first decode step's logits,
    unsharded ``params`` against the ``sharded`` tree (the lower)."""
    import torch

    from tpu_dra_torch.workloads import generate as G
    from tpu_dra_torch.workloads.models.llama import as_tree
    from tpu_dra_torch.workloads.parallel import mesh as meshlib

    mesh = meshlib.params_mesh(sharded)
    safe = meshlib.sharded_safe_config(cfg, mesh)
    out = []
    for tree, m in ((G.unroll_params(as_tree(params)), None), (sharded, mesh)):
        cache = G.init_cache(safe, prompt.shape[0], 64, device=device,
                             mesh=m)
        first = G.forward_chunk(safe, tree, cache, prompt)[:, -1]
        tok = torch.argmax(first, dim=-1).to(prompt.dtype)[:, None]
        out.append((first, G.forward_chunk(safe, tree, cache, tok)[:, -1]))
    return min(_cosine(a, b) for a, b in zip(*out))


def column_slice_identical(params, mesh, device) -> dict:
    """Whether this rank's column block of an fp32 product equals the
    same columns of the full product, bit for bit, for ``w_gate`` of
    layer 0 and the ``lm_head`` (8 rows of seeded activations)."""
    import torch

    from tpu_dra_torch.workloads.models.llama import as_tree
    from tpu_dra_torch.workloads.parallel import mesh as meshlib

    tree = as_tree(params)
    shard = meshlib.shard_decode_params(mesh, tree)
    x = torch.randn(8, tree["embed"]["embedding"].shape[1],
                    generator=torch.Generator().manual_seed(0)).to(device)
    out = {}
    m, j = mesh.shape["model"], mesh.coords[1]
    for name, full, part in (
        ("w_gate", tree["layer_0"]["mlp"]["w_gate"]["kernel"],
         shard["layer_0"]["mlp"]["w_gate"]["kernel"]),
        ("lm_head", tree["lm_head"]["kernel"], shard["lm_head"]["kernel"]),
    ):
        n = full.shape[1] // m
        whole = (x @ full.to(x.dtype))[:, j * n:(j + 1) * n]
        out[name] = bool(torch.equal(whole, x @ part.to(x.dtype)))
    return out


def gather_copies(mesh, device) -> dict:
    """Count by name the device memcpys in a ``torch.profiler`` trace of
    one model-axis gather of a [3, 4096] fp32 row block (after a warm
    one): host staging shows as a device-to-host copy and host-to-device
    ones. Empty when the trace holds no device activity."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(3, 4096, device=device)
    mesh.gather_model(x)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mesh.gather_model(x)
        torch.cuda.synchronize(device)
    return dict(collections.Counter(
        e.name for e in prof.events() if e.name.startswith("Memcpy")))


def _extent_bytes(extent) -> dict:
    """pool name -> L-list of the payload's bytes."""
    import torch

    return {name: [t.contiguous().view(-1).view(torch.uint8).numpy()
                   .tobytes() for t in layers]
            for name, layers in extent.payload.items()}


#: The sharded export against the unsharded one, where they are not
#: bit for bit the same (on the card cuBLAS picks an fp32 kernel by
#: shape, so a column block of ``wk``/``wv`` may round otherwise than
#: the full product): the largest difference over the largest value.
MIGRATE_FP32_REL = 1e-5


def _written_extent(eng, rid: str):
    """The extent of ``rid``'s written pages in ``eng``'s own pools (this
    rank's kv heads), read without exporting."""
    from tpu_dra_torch.workloads import paged_kv

    seq = next(s for s in eng._slots if s is not None and s.req.rid == rid)
    kv_len = int(eng._lengths[seq.slot])
    return paged_kv.serialize_extent(
        eng.cache, seq.pages[:-(-kv_len // eng.ec.page_size)], kv_len)


def migrate_round_trip(cfg, params, device) -> dict:
    """Export the greedy trace's first decoding sequence from a sharded
    engine and from the unsharded one at the same step, then import the
    sharded export into a fresh sharded engine and run it out.
    ``lossless``: this rank's kv-head block of the exported extent is
    its own pool pages bit for bit, and so are the pages the import
    grafted."""
    from tpu_dra_torch.workloads import paged_kv
    from tpu_dra_torch.workloads.device import synchronize
    from tpu_dra_torch.workloads.engine import Engine
    from tpu_dra_torch.workloads.parallel import mesh as meshlib

    def decoding(eng):
        for r in _trace(cfg.vocab_size):
            eng.add_request(r)
        while not eng.decoding_rids():
            eng.step()
        return eng.decoding_rids()[0]

    sharded = Engine(cfg, params, _engine_config(sharded=True),
                     device=device)
    single = Engine(sharded.config, params, _engine_config(), device=device)
    rid = decoding(sharded)
    same_rid = decoding(single) == rid
    local = _extent_bytes(_written_extent(sharded, rid))
    issued = sum(sharded.mesh.collectives.values())
    synchronize(device)
    t0 = time.perf_counter()
    sx = sharded.export_sequence(rid)
    export_ms = (time.perf_counter() - t0) * 1e3
    gathers = sum(sharded.mesh.collectives.values()) - issued
    kvh = cfg.n_kv_heads
    lo, n = meshlib.kv_head_block(sharded.mesh, kvh)
    mine = sx.extent if n == kvh else paged_kv.head_block(sx.extent, lo, n,
                                                          kvh)
    lossless = _extent_bytes(mine) == local
    ref = single.export_sequence(rid)
    identical = same_rid and _extent_bytes(sx.extent) == _extent_bytes(
        ref.extent) and (sx.kv_len, sx.emitted.tolist(), sx.extent.slots) \
        == (ref.kv_len, ref.emitted.tolist(), ref.extent.slots)
    diff = {name: max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(layers, ref.extent.payload[name]))
            for name, layers in sx.extent.payload.items()}
    rel = max(diff[name] / max(float(b.double().abs().max())
                               for b in ref.extent.payload[name])
              for name in diff)
    dst = Engine(cfg, params, _engine_config(sharded=True), device=device)
    t0 = time.perf_counter()
    imported = dst.import_sequence(sx)
    synchronize(device)
    import_ms = (time.perf_counter() - t0) * 1e3
    lossless = lossless and imported and local == _extent_bytes(
        _written_extent(dst, rid))
    resumed = sx.emitted.tolist() + dst.run()[rid].tokens.tolist()
    unmigrated = Engine(sharded.config, params, _engine_config(),
                        device=device).run(_trace(cfg.vocab_size))
    return {
        "rid": rid, "kv_len": sx.kv_len, "pages": sx.extent.n_pages,
        "extent_mb": sx.extent.nbytes / 2**20, "export_ms": export_ms,
        "import_ms": import_ms, "lossless": bool(lossless),
        "extent_bit_identical": bool(identical),
        "max_abs_diff_vs_unsharded": diff, "max_rel_diff_vs_unsharded": rel,
        "same_sequence": same_rid and (sx.kv_len, sx.emitted.tolist(),
                                       sx.extent.slots)
        == (ref.kv_len, ref.emitted.tolist(), ref.extent.slots),
        "imported": imported,
        "tokens_identical": resumed == unmigrated[rid].tokens.tolist(),
        "export_gathers": gathers,
    }


def _per_step(counter, steps: int, scale: float = 1.0) -> dict:
    """The engine's decode-phase entries of a mesh counter, per step."""
    return {k.split("/", 1)[1]: v / steps * scale
            for k, v in counter.items() if k.startswith("decode/")}


def _run(args, rank: int, world: int) -> tuple:
    """(report, violations) for this rank."""
    import torch
    import torch.distributed as dist

    from tpu_dra_torch.workloads.device import resolve_device, synchronize
    from tpu_dra_torch.workloads.engine import Engine
    from tpu_dra_torch.workloads.generate import greedy_generate
    from tpu_dra_torch.workloads.models.llama import TINY_LLAMA, init_params
    from tpu_dra_torch.workloads.parallel import mesh as meshlib

    device = resolve_device(args.device)
    cfg = _model(args.model, args.layers)
    params = init_params(
        cfg, torch.Generator(device=device).manual_seed(7), device=device)
    report, bad = {"ok": False, "world": world, "model": args.model,
                   "layers": cfg.n_layers, "device": str(device),
                   "backend": dist.get_backend() if world > 1 else None}, []

    def check(ok: bool, message: str) -> None:
        if not ok:
            bad.append(message)

    # (1) ladder + clamp.
    check(meshlib.decode_mesh_shape(1, TINY_LLAMA) == (1, 1), "ladder 1")
    check(meshlib.decode_mesh_shape(2, TINY_LLAMA) == (1, 2), "ladder 2")
    check(meshlib.decode_mesh_shape(8, TINY_LLAMA) == (4, 2), "ladder 8")
    single = meshlib.build_decode_mesh(cfg, ranks=[rank], device=device)
    mesh = meshlib.build_decode_mesh(cfg, device=device)
    report["mesh_shapes"] = [dict(single.shape), dict(mesh.shape)]
    check(mesh.size == world, f"mesh {mesh.shape} over a world of {world}")

    # (4) the sharding rules engage, and the shards hold their columns.
    specs = meshlib.decode_param_shardings(mesh, params)
    check("model" in json.dumps(specs), "no leaf is sharded over model")
    m = mesh.shape["model"]
    shard = meshlib.shard_decode_params(mesh, params)
    local = {
        "wq": tuple(shard["layer_0"]["attention"]["wq"]["kernel"].shape),
        "w_up": tuple(shard["layer_0"]["mlp"]["w_up"]["kernel"].shape),
        "lm_head": tuple(shard["lm_head"]["kernel"].shape),
    }
    report["local_shapes"] = local
    check(local["wq"] == (cfg.dim, cfg.n_heads * cfg.head_dim // m)
          and local["w_up"] == (cfg.dim, cfg.ffn_dim // m)
          and local["lm_head"] == (cfg.dim, cfg.vocab_size // m),
          f"local shapes {local} over a model axis of {m}")
    report["column_slice_bit_identical"] = column_slice_identical(
        params, mesh, device)
    del shard

    # (2) greedy path parity on this rank's (1, 1) mesh and the world's.
    prompt = torch.tile(torch.arange(8, dtype=torch.int32)[None], (2, 1))
    tokens = []
    for mm in (single, mesh):
        label = f"{mm.shape['batch']}x{mm.shape['model']}"
        safe = meshlib.sharded_safe_config(cfg, mm)
        base = greedy_generate(safe, params, prompt, NEW_TOKENS,
                               device=device)
        sp = meshlib.shard_decode_params(mm, params)
        synchronize(device)
        t0 = time.perf_counter()
        out = greedy_generate(cfg, sp, prompt, NEW_TOKENS, device=device)
        report[f"greedy_seconds_{label}"] = round(
            time.perf_counter() - t0, 3)
        same = bool(torch.equal(base, out))
        report[f"greedy_parity_{label}"] = same
        if mm.size > 1 or not same:
            cos = first_step_cosine(cfg, params, sp, prompt.to(device),
                                    device)
            report[f"greedy_logit_cosine_{label}"] = cos
            check(same or (args.fallback_cosine is not None
                           and cos >= args.fallback_cosine),
                  f"sharded greedy decode diverged from single-device on "
                  f"{label} (logit cosine {cos})")
        tokens.append(out)

    # (3) engine parity, greedy and sampled, over a mixed-length trace.
    for name, kw in (("greedy", {}), ("sampled", SAMPLED)):
        sharded_eng = Engine(cfg, params, _engine_config(sharded=True, **kw),
                             device=device)
        plain = Engine(sharded_eng.config, params, _engine_config(**kw),
                       device=device).run(_trace(cfg.vocab_size))
        done = sharded_eng.run(_trace(cfg.vocab_size))
        check(set(plain) == set(done), f"{name}: completions differ")
        diverged = [rid for rid in plain
                    if not np.array_equal(plain[rid].tokens, done[rid].tokens)]
        report[f"engine_parity_{name}"] = len(plain) - len(diverged)
        check(not diverged, f"sharded {name} engine diverged from "
              f"unsharded on {diverged}")
        tokens += [torch.from_numpy(done[rid].tokens) for rid in sorted(done)]
        eng_mesh = sharded_eng.mesh
        steps = max(sharded_eng.decode_steps, 1)
        report[f"engine_{name}"] = {
            "mesh": dict(eng_mesh.shape),
            "decode_steps": sharded_eng.decode_steps,
            "prefill_buckets": sharded_eng.prefill_buckets,
            "collectives": dict(eng_mesh.collectives),
            "gather_ms": {k: v * 1e3
                          for k, v in eng_mesh.gather_seconds.items()},
            "gather_mb": {k: v / 2**20
                          for k, v in eng_mesh.gather_bytes.items()},
            "decode_ms_per_step": sharded_eng.decode_seconds / steps * 1e3,
            "decode_collectives_per_step": _per_step(eng_mesh.collectives,
                                                     steps),
            "decode_gather_ms_per_step": _per_step(eng_mesh.gather_seconds,
                                                   steps, 1e3),
        }
    # (5) live migration across the mesh.
    mig = migrate_round_trip(cfg, params, device)
    report["migrate"] = mig
    check(mig["imported"] and mig["lossless"] and mig["same_sequence"]
          and mig["max_rel_diff_vs_unsharded"] <= MIGRATE_FP32_REL,
          f"the round trip lost bits, or the sharded export is not the "
          f"unsharded one's within {MIGRATE_FP32_REL}: {mig}")
    check(mig["tokens_identical"], f"the imported sequence diverged: {mig}")
    if mesh.shape["model"] > 1 and device.type == "cuda" and (
            dist.get_backend() == "gloo"):
        report["gather_copies"] = gather_copies(mesh, device)
    if world > 1:
        # Every rank's tokens, the same everywhere: one all_gather of a
        # digest over the world.
        flat = torch.cat([t.flatten().to(torch.int64) for t in tokens])
        digest = torch.stack([flat.sum(), (flat * torch.arange(
            1, flat.numel() + 1)).sum(), torch.tensor(flat.numel())])
        if dist.get_backend() == "nccl":
            digest = digest.to(device)
        parts = [torch.empty_like(digest) for _ in range(world)]
        dist.all_gather(parts, digest)
        agree = all(torch.equal(p, parts[0]) for p in parts)
        report["ranks_agree"] = agree
        check(agree, "ranks' tokens differ")
    report["ok"] = not bad
    return report, bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser("tpu-dra-torch-shardbench")
    p.add_argument(
        "--config-dir", default=os.environ.get("CD_CONFIG_DIR", ""),
        help="Per-CD config dir; when set, bootstrap.env from it is "
        "loaded into the process env first (the CDI-injection analog)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; 'cpu' "
                   "for gloo on the host)")
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                   help="process group backend (default: NCCL for CUDA, "
                   "gloo for the CPU; gloo puts several ranks on one card)")
    p.add_argument("--model", default="tiny", choices=("tiny", "llama3-8b"),
                   help="TINY_LLAMA or Llama-3-8B widths, in fp32")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the depth to this many layers (0: the model's)")
    p.add_argument("--fallback-cosine", type=float, default=None,
                   help="admit a greedy_generate token difference when its "
                   "first decode step's logits agree to this cosine "
                   "(reported); the engine's tokens stay exact")
    args = p.parse_args(argv)

    from tpu_dra_torch.workloads.bootstrap import (
        initialize_from_env,
        read_bootstrap_env,
        shutdown,
    )

    if args.config_dir:
        env = read_bootstrap_env(args.config_dir)
        if env is None:
            print(f"no bootstrap.env under {args.config_dir}", file=sys.stderr)
            return 2
        os.environ.update(env)
        os.environ["CD_CONFIG_DIR"] = args.config_dir
    se = initialize_from_env(device=args.device, backend=args.backend)
    try:
        report, bad = _run(args, se.worker_id, se.num_processes)
    finally:
        shutdown()
    if se.worker_id == 0:
        print(json.dumps(report))
    for message in bad:
        print(f"shardbench: {message}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
