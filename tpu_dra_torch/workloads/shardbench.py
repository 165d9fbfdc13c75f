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

Each unsharded reference runs the sharded run's config (kept over any
mesh: the kernels on a CUDA tensor, the plain versions on the CPU), so
the comparison isolates the sharding. Over
several ranks every rank also checks that all ranks' tokens agree, and
reports the cosine of the sharded against the unsharded logits of the
prefill and first decode step (``greedy_logit_cosine_<b>x<m>``) and
whether its column block of an fp32 product is bit for bit the same
columns of the full product (``column_slice_bit_identical``).
Over gloo with CUDA tensors it also reports the device copies one
model-axis gather makes, from a ``torch.profiler`` trace
(``gather_copies``: gloo stages the tensors through host memory).

On the card the decode kernels run on each rank's shard (the config is
kept): each sharded run reports its kernel launches a decode step,
held to a reckoning (a layer of a decode step is one paged or
contiguous decode attention call and one MLP call, the MLP's two halves
around the gather of ``silu(gate)·up``), and the calls its
kernel-capable ops made of their plain versions on a CUDA tensor
(``plain_on_card``, held at 0). Over a model axis above 1 it also runs
``kernel_shard_check`` (this rank's heads and act columns against the
unsharded kernel calls, bit for bit, in fp32 and bf16) and a bf16
engine arm, whose first decode step's logits are held to the unsharded
bf16 engine's at ``BF16_COSINE`` (its tokens are reported: bf16
column blocks of the cuBLAS projections round otherwise).
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
import collections
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

from tpu_dra_torch import kernels

SAMPLED = {"temperature": 0.8, "top_k": 8, "sample_seed": 5}
NEW_TOKENS = 12  # greedy_generate's, as JAX's shardbench
#: The bf16 engine arm's first decode step logits against the unsharded
#: bf16 engine's (the bar chip_smoke.py holds bf16 step logits to).
BF16_COSINE = 0.999
#: The kernel-capable ops' plain versions, as their dispatchers reach
#: them: (module, function) under ops/.
PLAIN_VERSIONS = (("attention", "_torch_paged_decode_attention"),
                  ("attention", "_torch_decode_attention"),
                  ("decode_mlp", "_torch_decode_mlp"))


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
    out = []
    for tree, m in ((G.unroll_params(as_tree(params)), None), (sharded, mesh)):
        cache = G.init_cache(cfg, prompt.shape[0], 64, device=device, mesh=m)
        first = G.forward_chunk(cfg, tree, cache, prompt)[:, -1]
        tok = torch.argmax(first, dim=-1).to(prompt.dtype)[:, None]
        out.append((first, G.forward_chunk(cfg, tree, cache, tok)[:, -1]))
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


@contextlib.contextmanager
def _spy(module, name: str, on_call):
    """Stand in for ``module.name`` while the body runs: each call is
    forwarded, then ``on_call(args, result)`` sees it."""
    fn = getattr(module, name)

    def call(*args, **kw):
        out = fn(*args, **kw)
        on_call(args, out)
        return out

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def plain_on_card():
    """Count, by function, the calls of a kernel-capable op's plain
    version (PLAIN_VERSIONS) on a CUDA tensor while the body runs."""
    import importlib

    counts = collections.Counter()

    def counter(name):
        def on_call(args, _):
            if args[0].is_cuda:
                counts[name] += 1
        return on_call

    with contextlib.ExitStack() as stack:
        for mod_name, name in PLAIN_VERSIONS:
            mod = importlib.import_module(
                f"tpu_dra_torch.workloads.ops.{mod_name}")
            stack.enter_context(_spy(mod, name, counter(name)))
        yield counts


@contextlib.contextmanager
def first_decode_logits():
    """Keep the fp32 logits [B, vocab] of the first engine decode step
    the body runs, with its active rows [B]: the list holds (logits,
    active) once a step has run."""
    from tpu_dra_torch.workloads import engine as E

    seen = []

    def on_call(args, out):
        if not seen:
            seen.append((out[2].detach().clone(), args[6].clone()))

    with _spy(E, "_decode_step", on_call):
        yield seen


@contextlib.contextmanager
def single_token_prefills():
    """Count the engine's prefill passes one token wide while the body
    runs: such a pass runs the decode MLP (s = 1) as a decode step
    does. The list holds the count."""
    from tpu_dra_torch.workloads import engine as E

    seen = [0]

    def on_call(args, _):
        seen[0] += int(args[5].shape[1] == 1)

    with _spy(E, "_prefill_batch", on_call):
        yield seen


def mlp_half_names(dtype) -> tuple:
    """The launch counters of the MLP's gate/up and down halves at the
    engine's slot count on this dtype: the tensor-core kernel's for bf16,
    decode_mlp.cu's for fp32."""
    import torch

    if dtype == torch.bfloat16:
        return "decode_mlp_sm90_gate_up", "decode_mlp_sm90_down"
    return "decode_mlp_gate_up", "decode_mlp_down"


def reckoned_decode_launches(cfg, mesh, steps: int,
                             single_prefills: int = 0) -> dict:
    """An engine run's decode kernel launches on one rank of ``mesh``:
    each layer of a decode step one paged decode attention call and one
    MLP call, and each layer of a one-token prefill pass one more MLP
    call. An MLP call is the fused block on a model axis of 1 (counted
    once as "decode_mlp", twice as "decode_mlp_sm90" for bf16: the
    tensor-core kernel's two launches) or, on a model shard, its two
    halves, one launch each."""
    import torch

    n = cfg.n_layers
    mlp = n * (steps + single_prefills)
    want = {"paged_decode_attention": n * steps}
    if mesh.shape["model"] > 1:
        want.update(dict.fromkeys(mlp_half_names(cfg.dtype), mlp))
    else:
        want["decode_mlp"] = mlp
        if cfg.dtype == torch.bfloat16:
            want["decode_mlp_sm90"] = 2 * mlp
    return want


def kernel_shard_check(mesh, device) -> dict:
    """This rank's shard of each decode kernel against the unsharded
    call, at Llama-3-8B widths (h 32, kvh 8, hd 128, d 4096, ffn 14336)
    in fp32 and bf16, from inputs seeded alike on every rank: its heads
    of the paged (8 slots of 8192 keys) and the contiguous (8 rows, 8187
    of 8192 keys) decode attention, planned as the unsharded heads', are
    those heads of the unsharded call bit for bit; its act columns of
    the MLP's gate/up half (3 rows, the engine's slots) are those
    columns of the unsharded half's; and the down half over the act
    gathered over the model axis is the fused kernel's output bit for
    bit. Returns {case: bool}, the halves' routes and the largest
    difference of each case."""
    import torch

    from tpu_dra_torch.workloads.ops import attention as A
    from tpu_dra_torch.workloads.ops import decode_mlp as DM

    m, j = mesh.shape["model"], mesh.coords[1]
    h, kvh, hd, d, ffn = 32, 8, 128, 4096, 14336
    b, page, cap, rows, eps = 8, 16, 8192, 3, 1e-5
    heads = slice(j * h // m, (j + 1) * h // m)
    kv = slice(j * kvh // m, (j + 1) * kvh // m)
    cols = slice(j * ffn // m, (j + 1) * ffn // m)
    gen = torch.Generator(device=device).manual_seed(11)
    out, diff, routes = {}, {}, {}

    def held(case, got, want):
        out[case] = bool(torch.equal(got, want))
        diff[case] = float((got.float() - want.float()).abs().max())

    for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        def rnd(*shape, std=1.0):
            return (std * torch.randn(*shape, generator=gen,
                                      device=device)).to(dt)

        q = rnd(b, h, hd)
        qm = q[:, heads].contiguous()
        per = cap // page
        kp, vp = rnd(b * per + 1, page, kvh, hd), rnd(b * per + 1, page, kvh,
                                                      hd)
        tables = (torch.randperm(b * per, generator=gen, device=device)
                  + 1).reshape(b, per).to(torch.int32)
        lens = torch.randint(1, cap + 1, (b,), generator=gen, device=device,
                             dtype=torch.int32)
        full = A.paged_decode_attention(q, kp, vp, tables, lens, impl="cuda")
        held(f"paged_{tag}", A.paged_decode_attention(
            qm, kp[:, :, kv].contiguous(), vp[:, :, kv].contiguous(), tables,
            lens, impl="cuda", plan_kv_heads=kvh), full[:, heads])
        del kp, vp
        k, v = rnd(b, cap, kvh, hd), rnd(b, cap, kvh, hd)
        full = A.decode_attention(q, k, v, cap - 5, impl="cuda")
        held(f"contiguous_{tag}", A.decode_attention(
            qm, k[:, :, kv].contiguous(), v[:, :, kv].contiguous(), cap - 5,
            impl="cuda", plan_kv_heads=kvh), full[:, heads])
        del k, v
        x = rnd(rows, d)
        scale = (1 + 0.1 * torch.randn(d, generator=gen,
                                       device=device)).to(dt)
        tree = {"w_gate": {"kernel": rnd(d, ffn, std=0.02)},
                "w_up": {"kernel": rnd(d, ffn, std=0.02)},
                "w_down": {"kernel": rnd(ffn, d, std=0.02)}}
        shard = dict(tree, **{n: {"kernel": tree[n]["kernel"][:, cols]
                                  .contiguous()}
                              for n in ("w_gate", "w_up")})
        act = DM.mlp_gate_up(x, scale, shard, eps, ffn=ffn, impl="cuda")
        held(f"gate_up_{tag}", act, DM.mlp_gate_up(
            x, scale, tree, eps, impl="cuda")[:, cols])
        whole = mesh.gather_model(act)
        held(f"down_{tag}", DM.mlp_down(x, whole, tree, impl="cuda"),
             DM.decode_mlp(x, scale, tree, eps, impl="cuda"))
        routes[tag] = {
            "gate_up": DM._gate_up_route(x, shard["w_gate"]["kernel"],
                                         shard["w_up"]["kernel"], ffn),
            "down": DM._down_route(x, whole, tree["w_down"]["kernel"])}
        del x, tree, shard, act, whole
    return {"bit_identical": out, "max_abs_diff": diff, "routes": routes}


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


def _launches() -> dict:
    return {k: v for k, v in kernels.LAUNCHES.items() if v}


#: The launch counters of the decode kernels (every other counter is
#: reported, not reckoned).
DECODE_KERNELS = ("paged_decode_attention", "decode_attention", "decode_mlp",
                  "decode_mlp_sm90", "decode_mlp_gate_up", "decode_mlp_down",
                  "decode_mlp_sm90_gate_up", "decode_mlp_sm90_down")


def _launch_reckoning(cfg, mesh, steps: int, single_prefills: int,
                      launches: dict, plain_calls, device, check,
                      what: str) -> dict:
    """A sharded engine run's decode kernel launches against
    :func:`reckoned_decode_launches` (on the card), and its plain calls
    on the card at 0. Returns the report's keys: every counter a decode
    step, and the reckoning."""
    out = {"decode_steps": steps, "single_token_prefills": single_prefills,
           "launches_per_decode_step": {
               k: v / max(steps, 1) for k, v in launches.items()}}
    if device.type != "cuda":
        return out
    want = reckoned_decode_launches(cfg, mesh, steps, single_prefills)
    out["reckoned_launches"] = want
    got = {k: launches[k] for k in DECODE_KERNELS if k in launches}
    check(got == want and not plain_calls,
          f"{what}: decode kernel launches {got}, want {want}; plain calls "
          f"on the card {dict(plain_calls)}")
    return out


def bf16_engine_arm(cfg, device, check) -> tuple:
    """The greedy trace through a bf16 engine sharded over the world's
    mesh (the tensor-core MLP halves) and unsharded: the first decode
    step's logits at cosine >= BF16_COSINE, the launches as reckoned,
    no plain call on the card; the tokens' agreement reported. Returns
    (report, the sharded run's launches)."""
    import torch

    from tpu_dra_torch.workloads.engine import Engine
    from tpu_dra_torch.workloads.models.llama import init_params

    bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
    params = init_params(
        bcfg, torch.Generator(device=device).manual_seed(7), device=device)
    with first_decode_logits() as ref:
        want = Engine(bcfg, params, _engine_config(), device=device).run(
            _trace(bcfg.vocab_size))
    eng = Engine(bcfg, params, _engine_config(sharded=True), device=device)
    kernels.reset_launches()
    with first_decode_logits() as mine, plain_on_card() as plain_calls, \
            single_token_prefills() as s1:
        done = eng.run(_trace(bcfg.vocab_size))
    launches = _launches()
    run = {"launches": launches, "plain_on_card": dict(plain_calls)}
    run.update(_launch_reckoning(bcfg, eng.mesh, eng.decode_steps, s1[0],
                                 launches, plain_calls, device, check,
                                 "sharded bf16 engine"))
    (a, act_a), (b, act_b) = ref[0], mine[0]
    cos = _cosine(a[act_a], b[act_b]) if torch.equal(act_a, act_b) else -1.0
    check(cos >= BF16_COSINE, f"bf16 sharded engine: first decode step "
          f"logit cosine {cos} below {BF16_COSINE}")
    pairs = [(np.asarray(want[r].tokens), np.asarray(done[r].tokens))
             for r in want if r in done]
    total = sum(len(c.tokens) for c in want.values())
    same = sum(int(np.sum(a[:len(b)] == b[:len(a)])) for a, b in pairs)
    steps = max(eng.decode_steps, 1)
    return {"first_step_logit_cosine": cos, "token_agreement": same / total,
            "decode_steps": eng.decode_steps,
            "decode_ms_per_step": eng.decode_seconds / steps * 1e3,
            "decode_collectives_per_step": _per_step(eng.mesh.collectives,
                                                     steps),
            "decode_gather_ms_per_step": _per_step(
                eng.mesh.gather_seconds, steps, 1e3)}, run


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
    # This rank's sharded runs: their kernel launches (the path's) and
    # plain calls on the card, gathered over the world below.
    runs = {}
    for mm in (single, mesh):
        label = f"{mm.shape['batch']}x{mm.shape['model']}"
        kernels.reset_launches()
        base = greedy_generate(cfg, params, prompt, NEW_TOKENS,
                               device=device)
        base_launches = _launches()
        sp = meshlib.shard_decode_params(mm, params)
        synchronize(device)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with plain_on_card() as plain_calls:
            out = greedy_generate(cfg, sp, prompt, NEW_TOKENS, device=device)
        report[f"greedy_seconds_{label}"] = round(
            time.perf_counter() - t0, 3)
        launches = _launches()
        runs[f"greedy_{label}"] = {"launches": launches,
                                   "plain_on_card": dict(plain_calls)}
        if device.type == "cuda":
            # The unsharded run's decode steps, each layer's MLP call as
            # its two halves on a model shard.
            want = dict(base_launches)
            if mm.shape["model"] > 1:
                calls = want.pop("decode_mlp", 0)
                want.pop("decode_mlp_sm90", None)
                want.update(dict.fromkeys(mlp_half_names(cfg.dtype), calls))
            check(launches == want and not plain_calls,
                  f"greedy_generate {label}: launches {launches}, want "
                  f"{want}; plain calls on the card {dict(plain_calls)}")
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
        kernels.reset_launches()
        with plain_on_card() as plain_calls, single_token_prefills() as s1:
            done = sharded_eng.run(_trace(cfg.vocab_size))
        launches = _launches()
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
        runs[f"engine_{name}"] = {"launches": launches,
                                  "plain_on_card": dict(plain_calls)}
        runs[f"engine_{name}"].update(_launch_reckoning(
            cfg, eng_mesh, sharded_eng.decode_steps, s1[0], launches,
            plain_calls, device, check, f"sharded {name} engine"))
    if mesh.shape["model"] > 1 and device.type == "cuda":
        report["kernel_shard_check"] = ks = kernel_shard_check(mesh, device)
        check(all(ks["bit_identical"].values()),
              f"a kernel's shard differs from the unsharded call: {ks}")
        check(ks["routes"] == {"fp32": {"gate_up": "simt", "down": "simt"},
                               "bf16": {"gate_up": "sm90", "down": "sm90"}},
              f"MLP halves' routes {ks['routes']}")
        report["engine_bf16"], runs["engine_bf16"] = bf16_engine_arm(
            cfg, device, check)
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
        # Every rank's runs, reported by rank 0.
        by_rank = [None] * world
        dist.all_gather_object(by_rank, runs)
        report["launches_by_rank"] = by_rank
    else:
        report["launches_by_rank"] = [runs]
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
