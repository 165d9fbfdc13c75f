"""Helpers shared by the engine twin tests (tests/test_torch_prefix.py,
tests/test_torch_drain.py, tests/test_torch_migrate.py,
tests/test_torch_fabric.py): the JAX engine and the port's engine on
TINY_LLAMA at fp32 with the same weights, stepped in lockstep through
the same trace, their host state compared after every step; KV extents
carried between the two packages; Router replicas holding port
engines."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpu_dra.serving.router import Replica
from tpu_dra.workloads import engine as JE
from tpu_dra.workloads import paged_kv as JP
from tpu_dra.workloads.models.llama import TINY_LLAMA as JAX_TINY
from tpu_dra.workloads.models.llama import Llama
from tpu_dra_torch.workloads import engine as TE
from tpu_dra_torch.workloads.convert import (
    extent_from_numpy,
    params_from_numpy,
)
from tpu_dra_torch.workloads.models.llama import TINY_LLAMA

JCFG = dataclasses.replace(JAX_TINY, dtype=jnp.float32, param_dtype=jnp.float32)
TCFG = dataclasses.replace(
    TINY_LLAMA, dtype=torch.float32, param_dtype=torch.float32
)
# tests/test_engine.py's _ec() and _spec_ec().
EC = dict(page_size=4, max_slots=3, max_pages_per_seq=10, scan_chunk=3,
          prefill_chunk=8)
SPEC_EC = dict(EC, max_pages_per_seq=16)
SAMPLED = dict(temperature=0.8, top_k=8, sample_seed=7)


def make_params():
    """(JAX params, the port's params converted from them)."""
    jp = Llama(JCFG).init_params(jax.random.PRNGKey(7), batch=2, seq=8)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, TCFG, device="cpu")


def random_trace(n=6, seed=11, max_prompt=14, max_new=9):
    """(rid, prompt, max_new, {}) as tests/test_engine.py's _reqs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(
            1, JCFG.vocab_size, rng.integers(2, max_prompt + 1)
        ).astype(np.int32)
        out.append((f"r{i}", prompt, int(rng.integers(1, max_new + 1)), {}))
    return out


def lookup_trace(n=4, seed=3, max_new=16):
    """Repetitive prompts (tests/test_engine.py's _lookup_reqs)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        motif = rng.integers(1, JCFG.vocab_size, 5).astype(np.int32)
        out.append((f"lk{i}", np.tile(motif, 4)[:18], max_new, {}))
    return out


def fleet_trace(prompt, n, max_new=8, share=True, prefix_len=16):
    """tests/test_engine.py's _fleet_reqs."""
    extra = {"prefix_id": "sys", "prefix_len": prefix_len} if share else {}
    return [(f"f{i}", prompt, max_new, dict(extra)) for i in range(n)]


def requests(mod, trace):
    return [mod.Request(rid=r, prompt=p, max_new_tokens=n, **kw)
            for r, p, n, kw in trace]


class Twin:
    """The JAX engine and the port's engine built alike; every call
    goes to both."""

    def __init__(self, params, ec=None, gates=None, metrics=None, **kw):
        jp, tp = params
        ec = dict(EC if ec is None else ec)
        ec.update(kw)
        gates = gates or (None, None)
        metrics = metrics or (None, None)
        self.j = JE.Engine(JCFG, jp, JE.EngineConfig(**ec), gate=gates[0],
                           metrics=metrics[0])
        self.t = TE.Engine(TCFG, tp, TE.EngineConfig(**ec), gate=gates[1],
                           metrics=metrics[1], device="cpu")

    def add(self, trace):
        for eng, mod in ((self.j, JE), (self.t, TE)):
            for r in requests(mod, trace):
                eng.add_request(r)

    def step(self, n=1):
        """``n`` lockstep steps, the host state held equal after each."""
        for _ in range(n):
            self.j.step()
            self.t.step()
            assert_same_state(self.j, self.t)

    def run(self, trace=()):
        """Submit ``trace``, step both to idle in lockstep, then let
        ``run`` make its idle exit; returns both completion dicts."""
        self.add(trace)
        while self.j.busy or self.t.busy:
            self.step()
        jd, td = self.j.run([]), self.t.run([])
        assert_same_state(self.j, self.t)
        return jd, td


def state(eng) -> dict:
    """The host bookkeeping two engines on the same trace must share:
    block tables, lengths, the allocator's free list and refcounts,
    the prefix registry in its LRU order, the sharing counters, and
    every live sequence's emitted tokens."""
    a = eng.allocator
    return {
        "tables": eng._tables.tolist(),
        "lengths": eng._lengths.tolist(),
        "active": eng._active.tolist(),
        "free": list(a._free), "refs": list(a._ref),
        "reserved": a.reserved_pages, "min_free": a.min_free,
        "pending_zero": list(eng._pending_zero),
        "registry": [(k, e.length, list(e.pages), e.tokens.tolist())
                     for k, e in eng._prefix_registry.items()],
        "prefix_attached": eng.prefix_attached,
        "cow_copies": eng.cow_copies,
        "prefix_saved_hw": eng.prefix_saved_hw,
        "spec": (eng.spec_proposed, eng.spec_accepted),
        "queue": [s.req.rid for s in eng._queue],
        "live": {s.req.rid: list(s.out) for s in eng._live()},
        "completed": sorted(eng.completed),
        "stalled": eng._stalled_since is not None,
        "blocked_on_pages": eng._blocked_on_pages,
        "busy": eng.busy,
    }


def assert_same_state(j, t) -> None:
    sj, st = state(j), state(t)
    diff = {k: (sj[k], st[k]) for k in sj if sj[k] != st[k]}
    assert not diff, diff


def assert_same_tokens(jd, td) -> None:
    assert sorted(jd) == sorted(td)
    for rid in jd:
        assert np.array_equal(jd[rid].tokens, td[rid].tokens), rid


def peak_pages(eng) -> int:
    a = eng.allocator
    return a.num_pages - 1 - a.min_free


def rendered(metrics) -> tuple:
    """({series name: type}, {counter name: value}) from the text
    exposition of a tpu_dra.infra.metrics.Metrics."""
    kinds, counters = {}, {}
    for line in metrics.render().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            kinds[name] = kind
        elif line and kinds.get(line.split()[0]) == "counter":
            name, value = line.split()
            counters[name] = float(value)
    return kinds, counters


def extent_to_numpy(extent) -> JP.KVExtent:
    """The port's KVExtent -> the JAX one, its payload numpy (bf16 as
    ml_dtypes bfloat16 through the 16-bit pattern, bit for bit): the
    reverse of ``convert.extent_from_numpy``."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(jnp.bfloat16)
        return t.numpy()

    return JP.KVExtent(
        page_size=extent.page_size, length=extent.length,
        quantized=extent.quantized, slots=tuple(extent.slots),
        payload={name: tuple(leaf(t) for t in layers)
                 for name, layers in extent.payload.items()},
    )


def to_port(sx):
    """A JAX SequenceExtent whose extent the port's engine can graft."""
    return dataclasses.replace(
        sx, extent=extent_from_numpy(sx.extent, device="cpu"))


def to_jax(sx):
    """A port SequenceExtent whose extent the JAX engine can graft."""
    return dataclasses.replace(sx, extent=extent_to_numpy(sx.extent))


def torch_replica(name, params, role="both", ec=None, **kw) -> Replica:
    """A serving-fabric Replica holding the port's engine on the CPU,
    built as ``Twin`` builds it."""
    ec = dict(EC if ec is None else ec)
    ec.update(kw)
    engine = TE.Engine(TCFG, params[1], TE.EngineConfig(**ec), device="cpu")
    return Replica(name, engine, role=role)
