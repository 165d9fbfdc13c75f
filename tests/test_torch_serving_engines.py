"""The port's serving tier over the port's engines against the JAX
package's tier over JAX engines, on the CPU.

TINY_LLAMA at fp32, the flax weights converted in-process
(tests/torch_twin.py). Each case runs twice, the same trace each time:
JAX's Router (tpu_dra.serving) over JAX engines, and the port's Router
(tpu_dra_torch.serving) over the port's engines (``device="cpu"``).
Completions must be token-identical, each request served by the same
replicas, with the same migration, re-dispatch and duplicate counts,
and both equal to one JAX engine's run of the trace in submit order
(the Router's sampling serials are its admission serials):

- two colocated (``both``-role) replicas, greedy and sampled;
- scale-down through each package's autoscaler: quiesce, the
  evacuation handshake, ``requeue_evacuated``, claim deletion; greedy
  and sampled;
- prefill→decode live KV migration, greedy and sampled;
- a replica killed mid-generation and recovered from the journal;
- the decode replica killed with a migrated extent in its inbox;
- replica threads and the begin_evacuate → evac_done →
  take_evacuated handshake under a 60 s deadline.

The single-threaded drive runs ``Replica._loop``'s body step for step,
as tests/test_torch_fabric.py's does.
"""

import time
import types

import numpy as np
import pytest

pytest.importorskip("jax")

from torch_twin import (  # noqa: E402
    EC,
    JCFG,
    TCFG,
    make_params,
    random_trace,
    requests,
)

from tpu_dra.serving import autoscaler as JA  # noqa: E402
from tpu_dra.serving import router as JR  # noqa: E402
from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra_torch.serving import autoscaler as TA  # noqa: E402
from tpu_dra_torch.serving import router as TR  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402

SAMPLED = {"temperature": 0.8, "top_k": 8, "sample_seed": 7}
MODES = [("greedy", {}), ("sampled", SAMPLED)]
DEADLINE_S = 60.0
POLL_S = 0.002


@pytest.fixture(scope="module")
def params():
    return make_params()


class World:
    """One package's Router, autoscaler and engines over its weights."""

    def __init__(self, label, params):
        self.label = label
        if label == "jax":
            self.R, self.A, self.E = JR, JA, JE
            self.cfg, self.params, self.kw = JCFG, params[0], {}
        else:
            self.R, self.A, self.E = TR, TA, TE
            self.cfg, self.params, self.kw = TCFG, params[1], {
                "device": "cpu"}

    def replica(self, name, role="both", **ec):
        eng = self.E.Engine(self.cfg, self.params,
                            self.E.EngineConfig(**dict(EC, **ec)), **self.kw)
        return self.R.Replica(name, eng, role=role)

    def router(self, reps, **cfg):
        return self.R.Router(
            [self.R.TenantSpec("t", self.R.INTERACTIVE)], reps,
            self.R.RouterConfig(
                backlog_cap_tokens=1e9, max_inflight_per_replica=4,
                # The single-threaded drive does not wait out wall-clock
                # re-dispatch backoff.
                redispatch_backoff_base_seconds=0.0,
                redispatch_backoff_cap_seconds=0.0, **cfg))

    def submit(self, router, trace):
        for req in requests(self.E, trace):
            assert router.submit("t", req)


def _reference(params, trace, **kw) -> dict:
    eng = JE.Engine(JCFG, params[0], JE.EngineConfig(**dict(EC, **kw)))
    return {r: c.tokens.tolist()
            for r, c in eng.run(requests(JE, trace)).items()}


def _loop_once(rep) -> None:
    """One pass of Replica._loop's body on the calling thread."""
    if rep._evac_request.is_set():
        rep._drain_outbox()
        rep._evacuated = rep.engine.evacuate()
        rep._evac_request.clear()
        rep._evac_done.set()
    while rep._import_inbox:
        sx, t0 = rep._import_inbox.popleft()
        rep.import_results.append((sx, rep.engine.import_sequence(sx), t0))
    if rep.engine.busy:
        rep.engine.step()
    rep._drain_outbox()
    if rep.role == "prefill" and rep.export_enabled:
        for rid in rep.engine.decoding_rids():
            rep.migration_outbox.append(rep.engine.export_sequence(rid))


def _drive(router, reps, rounds=400, until=None) -> None:
    for _ in range(rounds):
        router.poll()
        if until is not None and until():
            return
        for rep in reps:
            if not rep.dead:
                _loop_once(rep)
        if not router.busy:
            break
    router.poll()


def _mid_generation(rep) -> bool:
    return any(s is not None and s.out for s in rep.engine._slots)


def _whole(rep) -> None:
    a = rep.engine.allocator
    assert a.free_pages == a.num_pages - 1 and a.reserved_pages == 0
    assert not rep.engine.busy


def _outcome(router, reps) -> dict:
    for rep in reps:
        _whole(rep)
    return {
        "tokens": {r: c.tokens.tolist()
                   for r, c in router.completions.items()},
        "replicas": {r: list(c.replicas)
                     for r, c in router.completions.items()},
        "migrations": dict(router.kv_migrations),
        "pages": router.kv_migrated_pages,
        "counts": (router.deaths, router.redispatched,
                   router.duplicates_dropped),
    }


class _Claims:
    def __init__(self, names):
        self.store = {n: {"metadata": {"name": n}} for n in names}
        self.deleted = []

    def try_get(self, name, namespace=None):
        return self.store.get(name)

    def delete(self, name, namespace=None):
        self.deleted.append(name)
        self.store.pop(name, None)


def colocated(w, trace, kw):
    reps = [w.replica(f"r{i}", **kw) for i in range(2)]
    router = w.router(reps)
    w.submit(router, trace)
    _drive(router, reps)
    assert {c.replicas[0] for c in router.completions.values()} == {
        "r0", "r1"}
    return _outcome(router, reps)


def scale_down(w, trace, kw):
    reps = [w.replica(f"c{i}", **kw) for i in range(2)]
    for rep in reps:
        rep.claim_name = rep.name
    router = w.router(reps)
    claims, clock = _Claims(["c0", "c1"]), types.SimpleNamespace(t=100.0)
    scaler = w.A.ClaimAutoscaler(
        router, claims, make_claim=None, make_replica=None,
        config=w.A.AutoscalerConfig(
            min_replicas=1, max_replicas=3, target_tokens_per_replica=100.0,
            up_factor=1.0, down_factor=0.2, cooldown_seconds=5.0),
        clock=lambda: clock.t)
    w.submit(router, trace)
    _drive(router, reps, until=lambda: all(map(_mid_generation, reps)))
    scaler.tick()
    victim = scaler._draining
    assert victim is not None and victim.quiesced
    _loop_once(victim)
    clock.t += 0.5
    scaler.tick()
    assert scaler.scaledowns == 1 and claims.deleted == [victim.name]
    survivor = [r for r in reps if r is not victim]
    _drive(router, survivor)
    out = _outcome(router, reps)
    out["events"] = [(e[0], e[1]) for e in scaler.events]
    return out


def migration(w, trace, kw):
    p0 = w.replica("p0", role="prefill", **kw)
    d0 = w.replica("d0", role="decode", **kw)
    router = w.router([p0, d0])
    w.submit(router, trace)
    _drive(router, [p0, d0])
    assert router.kv_migrations.get("shipped", 0) >= 1
    return _outcome(router, [p0, d0])


def kill_mid_generation(w, trace, kw):
    reps = [w.replica(f"k{i}", **kw) for i in range(2)]
    router = w.router(reps)
    w.submit(router, trace)
    _drive(router, reps, until=lambda: _mid_generation(reps[0]))
    victims = len(reps[0].inflight)
    assert victims and router.mark_dead(reps[0], "chaos") == victims
    _drive(router, reps[1:])
    assert not router.journal.entries
    return _outcome(router, reps[1:])


def decode_death_at_boundary(w, trace, kw):
    p0 = w.replica("p0", role="prefill", **kw)
    d0 = w.replica("d0", role="decode", **kw)
    router = w.router([p0, d0])
    w.submit(router, trace)
    router.poll()
    for _ in range(4):
        _loop_once(p0)
        if p0.migration_outbox:
            break
    assert len(p0.migration_outbox) == 1
    router.poll()
    assert d0._import_inbox
    router.mark_dead(d0, "chaos: died with the extent in hand")
    _drive(router, [p0])
    return _outcome(router, [p0])


def threaded_evacuation(w, trace, kw):
    reps = [w.replica(f"t{i}", **kw) for i in range(2)]
    router = w.router(reps, stall_deadline_seconds=DEADLINE_S)
    deadline = time.monotonic() + DEADLINE_S

    def poll_until(cond, what):
        while not cond():
            assert time.monotonic() < deadline, f"timed out: {what}"
            assert not any(r.error or r.dead for r in reps), [
                (r.error, r.death_reason) for r in reps]
            router.poll()
            time.sleep(POLL_S)

    for rep in reps:
        rep.start()
    try:
        w.submit(router, trace)
        victim = reps[0]
        poll_until(lambda: victim.engine.progress > 2, "victim progress")
        victim.quiesced = True
        victim.begin_evacuate()
        poll_until(lambda: victim.evac_done, "evac_done")
        router.requeue_evacuated(victim)
        router.remove_replica(victim)
        assert victim.stop(timeout=DEADLINE_S)
        poll_until(lambda: not router.busy, "fabric idle")
    finally:
        for rep in reps:
            rep.stop(timeout=DEADLINE_S)
    out = _outcome(router, reps)
    # Which replica finished a request depends on thread timing.
    out.pop("replicas")
    return out


def _single_decoder(seed):
    trace = random_trace(1, seed=seed, max_new=9)
    trace[0] = trace[0][:2] + (9, {})  # outlives the first step
    return trace


CASES = [
    (colocated, 41, "greedy"), (colocated, 41, "sampled"),
    (scale_down, 43, "greedy"), (scale_down, 43, "sampled"),
    (migration, 47, "greedy"), (migration, 47, "sampled"),
    (kill_mid_generation, 53, "greedy"),
    (decode_death_at_boundary, 59, "greedy"),
    (threaded_evacuation, 61, "greedy"),
]


@pytest.mark.parametrize(
    "case,seed,mode", CASES, ids=[f"{c.__name__}-{m}" for c, _, m in CASES])
def test_port_tier_over_port_engines_matches_jax(params, case, seed, mode):
    kw = dict(MODES)[mode]
    trace = (_single_decoder(seed) if case is decode_death_at_boundary
             else random_trace(6, seed=seed))
    jax_out = case(World("jax", params), trace, kw)
    port_out = case(World("port", params), trace, kw)
    assert port_out == jax_out
    assert port_out["tokens"] == _reference(params, trace, **kw)
    assert port_out["counts"][2] == 0  # no duplicate completion
