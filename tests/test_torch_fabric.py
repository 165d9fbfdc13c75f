"""The unmodified serving fabric (tpu_dra.serving.router.Router and the
claim autoscaler) driving replicas that hold the port's engine, on the
CPU.

TINY_LLAMA at fp32 with the flax weights converted in-process
(tests/torch_twin.py). Every gate holds the fabric's completions to
the JAX engine's own run of the same trace (greedy, or sampled under
the Router's pinned (seed, serial) schedule, which a JAX engine fed the
trace in submit order reproduces):

- two colocated (``both``-role) replicas serve a trace;
- scale-down through the autoscaler's own calls: quiesce, the
  evacuation handshake, ``requeue_evacuated``, claim deletion;
- prefill→decode live KV migration between a ``prefill`` and a
  ``decode`` replica: extents shipped, both allocators whole;
- a replica killed mid-generation (``mark_dead``) and recovered from
  the dispatch journal exactly once;
- the decode replica killed with a migrated extent in its inbox
  (tests/test_serving_disagg.py:373's twin);
- replica threads (``Replica.start``) and the begin_evacuate →
  evac_done → take_evacuated handshake, under a 60 s deadline.

The single-threaded drive mirrors ``Replica._loop`` step for step, as
tests/test_serving_disagg.py's ``_drive_disagg`` does.
"""

import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_twin import (  # noqa: E402
    EC,
    JCFG,
    make_params,
    random_trace,
    requests,
    torch_replica,
)

from tpu_dra.infra.metrics import Metrics  # noqa: E402
from tpu_dra.serving.autoscaler import (  # noqa: E402
    AutoscalerConfig,
    ClaimAutoscaler,
)
from tpu_dra.serving.router import (  # noqa: E402
    INTERACTIVE,
    Router,
    RouterConfig,
    TenantSpec,
)
from tpu_dra.workloads import engine as JE  # noqa: E402

MODES = [("greedy", {}),
         ("sampled", {"temperature": 0.8, "top_k": 8, "sample_seed": 7})]
DEADLINE_S = 60.0
POLL_S = 0.002


@pytest.fixture(scope="module")
def params():
    return make_params()


def _reference(params, trace, **kw) -> dict:
    """JAX's run of ``trace`` in submit order (admission serials 1..n,
    the Router's sampling serials): rid -> tokens."""
    eng = JE.Engine(JCFG, params[0], JE.EngineConfig(**dict(EC, **kw)))
    return {r: c.tokens.tolist()
            for r, c in eng.run(requests(JE, trace)).items()}


def _router(reps, metrics=None, **kw) -> Router:
    return Router(
        [TenantSpec("t", INTERACTIVE)], reps,
        RouterConfig(
            backlog_cap_tokens=1e9, max_inflight_per_replica=4,
            # The single-threaded drive does not wait out wall-clock
            # re-dispatch backoff.
            redispatch_backoff_base_seconds=0.0,
            redispatch_backoff_cap_seconds=0.0,
            **kw,
        ),
        metrics=metrics,
    )


def _submit(router, trace) -> None:
    for req in requests(JE, trace):
        assert router.submit("t", req)


def _loop_once(rep) -> None:
    """One pass of Replica._loop's body on the calling thread: the
    evacuation handshake, grafts between steps, one step, the outbox,
    and a prefill replica's exports."""
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
    """Poll, then one loop pass on every live replica; stops when the
    fabric is idle or ``until()`` holds."""
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


def _tokens(router) -> dict:
    assert router.duplicates_dropped == 0
    return {r: c.tokens.tolist() for r, c in router.completions.items()}


def _ledger_whole(rep) -> None:
    a = rep.engine.allocator
    assert a.free_pages == a.num_pages - 1 and a.reserved_pages == 0
    assert not rep.engine.busy


def _mid_generation(rep) -> bool:
    return any(s is not None and s.out for s in rep.engine._slots)


def test_colocated_replicas_serve_trace_token_identical(params):
    trace = random_trace(6, seed=41)
    reps = [torch_replica(f"r{i}", params) for i in range(2)]
    router = _router(reps)
    _submit(router, trace)
    _drive(router, reps)
    assert _tokens(router) == _reference(params, trace)
    assert all(len(c.replicas) == 1 for c in router.completions.values())
    assert {c.replicas[0] for c in router.completions.values()} == {
        "r0", "r1"}
    assert router.kv_migrations == {}
    for rep in reps:
        _ledger_whole(rep)


class _Claims:
    """The claim store the autoscaler deletes a drained replica's claim
    from (tests/test_serving_fabric.py's StubClaims, trimmed)."""

    def __init__(self, names):
        self.store = {n: {"metadata": {"name": n}} for n in names}
        self.deleted = []

    def try_get(self, name, namespace=None):
        return self.store.get(name)

    def delete(self, name, namespace=None):
        self.deleted.append(name)
        self.store.pop(name, None)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("label,kw", MODES)
def test_scale_down_evacuation_token_identical(params, label, kw):
    """The autoscaler's scale-down on torch replicas: it quiesces the
    victim and begins the evacuation, the replica's loop evacuates, the
    next tick requeues the evacuees and deletes the claim, and the
    survivor re-prefills them — every request once, JAX's tokens."""
    trace = random_trace(6, seed=43)
    reps = [torch_replica(f"c{i}", params, **kw) for i in range(2)]
    for rep in reps:
        rep.claim_name = rep.name
    router = _router(reps)
    claims, clock = _Claims(["c0", "c1"]), _Clock()
    scaler = ClaimAutoscaler(
        router, claims, make_claim=None, make_replica=None,
        config=AutoscalerConfig(
            min_replicas=1, max_replicas=3, target_tokens_per_replica=100.0,
            up_factor=1.0, down_factor=0.2, cooldown_seconds=5.0),
        clock=clock,
    )
    _submit(router, trace)
    _drive(router, reps, until=lambda: all(map(_mid_generation, reps)))
    assert router.queued_tokens() == 0
    scaler.tick()
    victim = scaler._draining
    assert victim is not None and victim.quiesced
    assert victim._evac_request.is_set()
    moved = set(victim.inflight)
    _loop_once(victim)  # the replica's loop runs the handshake
    assert victim.evac_done
    clock.t += 0.5
    scaler.tick()
    assert scaler.scaledowns == 1 and claims.deleted == [victim.name]
    assert victim not in router.replicas
    _ledger_whole(victim)
    down = [e for e in scaler.events if e[0] == "down-complete"][0]
    assert down[3]["engine_empty_at_delete"]
    survivor = [r for r in reps if r is not victim]
    _drive(router, survivor)
    assert _tokens(router) == _reference(params, trace, **kw), label
    assert moved and all(
        router.completions[rid].replicas[-1] == survivor[0].name
        for rid in moved)
    _ledger_whole(survivor[0])


@pytest.mark.parametrize("label,kw", MODES)
def test_prefill_to_decode_migration_token_identical(params, label, kw):
    """Live KV migration between torch engines under the Router: the
    prefill replica exports every sequence at prefill completion, the
    decode replica grafts and finishes it, and the tokens are JAX's
    unmigrated run's."""
    trace = random_trace(6, seed=47)
    m = Metrics()
    p0 = torch_replica("p0", params, role="prefill", **kw)
    d0 = torch_replica("d0", params, role="decode", **kw)
    router = _router([p0, d0], metrics=m)
    _submit(router, trace)
    _drive(router, [p0, d0])
    assert _tokens(router) == _reference(params, trace, **kw), label
    shipped = router.kv_migrations.get("shipped", 0)
    assert shipped >= 1 and m.get_counter(
        "fabric_kv_migrations_total", labels={"outcome": "shipped"}
    ) == shipped
    assert router.kv_migrated_pages > 0
    for c in router.completions.values():
        if c.replicas == ["p0", "d0"]:
            break
    else:
        raise AssertionError("no completion spans the two replicas")
    for rep in (p0, d0):
        _ledger_whole(rep)


def test_kill_mid_generation_recovered_exactly_once(params):
    """mark_dead on a replica with sequences mid-generation: the
    journal re-dispatches them to the survivor, every request completes
    once, and the tokens are JAX's."""
    trace = random_trace(6, seed=53)
    reps = [torch_replica(f"k{i}", params) for i in range(2)]
    router = _router(reps)
    _submit(router, trace)
    _drive(router, reps, until=lambda: _mid_generation(reps[0]))
    victims = set(reps[0].inflight)
    assert victims
    assert router.mark_dead(reps[0], "chaos: killed mid-generation") == len(
        victims)
    _drive(router, reps[1:])
    assert _tokens(router) == _reference(params, trace)
    assert router.redispatched == len(victims)
    assert not router.journal.entries
    _ledger_whole(reps[1])


def test_decode_death_at_migration_boundary_is_exactly_once(params):
    """tests/test_serving_disagg.py:373 on torch engines: the decode
    replica dies holding a dispatched extent (the source's pages
    already released); journal replay re-prefills prompt + emitted on
    the prefill replica, which decodes it itself once no decode pool
    is left."""
    trace = random_trace(1, seed=59, max_new=9)
    trace[0] = trace[0][:2] + (9, {})  # outlives the first step
    p0 = torch_replica("p0", params, role="prefill")
    d0 = torch_replica("d0", params, role="decode")
    router = _router([p0, d0])
    _submit(router, trace)
    router.poll()
    assert p0.export_enabled
    for _ in range(4):  # prefill (two chunks at most), then the export
        _loop_once(p0)
        if p0.migration_outbox:
            break
    assert len(p0.migration_outbox) == 1
    router.poll()  # collect the export, dispatch the extent onto d0
    rid = trace[0][0]
    assert rid in d0.inflight and d0._import_inbox
    router.mark_dead(d0, "chaos: died with the extent in hand")
    _drive(router, [p0])
    assert _tokens(router) == _reference(params, trace)
    assert set(router.completions) == {rid}
    _ledger_whole(p0)


def test_threaded_replicas_evacuation_handshake(params):
    """Replica threads (Replica.start) under the Router, and the
    autoscaler's handshake on a live thread: begin_evacuate, wait for
    evac_done, take_evacuated through requeue_evacuated, stop; the
    survivor finishes every request with JAX's tokens."""
    trace = random_trace(6, seed=61)
    reps = [torch_replica(f"t{i}", params) for i in range(2)]
    # The stall watchdog is not under test: a loaded test host must not
    # trip it.
    router = _router(reps, stall_deadline_seconds=DEADLINE_S)
    deadline = time.monotonic() + DEADLINE_S

    def poll_until(cond, what):
        """The control loop: poll at the fabric's own pace (a busy poll
        would hold the interpreter from the replica threads) until
        ``cond`` holds, failing at the deadline."""
        while not cond():
            assert time.monotonic() < deadline, f"timed out: {what}"
            assert not any(r.error or r.dead for r in reps), [
                (r.error, r.death_reason) for r in reps]
            router.poll()
            time.sleep(POLL_S)

    for rep in reps:
        rep.start()
    try:
        _submit(router, trace)
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
    assert _tokens(router) == _reference(params, trace)
    for rep in reps:
        _ledger_whole(rep)
