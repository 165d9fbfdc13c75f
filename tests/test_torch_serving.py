"""The port's serving tier (tpu_dra_torch/serving/, tpu_dra_torch/infra/)
held to the JAX package's (tpu_dra/serving/, tpu_dra/infra/) on the
same inputs, on stub engines:

- the fault machinery: ``redispatch_backoff`` over seeded (rid,
  attempt) pairs, ``CircuitBreaker`` opening and ageing out on the same
  death times, ``DispatchJournal`` snapshot → restore;
- the Router's decisions: the cases of tests/test_serving_fabric.py
  (WFQ, admission, affinity, the evacuation splice) and
  tests/test_serving_faults.py (crash and stall detection, journal
  recovery, backoff, degradation, the breaker, the restart drills), each
  run once through each package's Router over stub engines built from
  that package's ``Completion`` / ``Evacuated``; compared: each
  replica's dispatch order, completions, ``tenant_stats()``, the
  journal, open breaker keys, the death log, shed counts and every
  metrics call in order;
- the claim autoscaler on the JAX package's ``FakeCluster``: scale-up
  waits for the packer, scale-down drains before it deletes the claim,
  a reversal inside the cooldown is suppressed, a first death re-binds,
  a crash loop quarantines and replaces, a vanished claim kills and
  replaces; equal event logs;
- replica threads: a wedged engine's stop timeout and an injected
  crash, alike in both packages;
- the port's tier without JAX (a subprocess with jax, flax and tpu_dra
  blocked), its single-owner check, its spans, and the thread-safe
  kernel launch counter.

Every router runs on a fake clock, so two runs of a case are equal to
the last stamp.
"""

import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from tpu_dra.infra import trace as jtrace  # noqa: E402
from tpu_dra.k8sclient import RESOURCE_CLAIMS, ResourceClient  # noqa: E402
from tpu_dra.k8sclient.fake import FakeCluster  # noqa: E402
from tpu_dra.serving import autoscaler as JA  # noqa: E402
from tpu_dra.serving import faults as JF  # noqa: E402
from tpu_dra.serving import router as JR  # noqa: E402
from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra_torch import kernels  # noqa: E402
from tpu_dra_torch.infra import lockdep as tlockdep  # noqa: E402
from tpu_dra_torch.infra import trace as ttrace  # noqa: E402
from tpu_dra_torch.serving import autoscaler as TA  # noqa: E402
from tpu_dra_torch.serving import faults as TF  # noqa: E402
from tpu_dra_torch.serving import router as TR  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
WORLDS = {
    "jax": types.SimpleNamespace(R=JR, F=JF, A=JA, E=JE),
    "port": types.SimpleNamespace(R=TR, F=TF, A=TA, E=TE),
}


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class RecordingMetrics:
    """Duck-typed metrics (``inc``, ``set_gauge``, ``observe``) that
    keep every call in order."""

    def __init__(self):
        self.calls = []

    def _key(self, labels):
        return tuple(sorted((labels or {}).items()))

    def inc(self, name, value=1.0, labels=None):
        self.calls.append(("inc", name, float(value), self._key(labels)))

    def set_gauge(self, name, value, labels=None):
        self.calls.append(("gauge", name, float(value), self._key(labels)))

    def observe(self, name, value, labels=None):
        self.calls.append(("observe", name, float(value), self._key(labels)))


class StubEngine:
    """tests/test_serving_fabric.py's StubEngine over one package's
    dataclasses and the case's clock: one request completes per step,
    in arrival order; evacuate hands back whatever is queued."""

    def __init__(self, w, clock):
        self.w, self.clock = w, clock
        self.queue, self.completed, self.order = [], {}, []
        self.closed = False

    def add_request(self, req):
        self.queue.append(req)
        self.order.append(req.rid)

    @property
    def busy(self):
        return bool(self.queue)

    def step(self):
        if self.queue:
            r = self.queue.pop(0)
            now = self.clock()
            self.completed[r.rid] = self.w.E.Completion(
                rid=r.rid, tokens=np.arange(r.max_new_tokens, dtype=np.int32),
                t_submit=now, t_arrival=now, t_first_token=now, t_done=now)
        return self.busy

    def evacuate(self):
        out = [self.w.E.Evacuated(req=r, emitted=np.zeros(0, np.int32),
                                  t_submit=0.0, t_first=None)
               for r in self.queue]
        self.queue = []
        return out

    def close(self):
        self.closed = True


class Case:
    """One run of a case in one package: its world, clock, metrics and
    the routers and replicas it made."""

    def __init__(self, w):
        self.w = w
        self.clock = FakeClock()
        self.metrics = RecordingMetrics()
        self.routers, self.reps = [], []

    def req(self, rid, plen=4, out=5):
        return self.w.E.Request(rid=rid, prompt=np.ones(plen, np.int32),
                                max_new_tokens=out)

    def replica(self, name, claim_name=""):
        rep = self.w.R.Replica(name, StubEngine(self.w, self.clock),
                               claim_name=claim_name)
        self.reps.append(rep)
        return rep

    def tenant(self, name, slo="INTERACTIVE", weight=1.0):
        return self.w.R.TenantSpec(name, getattr(self.w.R, slo), weight)

    def router(self, tenants, reps, **cfg):
        base = dict(backlog_cap_tokens=1e9, max_inflight_per_replica=4,
                    redispatch_backoff_base_seconds=0.01,
                    redispatch_backoff_cap_seconds=0.02)
        base.update(cfg)
        r = self.w.R.Router(tenants, reps, self.w.R.RouterConfig(**base),
                            metrics=self.metrics, clock=self.clock)
        self.routers.append(r)
        return r

    def drive(self, router, reps, steps=200, dt=0.05):
        """Poll, then step every engine once and drain its outbox; the
        clock advances each pass so backoffs lapse."""
        for _ in range(steps):
            self.clock.t += dt
            router.poll()
            for rep in reps:
                if rep.engine.busy:
                    rep.engine.step()
                rep._drain_outbox()
            if not router.busy:
                break
        router.poll()

    def observe(self) -> dict:
        out = {"metrics": self.metrics.calls, "routers": []}
        for r in self.routers:
            out["routers"].append({
                "completions": {
                    rid: (c.tokens.tolist(), c.t_submit, c.t_first_token,
                          c.t_done, list(c.replicas))
                    for rid, c in r.completions.items()},
                "tenant_stats": r.tenant_stats(),
                "journal": r.journal.snapshot(),
                "open_breakers": r.breaker.open_keys(),
                "breaker": r.breaker.snapshot(),
                "deaths": (r.deaths, r.death_log, r.redispatched,
                           r.duplicates_dropped, dict(r.shed)),
                "affinity": (r.affinity_hits, r.affinity_misses),
                "max_lag": r.max_lag_tokens,
                "backlog": (r.backlog_tokens(), r.queued_tokens(),
                            r.in_system(), r.queued_prefill_tokens(),
                            r.queued_decode_tokens()),
                "replicas": [rep.name for rep in r.replicas],
            })
        out["replicas"] = {
            rep.name: (list(rep.engine.order), rep.dead, rep.death_reason,
                       rep.quiesced, sorted(rep.inflight))
            for rep in self.reps}
        return out


# --- the Router's decisions: the JAX tests' cases -----------------------


def wfq_weight_ratio(c):
    a, b = c.tenant("a", weight=3.0), c.tenant("b", "BATCH")
    rep = c.replica("r0")
    router = c.router([a, b], [rep], max_inflight_per_replica=1)
    for i in range(12):
        router.submit("a", c.req(f"a{i}", plen=5, out=5))
        router.submit("b", c.req(f"b{i}", plen=5, out=5))
    c.drive(router, [rep], steps=100)
    assert sum(r.startswith("a") for r in rep.engine.order[:12]) == 9


def wfq_late_quiet_arrival(c):
    quiet, hot = c.tenant("quiet"), c.tenant("hot", "BATCH")
    rep = c.replica("r0")
    router = c.router([quiet, hot], [rep], max_inflight_per_replica=1)
    for i in range(20):
        router.submit("hot", c.req(f"h{i:02d}"))
    router.poll()
    rep.engine.step()
    rep._drain_outbox()
    router.poll()
    router.submit("quiet", c.req("q0"))
    c.drive(router, [rep], steps=60)
    assert rep.engine.order.index("q0") <= 3


def wfq_starvation_lag(c):
    a, b = c.tenant("a", weight=2.0), c.tenant("b", "BATCH")
    rep = c.replica("r0")
    router = c.router([a, b], [rep], max_inflight_per_replica=1)
    router._export_period = 0.0
    for i in range(10):
        router.submit("a", c.req(f"a{i}"))
        router.submit("b", c.req(f"b{i}"))
    c.drive(router, [rep], steps=80)
    assert router.max_lag_tokens <= 2 * 9


def admission_sheds_batch(c):
    gold, bulk = c.tenant("gold"), c.tenant("bulk", "BATCH")
    router = c.router([gold, bulk], [], backlog_cap_tokens=100.0)
    for i in range(6):
        assert router.submit("bulk", c.req(f"fill{i}"))
    assert not router.submit("bulk", c.req("shed"))
    assert router.submit("gold", c.req("vip"))
    for i in range(5):
        router.submit("gold", c.req(f"vip{i}"))
    assert not router.submit("gold", c.req("overcap"))


def session_affinity(c):
    t = c.tenant("t")
    r0, r1 = c.replica("r0"), c.replica("r1")
    router = c.router([t], [r0, r1])
    for i in range(4):
        router.submit("t", c.req(f"s{i}"), session="sticky")
    router.poll()
    router.submit("t", c.req("s4"), session="sticky")
    router.poll()
    assert router.affinity_hits == 4 and router.affinity_misses == 1


def prefix_affinity(c):
    t = c.tenant("t")
    r0, r1 = c.replica("r0"), c.replica("r1")
    router = c.router([t], [r0, r1], max_inflight_per_replica=8,
                      affinity_prefix_tokens=4)
    sys_prompt = np.asarray([7, 8, 9, 10], np.int32)
    for i in range(6):
        router.submit("t", c.w.E.Request(
            rid=f"p{i}", max_new_tokens=3, prompt=np.concatenate(
                [sys_prompt, np.full(i + 1, i + 20, np.int32)])))
    router.poll()
    assert len([r for r in (r0, r1) if r.engine.order]) == 1


def requeue_evacuated(c):
    t = c.tenant("t")
    r0, r1 = c.replica("r0"), c.replica("r1")
    router = c.router([t], [r0, r1])
    for i in range(6):
        router.submit("t", c.req(f"e{i}"), session=f"sess-{i}")
    router.poll()
    victim = r0 if r0.engine.order else r1
    victim.quiesced = True
    victim._evacuated = victim.engine.evacuate()
    assert router.requeue_evacuated(victim) == len(victim.engine.order)
    router.remove_replica(victim)
    c.drive(router, [r0, r1], steps=60)
    assert len(router.completions) == 6


def crash_redispatch(c):
    t = c.tenant("t")
    r0, r1 = c.replica("r0"), c.replica("r1")
    router = c.router([t], [r0, r1])
    for i in range(8):
        assert router.submit("t", c.req(f"x{i}"), session=f"s{i}")
    router.poll()
    assert r0.inflight
    r0.error = c.w.F.ReplicaFault("chaos: injected crash")
    router.poll()
    c.drive(router, [r1])
    assert len(router.completions) == 8 and router.take_dead() == [r0]


def late_completion_dropped(c):
    t = c.tenant("t")
    r0 = c.replica("r0")
    router = c.router([t], [r0])
    router.submit("t", c.req("a"))
    c.drive(router, [r0])
    now = c.clock()
    r0.outbox.append(c.w.E.Completion(
        rid="a", tokens=np.zeros(2, np.int32), t_submit=now,
        t_arrival=now, t_first_token=now, t_done=now))
    router.poll()
    assert router.duplicates_dropped == 1


def stall_watchdog(c):
    t = c.tenant("t")
    r0, r1 = c.replica("r0"), c.replica("r1")
    r0.engine.progress = 0
    r0.engine.step = lambda: True
    router = c.router([t], [r0, r1], stall_deadline_seconds=0.05)
    router.submit("t", c.req("w0", out=3), session="pin")
    router.poll()
    if "w0" not in r0.inflight:
        r0.inflight["w0"] = r1.inflight.pop("w0")
        r0.engine.queue.extend(r1.engine.queue)
        r1.engine.queue = []
    router.poll()
    assert not r0.dead
    time.sleep(0.06)
    r0.engine.progress += 1
    router.poll()
    assert not r0.dead
    time.sleep(0.06)
    router.poll()
    assert r0.dead and r0.death_reason == "stall"
    c.drive(router, [r1])
    assert "w0" in router.completions


def backoff_gates_requeue(c):
    t = c.tenant("t")
    r0, r1 = c.replica("r0"), c.replica("r1")
    router = c.router([t], [r0, r1], redispatch_backoff_base_seconds=10.0,
                      redispatch_backoff_cap_seconds=10.0,
                      max_inflight_per_replica=1)
    router.submit("t", c.req("a"), session="s")
    router.poll()
    (victim,) = [r for r in (r0, r1) if "a" in r.inflight]
    survivor = r1 if victim is r0 else r0
    victim.error = c.w.F.ReplicaFault("boom")
    router.poll()
    router.poll()
    assert "a" not in survivor.inflight
    c.clock.t += 11.0
    router.poll()
    assert "a" in survivor.inflight
    c.drive(router, [survivor])


def degradation_sheds_batch(c):
    gold, bulk = c.tenant("gold"), c.tenant("bulk", "BATCH")
    r0, r1 = c.replica("r0"), c.replica("r1")
    router = c.router([gold, bulk], [r0, r1], backlog_cap_tokens=100.0)
    router._export_period = 0.0
    router.mark_dead(r0, "crash")
    assert not router.submit("bulk", c.req("b", plen=20, out=20))
    assert router.submit("gold", c.req("g", plen=20, out=20))
    router.add_replica(c.replica("r2"))


def circuit_open_quarantines(c):
    t = c.tenant("t")
    r0 = c.replica("r0", claim_name="c0")
    router = c.router([t], [r0], breaker_deaths=1)
    router.submit("t", c.req("a"))
    router.poll()
    r0.error = c.w.F.ReplicaFault("boom")
    router.poll()
    rb = c.replica("r0b", claim_name="c0")
    router.add_replica(rb)
    c.clock.t += 1.0
    router.poll()
    fresh = c.replica("r1", claim_name="c1")
    router.add_replica(fresh)
    c.drive(router, [rb, fresh])
    assert not rb.engine.order and "a" in fresh.engine.order


def restart_post_journal(c):
    t = c.tenant("t")
    r0 = c.replica("r0")
    router1 = c.router([t], [r0])
    for i in range(3):
        router1.submit("t", c.req(f"j{i}"))
    router1.poll()
    snap = router1.journal.snapshot()
    r1 = c.replica("r1")
    router2 = c.router([t], [r1])
    assert router2.recover_from_journal(
        c.w.F.DispatchJournal.restore(snap)) == 3
    c.drive(router2, [r1])
    assert set(router2.completions) == {"j0", "j1", "j2"}


def restart_post_redispatch(c):
    t = c.tenant("t")
    r0, r1 = c.replica("r0"), c.replica("r1")
    router1 = c.router([t], [r0, r1])
    for i in range(6):
        router1.submit("t", c.req(f"k{i}"), session=f"s{i}")
    router1.poll()
    r1.engine.step()
    r1._drain_outbox()
    router1.poll()
    r0.error = c.w.F.ReplicaFault("boom")
    c.clock.t += 1.0
    router1.poll()
    snap = router1.journal.snapshot()
    r2 = c.replica("r2")
    router2 = c.router([t], [r2])
    router2.recover_from_journal(c.w.F.DispatchJournal.restore(snap))
    c.drive(router2, [r2])
    assert len(router2.completions) == 6 - len(router1.completions)


def restart_post_circuit_open(c):
    t = c.tenant("t")
    router1 = c.router([t], [], breaker_deaths=2)
    for i in range(2):
        rep = c.replica(f"r{i}", claim_name="bad-claim")
        router1.add_replica(rep)
        router1.submit("t", c.req(f"c{i}"), session=f"s{i}")
        c.clock.t += 0.1
        router1.poll()
        rep.error = c.w.F.ReplicaFault("loop")
        router1.poll()
    router2 = c.router([t], [], breaker_deaths=2)
    router2.breaker.restore(router1.breaker.snapshot())
    router2.recover_from_journal(
        c.w.F.DispatchJournal.restore(router1.journal.snapshot()))
    poisoned = c.replica("rX", claim_name="bad-claim")
    fresh = c.replica("rY", claim_name="good-claim")
    router2.add_replica(poisoned)
    router2.add_replica(fresh)
    c.drive(router2, [poisoned, fresh])
    assert set(router2.completions) == {"c0", "c1"}
    assert not poisoned.engine.order


def sampling_schedule(c):
    t = c.tenant("t")
    r0 = c.replica("r0")
    r0.engine.ec = types.SimpleNamespace(sample_seed=7)
    router = c.router([t], [r0])
    router.submit("t", c.req("a"))
    router.submit("t", c.req("b"))
    router.poll()
    assert [(r.sample_seed, r.sample_serial) for r in r0.engine.queue] == [
        (7, 1), (7, 2)]


ROUTER_CASES = [
    wfq_weight_ratio, wfq_late_quiet_arrival, wfq_starvation_lag,
    admission_sheds_batch, session_affinity, prefix_affinity,
    requeue_evacuated, crash_redispatch, late_completion_dropped,
    stall_watchdog, backoff_gates_requeue, degradation_sheds_batch,
    circuit_open_quarantines, restart_post_journal,
    restart_post_redispatch, restart_post_circuit_open, sampling_schedule,
]


@pytest.mark.parametrize("case", ROUTER_CASES, ids=lambda f: f.__name__)
def test_router_decisions_match_jax(case):
    """The case through JAX's Router and through the port's: the same
    dispatches, completions, tenant stats, journal, breaker, deaths,
    sheds and metrics calls."""
    obs = {}
    for name, w in WORLDS.items():
        c = Case(w)
        case(c)
        obs[name] = c.observe()
    assert obs["port"] == obs["jax"]


# --- the fault machinery ----------------------------------------------------


def test_redispatch_backoff_matches_jax():
    rng = np.random.default_rng(22)
    for _ in range(200):
        rid = f"r{int(rng.integers(0, 10_000))}"
        retries = int(rng.integers(0, 40))
        base, cap = float(rng.uniform(0.001, 1.0)), float(rng.uniform(0.1, 5))
        assert TF.redispatch_backoff(retries, base, cap, rid) == \
            JF.redispatch_backoff(retries, base, cap, rid)


def test_circuit_breaker_matches_jax():
    """The same death times on three keys: every record_death edge,
    is_open, open_keys and opened_total equal, through ageing out and a
    snapshot → restore."""
    rng = np.random.default_rng(5)
    events = np.cumsum(rng.exponential(2.0, 60))
    keys = rng.integers(0, 3, 60)
    out = {}
    for name, F in (("jax", JF), ("port", TF)):
        clock = FakeClock()
        br = F.CircuitBreaker(max_deaths=3, window_seconds=10.0, clock=clock)
        log = []
        for t, k in zip(events, keys):
            clock.t = 100.0 + float(t)
            opened = br.record_death(f"c{k}")
            log.append((opened, br.open_keys(), br.opened_total,
                        [br.is_open(f"c{j}") for j in range(3)]))
        clock.t += 11.0
        log.append(br.open_keys())
        restored = F.CircuitBreaker(max_deaths=3, window_seconds=10.0,
                                    clock=clock)
        restored.restore(br.snapshot())
        log.append((restored.snapshot(), restored.open_keys()))
        out[name] = log
    assert out["port"] == out["jax"]
    assert any(row[0] for row in out["port"][:-2])  # a circuit opened


def test_dispatch_journal_snapshot_restore_matches_jax():
    rng = np.random.default_rng(9)
    frs = []
    for i in range(6):
        frs.append(dict(
            rid=f"r{i}", tenant=f"t{i % 2}",
            prompt=rng.integers(1, 100, int(rng.integers(2, 9))),
            max_new=int(rng.integers(1, 9)), session=f"s{i}",
            cost=float(rng.integers(3, 20)),
            emitted=rng.integers(1, 100, int(rng.integers(0, 3))),
            t_submit=float(i), t_first=None if i % 3 else float(i) + 0.5,
            t_dispatch=float(10 - i), replicas=[f"rep{i % 2}"],
            sample_seed=13, sample_serial=i + 1, retries=i % 2,
            trace_ctx=None))
    out = {}
    for name, F in (("jax", JF), ("port", TF)):
        j = F.DispatchJournal()
        for fr in frs:
            j.record(types.SimpleNamespace(**fr), fr["replicas"][0])
        j.note_progress("r1", [5, 6, 7], 0.25)
        j.close("r2")
        j.close("r4")
        snap = j.snapshot()
        j2 = F.DispatchJournal.restore(snap)
        out[name] = (snap, j2.snapshot(),
                     [e.rid for e in j2.open_entries()],
                     [j2.is_closed(f"r{i}") for i in range(6)],
                     [j.sample_schedule(f"r{i}") for i in range(6)])
    assert out["port"] == out["jax"]


# --- the claim autoscaler on FakeCluster ------------------------------------


def _claims():
    return ResourceClient(FakeCluster(), RESOURCE_CLAIMS)


def _seed_claim(claims, name, ns="fabric"):
    claims.create({"metadata": {"name": name, "namespace": ns}})


def _allocate(claims, name, ns="fabric"):
    obj = claims.get(name, ns)
    obj.setdefault("status", {})["allocation"] = {"devices": {"results": [
        {"pool": "node-0", "device": "ss-1x1x1-0-0-0"}]}}
    claims.update_status(obj)


def _autoscaler(c, router, claims, **cfg):
    base = dict(min_replicas=1, max_replicas=3,
                target_tokens_per_replica=100.0, up_factor=1.0,
                down_factor=0.2, cooldown_seconds=5.0)
    base.update(cfg)
    return c.w.A.ClaimAutoscaler(
        router, claims,
        make_claim=lambda name: {"metadata": {"name": name},
                                 "spec": {"devices": {"requests": []}}},
        make_replica=lambda claim: c.replica(claim["metadata"]["name"]),
        config=c.w.A.AutoscalerConfig(**base), metrics=c.metrics,
        clock=c.clock)


def scale_up_waits_for_packer(c, claims):
    rep = c.replica("boot")
    router = c.router([c.tenant("t")], [rep], max_inflight_per_replica=16)
    a = _autoscaler(c, router, claims)
    for i in range(30):
        router.submit("t", c.req(f"x{i}"))
    a.tick()
    name = a._pending_claim["metadata"]["name"]
    c.clock.t += 1.0
    a.tick()
    assert len(router.replicas) == 1
    c.clock.t += 2.0
    _allocate(claims, name)
    a.tick()
    assert len(router.replicas) == 2 and a.reaction_s == [3.0]
    return a


def scale_down_drains_first(c, claims):
    r0, r1 = c.replica("c0", "c0"), c.replica("c1", "c1")
    for name in ("c0", "c1"):
        _seed_claim(claims, name)
    router = c.router([c.tenant("t")], [r0, r1])
    a = _autoscaler(c, router, claims)
    for i in range(6):
        router.submit("t", c.req(f"d{i}"), session=f"s{i}")
    router.poll()
    a.tick()
    victim = a._draining
    assert victim.quiesced and claims.try_get(victim.claim_name, "fabric")
    victim._evacuated = victim.engine.evacuate()
    victim._evac_done.set()
    c.clock.t += 0.5
    a.tick()
    assert claims.try_get(victim.claim_name, "fabric") is None
    assert victim.engine.closed
    c.drive(router, [r for r in (r0, r1) if r is not victim], steps=60)
    assert len(router.completions) == 6
    return a


def reversal_suppressed(c, claims):
    r0, r1 = c.replica("c0", "c0"), c.replica("c1", "c1")
    for name in ("c0", "c1"):
        _seed_claim(claims, name)
    router = c.router([c.tenant("t")], [r0, r1], max_inflight_per_replica=1)
    a = _autoscaler(c, router, claims, cooldown_seconds=10.0)
    for i in range(30):
        router.submit("t", c.req(f"f{i}"))
    a.tick()
    _allocate(claims, a._pending_claim["metadata"]["name"])
    a.tick()
    c.drive(router, router.replicas, steps=200)
    c.clock.t += 1.0
    a.tick()
    for _ in range(50):
        c.clock.t += 0.01
        a.tick()
    assert a.flaps == 1 and a.scaledowns == 0
    c.clock.t += 20.0
    a.tick()
    assert a._draining is not None
    return a


def _bound_claim(claims, rep_name="c0"):
    _seed_claim(claims, rep_name)
    _allocate(claims, rep_name)


def first_death_rebinds(c, claims):
    r0 = c.replica("c0", "c0")
    router = c.router([c.tenant("t")], [r0])
    _bound_claim(claims)
    a = _autoscaler(c, router, claims, target_tokens_per_replica=1e9)
    router.mark_dead(r0, "crash")
    a.tick()
    assert a.rebinds == 1 and router.replicas[0].claim_name == "c0"
    assert r0.engine.closed
    return a


def crash_loop_quarantines(c, claims):
    r0 = c.replica("c0", "c0")
    router = c.router([c.tenant("t")], [r0], breaker_deaths=2)
    _bound_claim(claims)
    a = _autoscaler(c, router, claims, target_tokens_per_replica=1e9)
    router.mark_dead(r0, "crash")
    a.tick()
    c.clock.t += 0.1
    router.mark_dead(router.replicas[0], "crash")
    a.tick()
    assert a.quarantined == 1 and claims.try_get("c0", "fabric") is None
    c.clock.t += 0.01
    a.tick()
    name = [e for e in a.events if e[0] == "replace-requested"][0][1]
    _allocate(claims, name)
    c.clock.t += 0.1
    a.tick()
    assert [r.claim_name for r in router.replicas] == [name]
    return a


def claim_vanished(c, claims):
    r0 = c.replica("c0", "c0")
    router = c.router([c.tenant("t")], [r0])
    router.submit("t", c.req("a"))
    router.poll()
    a = _autoscaler(c, router, claims, target_tokens_per_replica=1e9)
    a.tick()
    assert r0.dead and r0.death_reason == "claim-vanished"
    c.clock.t += 0.01
    a.tick()
    assert a.replaced == 1 and router.in_system() == 1
    return a


@pytest.mark.parametrize(
    "case", [scale_up_waits_for_packer, scale_down_drains_first,
             reversal_suppressed, first_death_rebinds,
             crash_loop_quarantines, claim_vanished],
    ids=lambda f: f.__name__)
def test_autoscaler_event_log_matches_jax(case):
    """Both autoscalers on a FakeCluster claim store: the same event
    log as (kind, claim name), the same counters, claims and router
    state."""
    obs = {}
    for name, w in WORLDS.items():
        c = Case(w)
        claims = _claims()
        a = case(c, claims)
        obs[name] = {
            "events": [(e[0], e[1]) for e in a.events],
            "event_info": [e[2:] for e in a.events],
            "counts": (a.scaleups, a.scaledowns, a.flaps, a.rebinds,
                       a.quarantined, a.replaced, a.reaction_s, a.drain_s),
            "claims": sorted(o["metadata"]["name"]
                             for o in claims.list("fabric")),
            **c.observe(),
        }
    assert obs["port"]["events"]
    assert obs["port"] == obs["jax"]


# --- standing alone, roles, spans, the launch counter -------------------------


NO_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "tpu_dra"):
    sys.modules[name] = None
import time
import numpy as np
from tpu_dra_torch.serving import INTERACTIVE, Replica, Router, TenantSpec
from tpu_dra_torch.workloads.engine import Completion, Request

class Engine:
    def __init__(self):
        self.queue, self.completed = [], {}
    def add_request(self, req):
        self.queue.append(req)
    @property
    def busy(self):
        return bool(self.queue)
    def step(self):
        r = self.queue.pop(0)
        self.completed[r.rid] = Completion(
            rid=r.rid, tokens=np.arange(r.max_new_tokens, dtype=np.int32),
            t_submit=0.0, t_arrival=0.0, t_first_token=1.0, t_done=2.0)
        return self.busy
    def close(self):
        pass

rep = Replica("r0", Engine())
router = Router([TenantSpec("t", INTERACTIVE)], [rep])
assert router.submit("t", Request(rid="a", prompt=np.ones(3, np.int32),
                                  max_new_tokens=4))
rep.start()
for _ in range(2000):
    router.poll()
    if "a" in router.completions:
        break
    time.sleep(0.005)
rep.stop(timeout=10.0)
assert router.completions["a"].tokens.tolist() == [0, 1, 2, 3]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "tpu_dra")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("served")
"""


def test_serving_tier_runs_without_jax():
    """A process where jax, flax and tpu_dra cannot be imported builds
    the port's Router over one replica thread and serves a request."""
    out = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "served"


class WedgedEngine:
    """Busy forever; ``step`` blocks until released — a replica thread
    ``stop()`` cannot join."""

    def __init__(self):
        self.release = threading.Event()
        self.completed, self.closed, self.busy = {}, False, True

    def add_request(self, req):
        pass

    def step(self):
        self.release.wait(30.0)
        return False

    def close(self):
        self.closed = True


def test_replica_thread_stop_timeout_and_injected_crash_match_jax():
    """Replica threads in both packages: a wedged engine's stop() times
    out, marks the replica dead and counts it; an injected crash ends
    the thread with a ReplicaFault and no re-raise."""
    out = {}
    for name, w in WORLDS.items():
        metrics = RecordingMetrics()
        rep = w.R.Replica("w0", WedgedEngine(), metrics=metrics)
        rep.start()
        time.sleep(0.05)
        joined = rep.stop(timeout=0.2)
        rep.engine.release.set()
        rep._thread.join(timeout=5.0)
        crashed = w.R.Replica("x0", StubEngine(w, FakeClock()))
        crashed.start()
        crashed.inject_fault("crash")
        deadline = time.monotonic() + 5.0
        while crashed.error is None and time.monotonic() < deadline:
            time.sleep(0.005)
        out[name] = (joined, rep.dead, rep.death_reason, rep.engine.closed,
                     metrics.calls, type(crashed.error).__name__,
                     crashed.stop(timeout=5.0))
    assert out["port"] == out["jax"]
    assert out["port"][:4] == (False, True, "stop-timeout", True)
    assert out["port"][5:] == ("ReplicaFault", True)


def test_single_owner_catches_second_control_thread():
    """Router.poll and ClaimAutoscaler.tick declare the same control
    role on the router: a tick from a second thread fails the check,
    one thread passes it."""
    c = Case(WORLDS["port"])
    router = c.router([c.tenant("t")], [c.replica("r0")])
    a = _autoscaler(c, router, _claims(), target_tokens_per_replica=1e9)
    tlockdep.install()
    try:
        router.poll()
        a.tick()
        assert tlockdep.check()["owners"]
        th = threading.Thread(target=a.tick, name="second-control")
        th.start()
        th.join()
        with pytest.raises(tlockdep.LockdepError, match="second-control"):
            tlockdep.check()
    finally:
        tlockdep.uninstall()
    router.poll()  # uninstalled: a no-op again
    assert tlockdep.report() == {"installed": False}


def test_request_spans_match_jax():
    """The spans a request leaves in each package's flight recorder:
    the same names, parents and attributes, dispatch to completion."""
    names = {}
    for label, w, tr in (("jax", WORLDS["jax"], jtrace),
                         ("port", WORLDS["port"], ttrace)):
        tr.reset_for_tests()
        prev = tr.set_enabled(True)
        try:
            c = Case(w)
            rep = c.replica("r0")
            router = c.router([c.tenant("t")], [rep])
            router.submit("t", c.req("a"))
            c.drive(router, [rep])
            spans = tr.RECORDER.spans()
        finally:
            tr.set_enabled(prev)
            tr.reset_for_tests()
        root = next(s for s in spans if s["name"] == "serving.request.queued")
        names[label] = sorted(
            (s["name"], s["parent"] == root["span"], s["attrs"],
             s["trace"] == root["trace"]) for s in spans)
    assert [n[0] for n in names["port"]] == [
        "serving.request.dispatch", "serving.request.first_token",
        "serving.request.prefill", "serving.request.queued"]
    assert names["port"] == names["jax"]


def test_launch_counter_is_exact_across_threads():
    """8 threads each count 10,000 launches of one kernel (and of a
    second name in the same call): the totals are exact."""
    before = dict(kernels.LAUNCHES)
    go = threading.Barrier(8)

    def hammer():
        go.wait()
        for _ in range(10_000):
            kernels.count("paged_decode_attention", "decode_mlp")

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name in ("paged_decode_attention", "decode_mlp"):
        assert kernels.LAUNCHES[name] - before[name] == 80_000
    kernels.reset_launches()
    assert not any(kernels.LAUNCHES.values())
