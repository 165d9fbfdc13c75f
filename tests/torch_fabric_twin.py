"""Helpers shared by the fabric bench twin tests
(tests/test_torch_fabricbench.py, tests/test_torch_faultbench.py): the
driver's real claim layer (a FakeCluster, its published fleet and the
scheduler's packer) as a claim layer for the port's Fabric; a recorder
that keeps every Fabric a bench builds and logs its claim traffic; and
the drills, each run by the JAX bench and by the port's on the same
seeded inputs."""

import collections
import threading
import time

import pytest

from tpu_dra.infra.metrics import Metrics as JaxMetrics
from tpu_dra.k8sclient import RESOURCE_CLAIMS, ResourceClient
from tpu_dra.k8sclient.fake import FakeCluster
from tpu_dra.scheduler.core import SchedulerCore
from tpu_dra.serving import disaggbench as JDB
from tpu_dra.serving import fabricbench as JFB
from tpu_dra.serving import faultbench as JFT
from tpu_dra.serving import router as JR
from tpu_dra.tools.fleetsim import spin_fleet
from tpu_dra_torch.serving import disaggbench as TDB
from tpu_dra_torch.serving import fabricbench as TFB
from tpu_dra_torch.serving import faultbench as TFT
from tpu_dra_torch.serving import router as TR

NODES = 8
TIMEOUT = 120.0
# The crash drills' post-kill TTFT bound, widened as the bench's
# FAULT_RECOVERY_BOUND_MS allows on a slow machine: a timing gate.
RECOVERY_BOUND_MS = 1000.0 * TIMEOUT
# Runs of one drill until one is clean (below). Under the suite's six
# loaded workers three unclean runs in a row were seen (the JAX bench's
# crash drill: 6 stall deaths for 2 injected faults, then 4, then 3).
ATTEMPTS = 6
FABRIC_SEED = 20260804
FAULT_SEED = 20260807
DISAGG_SEED = 20260807


class PackerLayer:
    """The claim layer the JAX Fabric builds for itself
    (tpu_dra/serving/fabricbench.py ``Fabric.__init__``): a FakeCluster,
    ``nodes`` published nodes, the scheduler's packer, and a claim
    client over the cluster."""

    def __init__(self, nodes: int):
        self.metrics = JaxMetrics()
        self.cluster = FakeCluster()
        self.agents = spin_fleet(self.cluster, nodes, self.metrics)
        self.core = SchedulerCore(self.cluster, retry_unschedulable_after=0.5,
                                  metrics=self.metrics)
        self.claims = ResourceClient(self.cluster, RESOURCE_CLAIMS)

    def start(self) -> None:
        self.core.start()
        deadline = time.monotonic() + 60
        for inf in (self.core.claim_informer, self.core.slice_informer,
                    self.core.class_informer):
            if not inf.wait_for_sync(timeout=deadline - time.monotonic()):
                raise RuntimeError("scheduler informer sync timed out")

    def stop(self) -> None:
        self.core.stop()


class LoggedClaims:
    """A claim client that logs ``(op, name, t)`` for every create and
    delete it passes on."""

    def __init__(self, inner):
        self.inner = inner
        self.log = []
        self._lock = threading.Lock()

    def create(self, obj):
        out = self.inner.create(obj)
        with self._lock:
            self.log.append(("created", obj["metadata"]["name"],
                             time.monotonic()))
        return out

    def delete(self, name, namespace=None):
        self.inner.delete(name, namespace)
        with self._lock:
            self.log.append(("deleted", name, time.monotonic()))

    def __getattr__(self, attr):
        return getattr(self.inner, attr)


def record(monkeypatch, module, attr: str, replica_cls) -> tuple:
    """Replace ``module.attr`` (a Fabric class) by a subclass that keeps
    every instance in the returned list and logs its claim traffic
    (``fab.claims``, the client the autoscaler calls), and log the
    faults injected into ``replica_cls`` replicas as (replica name,
    kind). Returns (the list, the fault log)."""
    built, injected = [], []
    base = getattr(module, attr)
    inject = replica_cls.inject_fault

    class Recorded(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.claims = self.autoscaler.claims = LoggedClaims(self.claims)
            built.append(self)

    def inject_counted(rep, kind):
        injected.append((rep.name, kind))
        inject(rep, kind)

    monkeypatch.setattr(module, attr, Recorded)
    monkeypatch.setattr(replica_cls, "inject_fault", inject_counted)
    return built, injected


def snapshot(fab) -> dict:
    """What a drill left behind in one Fabric: the completions' tokens,
    the autoscaler's events as (kind, claim name), the claim log as
    (op, name), the open breaker keys, the deaths by reason and by
    replica, and the duplicates the Router dropped."""
    return {
        "tokens": {rid: [int(t) for t in c.tokens]
                   for rid, c in fab.router.completions.items()},
        "events": [(e[0], e[1]) for e in fab.autoscaler.events],
        "claims": [(op, name) for op, name, _ in fab.claims.log],
        "open_breakers": sorted(fab.router.breaker.open_keys()),
        "deaths": sorted(r for _, r, _ in fab.router.death_log),
        "dead_replicas": sorted(n for n, _, _ in fab.router.death_log),
        "duplicates_dropped": fab.router.duplicates_dropped,
    }


# The snapshot fields whose replica identity thread timing sets, by
# drill. A crash drill's injector kills the ``replica_index``-th of the
# live replicas that hold in-flight sequences at the moment the event
# fires, so which replica (and which claim a rebind names) is hit
# depends on how far each replica thread has got; two runs of the JAX
# bench on one machine differ there under load (rebinds of
# fabric-replica-0001 twice in one run, of 0003 then 0002 in another).
# Those fields are compared by what the drill fixes: the events' kinds
# as a multiset, each rebind naming a replica that died in the same
# run, and as many deaths.
TIMED_FIELDS = {
    "crash_greedy": ("events", "dead_replicas"),
    "crash_sampled": ("events", "dead_replicas"),
}


def _kinds(snap: dict) -> collections.Counter:
    return collections.Counter(kind for kind, _ in snap["events"])


def _rebinds_name_the_dead(snap: dict) -> bool:
    named = sorted(name for kind, name in snap["events"] if kind == "rebind")
    return named == snap["dead_replicas"]


def assert_snapshots_match(got: list, want: list, timed=()) -> None:
    """Hold the port's snapshots to JAX's, Fabric by Fabric and field
    by field, naming the field that differs and showing both values.
    Fields in ``timed`` (TIMED_FIELDS) are held to what the drill fixes
    instead of to JAX's replica names."""
    assert len(got) == len(want), (
        f"Fabrics built: port {len(got)}, jax {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for key in w:
            if key not in timed:
                assert g[key] == w[key], (
                    f"Fabric {i}, {key}: port {g[key]!r} != jax {w[key]!r}")
        if "events" in timed:
            assert _kinds(g) == _kinds(w), (
                f"Fabric {i}, event kinds: port {_kinds(g)} != jax "
                f"{_kinds(w)} (events: port {g['events']!r}, jax "
                f"{w['events']!r})")
        if "dead_replicas" in timed:
            for side, snap in (("port", g), ("jax", w)):
                assert _rebinds_name_the_dead(snap), (
                    f"Fabric {i}, {side}: rebinds {snap['events']!r} do "
                    f"not name the replicas that died "
                    f"{snap['dead_replicas']!r}")
            assert len(g["dead_replicas"]) == len(w["dead_replicas"]), (
                f"Fabric {i}, dead replicas: port {g['dead_replicas']!r}, "
                f"jax {w['dead_replicas']!r}")


def drain_before_delete(fab) -> bool:
    """Every claim a scale-down retired was deleted after its drain
    began, with the engine found empty at the delete."""
    begun = {e[1]: e[2] for e in fab.autoscaler.events
             if e[0] == "down-draining"}
    done = {e[1]: e[3] for e in fab.autoscaler.events
            if e[0] == "down-complete"}
    deleted = {name: t for op, name, t in fab.claims.log if op == "deleted"}
    return all(name in deleted and begun[name] <= deleted[name]
               and info["engine_empty_at_delete"]
               for name, info in done.items())


# Each drill: which Fabric class its module builds, and the call, with
# (config, params) and, on the port, the device and the claim layer.
DRILLS = {
    "autoscale": (
        "fabricbench", "Fabric",
        lambda m, c, p, **kw: m.run_autoscale_drill(
            c, p, NODES, FABRIC_SEED, TIMEOUT, **kw)),
    "crash_greedy": (
        "faultbench", "Fabric",
        lambda m, c, p, **kw: m.run_crash_drill(
            c, p, NODES, 36, FAULT_SEED, TIMEOUT, temperature=0.0,
            recovery_bound_ms=RECOVERY_BOUND_MS, **kw)),
    "crash_sampled": (
        "faultbench", "Fabric",
        lambda m, c, p, **kw: m.run_crash_drill(
            c, p, NODES, 36, FAULT_SEED + 1, TIMEOUT, temperature=0.8,
            recovery_bound_ms=RECOVERY_BOUND_MS, **kw)),
    "crash_loop": (
        "faultbench", "Fabric",
        lambda m, c, p, **kw: m.run_crash_loop_drill(
            c, p, NODES, FAULT_SEED, TIMEOUT, **kw)),
    "disagg_parity": (
        "disaggbench", "DisaggFabric",
        lambda m, c, p, **kw: m.run_parity(
            c, p, NODES, 4, DISAGG_SEED, TIMEOUT, **kw)),
    "disagg_kill": (
        "disaggbench", "DisaggFabric",
        lambda m, c, p, **kw: m.run_kill_drill(
            c, p, NODES, 4, DISAGG_SEED, TIMEOUT, **kw)),
}
JAX_MODULES = {"fabricbench": JFB, "faultbench": JFT, "disaggbench": JDB}
PORT_MODULES = {"fabricbench": TFB, "faultbench": TFT, "disaggbench": TDB}


def _deaths(built: list) -> list:
    """Every death the Fabrics' Routers classified, as (replica name,
    reason), sorted."""
    return sorted((n, r) for f in built for n, r, _ in f.router.death_log)


def run_drill(name: str, port: bool, config, params,
              layer: str = "packer") -> tuple:
    """Run drill ``name`` through the JAX bench or the port's (on the
    CPU, over ``layer``: "packer" for :class:`PackerLayer`, "store" for
    the default ClaimStore) until a run is clean: its Routers' deaths
    are the faults the drill injected, replica by replica and kind by
    kind ("crash" a crash, "stall" a stall). On a loaded machine a
    healthy replica whose step outlasts the drill's stall watchdog (2.5
    s in the crash drills) dies a death nothing injected, and a crashed
    replica's watchdog may fire before its thread trips the crash flag
    (the race the crash drill's comment names), so the death reads
    "stall". Such a run is timing, not the drill: it changes the events
    the twins compare, and it can fail a gate of the drill itself (both
    detection paths seen; every sequence completed). Only an unclean
    run is retried; a clean run's failing gate raises at once. Returns
    (report, [every Fabric the clean run built])."""
    mod_name, attr, call = DRILLS[name]
    mod = (PORT_MODULES if port else JAX_MODULES)[mod_name]
    replica_cls = TR.Replica if port else JR.Replica
    runs = []
    for _ in range(ATTEMPTS):
        error = None
        with pytest.MonkeyPatch.context() as mp:
            built, injected = record(mp, mod, attr, replica_cls)
            try:
                if port:
                    kw = {"device": "cpu"}
                    if layer == "packer":
                        kw["make_claim_layer"] = PackerLayer
                    report = call(mod, config, params, **kw)
                else:
                    report = call(mod, config, params)
            except (AssertionError, RuntimeError) as e:
                error = e
        deaths = _deaths(built)
        runs.append((deaths, sorted(injected), repr(error)[:300]))
        if deaths == sorted(injected):
            if error is not None:
                raise error
            return report, built
    raise AssertionError(
        f"{name}: no clean run in {ATTEMPTS} (deaths, faults injected, "
        f"error): {runs}")
