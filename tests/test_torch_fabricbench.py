"""The port's fabric benches (tpu_dra_torch/serving/{fabricbench,
disaggbench,repack,claims}.py) and the helpers they call
(tpu_dra_torch/infra/{metrics,chaos}.py) held to the JAX package's on
the CPU.

- Traces and claims: ``make_fabric_trace`` on the smoke's tenant mix,
  ``faultbench._make_trace`` and ``disaggbench.make_disagg_trace`` give
  the same arrivals, tenants, prompts and output lengths for three
  seeds; ``make_claim`` writes JAX's claim.
- Chaos: the kill schedules, the validation errors, seeded generation
  and the engine's firing order under a fake clock are JAX's.
- Metrics: the registry renders and reads back as JAX's.
- Drills over the real packer and over the default ClaimStore: the
  autoscale drill and the disaggregated parity and kill drills, each
  held to the JAX bench's own run of the same drill (completions token
  for token, autoscaler events, claims created and deleted, deaths,
  open breakers); tests/test_torch_faultbench.py does the same for the
  fault drills.
- The repack adapter under the driver's real ``Repacker``: one
  mid-generation migration, ``abort`` and a key it has never seen.
- The benches run where JAX is missing.

TINY_LLAMA at fp32 with the flax weights converted in-process
(tests/torch_twin.py).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_fabric_twin import (  # noqa: E402
    TIMED_FIELDS,
    PackerLayer,
    assert_snapshots_match,
    drain_before_delete,
    run_drill,
    snapshot,
)
from torch_twin import EC, JCFG, TCFG, make_params  # noqa: E402

from tpu_dra.infra import chaos as JC  # noqa: E402
from tpu_dra.infra.crashpoint import CRASH_POINTS  # noqa: E402
from tpu_dra.infra.metrics import Metrics as JaxMetrics  # noqa: E402
from tpu_dra.scheduler import fleet  # noqa: E402
from tpu_dra.scheduler.repacker import Repacker, RepackerConfig  # noqa: E402
from tpu_dra.serving import disaggbench as JDB  # noqa: E402
from tpu_dra.serving import fabricbench as JFB  # noqa: E402
from tpu_dra.serving import faultbench as JFT  # noqa: E402
from tpu_dra.serving import router as JR  # noqa: E402
from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra_torch.infra import chaos as TC  # noqa: E402
from tpu_dra_torch.infra.metrics import Metrics  # noqa: E402
from tpu_dra_torch.serving import claims as TCL  # noqa: E402
from tpu_dra_torch.serving import disaggbench as TDB  # noqa: E402
from tpu_dra_torch.serving import fabricbench as TFB  # noqa: E402
from tpu_dra_torch.serving import faultbench as TFT  # noqa: E402
from tpu_dra_torch.serving import router as TR  # noqa: E402
from tpu_dra_torch.serving.repack import FabricRepackAdapter  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SEEDS = (20260804, 7, 123)


@pytest.fixture(scope="module")
def params():
    return make_params()


def _trace_rows(trace):
    return [(t, tenant, r.rid, r.prompt.tolist(), r.max_new_tokens,
             r.sample_seed, r.sample_serial, session)
            for t, tenant, r, session in trace]


# --- traces and claims ------------------------------------------------------


def _jax_smoke_mix(requests, rate):
    """The tenant mix of tpu_dra/serving/fabricbench.py ``run``."""
    return [
        JFB.TenantTraffic(
            JR.TenantSpec("gold", JR.INTERACTIVE, weight=4.0),
            requests=int(requests * 0.27), rate_rps=rate * 0.25,
            prompt_lens=[20, 24, 28], output_lens=[2, 4, 6],
            sessions=50, shared_prefix_len=16,
        ),
        JFB.TenantTraffic(
            JR.TenantSpec("silver", JR.STANDARD, weight=2.0),
            requests=int(requests * 0.33), rate_rps=rate * 0.31,
            prompt_lens=[4, 8, 12], output_lens=[2, 4, 6], sessions=50,
        ),
        JFB.TenantTraffic(
            JR.TenantSpec("bulk", JR.BATCH, weight=1.0),
            requests=requests - int(requests * 0.27)
            - int(requests * 0.33),
            rate_rps=rate * 0.44,
            prompt_lens=[4, 8, 12], output_lens=[2, 4, 6],
        ),
    ]


@pytest.mark.parametrize("seed", SEEDS)
def test_fabric_trace_matches_jax(seed):
    mine, theirs = TFB.smoke_mix(60, 200.0), _jax_smoke_mix(60, 200.0)
    for a, b in zip(mine, theirs):
        assert (a.spec.name, a.spec.slo.name, a.spec.weight) == (
            b.spec.name, b.spec.slo.name, b.spec.weight)
        assert dataclasses.astuple(a)[1:] == dataclasses.astuple(b)[1:]
    got = TFB.make_fabric_trace(seed, mine, JCFG.vocab_size)
    want = JFB.make_fabric_trace(seed, theirs, JCFG.vocab_size)
    assert len(got) == 60 and _trace_rows(got) == _trace_rows(want)


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_and_disagg_traces_match_jax(seed):
    assert _trace_rows(TFT._make_trace(seed, 36, 256, 1.5)) == _trace_rows(
        JFT._make_trace(seed, 36, 256, 1.5))
    for pin in (False, True):
        kw = dict(requests=12, rate_rps=60.0, vocab=256,
                  prompt_lens=[24, 32, 48], output_lens=[8, 12, 16],
                  pin_sampling=pin, sample_seed=seed)
        assert _trace_rows(TDB.make_disagg_trace(seed, **kw)) == (
            _trace_rows(JDB.make_disagg_trace(seed, **kw)))


@pytest.mark.parametrize("args", [
    (0, "1x1x1", None, "allocbench"), (7, "2x2x1", "v5p", "fabric"),
    (12345, "2x1x1", "v5e", "allocbench"),
])
def test_make_claim_matches_jax(args):
    i, shape, gen, ns = args
    assert TCL.make_claim(i, shape, gen, namespace=ns) == fleet.make_claim(
        i, shape, gen, namespace=ns)
    assert TCL.SUBSLICE_CLASS_NAME == fleet.SUBSLICE_CLASS["metadata"]["name"]
    assert TCL.DRIVER == fleet.DRIVER


def test_claim_store_allocates_at_once_and_logs():
    store = TCL.ClaimStore(device="cuda:0")
    assert store.claims is store
    store.start()
    claim = TCL.make_claim(0, "1x1x1")
    claim["metadata"] = {"name": "a", "namespace": "fabric"}
    store.create(claim)
    store.create({"metadata": {"name": "b"}})  # the default namespace
    got = store.try_get("a", "fabric")
    assert got["status"]["allocation"]["devices"]["results"] == [
        {"pool": "card-0", "device": "cuda:0"}]
    got["metadata"]["name"] = "mutated"  # a copy, as from an API server
    assert store.try_get("a", "fabric")["metadata"]["name"] == "a"
    assert store.try_get("b")["metadata"]["name"] == "b"
    assert store.try_get("a", "elsewhere") is None
    with pytest.raises(ValueError):
        store.create({"metadata": {"name": "a", "namespace": "fabric"}})
    assert [c["metadata"]["name"] for c in store.list()] == ["a", "b"]
    store.delete("a", "fabric")
    with pytest.raises(KeyError):
        store.delete("a", "fabric")
    assert store.try_get("a", "fabric") is None
    assert store.log == [("created", "a"), ("created", "b"),
                         ("deleted", "a")]
    assert store.deleted == ["a"]
    store.stop()


# --- chaos ------------------------------------------------------------------


def test_chaos_tables_match_jax():
    assert TC.CRASH_POINTS == frozenset(CRASH_POINTS)
    assert TC.FAULT_KINDS == JC.FAULT_KINDS
    assert TC.SERVING_FAULT_KINDS == JC.SERVING_FAULT_KINDS
    assert TC.CONTROL_PLANE_FAULT_KINDS == JC.CONTROL_PLANE_FAULT_KINDS
    assert set(TC._REQUIRED_PARAMS) == set(JC._REQUIRED_PARAMS)
    assert (TC.CHAOS_SEED_ENV, TC.CHAOS_SCHEDULE_ENV,
            TC.CHAOS_TIME_SCALE_ENV) == (
        JC.CHAOS_SEED_ENV, JC.CHAOS_SCHEDULE_ENV, JC.CHAOS_TIME_SCALE_ENV)


@pytest.mark.parametrize("seed", SEEDS)
def test_kill_schedule_matches_jax(seed):
    got, want = TFT._kill_schedule(seed), JFT._kill_schedule(seed)
    assert got.to_dict() == want.to_dict()
    again = TC.FaultSchedule.from_dict(want.to_dict())
    assert [(e.at, e.kind, e.params) for e in again] == [
        (e.at, e.kind, e.params) for e in want]


BAD_SCHEDULES = [
    [],
    {"version": 2, "events": []},
    {"events": [{"at": -1, "kind": "chip_down", "chip_index": 0}]},
    {"events": [{"at": 0.1, "kind": "meteor"}, "not an object"]},
    {"events": [{"at": 0.1, "kind": "chip_down"}]},
    {"events": [{"at": 0.5, "kind": "chip_up", "chip_index": 1},
                {"at": 0.2, "kind": "chip_down", "chip_index": 1},
                {"at": 0.3, "kind": "chip_down", "chip_index": 1}]},
    {"events": [{"at": 0.1, "kind": "crash", "point": "no.such.point"},
                {"at": 0.2, "kind": "apiserver_throttle", "count": 0},
                {"at": 0.3, "kind": "replica_crash", "replica_index": True},
                {"at": 0.4, "kind": "replica_crash_loop",
                 "replica_index": 0, "count": 1},
                {"at": 0.5, "kind": "api_latency", "delay": 0.1},
                {"at": 0.6, "kind": "apiserver_restart", "outage": -1},
                {"at": 0.7, "kind": "apiserver_brownout",
                 "concurrency": 0, "duration": 1.0}]},
]


def test_validate_schedule_matches_jax():
    for bad in BAD_SCHEDULES:
        want = JC.validate_schedule(bad)
        assert want, bad
        assert TC.validate_schedule(bad) == want
        with pytest.raises(ValueError):
            TC.FaultSchedule.from_dict(bad)


@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_schedules_match_jax(seed):
    for kw in ({}, {"kinds": sorted(JC.SERVING_FAULT_KINDS), "replicas": 3},
               {"kinds": sorted(JC.CONTROL_PLANE_FAULT_KINDS
                                | {JC.CRASH, JC.CHIP_DOWN}),
                "duration": 3.0, "chips": 2}):
        assert TC.FaultSchedule.from_seed(seed, **kw).to_dict() == (
            JC.FaultSchedule.from_seed(seed, **kw).to_dict())


def test_schedule_from_env_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv(JC.CHAOS_SEED_ENV, "42")
    monkeypatch.delenv(JC.CHAOS_SCHEDULE_ENV, raising=False)
    monkeypatch.setenv(JC.CHAOS_TIME_SCALE_ENV, "0.25")
    assert TC.schedule_from_env(replicas=2).to_dict() == (
        JC.schedule_from_env(replicas=2).to_dict())
    assert TC.time_scale_from_env() == JC.time_scale_from_env() == 0.25
    path = tmp_path / "drill.chaos.json"
    path.write_text(json.dumps(JFT._kill_schedule(9).to_dict()))
    monkeypatch.setenv(JC.CHAOS_SCHEDULE_ENV, str(path))
    assert TC.schedule_from_env().to_dict() == (
        JC.schedule_from_env().to_dict())


def _fire_under_fake_clock(mod, schedule_dict):
    """Step the schedule on a fake clock as faultbench's chaos tick does;
    every kind but chip_up has an injector (one raises). Returns the
    (clock, kind, params) fired and the engine's counters."""
    eng = mod.ChaosEngine(mod.FaultSchedule.from_dict(schedule_dict))
    fired = []
    for kind in sorted(mod.FAULT_KINDS - {mod.CHIP_UP}):
        def inject(ev, kind=kind):
            if kind == mod.WATCH_DROP:
                raise RuntimeError("injector failed")
            fired.append((clock[0], ev.kind, dict(ev.params)))
        eng.register(kind, inject)
    with pytest.raises(ValueError):
        eng.register("meteor", lambda ev: None)
    clock = [0.0]
    while eng.remaining:
        nxt = eng.schedule.events[len(eng.schedule.events) - eng.remaining]
        if nxt.at > clock[0]:
            clock[0] = round(clock[0] + 0.05, 2)
            continue
        eng.step()
    assert eng.step() is None
    return fired, eng.fired, eng.skipped, eng.errors


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_engine_fires_as_jax(seed):
    sched = JC.FaultSchedule.from_seed(
        seed, duration=4.0, events_per_second=4.0,
        kinds=sorted(JC.FAULT_KINDS - {JC.CHIP_UP}), replicas=3).to_dict()
    got = _fire_under_fake_clock(TC, sched)
    assert got == _fire_under_fake_clock(JC, sched)
    assert got[0] and (got[2] or got[3])


# --- metrics ----------------------------------------------------------------


def _exercise(m):
    m.inc("fabric_requests_total", labels={"tenant": "gold"})
    m.inc("fabric_requests_total", 2.0, labels={"tenant": "bulk"})
    m.set_gauge("fabric_backlog_tokens", 17.0)
    m.set_gauge("fabric_tenant_vtime_lag", 3.0, labels={"tenant": 'a"b\\'})
    for i in range(7):
        m.observe("fabric_ttft_seconds", 0.01 * i, labels={"slo": "batch"})
    for i in range(5):  # past the series cap of 3
        m.set_gauge("capped", float(i), labels={"claim": f"c{i}"})
    m.remove_gauge("capped", labels={"claim": "c0"})
    m.set_gauge("hist", 1.0, labels={"claim": "x", "le": "1"})
    m.set_gauge("hist", 2.0, labels={"claim": "x", "le": "2"})
    m.remove_gauges("hist", {"claim": "x"})
    calls = []
    m.register_collector(lambda: calls.append(1))
    m.register_collector(lambda: 1 / 0)  # a scrape never fails
    text = m.render()
    return (text, len(calls),
            m.get_counter("fabric_requests_total", {"tenant": "bulk"}),
            m.get_gauge("fabric_backlog_tokens"), m.get_gauge("nope"),
            m.quantile("fabric_ttft_seconds", 0.99, {"slo": "batch"}),
            m.quantile("fabric_ttft_seconds", 0.5, {"slo": "none"}))


def test_metrics_registry_matches_jax():
    got = _exercise(Metrics(prefix="tpu_dra", series_cap=3))
    assert got == _exercise(JaxMetrics(prefix="tpu_dra", series_cap=3))
    assert "tpu_dra_metrics_series_capped_total" in got[0]


# --- drills over the real packer and over the ClaimStore ---------------------

DRILLS = ("autoscale", "disagg_parity", "disagg_kill")
_JAX_RUNS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # Tiny matmuls gain nothing from the intra-op pool; one thread keeps
    # these replica-thread drills from crowding the suite's other
    # workers.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _allow_timing_gaps(monkeypatch):
    # The benches' timing bypasses, as their smokes allow on slow
    # machines; every gate that is not about timing stays on.
    for knob in ("FABRIC_ALLOW_GAP", "DISAGG_ALLOW_GAP"):
        monkeypatch.setenv(knob, "1")


def _jax_run(name, params):
    if name not in _JAX_RUNS:
        report, built = run_drill(name, False, JCFG, params[0])
        assert all(drain_before_delete(f) for f in built)
        _JAX_RUNS[name] = (report, [snapshot(f) for f in built])
    return _JAX_RUNS[name]


@pytest.mark.parametrize("layer", ["packer", "store"])
@pytest.mark.parametrize("name", DRILLS)
def test_fabric_drill_matches_jax(params, name, layer):
    want_report, want = _jax_run(name, params)
    report, built = run_drill(name, True, TCFG, params[1], layer=layer)
    got = [snapshot(f) for f in built]
    assert all(drain_before_delete(f) for f in built)
    assert_snapshots_match(got, want, TIMED_FIELDS.get(name, ()))
    if name == "autoscale":
        for key in ("scaleups", "scaledowns", "evacuated_requeued",
                    "flaps"):
            assert report[key] == want_report[key], key
        assert report["scaledowns"] == 1
        want_devices = (want_report["placed_devices"] if layer == "packer"
                        else ["cpu"])
        assert report["placed_devices"] == want_devices
    elif name == "disagg_parity":
        assert report == want_report
    else:
        assert report["killed"] and want_report["killed"]
        # How many sequences the kill catches in flight on the decode
        # replica is set by thread timing: the JAX bench's own runs
        # recovered 1 on an idle machine and 4 under the suite's load.
        # The drill fixes that at least one was (it kills the decode
        # replica only while it holds in-flight work) and that every
        # sequence completed.
        assert report["completed"] == want_report["completed"]
        for r in (report, want_report):
            assert 1 <= r["journal_recovered"] <= r["completed"], r


# --- the repack adapter under the driver's Repacker -------------------------


def _reference(jparams, ec, reqs) -> dict:
    eng = JE.Engine(JCFG, jparams, JE.EngineConfig(**ec))
    done = eng.run([JE.Request(rid=r.rid, prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens)
                    for r in reqs])
    return {rid: c.tokens.tolist() for rid, c in done.items()}


def _wait(cond, fab, tick=None, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        if tick is not None:
            tick()
        fab.router.poll()
        time.sleep(0.005)


def test_repack_adapter_migrates_under_the_real_repacker(params):
    """tpu_dra/serving/repackbench.py's serving drill with port replicas:
    five one-chip replicas packed four and one on two nodes, three of
    the four retired, a 2x2x1 claim stranded; the JAX Repacker moves a
    resident through the port's adapter while a trace is in flight."""
    jparams, tparams = params
    ec = dict(page_size=8, max_slots=4, max_pages_per_seq=4, scan_chunk=4,
              prefill_chunk=16)
    gold = TR.TenantSpec("gold", TR.INTERACTIVE)
    layer = PackerLayer(2)
    fab = TFB.Fabric(
        2, [gold], TCFG, tparams, TFB.EngineConfig(**ec),
        TR.RouterConfig(backlog_cap_tokens=1e9, max_inflight_per_replica=8),
        TFB.AutoscalerConfig(min_replicas=5, max_replicas=5),
        claim_layer=layer, device="cpu")
    try:
        fab.scale_to(5)
        by_node = {}
        for rep in fab.router.replicas:
            pool = rep.claim["status"]["allocation"]["devices"]["results"][
                0]["pool"]
            by_node.setdefault(pool, []).append(rep)
        full = max(by_node, key=lambda n: len(by_node[n]))
        assert sorted(len(v) for v in by_node.values()) == [1, 4]
        for rep in by_node[full][:3]:
            fab.router.remove_replica(rep)
            rep.stop()
            fab.claims.delete(rep.claim_name, TFB.NS)
        big = TCL.make_claim(0, "2x2x1")
        big["metadata"] = {"name": "big-0000", "namespace": TFB.NS}
        fab.claims.create(big)
        adapter = FabricRepackAdapter(fab.router, fab._make_replica)
        repacker = Repacker(
            layer.cluster,
            RepackerConfig(poll_period=0.2, frag_threshold=0.05,
                           min_disruption_interval_seconds=2.0,
                           drain_timeout_seconds=20.0),
            index=layer.core.index, serving=adapter,
            utilization=adapter.utilization, metrics=JaxMetrics())
        tt = TFB.TenantTraffic(gold, requests=24, rate_rps=400.0,
                               prompt_lens=[4, 8], output_lens=[8, 12])
        trace = TFB.make_fabric_trace(11, [tt], TCFG.vocab_size)
        fab.drive(trace, timeout=120.0, extra_tick=repacker.tick)
        _wait(lambda: repacker.migrations >= 1 and not repacker._active,
              fab, tick=repacker.tick)
        assert adapter.rebinds >= 1 and adapter.aborts == 0
        assert not adapter._draining
        assert all(not r.migrating and not r.quiesced
                   for r in fab.router.replicas)
        done = fab.router.completions
        reqs = [r for _, _, r, _ in trace]
        assert set(done) == {r.rid for r in reqs}
        assert fab.router.duplicates_dropped == 0
        moved = [rid for rid, c in done.items() if len(c.replicas) > 1]
        assert moved, "the migration moved no sequence mid-generation"
        ref = _reference(jparams, ec, reqs)
        assert {rid: c.tokens.tolist() for rid, c in done.items()} == ref
        util = adapter.utilization()
        assert set(util) == {f"{TFB.NS}/{r.claim_name}"
                             for r in fab.router.replicas}
        assert all(0.0 <= v <= 1.0 for v in util.values())
    finally:
        fab.stop()


def test_repack_adapter_abort_and_unknown_key(params):
    jparams, tparams = params
    ec = dict(EC, max_slots=4, max_pages_per_seq=12)
    fab = TFB.Fabric(
        1, [TR.TenantSpec("t", TR.INTERACTIVE)], TCFG, tparams,
        TFB.EngineConfig(**ec),
        TR.RouterConfig(backlog_cap_tokens=1e9, max_inflight_per_replica=4),
        TFB.AutoscalerConfig(min_replicas=2, max_replicas=2),
        device="cpu")
    adapter = FabricRepackAdapter(fab.router, fab._make_replica)
    try:
        fab.scale_to(2)
        # A key the adapter has never seen: placement-only, no effect.
        ghost = f"{TFB.NS}/ghost"
        adapter.begin_drain(ghost)
        assert adapter.drain_done(ghost)
        assert adapter.finish_drain(ghost) == 0
        adapter.abort(ghost)
        assert adapter.aborts == 0 and not adapter._draining
        rng = np.random.default_rng(5)
        reqs = [TFB.Request(rid=f"a{i}",
                            prompt=rng.integers(1, 256, 6).astype(np.int32),
                            max_new_tokens=20) for i in range(6)]
        for i, r in enumerate(reqs):
            assert fab.router.submit("t", r, session=f"s{i}")
        _wait(lambda: any(r.inflight and any(
            s is not None and s.out for s in r.engine._slots)
            for r in fab.router.replicas), fab)
        rep = next(r for r in fab.router.replicas if r.inflight)
        key = f"{TFB.NS}/{rep.claim_name}"
        adapter.begin_drain(key)
        assert rep.migrating and rep.quiesced
        adapter.abort(key)  # waits out the evacuation, then requeues
        assert adapter.aborts == 1 and not adapter._draining
        assert not rep.migrating and not rep.quiesced
        assert rep in fab.router.live_replicas()
        _wait(lambda: not fab.router.busy, fab)
        done = fab.router.completions
        assert set(done) == {r.rid for r in reqs}
        assert fab.router.duplicates_dropped == 0
        assert {rid: c.tokens.tolist() for rid, c in done.items()} == (
            _reference(jparams, ec, reqs))
        assert sum(c.tokens.size for c in done.values()) == 120
    finally:
        fab.stop()


# --- the benches where JAX is missing ----------------------------------------

JAX_FREE = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "tpu_dra"):
    sys.modules[name] = None  # any import of them raises ImportError
sys.path.insert(0, sys.argv[1])
import json
import tpu_dra_torch.infra.chaos
import tpu_dra_torch.infra.metrics
import tpu_dra_torch.serving
import tpu_dra_torch.serving.claims
import tpu_dra_torch.serving.disaggbench
import tpu_dra_torch.serving.faultbench
import tpu_dra_torch.serving.repack
from tpu_dra_torch.serving import fabricbench as FB
config, params = FB._model("cpu")
out = FB.run_autoscale_drill(config, params, 8, 20260804, 120.0,
                             device="cpu")
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "tpu_dra")
                and sys.modules[m] is not None)
print(json.dumps({"drill": out, "loaded": loaded}))
"""


def test_benches_run_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_FREE, str(REPO)], capture_output=True,
        text=True, timeout=300, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["drill"]["scaleups"] >= 1 and out["drill"]["scaledowns"] >= 1
    assert out["drill"]["placed_devices"] == ["cpu"]


def test_bench_modules_are_scanned():
    from test_torch_isolation import _port_files

    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {f"tpu_dra_torch/serving/{m}.py" for m in (
        "fabricbench", "faultbench", "disaggbench", "repack", "claims")} | {
        "tpu_dra_torch/infra/metrics.py", "tpu_dra_torch/infra/chaos.py",
        "chip_smoke.py"} <= names

