"""Lease gates, the backpressure drain and metrics export in the torch
engine, held to the JAX engine on the CPU.

TINY_LLAMA at fp32 with the flax weights converted in-process; the JAX
engine and the port's step in lockstep through the same trace and the
same gate actions (tests/torch_twin.py), their host state equal after
every step and their tokens at the end. These are the twins of
tests/test_engine.py's drain tests (the stub gate, the tied clock, the
second drain cycle, sampled and speculative drain and resume), of its
real multiplex daemon and ``auto_gate`` tests (the port's
``MultiplexLeaseGate`` over its copied client, against the JAX
package's daemon) and of its metrics tests: both engines export into a
``tpu_dra.infra.metrics.Metrics``, and the rendered series names and
counter values must be equal (histograms: names only).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_twin import (  # noqa: E402
    JCFG,
    SAMPLED,
    SPEC_EC,
    TCFG,
    Twin,
    assert_same_state,
    assert_same_tokens,
    lookup_trace,
    make_params,
    random_trace,
    rendered,
    requests,
)

from tpu_dra.infra.metrics import Metrics  # noqa: E402
from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402
from tpu_dra_torch.workloads import multiplex_client as TMC  # noqa: E402


@pytest.fixture(scope="module")
def params():
    return make_params()


def _gated(params, ec=None, metrics=False, **kw):
    """A Twin behind two EventGates (one per engine), optionally with a
    Metrics each; returns (twin, gates, metrics)."""
    gates = (JE.EventGate(), TE.EventGate())
    mets = (Metrics(), Metrics()) if metrics else (None, None)
    return Twin(params, ec, gates=gates, metrics=mets, **kw), gates, mets


def _set(gates, ready: bool) -> None:
    for g in gates:
        g.restore() if ready else g.revoke()


def _pre(eng) -> dict:
    return {s.req.rid: list(s.out) for s in eng._live()}


def assert_same_metrics(mets) -> None:
    (jk, jc), (tk, tc) = rendered(mets[0]), rendered(mets[1])
    assert jk == tk
    assert jc == tc


# --- the drain -----------------------------------------------------------------


def test_backpressure_drain_and_resume_stub_gate(params):
    """tests/test_engine.py:161: revoke mid-trace drains (slots empty,
    pages free, admissions stall, the stall gauge exported); the resume
    completes every request once with its pre-drain tokens intact."""
    tw, gates, mets = _gated(params, metrics=True)
    trace = random_trace(5, seed=23)
    tw.add(trace)
    tw.step(4)
    pre = _pre(tw.t)
    _set(gates, False)
    tw.step()
    assert all(s is None for s in tw.t._slots)
    assert tw.t.allocator.free_pages == tw.t.allocator.num_pages - 1
    assert "engine_admission_stalled" in mets[1].render()
    done_during = len(tw.t.completed)
    tw.step(3)
    assert len(tw.t.completed) == done_during
    _set(gates, True)
    jd, td = tw.run()
    assert_same_tokens(jd, td)
    for rid, c in td.items():
        assert list(c.tokens[: len(pre.get(rid, []))]) == pre.get(rid, [])
    assert {r: len(c.tokens) for r, c in td.items()} == {
        r: n for r, _, n, _ in trace}
    assert_same_metrics(mets)


def test_drain_resumes_oldest_first_under_tied_clock(params):
    """tests/test_engine.py:195: one t_submit for a whole burst; the
    admission serial still resumes oldest first, and a cold stall with
    nothing in flight counts no drain."""
    gates = (JE.EventGate(ready=False), TE.EventGate(ready=False))
    mets = (Metrics(), Metrics())
    tw = Twin(params, gates=gates, metrics=mets)
    tw.j.clock = tw.t.clock = lambda: 42.0
    tw.step()
    assert "engine_backpressure_drains_total" not in mets[1].render()
    _set(gates, True)
    tw.add([(f"t{i}", np.ones(6, np.int32), 8, {}) for i in range(4)])
    tw.step(2)
    assert sum(s is not None for s in tw.t._slots) >= 2
    _set(gates, False)
    tw.step()
    resumed = [s.req.rid for s in tw.t._queue]
    assert resumed == sorted(resumed)
    assert rendered(mets[1])[1]["tpu_dra_engine_backpressure_drains_total"] == 1
    _set(gates, True)
    jd, td = tw.run()
    assert sorted(td) == [f"t{i}" for i in range(4)]
    assert_same_tokens(jd, td)
    assert_same_metrics(mets)


def test_second_drain_cycle_and_double_revoke(params):
    """tests/test_engine.py:236: two revocations, each drains once; a
    stalled step does not drain again."""
    tw, gates, mets = _gated(params, metrics=True)
    trace = random_trace(4, seed=5, max_new=24)
    tw.add(trace)
    for _ in range(2):
        tw.step(2)
        _set(gates, False)
        tw.step(2)
        _set(gates, True)
    jd, td = tw.run()
    assert_same_tokens(jd, td)
    assert sorted(td) == sorted(r for r, _, _, _ in trace)
    assert rendered(mets[1])[1]["tpu_dra_engine_backpressure_drains_total"] == 2
    assert_same_metrics(mets)


def test_sampled_drain_resume_preserves_trajectory(params):
    """tests/test_engine.py:512: position-keyed draws make the
    re-prefilled resume sample what the undrained run sampled."""
    base = Twin(params, **SAMPLED)
    _, want = base.run(random_trace())
    tw, gates, _ = _gated(params, **SAMPLED)
    tw.add(random_trace())
    tw.step(4)
    assert any(s is not None for s in tw.t._slots)
    _set(gates, False)
    tw.step(3)
    _set(gates, True)
    jd, td = tw.run()
    assert_same_tokens(jd, td)
    assert_same_tokens(want, td)


@pytest.mark.parametrize("kw", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_spec_drain_resume_token_identical(params, kw):
    """tests/test_engine.py:661: drain and resume under speculation
    match the per-token oracle and JAX."""
    oracle = TE.Engine(TCFG, params[1], TE.EngineConfig(
        **SPEC_EC, fused=False, contiguous=True, **kw), device="cpu").run(
        requests(TE, lookup_trace()))
    tw, gates, _ = _gated(params, SPEC_EC, spec_k=4, **kw)
    tw.add(lookup_trace())
    tw.step(7)
    assert any(s is not None for s in tw.t._slots)
    _set(gates, False)
    tw.step(2)
    _set(gates, True)
    jd, td = tw.run()
    assert_same_tokens(jd, td)
    assert_same_tokens(oracle, td)
    assert tw.t.spec_proposed > 0


def test_stalled_step_exports_and_blocks_nothing(params):
    """While the gate is closed, step() returns at once with the queue
    intact; the stall gauge grows with the engine's clock."""
    clock = {"t": 0.0}
    m = Metrics()
    gate = TE.EventGate(ready=False)
    eng = TE.Engine(TCFG, params[1], TE.EngineConfig(**SPEC_EC), gate=gate,
                    metrics=m, clock=lambda: clock["t"], device="cpu")
    for r in requests(TE, random_trace(2)):
        eng.add_request(r)
    assert eng.step() is True
    clock["t"] = 2.5
    eng.step()
    assert m.get_gauge("engine_admission_stalled") == 2.5
    assert m.get_gauge("engine_queued_sequences") == 2.0
    assert eng.progress == 0 and not eng.completed
    gate.restore()
    eng.run([])
    assert m.get_gauge("engine_admission_stalled") == 0.0
    assert len(eng.completed) == 2


# --- the real multiplex daemon -------------------------------------------------


def test_socket_name_matches_the_daemon():
    from tpu_dra.plugin.multiplexd import SOCKET_NAME

    assert TMC.SOCKET_NAME == SOCKET_NAME == "multiplexd.sock"


def test_backpressure_through_real_multiplex_daemon(params, tmp_path):
    """tests/test_engine.py:262: the port's MultiplexLeaseGate over its
    copied client holds the lease of the JAX package's daemon;
    force_revoke closes the gate, the engine drains, re-acquires through
    the cooldown and completes every request — with the tokens of the
    JAX engine drilled by an EventGate at the same step."""
    from tpu_dra.plugin.multiplexd import MultiplexDaemon

    trace = random_trace(4, seed=9)
    daemon = MultiplexDaemon(str(tmp_path), ["bench-chip"],
                             preempt_cooldown_seconds=0.1).start()
    try:
        client = TMC.MultiplexClient(str(tmp_path), client_name="engine")
        gate = TE.MultiplexLeaseGate(client)
        eng = TE.Engine(TCFG, params[1], TE.EngineConfig(**SPEC_EC),
                        gate=gate, device="cpu")
        for r in requests(TE, trace):
            eng.add_request(r)
        assert not gate.ready()  # no lease yet
        assert gate.wait_ready()
        for _ in range(3):
            eng.step()
        assert any(s is not None for s in eng._slots)
        assert daemon.state.force_revoke("test drill")
        eng.step()  # sees the async revocation and drains
        assert all(s is None for s in eng._slots)
        assert client.revocations == 1
        done = eng.run([])
        assert {r: len(c.tokens) for r, c in done.items()} == {
            r: n for r, _, n, _ in trace}
        gate.close()
    finally:
        daemon.stop()
    jgate = JE.EventGate()
    jeng = JE.Engine(JCFG, params[0], JE.EngineConfig(**SPEC_EC), gate=jgate)
    for r in requests(JE, trace):
        jeng.add_request(r)
    for _ in range(3):
        jeng.step()
    jgate.revoke()
    jeng.step()
    jgate.restore()
    assert_same_tokens(jeng.run([]), done)


def test_auto_gate_env_contract(tmp_path):
    """tests/test_engine.py:302: the open gate outside a multiplexed
    container, the daemon's lease inside one."""
    from tpu_dra.plugin.multiplexd import MultiplexDaemon

    assert type(TE.auto_gate(environ={})) is TE.LeaseGate
    daemon = MultiplexDaemon(str(tmp_path), ["c0"]).start()
    try:
        g = TE.auto_gate(environ={
            "TPU_PROCESS_MULTIPLEXING": "true",
            "TPU_MULTIPLEX_SOCKET_DIR": str(tmp_path),
        })
        assert isinstance(g, TE.MultiplexLeaseGate)
        assert g.wait_ready() and g.ready()
        g.close()
    finally:
        daemon.stop()


# --- metrics ---------------------------------------------------------------------


def test_engine_metrics_export(params):
    """tests/test_engine.py:322: every engine_* series JAX exports, with
    the same counter values; no exhaustion counter."""
    mets = (Metrics(), Metrics())
    tw = Twin(params, metrics=mets)
    jd, td = tw.run(random_trace(3, seed=2))
    assert_same_tokens(jd, td)
    kinds, counters = rendered(mets[1])
    for name in ("engine_tokens_total", "engine_prefill_tokens_total",
                 "engine_admitted_total", "engine_completed_total",
                 "engine_pages_free", "engine_admission_stalled",
                 "engine_admission_blocked_on_pages",
                 "engine_request_latency_seconds", "engine_ttft_seconds"):
        assert f"tpu_dra_{name}" in kinds, name
    assert counters["tpu_dra_engine_tokens_total"] == sum(
        len(c.tokens) for c in td.values())
    assert mets[1].quantile("engine_request_latency_seconds", 0.5) >= 0
    assert "engine_page_exhausted_total" not in mets[1].render()
    assert_same_metrics(mets)


def test_pages_backpressure_is_gauge_not_exhaustion(params):
    """tests/test_engine.py:409: an oversubscribed pool blocks admission
    (the gauge flips) and never counts exhaustion."""
    mets = (Metrics(), Metrics())
    tw = Twin(params, metrics=mets, num_pages=12)
    tw.add([(f"q{i}", np.ones(10, np.int32), 8, {}) for i in range(4)])
    saw_blocked = False
    while tw.t.busy:
        tw.step()
        saw_blocked = saw_blocked or tw.t._blocked_on_pages
    assert saw_blocked
    assert len(tw.t.completed) == 4 and tw.t.allocator.exhausted == 0
    assert "engine_page_exhausted_total" not in mets[1].render()
    assert_same_metrics(mets)


def test_spec_metrics_exported(params):
    """tests/test_engine.py:923: proposed and accepted drafts and the
    shared-pages gauge, equal to JAX's."""
    mets = (Metrics(), Metrics())
    tw = Twin(params, SPEC_EC, metrics=mets, spec_k=4)
    jd, td = tw.run(lookup_trace())
    assert_same_tokens(jd, td)
    kinds, counters = rendered(mets[1])
    assert counters["tpu_dra_engine_spec_proposed_total"] == tw.t.spec_proposed
    assert counters["tpu_dra_engine_spec_accepted_total"] == tw.t.spec_accepted
    assert "tpu_dra_engine_prefix_shared_pages" in kinds
    assert_same_metrics(mets)


def test_prefix_metrics_match_engine_counts(params):
    """Prefix counters and the TTFT observation: one per request, none
    again after a drain (t_first survives), none for a request marked
    ttft_preobserved."""
    prompt = np.arange(1, 19, dtype=np.int32)
    share = {"prefix_id": "sys", "prefix_len": 14}
    trace = [(f"f{i}", prompt, 10, dict(share)) for i in range(3)]
    trace.append(("pre", prompt[:9], 4, {"ttft_preobserved": True}))
    tw, gates, mets = _gated(params, SPEC_EC, metrics=True)
    tw.add(trace)
    tw.step(4)
    _set(gates, False)
    tw.step()
    _set(gates, True)
    jd, td = tw.run()
    assert_same_tokens(jd, td)
    _, counters = rendered(mets[1])
    assert counters["tpu_dra_engine_prefix_attached_total"] == (
        tw.t.prefix_attached)
    assert counters["tpu_dra_engine_cow_copies_total"] == tw.t.cow_copies
    assert tw.t.cow_copies > 0
    assert mets[1].render().count("engine_ttft_seconds_count 3") == 1
    assert_same_metrics(mets)
    assert_same_state(tw.j, tw.t)
