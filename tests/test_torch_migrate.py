"""Evacuation and live KV migration in the torch engine, held to the JAX
engine on the CPU.

TINY_LLAMA at fp32 with the flax weights converted in-process
(tests/torch_twin.py). The twins of tests/test_serving_disagg.py's
engine tests (export -> import token-identical to an unmigrated run,
greedy and sampled; TTFT riding ``ttft_preobserved``) and of
tests/test_serving_fabric.py's evacuation test, with the JAX engine
and the port stepped in lockstep through the same export and import:
tables, refcounts, counters and tokens equal after every step. Then
migrations ACROSS the frameworks (a JAX export grafted by the port and
a port export grafted by JAX, token-identical to JAX's unmigrated run),
an import that attaches a registered prefix, capacity rejections that
leave the ledger whole, and the refusals, message for message.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from torch_twin import (  # noqa: E402
    EC,
    JCFG,
    Twin,
    assert_same_state,
    make_params,
    random_trace,
    rendered,
    requests,
    to_jax,
    to_port,
)

from tpu_dra.infra.metrics import Metrics  # noqa: E402
from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402

# tests/test_serving_disagg.py's sampled case.
MODES = [("greedy", {}),
         ("sampled", {"temperature": 0.8, "sample_seed": 11})]


@pytest.fixture(scope="module")
def params():
    return make_params()


def _one(seed=17, plen=6, new=7, rid="mig0", **kw):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(1, JCFG.vocab_size, plen).astype(np.int32),
             new, kw)]


def _reference(params, trace, **kw) -> dict:
    """JAX's unmigrated run of ``trace``: rid -> tokens."""
    eng = JE.Engine(JCFG, params[0], JE.EngineConfig(**dict(EC, **kw)))
    return {r: c.tokens.tolist()
            for r, c in eng.run(requests(JE, trace)).items()}


def _ledger_whole(eng) -> None:
    a = eng.allocator
    assert a.free_pages == a.num_pages - 1 and a.reserved_pages == 0


def _until_decoding(tw) -> list:
    while not tw.j.decoding_rids():
        tw.step()
    assert tw.t.decoding_rids() == tw.j.decoding_rids()
    return tw.j.decoding_rids()


def _same_extent(sj, st) -> None:
    """A JAX SequenceExtent and the port's of the same sequence: equal
    bookkeeping, and KV within fp32 rounding of each other."""
    assert (st.req.rid, st.kv_len, st.sample_seed, st.sample_serial) == (
        sj.req.rid, sj.kv_len, sj.sample_seed, sj.sample_serial)
    assert st.emitted.tolist() == sj.emitted.tolist()
    assert st.remaining == sj.remaining
    assert st.extent.slots == sj.extent.slots
    assert st.extent.nbytes == sj.extent.nbytes
    for name, layers in sj.extent.payload.items():
        for jl, tl in zip(layers, st.extent.payload[name]):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-5, rtol=1e-5)


def _finish(tw) -> dict:
    """Step a Twin to idle in lockstep; returns rid -> tokens (equal in
    both engines)."""
    jd, td = tw.run()
    assert {r: c.tokens.tolist() for r, c in td.items()} == {
        r: c.tokens.tolist() for r, c in jd.items()}
    return {r: c.tokens.tolist() for r, c in jd.items()}


# --- export -> import, lockstep ----------------------------------------------


@pytest.mark.parametrize("label,kw", MODES)
def test_export_import_token_identical_to_unmigrated_twin(params, label, kw):
    """tests/test_serving_disagg.py:93, both engines in lockstep: the
    migrated sequence's emitted + resumed tokens equal JAX's unmigrated
    run, the exports agree, and both sources' ledgers are whole."""
    trace = _one()
    ref = _reference(params, trace, **kw)
    src = Twin(params, **kw)
    src.add(trace)
    (rid,) = _until_decoding(src)
    sj, st = src.j.export_sequence(rid), src.t.export_sequence(rid)
    assert_same_state(src.j, src.t)
    _same_extent(sj, st)
    for eng in (src.j, src.t):
        _ledger_whole(eng)
        assert not eng.busy
    dst = Twin(params, **kw)
    assert dst.j.import_sequence(sj) and dst.t.import_sequence(st)
    assert_same_state(dst.j, dst.t)
    done = _finish(dst)
    assert st.emitted.tolist() + done[rid] == ref[rid], label
    for eng in (dst.j, dst.t):
        _ledger_whole(eng)


@pytest.mark.parametrize("label,kw", MODES)
def test_whole_batch_migration_lockstep(params, label, kw):
    """Every decoding sequence exported at one step boundary and
    imported in slot order into a second engine, while the source
    keeps prefilling its queue: both pairs stay equal every step, the
    counters agree, and every request's tokens are JAX's unmigrated
    run's."""
    trace = random_trace(6, seed=29)
    ref = _reference(params, trace, **kw)
    mets = [(Metrics(), Metrics()) for _ in range(2)]
    src = Twin(params, metrics=mets[0], **kw)
    dst = Twin(params, metrics=mets[1], **kw)
    src.add(trace)
    _until_decoding(src)
    emitted = {}
    for rid in src.j.decoding_rids():
        sj, st = src.j.export_sequence(rid), src.t.export_sequence(rid)
        _same_extent(sj, st)
        emitted[rid] = st.emitted.tolist()
        assert dst.j.import_sequence(sj) and dst.t.import_sequence(st)
        assert_same_state(src.j, src.t)
        assert_same_state(dst.j, dst.t)
    assert emitted
    got = {}
    for tw in (src, dst):
        got.update(_finish(tw))
        for eng in (tw.j, tw.t):
            _ledger_whole(eng)
    for rid, toks in emitted.items():
        got[rid] = toks + got[rid]
    assert got == ref, label
    for jm, tm in mets:
        assert rendered(jm) == rendered(tm)
    counters = rendered(mets[0][1])[1]
    assert counters["tpu_dra_engine_kv_exports_total"] == len(emitted)
    assert rendered(mets[1][1])[1]["tpu_dra_engine_kv_imports_total"] == len(emitted)


@pytest.mark.parametrize("label,kw", MODES)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_migration_across_frameworks(params, direction, label, kw):
    """A JAX export grafted by the port's engine (the payload carried by
    convert.extent_from_numpy), and a port export grafted by the JAX
    engine (torch_twin.extent_to_numpy): either way the tokens are JAX's
    unmigrated run's, and the destination's ledger ends whole."""
    trace = _one(seed=5, plen=9, new=8)
    ref = _reference(params, trace, **kw)
    src = Twin(params, **kw)
    src.add(trace)
    (rid,) = _until_decoding(src)
    sj, st = src.j.export_sequence(rid), src.t.export_sequence(rid)
    cfg = TE.EngineConfig(**dict(EC, **kw))
    if direction == "jax_to_port":
        dst = TE.Engine(src.t.config, params[1], cfg, device="cpu")
        sx = to_port(sj)
    else:
        dst = JE.Engine(JCFG, params[0], JE.EngineConfig(**dict(EC, **kw)))
        sx = to_jax(st)
    assert dst.import_sequence(sx)
    done = dst.run()
    assert sx.emitted.tolist() + done[rid].tokens.tolist() == ref[rid]
    _ledger_whole(dst)


def test_ttft_preobserved_rides_migration(params):
    """tests/test_serving_disagg.py:118: neither destination observes
    engine_ttft_seconds for a sequence whose first token happened on
    the source."""
    src = Twin(params)
    src.add(_one(plen=5, new=6, rid="t0"))
    _until_decoding(src)
    sj, st = src.j.export_sequence("t0"), src.t.export_sequence("t0")
    assert st.t_first is not None and st.resume_request().ttft_preobserved
    mets = (Metrics(), Metrics())
    dst = Twin(params, metrics=mets)
    assert dst.j.import_sequence(sj) and dst.t.import_sequence(st)
    _finish(dst)
    for m in mets:
        assert "engine_ttft_seconds" not in m.render()


# --- evacuation ----------------------------------------------------------------


@pytest.mark.parametrize("label,kw", MODES)
def test_engine_evacuate_moves_sequences_losslessly(params, label, kw):
    """tests/test_serving_fabric.py:494 in lockstep: evacuate both
    engines mid-generation (the same checkpoints, ledgers whole), resume
    the evacuees on a fresh pair by re-prefilling prompt + emitted with
    the sampling schedule pinned, and the stitched tokens equal JAX's
    uninterrupted run."""
    rng = np.random.default_rng(3)
    trace = [(f"r{i}", rng.integers(1, JCFG.vocab_size, 6).astype(np.int32),
              9, {}) for i in range(5)]
    ref = _reference(params, trace, **kw)
    mets = (Metrics(), Metrics())
    tw = Twin(params, metrics=mets, **kw)
    tw.add(trace)
    tw.step(4)
    ev_j, ev_t = tw.j.evacuate(), tw.t.evacuate()
    assert_same_state(tw.j, tw.t)
    assert [(e.req.rid, e.emitted.tolist(), e.remaining, e.t_first is None)
            for e in ev_t] == [
        (e.req.rid, e.emitted.tolist(), e.remaining, e.t_first is None)
        for e in ev_j]
    assert any(len(e.emitted) for e in ev_t), "no sequence mid-generation"
    for eng in (tw.j, tw.t):
        assert not eng.busy
        _ledger_whole(eng)
    assert rendered(mets[0]) == rendered(mets[1])
    assert rendered(mets[1])[1]["tpu_dra_engine_evacuated_total"] == len(ev_t)
    got = {r: c.tokens.tolist() for r, c in tw.t.completed.items()}
    assert len(ev_t) + len(got) == len(trace)
    # The admission serials of the first run, pinned as the Router's
    # journal pins them.
    serial = {rid: i + 1 for i, (rid, *_) in enumerate(trace)}
    resume = Twin(params, **kw)
    resume.add([(e.req.rid, np.concatenate([e.req.prompt, e.emitted]),
                 e.remaining, {"sample_seed": kw.get("sample_seed", 0),
                               "sample_serial": serial[e.req.rid]})
                for e in ev_t])
    got.update(_finish(resume))
    for e in ev_t:
        got[e.req.rid] = e.emitted.tolist() + got[e.req.rid]
    assert got == ref, label


# --- prefixes, capacity and refusals -------------------------------------------


def test_import_attaches_registered_prefix(params):
    """A destination holding a registered prefix attaches its full
    pages by incref instead of grafting the payload: the same attach
    count and pages in both engines, and the tokens JAX's."""
    rng = np.random.default_rng(8)
    system = rng.integers(1, JCFG.vocab_size, 9).astype(np.int32)
    share = {"prefix_id": "sys", "prefix_len": 9}

    def req(rid, n_suffix, new):
        suffix = rng.integers(1, JCFG.vocab_size, n_suffix).astype(np.int32)
        return (rid, np.concatenate([system, suffix]), new, dict(share))

    leader, mover = req("lead", 3, 12), req("move", 2, 6)
    ref = _reference(params, [mover])
    dst = Twin(params)
    dst.add([leader])
    while "sys" not in dst.j._prefix_registry:
        dst.step()
    src = Twin(params)
    src.add([mover])
    _until_decoding(src)
    sj, st = src.j.export_sequence("move"), src.t.export_sequence("move")
    before = (dst.j.prefix_attached, dst.t.prefix_attached)
    assert dst.j.import_sequence(sj) and dst.t.import_sequence(st)
    assert_same_state(dst.j, dst.t)
    assert (dst.j.prefix_attached, dst.t.prefix_attached) == (
        before[0] + 1, before[1] + 1)
    entry = dst.t._prefix_registry["sys"]
    slot = next(s for s in dst.t._slots if s and s.req.rid == "move")
    assert slot.pages[:2] == entry.pages[:2]  # 9 tokens: 2 full pages
    done = _finish(dst)
    assert st.emitted.tolist() + done["move"] == ref["move"]
    for eng in (dst.j, dst.t):
        _ledger_whole(eng)


@pytest.mark.parametrize("case", ["no_slot", "no_pages"])
def test_import_capacity_rejection_leaves_ledger_whole(params, case):
    """No free slot, or no page headroom after shedding prefixes:
    import_sequence returns False in both engines, and the ledger,
    tables and rids stay as they were."""
    src = Twin(params)
    src.add(_one())
    (rid,) = _until_decoding(src)
    sj, st = src.j.export_sequence(rid), src.t.export_sequence(rid)
    if case == "no_slot":
        dst = Twin(params, max_slots=1)
        dst.add(_one(seed=2, rid="resident"))
        dst.step()
    else:
        dst = Twin(params, num_pages=4)  # 3 free, the import needs 4
    free = (dst.t.allocator.free_pages, dst.t.allocator.reserved_pages)
    assert dst.j.import_sequence(sj) is False
    assert dst.t.import_sequence(st) is False
    assert_same_state(dst.j, dst.t)
    assert (dst.t.allocator.free_pages,
            dst.t.allocator.reserved_pages) == free
    assert rid not in dst.t._rids


def _refusal(params, case):
    """(destination Twin, JAX sx, port sx, the two request overrides or
    None) for one refusal case."""
    kw = {"temperature": 0.8, "sample_seed": 11} if case == "seed" else {}
    src = Twin(params, **kw)
    src.add(_one())
    (rid,) = _until_decoding(src)
    sj, st = src.j.export_sequence(rid), src.t.export_sequence(rid)
    dkw = {"contiguous": dict(contiguous=True),
           "seed": dict(temperature=0.8, sample_seed=12),
           "page_size": dict(page_size=8),
           "budget": dict(max_pages_per_seq=3)}.get(case, {})
    dst = Twin(params, **dkw)
    if case == "duplicate":
        dst.add(_one(seed=3, rid=rid))
    short = None
    if case == "prompt":
        short = [dataclasses.replace(sx.resume_request(),
                                     prompt=sx.resume_request().prompt[:-1])
                 for sx in (sj, st)]
    return dst, sj, st, short


@pytest.mark.parametrize(
    "case", ["contiguous", "duplicate", "seed", "page_size", "prompt",
             "budget"])
def test_import_refusals_match_jax(params, case):
    """Every mismatch raises ValueError, with the JAX engine's message."""
    dst, sj, st, short = _refusal(params, case)
    msgs = []
    for eng, sx, req in ((dst.j, sj, short and short[0]),
                         (dst.t, st, short and short[1])):
        with pytest.raises(ValueError) as e:
            eng.import_sequence(sx, req)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert_same_state(dst.j, dst.t)


def test_export_refusals_match_jax(params):
    """Exports of a sequence that is not decoding, and from a contiguous
    engine, raise ValueError with the JAX engine's messages."""
    for kw, trace in (({}, _one()), ({"contiguous": True}, _one())):
        tw = Twin(params, **kw)
        tw.add(trace)
        rid = trace[0][0]
        target = "nope" if not kw else rid
        if kw:
            _until_decoding(tw)
        msgs = []
        for eng in (tw.j, tw.t):
            with pytest.raises(ValueError) as e:
                eng.export_sequence(target)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
