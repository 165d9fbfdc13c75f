"""The port's serve and decode benches held to the JAX package's on the
CPU.

``tpu_dra_torch.workloads.enginebench`` against
``tpu_dra.workloads.enginebench``: the seeded traces equal element for
element; the accounting (trace stats, padding waste, the equal-memory
engine config, the fixed-batch baseline's counts) equal; the engine
replay (warmup included, which advances the sampling serials) gives
JAX's tokens greedy, sampled, with int8 KV, with int8 weights and
speculative, at a saturating rate so the schedule is deterministic; the
prefix fleet's page counts equal; ``run_serve_bench`` returns JAX's key
set with the same speculation counts. Batched against serial prefill is
held by its deterministic cause: the engine iteration at which each
burst request gets its first token, equal to JAX's. ``decodebench``'s
breakdown keeps JAX's schema. Each module's ``main`` runs on the CPU.

The weights are TINY_LLAMA's flax tree at fp32, converted in-process
(tests/torch_twin.py); JAX runs its xla paths on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
from torch_twin import JCFG, TCFG, make_params  # noqa: E402

from tpu_dra.workloads import decodebench as JD  # noqa: E402
from tpu_dra.workloads import engine as JE  # noqa: E402
from tpu_dra.workloads import enginebench as JB  # noqa: E402
from tpu_dra_torch.workloads import decodebench as TD  # noqa: E402
from tpu_dra_torch.workloads import engine as TE  # noqa: E402
from tpu_dra_torch.workloads import enginebench as TB  # noqa: E402
from tpu_dra_torch.workloads import specbench as TS  # noqa: E402

# The JAX smoke's engine config (enginebench.main's ec()).
EC = dict(page_size=4, max_slots=3, max_pages_per_seq=10, scan_chunk=3,
          prefill_chunk=8)
VOCAB = JCFG.vocab_size


@pytest.fixture(scope="module")
def params():
    return make_params()


TRACES = [
    (3, 8, 1e9, [3, 7, 11, 16], [2, 5, 9, 13]),
    (0, 16, 1000.0, [16, 64, 128, 256], [8, 32, 96, 192]),
    (5, 5, 2.5, [4], [1, 3]),
]


def _same_trace(jt, tt):
    assert len(jt) == len(tt)
    for j, t in zip(jt, tt):
        assert (j.rid, j.max_new_tokens, j.arrival_s) == (
            t.rid, t.max_new_tokens, t.arrival_s)
        assert j.prompt.dtype == t.prompt.dtype
        assert np.array_equal(j.prompt, t.prompt), j.rid


@pytest.mark.parametrize("maker", ["make_trace", "make_lookup_trace"])
@pytest.mark.parametrize("args", TRACES, ids=["smoke", "serve", "sparse"])
def test_traces_equal_jax_element_for_element(maker, args):
    jt = getattr(JB, maker)(*args, vocab=VOCAB)
    tt = getattr(TB, maker)(*args, vocab=VOCAB)
    _same_trace(jt, tt)
    assert all(isinstance(r, TE.Request) for r in tt)


@pytest.mark.parametrize("batch", [1, 3, 4, 16])
@pytest.mark.parametrize("args", TRACES, ids=["smoke", "serve", "sparse"])
def test_trace_stats_and_padding_waste_equal_jax(args, batch):
    jt, tt = JB.make_trace(*args, VOCAB), TB.make_trace(*args, VOCAB)
    assert TB.trace_stats(tt) == JB.trace_stats(jt)
    assert (TB.fixed_batch_padding_waste(tt, batch)
            == JB.fixed_batch_padding_waste(jt, batch))


@pytest.mark.parametrize("kw", [
    {}, {"page_size": 4, "scan_chunk": 3, "prefill_chunk": 8},
    {"slots_factor": 1, "kv_quant": "int8", "weight_quant": "int8"},
])
@pytest.mark.parametrize("batch", [2, 8])
def test_equal_memory_engine_config_equals_jax(kw, batch):
    args = TRACES[1]
    jc = JB.equal_memory_engine_config(JB.make_trace(*args, VOCAB), batch,
                                       **kw)
    tc = TB.equal_memory_engine_config(TB.make_trace(*args, VOCAB), batch,
                                       **kw)
    assert isinstance(tc, TE.EngineConfig)
    assert dataclasses.asdict(tc) == {
        k: v for k, v in dataclasses.asdict(jc).items()
        if k in dataclasses.asdict(tc)}


def _smoke_trace(mod):
    return mod.make_trace(3, 8, 1e9, [3, 7, 11, 16], [2, 5, 9, 13], VOCAB)


def _lookup_trace(mod):
    return mod.make_lookup_trace(3, 6, 1e9, [8, 16], [5, 9, 13], VOCAB)


ARMS = {
    "greedy": ({}, _smoke_trace),
    "sampled": (dict(temperature=0.8, top_k=8, sample_seed=11), _smoke_trace),
    "kv8": ({"kv_quant": "int8"}, _smoke_trace),
    "w8": ({"weight_quant": "int8"}, _smoke_trace),
    "spec4": ({"spec_k": 4, "max_pages_per_seq": 16}, _lookup_trace),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_run_engine_trace_tokens_identical_to_jax(params, arm):
    """The warmup included: its requests take the first sampling
    serials, so the trace's sampled tokens match only if the port's
    warmup admits them as JAX's does."""
    kw, trace = ARMS[arm]
    jp, tp = params
    want = JB.run_engine_trace(JCFG, jp, JE.EngineConfig(**{**EC, **kw}),
                               trace(JB))
    got = TB.run_engine_trace(TCFG, tp, TE.EngineConfig(**{**EC, **kw}),
                              trace(TB), device="cpu")
    assert sorted(got["completions"]) == sorted(want["completions"])
    for rid, c in want["completions"].items():
        assert np.array_equal(got["completions"][rid].tokens, c.tokens), rid
    assert got["useful_decode_tokens"] == want["useful_decode_tokens"]
    je, te = want["engine"], got["engine"]
    assert (te.spec_proposed, te.spec_accepted) == (
        je.spec_proposed, je.spec_accepted)
    if kw.get("spec_k"):
        assert te.spec_accepted > 0
    # The port's extra key: the engine's decode timer, warmup excluded.
    assert got["decode_seconds"] == te.decode_seconds > 0
    assert set(want) <= set(got)


def test_warmup_advances_sampling_serials_as_jax_does(params):
    """Without the warmup the trace's serials start at 1, with it after
    the warmup's requests: the sampled tokens differ, in both packages
    alike."""
    jp, tp = params
    kw = dict(EC, temperature=0.8, top_k=8, sample_seed=11)
    runs = {
        warm: TB.run_engine_trace(TCFG, tp, TE.EngineConfig(**kw),
                                  _smoke_trace(TB), warmup=warm,
                                  device="cpu")["completions"]
        for warm in (True, False)
    }
    cold = JB.run_engine_trace(JCFG, jp, JE.EngineConfig(**kw),
                               _smoke_trace(JB), warmup=False)["completions"]
    for rid, c in cold.items():
        assert np.array_equal(runs[False][rid].tokens, c.tokens), rid
    assert TB.first_difference(runs[True], runs[False]) is not None


def test_run_prefix_fleet_counts_equal_jax(params):
    jp, tp = params
    kw = dict(fleet_n=4, prompt_len=17, max_new=6, page_size=4, vocab=VOCAB,
              seed=2)
    want = JB.run_prefix_fleet(JCFG, jp, **kw)
    got = TB.run_prefix_fleet(TCFG, tp, device="cpu", **kw)
    assert got == want
    assert got["prefix_pages_saved"] >= 3 * 4 - 1
    # Not exact: the same counts, and the agreement reported instead.
    loose = TB.run_prefix_fleet(TCFG, tp, device="cpu", exact=False, **kw)
    assert loose == {**want, "token_agreement": 1.0,
                     "first_difference": None}


def test_fixed_batch_baseline_accounting_equals_jax(params):
    jp, tp = params
    trace = TRACES[0]
    want = JB.run_fixed_batch_baseline(JCFG, jp, JB.make_trace(*trace, VOCAB),
                                       3)
    got = TB.run_fixed_batch_baseline(TCFG, tp, TB.make_trace(*trace, VOCAB),
                                      3, device="cpu")
    assert set(got) == set(want)
    for key in ("n_batches", "padded_decode_tokens", "useful_decode_tokens",
                "decode_padding_waste", "batch", "max_seq"):
        assert got[key] == want[key], key
    assert got["p99_ms"] >= got["p50_ms"] > 0


SERVE_ENV = {
    "BENCH_SERVE_REQUESTS": "4", "BENCH_SERVE_BATCH": "2",
    "BENCH_SERVE_RATE_RPS": "1e9", "BENCH_SERVE_PROMPTS": "6,10",
    "BENCH_SERVE_OUTPUTS": "4,8", "BENCH_SERVE_PAGE": "4",
    "BENCH_SPEC_K": "3", "BENCH_PREFIX_FLEET": "3",
}


def test_run_serve_bench_keys_and_spec_counts_equal_jax(params):
    jp, tp = params
    want = JB.run_serve_bench(JCFG, jp, SERVE_ENV)
    arms = []
    got = TB.run_serve_bench(
        TCFG, tp, SERVE_ENV, device="cpu",
        on_arm=lambda name, trace, run: arms.append(name))
    assert set(got) == set(want)
    for key in ("spec_proposed", "spec_accepted", "spec_k",
                "prefix_pages_saved", "prefix_private_peak_pages",
                "prefix_shared_peak_pages", "decode_padding_waste",
                "trace", "serve_requests", "serve_batch"):
        assert got[key] == want[key], key
    assert got["spec_proposed"] > 0 and got["prefix_pages_saved"] > 0
    assert arms == ["baseline", "engine", "w8", "sampled", "lookup", "spec",
                    "prefix_fleet", "prefill_batched", "prefill_serial"]


def test_run_serve_bench_cut_spec_trace(params):
    """BENCH_SPEC_* cut only the lookup trace of the spec arm and its
    baseline; each arm hands its engine to on_arm whole; exact=False
    reports the pairs' agreement."""
    _, tp = params
    env = dict(SERVE_ENV, BENCH_SPEC_REQUESTS="2", BENCH_SPEC_PROMPTS="8",
               BENCH_SPEC_OUTPUTS="5")
    seen = {}

    def on_arm(name, trace, run):
        if "engine" in run:
            alloc = run["engine"].allocator
            assert alloc.free_pages == alloc.num_pages - 1, name
            seen[name] = [(r.rid, len(r.prompt), r.max_new_tokens)
                          for r in trace]
            for r in trace:
                assert len(run["completions"][r.rid].tokens) == (
                    r.max_new_tokens), (name, r.rid)

    got = TB.run_serve_bench(TCFG, tp, env, device="cpu", exact=False,
                             on_arm=on_arm)
    assert seen["lookup"] == seen["spec"] == [
        ("lk0000", 8, 5), ("lk0001", 8, 5)]
    assert len(seen["engine"]) == 4
    assert got["serve_requests"] == 4
    # Not exact: each pair's agreement is reported (identical here).
    assert {k: got[k] for k in got if "agreement" in k
            or "first_difference" in k} == {
        "spec_token_agreement": 1.0, "spec_first_difference": None,
        "prefix_token_agreement": 1.0, "prefix_first_difference": None}


def _first_token_iterations(mod, cfg, params, ec, burst, **engine_kw):
    """Each burst request's first-token engine iteration, on a clock
    that counts iterations."""
    it = [0]
    eng = mod.Engine(cfg, params, ec, clock=lambda: float(it[0]),
                     **engine_kw)
    for r in burst:
        eng.add_request(r)
    while eng.busy:
        eng.step()
        it[0] += 1
    return [eng.completed[r.rid].t_first_token for r in burst]


@pytest.mark.parametrize("burst_n", [4, 6])
def test_batched_prefill_first_tokens_come_earlier_as_in_jax(params,
                                                             burst_n):
    """The deterministic cause of the TTFT pair's wall-clock ordering:
    batched prefill gives every burst request its first token in the
    first iteration, the serial schedule one request an iteration."""
    jp, tp = params
    ec = dict(page_size=4, max_slots=6, max_pages_per_seq=10, scan_chunk=3,
              prefill_chunk=16)
    firsts = {}
    for label, pb in (("batched", 0), ("serial", 1)):
        runs = []
        for mod, cfg, p, kw in ((JE, JCFG, jp, {}),
                                (TE, TCFG, tp, {"device": "cpu"})):
            bench = JB if mod is JE else TB
            rng = np.random.default_rng(55)
            burst = [bench._mk_burst_req(rng, i, 12, VOCAB)
                     for i in range(burst_n)]
            runs.append(_first_token_iterations(
                mod, cfg, p, mod.EngineConfig(**ec, prefill_batch=pb),
                burst, **kw))
        assert runs[0] == runs[1], label
        firsts[label] = runs[1]
    assert firsts["batched"] == [0.0] * burst_n
    assert firsts["serial"] == [float(i) for i in range(burst_n)]
    assert np.median(firsts["batched"]) < np.median(firsts["serial"])


BREAKDOWN_KEYS = (
    "step_ms", "sampled_step_ms", "sampling_ms", "attention_ms",
    "qkv_ms", "attn_out_ms", "mlp_ms", "embed_norm_ms", "logits_ms",
    "residual_ms", "sampled_overhead_ms",
)


def test_step_breakdown_schema_and_consistency(params):
    """The twin of tests/test_workloads.py's breakdown test: every key
    present, positive, the fractions normalized by step_ms, JAX's key
    set; no device keys off the card."""
    jp, tp = params
    bd = TD.measure_step_breakdown(TCFG, tp, batch=2, ctx_len=20, reps=2,
                                   device="cpu")
    for key in BREAKDOWN_KEYS:
        assert key in bd, key
        if key.endswith("_ms") and key not in (
            "residual_ms", "sampled_overhead_ms"
        ):
            assert bd[key] > 0, (key, bd[key])
    assert bd["ctx_len"] == 20 and bd["batch"] == 2
    assert abs(
        bd["attention_frac"] - bd["attention_ms"] / bd["step_ms"]
    ) < 0.01
    want = JD.measure_step_breakdown(JCFG, jp, batch=2, ctx_len=20, reps=2)
    assert set(bd) == set(want)
    assert not [k for k in bd if "device" in k or k in (
        "busy_share", "step_launches")]


class _Event:
    """The torch.profiler FunctionEvent fields attribute_kernels reads:
    a host span (device_type CPU) or a device activity (CUDA), its start
    and length in µs."""

    def __init__(self, name, device, start, length=0.0):
        self.name, self.device_type = name, device
        self.time_range = type("Range", (), {
            "start": start, "elapsed_us": lambda self: length})()


def test_attribute_kernels_charges_each_part_its_window():
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    events = [
        _Event("gemm", cuda, 5.0, 1.0),  # before every span: not a part's
        _Event("decodebench/a", cpu, 10.0),
        _Event("aten::mm", cpu, 11.0),
        _Event("gemm", cuda, 12.0, 5.0),
        _Event("decodebench/a", cuda, 12.0, 9.0),  # the span's annotation
        _Event("Memset", cuda, 18.0, 1.0),
        _Event("decodebench/b", cpu, 30.0),
        _Event("mlp_sm90_kernel", cuda, 31.5, 7.5),
        _Event("decodebench/end", cpu, 50.0),
        _Event("pad", cuda, 51.0, 2.0),
    ]
    us, launches = TD.attribute_kernels(events, TD.SPAN)
    assert us == {"a": 6.0, "b": 7.5, "end": 2.0}
    assert launches == {"a": 2, "b": 1, "end": 1}


def test_attribute_by_gaps_reads_the_device_clock_alone():
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)
    # The device clock reads 10-20 µs behind the host's: on the host
    # clock a's work starts before every span, b's kernel inside a's
    # window and the pad inside b's, so the host windows lose a's work
    # and charge each later part its predecessor's.
    events = [
        _Event("decodebench/a", cpu, 100.0),
        _Event("gemm", cuda, 80.0, 5.0),
        _Event("Memset", cuda, 86.0, 1.0),
        _Event("decodebench/a", cuda, 80.0, 9.0),  # the span's annotation
        _Event("decodebench/b", cpu, 200.0),
        _Event("sample", cuda, 185.0, 2.0),
        _Event("decodebench/end", cpu, 300.0),
        _Event("pad", cuda, 290.0, 2.0),
    ]
    assert TD.attribute_kernels(events, TD.SPAN)[1] == {"a": 1, "b": 1}
    us, launches, skews = TD.attribute_by_gaps(events, TD.SPAN, 50.0)
    assert us == {"a": 6.0, "b": 2.0, "end": 2.0}
    assert launches == {"a": 2, "b": 1, "end": 1}
    assert skews == {"a": -20.0, "b": -15.0, "end": -10.0}
    # A part's work split by a longer idle than the gap: no grouping.
    assert TD.attribute_by_gaps(events, TD.SPAN, 0.5) is None


def test_teacher_forced_agreement_is_one_against_itself(params):
    _, tp = params
    prompt = np.random.default_rng(4).integers(1, VOCAB, (3, 6)).astype(
        np.int32)
    from tpu_dra_torch.workloads.generate import greedy_generate

    out = greedy_generate(TCFG, tp, prompt, 7, device="cpu")[:, 6:]
    assert TD.teacher_forced_agreement(TCFG, tp, prompt, out,
                                       device="cpu") == 1.0
    flipped = out.clone()
    flipped[0, 3] = (flipped[0, 3] + 1) % VOCAB
    assert TD.teacher_forced_agreement(
        TCFG, tp, prompt, flipped, device="cpu") < 1.0


def test_metrics_recorder_keeps_counters_gauge_peaks_observations():
    rec = TB.MetricsRecorder()
    rec.inc("a")
    rec.inc("a", 2.0)
    for v in (3.0, 1.0, 5.0, 0.0):
        rec.set_gauge("g", v)
    rec.observe("h", 0.5)
    rec.observe("h", 0.25)
    assert rec.counters == {"a": 3.0}
    assert rec.gauge_max == {"g": 5.0}
    assert rec.observed == {"h": [0.5, 0.25]}


MAINS = {
    "enginebench_smoke": (TB.main, ["--smoke"]),
    "enginebench_serve": (TB.main, ["--serve"]),
    "decodebench": (TD.main, []),
    "specbench": (TS.main, []),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_on_the_cpu(name, capsys, monkeypatch):
    for key in list(SERVE_ENV):
        monkeypatch.delenv(key, raising=False)
    main, argv = MAINS[name]
    assert main(argv + ["--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] is True and report["device"] == "cpu"


def test_mains_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (TB.main, TD.main, TS.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])
