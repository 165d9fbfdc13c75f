"""The port's fault drills (tpu_dra_torch/serving/faultbench.py) held
to the JAX bench's own runs (tpu_dra/serving/faultbench.py) on the CPU.

TINY_LLAMA at fp32, the flax weights converted in-process
(tests/torch_twin.py). Each drill runs three times on the same seeded
inputs: by the JAX bench (its own claim layer: a FakeCluster, the
published fleet and the scheduler's packer), by the port's over that
same claim layer (tests/torch_fabric_twin.py ``PackerLayer``), and by
the port's over its default ClaimStore. Every gate inside the drills
holds in each run; across the runs the test compares the completions
token for token, the lost and duplicated sequences, the autoscaler's
events as (kind, claim name), the claims created and deleted in order,
the deaths by reason and the open breaker keys.
"""

import pytest
import torch

jax = pytest.importorskip("jax")

from torch_fabric_twin import run_drill, snapshot  # noqa: E402
from torch_twin import JCFG, TCFG, make_params  # noqa: E402

DRILLS = ("crash_greedy", "crash_sampled", "crash_loop")
_JAX_RUNS = {}


@pytest.fixture(scope="module")
def params():
    return make_params()


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
        _JAX_RUNS[name] = (report, [snapshot(f) for f in built])
    return _JAX_RUNS[name]


@pytest.mark.parametrize("layer", ["packer", "store"])
@pytest.mark.parametrize("name", DRILLS)
def test_fault_drill_matches_jax(params, name, layer):
    want_report, want = _jax_run(name, params)
    report, built = run_drill(name, True, TCFG, params[1], layer=layer)
    got = [snapshot(f) for f in built]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"]
        assert g["events"] == w["events"]
        assert g["claims"] == w["claims"]
        assert g["open_breakers"] == w["open_breakers"]
        assert g["deaths"] == w["deaths"]
        assert g["duplicates_dropped"] == w["duplicates_dropped"] == 0
    if name == "crash_loop":
        for key in ("circuit_opens", "quarantined", "claims_replaced",
                    "rebinds", "deaths"):
            assert report[key] == want_report[key], key
    else:
        assert report["lost"] == want_report["lost"] == 0
        assert report["reasons"] == want_report["reasons"] == ["crash",
                                                               "stall"]
        assert report["identical"] and want_report["identical"]
