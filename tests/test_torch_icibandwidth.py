"""The port's collective-bandwidth exerciser held to JAX's
(tests/test_icibandwidth.py): the one-rank HBM copy fallback, the four
legs over 2 gloo ranks with JAX's keys and bus-bandwidth algebra (the
factor each leg's busbw x seconds / S recovers equals the one JAX's legs
recover at the same n), and the CLI's threshold gate."""

import json

import pytest

jax = pytest.importorskip("jax")

from tests.torch_ranks import free_port, last_json, launch, rank_env  # noqa: E402
from tpu_dra.workloads import icibandwidth as JI  # noqa: E402
from tpu_dra_torch.workloads import icibandwidth as TI  # noqa: E402

LEGS = ("psum_allreduce", "all_gather", "reduce_scatter", "ppermute_ring")
SIZE_MB, REPS = 1.0, 3
SIZE_BYTES = int(SIZE_MB * 1024 * 1024)


def _factor(leg: dict) -> float:
    return leg["busbw_gbps"] * 1e9 * leg["seconds"] / SIZE_BYTES


def test_single_device_hbm_fallback():
    want = JI.measure_collectives(SIZE_MB, REPS, devices=jax.devices()[:1])
    got = TI.measure_collectives(SIZE_MB, REPS, device="cpu")
    assert set(got) == set(want)
    assert got["devices"] == 1
    assert got["payload_mb"] == SIZE_MB and got["reps"] == REPS
    assert set(got["hbm_copy"]) == set(want["hbm_copy"])
    assert got["hbm_copy"]["gbps"] > 0 and got["hbm_copy"]["seconds"] > 0
    assert got["hbm_copy"]["gbps"] == pytest.approx(
        2 * SIZE_BYTES / got["hbm_copy"]["seconds"] / 1e9)


def test_collectives_over_two_gloo_ranks_match_jax_algebra():
    n = 2
    want = JI.measure_collectives(SIZE_MB, REPS, devices=jax.devices()[:n])
    coordinator = f"127.0.0.1:{free_port()}"
    argv = ["-m", "tpu_dra_torch.workloads.icibandwidth", "--distributed",
            "--device", "cpu", "--size-mb", str(SIZE_MB), "--reps",
            str(REPS), "--min-gbps", "0"]
    results = launch([argv] * n,
                     [rank_env(r, n, coordinator) for r in range(n)],
                     timeout=120)
    for rank, (rc, out, err, _) in enumerate(results):
        assert rc == 0, (rank, rc, err[-3000:])
        assert "PASS" in err
        got = json.loads(last_json(out))
        assert set(got) == set(want)
        assert got["devices"] == want["devices"] == n
        for leg in LEGS:
            assert set(got[leg]) == set(want[leg])
            assert got[leg]["seconds"] > 0 and got[leg]["busbw_gbps"] > 0
            assert _factor(got[leg]) == pytest.approx(
                _factor(want[leg]), rel=1e-9), leg
    # The factors themselves: 2(n-1)/n, (n-1), (n-1)/n and 1 at n = 2.
    factors = {leg: _factor(want[leg]) for leg in LEGS}
    assert factors == pytest.approx(
        {"psum_allreduce": 1.0, "all_gather": 1.0, "reduce_scatter": 0.5,
         "ppermute_ring": 1.0}, rel=1e-9)


def test_cli_smoke_and_threshold_gate(capsys):
    args = ["--size-mb", "1", "--reps", "3", "--device", "cpu"]
    assert TI.main(args + ["--min-gbps", "0"]) == 0
    captured = capsys.readouterr()
    results = json.loads(captured.out.strip().splitlines()[-1])
    assert results["devices"] == 1 and "PASS" in captured.err
    # An impossibly high threshold must fail the probe. At 1 MB and 3
    # reps the CPU's differential timing (two ops of ~20 us) reaches the
    # 1e-9 s noise floor about one run in 30, which reads as a bandwidth
    # above any threshold; 4 MB and 10 reps give it nine ops of margin.
    assert TI.main(["--size-mb", "4", "--reps", "10", "--device", "cpu",
                    "--min-gbps", "1000000"]) == 1
    assert "FAIL hbm_copy" in capsys.readouterr().err
