"""The port's rendezvous workload held to JAX's
(tpu_dra/workloads/rendezvous_smoke.py): the same data-parallel step on
the same global batch gives JAX's losses, in one process and over 2 gloo
ranks bootstrapped from config dirs the slice daemon's own renderer
wrote; and ``train --distributed`` trains at world 1 and, on JAX's
default mesh (fsdp=2), at world 2."""

import ast
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tests.torch_ranks import free_port, last_json, launch, rank_env  # noqa: E402
from tpu_dra.computedomain.daemon.bootstrap import (  # noqa: E402
    render_bootstrap_env,
    write_bootstrap_files,
)
from tpu_dra.workloads import rendezvous_smoke as JR  # noqa: E402
from tpu_dra_torch.workloads import rendezvous_smoke as TR  # noqa: E402
from tpu_dra_torch.workloads import train as TT  # noqa: E402

BOOT_KEYS = ("TPU_WORKER_ID", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
             "JAX_COORDINATOR_ADDRESS", "CD_CONFIG_DIR",
             "MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID")


@pytest.fixture
def clean_env(monkeypatch):
    for k in BOOT_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _jax_step(rows: np.ndarray) -> tuple:
    """JAX's step (rendezvous_smoke.py :110-117) on one global batch."""
    x = jnp.asarray(rows)

    def loss_fn(w):
        return jnp.mean((x @ w) ** 2)

    w = jnp.ones((JR.FEATURE_DIM,), jnp.float32)
    loss, grad = jax.value_and_grad(loss_fn)(w)
    loss2 = loss_fn(w - 0.01 * grad)
    return float(loss), float(loss2)


def _rows(worker: int, n: int) -> np.ndarray:
    return np.stack([
        np.full((JR.FEATURE_DIM,), 1.0 + worker * 0.5 + i * 0.01, np.float32)
        for i in range(n)
    ])


def test_one_rank_matches_jax_on_the_same_global_batch(clean_env, capsys):
    """JAX over conftest's 8 CPU devices x 4 rows, the port at 1 rank x
    32 rows: the same 32 rows."""
    assert JR.main(["--rows-per-device", "4"]) == 0
    want = json.loads(last_json(capsys.readouterr().out))
    assert TR.main(["--rows-per-device", "32", "--device", "cpu"]) == 0
    got = json.loads(last_json(capsys.readouterr().out))
    assert set(got) == set(want)
    assert want["global_devices"] == 8 and got["global_devices"] == 1
    assert got["processes"] == want["processes"] == 1
    assert got["psum"] == want["psum"] == 1.0
    for key in ("loss", "loss_after_step"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    assert got["loss_after_step"] < got["loss"]
    assert (got["loss"], got["loss_after_step"]) == pytest.approx(
        _jax_step(_rows(0, 32)), rel=1e-6)


def test_missing_bootstrap_env_exits_2(clean_env, tmp_path, capsys):
    assert TR.main(["--config-dir", str(tmp_path), "--device", "cpu"]) == 2
    assert "no bootstrap.env" in capsys.readouterr().err


def test_two_ranks_from_daemon_rendered_dirs(tmp_path):
    """The coordinator is daemon-0's DNS name, which only the rendered
    peers.json maps (to 127.0.0.1)."""
    port = free_port()
    peers = [{"index": i, "nodeName": f"node-{i}", "ipAddress": "127.0.0.1",
              "status": "Ready"} for i in range(2)]
    dirs = []
    for i in range(2):
        env = render_bootstrap_env(i, 2, "v5litepod-8", "2x4", peers,
                                   coordinator_port=port)
        d = tmp_path / f"cd-{i}"
        write_bootstrap_files(str(d), env, peers)
        dirs.append(d)
    assert env["JAX_COORDINATOR_ADDRESS"] == f"compute-domain-daemon-0:{port}"
    argv = ["-m", "tpu_dra_torch.workloads.rendezvous_smoke", "--device",
            "cpu"]
    results = launch([argv + ["--config-dir", str(d)] for d in dirs],
                     [{}, {}], timeout=120)
    got = []
    for rank, (rc, out, err, _) in enumerate(results):
        assert rc == 0, (rank, rc, err[-3000:])
        got.append(json.loads(last_json(out)))
    assert sorted(r["worker"] for r in got) == [0, 1]
    for r in got:
        assert r["processes"] == 2 and r["global_devices"] == 2
        assert r["local_devices"] == 1
        assert r["psum"] == 3.0  # 2**0 + 2**1: both workers contributed
    assert got[0]["loss"] == got[1]["loss"]
    assert got[0]["loss_after_step"] == got[1]["loss_after_step"]
    want = _jax_step(np.concatenate([_rows(0, 4), _rows(1, 4)]))
    assert (got[0]["loss"], got[0]["loss_after_step"]) == pytest.approx(
        want, rel=1e-6)


def test_train_distributed_world_one_trains(clean_env, capsys):
    clean_env.setenv("JAX_NUM_PROCESSES", "1")
    assert TT.main(["--distributed", "--device", "cpu", "--steps", "2",
                    "--seq", "16"]) == 0
    assert "'ok': True" in capsys.readouterr().out


def test_train_distributed_world_two_reaches_the_parallel_refusal():
    """World two trains (the name is the one from before parallel
    training was ported): both ranks bootstrap, train one step on JAX's
    default mesh for 2 devices (fsdp=2) with its default batch of one
    row a shard, and print the same loss."""
    coordinator = f"127.0.0.1:{free_port()}"
    argv = ["-m", "tpu_dra_torch.workloads.train", "--distributed",
            "--device", "cpu", "--steps", "1", "--seq", "16"]
    results = launch([argv, argv],
                     [rank_env(r, 2, coordinator) for r in range(2)],
                     timeout=120)
    got = []
    for rank, (rc, out, err, _) in enumerate(results):
        assert rc == 0, (rank, rc, err[-3000:])
        assert "slice bootstrap: SliceEnv(worker_id=%d" % rank in err
        got.append(ast.literal_eval(last_json(out)))
    for r in got:
        assert r["ok"] and r["steps"] == 1 and r["device"] == "cpu"
        assert r["mesh"] == {"fsdp": 2} and r["batch"] == 2
    assert got[0]["loss"] == got[1]["loss"]
