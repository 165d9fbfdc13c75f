"""The port's slice bootstrap held to the JAX one: the driver-rendered env
parsed into the same fields, the coordinator resolved the same way, the
same mesh factorizations, the daemon's bootstrap.env read the same; and
a rendezvous whose peer never comes fails within
TPU_DRA_INIT_TIMEOUT_SECONDS."""

import json

import pytest
import torch

from tests.torch_ranks import free_port, launch, rank_env
from tpu_dra.computedomain.daemon import bootstrap as daemon
from tpu_dra.workloads import bootstrap as JB
from tpu_dra.workloads.parallel.mesh import MeshConfig as JaxMeshConfig
from tpu_dra_torch.workloads import bootstrap as TB
from tpu_dra_torch.workloads.train import MeshConfig

ENVS = [
    {},
    {
        "TPU_WORKER_ID": "3",
        "JAX_NUM_PROCESSES": "4",
        "JAX_COORDINATOR_ADDRESS": "compute-domain-daemon-0:8476",
        "TPU_ACCELERATOR_TYPE": "v5p-16",
        "MEGASCALE_NUM_SLICES": "2",
        "MEGASCALE_SLICE_ID": "1",
    },
    {"JAX_PROCESS_ID": "1", "JAX_NUM_PROCESSES": "2",
     "TPU_TOPOLOGY": "2x2x1"},
    {"TPU_WORKER_ID": "", "JAX_NUM_PROCESSES": "", "MEGASCALE_NUM_SLICES": ""},
]


@pytest.mark.parametrize("env", ENVS, ids=["empty", "multislice",
                                           "process_id", "blank"])
def test_bootstrap_env_parsing(env):
    want = JB.read_slice_env(env)
    got = TB.read_slice_env(env)
    assert vars(got) == vars(want)
    assert got.multi_host == want.multi_host
    if env.get("TPU_WORKER_ID") == "3":  # tests/test_workloads.py's case
        assert got.worker_id == 3 and got.num_processes == 4
        assert got.multi_host
        assert got.num_slices == 2 and got.slice_id == 1


def _peers(tmp_path, peers):
    (tmp_path / "peers.json").write_text(json.dumps(peers))
    return str(tmp_path)


@pytest.mark.parametrize("case", ["resolvable", "mapped", "unmapped",
                                  "missing_file", "bad_json", "no_port"])
def test_resolve_coordinator_matches_jax(tmp_path, case):
    name = "compute-domain-daemon-0.invalid"
    address = f"{name}:8476"
    cfg = str(tmp_path)
    if case == "resolvable":
        address = "127.0.0.1:8476"
    elif case == "mapped":
        cfg = _peers(tmp_path, [
            {"dnsName": "compute-domain-daemon-1.invalid",
             "ipAddress": "10.0.0.2"},
            {"dnsName": name, "ipAddress": "10.0.0.1"},
        ])
    elif case == "unmapped":
        cfg = _peers(tmp_path, [{"dnsName": name, "ipAddress": ""}])
    elif case == "bad_json":
        (tmp_path / "peers.json").write_text("{not json")
    elif case == "no_port":
        address = "8476"
    want = JB.resolve_coordinator(address, cfg)
    got = TB.resolve_coordinator(address, cfg)
    assert got == want
    expected = {"resolvable": "127.0.0.1:8476", "mapped": "10.0.0.1:8476",
                "no_port": "8476"}.get(case, address)
    assert got == expected


@pytest.mark.parametrize("n", range(1, 65))
def test_for_device_count_matches_jax(n):
    want = JaxMeshConfig.for_device_count(n)
    got = MeshConfig.for_device_count(n)
    assert (got.dp, got.fsdp, got.sp, got.tp, got.ep, got.pp) == (
        want.dp, want.fsdp, want.sp, want.tp, want.ep, want.pp)
    assert got.size == n


def test_for_device_count_refuses_zero():
    with pytest.raises(ValueError, match="at least one"):
        MeshConfig.for_device_count(0)


@pytest.mark.parametrize("procs,chips,slices,tp,sp", [
    (1, 1, 1, 1, 1), (4, 4, 1, 1, 1), (2, 4, 2, 2, 1), (4, 8, 2, 2, 2),
    (3, 4, 1, 3, 1),
])
def test_mesh_config_from_slice_env_matches_jax(procs, chips, slices, tp,
                                                 sp):
    env = {"JAX_NUM_PROCESSES": str(procs),
           "MEGASCALE_NUM_SLICES": str(slices)}
    want = JB.mesh_config_from_slice_env(JB.read_slice_env(env), chips,
                                         tp=tp, sp=sp)
    got = TB.mesh_config_from_slice_env(TB.read_slice_env(env), chips,
                                        tp=tp, sp=sp)
    assert isinstance(got, MeshConfig)
    assert (got.dp, got.fsdp, got.sp, got.tp) == (
        want.dp, want.fsdp, want.sp, want.tp)


def test_mesh_config_from_slice_env_refuses_what_does_not_factor():
    se = {"JAX_NUM_PROCESSES": "3"}
    with pytest.raises(ValueError, match="cannot factor") as jax_err:
        JB.mesh_config_from_slice_env(JB.read_slice_env(se), 1, tp=2)
    with pytest.raises(ValueError, match="cannot factor") as port_err:
        TB.mesh_config_from_slice_env(TB.read_slice_env(se), 1, tp=2)
    assert str(port_err.value) == str(jax_err.value)


def test_read_bootstrap_env_matches_the_daemon(tmp_path):
    peers = [{"index": 0, "nodeName": "n0", "ipAddress": "10.0.0.1"},
             {"index": 1, "nodeName": "n1", "ipAddress": "10.0.0.2"}]
    env = daemon.render_bootstrap_env(1, 4, "v5p-16", "2x2x2", peers,
                                      num_slices=2, slice_index=1,
                                      megascale_coordinator_ip="10.0.0.9")
    daemon.write_bootstrap_files(str(tmp_path), env, peers)
    (tmp_path / "bootstrap.env").write_text(
        (tmp_path / "bootstrap.env").read_text() + "\n  \nno_equals_sign\n")
    got = TB.read_bootstrap_env(str(tmp_path))
    assert got == daemon.read_bootstrap_env(str(tmp_path)) == env
    assert TB.read_bootstrap_env(str(tmp_path / "absent")) is None
    assert daemon.read_bootstrap_env(str(tmp_path / "absent")) is None
    se = TB.read_slice_env(got)
    assert vars(se) == vars(JB.read_slice_env(got))
    assert (se.worker_id, se.num_processes, se.num_slices) == (1, 2, 2)


def test_single_process_initialize_is_a_noop():
    import torch.distributed as dist

    se = TB.initialize_from_env({"JAX_NUM_PROCESSES": "1"}, device="cpu")
    assert not se.multi_host and not dist.is_initialized()
    with pytest.raises(ValueError, match="host:port"):
        TB.rendezvous("8476", 0, 2, device="cpu")
    with pytest.raises(ValueError, match="outside a world"):
        TB.rendezvous("127.0.0.1:8476", 2, 2, device="cpu")


def test_rendezvous_bound_leaves_the_collectives_torch_timeout():
    """The store's timeout bounds the rendezvous, then goes back to
    torch's default: the group reads the store at its first collectives
    (NCCL's communicator ids), long after a rendezvous bound has run."""
    import datetime

    import torch.distributed as dist

    TB.rendezvous(f"127.0.0.1:{free_port()}", 0, 1, device="cpu",
                  timeout_s=5)
    try:
        store = dist.distributed_c10d._get_default_store()
        while hasattr(store, "underlying_store"):
            store = store.underlying_store
        assert store.timeout == dist.constants.default_pg_timeout
        assert store.timeout > datetime.timedelta(seconds=5)
        x = torch.ones(1)
        dist.all_reduce(x)
        assert float(x[0]) == 1.0
    finally:
        TB.shutdown()
    assert TB.collective_timeout("gloo") == dist.constants.default_pg_timeout


def test_missing_peer_fails_the_rendezvous_within_its_timeout():
    """Two lone ranks of two 2-rank groups: rank 0, whose peer never
    starts, and rank 1, whose coordinator never starts. Each exits
    non-zero once TPU_DRA_INIT_TIMEOUT_SECONDS has passed."""
    timeout_s = 5
    argv = ["-m", "tpu_dra_torch.workloads.rendezvous_smoke",
            "--device", "cpu"]
    envs = [rank_env(r, 2, f"127.0.0.1:{free_port()}",
                     TPU_DRA_INIT_TIMEOUT_SECONDS=timeout_s)
            for r in (0, 1)]
    results = launch([argv, argv], envs, timeout=90)
    for rank, (rc, out, err, seconds) in enumerate(results):
        assert rc not in (0, None), (rank, rc, err[-2000:])
        assert "imed out" in err, err[-2000:]  # "Timed out" / "timed out"
        assert not out.strip()
        # The bound held: past the timeout, well short of torch's own.
        assert timeout_s <= seconds < timeout_s + 45, seconds
