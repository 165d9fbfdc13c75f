"""Ring and Ulysses attention over gloo ranks on the CPU, held to JAX's
``ring_attention`` / ``ulysses_attention`` on conftest's 8 CPU devices,
on the same numpy inputs (tests/torch_seqpar_rank.py): the cases of
tests/test_workloads.py :74, :87 and :224-289 at their rtol 2e-4 and
atol 2e-5 (one launch of 8 ranks), and the ring's flash path with
gradients of tests/test_flash_attention.py :150 (4 ranks, s=512, hd
64, JAX's Pallas kernels in interpret mode; atol/rtol 1e-3 on dq, dk,
dv), with a spy in every rank asserting that
``flash_attention_with_lse`` ran. Without a mesh both fall back to
single-device attention, as in JAX."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from tests import torch_seqpar_rank as RK  # noqa: E402
from tests.torch_ranks import free_port, last_json, rank_env, start, wait  # noqa: E402
from tpu_dra.workloads.ops import attention as JA  # noqa: E402
from tpu_dra.workloads.parallel import mesh as JM  # noqa: E402
from tpu_dra.workloads.parallel import ring_attention as JR  # noqa: E402
from tpu_dra.workloads.parallel import ulysses as JU  # noqa: E402
from tpu_dra.workloads.parallel.context import set_global_mesh as jax_mesh  # noqa: E402
from tpu_dra_torch.workloads.ops.attention import attention  # noqa: E402
from tpu_dra_torch.workloads.parallel import ring_attention as TR  # noqa: E402
from tpu_dra_torch.workloads.parallel import ulysses as TU  # noqa: E402
from tpu_dra_torch.workloads.parallel.context import set_global_mesh  # noqa: E402

LAUNCHES = {
    8: ["ring_ref", "ring_gqa", "ulysses_ref", "ulysses_gqa",
        "ulysses_unrepeated"],
    4: ["ring_flash"],
}
TIMEOUT_S = 300  # a launch; only a hang reaches it


@pytest.fixture(autouse=True)
def clear_meshes():
    jax_mesh(None)
    set_global_mesh(None)
    yield
    jax_mesh(None)
    set_global_mesh(None)


class Launches:
    """Both launches, started together when the module's first test
    asks; ``[world]`` waits for one (after the caller's JAX work, so the
    two overlap) and gives each rank's result."""

    def __init__(self):
        self.started, self.results = {}, {}
        for world, cases in LAUNCHES.items():
            coordinator = f"127.0.0.1:{free_port()}"
            self.started[world] = start(
                [["tests/torch_seqpar_rank.py", *cases]] * world,
                [rank_env(r, world, coordinator) for r in range(world)])

    def __getitem__(self, world: int) -> list:
        if world not in self.results:
            out = []
            for rank, (rc, so, se, _) in enumerate(
                    wait(self.started[world], TIMEOUT_S)):
                assert rc == 0, (world, rank, rc, se[-3000:])
                out.append(json.loads(last_json(so)))
            self.results[world] = out
        return self.results[world]

    def close(self):
        for world in LAUNCHES:
            if world not in self.results:
                wait(self.started[world], 0)


@pytest.fixture(scope="module")
def ranks():
    launches = Launches()
    yield launches
    launches.close()


def _assemble(results: list, case: str, key: str, shape: tuple) -> np.ndarray:
    """The global array from every rank's block (rows, chunk)."""
    full = np.full(shape, np.nan, dtype=np.float32)
    for r in results:
        res = r[case]
        (r0, r1), (c0, c1) = res["rows"], res["chunk"]
        full[r0:r1, c0:c1] = np.array(res[key], dtype=np.float32)
    assert not np.isnan(full).any()
    return full


def _jax_out(case: RK.Case, x: dict) -> np.ndarray:
    mc = {"dp": 1, "fsdp": 1, "sp": 1, "tp": 1, **case.mesh}
    jax_mesh(JM.build_mesh(JM.MeshConfig(**mc)))
    fn = JR.ring_attention if case.impl == "ring" else JU.ulysses_attention
    return np.asarray(fn(jnp.asarray(x["q"]), jnp.asarray(x["k"]),
                         jnp.asarray(x["v"])))


@pytest.mark.parametrize("name", LAUNCHES[8])
def test_matches_jax_over_eight_ranks(ranks, name):
    case = RK.CASES[name]
    x = RK.inputs(case)
    want = _jax_out(case, x)
    got = _assemble(ranks[8], name, "out", x["q"].shape)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # TINY's hd 8 takes the plain online softmax, as in JAX.
    assert all(r[name]["flash_calls"] == 0 for r in ranks[8])
    kinds = {k.split(":")[0] for r in ranks[8] for k in r[name]["collectives"]}
    assert kinds == ({"ppermute"} if case.impl == "ring" else {"all_to_all"})


def test_ulysses_refuses_heads_that_do_not_split(ranks):
    for r in ranks[8]:
        assert "divisible" in r["ulysses_error"]
        assert "n_heads (6)" in r["ulysses_error"]


def test_ring_flash_path_and_gradients(ranks, monkeypatch):
    case = RK.CASES["ring_flash"]
    x = RK.inputs(case)
    monkeypatch.setattr(JA, "_INTERPRET", True)
    with jax.default_matmul_precision("highest"):
        mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
        with mesh:
            jax_mesh(mesh)
            out_j, vjp = jax.vjp(
                lambda q, k, v: JR.ring_attention(q, k, v, mesh=mesh),
                *(jnp.asarray(x[n]) for n in "qkv"))
            grads_j = vjp(jnp.asarray(x["g"]))
    results = ranks[4]
    np.testing.assert_allclose(
        _assemble(results, "ring_flash", "out", x["q"].shape),
        np.asarray(out_j), rtol=2e-5, atol=2e-5)
    for name, want in zip("qkv", grads_j):
        got = _assemble(results, "ring_flash", f"d{name}", x[name].shape)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3,
                                   atol=1e-3, err_msg=f"d{name}")
    # Rank i runs its diagonal and i full chunks through the flash path.
    assert [r["ring_flash"]["flash_calls"] for r in results] == [1, 2, 3, 4]


@pytest.mark.parametrize("fn,jfn", [(TR.ring_attention, JR.ring_attention),
                                    (TU.ulysses_attention,
                                     JU.ulysses_attention)])
@pytest.mark.parametrize("hd", [4, 16])
def test_falls_back_without_mesh(fn, jfn, hd):
    """JAX's tests/test_workloads.py :96 and :257 (hd 4, JAX's XLA path;
    the port's reference) and hd 16 (the flash path)."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 8, 2, hd)).astype(np.float32)
               for _ in range(3))
    got = fn(*(torch.from_numpy(t) for t in (q, k, v)))
    assert got.shape == (1, 8, 2, hd)
    want = attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=True,
                     impl="auto" if hd == 16 else "reference")
    assert torch.equal(got, want)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jfn(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))), rtol=2e-5, atol=2e-6)
