"""The port's smokes held to JAX's (tests/test_workloads.py
test_smoke_workloads): the psum over 4 gloo ranks gives JAX's 4-device
report, the bf16 matmul JAX's value, and decode_smoke the tokens of
JAX's greedy_generate on the same weights (PRNGKey(0), converted), at
fp32, with the same report keys."""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tests.torch_ranks import free_port, last_json, launch  # noqa: E402
from tpu_dra.workloads import smoke as JS  # noqa: E402
from tpu_dra.workloads.generate import greedy_generate  # noqa: E402
from tpu_dra.workloads.models import llama as JL  # noqa: E402
from tpu_dra_torch.workloads import smoke as TS  # noqa: E402
from tpu_dra_torch.workloads.convert import params_from_numpy  # noqa: E402
from tpu_dra_torch.workloads.models import llama as TL  # noqa: E402

PSUM_RANK = """
import json, sys
from tpu_dra_torch.workloads import bootstrap, smoke
rank, world, coordinator = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
bootstrap.rendezvous(coordinator, rank, world, "cpu", 60)
try:
    print(json.dumps(smoke.pmap_psum_smoke()))
finally:
    bootstrap.shutdown()
"""


def test_pmap_psum_smoke_over_four_gloo_ranks_matches_jax():
    want = JS.pmap_psum_smoke(4)
    coordinator = f"127.0.0.1:{free_port()}"
    results = launch([["-c", PSUM_RANK, str(r), "4", coordinator]
                      for r in range(4)], [{}] * 4, timeout=120)
    for rank, (rc, out, err, _) in enumerate(results):
        assert rc == 0, (rank, rc, err[-3000:])
        got = json.loads(last_json(out))
        assert got["ok"] and want["ok"]
        assert got["devices"] == want["devices"] == 4
        assert got["expected"] == want["expected"] == 6.0
        assert got["got"] == want["got"] == 6.0
        assert got["platform"] == want["platform"] == "cpu"
        assert set(got) == set(want)


def test_pmap_psum_smoke_without_a_group():
    got = TS.pmap_psum_smoke(device="cpu")
    assert got == {"ok": True, "devices": 1, "platform": "cpu",
                   "expected": 0.0, "got": 0.0}
    with pytest.raises(ValueError, match="one rank a device"):
        TS.pmap_psum_smoke(4, device="cpu")


def test_matmul_smoke_matches_jax():
    want = JS.matmul_smoke(256)
    got = TS.matmul_smoke(256, device="cpu")
    assert got == want == {"ok": True, "size": 256, "value": 256.0}


@pytest.mark.parametrize("dim", [64, 256], ids=["tiny", "smoke_widths"])
def test_decode_smoke_tokens_identical_to_jax(dim):
    """JAX's decode_smoke weights (PRNGKey(0)) at fp32; dim 64 is
    TINY_LLAMA itself (the port's SMOKE_LLAMA), dim 256 a wider twin."""
    jcfg = dataclasses.replace(JL.TINY_LLAMA, dim=dim, dtype=jnp.float32,
                               param_dtype=jnp.float32)
    tcfg = dataclasses.replace(TS.SMOKE_LLAMA, dim=dim, dtype=torch.float32,
                               param_dtype=torch.float32)
    batch, prompt_len, new = 2, 8, 16
    jparams = JL.Llama(jcfg).init_params(jax.random.PRNGKey(0), batch=batch,
                                         seq=prompt_len)
    prompt = jnp.tile(jnp.arange(prompt_len, dtype=jnp.int32)[None],
                      (batch, 1))
    want = np.asarray(greedy_generate(jcfg, jparams, prompt,
                                      max_new_tokens=new))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                tcfg, device="cpu")
    report, tokens = TS.decode_smoke(batch, prompt_len, new, device="cpu",
                                     params=tparams, config=tcfg,
                                     return_tokens=True)
    np.testing.assert_array_equal(tokens.numpy(), want)
    assert report["ok"] and report["shape"] == [batch, prompt_len + new]
    assert report["platform"] == "cpu" and report["decode_tok_s"] > 0


def test_decode_smoke_default_has_jax_keys():
    want = JS.decode_smoke(max_new_tokens=4)
    got = TS.decode_smoke(max_new_tokens=4, device="cpu")
    assert set(got) == set(want)
    assert got["ok"] and want["ok"]
    assert got["shape"] == want["shape"] == [2, 12]
    assert TS.SMOKE_LLAMA == TL.TINY_LLAMA  # JAX's decode_smoke model
