"""One gloo rank of the sequence-parallel attention twins
(tests/test_torch_seqpar.py).

Run as ``python tests/torch_seqpar_rank.py CASE [CASE ...]`` in the env
the slice daemon renders (tests/torch_ranks.py ``rank_env``): for each
case it builds the case's mesh, takes this rank's block of the case's
inputs (its ``(dp, fsdp)`` rows and ``sp`` chunk; ``inputs`` makes them
from a seed, so the parent feeds JAX the same), runs the port's ring or
Ulysses attention and prints one JSON line: the local output, and for a
case with a cotangent the local dq, dk and dv and how often
``flash_attention_with_lse`` ran. No JAX import: the ranks are the
port's.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@dataclasses.dataclass(frozen=True)
class Case:
    impl: str  # "ring" | "ulysses"
    mesh: dict
    shape: tuple  # b, s, h, kvh, hd
    seed: int
    grad: bool = False


CASES = {
    # tests/test_workloads.py :74, :87, :224, :238, :274.
    "ring_ref": Case("ring", dict(sp=8), (2, 32, 4, 4, 8), 7),
    "ring_gqa": Case("ring", dict(sp=8), (1, 16, 4, 2, 8), 0),
    "ulysses_ref": Case("ulysses", dict(sp=8), (2, 32, 8, 8, 8), 3),
    "ulysses_gqa": Case("ulysses", dict(sp=8), (1, 16, 8, 2, 8), 0),
    "ulysses_unrepeated": Case("ulysses", dict(fsdp=2, sp=4),
                               (2, 16, 8, 4, 8), 10),
    # tests/test_flash_attention.py :150: the ring's flash path, 4 ranks,
    # 4 chunks of 128, hd 64, with gradients.
    "ring_flash": Case("ring", dict(sp=4), (1, 512, 4, 2, 64), 0,
                       grad=True),
}


def inputs(case: Case) -> dict:
    """q, k, v (and a cotangent g) of a case, float32 numpy."""
    b, s, h, kvh, hd = case.shape
    rng = np.random.default_rng(case.seed)
    out = {"q": rng.standard_normal((b, s, h, hd)),
           "k": rng.standard_normal((b, s, kvh, hd)),
           "v": rng.standard_normal((b, s, kvh, hd))}
    if case.grad:
        out["g"] = rng.standard_normal((b, s, h, hd))
    return {k: v.astype(np.float32) for k, v in out.items()}


def run_case(case: Case) -> dict:
    import torch

    from tpu_dra_torch.workloads.parallel import mesh as M
    from tpu_dra_torch.workloads.parallel import ring_attention as R
    from tpu_dra_torch.workloads.parallel.ulysses import ulysses_attention

    mesh = M.build_mesh(M.MeshConfig(**case.mesh), device="cpu")
    r0, r1 = mesh.block(case.shape[0], M.BATCH_AXES)
    c0, c1 = mesh.block(case.shape[1], "sp")
    local = {k: torch.from_numpy(v[r0:r1, c0:c1]).requires_grad_(case.grad)
             for k, v in inputs(case).items()}
    calls = {"n": 0}
    real = R.flash_attention_with_lse

    def spy(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    R.flash_attention_with_lse = spy
    try:
        fn = R.ring_attention if case.impl == "ring" else ulysses_attention
        out = fn(local["q"], local["k"], local["v"], mesh=mesh)
    finally:
        R.flash_attention_with_lse = real
    res = {"rows": [r0, r1], "chunk": [c0, c1], "out": out.tolist(),
           "flash_calls": calls["n"], "collectives": dict(mesh.collectives)}
    if case.grad:
        out.backward(local["g"])
        res.update({f"d{n}": local[n].grad.tolist() for n in "qkv"})
    return res


def main(argv) -> int:
    import torch

    from tpu_dra_torch.workloads.bootstrap import initialize_from_env, shutdown
    from tpu_dra_torch.workloads.parallel import mesh as M
    from tpu_dra_torch.workloads.parallel.ulysses import ulysses_attention

    se = initialize_from_env(device="cpu")
    out = {"rank": se.worker_id}
    try:
        for name in argv:
            out[name] = run_case(CASES[name])
            if name == "ulysses_gqa":
                # heads not divisible by sp: a loud error, as in JAX.
                bad = torch.zeros((1, 2, 6, 8))
                try:
                    ulysses_attention(bad, bad, bad, mesh=M.build_mesh(
                        M.MeshConfig(sp=8), device="cpu"))
                    out["ulysses_error"] = None
                except ValueError as e:
                    out["ulysses_error"] = str(e)
    finally:
        shutdown()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
