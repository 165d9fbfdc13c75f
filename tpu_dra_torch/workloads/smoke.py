"""Collective, matmul and decode smokes: the quickstart workloads a claim
runs to show its devices work (the nvbandwidth/nbody pass-fail loads of
the reference driver).

Counterpart of ``tpu_dra/workloads/smoke.py``, with its names and keys.
``pmap_psum_smoke`` sums one value a rank over the process group
:mod:`.bootstrap` built (one rank a device), or over the one local
device when there is none.

``decode_smoke`` runs the port's ``greedy_generate`` on
:data:`SMOKE_LLAMA`, which is TINY_LLAMA (head dim 16), as JAX's
``decode_smoke`` runs it. On the card the smoke goes through
``csrc/decode.cu`` (every head dim that is a multiple of 16 up to 256)
and the fused decode MLP; ``config`` and ``params`` let a caller run
another config, or given weights.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from tpu_dra_torch.workloads.device import resolve_device, synchronize
from tpu_dra_torch.workloads.models.llama import TINY_LLAMA

SMOKE_LLAMA = TINY_LLAMA


def platform(device: torch.device) -> str:
    """JAX's platform name for a torch device."""
    return "gpu" if device.type == "cuda" else device.type


def group_device(device=None) -> torch.device:
    """The device a collective's tensors live on: the card for an NCCL
    process group, the CPU for a gloo one; without a group,
    :func:`.device.resolve_device` of ``device``."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    return resolve_device(device)


def pmap_psum_smoke(n_devices: int = 0, device=None) -> dict:
    """All-reduce across every rank (one device a rank); returns a
    pass/fail report. ``n_devices`` is 0 or the group's size."""
    dev = group_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = n_devices or world
    if n != world:
        raise ValueError(
            f"n_devices={n_devices}: one rank a device, and the group has "
            f"{world}"
        )
    x = torch.tensor([float(rank)], dtype=torch.float32, device=dev)
    if dist.is_initialized():
        dist.all_reduce(x)
    expected = float(sum(range(n)))
    got = float(x[0])  # a host read: waits for the collective
    return {
        "ok": got == expected,
        "devices": n,
        "platform": platform(dev),
        "expected": expected,
        "got": got,
    }


def matmul_smoke(size: int = 1024, device=None) -> dict:
    """One bf16 ``ones @ ones`` on the device (a library matmul: JAX's
    smoke runs it outside any kernel of its own too)."""
    dev = resolve_device(device)
    x = torch.ones((size, size), dtype=torch.bfloat16, device=dev)
    y = x @ x
    value = float(y[0, 0])
    ok = abs(value - size) <= 1e-2 * size
    return {"ok": ok, "size": size, "value": value}


def decode_smoke(
    batch: int = 2, prompt_len: int = 8, max_new_tokens: int = 16,
    device=None, params=None, config=None, return_tokens: bool = False,
):
    """The serving path on the device: prefill and KV-cache greedy decode
    (``generate.greedy_generate``) on a tiny model, timed on the second
    call. Pass = right shape, prompt preserved, ids in the vocab.
    ``config`` defaults to :data:`SMOKE_LLAMA`; ``params`` (a LlamaParams
    or a nested tree) to weights drawn from seed 0. With
    ``return_tokens`` returns ``(report, tokens)``, tokens [batch,
    prompt_len + max_new_tokens] on the host."""
    from tpu_dra_torch.workloads.generate import greedy_generate
    from tpu_dra_torch.workloads.models.llama import init_params

    config = config or SMOKE_LLAMA
    dev = resolve_device(device)
    if params is None:  # drawn on the host: the same weights on any device
        params = init_params(config, torch.Generator().manual_seed(0), "cpu")
        params.to(dev)
    prompt = torch.arange(prompt_len, dtype=torch.int32)[None].repeat(batch, 1)

    def run():
        return greedy_generate(config, params, prompt,
                               max_new_tokens=max_new_tokens, device=dev)

    run()
    synchronize(dev)
    t0 = time.monotonic()
    out = run()  # returned on the host: the copy waits for the device
    synchronize(dev)
    dt = time.monotonic() - t0
    last = int(out[0, -1])
    ok = (
        tuple(out.shape) == (batch, prompt_len + max_new_tokens)
        and bool(torch.equal(out[:, :prompt_len], prompt))
        and 0 <= last < config.vocab_size
    )
    report = {
        "ok": ok,
        "platform": platform(dev),
        "decode_tok_s": round(batch * max_new_tokens / dt, 1),
        "shape": list(out.shape),
    }
    return (report, out) if return_tokens else report


if __name__ == "__main__":
    print(pmap_psum_smoke())
    print(matmul_smoke())
    print(decode_smoke())
