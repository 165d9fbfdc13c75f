"""Fused (chunked) next-token cross-entropy.

Counterpart of ``tpu_dra/workloads/ops/loss.py``. The materialised loss
keeps fp32 logits ``[b, s, vocab]`` alive through the backward pass
(2.1 GB at b=2, s=2048, vocab 128256); this computes the same
``mean(logsumexp(logits) - logits[target])`` over sequence chunks, each
under ``torch.utils.checkpoint`` so its ``[b, chunk, vocab]`` logits are
recomputed in the backward pass instead of kept.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _padded_len(seq: int, chunk: int) -> int:
    """seq rounded up to a whole number of chunks."""
    return ((seq + chunk - 1) // chunk) * chunk


def _chunk_loss(xk, k, tk, wk):
    # The unfused head's numerics: matmul in the compute dtype, softmax
    # statistics in fp32.
    logits = (xk @ k).to(torch.float32)  # [b, c, vocab]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tk[..., None])[..., 0]
    return torch.sum((lse - tgt) * wk)


def fused_next_token_xent(
    x: torch.Tensor, kernel: torch.Tensor, tokens: torch.Tensor,
    chunk: int = 256,
) -> torch.Tensor:
    """Mean next-token cross entropy without whole-sequence logits.

    x [b, s, d] final hidden states (compute dtype); kernel [d, vocab]
    the LM-head weight (from the parameter tree, so gradients reach it);
    tokens [b, s] int ids: position i is scored against tokens[i + 1],
    the last position is masked out. Uniform chunks of min(chunk, s):
    targets shift left with a zero-weighted last position, and the
    sequence pads with zero-weighted rows up to a whole number of
    chunks, as in JAX (no divisor search)."""
    b, s, d = x.shape
    if s < 2:
        raise ValueError(f"fused_next_token_xent needs seq >= 2, got {s}")
    c = min(chunk, s)
    padded = _padded_len(s, c)
    tokens = tokens.to(device=x.device, dtype=torch.long)
    targets = torch.cat(
        [tokens[:, 1:], tokens.new_zeros((b, 1 + padded - s))], dim=1
    )
    weights = torch.cat(
        [
            torch.ones((b, s - 1), dtype=torch.float32, device=x.device),
            torch.zeros((b, 1 + padded - s), dtype=torch.float32,
                        device=x.device),
        ],
        dim=1,
    )
    if padded != s:
        x = torch.cat([x, x.new_zeros((b, padded - s, d))], dim=1)
    k = kernel.to(x.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(padded // c):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(
            _chunk_loss, x[:, sl], k, targets[:, sl], weights[:, sl],
            use_reentrant=False,
        )
    return total / (b * (s - 1))
