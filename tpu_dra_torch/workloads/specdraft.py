"""Draft-token proposers for speculative decoding.

A copy of ``tpu_dra/workloads/specdraft.py`` (framework-free; the port
imports nothing of the JAX package). The serving engine's speculative
path (``EngineConfig.spec_k``, workloads/engine.py) asks a
:class:`DraftSource` for up to K cheap guesses of the next tokens,
writes their K/V into the sequence's pages, and verifies all K+1
positions in one pass against the paged cache — accepted guesses cost
one model pass for many tokens, rejected ones are rewound host-side.
The proposer is a protocol, not a model: the built-in
:class:`NgramDraft` is the prompt-lookup scheme (find the most recent
prior occurrence of the trailing n-gram in the sequence's own history
and propose what followed it), and a draft-model proposer can slot in
behind the same two-method surface without touching the engine.

Exactness contract: a proposer can only affect speed, never tokens.
The engine's acceptance rule replays the exact (seed, serial, position)
pick schedule the per-token path uses, so a wrong draft is rejected and
corrected in the same step (tests/test_torch_spec.py pins it with an
adversarial proposer).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class DraftSource(Protocol):
    """Anything that can guess a sequence's next tokens.

    ``propose(history, k)`` receives the sequence's FULL token history
    (prompt + every emitted token, host-side int32) and returns up to
    ``k`` draft tokens (possibly zero — an empty array means "no guess
    this step", which costs nothing: the verify pass still emits one
    real token). Called on the engine's host thread between chunks; it
    must not touch the device.
    """

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        ...


class NgramDraft:
    """Prompt-lookup proposer: the most recent earlier occurrence of
    the trailing ``order``-gram predicts what comes next.

    Falls back through shorter orders (order, order-1, ..., 1) until a
    match exists; proposes the k tokens that followed the match (capped
    by what the history holds). O(len(history) * order) vectorized
    numpy per call — host-side noise next to a model pass.
    """

    def __init__(self, order: int = 3):
        if order < 1:
            raise ValueError(f"ngram order must be >= 1, got {order}")
        self.order = order

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        history = np.asarray(history, np.int32)
        L = len(history)
        empty = np.zeros(0, np.int32)
        if k < 1 or L < 2:
            return empty
        for n in range(min(self.order, L - 1), 0, -1):
            needle = history[L - n:]
            # Candidate starts i with i + n < L: the trailing needle
            # itself (i == L - n) is excluded — matching it would
            # propose nothing new.
            windows = np.lib.stride_tricks.sliding_window_view(
                history[: L - 1], n
            )  # starts 0 .. L-1-n
            hits = np.flatnonzero(np.all(windows == needle, axis=1))
            if hits.size == 0:
                continue
            start = int(hits[-1]) + n  # most recent occurrence
            out = history[start: start + k]
            if out.size:
                return out.astype(np.int32)
        return empty


class StaticDraft:
    """Test/drill proposer: replays a fixed token sequence (or nothing)
    regardless of history — the adversarial 'always wrong' and 'always
    right' corners of the acceptance sampler are pinned with it."""

    def __init__(self, tokens):
        self.tokens = np.asarray(tokens, np.int32)

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        return self.tokens[:k]
