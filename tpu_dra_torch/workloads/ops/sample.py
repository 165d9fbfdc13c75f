"""The fused temperature / top-k pick: logits rows -> sampled token ids.

No Pallas kernel stands behind it: on the JAX side ``sample_token``
(``tpu_dra/workloads/generate.py``) runs inside the jitted step as one
XLA fusion. Here the same function, with ``jax.random``'s bits, is
``csrc/sample.cu``: per row, the scores ``logits * f32(1/temperature)``,
the ``top_k`` candidates in ``lax.top_k`` order (or the whole row when
``top_k == 0``), Gumbel noise from Threefry-2x32 and the argmax of noise
plus score, in one launch with no value read back to the host.

Rounding, as JAX's compiled sampler (the engine's decode step and
verify pass, ``sample_generate``'s scan steps) does it on the CPU:

- XLA rewrites ``logits / temperature`` into a product with the float32
  reciprocal of the (static) temperature; the port multiplies everywhere
  (:func:`inv_temperature`);
- with ``top_k > 0`` the candidates are rounded scores and the draw adds
  the noise to them; with ``top_k == 0`` XLA fuses the scaling into the
  draw, and ``noise + logits * inv`` is one FMA
  (``sampling.perturbed_scores``; ``fmaf`` in the kernel).

JAX's eager calls (the engine's first-token pick, the unfused generate
loop) divide and round the scores first, which can move a perturbed
score by an ulp.

Keys (``sampling.py`` holds the plain functions):

- **rows** — ``seed`` (an int32 device scalar), ``serials`` [R / S] and
  ``positions`` [R] (int32 device tensors): row r's key is
  ``fold_in(fold_in(PRNGKey(seed), serials[r // S]), positions[r])`` and
  its candidate j draws counter j. The engine's picks:
  ``_pick_tokens`` (S = 1) and the verify pass's ``_pick_tokens_batched``
  (S = positions per sequence), as JAX's ``vmap`` of ``sample_token``
  over one-row blocks.
- **block** — one ``key`` [2] (int64 words on the device) for all rows,
  folded with the host int ``fold`` when given; candidate j of row r
  draws counter ``r * n_cand + j``: ``sample_token(logits,
  fold_in(rng, i))`` over a [b, vocab] block, as ``sample_generate``.

``impl="auto"`` launches the kernel for CUDA tensors and takes the plain
version (``"torch"``) for CPU tensors; a CUDA tensor never falls back.
``kernels.LAUNCHES["sample_pick"]`` counts the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_dra_torch import kernels
from tpu_dra_torch.workloads import sampling

_LAST_SAMPLE_IMPL = None

# csrc/sample.cu kMaxK: the candidates of a row sort in shared memory.
MAX_TOP_K = 1024

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    + [ctypes.c_uint, ctypes.c_int] + [ctypes.c_void_p] * 4
)
_ROWS, _BLOCK = 0, 1


def inv_temperature(temperature: float) -> float:
    """float32(1) / float32(temperature), as a Python float holding that
    float32 exactly: the factor XLA's compiled sampler multiplies by."""
    return float(np.float32(1.0) / np.float32(temperature))


def topk_exact(x: torch.Tensor, k: int) -> tuple:
    """``lax.top_k`` semantics over the last axis: values [.., k]
    descending, ties to the lower index, with their indices. A stable
    descending sort (``torch.topk`` orders ties in no promised way)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _check_layout(logits, key, seed, serials, positions, rows_per_serial):
    rows = logits.shape[0]
    if key is not None:
        if seed is not None or serials is not None or positions is not None:
            raise ValueError("give key (block layout) or seed, serials and "
                             "positions (rows layout), not both")
        if tuple(key.shape) != (2,):
            raise ValueError(f"key is 2 words, got {tuple(key.shape)}")
        return _BLOCK
    if seed is None or serials is None or positions is None:
        raise ValueError("sample_pick needs key, or seed, serials and "
                         "positions")
    if rows_per_serial < 1 or tuple(positions.shape) != (rows,) or (
        serials.numel() * rows_per_serial != rows
    ):
        raise ValueError(
            f"rows layout: positions {tuple(positions.shape)}, serials "
            f"{tuple(serials.shape)} x {rows_per_serial} for {rows} rows"
        )
    return _ROWS


def _torch_pick(logits, inv_t, top_k, mode, key, fold, seed, serials,
                positions, rows_per_serial):
    """The plain version: sampling.py's jax.random twins and
    :func:`topk_exact`. Returns (ids int32 [R], candidate values,
    candidate indices)."""
    scaled = logits.float() * inv_t
    if top_k:
        cand, idx = topk_exact(scaled, top_k)
    else:
        cand, idx = scaled, None
    rows, n = cand.shape
    if mode == _BLOCK:
        if fold is not None:
            key = sampling.fold_in(key, fold)
        bits = sampling.random_bits(key, (rows, n))
    else:
        seed64 = seed.reshape(()).to(torch.int64)
        base = torch.stack([torch.zeros_like(seed64), seed64])
        per_row = serials.reshape(-1).to(torch.int64).repeat_interleave(
            rows_per_serial)
        keys = sampling.fold_in(sampling.fold_in(base, per_row), positions)
        j = torch.arange(n, dtype=torch.int64, device=cand.device)
        y0, y1 = sampling.threefry2x32(
            keys[:, :1], keys[:, 1:], torch.zeros_like(j), j)
        bits = y0 ^ y1
    noise = sampling.gumbel_from_bits(bits)
    if top_k:
        scores = noise + cand
    else:
        scores = sampling.perturbed_scores(logits.float(), inv_t, noise)
    choice = torch.argmax(scores, dim=-1)
    ids = choice if idx is None else torch.gather(idx, 1, choice[:, None])[:, 0]
    return ids.to(torch.int32), (cand if top_k else None), idx


def _cuda_pick(logits, inv_t, top_k, mode, key, fold, seed, serials,
               positions, rows_per_serial, candidates):
    rows, n = logits.shape
    dev = logits.device
    if not logits.is_cuda:
        raise ValueError("impl='cuda' needs CUDA logits")
    if logits.dtype != torch.float32 or logits.stride(-1) != 1:
        raise ValueError(
            "impl='cuda' takes float32 logits with unit stride along the "
            f"vocab, got {logits.dtype} strides {logits.stride()}"
        )
    if top_k > MAX_TOP_K:
        raise ValueError(
            f"impl='cuda' takes top_k <= {MAX_TOP_K}, got {top_k}"
        )
    ints = (seed, serials, positions) if mode == _ROWS else ()
    for t in ints:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("seed, serials and positions must be "
                             "contiguous int32 tensors")
    if mode == _BLOCK and key.dtype != torch.int64:
        raise ValueError(f"key words are int64, got {key.dtype}")
    if not all(t.is_cuda and t.device == dev
               for t in ints + ((key,) if mode == _BLOCK else ())):
        raise ValueError("impl='cuda' needs every input on the logits' "
                         "CUDA device")
    out = torch.empty((rows,), dtype=torch.int32, device=dev)
    vals = idx = None
    if candidates and top_k:
        vals = torch.empty((rows, top_k), dtype=torch.float32, device=dev)
        idx = torch.empty((rows, top_k), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = kernels.function("sample.cu", "tpu_sample_pick", _ARGTYPES)
    err = fn(
        logits.data_ptr(), logits.stride(0) if rows > 1 else n, rows, n,
        top_k, inv_t, mode, ptr(seed), ptr(serials), rows_per_serial,
        ptr(positions), ptr(key),
        0 if fold is None else int(fold) & sampling.MASK32,
        int(fold is not None), out.data_ptr(), ptr(vals), ptr(idx),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(err, "sample_pick")
    kernels.LAUNCHES["sample_pick"] += 1
    return out, vals, idx


def sample_pick(
    logits: torch.Tensor,
    temperature: float,
    top_k: int,
    *,
    key: "torch.Tensor | None" = None,
    fold: "int | None" = None,
    seed: "torch.Tensor | None" = None,
    serials: "torch.Tensor | None" = None,
    positions: "torch.Tensor | None" = None,
    rows_per_serial: int = 1,
    impl: str = "auto",
    candidates: bool = False,
):
    """Sampled token ids (int32 [R]) of fp32 ``logits`` [R, vocab] at
    ``temperature`` > 0 over the ``top_k`` best (0: the whole row), with
    the block layout (``key``, ``fold``) or the rows layout (``seed``,
    ``serials``, ``positions``, ``rows_per_serial``) of keys; see the
    module doc. With ``candidates`` also returns the top-k values and
    indices the draw ran over (None for ``top_k == 0``). impl: "auto" |
    "cuda" | "torch"."""
    if logits.dim() != 2:
        raise ValueError(f"logits are [rows, vocab], got {tuple(logits.shape)}")
    if not temperature > 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if not 0 <= top_k <= logits.shape[1]:
        raise ValueError(
            f"top_k={top_k} out of range for vocab {logits.shape[1]}"
        )
    mode = _check_layout(logits, key, seed, serials, positions,
                         rows_per_serial)
    if impl == "auto":
        impl = "cuda" if logits.is_cuda else "torch"
    global _LAST_SAMPLE_IMPL
    _LAST_SAMPLE_IMPL = impl
    args = (logits, inv_temperature(temperature), top_k, mode, key, fold,
            seed, serials, positions, rows_per_serial)
    if impl == "cuda":
        ids, vals, idx = _cuda_pick(*args, candidates)
    elif impl == "torch":
        ids, vals, idx = _torch_pick(*args)
    else:
        raise ValueError(f"unknown sample_pick impl: {impl!r}")
    if candidates:
        return ids, vals, (None if idx is None else idx.to(torch.int32))
    return ids
