"""The port's own copy of the ``jax.random`` functions the sampler uses.

``jax.random`` with its default implementation (``threefry2x32``,
``jax_threefry_partitionable`` on) is a pure function of a key and a
shape, and these functions reproduce its bits exactly:

- a key is two 32-bit words; :func:`prng_key` makes ``[0, seed]``;
- :func:`fold_in` is Threefry-2x32 of the counter pair ``(0, data)``;
- :func:`random_bits` is ``y0 ^ y1`` of Threefry-2x32 over the high and
  low words of each element's row-major index;
- :func:`uniform` puts 23 of those bits in the mantissa of a float in
  [1, 2), subtracts 1, scales and clamps, as ``jax.random.uniform``;
- :func:`gumbel` is ``-log(-log(u))`` (the "low" mode) and
  :func:`categorical` the Gumbel-max draw ``argmax(logits + gumbel)``.

Words are int64 tensors holding values in [0, 2**32) (torch has no
full uint32 arithmetic), masked after every operation, so the same code
runs on the CPU and on the card. :func:`threefry2x32` also takes plain
Python ints, which lets a host caller fold a key without a tensor.
Keys are tensors of shape ``[..., 2]`` and stay where they are made: no
function here reads a device value on the host.

The floats match bit for bit up to the ``log``: ``torch.log`` and XLA's
``log`` may differ in the last place, so a Gumbel value may differ by an
ulp, and a draw only where two candidates' perturbed scores tie to that
ulp. ``ops/sample.py`` holds the fused kernel these functions are the
plain version of.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# Threefry-2x32 (Salmon et al. 2011), 20 rounds, as jax.random uses it.
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KEY_PARITY = 0x1BD11BDA
# The smallest normal float32: jax.random.gumbel's uniform minval.
F32_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1) -> tuple:
    """Threefry-2x32 of the counter words (x0, x1) under the key words
    (k0, k1): JAX's ``threefry2x32_p``. Arguments are int64 tensors
    (broadcast together) or Python ints holding 32-bit values; returns
    the two output words."""
    k2 = k0 ^ k1 ^ KEY_PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def _words(key: torch.Tensor) -> tuple:
    key = torch.as_tensor(key)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is [..., 2] words, got {tuple(key.shape)}")
    key = key.to(torch.int64) & MASK32
    return key[..., 0], key[..., 1]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for an int32 seed: the words
    ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key [..., 2] with ``data`` (an int
    or an integer tensor broadcasting against the key's leading dims,
    taken mod 2**32) folded in."""
    k0, k1 = _words(key)
    d = torch.as_tensor(data, device=k0.device).to(torch.int64) & MASK32
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (32-bit, partitionable Threefry) for one key
    [2]: int64 values in [0, 2**32) of ``shape``."""
    k0, k1 = _words(key)
    if k0.dim():
        raise ValueError("random_bits takes one key of shape [2]")
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & MASK32)
    return (y0 ^ y1).reshape(shape)


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """The float32 in [0, 1) that jax.random.uniform makes of 32 random
    bits: the top 23 as the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as the FMA that XLA's
    compiled code contracts a float32 multiply and add into. The
    product is exact in float64; the sum is rounded to odd there (a
    TwoSum error moves an inexact even result one ulp towards it), and
    rounding that to float32 is then the correctly rounded result."""
    a = a.double()
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    c = c.double()
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    away = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + away, bits)
    return bits.view(torch.float64).to(torch.float32)


def uniform_from_bits(bits: torch.Tensor, minval: float = F32_TINY,
                      maxval: float = 1.0) -> torch.Tensor:
    """``floats * (maxval - minval) + minval`` clamped below at minval,
    in float32 with the multiply-add fused, as jax.random.uniform."""
    dev = bits.device
    lo = torch.full((), minval, dtype=torch.float32, device=dev)
    hi = torch.full((), maxval, dtype=torch.float32, device=dev)
    return torch.maximum(lo, fma_f32(bits_to_unit_float(bits), hi - lo, lo))


def uniform(key: torch.Tensor, shape, minval: float = F32_TINY,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return uniform_from_bits(random_bits(key, shape), minval, maxval)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(uniform_from_bits(bits)))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (mode "low")."""
    return gumbel_from_bits(random_bits(key, shape))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32
    logits: the argmax of logits plus Gumbel noise of the logits' whole
    shape under one key (ties to the lower index, as jnp.argmax)."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)


def perturbed_scores(logits: torch.Tensor, inv_temp: float,
                     noise: torch.Tensor) -> torch.Tensor:
    """``noise + logits * inv_temp`` as jitted XLA computes it when the
    scaling and the draw meet in one fusion (a full-vocab draw): one
    FMA, one rounding."""
    return fma_f32(logits, inv_temp, noise)
