"""PyTorch/CUDA port of the ``tpu_dra`` workload payload.

The JAX package under ``tpu_dra/workloads/`` stays the reference; this
package mirrors its module paths (``tpu_dra_torch/workloads/...`` beside
``tpu_dra/workloads/...``) so each counterpart is easy to find. It
imports ``torch`` and numpy only — never ``jax``, ``flax`` or anything
under ``tpu_dra`` (tests/test_torch_isolation.py enforces it). The
kernels that the JAX package wrote in Pallas for the TPU are CUDA C++
for Hopper under ``csrc/``, built at first use by :mod:`.kernels`.
"""
