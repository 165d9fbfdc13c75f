"""Decode-path ops: each holds a CUDA kernel wrapper beside its plain
PyTorch twin of the JAX package's op."""
