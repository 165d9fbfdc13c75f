"""Model configurations, parameter trees and the model builder."""

from tpu_dra_torch.workloads.models.llama import (  # noqa: F401
    LLAMA3_8B,
    TINY_LLAMA,
    Llama,
    LlamaConfig,
)


def build_model(config):
    """Model instance for a family config (counterpart of the JAX
    ``build_model``): a stateless :class:`Llama` that takes its weights
    per call. Mixtral is not ported yet."""
    if type(config).__name__ == "MixtralConfig":
        raise NotImplementedError(
            "Mixtral is not ported yet: ROADMAP Queue A item 10 (Mixtral)"
        )
    if isinstance(config, LlamaConfig):
        return Llama(config)
    raise TypeError(f"unknown model config type: {type(config).__name__}")
