"""Model configurations, parameter trees and the model builder."""

from tpu_dra_torch.workloads.models.llama import (  # noqa: F401
    LLAMA3_8B,
    TINY_LLAMA,
    Llama,
    LlamaConfig,
)
from tpu_dra_torch.workloads.models.mixtral import (  # noqa: F401
    MIXTRAL_8X7B,
    TINY_MIXTRAL,
    Mixtral,
    MixtralConfig,
)


def build_model(config):
    """Model instance for a family config (LlamaConfig | MixtralConfig;
    counterpart of the JAX ``build_model``): a stateless module that
    takes its weights per call."""
    if isinstance(config, MixtralConfig):
        return Mixtral(config)
    if isinstance(config, LlamaConfig):
        return Llama(config)
    raise TypeError(f"unknown model config type: {type(config).__name__}")
