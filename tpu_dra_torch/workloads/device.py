"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises RuntimeError when the card is
    asked for and no CUDA device exists — never a quiet CPU run."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_dra_torch runs on the CUDA device by default and none is "
            "available; pass device='cpu' for the plain PyTorch path"
        )
    return device


def synchronize(device) -> None:
    """Wait until the work queued on ``device`` has run (a CPU tensor's
    work has run when its call returns)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
