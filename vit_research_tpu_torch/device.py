"""Device selection. Every entry point of the port takes an explicit
device; asking for CUDA where there is none is an error, never a silent
CPU run."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``'cuda'``, ``'cuda:N'``, ``'cpu'`` or a ``torch.device`` ->
    ``torch.device``. Raises RuntimeError for a CUDA device when CUDA is
    not available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False (no CUDA build or no card); pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
