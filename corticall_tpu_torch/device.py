"""Device choice for the port: the CUDA card unless the caller asks for the CPU.

An entry point given `device=None` runs on the card and raises when none is
visible; only an explicit "cpu" (or `torch.device("cpu")`) runs the plain
PyTorch twins.  On a CUDA device every kernel wrapper launches its kernel or
raises.  Nothing here falls back silently.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """An explicit device (str or torch.device), or the CUDA device when
    `device` is None (RuntimeError when no card is visible)."""
    return require_cuda() if device is None else torch.device(device)


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("corticall_tpu_torch: no CUDA device is available; "
                           "pass device='cpu' to run the plain twins")
    return torch.device("cuda")
