"""Device choice for the port: CUDA when a card is present, else the CPU.

On the CPU every kernel wrapper runs its plain PyTorch twin; on a CUDA device
it launches its kernel or raises.  Nothing here falls back silently.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """`cuda` when a card is visible, else `cpu`."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve(device=None) -> torch.device:
    """An explicit device (str or torch.device), or the default one."""
    return default_device() if device is None else torch.device(device)


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("corticall_tpu_torch: no CUDA device is available")
    return torch.device("cuda")
