"""Device resolution and the host boundary for the PyTorch port.

Every store, view and entry point of the port takes an explicit
``device``. The default is ``"cuda"``; asking for CUDA on a machine
without a usable card raises instead of quietly running on the CPU, so a
run that claims to have used the card always did.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` when it
    names CUDA and no CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host")
    return dev


def to_host(x) -> np.ndarray:
    """NumPy copy of a tensor on any device (NumPy input passes through):
    the one place results cross from the device to the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        # a CPU tensor's .numpy() shares its memory: copy, as the device
        # path's .cpu() does, so the host array never aliases the tensor
        return x.numpy().copy() if x.device.type == "cpu" else x.cpu().numpy()
    return np.asarray(x)
