"""Device resolution and the host boundary for the PyTorch port.

Every store, view and entry point of the port takes an explicit
``device``. The default is ``"cuda"``; asking for CUDA on a machine
without a usable card raises instead of quietly running on the CPU, so a
run that claims to have used the card always did.

A tensor on the ``meta`` device has a shape and a dtype but no data. The
dry-run (``launch/dryrun.py``) runs a step on meta tensors to count it;
within :func:`meta_as` a meta tensor stands for one on another device: the
dtype policy (``nn.layers.compute_dtype``, ``weight_dtype``) and the
kernel switch (``kernels.ops.wants_kernel``) read :func:`stands_for`, so
the counted step is the one that device would run.
"""
from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

# the device a meta tensor stands for (outside meta_as: the CPU)
_META_AS = contextvars.ContextVar("repro_torch_meta_as", default="cpu")


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


@contextlib.contextmanager
def meta_as(device):
    """Within this scope a ``meta`` tensor stands for a tensor on
    ``device`` ("cuda" or "cpu"): see :func:`stands_for`. No device is
    touched, so a card is not needed."""
    tok = _META_AS.set(torch.device(device).type)
    try:
        yield
    finally:
        _META_AS.reset(tok)


def stands_for(device) -> torch.device:
    """The device whose policy applies to ``device``: itself, or for
    ``meta`` the device of the enclosing :func:`meta_as` (the CPU
    outside one)."""
    dev = torch.device(device)
    return torch.device(_META_AS.get()) if dev.type == "meta" else dev
