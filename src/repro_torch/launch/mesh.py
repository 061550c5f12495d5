"""Meshes for the port; the counterpart of ``repro/launch/mesh.py``.

A :class:`Mesh` is a record of axis names, their sizes and the devices
laid on them. The reference builds JAX meshes of 256 or 512 TPU chips; the
port runs on one H100, so its production meshes are *declared*: they carry
the axis sizes the sharding rules and the dry-run read, and no devices.
:func:`make_local_mesh` lays the cards of this machine (or the CPU) on the
``data`` axis. There is no ``torch.distributed`` here and no process group.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    # the devices in row-major order over ``shape``; empty when declared
    devices: tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} vs shape {self.shape}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, declared: (16, 16) ``("data",
    "model")``, or (2, 16, 16) ``("pod", "data", "model")``. It has no
    devices; the dry-run reads only its axis sizes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_local_mesh(device="cuda") -> Mesh:
    """(n, 1) ``("data", "model")`` over this machine's n cards, or (1, 1)
    over the CPU with ``device="cpu"``. Raises ``RuntimeError`` on a
    ``cuda`` request without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    else:
        devs = (dev,)
    return Mesh(("data", "model"), (len(devs), 1), devs)


def one_card_mesh() -> Mesh:
    """One card, declared: the (1, 1) mesh the dry-run's ``local`` cells
    count for, with no device touched."""
    return Mesh(("data", "model"), (1, 1))
