"""Production mesh definitions (port of ``repro.launch.mesh``).

Mesh axes, as in the reference:
  single-pod: (data=16, model=16)           — 256 chips
  multi-pod:  (pod=2, data=16, model=16)    — 512 chips

Axis roles: ``data`` shards the global batch (and FSDP weight rows),
``model`` shards heads / FFN columns / experts / long KV sequences,
``pod`` is pure data parallelism across pods.

A :class:`Mesh` is a frozen record of axis names, sizes and the devices
it spans.  The reference's dry-run builds its production meshes over 512
host devices that XLA fakes (``--xla_force_host_platform_device_count``);
the port's builds them with no devices at all (``abstract=True``), since
a shape dry-run on the ``meta`` device needs only the axis sizes.  Built
over devices, a production mesh raises ``ValueError`` when fewer CUDA
devices are visible than it spans, as ``jax.make_mesh`` does.
``make_host_mesh`` is the one card (or the device it is given).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, and the devices the mesh spans (empty for an
    abstract mesh, which only shapes and shards specs)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"a mesh of {self.size} positions over "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def _make_mesh(shape: tuple, axes: tuple, abstract: bool) -> Mesh:
    if abstract:
        return Mesh(axes, shape)
    need = Mesh(axes, shape).size
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise ValueError(
            f"a ({', '.join(f'{a} {s}' for a, s in zip(axes, shape))}) mesh "
            f"spans {need} devices; {have} CUDA devices are visible")
    return Mesh(axes, shape,
                tuple(torch.device("cuda", i) for i in range(need)))


def make_production_mesh(*, multi_pod: bool = False,
                         abstract: bool = False) -> Mesh:
    """The single-pod (16 x 16) or multi-pod (2 x 16 x 16) mesh: over that
    many CUDA devices, or with none when ``abstract``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, abstract)


def make_host_mesh(device: DeviceLike = None) -> Mesh:
    """1-device mesh with the production axis names: the card, unless
    ``device`` names another."""
    return Mesh(("data", "model"), (1, 1), (resolve_device(device),))


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_shards(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return int(n)
