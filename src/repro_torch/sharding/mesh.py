"""A mesh with named axes: an n-dimensional array of ``torch.device``
entries, the counterpart of the reference's ``jax.make_mesh(shape,
axes)``.

Entries may repeat (``cuda:0`` four times): that is how the reference
tests a mesh on one host, and the row-sharded filter ring
(``core/distributed.py::Mesh``, one axis) works the same way. A
coordinate's values then live on the one card, and a move between two
such entries is no copy. An entry that names a card that is not there
raises; the entries are all CUDA, all CPU, or all ``meta`` (shapes only:
the dry run's production meshes, ``launch/dryrun.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

Coord = Tuple[int, ...]


def mesh_device(device) -> torch.device:
    """``device`` as a mesh entry: a card that is there, the CPU, or
    ``meta``."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return torch.device("cpu")       # 'cpu:0' is the one CPU device
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh entry {dev} names a card that is not "
                           f"there ({torch.cuda.device_count()} present)")
    return dev


class DeviceMesh:
    """``devices``: a nested sequence (or object array) of devices, one
    per mesh coordinate; ``axis_names``: one name per dimension."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if src.ndim != len(axis_names):
            raise ValueError(f"{src.ndim}-d devices for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        arr = np.empty(src.shape, dtype=object)
        for c in np.ndindex(src.shape):
            arr[c] = mesh_device(src[c])
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in arr.flat}) > 1:
            raise ValueError("mesh entries must be all CUDA, all CPU or "
                             "all meta")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax``'s ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, coord: Coord) -> torch.device:
        return self.devices[tuple(coord)]

    def coords(self) -> Iterator[Coord]:
        """Every coordinate, in row-major order."""
        return np.ndindex(self.devices.shape)

    def axis_index(self, coord: Coord, axis: str) -> int:
        """The coordinate of ``coord`` along ``axis``."""
        return coord[self.axis_names.index(axis)]

    def groups(self, axis: str) -> List[List[Coord]]:
        """The coordinates that share every coordinate but ``axis``'s, one
        list per group, each in order along ``axis``."""
        i = self.axis_names.index(axis)
        n = self.devices.shape[i]
        rest = self.devices.shape[:i] + self.devices.shape[i + 1:]
        return [[r[:i] + (k,) + r[i:] for k in range(n)]
                for r in np.ndindex(rest)]

    def sub(self, **fixed: int) -> "DeviceMesh":
        """The mesh of the entries at the given coordinates, those axes
        dropped: ``mesh.sub(pod=1)`` of a (pod, data, model) mesh is pod
        1's (data, model) mesh."""
        index = tuple(fixed.pop(a) if a in fixed else slice(None)
                      for a in self.axis_names)
        if fixed:
            raise ValueError(f"no axes {sorted(fixed)} in {self.axis_names}")
        names = tuple(a for a, ix in zip(self.axis_names, index)
                      if isinstance(ix, slice))
        return DeviceMesh(self.devices[index], names)

    def distinct_devices(self) -> List[torch.device]:
        """Each device once, in the order of its first entry."""
        return list(dict.fromkeys(self.devices.flat))

    def __eq__(self, other):
        return (isinstance(other, DeviceMesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat,
                                               other.devices.flat)))

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape,
                     tuple(self.devices.flat)))

    def __repr__(self):
        axes = ", ".join(f"{a!r}: {n}" for a, n in self.shape.items())
        return f"DeviceMesh({axes}; {[str(d) for d in self.devices.flat]})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Sequence) -> DeviceMesh:
    """The mesh of ``shape`` over the first ``prod(shape)`` of
    ``devices``, in row-major order, as ``jax.make_mesh`` takes them;
    fewer devices than that raise (nothing repeats a card on its own)."""
    shape = tuple(int(n) for n in shape)
    devices = list(devices)
    if len(devices) < math.prod(shape):
        raise ValueError(f"{len(devices)} devices for a mesh of "
                         f"{math.prod(shape)} ({shape})")
    flat = np.empty(math.prod(shape), dtype=object)
    flat[:] = devices[:math.prod(shape)]
    return DeviceMesh(flat.reshape(shape), axis_names)
