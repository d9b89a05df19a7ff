"""One-controller collectives over a ``DeviceMesh``: what ``shard_map``
gives the reference's explicit-collective modules
(``training/dp_shardmap.py``, ``training/pipeline.py``).

A ``MeshValue`` holds one tensor per mesh coordinate, on that
coordinate's device: the local value a ``shard_map`` body sees there.
``psum``, ``pmean``, ``pmax`` and ``ppermute`` over a named axis, and
``axis_index``, have ``jax.lax``'s meaning. One process drives every
coordinate, and a value moves between entries with ``.to(device)``: a
device-to-device copy between two cards, and the same tensor (no copy)
where two entries are one card. Autograd flows through ``psum`` and
``ppermute`` (``.to`` and the adds are differentiable), so a backward
through them is their transpose.

Nothing here calls ``torch.distributed``: NCCL cannot put two ranks on
one card, and a machine with one card runs a mesh of repeated entries.
A reduction is taken in order along the axis on the group's first entry
(``((v0 + v1) + v2) ...``), then handed to every member of the group.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

from repro_torch.sharding.mesh import Coord, DeviceMesh


class MeshValue:
    """``values[coord]``: the tensor at each coordinate of ``mesh``."""

    def __init__(self, mesh: DeviceMesh, values: Dict[Coord, torch.Tensor]):
        missing = set(mesh.coords()) - set(values)
        if missing:
            raise ValueError(f"no value at coordinates {sorted(missing)}")
        self.mesh = mesh
        self.values = {tuple(c): values[tuple(c)] for c in mesh.coords()}

    @classmethod
    def build(cls, mesh: DeviceMesh,
              fn: Callable[[Coord, torch.device], torch.Tensor]
              ) -> "MeshValue":
        """``fn(coord, device)`` at every coordinate."""
        return cls(mesh, {c: fn(c, mesh.device(c)) for c in mesh.coords()})

    def __getitem__(self, coord: Coord) -> torch.Tensor:
        return self.values[tuple(coord)]

    def map(self, fn: Callable[[Coord, torch.Tensor], torch.Tensor]
            ) -> "MeshValue":
        return MeshValue(self.mesh, {c: fn(c, v)
                                     for c, v in self.values.items()})


def axis_index(mesh: DeviceMesh, axis: str) -> Dict[Coord, int]:
    """Each coordinate's index along ``axis`` (``jax.lax.axis_index``)."""
    return {c: mesh.axis_index(c, axis) for c in mesh.coords()}


def _reduce(v: MeshValue, axis: str,
            op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
            ) -> MeshValue:
    out = {}
    for group in v.mesh.groups(axis):
        acc = v[group[0]]
        for c in group[1:]:
            acc = op(acc, v[c].to(acc.device))
        for c in group:
            out[c] = acc.to(v.mesh.device(c))
    return MeshValue(v.mesh, out)


def psum(v: MeshValue, axis: str) -> MeshValue:
    """The sum over ``axis``, at every member of each group."""
    return _reduce(v, axis, torch.add)


def pmean(v: MeshValue, axis: str) -> MeshValue:
    """``psum`` divided by the axis size (the sum first, as ``jax``)."""
    n = v.mesh.shape[axis]
    return psum(v, axis).map(lambda c, x: x / n)


def pmax(v: MeshValue, axis: str) -> MeshValue:
    """The elementwise maximum over ``axis``."""
    return _reduce(v, axis, torch.maximum)


def ppermute(v: MeshValue, axis: str,
             perm: Iterable[Tuple[int, int]]) -> MeshValue:
    """Each ``(src, dst)`` pair sends the value at index ``src`` along
    ``axis`` to index ``dst`` (the other coordinates kept); a coordinate
    that no pair sends to gets zeros, as ``jax.lax.ppermute``."""
    perm = list(perm)
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts) or len({s for s, _ in perm}) != len(perm):
        raise ValueError(f"not a permutation: {perm}")
    i = v.mesh.axis_names.index(axis)
    src_of = {d: s for s, d in perm}
    out = {}
    for c in v.mesh.coords():
        if c[i] in src_of:
            src = c[:i] + (src_of[c[i]],) + c[i + 1:]
            out[c] = v[src].to(v.mesh.device(c))
        else:
            out[c] = torch.zeros_like(v[c])
    return MeshValue(v.mesh, out)

