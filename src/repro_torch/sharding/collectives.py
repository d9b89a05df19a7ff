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

``all_reduce`` and ``broadcast`` serve tensor parallelism
(``training/spmd.py``): a data-parallel rank's group of coordinates over
its tensor-parallel axes ('model') computes one part each of a product,
and the parts are summed (or their maximum taken) where the reference's
partitioned program all-reduces. The single controller takes the
reduction on the group's first member and hands its inputs to the other
members with ``broadcast``. Both are autograd functions: the gradient of
a reduction is handed back to each part's member, and that of a
broadcast is summed from the members, the all-reduce of the input's
gradient. What each moves is counted by kind: ``all_reduced`` the bytes
the members other than the first send into a reduction (the all-reduces
of the reference's program, one per reduction in forward and one per
broadcast in backward), ``copies`` the single controller's own copies of
a replicated tensor (a broadcast's inputs, a reduction's gradient, and a
reduction run again where the remat policy recomputes a layer in
backward).

``all_gather`` and ``reduce_scatter`` over named axes are ``jax.lax``'s
``all_gather(tiled=True)`` and ``psum_scatter(tiled=True)``: what XLA
inserts around a weight sharded by a ``PartitionSpec``. Each adds the
bytes it carries to a ``Traffic``: ``moved`` between distinct devices
(a copy), ``local`` between entries of one device (no copy: the same
storage, or a view of it). Where the parts of a gather are adjacent views
of one tensor on one device, the result is a view of that tensor, not a
new one.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
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



@dataclasses.dataclass
class Traffic:
    """Bytes carried by collectives: ``moved`` between distinct devices,
    ``local`` between entries of one device (no copy). ``add`` may be
    called from autograd's threads, one a card."""
    moved: int = 0
    local: int = 0
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def add(self, nbytes: int, src: torch.device, dst: torch.device) -> None:
        with self.lock:
            if src == dst:
                self.local += int(nbytes)
            else:
                self.moved += int(nbytes)


def _axes(axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _group_of(mesh: DeviceMesh, coord: Coord, axes: Tuple[str, ...]
              ) -> Tuple[int, list]:
    """``coord``'s index in its group over ``axes`` (row-major over the
    axes in the order given, as ``jax.lax.axis_index`` of a tuple), and
    the group's coordinates in that order."""
    idx = [mesh.axis_names.index(a) for a in axes]
    sizes = [mesh.devices.shape[i] for i in idx]
    group = []
    for pos in np.ndindex(*sizes):
        c = list(coord)
        for i, k in zip(idx, pos):
            c[i] = k
        group.append(tuple(c))
    return group.index(tuple(coord)), group


def cat_views(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """``torch.cat(parts, dim)``, or a view where the parts are adjacent
    views of one tensor's storage along ``dim`` (no copy) and none needs a
    gradient."""
    p0 = parts[0]
    if (len(parts) > 1 and p0.device.type != "meta"
            and not any(p.requires_grad for p in parts)):
        st = p0.stride()
        step = p0.shape[dim] * st[dim]
        if all(p.device == p0.device and p.dtype == p0.dtype
               and p.stride() == st
               and p.untyped_storage().data_ptr()
               == p0.untyped_storage().data_ptr()
               and p.shape == p0.shape
               and p.storage_offset() == p0.storage_offset() + i * step
               for i, p in enumerate(parts)):
            shape = list(p0.shape)
            shape[dim] *= len(parts)
            return p0.as_strided(shape, st, p0.storage_offset())
    return torch.cat(list(parts), dim=dim) if len(parts) > 1 else p0


def all_gather(v: MeshValue, axes, dim: int,
               traffic: Optional[Traffic] = None) -> MeshValue:
    """At each coordinate, the values of its group over ``axes``
    concatenated along ``dim`` in group order (``jax.lax.all_gather(x,
    axes, axis=dim, tiled=True)``). Differentiable: its transpose is
    ``reduce_scatter``."""
    axes = _axes(axes)
    out = {}
    for c in v.mesh.coords():
        dev = v.mesh.device(c)
        me, group = _group_of(v.mesh, c, axes)
        parts = []
        for i, g in enumerate(group):
            if traffic is not None and i != me:
                traffic.add(v[g].nbytes, v.mesh.device(g), dev)
            parts.append(v[g].to(dev))
        out[c] = cat_views(parts, dim)
    return MeshValue(v.mesh, out)


def reduce_scatter(v: MeshValue, axes, dim: int,
                   traffic: Optional[Traffic] = None) -> MeshValue:
    """At each coordinate, its block along ``dim`` of the sum over its
    group over ``axes``: the group's k-th member gets the k-th of n equal
    blocks (``jax.lax.psum_scatter(x, axes, scatter_dimension=dim,
    tiled=True)``). The sum is taken in group order on the receiving
    coordinate's device. Differentiable: its transpose is ``all_gather``."""
    axes = _axes(axes)
    out = {}
    for c in v.mesh.coords():
        dev = v.mesh.device(c)
        me, group = _group_of(v.mesh, c, axes)
        n = v[c].shape[dim] // len(group)
        if n * len(group) != v[c].shape[dim]:
            raise ValueError(f"dim {dim} of {tuple(v[c].shape)} does not "
                             f"split over {axes} ({len(group)})")
        acc = None
        for g in group:
            part = v[g].narrow(dim, me * n, n)
            if traffic is not None and g != c:
                traffic.add(part.nbytes, v.mesh.device(g), dev)
            part = part.to(dev)
            acc = part if acc is None else acc + part
        out[c] = acc
    return MeshValue(v.mesh, out)


@dataclasses.dataclass
class TPCounts:
    """Where tensor parallelism's bytes are counted: ``all_reduced`` (the
    reference's all-reduces) and ``copies`` (the single controller's);
    ``recompute()`` says whether a forward runs again in backward, whose
    reductions are then copies. Serving adds ``exchanged`` (a prefill's
    keys and values sent to the members whose cache slots they fill: an
    all-to-all) and ``logits`` (the members' vocabulary blocks of the
    logits assembled on the first member). ``states``: the recurrent
    layers' blocks (``tp.TP.send`` / ``put`` / ``collect``): a member's
    channels or heads of a state the rank holds whole, sent to the member
    and the new ones put back on the first member, and the sLSTM's
    hidden states assembled there (an all-gather; its gradient's blocks
    sent back in backward). ``tp_gathered`` and ``tp_scattered``: the
    group's all-gathers and reduce-scatters (``train_sp``: the members'
    token blocks gathered before a split block and its partial outputs
    reduce-scattered over the tokens after it; ``kv_seq``: the members'
    query heads gathered, and each member's heads of the combined
    attention output), each counting the other's gradient in backward."""
    all_reduced: Traffic
    copies: Traffic
    recompute: Callable[[], bool] = lambda: False
    exchanged: Optional[Traffic] = None
    logits: Optional[Traffic] = None
    states: Optional[Traffic] = None
    tp_gathered: Optional[Traffic] = None
    tp_scattered: Optional[Traffic] = None


def _add(t: Optional[Traffic], x: torch.Tensor, src, dst) -> None:
    if t is not None:
        t.add(x.nbytes, src, dst)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, device, counts, *parts):
        ctx.op, ctx.counts = op, counts
        ctx.devices = [p.device for p in parts]
        kind = None
        if counts is not None:
            kind = counts.copies if counts.recompute() else \
                counts.all_reduced
        acc = parts[0].to(device)
        for p in parts[1:]:
            _add(kind, p, p.device, device)
            q = p.to(device)
            acc = acc + q if op == "sum" else torch.maximum(acc, q)
        if op == "max":
            # the first part holding each maximum takes its gradient
            taken = torch.zeros_like(acc, dtype=torch.bool)
            wins = []
            for p in parts:
                w = (p.to(device) == acc) & ~taken
                taken |= w
                wins.append(w)
            ctx.save_for_backward(*wins)
        return acc

    @staticmethod
    def backward(ctx, grad):
        counts = ctx.counts
        out = []
        wins = ctx.saved_tensors if ctx.op == "max" else None
        for i, dev in enumerate(ctx.devices):
            g = grad if wins is None else torch.where(wins[i], grad, 0)
            if i and counts is not None:
                _add(counts.copies, g, g.device, dev)
            out.append(g.to(dev))
        return (None, None, None, *out)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, counts, x):
        ctx.device, ctx.counts = x.device, counts
        out = []
        for i, dev in enumerate(devices):
            if i and counts is not None:
                _add(counts.copies, x, x.device, dev)
            # a view where the member is the input's device: autograd
            # needs an output of its own for each member
            out.append(x.to(dev) if dev != x.device else x.view_as(x))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        counts = ctx.counts
        acc = None
        for i, g in enumerate(grads):
            if g is None:
                continue
            if i and counts is not None:
                _add(counts.all_reduced, g, g.device, ctx.device)
            g = g.to(ctx.device)
            acc = g if acc is None else acc + g
        return None, None, acc


def all_reduce(parts: Sequence[torch.Tensor], device, op: str = "sum",
               counts: Optional[TPCounts] = None) -> torch.Tensor:
    """The sum (or elementwise maximum, ``op='max'``) of a
    tensor-parallel group's parts, on ``device`` (the group's first
    member), taken in the parts' order. Its gradient goes back to each
    part's member (a maximum's to the first part holding it)."""
    if op not in ("sum", "max"):
        raise ValueError(op)
    if len(parts) == 1:
        return parts[0]
    return _Reduce.apply(op, torch.device(device), counts, *parts)


def broadcast(x: torch.Tensor, devices: Sequence[torch.device],
              counts: Optional[TPCounts] = None) -> List[torch.Tensor]:
    """``x`` at each of ``devices`` (``devices[0]`` is ``x``'s own): a copy
    between two cards, ``x`` itself between entries of one. Its gradient
    is the sum of the members' (the all-reduce of the input's gradient),
    in the members' order."""
    if len(devices) == 1:
        return [x]
    if not x.requires_grad:
        out = []
        for i, dev in enumerate(devices):
            if i and counts is not None:
                _add(counts.copies, x, x.device, dev)
            out.append(x.to(dev))
        return out
    return list(_Broadcast.apply(tuple(devices), counts, x))
