"""Tensors placed by a ``PartitionSpec`` on a ``DeviceMesh``: the port's
``jax.sharding.NamedSharding``.

``NamedSharding(mesh, spec).shard(x)`` gives a ``ShardedTensor``: at each
mesh coordinate the block that ``jax.device_put(x, sharding)`` leaves on
that coordinate's device (``index(coord, shape)`` is the reference's
``addressable_shards[i].index`` there). A dim sharded over several mesh
axes splits row-major over them, in the order the spec names them; a dim
the spec leaves out (``None``, or past its end) is whole everywhere.

Storage. The entries of one device share storage: a device whose
coordinates together hold every block keeps the whole tensor once (its
*base*), and each of its blocks is a view of it, so four entries of one
card hold a weight once, not four times. A device that holds only some
blocks keeps each distinct block once. Distinct devices hold copies of a
block they share; the first coordinate (row-major) that holds a block
*owns* it: an update is applied to the owner's copy
(``owned_units``) and copied to the others (``sync_replicas``).

``gather(device)`` gives the logical tensor on ``device``: the base
itself where that device has one (no copy), else the blocks assembled,
each taken from that device where it holds it, else from its owner.
``gather_layer`` gives one layer of it, or one *region* (``index``: a
slice per dim): what a coordinate of a tensor-parallel group computes
with is its own part of a weight (its heads, its columns, its experts),
gathered over the other axes only, so its 'model' block stays split.
Every byte a gather or a replica copy carries can be counted in a
``collectives.Traffic``.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.sharding.collectives import MeshValue, Traffic
from repro_torch.sharding.mesh import Coord, DeviceMesh
from repro_torch.sharding.rules import PartitionSpec

Key = Tuple[int, ...]


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A ``PartitionSpec`` on a ``DeviceMesh``. ``.mesh`` and ``.spec`` as
    the reference's (so its ``hasattr(x, 'spec')`` leaf test holds)."""

    def __init__(self, mesh: DeviceMesh, spec: Sequence = ()):
        self.mesh = mesh
        self.spec = (spec if isinstance(spec, PartitionSpec)
                     else PartitionSpec(*spec))
        seen = set()
        for entry in self.spec:
            for a in _names(entry):
                if a not in mesh.axis_names:
                    raise ValueError(f"axis {a!r} of {self.spec} is not in "
                                     f"the mesh's {mesh.axis_names}")
                if a in seen:
                    raise ValueError(f"axis {a!r} twice in {self.spec}")
                seen.add(a)

    def dim_axes(self, ndim: int) -> List[Tuple[str, ...]]:
        """The mesh axes each of ``ndim`` dims is split over."""
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} for a {ndim}-d tensor")
        return ([_names(e) for e in self.spec]
                + [()] * (ndim - len(self.spec)))

    def splits(self, ndim: int) -> Tuple[int, ...]:
        """How many blocks each dim is split into."""
        memo = self.__dict__.setdefault("_splits", {})
        if ndim not in memo:
            memo[ndim] = tuple(math.prod(self.mesh.shape[a] for a in axes)
                               for axes in self.dim_axes(ndim))
        return memo[ndim]

    def key(self, coord: Coord, ndim: int) -> Key:
        """The block a coordinate holds: its position along each dim."""
        out = []
        for axes in self.dim_axes(ndim):
            k = 0
            for a in axes:
                k = k * self.mesh.shape[a] + self.mesh.axis_index(coord, a)
            out.append(k)
        return tuple(out)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = []
        for n, s in zip(shape, self.splits(len(shape))):
            if n % s:
                raise ValueError(f"dim of {n} does not split into {s} "
                                 f"({self.spec} on {tuple(shape)})")
            out.append(n // s)
        return tuple(out)

    def key_index(self, key: Key, shape: Sequence[int]) -> Tuple[slice, ...]:
        bs = self.shard_shape(shape)
        return tuple(slice(None) if s == 1 else slice(k * b, (k + 1) * b)
                     for k, b, s in zip(key, bs, self.splits(len(shape))))

    def index(self, coord: Coord, shape: Sequence[int]) -> Tuple[slice, ...]:
        """The slices of the block at ``coord`` of a tensor of ``shape``."""
        return self.key_index(self.key(coord, len(shape)), shape)

    def keys(self, ndim: int) -> List[Key]:
        """Every block's key, row-major."""
        return list(itertools.product(*(range(n)
                                        for n in self.splits(ndim))))

    def foreign(self, shape: Sequence[int], at: Optional[Coord],
                index: Optional[Sequence[slice]] = None
                ) -> List[Tuple[Key, int]]:
        """(key, elements) of each block other than coordinate ``at``'s
        (every block where ``at`` is None) that meets the region
        ``index`` of a tensor of ``shape``: what a gather of that region
        at ``at`` takes from the other coordinates."""
        own = self.key(at, len(shape)) if at is not None else None
        region = _box(index, shape)
        out = []
        for k in self.keys(len(shape)):
            n = _numel(_meet(_box(self.key_index(k, shape), shape), region))
            if k != own and n:
                out.append((k, n))
        return out

    def shard(self, x: torch.Tensor) -> "ShardedTensor":
        return ShardedTensor.from_tensor(self, x)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and tuple(self.spec) == tuple(other.spec))

    def __hash__(self):
        return hash((self.mesh, tuple(self.spec)))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


Box = List[Tuple[int, int]]


def _box(index: Optional[Sequence[slice]], shape: Sequence[int]) -> Box:
    """``index`` (a slice per dim, step 1; None: everything) as (start,
    stop) per dim of ``shape``."""
    if index is None:
        return [(0, n) for n in shape]
    out = []
    for i, n in enumerate(shape):
        sl = index[i] if i < len(index) else slice(None)
        lo, hi, step = sl.indices(n)
        if step != 1:
            raise ValueError(f"a region's slices take every element: {sl}")
        out.append((lo, hi))
    return out


def _meet(a: Box, b: Box) -> Optional[Box]:
    out = [(max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b)]
    return None if any(lo >= hi for lo, hi in out) else out


def _within(inner: Box, outer: Box) -> Tuple[slice, ...]:
    """``inner``'s slices relative to ``outer``'s start."""
    return tuple(slice(lo - o, hi - o) for (lo, hi), (o, _) in
                 zip(inner, outer))


def _numel(box: Optional[Box]) -> int:
    return 0 if box is None else math.prod(hi - lo for lo, hi in box)


def _own_copy(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` in storage of its own."""
    if x.device == device:
        return x.clone(memory_format=torch.contiguous_format)
    return x.to(device).contiguous()


class ShardedTensor:
    """A logical tensor of ``shape`` held as blocks on ``sharding.mesh``
    (see the module note). Build one with ``NamedSharding.shard``."""

    def __init__(self, sharding: NamedSharding, shape, dtype,
                 bases: Dict[torch.device, torch.Tensor],
                 blocks: Dict[Tuple[torch.device, Key], torch.Tensor]):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.bases = bases
        self.blocks = blocks
        mesh = sharding.mesh
        self.owner: Dict[Key, torch.device] = {}
        for c in mesh.coords():
            self.owner.setdefault(sharding.key(c, len(self.shape)),
                                  mesh.device(c))

    @classmethod
    def from_tensor(cls, sharding: NamedSharding, x: torch.Tensor
                    ) -> "ShardedTensor":
        """``x`` placed: one base per device that holds every block (``x``
        itself on ``x``'s own device: no copy), else a copy of each
        distinct block."""
        mesh, shape = sharding.mesh, tuple(x.shape)
        held: Dict[torch.device, Dict[Key, None]] = {}
        for c in mesh.coords():
            held.setdefault(mesh.device(c), {})[
                sharding.key(c, len(shape))] = None
        n_keys = math.prod(sharding.splits(len(shape)))
        bases, blocks = {}, {}
        for dev, keys in held.items():
            if len(keys) == n_keys:
                bases[dev] = base = x.to(dev)
                for k in keys:
                    blocks[(dev, k)] = base[sharding.key_index(k, shape)]
            else:
                for k in keys:
                    blocks[(dev, k)] = _own_copy(
                        x[sharding.key_index(k, shape)], dev)
        return cls(sharding, shape, x.dtype, bases, blocks)

    # -- the logical tensor ---------------------------------------------------
    @property
    def mesh(self) -> DeviceMesh:
        return self.sharding.mesh

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def key(self, coord: Coord) -> Key:
        return self.sharding.key(coord, self.ndim)

    def block(self, coord: Coord) -> torch.Tensor:
        """The block at ``coord`` (a view of the base where there is one)."""
        return self.blocks[(self.mesh.device(coord), self.key(coord))]

    def local_blocks(self) -> MeshValue:
        """The block at every coordinate, as a ``MeshValue``."""
        return MeshValue(self.mesh, {c: self.block(c)
                                     for c in self.mesh.coords()})

    def block_nbytes(self) -> int:
        """The bytes of one block (every block is the same size)."""
        return (math.prod(self.sharding.shard_shape(self.shape))
                * torch.empty((), dtype=self.dtype).element_size())

    def gather(self, device, traffic: Optional[Traffic] = None,
               at: Optional[Coord] = None, copy: bool = False
               ) -> torch.Tensor:
        """The logical tensor on ``device``: the base where ``device`` has
        one (a copy of it where ``copy``), else the blocks assembled.
        ``traffic`` counts the blocks a gather at coordinate ``at`` takes
        from the other coordinates (every block where ``at`` is None):
        ``local`` where ``device`` holds the block, ``moved`` where it comes
        from its owner on another device."""
        device = torch.device(device)
        if traffic is not None:
            self.count_gather(device, traffic, at)
        if device in self.bases:
            base = self.bases[device]
            return base.clone() if copy else base
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for k, o in self.owner.items():
            src = self.blocks.get((device, k), self.blocks[(o, k)])
            out[self.sharding.key_index(k, self.shape)].copy_(src)
        return out

    def gather_layer(self, device, layer: Optional[int] = None,
                     traffic: Optional[Traffic] = None,
                     at: Optional[Coord] = None,
                     index: Optional[Sequence[slice]] = None
                     ) -> torch.Tensor:
        """Index ``layer`` of the leading dim (the whole tensor where
        ``layer`` is None), or its region ``index`` (a slice per dim of
        the logical shape, the leading dim's ignored for a layer), on
        ``device``, as a tensor object of its own: an alias of the base's
        storage where ``device`` has a base (no copy, and not a view, so
        its views and their lifetimes are its own), else the parts of the
        blocks that meet the region assembled. The leading dim of a
        stacked leaf is never sharded (``W_RULES['layers']``).
        ``traffic`` counts as ``gather`` does, for that layer's region
        only."""
        device = torch.device(device)
        if layer is not None and self.sharding.splits(self.ndim)[0] != 1:
            raise ValueError(f"{self!r}: the leading dim is sharded")
        if traffic is not None:
            self.count_gather(device, traffic, at, layer is not None, index)
        region = _box(index, self.shape)
        if layer is not None:
            region[0] = (layer, layer + 1)
        sl = tuple(slice(lo, hi) for lo, hi in region)
        if device in self.bases:
            t = self.bases[device][sl]
            if layer is not None:
                t = t[0]
            return torch.empty(0, dtype=t.dtype, device=device).set_(
                t.untyped_storage(), t.storage_offset(), t.size(), t.stride())
        shape = [hi - lo for lo, hi in region]
        out = torch.empty(shape[1:] if layer is not None else shape,
                          dtype=self.dtype, device=device)
        dst = out if layer is None else out[None]
        for k, o in self.owner.items():
            box = _box(self.sharding.key_index(k, self.shape), self.shape)
            part = _meet(box, region)
            if part is None:
                continue
            src = self.blocks.get((device, k), self.blocks[(o, k)])
            dst[_within(part, region)].copy_(src[_within(part, box)])
        return out

    def _foreign(self, at: Optional[Coord], layer: bool,
                 index: Optional[Sequence[slice]]):
        """(key, owner, bytes) of each block other than ``at``'s that meets
        the region ``index``: the part of it there (one layer's rows with
        ``layer``). Kept per (``at``, ``layer``, region): a step asks the
        same every layer."""
        memo = self.__dict__.setdefault("_foreign_memo", {})
        region = None if index is None else tuple(
            (sl.start, sl.stop) for sl in index)
        got = memo.get((at, layer, region))
        if got is None:
            size = torch.empty((), dtype=self.dtype).element_size()
            got = memo[(at, layer, region)] = [
                (k, self.owner[k],
                 n * size // (self.shape[0] if layer else 1))
                for k, n in self.sharding.foreign(self.shape, at, index)]
        return got

    def count_gather(self, device, traffic: Traffic,
                     at: Optional[Coord] = None, layer: bool = False,
                     index: Optional[Sequence[slice]] = None) -> None:
        """Add to ``traffic`` the blocks a gather onto ``device`` at
        coordinate ``at`` takes from the other coordinates (see
        ``gather``); with ``layer``, one layer's rows of them; with
        ``index``, their parts in that region."""
        device = torch.device(device)
        for k, o, nb in self._foreign(at, layer, index):
            src = device if (device, k) in self.blocks else o
            traffic.add(nb, src, device)

    def count_scatter(self, at: Coord, traffic: Traffic,
                      layer: bool = False,
                      index: Optional[Sequence[slice]] = None) -> None:
        """Add to ``traffic`` the blocks of a gradient a reduce-scatter
        sends from coordinate ``at`` to their owners (all but its own);
        with ``layer``, one layer's rows of them; with ``index``, their
        parts in that region."""
        src = self.mesh.device(at)
        for _, o, nb in self._foreign(at, layer, index):
            traffic.add(nb, src, o)

    @torch.no_grad()
    def scatter_add(self, grad: torch.Tensor, into: List[torch.Tensor],
                    layer: Optional[int] = None,
                    index: Optional[Sequence[slice]] = None) -> None:
        """Add ``grad`` (the gradient of the logical tensor, of layer
        ``layer``, or of their region ``index``) into ``into``, one
        accumulator per ``owned_keys`` entry shaped as its
        ``owned_units`` tensor: each owner's blocks take the part of it
        they meet, on the owner (a view of one gradient where the owner
        is ``grad``'s own device)."""
        region = _box(index, self.shape)
        if layer is not None:
            region[0] = (layer, layer + 1)
            grad = grad[None]
        for (owner, key), acc in zip(self.owned_keys(), into, strict=True):
            box = (_box(None, self.shape) if key is None else
                   _box(self.sharding.key_index(key, self.shape),
                        self.shape))
            part = _meet(box, region)
            if part is not None:
                acc[_within(part, box)].add_(
                    grad[_within(part, region)].to(owner))

    # -- in-place updates ------------------------------------------------------
    def owned_keys(self) -> List[Tuple[torch.device, Optional[Key]]]:
        """(device, key) of each of ``owned_units`` (key None: the base)."""
        out = []
        n_keys = len(self.owner)
        for dev in self.mesh.distinct_devices():
            mine = [k for k, o in self.owner.items() if o == dev]
            if dev in self.bases and len(mine) == n_keys:
                out.append((dev, None))
            else:
                out.extend((dev, k) for k in mine)
        return out

    def owned_units(self) -> List[torch.Tensor]:
        """Tensors that cover each element once, each on the element's
        owner: a device's base where it owns every block, else its owned
        blocks. An update applied to these and then ``sync_replicas``
        updates every copy."""
        return [self.bases[d] if k is None else self.blocks[(d, k)]
                for d, k in self.owned_keys()]

    def replica_pairs(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(owner's copy, replica) for every block held on a device that
        does not own it; a whole base at once where one device owns all
        of it."""
        pairs = []
        for dev in self.mesh.distinct_devices():
            keys = [k for (d, k) in self.blocks if d == dev]
            foreign = [k for k in keys if self.owner[k] != dev]
            if not foreign:
                continue
            owners = {self.owner[k] for k in keys}
            if (dev in self.bases and len(owners) == 1
                    and next(iter(owners)) in self.bases):
                pairs.append((self.bases[next(iter(owners))],
                              self.bases[dev]))
                continue
            pairs.extend((self.blocks[(self.owner[k], k)],
                          self.blocks[(dev, k)]) for k in foreign)
        return pairs

    @torch.no_grad()
    def sync_replicas(self, traffic: Optional[Traffic] = None) -> None:
        """Copy each owned block onto its replicas on other devices."""
        for src, dst in self.replica_pairs():
            if traffic is not None:
                traffic.add(src.nbytes, src.device, dst.device)
            dst.copy_(src)

    def map_units(self, fn) -> "ShardedTensor":
        """A ShardedTensor of the same layout whose stored tensors are
        ``fn`` of this one's (each base and each block of its own once)."""
        bases = {d: fn(b) for d, b in self.bases.items()}
        blocks = {}
        for (d, k), t in self.blocks.items():
            blocks[(d, k)] = (bases[d][self.sharding.key_index(k, self.shape)]
                              if d in bases else fn(t))
        any_t = next(iter(bases.values()), None)
        if any_t is None:
            any_t = next(iter(blocks.values()))
        return ShardedTensor(self.sharding, self.shape, any_t.dtype, bases,
                             blocks)

    def stored_nbytes(self) -> Dict[torch.device, int]:
        """Bytes each device stores for this tensor."""
        out: Dict[torch.device, int] = {}
        for d, b in self.bases.items():
            out[d] = b.nbytes
        for (d, _), t in self.blocks.items():
            if d not in self.bases:
                out[d] = out.get(d, 0) + t.nbytes
        return out

    def __repr__(self):
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec!r})")


def gather(x, device, **kw) -> torch.Tensor:
    """The logical tensor of ``x`` (a ``ShardedTensor`` or a tensor) on
    ``device``."""
    if isinstance(x, ShardedTensor):
        return x.gather(device, **kw)
    return x.to(device)


def shard_tree(tree, shardings):
    """``tree``'s leaves placed by the matching ``NamedSharding`` leaves of
    ``shardings`` (a ``None`` leaf or subtree leaves its leaves as they
    are)."""
    if shardings is None:
        return tree
    if isinstance(shardings, NamedSharding):
        return shardings.shard(tree)
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [shard_tree(v, s) for v, s in zip(tree, shardings)]
        return type(tree)(*seq) if hasattr(tree, "_fields") \
            else type(tree)(seq)
    return tree
