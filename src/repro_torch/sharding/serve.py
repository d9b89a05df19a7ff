"""Prefill and the decode step on a mesh: the reference's
``jax.jit(lambda p, b: bundle.prefill(p, b, shd=ctx), in_shardings=...)``
and its decode step (``launch/dryrun.py::build_lowered``), where XLA
partitions the weights and the caches by ``sharding.rules`` and inserts
the collectives. Torch has no partitioner; here one process drives every
coordinate, and every move of bytes is explicit and counted.

Storage: the parameters are ``ShardedTensor``s placed by the profile
(``ctx.spec_tree_shardings``, as ``train_loop(mesh=)`` places them), and
so are the caches, by ``bundle.cache_axes()`` under the same context:
the KV cache's sequence lies on 'model' (``cache_seq``) and its rows on
the data-parallel axes in every profile, so a prefill's caches (train
profile) feed the decode step (decode profile) as they are.

Compute: each data-parallel rank (the axes ``act_batch`` maps to) takes
its rows, and its group of 'model' coordinates computes them together.
The rank gathers one layer at a time through the mesh step's seam
(``training/spmd.py::stacked_leaf``, ``sharding/fsdp.py``), forward only
(no gradients held). What each member computes is the profile's
(``ShardingCtx.tp_splits``, ``registry.tp_plan``):

- prefill (train profile): its query heads with the key/value heads they
  read, its MLP columns, its experts or expert columns and its
  vocabulary block, as the mesh train step splits them; the keys and
  values it projects are sent to the members whose cache slots they
  fill (``tp.TP.exchange``);
- decode (decode profile, flash-decode): the heads whole, each member
  attending over its block of the cache and the partials combined
  (``tp.TP.combine``); the MLP, experts and vocabulary split as above.

Whisper splits the same way (``whisper.tp_plan``): to prefill, the
encoder's and the decoder's heads and the MLP columns, each member's
cross K/V (its heads over every frame) sent to the members whose block of
the cross cache holds those frames; to decode, its 448-slot self ring and
its cross cache both along their sequence, a member's partials over its
blocks combined.

The recurrent layers split over the group by their inner dim
(``act_ssm``, in both profiles): mamba's channels (hymba's mamba part and
the ``mamba`` kind), the mLSTM's channels and heads, the sLSTM's heads
and its FFN's columns, as the mesh train step splits them. Their states
lie as the reference's ``cache_logical_axes`` place them: the mamba and
mLSTM conv states along ``act_ssm``, each member reading and writing its
own block in place (``_Rank.blocks``); the mamba ssm state, the mLSTM
memory (C, n, m) and the sLSTM state whole, gathered on the rank's first
coordinate for its rows, each member's heads or channels sent to it and
the new ones put together there (``states``), and written back to their
blocks after the call. The norms and residual adds run on the rank's
first coordinate. A cache whose length does not divide 'model' is
placed whole on every member (the reference drops that mapping) and
attended on the first. The logits come back whole on
the mesh's first entry, the ranks' rows in order.

On one card whose entries make the mesh, a gather returns an alias of
the stored tensor, a cache block is a view of the one stored cache, and
the moves copy nothing: ``traffic`` counts those bytes as ``local``, and
bytes between distinct cards as ``moved``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import registry
from repro_torch.models.attention import KVBlocks
from repro_torch.models.module import tree_map, tree_paths
from repro_torch.sharding import fsdp
from repro_torch.sharding.collectives import TPCounts, Traffic
from repro_torch.sharding.mesh import Coord, mesh_device
from repro_torch.sharding.placement import (ShardedTensor, _box, _meet,
                                            _within, shard_tree)
from repro_torch.sharding.rules import ShardingCtx
from repro_torch.sharding.tp import TP, CoordFlops, Parts
from repro_torch.training import spmd

KINDS = ("gathered", "all_reduced", "tp_gathered", "tp_scattered",
         "exchanged", "logits", "states", "copies", "replicas", "batch")


def cache_shardings(bundle, batch: int, ctx: ShardingCtx):
    """The caches' ``NamedSharding`` tree for ``batch`` rows of
    ``rc.shape.seq_len`` tokens: ``bundle.cache_axes()`` resolved by
    ``ctx``."""
    def zip_(ab, ax):
        if isinstance(ab, dict):
            return {k: zip_(ab[k], ax[k]) for k in ab}
        if isinstance(ab, (list, tuple)) and not torch.is_tensor(ab):
            return type(ab)(zip_(a, x) for a, x in zip(ab, ax))
        return ctx.sharding(ab.shape, ax)
    return zip_(bundle.cache_abstract(batch, bundle.cfg.shape.seq_len),
                bundle.cache_axes())


def cache_block(x: ShardedTensor, coord: Coord) -> torch.Tensor:
    """The block of a placed cache leaf a coordinate holds (a view of the
    stored cache where its device holds it whole), which the coordinate's
    writes go into."""
    return x.block(coord)


def _is_kv(tree) -> bool:
    return isinstance(tree, dict) and "k" in tree and "v" in tree


def kv_length(tree, axes) -> Tuple[str, int, int]:
    """A KV cache's leaf that its sequence is read from ('pos', or 'k'
    for a cache of keys and values alone, whisper's cross cache), that
    leaf's ``cache_seq`` dim, and the cache's length."""
    name = "pos" if "pos" in tree else "k"
    dim = axes[name].index("cache_seq")
    return name, dim, tree[name].shape[dim]


def map_cache(tree, axes, fn_kv, fn_leaf):
    """A cache tree (``bundle.cache_axes()``' logical ``axes`` beside it)
    mapped: ``fn_kv(tree, axes)`` of each KV cache (a dict with 'k' and
    'v') where ``fn_kv`` is given, else ``fn_leaf(leaf, axes)`` of every
    leaf."""
    if fn_kv is not None and _is_kv(tree):
        return fn_kv(tree, axes)
    if isinstance(tree, dict):
        return {k: map_cache(v, axes[k], fn_kv, fn_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not (
            axes and all(a is None or isinstance(a, str) for a in axes)):
        return type(tree)(map_cache(v, a, fn_kv, fn_leaf)
                          for v, a in zip(tree, axes))
    return fn_leaf(tree, axes)


def _leaves(tree) -> List[ShardedTensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class _Rank:
    """One data-parallel rank's call: its group's ``members`` (mesh
    coordinates, its own first), its rows [lo, lo + rows) of the batch,
    and the moves it counts."""

    def __init__(self, members: List[Coord], lo: int, rows: int,
                 traffic: Dict[str, Traffic], mesh):
        self.members, self.lo, self.rows = members, lo, rows
        self.traffic, self.mesh = traffic, mesh
        self.states: List[Tuple[ShardedTensor, torch.Tensor, tuple]] = []

    @property
    def device(self) -> torch.device:
        return self.mesh.device(self.members[0])

    def _region(self, x: ShardedTensor, axes) -> tuple:
        """The rank's rows of a cache leaf of logical ``axes``."""
        region = [slice(None)] * x.ndim
        if "act_batch" in axes:
            region[axes.index("act_batch")] = slice(self.lo,
                                                    self.lo + self.rows)
        return tuple(region)

    def kv(self, tree: Dict[str, ShardedTensor], axes) -> KVBlocks:
        """A KV cache's blocks at the members with a block of their own
        (their spans from the placement of its sequence, ``kv_length``)."""
        name, dim, length = kv_length(tree, axes)
        x = tree[name]
        spans: Dict[int, Tuple[int, int]] = {}
        for m, c in enumerate(self.members):
            lo, hi, _ = x.sharding.index(c, x.shape)[dim].indices(length)
            if (lo, hi) not in spans.values():
                spans[m] = (lo, hi)
        blocks = {m: {k: cache_block(x, self.members[m])
                      for k, x in tree.items()} for m in spans}
        return KVBlocks(blocks, spans, length)

    def whole(self, x: ShardedTensor, axes) -> torch.Tensor:
        """A cache leaf for the rank's rows, whole on its first
        coordinate (an alias of the stored tensor where its device holds
        it whole; else assembled, and written back by ``write_back``)."""
        region = self._region(x, axes)
        t = x.gather_layer(self.device, None, self.traffic["copies"],
                           self.members[0], region)
        if self.device not in x.bases:
            self.states.append((x, t, region))
        return t

    @torch.no_grad()
    def write_back(self) -> None:
        """The assembled states into the blocks of the rank's
        coordinates."""
        for x, t, region in self.states:
            want = _box(region, x.shape)
            for c in self.members:
                box = _box(x.sharding.index(c, x.shape), x.shape)
                part = _meet(box, want)
                if part is None:
                    continue
                dst = x.block(c)
                src = t[_within(part, want)]
                self.traffic["copies"].add(src.nbytes, t.device, dst.device)
                dst[_within(part, box)].copy_(src)
        self.states = []

    def blocks(self, x: ShardedTensor, axes):
        """A recurrent conv state placed along ``act_ssm`` as the members'
        blocks of the rank's rows (``tp.Parts`` of views of the stored
        blocks: each member reads and writes its own in place), or None
        where the placement does not split it over the group."""
        want = _box(self._region(x, axes), x.shape)
        dim = axes.index("act_ssm")
        tensors, index = [], []
        for c in self.members:
            box = _box(x.sharding.index(c, x.shape), x.shape)
            part = _meet(box, want)
            tensors.append(x.block(c)[_within(part, box)])
            index.append(tuple(slice(lo, hi) for lo, hi in part))
        if len({ix[dim] for ix in index}) == 1:
            return None
        return Parts(tensors, index)

    def caches(self, tree, axes, split: bool):
        """The rank's view of the placed caches (logical ``axes``, the
        bundle's ``cache_axes()``), as the model takes it: with ``split``
        (the rank's group computes together) each KV cache as its
        members' blocks, each conv state the placement splits along
        ``act_ssm`` as its members' blocks (``blocks``), and the other
        leaves whole on the first member; else every leaf whole there."""
        def leaf(x, ax):
            got = (self.blocks(x, ax) if split and "act_ssm" in ax
                   else None)
            return self.whole(x, ax) if got is None else got
        return map_cache(tree, axes, self.kv if split else None, leaf)


def _rows_of(x, dev, traffic: Traffic, at: Coord) -> torch.Tensor:
    """A batch input on ``dev`` (a ``ShardedTensor`` gathered there)."""
    if isinstance(x, ShardedTensor):
        return x.gather(dev, traffic, at)
    x = torch.as_tensor(x)
    traffic.add(x.nbytes, x.device, torch.device(dev))
    return x.to(dev)


class _Serving:
    """What ``make_spmd_prefill`` and ``make_spmd_decode_step`` share."""

    def __init__(self, bundle, rc: RunConfig, ctx: ShardingCtx,
                 count_flops: bool):
        mesh = ctx.mesh
        self.home = mesh.devices.flat[0]
        if mesh_device(bundle.device) != self.home:
            raise ValueError(f"bundle on {bundle.device}, the mesh's first "
                             f"entry is {self.home}")
        self.bundle, self.rc, self.ctx, self.mesh = bundle, rc, ctx, mesh
        self.ranks = spmd.rank_coords(mesh, spmd.dp_axes(ctx))
        self.plan = spmd.tp_plan(rc, ctx)
        # a rank's group: its coordinates along the tensor-parallel axes
        # (a cache lies on them whether or not the rank computes alone)
        axes = ctx.tp_axes() or tuple(
            a for a in mesh.axis_names if a not in spmd.dp_axes(ctx))
        self.groups = {c: spmd.group_coords(mesh, c, axes)
                       for c in self.ranks}
        self.bundles = {self.home: bundle}
        for c in self.ranks:
            dev = mesh.device(c)
            if dev not in self.bundles:
                self.bundles[dev] = registry.build(rc, device=dev)
        self.count_flops = count_flops

    def __call__(self, body, B: int, caches):
        """``body(rank, tree, tp, caches, dev)`` for each active rank,
        its logits put together in row order on the mesh's first entry.
        Sets the call's ``traffic``, ``gathered_peak`` and
        ``coord_flops``."""
        mesh, plan = self.mesh, self.plan
        traffic = {k: Traffic() for k in KINDS}
        # rows that do not split over the ranks are computed by the first
        # (the reference's batch placement is then dropped)
        active = (self.ranks if B % len(self.ranks) == 0
                  else self.ranks[:1])
        rows = B // len(active)
        ledgers = {c: fsdp.Ledger() for c in mesh.coords()}
        flops = CoordFlops() if self.count_flops else None
        out = []
        with flops if flops is not None else contextlib.nullcontext():
            for r, c in enumerate(active):
                members = self.groups[c]
                rank = _Rank(members, r * rows, rows, traffic, mesh)
                if plan is None:
                    members = members[:1]     # the rank computes alone
                group = fsdp.Group([fsdp.Rank(mesh.device(m), m, traffic,
                                              ledgers[m], {})
                                    for m in members], self.by_id,
                                   grads=False)
                tp = None
                if len(members) > 1:
                    tp = TP(self.ctx, [mesh.device(m) for m in members],
                            TPCounts(traffic["all_reduced"],
                                     traffic["copies"],
                                     exchanged=traffic["exchanged"],
                                     logits=traffic["logits"],
                                     states=traffic["states"],
                                     tp_gathered=traffic["tp_gathered"],
                                     tp_scattered=traffic["tp_scattered"]),
                            names=members if flops is not None else None)
                if flops is not None:
                    flops.default = c
                tree = self.tree(group)
                view = rank.caches(caches, self.bundle.cache_axes(),
                                   tp is not None)
                logits = body(rank, tree, tp, view, mesh.device(c))
                del tree
                rank.write_back()
                group.release()
                out.append(logits.to(self.home))
        for x in _leaves(caches):
            x.sync_replicas(traffic["replicas"])
        self.traffic = traffic
        self.gathered_peak = max(x.peak for x in ledgers.values())
        self.coord_flops = (None if flops is None else
                            {c: flops.by_scope().get(c, 0)
                             for c in mesh.coords()})
        return torch.cat(out, dim=0)

    def tree(self, group: fsdp.Group):
        """The rank's parameters as the model takes them: the stacked
        leaves as handles gathered a layer at a time, the others gathered
        whole (each at the members' regions of the plan)."""
        return tree_map(lambda x, s: (spmd.stacked_leaf(x, group)
                                      if fsdp.stacked(s)
                                      else group.gather_whole(x)),
                        self.params, self.bundle.specs)

    def check(self, params) -> None:
        """Take a call's parameters (the bundle's tree, placed)."""
        at_path = tree_paths(params)
        if set(at_path) != set(tree_paths(self.bundle.specs)):
            raise ValueError("the parameters' tree is not the bundle's")
        self.params = params
        self.by_id = ({id(x): self.plan[p] for p, x in at_path.items()
                       if p in self.plan} if self.plan is not None else {})


def _publish(fn, state: _Serving) -> None:
    fn.traffic = getattr(state, "traffic", None)
    fn.gathered_peak = getattr(state, "gathered_peak", None)
    fn.coord_flops = getattr(state, "coord_flops", None)


def make_spmd_prefill(bundle, rc: RunConfig, ctx: ShardingCtx,
                      count_flops: bool = False):
    """``prefill(params, batch) -> (logits, caches)`` on ``ctx.mesh``:
    ``params`` a tree of ``ShardedTensor``s placed by ``ctx`` (the train
    profile, as the reference's prefill cells), ``batch`` the bundle's
    prefill inputs (``ShardedTensor``s placed by ``act_batch``, or
    tensors); the logits [B, V] of the last position on the mesh's first
    entry (where ``bundle`` lives), and the caches, new ``ShardedTensor``s
    placed by ``cache_shardings``. After a call, ``prefill.traffic``
    holds its ``Traffic`` by kind (``KINDS``): ``gathered`` (each layer
    onto the coordinates once, the other leaves once), ``all_reduced``
    (the sums of the split blocks' outputs), ``exchanged`` (keys and
    values to the members whose slots they fill), ``logits`` (the
    vocabulary blocks put together), ``states`` (a member's heads or
    channels of a whole recurrent state sent to it and the new ones put
    together on the rank's first member, and the sLSTM's hidden states
    assembled there), ``copies`` (the single controller's own: inputs
    handed to the members, recurrent states gathered and written
    back), ``replicas`` (cache blocks to their copies) and
    ``batch``; ``prefill.gathered_peak`` the most bytes of gathered
    weights a coordinate held at once (``fsdp.peak_bytes(...,
    grads=False)`` of the plan); with ``count_flops``,
    ``prefill.coord_flops`` every coordinate's matmul flops
    (``tp.CoordFlops``), else None. A bundle that is not on the mesh's
    first entry is refused."""
    state = _Serving(bundle, rc, ctx, count_flops)

    def prefill(params, batch):
        state.check(params)
        B = next(iter(batch.values())).shape[0]
        placed = shard_tree(bundle.cache_init(B, rc.shape.seq_len),
                            cache_shardings(bundle, B, ctx))

        def body(rank, tree, tp, caches, dev):
            sub = {k: _rows_of(v, dev, rank.traffic["batch"],
                               rank.members[0])[rank.lo:rank.lo + rank.rows]
                   for k, v in batch.items()}
            logits, _ = state.bundles[dev].prefill(tree, sub, tp=tp,
                                                   caches=caches)
            return logits

        logits = state(body, B, placed)
        _publish(prefill, state)
        return logits, placed

    _publish(prefill, state)
    return prefill


def make_spmd_decode_step(bundle, rc: RunConfig, ctx: ShardingCtx,
                          count_flops: bool = False):
    """``decode_step(params, inp, caches, cur) -> (logits, caches)`` on
    ``ctx.mesh`` (the decode profile): ``inp`` [B, 1] (a tensor, or a
    ``ShardedTensor`` placed by ``act_batch``), ``caches`` as
    ``make_spmd_prefill`` returns them, written in place; ``cur`` the
    absolute position (a Python int). The logits [B, V] on the mesh's
    first entry. ``traffic``, ``gathered_peak`` and ``coord_flops`` as
    ``make_spmd_prefill``'s (no ``exchanged``: each key and value is
    written by the member whose slots hold it, which projects it)."""
    state = _Serving(bundle, rc, ctx, count_flops)

    def decode_step(params, inp, caches, cur: int):
        state.check(params)

        def body(rank, tree, tp, view, dev):
            sub = _rows_of(inp, dev, rank.traffic["batch"],
                           rank.members[0])[rank.lo:rank.lo + rank.rows]
            logits, _ = state.bundles[dev].decode_step(tree, sub, view, cur,
                                                       tp=tp)
            return logits

        logits = state(body, inp.shape[0], caches)
        _publish(decode_step, state)
        return logits, caches

    _publish(decode_step, state)
    return decode_step

