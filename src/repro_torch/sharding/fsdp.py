"""One layer's weights at a time: the seam between the mesh train step
(``training/spmd.py``) and the models.

The reference runs its layers in a ``jax.lax.scan`` over the stacked
'layers' dim under ``jax.jit`` on a mesh whose weights are sharded, so
XLA gathers each layer's blocks inside the loop body. The port's step
does the same by hand:

- A stacked leaf (leading dim 'layers', never sharded) reaches the model
  as a ``Stacked`` handle. ``models/transformer.py::_unstack`` turns it
  into one ``LayerRef`` per layer, and the layer's run gathers its refs
  itself: inside the function that ``_remat``'s checkpoint recomputes
  (``gathered``), so backward gathers the layer again; or, without
  remat, under ``saved_tensors_hooks`` (``hooked``) that save a gathered
  weight as its handle and gather the layer again when backward first
  needs it. Either way no gathered layer is saved for backward.
- Every gather goes through ``_Gather``, an autograd function: forward
  returns the gathered tensor, backward adds its gradient into the
  owners' float32 accumulators (the reduce-scatter of that layer's
  gradient) and returns nothing for the storage.
- A leaf outside the stacks (embedding, head, final norm) is gathered
  once per microbatch and rank and held through that backward.
- With tensor parallelism (``sharding/tp.py``) a data-parallel rank is a
  ``Group`` of ``Rank``s, one for each coordinate of its tensor-parallel
  group (its 'model' coordinates), and the step's *plan* (by leaf:
  ``None``, the leaf whole on the group's first member, else each
  member's region of it or ``None``) says what each member gathers: its
  own block of a split weight, gathered over the other axes only, or a
  replicated weight whole where its part reads it. The model then sees
  ``tp.Parts`` where it sees a tensor without a mesh.
- Each coordinate's ``Ledger`` holds the bytes of each tensor gathered
  there, with those of the float32 gradient it will receive (a stacked
  layer's from its gather in backward, the other leaves' from their
  gather), from the gather until the gathered tensor is freed. The most
  any one holds is the step's ``gathered_peak``; ``peak_bytes`` reckons
  the same from the specs and the plan.

Under remat ``'none'`` the rest of what autograd saves of a layer stays
saved as it is: activations, and a weight's cast to the compute dtype
(bf16 models), which is a copy and not the gathered tensor.

Serving on a mesh (``sharding/serve.py``) gathers through the same
seam forward only (``Group(grads=False)``): no autograd function, no
gradient accumulators, no reduce-scatter, and a ledger of the weights
alone (``peak_bytes(..., grads=False)``).

With plain tensors (one device, ``dp_shardmap.py``, ``pipeline.py``) the
model's trees hold no handle and the seam does nothing.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.module import ParamSpec, tree_paths
from repro_torch.sharding.collectives import Traffic
from repro_torch.sharding.mesh import Coord
from repro_torch.sharding.placement import ShardedTensor
from repro_torch.sharding.tp import Parts, region_pieces

GRAD_BYTES = 4          # the gradients are float32


def stacked(spec: ParamSpec) -> bool:
    """Whether a leaf is stacked over the layers of a stage."""
    return spec.axes[:1] == ("layers",)


def _size(s: ParamSpec, dtype: Optional[torch.dtype]) -> int:
    return torch.empty((), dtype=dtype or s.dtype).element_size()


def _regions(path, s: ParamSpec, plan) -> List[Tuple[int, tuple]]:
    """(member, region) of each member that gathers a leaf, by the plan
    (``None``: the first member, whole)."""
    p = plan.get(path) if plan is not None else None
    if p is None:
        return [(0, tuple(slice(None) for _ in s.shape))]
    return [(m, ix) for m, ix in enumerate(p) if ix is not None]


def _region_numel(s: ParamSpec, index) -> int:
    total = 0
    for piece in region_pieces(tuple(index))[1]:
        n = 1
        for d, sl in zip(s.shape, piece):
            lo, hi, _ = sl.indices(d)
            n *= hi - lo
        total += n
    return total


def _per_member(specs, dtype, plan, stacks: bool,
                grads: bool = True) -> Dict[int, int]:
    other: Dict[int, int] = {}
    layer: Dict[int, Dict[str, int]] = {}
    for path, s in tree_paths(specs).items():
        for m, ix in _regions(path, s, plan):
            nb = _region_numel(s, ix) * (_size(s, dtype)
                                         + grads * GRAD_BYTES)
            if stacks and stacked(s):
                per = layer.setdefault(m, {})
                per[path[0]] = per.get(path[0], 0) + nb // s.shape[0]
            else:
                other[m] = other.get(m, 0) + nb
    return {m: other.get(m, 0) + max(layer.get(m, {}).values(), default=0)
            for m in set(other) | set(layer)}


def peak_bytes(specs, dtype: Optional[torch.dtype] = None,
               plan: Optional[Dict[tuple, list]] = None,
               grads: bool = True) -> int:
    """The most a coordinate of the mesh step holds at once of gathered
    weights (in ``dtype``, else their specs') and their float32
    gradients (``grads``; a serving call's forward-only gathers hold
    none): every leaf outside the stacks, and the largest layer of any
    stack (the stacked leaves under one top-level key are one stack),
    each at the region the ``plan`` (by leaf path, see the module note)
    gives the coordinate; the busiest coordinate's."""
    return max(_per_member(specs, dtype, plan, True, grads).values())


def whole_bytes(specs, dtype: Optional[torch.dtype] = None,
                plan: Optional[Dict[tuple, list]] = None) -> int:
    """The whole tree's weights (in ``dtype``, else their specs') and
    float32 gradients, at the regions the busiest coordinate gathers."""
    return max(_per_member(specs, dtype, plan, False).values())


class Ledger:
    """The bytes a step holds of gathered weights and their gradients.
    Each ``hold`` lasts until the step lets go of its tensor
    (``_Hold.end('released')``) and the tensor is freed, whichever comes
    last: a tensor kept alive past its release stays counted. Holds begin
    and end on autograd's threads too (one a card)."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self.lock = threading.Lock()

    def hold(self, t: torch.Tensor, nbytes: int) -> "_Hold":
        with self.lock:
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        h = _Hold(self, nbytes)
        weakref.finalize(t, h.end, "freed")
        return h


class _Hold:
    def __init__(self, ledger: Ledger, nbytes: int):
        self.ledger, self.nbytes = ledger, nbytes
        self.open = {"freed", "released"}

    def end(self, why: str) -> None:
        with self.ledger.lock:
            if why in self.open:
                self.open.discard(why)
                if not self.open:
                    self.ledger.live -= self.nbytes


def _release(holds: List[_Hold]) -> None:
    for h in holds:
        h.end("released")


class Rank:
    """One coordinate of a data-parallel rank's group (``device``,
    coordinate ``at``): what it counts (``traffic``'s ``gathered`` and
    ``reduce_scattered``, its ``ledger``) and the owners' accumulators its
    gradients go to (``accs``: by ``id`` of a ``ShardedTensor``, one per
    ``owned_keys`` entry)."""

    def __init__(self, device: torch.device, at: Coord,
                 traffic: Dict[str, Traffic], ledger: Ledger,
                 accs: Dict[int, List[torch.Tensor]]):
        self.device, self.at = device, at
        self.traffic, self.ledger, self.accs = traffic, ledger, accs
        self.token = torch.zeros((), device=device, requires_grad=True)

    def take(self, x: ShardedTensor, layer: Optional[int], index,
             grad: bool) -> Tuple[torch.Tensor, "_Hold"]:
        """The gather itself (``x``'s layer ``layer``, its region
        ``index``): counted, and held in the ledger (with the gradient it
        will receive, where ``grad``) until its holder releases it."""
        d, pieces = (None, [index]) if index is None else \
            region_pieces(tuple(index))
        ts = [x.gather_layer(self.device, layer, self.traffic["gathered"],
                             self.at, ix) for ix in pieces]
        t = ts[0] if d is None else torch.cat(ts, dim=d - (layer is not None))
        return t, self.ledger.hold(t, t.nbytes
                                   + grad * GRAD_BYTES * t.numel())

    def scatter(self, x: ShardedTensor, layer: Optional[int], index,
                grad: torch.Tensor) -> None:
        d, pieces = (None, [index]) if index is None else \
            region_pieces(tuple(index))
        grads = [grad] if d is None else grad.split(
            [p[d].indices(x.shape[d])[1] - p[d].indices(x.shape[d])[0]
             for p in pieces], dim=d - (layer is not None))
        for ix, g in zip(pieces, grads, strict=True):
            x.scatter_add(g, self.accs[id(x)], layer, ix)
            x.count_scatter(self.at, self.traffic["reduce_scattered"],
                            layer is not None, ix)


class Group:
    """One data-parallel rank's run of one microbatch: its ``members``
    (a ``Rank`` for each coordinate of its tensor-parallel group, the
    first the rank's own) and the ``plan`` by ``id`` of a leaf (see the
    module note; a leaf it leaves out is the first member's, whole).

    What it holds: the leaves outside the stacks until the end of its
    backward; a layer gathered in forward until that layer's run ends;
    the layer gathered again in backward until backward gathers the
    next (``let_go``) or ends."""

    def __init__(self, members: List[Rank], plan: Dict[int, list],
                 grads: bool = True):
        self.members, self.plan, self.grads = members, plan, grads
        self.in_backward = False
        self.fresh: List[_Hold] = []       # gathered, not yet claimed
        self.whole: List[_Hold] = []       # the leaves outside the stacks
        self.held: Tuple[List[_Hold], Optional[_Hooks]] = ([], None)

    def _each(self, x: ShardedTensor, layer: Optional[int], fn):
        """``fn(rank, index)`` at the first member (whole) where the plan
        leaves ``x`` out, else a ``tp.Parts`` of it (of its layer
        ``layer``) at each member the plan names."""
        p = self.plan.get(id(x))
        if p is None:
            return fn(self.members[0], None)
        index = p if layer is None else [None if ix is None else ix[1:]
                                         for ix in p]
        return Parts([None if ix is None else fn(r, ix)
                      for r, ix in zip(self.members, p)], index)

    def gather(self, x: ShardedTensor, layer: Optional[int] = None):
        """``x`` (its layer ``layer``) at its members, through the seam
        (forward only: gathered, with no gradient to send back)."""
        if not self.grads:
            return self.take(x, layer)
        return self._each(x, layer, lambda r, ix: _Gather.apply(
            r.token, self, r, x, layer, ix))

    def take(self, x: ShardedTensor, layer: Optional[int]):
        """``gather`` outside autograd (backward's gather again)."""
        return self._each(x, layer, lambda r, ix: self.take_at(
            r, x, layer, ix))

    def take_at(self, rank: Rank, x: ShardedTensor, layer: Optional[int],
                index) -> torch.Tensor:
        """``rank``'s gather, held (with the gradient it will receive,
        where that comes while it is held) until its holder claims and
        releases it."""
        t, hold = rank.take(x, layer, index, self.grads and (
            self.in_backward or layer is None))
        self.fresh.append(hold)
        return t

    def gather_whole(self, x: ShardedTensor):
        """``x`` whole, held until the end of this rank's backward."""
        t = self.gather(x)
        self.whole += self.claim()
        return t

    def claim(self) -> List[_Hold]:
        out, self.fresh = self.fresh, []
        return out

    def let_go(self) -> None:
        """Let go of the layer backward gathered last (its backward is
        done: the next layer's needs the gradient of its input)."""
        holds, hooks = self.held
        _release(holds)
        if hooks is not None:
            hooks.back = None
        self.held = ([], None)

    def backward(self, loss: torch.Tensor) -> None:
        """``loss.backward()``, the layers gathered again as it needs
        them; then everything this rank gathered is let go."""
        self.in_backward = True
        try:
            loss.backward()
        finally:
            self.in_backward = False
            self.release()

    def release(self) -> None:
        """Let go of everything this rank gathered."""
        self.let_go()
        _release(self.whole)
        self.whole = []


class _Gather(torch.autograd.Function):
    """Forward: the gathered tensor. Backward: its gradient into the
    owners' accumulators; nothing for the storage (``token`` only makes
    autograd call this backward)."""

    @staticmethod
    def forward(ctx, token, group: Group, rank: Rank, x: ShardedTensor,
                layer: Optional[int], index):
        ctx.src = (rank, x, layer, index)
        return group.take_at(rank, x, layer, index)

    @staticmethod
    def backward(ctx, grad):
        rank, x, layer, index = ctx.src
        rank.scatter(x, layer, index, grad)
        return None, None, None, None, None, None


class Stacked:
    """A stacked leaf as the model sees it on a mesh: gathered a layer at
    a time through ``layers``, by its group (``rank``)."""

    def __init__(self, x: ShardedTensor, rank: Group):
        self.x, self.rank = x, rank

    def layers(self, n: int) -> List["LayerRef"]:
        if n != self.x.shape[0]:
            raise ValueError(f"{n} layers of {self.x!r}")
        return [LayerRef(self, i) for i in range(n)]


class LayerRef:
    """Layer ``i`` of a ``Stacked`` leaf, not yet gathered."""

    def __init__(self, stack: Stacked, i: int):
        self.stack, self.i = stack, i

    def gather(self):
        return self.stack.rank.gather(self.stack.x, self.i)


def _refs(tree, out: List[Tuple[Any, LayerRef]], path=()) -> list:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _refs(v, out, path + (k,))
    elif isinstance(tree, LayerRef):
        out.append((path, tree))
    return out


def _put(tree, values: Dict[tuple, torch.Tensor], path=()):
    if isinstance(tree, dict):
        return {k: _put(v, values, path + (k,)) for k, v in tree.items()}
    return values.get(path, tree)


def gathered(fn):
    """``fn(lp, ...)`` with ``lp``'s layer refs gathered first, inside
    the call: under ``torch.utils.checkpoint`` the recomputation in
    backward gathers the layer again."""
    def run(lp, *args, **kwargs):
        refs = _refs(lp, [])
        if not refs:
            return fn(lp, *args, **kwargs)
        rank = refs[0][1].stack.rank
        again = rank.in_backward        # the checkpoint's recomputation
        if again:
            rank.let_go()
        lp = _put(lp, {p: r.gather() for p, r in refs})
        holds = rank.claim()
        if again:
            rank.held = (holds, None)
            return fn(lp, *args, **kwargs)
        try:
            return fn(lp, *args, **kwargs)
        finally:
            _release(holds)
    return run


def _tensors(t) -> List[Tuple[int, torch.Tensor]]:
    """(member, tensor) of a gathered leaf: a tensor (the first
    member's) or a ``tp.Parts``."""
    if isinstance(t, Parts):
        return [(m, t[m]) for m in t.members]
    return [(0, t)]


class _Hooks:
    """One layer's run without remat: its gathered weights, and their
    views, are saved for backward as handles; backward's first unpack
    gathers the layer again (every ref of it, once) and lets go of the
    rank's layer regathered before."""

    def __init__(self, refs: List[Tuple[Any, LayerRef]]):
        self.refs = [r for _, r in refs]
        self.ids: Dict[int, Tuple[int, int]] = {}
        self.back: Optional[List[Dict[int, torch.Tensor]]] = None
        self.lock = threading.Lock()     # members' cards unpack too

    def pack(self, t: torch.Tensor):
        key = self.ids.get(id(t if t._base is None else t._base))
        if key is None:
            return t
        return (key, t.size(), t.stride(), t.storage_offset())

    def unpack(self, saved):
        if isinstance(saved, torch.Tensor):
            return saved
        (j, m), size, stride, offset = saved
        with self.lock:
            if self.back is None:
                group = self.refs[0].stack.rank
                group.let_go()
                self.back = [dict(_tensors(group.take(r.stack.x, r.i)))
                             for r in self.refs]
                group.held = (group.claim(), self)
            back = self.back
        return back[j][m].as_strided(size, stride, offset)


def hooked(fn):
    """``fn(lp, ...)`` with ``lp``'s layer refs gathered first and saved
    for backward as handles (see ``_Hooks``)."""
    def run(lp, *args, **kwargs):
        refs = _refs(lp, [])
        if not refs:
            return fn(lp, *args, **kwargs)
        hooks = _Hooks(refs)
        got = {}
        for j, (p, r) in enumerate(refs):
            got[p] = t = r.gather()
            for m, u in _tensors(t):
                hooks.ids[id(u)] = (j, m)
        holds = refs[0][1].stack.rank.claim()
        try:
            with torch.autograd.graph.saved_tensors_hooks(hooks.pack,
                                                          hooks.unpack):
                return fn(_put(lp, got), *args, **kwargs)
        finally:
            hooks.ids.clear()
            _release(holds)
    return run
