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
- A ``Ledger`` holds the bytes of each gathered tensor, with those of the
  float32 gradient it will receive (a stacked layer's from its gather in
  backward, the other leaves' from their gather), from the gather until
  the gathered tensor is freed. Its peak is the step's ``gathered_peak``;
  ``peak_bytes`` reckons the same from the specs.

Under remat ``'none'`` the rest of what autograd saves of a layer stays
saved as it is: activations, and a weight's cast to the compute dtype
(bf16 models), which is a copy and not the gathered tensor.

With plain tensors (one device, serving, ``dp_shardmap.py``,
``pipeline.py``) the model's trees hold no handle and the seam does
nothing.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.module import ParamSpec, tree_paths
from repro_torch.sharding.collectives import Traffic
from repro_torch.sharding.mesh import Coord
from repro_torch.sharding.placement import ShardedTensor

GRAD_BYTES = 4          # the gradients are float32


def stacked(spec: ParamSpec) -> bool:
    """Whether a leaf is stacked over the layers of a stage."""
    return spec.axes[:1] == ("layers",)


def _numel(s: ParamSpec) -> int:
    n = 1
    for d in s.shape:
        n *= d
    return n


def _size(s: ParamSpec, dtype: Optional[torch.dtype]) -> int:
    return torch.empty((), dtype=dtype or s.dtype).element_size()


def peak_bytes(specs, dtype: Optional[torch.dtype] = None) -> int:
    """The most a rank of the mesh step holds at once of gathered weights
    (in ``dtype``, else their specs') and their float32 gradients: every
    leaf outside the stacks, and the largest layer of any stack (the
    stacked leaves under one top-level key are one stack)."""
    other, layer = 0, {}
    for path, s in tree_paths(specs).items():
        nb = _numel(s) * (_size(s, dtype) + GRAD_BYTES)
        if stacked(s):
            layer[path[0]] = layer.get(path[0], 0) + nb // s.shape[0]
        else:
            other += nb
    return other + max(layer.values(), default=0)


def whole_bytes(specs, dtype: Optional[torch.dtype] = None) -> int:
    """The whole tree's weights (in ``dtype``, else their specs') and
    float32 gradients."""
    return sum(_numel(s) * (_size(s, dtype) + GRAD_BYTES)
               for s in tree_paths(specs).values())


class Ledger:
    """The bytes a step holds of gathered weights and their gradients.
    Each ``hold`` lasts until the step lets go of its tensor
    (``_Hold.end('released')``) and the tensor is freed, whichever comes
    last: a tensor kept alive past its release stays counted."""

    def __init__(self):
        self.live = 0
        self.peak = 0

    def hold(self, t: torch.Tensor, nbytes: int) -> "_Hold":
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
        if why in self.open:
            self.open.discard(why)
            if not self.open:
                self.ledger.live -= self.nbytes


def _release(holds: List[_Hold]) -> None:
    for h in holds:
        h.end("released")


class Rank:
    """One data-parallel rank's run of one microbatch: where it gathers
    (``device``, coordinate ``at``), what it counts (``traffic``'s
    ``gathered`` and ``reduce_scattered``, the ``ledger``) and the
    owners' accumulators its gradients go to (``accs``: by ``id`` of a
    ``ShardedTensor``, one per ``owned_keys`` entry).

    What it holds: the leaves outside the stacks until the end of its
    backward; a layer gathered in forward until that layer's run ends;
    the layer gathered again in backward until backward gathers the
    next (``let_go``) or ends."""

    def __init__(self, device: torch.device, at: Coord,
                 traffic: Dict[str, Traffic], ledger: Ledger,
                 accs: Dict[int, List[torch.Tensor]]):
        self.device, self.at = device, at
        self.traffic, self.ledger, self.accs = traffic, ledger, accs
        self.token = torch.zeros((), device=device, requires_grad=True)
        self.in_backward = False
        self.fresh: List[_Hold] = []       # gathered, not yet claimed
        self.whole: List[_Hold] = []       # the leaves outside the stacks
        self.held: Tuple[List[_Hold], Optional[_Hooks]] = ([], None)

    def gather(self, x: ShardedTensor, layer: Optional[int] = None
               ) -> torch.Tensor:
        """``x`` (its layer ``layer``) on this rank, through the seam."""
        return _Gather.apply(self.token, self, x, layer)

    def gather_whole(self, x: ShardedTensor) -> torch.Tensor:
        """``x`` whole, held until the end of this rank's backward."""
        t = self.gather(x)
        self.whole += self.claim()
        return t

    def take(self, x: ShardedTensor, layer: Optional[int]) -> torch.Tensor:
        """The gather itself: counted, and held in the ledger (with the
        gradient it will receive, where that comes while it is held)
        until its holder claims and releases it."""
        t = x.gather_layer(self.device, layer, self.traffic["gathered"],
                           self.at)
        grad = self.in_backward or layer is None
        self.fresh.append(self.ledger.hold(
            t, t.nbytes + grad * GRAD_BYTES * t.numel()))
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

    def scatter(self, x: ShardedTensor, layer: Optional[int],
                grad: torch.Tensor) -> None:
        x.scatter_add(grad, self.accs[id(x)], layer)
        x.count_scatter(self.at, self.traffic["reduce_scattered"],
                        layer is not None)

    def backward(self, loss: torch.Tensor) -> None:
        """``loss.backward()``, the layers gathered again as it needs
        them; then everything this rank gathered is let go."""
        self.in_backward = True
        try:
            loss.backward()
        finally:
            self.in_backward = False
            self.let_go()
            _release(self.whole)
            self.whole = []


class _Gather(torch.autograd.Function):
    """Forward: the gathered tensor. Backward: its gradient into the
    owners' accumulators; nothing for the storage (``token`` only makes
    autograd call this backward)."""

    @staticmethod
    def forward(ctx, token, rank: Rank, x: ShardedTensor,
                layer: Optional[int]):
        ctx.src = (rank, x, layer)
        return rank.take(x, layer)

    @staticmethod
    def backward(ctx, grad):
        rank, x, layer = ctx.src
        rank.scatter(x, layer, grad)
        return None, None, None, None


class Stacked:
    """A stacked leaf as the model sees it on a mesh: gathered a layer at
    a time through ``layers``."""

    def __init__(self, x: ShardedTensor, rank: Rank):
        self.x, self.rank = x, rank

    def layers(self, n: int) -> List["LayerRef"]:
        if n != self.x.shape[0]:
            raise ValueError(f"{n} layers of {self.x!r}")
        return [LayerRef(self, i) for i in range(n)]


class LayerRef:
    """Layer ``i`` of a ``Stacked`` leaf, not yet gathered."""

    def __init__(self, stack: Stacked, i: int):
        self.stack, self.i = stack, i

    def gather(self) -> torch.Tensor:
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


class _Hooks:
    """One layer's run without remat: its gathered weights, and their
    views, are saved for backward as handles; backward's first unpack
    gathers the layer again (every ref of it, once) and lets go of the
    rank's layer regathered before."""

    def __init__(self, refs: List[Tuple[Any, LayerRef]]):
        self.refs = [r for _, r in refs]
        self.ids: Dict[int, int] = {}
        self.back: Optional[List[torch.Tensor]] = None

    def pack(self, t: torch.Tensor):
        j = self.ids.get(id(t if t._base is None else t._base))
        if j is None:
            return t
        return (j, t.size(), t.stride(), t.storage_offset())

    def unpack(self, saved):
        if isinstance(saved, torch.Tensor):
            return saved
        j, size, stride, offset = saved
        if self.back is None:
            rank = self.refs[0].stack.rank
            rank.let_go()
            self.back = [rank.take(r.stack.x, r.i) for r in self.refs]
            rank.held = (rank.claim(), self)
        return self.back[j].as_strided(size, stride, offset)


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
            hooks.ids[id(t)] = j
        holds = refs[0][1].stack.rank.claim()
        try:
            with torch.autograd.graph.saved_tensors_hooks(hooks.pack,
                                                          hooks.unpack):
                return fn(_put(lp, got), *args, **kwargs)
        finally:
            hooks.ids.clear()
            _release(holds)
    return run
