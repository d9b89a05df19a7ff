"""Tensor parallelism as the model sees it in the mesh train step: the
reference's activation constraints made explicit.

Under ``jax.jit`` on a mesh the reference's constraints
(``sharding/rules.py``'s ``act_heads``, ``act_mlp``, ``act_vocab``,
``act_experts``, all on 'model' in the train profile) let XLA split the
products between them over 'model' and all-reduce where a block's output
leaves it. The port's mesh step does it by hand, Megatron's way (no
sequence parallelism): one data-parallel rank's *group*, its coordinates
along the tensor-parallel axes (``ShardingCtx.tp_axes``), computes each
split block once per member, on the member's device, from the member's
own block of the weights (``Parts``), and the members' partial outputs
are summed. The residual stream, the norms, RoPE and the residual adds
stay whole and are computed once a rank, on the group's first member.

- ``Parts``: a weight as the group holds it, member by member (None where
  a member does not compute with it), with each member's region.
- ``TP``: the group. ``blocks`` resolves a constraint point's split
  (``ShardingCtx.tp_blocks``), ``run`` computes a block's members and sums
  them, ``broadcast`` / ``replicate`` / ``all_reduce`` are the moves
  (``sharding/collectives.py``), counted in its ``counts``.
- Serving on a mesh (``sharding/serve.py``) adds the moves of the KV
  cache, which lies on the group along its sequence: ``exchange`` sends
  a prefill member's keys and values to the member whose slots they
  fill, ``combine`` is the flash-decode combine of the members' partial
  attention over their blocks (their maxima, sums and rescaled outputs),
  and ``assemble`` puts the members' vocabulary blocks of the logits
  together.
- The recurrent layers (``act_ssm``: mamba's and mLSTM's channels,
  sLSTM's heads) sum their norms' squares over the members
  (``mean_square``) and their row-split projections' partials
  (``row_sum``), send a member its block of a state the rank holds
  whole (``send``) and put the new blocks back on the first member
  (``put``), assemble the sLSTM's hidden states there (``collect``) and
  hand each member its slice of a sum (``scatter``). A weight region may
  take several slices along one dim (mamba's ``in_proj``: a member's x
  and z columns and the whole B, C, dt tail; ``region_pieces``,
  ``take_region``).
- Sequence parallelism (``train_sp``): the residual stream is a ``Seq``,
  each member's block of the rank's tokens on its device, and the norms
  and residual adds run there; ``run`` all-gathers the blocks before a
  split block (``gather``) and reduce-scatters the members' partial
  outputs over the tokens after it (``scatter_sum``), in place of the
  broadcast and the all-reduce. ``split`` and ``gather(x, [0])`` move a
  whole sequence on the first member to the blocks and back, for the
  parts that run there whole.
- Context parallelism (``kv_seq``): each member attends every query over
  its block of the keys (``attention.attend_partial``), and ``combine``
  joins the partials as it joins the flash-decode ones; ``all_gather``
  puts the members' blocks of a tensor (their query heads) together at
  every member, and ``reduce_scatter`` hands each member its block of a
  sum (its heads of the combined output).
- ``CoordFlops``: ``FlopCounterMode`` with each operation counted under
  the member whose part is running (forward, and its backward, which
  autograd runs between the marks ``run`` puts on the part's input and
  output), else under its ``default``, the rank's first member.

On one device there is no group (``tp=None``) and no ``Parts``: the model
runs as before.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.sharding import collectives as coll

Index = Tuple[slice, ...]


def region_pieces(index: Index) -> Tuple[Optional[int], List[Index]]:
    """A region whose entry along one dim may be a tuple of slices (its
    pieces along that dim, in order) as (that dim, or None, and the
    plain regions of its pieces)."""
    multi = [d for d, e in enumerate(index) if isinstance(e, tuple)]
    if not multi:
        return None, [index]
    if len(multi) > 1:
        raise ValueError(f"a region takes several slices along one dim "
                         f"only: {index}")
    d = multi[0]
    return d, [index[:d] + (s,) + index[d + 1:] for s in index[d]]


def take_region(t: torch.Tensor, index: Index) -> torch.Tensor:
    """``t[index]``, its pieces along a dim of several slices
    concatenated there (``region_pieces``)."""
    d, pieces = region_pieces(index)
    if d is None:
        return t[index]
    return torch.cat([t[ix] for ix in pieces], dim=d)


class Parts:
    """``tensors[i]``: member i's region ``index[i]`` of a weight (the
    slices of the logical tensor, ``region_pieces``), None where member
    i does not compute with it."""

    def __init__(self, tensors: Sequence[Optional[torch.Tensor]],
                 index: Sequence[Optional[Index]]):
        self.tensors, self.index = list(tensors), list(index)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.tensors[i]

    @property
    def members(self) -> List[int]:
        return [i for i, t in enumerate(self.tensors) if t is not None]

    def start(self, i: int, dim: int) -> int:
        """Where member i's region starts along ``dim``."""
        return self.index[i][dim].start or 0

    def unbind(self, n: int) -> List["Parts"]:
        """A stacked weight's ``n`` layers (the regions' leading dim is
        the stack's, whole)."""
        per = [t.unbind(0) if t is not None else [None] * n
               for t in self.tensors]
        index = [None if ix is None else ix[1:] for ix in self.index]
        return [Parts([p[j] for p in per], index) for j in range(n)]


def at(tree, i: int):
    """Member i's tree: each ``Parts`` leaf's tensor, the others as
    they are."""
    if isinstance(tree, dict):
        return {k: at(v, i) for k, v in tree.items()}
    if isinstance(tree, Parts):
        return tree[i]
    return tree


# -- which member an operation belongs to ------------------------------------

# each thread's stack of the parts it runs (autograd runs a card's
# backward on a thread of its own); every push is popped
_SCOPE = threading.local()


def _stack() -> list:
    if not hasattr(_SCOPE, "stack"):
        _SCOPE.stack = []
    return _SCOPE.stack


@contextlib.contextmanager
def scope(name):
    _stack().append(name)
    try:
        yield
    finally:
        _stack().pop()


class _Enter(torch.autograd.Function):
    """Identity on a part's outputs; its backward enters the part."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        _stack().append(ctx.name)
        return (None, *grads)


class _Leave(torch.autograd.Function):
    """Identity on a part's input; its backward leaves the part."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        _stack().pop()
        return grad


class _Recompute(torch.autograd.Function):
    """Identity that saves its input. At the end of a region that
    ``torch.utils.checkpoint`` recomputes, its backward is the region's
    first: it unpacks its saved input and so recomputes the whole region
    on its own thread, before the backward of any member's part (another
    card's thread) asks for a saved tensor. The checkpoint's
    recomputation is not safe to start from two threads at once."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.saved_tensors
        return grad


class _Unseen(torch.autograd.Function):
    """Identity; its backward counts the gradients of ``n`` members a
    probe does not run as all-reduced."""

    @staticmethod
    def forward(ctx, x, counts, n):
        ctx.counts, ctx.n = counts, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.counts.all_reduced.add(ctx.n * grad.nbytes, grad.device,
                                   grad.device)
        return grad, None, None


class _Collect(torch.autograd.Function):
    """The members' blocks put together along ``dim`` on ``home``,
    counted under ``traffic``; backward sends each block's gradient back
    to its member, counted there too."""

    @staticmethod
    def forward(ctx, home, dim, traffic, *parts):
        ctx.dim, ctx.traffic = dim, traffic
        ctx.devices = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        for p in parts[1:]:
            if traffic is not None:
                traffic.add(p.nbytes, p.device, home)
        return torch.cat([p.to(home) for p in parts], dim=dim)

    @staticmethod
    def backward(ctx, grad):
        out = []
        for i, (g, dev) in enumerate(zip(grad.split(ctx.sizes, ctx.dim),
                                         ctx.devices)):
            if i and ctx.traffic is not None:
                ctx.traffic.add(g.nbytes, g.device, dev)
            out.append(g.to(dev))
        return (None, None, None, *out)


class _Parents:
    """Stands in for ``FlopCounterMode``'s module tracker: every
    operation's parents are the whole and the member whose part runs,
    else the counter's ``default``."""

    def __init__(self, counter: "CoordFlops"):
        self.counter = counter

    @property
    def parents(self):
        st = _stack()
        return {"Global", st[-1] if st else self.counter.default}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class CoordFlops(FlopCounterMode):
    """``FlopCounterMode`` whose counts are kept by member
    (``by_scope()``) besides the total; an operation outside every part
    counts under ``default`` (the caller sets it: the rank's first
    member)."""

    def __init__(self):
        super().__init__(display=False)
        if not hasattr(self, "mod_tracker"):
            raise RuntimeError("this torch's FlopCounterMode keeps no "
                               "module tracker to attribute flops by")
        self.default = None
        self.mod_tracker = _Parents(self)

    def by_scope(self) -> dict:
        return {k: sum(v.values()) for k, v in self.flop_counts.items()
                if k != "Global"}


class _Backward(torch.autograd.Function):
    """Identity; its backward counts ``nbytes`` under ``traffic`` (what
    the members a probe does not run would move in backward)."""

    @staticmethod
    def forward(ctx, x, traffic, nbytes):
        ctx.traffic, ctx.nbytes = traffic, nbytes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.traffic.add(ctx.nbytes, grad.device, grad.device)
        return grad, None, None


def _kind(counts, name: str):
    """Where a forward move of kind ``name`` is counted: ``copies`` while
    a recomputed forward runs in backward."""
    if counts is None:
        return None
    return counts.copies if counts.recompute() else getattr(counts, name)


class _Gather(torch.autograd.Function):
    """The blocks ``parts`` (of members ``srcs``) put together along
    ``dim`` at each destination (member, device) of ``dsts``: an
    all-gather, each move between two members counted under
    ``tp_gathered``; backward hands each block the sum of the
    destinations' gradients of it (a reduce-scatter), counted under
    ``tp_scattered``."""

    @staticmethod
    def forward(ctx, dim, srcs, dsts, counts, *parts):
        ctx.dim, ctx.srcs, ctx.dsts, ctx.counts = dim, srcs, dsts, counts
        ctx.devices = [p.device for p in parts]
        ctx.sizes = [p.shape[dim] for p in parts]
        kind = _kind(counts, "tp_gathered")
        out = []
        for j, dev in dsts:
            for i, p in zip(srcs, parts):
                if i != j and kind is not None:
                    kind.add(p.nbytes, p.device, dev)
            out.append(torch.cat([p.to(dev) for p in parts], dim=dim))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        kind = None if ctx.counts is None else ctx.counts.tp_scattered
        out, lo = [], 0
        for i, dev, n in zip(ctx.srcs, ctx.devices, ctx.sizes):
            acc = None
            for (j, _), g in zip(ctx.dsts, grads):
                if g is None:
                    continue
                piece = g.narrow(ctx.dim, lo, n)
                if i != j and kind is not None:
                    kind.add(piece.nbytes, piece.device, dev)
                piece = piece.to(dev)
                acc = piece if acc is None else acc + piece
            out.append(acc)
            lo += n
        return (None,) * 4 + tuple(out)


class _Scatter(torch.autograd.Function):
    """Each destination (member, device, span) of ``dsts`` takes its span
    along ``dim`` of the sum of ``parts`` (of members ``srcs``): a
    reduce-scatter, each move between two members counted under
    ``tp_scattered``; backward hands each part the destinations'
    gradients put together (an all-gather; zeros for spans no
    destination runs), counted under ``tp_gathered``."""

    @staticmethod
    def forward(ctx, dim, srcs, dsts, spans, counts, *parts):
        ctx.dim, ctx.srcs, ctx.dsts, ctx.spans = dim, srcs, dsts, spans
        ctx.counts = counts
        ctx.devices = [p.device for p in parts]
        ctx.shape = parts[0].shape
        kind = _kind(counts, "tp_scattered")
        out = []
        for j, dev, sp in dsts:
            acc = None
            for i, p in zip(srcs, parts):
                piece = p.narrow(dim, sp.start, sp.stop - sp.start)
                if i != j and kind is not None:
                    kind.add(piece.nbytes, p.device, dev)
                acc = (piece.to(dev, copy=True) if acc is None
                       else acc + piece.to(dev))
            out.append(acc)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        kind = None if ctx.counts is None else ctx.counts.tp_gathered
        got = {j: g for (j, _, _), g in zip(ctx.dsts, grads)}
        out = []
        for i, dev in zip(ctx.srcs, ctx.devices):
            pieces = []
            for j, sp in enumerate(ctx.spans):
                g = got.get(j)
                if g is None:
                    shape = list(ctx.shape)
                    shape[ctx.dim] = sp.stop - sp.start
                    pieces.append(torch.zeros(shape, device=dev,
                                              dtype=grads[0].dtype))
                    continue
                if i != j and kind is not None:
                    kind.add(g.nbytes, g.device, dev)
                pieces.append(g.to(dev))
            out.append(torch.cat(pieces, dim=ctx.dim))
        return (None,) * 5 + tuple(out)


class Seq:
    """A rank's residual stream as its group holds it under ``train_sp``:
    split along the sequence (dim 1), ``tensors[k]`` the k-th live
    member's block, tokens ``spans[k]``, on its device (a probe holds its
    first member's alone). Elementwise work runs on each block: ``map``,
    ``+`` and a scalar ``*``."""

    def __init__(self, tensors: Sequence[torch.Tensor],
                 spans: Sequence[slice]):
        self.tensors, self.spans = list(tensors), list(spans)

    @property
    def length(self) -> int:
        return self.spans[-1].stop

    @property
    def shape(self) -> Tuple[int, ...]:
        """The whole sequence's shape."""
        t = self.tensors[0]
        return (t.shape[0], self.length) + tuple(t.shape[2:])

    def map(self, fn: Callable[[int, torch.Tensor], torch.Tensor]
            ) -> "Seq":
        return Seq([fn(m, t) for m, t in enumerate(self.tensors)],
                   self.spans)

    def __add__(self, other):
        if isinstance(other, Seq):
            return Seq([a + b for a, b in zip(self.tensors, other.tensors,
                                              strict=True)], self.spans)
        return self.map(lambda m, t: t + other)

    __radd__ = __add__

    def __mul__(self, k):
        return self.map(lambda m, t: t * k)

    __rmul__ = __mul__


# -- the group ------------------------------------------------------------------


class TP:
    """One data-parallel rank's tensor-parallel group: ``devices[i]`` is
    member i's (``devices[0]`` the rank's own, where the residual stream
    lives), ``names[i]`` its scope in a ``CoordFlops`` count;
    ``counts`` where the moves are counted; ``probe``: only member 0
    computes (the dry run's count of one coordinate on ``meta``), the
    other members' parts left out of every sum."""

    def __init__(self, ctx, devices: Sequence[torch.device],
                 counts: Optional[coll.TPCounts] = None,
                 names: Optional[Sequence] = None, probe: bool = False):
        self.ctx = ctx
        self.devices = [torch.device(d) for d in devices]
        self.counts = counts
        self.names = list(names) if names is not None else None
        self.probe = probe

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def recomputed_first(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, the output of a region the remat checkpoint recomputes,
        marked so that backward recomputes the region on ``home``'s
        thread first (``_Recompute``), where the members are distinct
        cards (autograd runs each card's backward on a thread of its
        own); ``x`` itself on one card."""
        if isinstance(x, Seq):
            return x.map(lambda m, t: self.recomputed_first(t))
        if (len(set(self.devices)) == 1 or not torch.is_grad_enabled()
                or not x.requires_grad):
            return x
        return _Recompute.apply(x)

    def blocks(self, shape: Sequence[int],
               axes: Sequence[Optional[str]]) -> List[Index]:
        """Each member's block of the activation at a constraint point
        (``ShardingCtx.tp_blocks``)."""
        return self.ctx.tp_blocks(shape, axes)

    @staticmethod
    def members(blocks: Sequence[Index]) -> List[int]:
        """The members that compute: the first of each distinct block
        (``[0]`` alone: the part is not split)."""
        seen, out = set(), []
        for i, b in enumerate(blocks):
            key = tuple((s.start, s.stop) for s in b)
            if key not in seen:
                seen.add(key)
                out.append(i)
        return out

    def live(self, members: Sequence[int]) -> List[int]:
        """The members of ``members`` that run (a probe's first only)."""
        return [m for m in members if m == 0] if self.probe else list(members)

    def broadcast(self, x: torch.Tensor, members: Sequence[int]
                  ) -> List[torch.Tensor]:
        """``x`` (on ``home``) at each of ``members``' devices."""
        live = self.live(members)
        if len(live) < len(members) and x.requires_grad and self.counts:
            x = _Unseen.apply(x, self.counts, len(members) - len(live))
        return coll.broadcast(x, [self.devices[m] for m in live],
                              self.counts)

    def replicate(self, x: torch.Tensor, members: Sequence[int]
                  ) -> List[torch.Tensor]:
        """``x`` with no gradient at each of ``members``' devices."""
        return self.broadcast(x.detach(), members)

    def all_reduce(self, parts: Sequence[torch.Tensor],
                   members: Sequence[int], op: str = "sum") -> torch.Tensor:
        """The sum (``op='max'``: the maximum) of ``members``' parts, on
        ``home``."""
        unseen = len(members) - len(parts)
        if unseen and self.counts is not None:     # a probe's: counted
            kind = (self.counts.copies if self.counts.recompute()
                    else self.counts.all_reduced)
            kind.add(unseen * parts[0].nbytes, self.home, self.home)
        return coll.all_reduce(parts, self.home, op, self.counts)

    def _name(self, m: int):
        return self.names[m] if self.names is not None else None

    @contextlib.contextmanager
    def part(self, m: int):
        """Member m's part runs within (its operations counted under it)."""
        if self.names is None:
            yield
            return
        with scope(self._name(m)):
            yield

    def marks(self, x: torch.Tensor) -> bool:
        """Whether a part on input ``x`` gets its backward marks: flops are
        counted and ``x`` takes a gradient (a part marked on its outputs
        alone would never leave)."""
        return (self.names is not None and torch.is_grad_enabled()
                and x.requires_grad)

    def enter(self, m: int, *outs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Mark a part's outputs: backward enters member m's part there."""
        return _Enter.apply(self._name(m), *outs)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """Mark a part's input: backward leaves the part there."""
        return _Leave.apply(x)

    # -- serving: the KV cache along the group ----------------------------
    def exchange(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """``t``, computed at member ``src``, at member ``dst``'s device
        (``t`` itself where they are one member), counted under
        ``exchanged`` (a probe counts what its first member sends)."""
        if src == dst:
            return t
        if self.counts is not None and self.counts.exchanged is not None:
            self.counts.exchanged.add(t.nbytes, self.devices[src],
                                      self.devices[dst])
        return t.to(self.devices[dst])

    def exchange_unseen(self, nbytes: int, src: int, dst: int) -> None:
        """Count what member ``src``, which a probe does not run, would
        send member ``dst``, as the probe's own."""
        if self.counts is not None and self.counts.exchanged is not None:
            self.counts.exchanged.add(nbytes, self.home, self.home)

    def combine(self, parts: Sequence[Tuple[torch.Tensor, ...]],
                members: Sequence[int]) -> List[torch.Tensor]:
        """The flash-decode combine of ``members``' partial attention
        (``attention.decode_partial``: each live member's row maxima,
        sums and unnormalised output over its block of the cache): the
        maximum M over the members, and each member's output rescaled by
        exp(mx − M) over the sum of the members' rescaled sums, float32,
        on the member's device (the outputs' sum over the members is the
        softmax over the whole cache). The maxima and sums are reduced
        here; the rescaled outputs are summed by the caller, after the
        out-projection. The sums and outputs carry their gradients
        through (``attention.attend_partial``'s, to train under
        ``kv_seq``); the maxima carry none."""
        live = self.live(members)
        mx = self.all_reduce([p[0] for p in parts], members, "max")
        mx = dict(zip(live, self.replicate(mx, members)))
        scale = {m: torch.exp(p[0] - mx[m]) for m, p in zip(live, parts)}
        total = self.all_reduce([p[1] * scale[m]
                                 for m, p in zip(live, parts)], members)
        total = dict(zip(live, self.broadcast(total, members)))
        return [p[2].float() * (scale[m] / total[m])
                for m, p in zip(live, parts)]

    def assemble(self, parts: Sequence[torch.Tensor], members: Sequence[int],
                 dim: int = -1) -> torch.Tensor:
        """``members``' blocks of a tensor along ``dim`` put together in
        order on ``home``, the members' but the first counted under
        ``logits`` (a probe's: its first member's block, the others'
        counted as its)."""
        live = self.live(members)
        out = []
        for m, t in zip(live, parts):
            if m and self.counts is not None and self.counts.logits:
                self.counts.logits.add(t.nbytes, t.device, self.home)
            out.append(t.to(self.home))
        unseen = len(members) - len(live)
        if unseen and self.counts is not None and self.counts.logits:
            self.counts.logits.add(unseen * parts[0].nbytes, self.home,
                                   self.home)
        return torch.cat(out, dim=dim)

    # -- the recurrent layers' blocks -----------------------------------
    def mean_square(self, parts: Sequence[torch.Tensor],
                    members: Sequence[int], width: int
                    ) -> List[torch.Tensor]:
        """The mean square over a dim of ``width`` whose blocks ``parts``
        (float32, by live member) the members hold: their sums of squares
        ([.., 1]) all-reduced on ``home`` and divided by ``width``, handed
        back to each live member (a norm over a recurrent layer's whole
        inner dim)."""
        sums = self.all_reduce([(t * t).sum(dim=-1, keepdim=True)
                                for t in parts], members)
        return self.broadcast(sums / width, members)

    def row_sum(self, parts: Sequence[torch.Tensor],
                members: Sequence[int]) -> torch.Tensor:
        """The sum of a row-split projection's partial outputs (a
        recurrent layer's ``out_proj`` / ``down_proj``), on ``home``."""
        return self.all_reduce(parts, members)

    def _states(self):
        return None if self.counts is None else self.counts.states

    def send(self, t: torch.Tensor, m: int) -> torch.Tensor:
        """``t`` (on ``home``, no gradient: a member's block of a state
        the rank holds whole) at member m's device, counted under
        ``states``."""
        if m and self._states() is not None:
            self._states().add(t.nbytes, self.home, self.devices[m])
        return t.to(self.devices[m])

    def put(self, dst: torch.Tensor, t: torch.Tensor, m: int) -> None:
        """Member m's new block ``t`` of a state the rank holds whole into
        ``dst`` (its view on ``home``), counted under ``states``."""
        if m and self._states() is not None:
            self._states().add(t.nbytes, t.device, self.home)
        dst.copy_(t)

    def states_unseen(self, nbytes: int, members: Sequence[int]) -> None:
        """A probe's count of the ``nbytes`` of state blocks each member
        it does not run would take and give back, as its own."""
        unseen = len(members) - len(self.live(members))
        if unseen and self._states() is not None:
            self._states().add(unseen * nbytes, self.home, self.home)

    def collect(self, parts: Sequence[torch.Tensor], members: Sequence[int],
                dim: int) -> torch.Tensor:
        """``members``' blocks of a tensor, in order along ``dim``, put
        together on ``home`` (their gradients sent back), the members'
        but the first counted under ``states``. A probe has its first
        member's block alone: copies of it stand in for the others' (the
        shape is the whole's), counted as they would be."""
        unseen = len(members) - len(self.live(members))
        if unseen:
            parts = list(parts) + [parts[0]] * unseen
        if len(parts) == 1:
            return parts[0]
        return _Collect.apply(self.home, dim, self._states(), *parts)

    def scatter(self, x: torch.Tensor, blocks: Sequence[Index],
                members: Sequence[int]) -> List[torch.Tensor]:
        """Each of ``members``' block ``blocks[m]`` of ``x`` (on ``home``:
        a sum whose slices the members compute on) at its device, with
        its gradient sent back: a broadcast of each block to its member
        alone (``copies`` forward, ``all_reduced`` backward, as
        ``broadcast``)."""
        out = []
        for m in self.live(members):
            part = x[blocks[m]]
            if m == 0:
                out.append(part)
                continue
            out.append(coll.broadcast(part, [self.home, self.devices[m]],
                                      self.counts)[1])
        unseen = len(members) - len(self.live(members))
        if unseen and x.requires_grad and self.counts is not None:
            out[0] = _Unseen.apply(out[0], self.counts, unseen)
        return out

    # -- sequence parallelism (train_sp) and context parallelism (kv_seq) --
    def seq_spans(self, S: int) -> Optional[List[slice]]:
        """Each member's tokens of a sequence of ``S`` where the group
        splits the residual stream's sequence (``act_seq``: ``train_sp``),
        None where it does not (another profile, or ``S`` that does not
        divide the group)."""
        if "act_seq" not in self.ctx.tp_splits():
            return None
        blocks = self.blocks((1, S, 1), ("act_batch", "act_seq", None))
        if len(self.members(blocks)) == 1:
            return None
        return [b[1] for b in blocks]

    def _probe_moves(self, out: torch.Tensor, fwd: str, bwd: str,
                     nbytes: int) -> torch.Tensor:
        """A probe's count of a collective's ``nbytes`` (the group's
        whole), forward under ``fwd`` and, where ``out`` takes a
        gradient, backward under ``bwd``."""
        if self.counts is None or not nbytes:
            return out
        kind = _kind(self.counts, fwd)
        if kind is not None:
            kind.add(nbytes, self.home, self.home)
        if out.requires_grad and getattr(self.counts, bwd) is not None:
            out = _Backward.apply(out, getattr(self.counts, bwd), nbytes)
        return out

    def all_gather(self, parts: Sequence[torch.Tensor],
                   members: Sequence[int], dim: int,
                   dsts: Optional[Sequence[int]] = None
                   ) -> List[torch.Tensor]:
        """``members``' blocks (by live member) put together along ``dim``
        at each live member of ``dsts`` (default ``members``), the
        gradient of each block summed back at its member. A probe's
        first member has its own block alone: copies of it stand in for
        the others', and the group's moves are counted as its."""
        dsts = list(members if dsts is None else dsts)
        live = self.live(dsts)
        parts = list(parts)
        if self.probe:
            parts += [parts[0]] * (len(members) - len(parts))
        if len(parts) == 1 and dsts == [members[0]]:
            return parts
        counts = None if self.probe else self.counts
        out = list(_Gather.apply(dim, tuple(members),
                                 tuple((m, self.devices[m]) for m in live),
                                 counts, *parts))
        if self.probe:
            out[0] = self._probe_moves(out[0], "tp_gathered", "tp_scattered",
                                       len(dsts) * (len(members) - 1)
                                       * parts[0].nbytes)
        return out

    def reduce_scatter(self, parts: Sequence[torch.Tensor],
                       members: Sequence[int], spans: Sequence[slice],
                       dim: int) -> List[torch.Tensor]:
        """Member j's ``spans[j]`` along ``dim`` of the sum of
        ``members``' parts (by live member), at each live member of the
        group; one part: a scatter. A probe counts the group's moves as
        its first member's."""
        srcs = tuple(self.live(members))
        dsts = tuple((j, self.devices[j], spans[j])
                     for j in self.live(range(len(spans))))
        counts = None if self.probe else self.counts
        out = list(_Scatter.apply(dim, srcs, dsts, tuple(spans), counts,
                                  *parts))
        if self.probe:
            k, n = len(members), len(spans)
            out[0] = self._probe_moves(out[0], "tp_scattered",
                                       "tp_gathered",
                                       k * (n - 1) * parts[0].nbytes // n)
        return out

    def gather(self, x: Seq, members: Sequence[int]) -> List[torch.Tensor]:
        """The whole sequence of ``x`` at each of ``members``' (live)
        devices: the all-gather before a split block (``[0]``: the
        sequence put together on the first member)."""
        return self.all_gather(x.tensors, range(len(x.spans)), 1, members)

    def scatter_sum(self, parts: Sequence[torch.Tensor],
                    members: Sequence[int], spans: Sequence[slice]) -> Seq:
        """The sum of ``members``' partial outputs (whole sequences) as
        the members' token blocks: the reduce-scatter after a split
        block."""
        return Seq(self.reduce_scatter(parts, members, spans, 1), spans)

    def split(self, x: torch.Tensor, spans: Sequence[slice]) -> Seq:
        """``x``, a whole sequence on the first member, as the members'
        token blocks (a scatter; its gradient gathered back)."""
        return self.scatter_sum([x], [0], spans)

    def apply(self, m: int, xm: torch.Tensor,
              fn: Callable[[int, torch.Tensor], object]
              ) -> Tuple[torch.Tensor, ...]:
        """Member m's part ``fn(m, xm)`` on its input ``xm`` (already at
        its device), its outputs as a tuple, marked for backward's count
        where ``marks``."""
        mark = self.marks(xm)
        with self.part(m):
            y = fn(m, self.leave(xm) if mark else xm)
        ys = y if isinstance(y, tuple) else (y,)
        return self.enter(m, *ys) if mark else ys

    def run(self, x: torch.Tensor, members: Sequence[int],
            fn: Callable[[int, torch.Tensor], object]):
        """Σ over ``members`` of ``fn(m, x at member m)``, on ``home``.
        ``fn`` may return a tuple: its first element is summed, the rest
        are the first member's. ``x`` a ``Seq`` (``train_sp``): the
        members' blocks are all-gathered at each of ``members`` and the
        sum is reduce-scattered over the tokens, a ``Seq`` too."""
        outs, rest = [], None
        xs = (self.gather(x, members) if isinstance(x, Seq)
              else self.broadcast(x, members))
        for m, xm in zip(self.live(members), xs):
            ys = self.apply(m, xm, fn)
            outs.append(ys[0])
            if rest is None:
                rest = ys[1:]
        out = (self.scatter_sum(outs, members, x.spans) if isinstance(x, Seq)
               else self.all_reduce(outs, members))
        return (out, *rest) if rest else out
