"""Logical-axis -> mesh-axis sharding rules (MaxText-style), as in the
reference's ``sharding/rules.py``: the same rules, profiles and
resolution against concrete shapes.

A profile maps logical axis names (used in ParamSpec.axes and activation
constraints) to mesh axis names. Rules are resolved against concrete
shapes: a mapping is silently dropped when the dim is not divisible by
the mesh axis size (recorded in ``dropped`` for diagnostics) — this is
what lets one model definition serve every (arch x shape x mesh) cell.

Profiles:
  train   — TP over 'model' (heads or kv-seq per arch), DP over pod+data,
            FSDP ('data') on the weight 'embed'/'vocab' dims.
  decode  — KV cache sharded over sequence ('model', flash-decode style);
            batch over pod+data when divisible, else sequence over data too.

With a mesh, ``sharding`` gives a ``placement.NamedSharding`` (a
weight or batch held as blocks, one per mesh coordinate) and
``spec_tree_shardings`` the tree of them; without one, ``None``, as the
reference's.

Activation constraints. The reference's ``constrain`` is a hint to XLA's
partitioner, which splits the products at the constraint points
(attention's heads, the MLP's columns, the experts, the vocabulary) over
the axes the rules map them to. Torch has no partitioner: the port's mesh
step (``training/spmd.py``) and its mesh serving functions
(``sharding/serve.py``) split them themselves, one data-parallel rank's
tensor-parallel group at a time, and ask this module where.
``tp_axes`` names the group's mesh axes (every axis the batch does not
take), ``tp_splits`` the constraint points the group splits (train:
the heads, the MLP's columns, the experts, the vocabulary and the
recurrent layers' inner dim ``act_ssm``; train_sp: the residual
stream's sequence besides them; kv_seq: the keys' sequence in place of
the heads, context parallelism; decode: the KV cache's sequence in place
of the heads, flash-decode style), and
``tp_blocks(shape, axes)`` gives each member's block of the activation a
constraint point names: ``pspec(shape, axes)`` on those axes, its drops
included (a dim that does not divide stays whole, and the part is
computed replicated). So ``constrain`` itself, with a mesh, still
raises: nothing in the port passes an activation through it.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.models import module as mod

MeshAxes = Union[None, str, Tuple[str, ...]]

_CONSTRAIN = ("an activation constraint on a mesh (with_sharding_constraint) "
              "has no counterpart in the port: its mesh step "
              "(training/spmd.py) splits the constraint points' products "
              "itself, by ShardingCtx.tp_blocks")


def _names(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class PartitionSpec(tuple):
    """A tuple of mesh axes per dim (``None``, a name, or a tuple of
    names), as ``jax.sharding.PartitionSpec``: its ``tuple()`` equals the
    reference's."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


# Weight dims
W_RULES = {
    "vocab": "model",
    "embed": "data",        # FSDP shard of the non-TP weight dim
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "experts": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "layers": None,
    "stage": None,
}

# Activation dims
A_RULES = {
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_kv_seq": None,      # 'model' in kv_seq attention / decode profiles
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",
    "act_ssm": "model",      # mamba/xlstm inner dim
    "cache_seq": "model",    # decode: sequence-sharded KV cache
}


@dataclasses.dataclass
class ShardingCtx:
    """Resolves logical axes to PartitionSpecs for one mesh: anything
    with ``axis_names`` and a name -> size ``shape`` (a ``DeviceMesh``),
    or ``None``."""

    mesh: Optional[object]
    rules: Dict[str, MeshAxes]
    dropped: list = dataclasses.field(default_factory=list)
    profile: str = "train"

    # -- resolution ---------------------------------------------------------
    def _axis_size(self, names: MeshAxes) -> int:
        if names is None or self.mesh is None:
            return 1
        if isinstance(names, str):
            names = (names,)
        size = 1
        for n in names:
            size *= dict(self.mesh.shape).get(n, 1)
        return size

    def _mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        axes = self.rules.get(logical)
        if axes is None or self.mesh is None:
            return None
        if isinstance(axes, str):
            axes = (axes,)
        present = tuple(a for a in axes if a in self.mesh.axis_names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]

    def pspec(self, shape: Sequence[int],
              axes: Sequence[Optional[str]],
              record: bool = True) -> PartitionSpec:
        entries = []
        used = set()
        for dim, logical in zip(shape, axes):
            m = self._mesh_axes(logical)
            if m is None:
                entries.append(None)
                continue
            key = (m,) if isinstance(m, str) else tuple(m)
            if used & set(key):  # a mesh axis may appear once per spec
                entries.append(None)
                continue
            if dim % self._axis_size(m) != 0:
                if record:
                    self.dropped.append((tuple(shape), logical, m))
                entries.append(None)
                continue
            entries.append(m)
            used |= set(key)
        while entries and entries[-1] is None:
            entries.pop()
        return PartitionSpec(*entries)

    def sharding(self, shape, axes):
        """``None`` without a mesh, as the reference's; with one, the
        ``NamedSharding`` of ``pspec(shape, axes)``."""
        if self.mesh is None:
            return None
        from repro_torch.sharding.placement import NamedSharding
        return NamedSharding(self.mesh, self.pspec(shape, axes))

    # -- tensor parallelism ---------------------------------------------------
    def tp_axes(self) -> Tuple[str, ...]:
        """The mesh axes of a data-parallel rank's tensor-parallel group:
        every axis of the mesh that ``act_batch`` does not map to, in mesh
        order, under every profile. What the group splits is the
        profile's (``tp_splits``): the heads under ``train`` and
        ``zero1``, the residual stream's sequence besides them under
        ``train_sp``, the keys' sequence in place of the heads under
        ``kv_seq`` and ``decode``. ``dp_only`` keeps no group: its
        ``act_batch`` spans every axis."""
        if self.mesh is None:
            return ()
        batch = _names(self._mesh_axes("act_batch"))
        return tuple(a for a in self.mesh.axis_names if a not in batch)

    def tp_splits(self) -> Tuple[str, ...]:
        """The constraint points whose activations the group splits: of
        ``act_seq``, ``act_heads``, ``act_kv_seq``, ``act_mlp``,
        ``act_experts``, ``act_vocab`` and ``act_ssm``, those the rules
        map onto the group's axes. Under ``train``: the heads, the MLP,
        the experts, the vocabulary and the recurrent layers' inner dim
        (mamba's and mLSTM's channels, sLSTM's heads); under ``train_sp``
        the residual stream's sequence besides them (Megatron sequence
        parallelism: the norms and residual adds on a member's tokens,
        the split blocks on the gathered sequence); under ``kv_seq`` the
        keys' sequence (context parallelism: each member attends every
        query over its block of the keys), the MLP, the experts, the
        vocabulary and the recurrent inner dim, the heads whole; under
        ``decode``: the KV cache's sequence (the cache lies on the group
        along ``cache_seq``), the MLP, the experts, the vocabulary and
        the recurrent inner dim, the heads whole."""
        tp = set(self.tp_axes())
        return tuple(a for a in ("act_seq", "act_heads", "act_kv_seq",
                                 "act_mlp", "act_experts", "act_vocab",
                                 "act_ssm")
                     if tp and _names(self._mesh_axes(a))
                     and set(_names(self._mesh_axes(a))) <= tp)

    def tp_size(self) -> int:
        """The members of a tensor-parallel group (1 without one)."""
        return math.prod(dict(self.mesh.shape)[a] for a in self.tp_axes()) \
            if self.mesh is not None else 1

    def tp_blocks(self, shape: Sequence[int],
                  axes: Sequence[Optional[str]]) -> List[Tuple[slice, ...]]:
        """Each member's block of an activation of ``shape`` at a
        constraint point of logical ``axes``, in the group's order
        (row-major over ``tp_axes``): ``pspec(shape, axes)`` on the
        group's axes, its drops included, each split dim cut into equal
        parts and the member's taken (row-major over the dim's axes, as
        ``NamedSharding.key``); the dims on the data-parallel axes whole
        (the step splits the rows). Members whose blocks are equal
        compute one part once. The drops are not recorded in
        ``dropped``: that counts the placements."""
        tp = self.tp_axes()
        logical = [a if a is not None and self._mesh_axes(a) is not None
                   and set(_names(self._mesh_axes(a))) <= set(tp) else None
                   for a in axes]
        spec = self.pspec(shape, logical, record=False)
        sizes = [dict(self.mesh.shape)[a] for a in tp]
        out = []
        for pos in itertools.product(*(range(n) for n in sizes)):
            at = dict(zip(tp, pos))
            block = []
            for d, n in enumerate(shape):
                names = _names(spec[d]) if d < len(spec) else ()
                k, parts = 0, 1
                for a in names:
                    k = k * dict(self.mesh.shape)[a] + at[a]
                    parts *= dict(self.mesh.shape)[a]
                step = n // parts
                block.append(slice(k * step, (k + 1) * step))
            out.append(tuple(block))
        return out

    # -- application --------------------------------------------------------
    def constrain(self, x, *axes: Optional[str]):
        """``x`` without a mesh, as the reference's; with one it raises (see
        the module note)."""
        if self.mesh is None:
            return x
        raise NotImplementedError(_CONSTRAIN)

    def spec_tree_shardings(self, specs):
        """The ``NamedSharding`` tree of a ParamSpec tree (a tree of
        ``None`` without a mesh)."""
        return mod.map_specs(lambda s: self.sharding(s.shape, s.axes), specs)

    def spec_tree_pspecs(self, specs):
        return mod.map_specs(lambda s: self.pspec(s.shape, s.axes), specs)


def make_rules(profile: str = "train",
               overrides: Sequence[Tuple[str, MeshAxes]] = ()
               ) -> Dict[str, MeshAxes]:
    rules = dict(W_RULES)
    rules.update(A_RULES)
    if profile == "decode":
        rules["act_kv_seq"] = "model"
        rules["act_heads"] = None        # flash-decode: heads replicated
        rules["act_mlp"] = "model"
    elif profile == "dp_only":
        # small-model regime: TP of a 350M model over 16 ranks moves more
        # activation bytes than it saves compute. Fold 'model' into the
        # batch: 256-way DP, weights replicated, the only collective left
        # is the gradient all-reduce (params << activations here).
        for k in ("embed", "mlp", "heads", "kv_heads", "ssm_inner",
                  "vocab", "experts"):
            rules[k] = None
        rules["act_batch"] = ("pod", "data", "model")
        for k in ("act_heads", "act_mlp", "act_vocab", "act_ssm",
                  "act_experts"):
            rules[k] = None
    elif profile == "zero1":
        # ZeRO-1: weights replicated over 'data'; only the optimizer
        # moments stay data-sharded (they take the FSDP rules).
        rules["embed"] = None
    elif profile == "train_sp":
        # sequence parallelism: residual stream sharded over 'model' on seq
        # between the TP blocks (Megatron SP).
        rules["act_seq"] = "model"
    elif profile == "kv_seq":
        # context parallelism: scores sharded over the KV-sequence dim,
        # for any head count; weights keep their TP sharding.
        rules["act_kv_seq"] = "model"
        rules["act_heads"] = None
    elif profile != "train":
        raise ValueError(profile)
    for k, v in overrides:
        rules[k] = v
    return rules


# Overrides for the (data, expert, model) MoE mesh: TP spans both sub-axes
# for dense ops; experts shard over 'expert'.
EP_OVERRIDES = (
    ("experts", "expert"),
    ("expert_mlp", "model"),
    ("mlp", ("expert", "model")),
    ("heads", ("expert", "model")),
    ("kv_heads", ("expert", "model")),
    ("vocab", ("expert", "model")),
    ("act_heads", ("expert", "model")),
    ("act_mlp", ("expert", "model")),
    ("act_vocab", ("expert", "model")),
    ("act_experts", "expert"),
    ("act_ssm", ("expert", "model")),
    ("cache_seq", ("expert", "model")),
)


def make_ctx(mesh, profile: str = "train",
             overrides: Sequence[Tuple[str, MeshAxes]] = ()) -> ShardingCtx:
    return ShardingCtx(mesh=mesh, rules=make_rules(profile, overrides),
                       profile=profile)


def null_ctx() -> ShardingCtx:
    return ShardingCtx(mesh=None, rules=make_rules("train"))
