"""Parameter specs: nested dicts of ``ParamSpec`` (shape, logical axes,
initializer) that ``init_params`` materialises as nested dicts of
tensors — the reference's module system (``repro/models/module.py``) with
torch tensors and an explicit ``torch.Generator``.

The reference seeds each leaf from ``hash()`` of its path, which varies
from process to process; here the leaves are drawn in sorted path order
from the one generator, so a seed gives the same parameters in every
process. The two packages' values never agree: tests carry the
reference's parameters across with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]    # logical axis names, len == ndim
    init: str = "lecun"                # lecun | normal | zeros | ones | embed | small
    dtype: torch.dtype = torch.float32
    scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def p(shape, axes, init="lecun", dtype=torch.float32, scale=1.0) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, dtype, scale)


# -- tree helpers (nested dicts of ParamSpec / tensors) -----------------------

def tree_paths(tree: Dict, prefix: Tuple[str, ...] = ()
               ) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def tree_leaves(tree) -> List[Any]:
    """The leaves of a tree of dicts, lists and tuples (named tuples
    included), in order: dicts by insertion, as the trees built from one
    spec tree share. ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*seq) if hasattr(tree, "_fields") \
            else type(tree)(seq)
    return None if tree is None else fn(tree, *rest)


def map_specs(fn: Callable[[ParamSpec], Any], tree):
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def _fan_in(shape: Tuple[int, ...]) -> int:
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    # contraction dims: everything except the last
    return max(1, math.prod(shape[:-1]))


# A leaf whose float32 draw is larger than this is drawn a block of rows
# (along axis 0) at a time, each block cast into the output as it comes:
# qwen3-moe-30b-a3b's expert leaves ([48, 128, 2048, 768], 38.7 GB as
# float32) would otherwise need two float32 temporaries of that size
# before the cast. 2 GiB keeps every leaf of h2o-danube-1.8b and
# hymba-1.5b (the largest 1.7 GB) drawn whole, value for value as before.
WHOLE_DRAW_BYTES = 2 << 30


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One parameter on the generator's device, in ``dtype`` if it is
    given and the spec's dtype is floating (else the spec's dtype)."""
    dev = generator.device
    out_dtype = (dtype if dtype is not None and spec.dtype.is_floating_point
                 else spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=out_dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=out_dtype, device=dev)
    std = {"embed": 0.02 * spec.scale, "normal": spec.scale,
           "small": 1e-2 * spec.scale,
           "lecun": spec.scale / math.sqrt(_fan_in(spec.shape))}.get(spec.init)
    if std is None:
        raise ValueError(f"unknown init {spec.init!r}")
    n = math.prod(spec.shape)
    if 4 * n <= WHOLE_DRAW_BYTES:
        x = torch.randn(spec.shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x * std).to(out_dtype)
    out = torch.empty(spec.shape, dtype=out_dtype, device=dev)
    rows = max(1, WHOLE_DRAW_BYTES // (4 * (n // spec.shape[0])))
    for r0 in range(0, spec.shape[0], rows):
        x = torch.randn((min(rows, spec.shape[0] - r0),) + spec.shape[1:],
                        generator=generator, device=dev, dtype=torch.float32)
        out[r0:r0 + rows].copy_(x.mul_(std))
        del x
    return out


def init_params(specs, generator: torch.Generator, dtype: Any = None):
    """Materialise a ParamSpec tree on ``generator.device``, the leaves
    drawn in sorted path order. ``dtype`` is the dtype of the floating
    leaves (each drawn in float32 and cast, block by block for a large
    leaf, so no float32 copy of a whole large leaf is made)."""
    out: Dict[str, Any] = {}
    for path, spec in sorted(tree_paths(specs).items()):
        leaf = init_leaf(spec, generator, dtype)
        d = out
        for seg in path[:-1]:
            d = d.setdefault(seg, {})
        d[path[-1]] = leaf
    return out


def abstract_params(specs, dtype: Any = None):
    """The parameters as ``meta`` tensors (shapes and dtypes only, no
    storage), as the reference's ``ShapeDtypeStruct`` tree: each leaf in
    ``dtype`` where given, else its spec's dtype."""
    def mk(s: ParamSpec):
        return torch.empty(s.shape, dtype=dtype if dtype is not None
                           else s.dtype, device="meta")
    return map_specs(mk, specs)


def param_bytes(specs, bytes_per_el: int = 4) -> int:
    total = 0
    for spec in tree_paths(specs).values():
        total += math.prod(spec.shape) * bytes_per_el
    return total


def count_params(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_paths(specs).values())


def stack_specs(spec_tree, n: int, axis_name: str = "layers"):
    """Prepend a stacked layer dim to every spec (the layers of a stage)."""
    def stk(s: ParamSpec) -> ParamSpec:
        return ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                         s.dtype, s.scale)
    return map_specs(stk, spec_tree)
