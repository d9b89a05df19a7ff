"""Policy-neutral border specification — the one spec every entry point eats.

The paper's §III treats border management as a *policy* separate from the
datapath: the same streaming filter hardware serves border neglecting,
constant extension, wrap-around, duplication and mirroring, selected by a
small index multiplexer in front of the window cache. This module is the
software analogue of that separation: a single hashable ``BorderSpec``
that ``core.filter2d``, ``core.pipeline``, the CUDA kernel wrapper and the
filter-bank entry points all consume. Pure Python and numpy, so the static
halo planner (``kernels/filter2d/halo``) can bake it into its plans.

Canonical policy names follow the paper's Table IV; common aliases from the
FPGA/vision literature (``zero``, ``replicate``, ``reflect``) and numpy.pad
(``edge``, ``symmetric``) normalise onto them, so ``BorderSpec("zero")`` and
``BorderSpec("constant")`` are the same spec.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import dtypes

POLICIES = ("neglect", "constant", "wrap", "duplicate", "mirror_dup", "mirror")

# Policies that keep output size == input size (everything except neglect).
SAME_SIZE_POLICIES = tuple(p for p in POLICIES if p != "neglect")

# Literature / numpy.pad spellings -> canonical policy names.
ALIASES = {
    "zero": "constant",        # zero extension == constant(0)
    "replicate": "duplicate",  # OpenCV BORDER_REPLICATE
    "edge": "duplicate",       # numpy.pad 'edge'
    "reflect": "mirror",       # numpy.pad 'reflect' (no duplication)
    "symmetric": "mirror_dup",  # numpy.pad 'symmetric' (with duplication)
}


@dataclasses.dataclass(frozen=True)
class BorderSpec:
    """A border policy + its parameters. Hashable (a cache-key field).

    ``BorderSpec("zero")`` normalises to ``constant`` with the constant
    forced to 0; other aliases keep their ``constant`` untouched.
    """

    policy: str = "mirror"
    constant: float = 0.0

    def __post_init__(self):
        raw = self.policy
        if raw in ALIASES:
            object.__setattr__(self, "policy", ALIASES[raw])
            if raw == "zero":
                object.__setattr__(self, "constant", 0.0)
        if self.policy not in POLICIES:
            raise ValueError(f"unknown border policy {raw!r}; "
                             f"choose from {POLICIES} or aliases "
                             f"{tuple(ALIASES)}")

    @property
    def same_size(self) -> bool:
        return self.policy != "neglect"


def np_pad_mode(policy: str) -> Optional[str]:
    """The numpy.pad mode equivalent (oracle cross-checks in tests)."""
    return {
        "constant": "constant",
        "wrap": "wrap",
        "duplicate": "edge",
        "mirror_dup": "symmetric",
        "mirror": "reflect",
        "neglect": None,
    }[ALIASES.get(policy, policy)]


def out_shape(h: int, w: int, window: int, spec: BorderSpec
              ) -> Tuple[int, int]:
    """Output frame shape for an (h, w) input (paper: Direct keeps H×W,
    neglect/Transposed shrinks by w-1)."""
    if spec.same_size:
        return h, w
    return h - (window - 1), w - (window - 1)


def quantize_constant(value: float, dtype) -> float:
    """Quantize a ``constant(c)`` border value against the frame's *storage*
    dtype — the one shared rule for every datapath.

    On the FPGA (and in the CUDA kernel) the border constant is injected
    into the B-bit pixel stream *before* the wide MAC, so it must be
    representable in the storage dtype: integer frames round ``c`` to the
    nearest integer and saturate it into the dtype's range (int8: [-128,
    127]), exactly as the hardware register would hold it. Float frames
    pass ``c`` through unchanged. ``core.filter2d`` widens int frames to
    int32 *before* extending the border, so without this rule an
    out-of-range ``c`` (say 300 on an int8 frame) would silently survive
    in the widened frame while the in-kernel path stores 127 — the two
    paths would disagree at the edges. Both call this helper first.

    Static planning (``kernels/filter2d/halo.make_plan``) bakes the result
    into the hashable plan.
    """
    if dtypes.is_integer(dtype):
        info = np.iinfo(dtypes.name(dtype))
        q = int(np.rint(value))
        return int(min(max(q, info.min), info.max))
    return float(value)


def min_extent(spec: BorderSpec, radius: int) -> int:
    """Smallest frame extent a policy can extend by ``radius``: ``mirror``
    reflects without duplication (needs r+1 rows), ``mirror_dup``/``wrap``
    source r distinct rows, ``duplicate``/``constant`` any. ``neglect``
    produces no border at all, so every output needs its full 2r+1-tap
    window in-frame: extents below that have zero valid outputs and must
    be rejected at plan time (not deep inside the axis planner)."""
    if radius == 0:
        return 1
    if spec.policy == "neglect":
        return 2 * radius + 1
    if spec.policy == "mirror":
        return radius + 1
    if spec.policy in ("mirror_dup", "wrap"):
        return radius
    return 1


def check_min_extent(spec: BorderSpec, radius: int, H: int, W: int) -> None:
    """Refuse an H×W frame smaller than :func:`min_extent` — the one
    compile-time rule (and wording) of every executor that plans or
    extends a frame."""
    need = min_extent(spec, radius)
    if min(H, W) < need:
        raise ValueError(f"policy {spec.policy!r} with radius {radius} needs "
                         f"frames of at least {need} rows/cols (min_extent); "
                         f"got {(H, W)}")
