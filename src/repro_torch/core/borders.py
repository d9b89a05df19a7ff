"""Border management for 2D spatial filters — the paper's §III, as torch
index remaps.

The paper's point (after Bailey [15]) is that border handling should be a
*lean index multiplexer*, not a stall or an extra buffered pass: the stream
never stops, the output frame keeps the input frame size, and the only cost
is a small mux in front of the window cache.

Every policy here is an *index remap* ``map_index(i, n) -> j in [0, n)``
plus, for ``constant``, a validity mask. The plain torch versions
(``core/filter2d``, the kernel's ``filter2d_halo_ref``) gather the
extended frame through the remap; the CUDA kernel applies the same remap
to each source index as it loads its shared-memory window, so no padded
copy of the frame ever exists in device memory.

``mirror`` (numpy ``reflect``) and ``mirror_dup`` (numpy ``symmetric``)
are built by remap because ``torch.nn.functional.pad`` has no
``symmetric`` mode and its ``reflect`` mode limits the pad width.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.border_spec import (ALIASES, POLICIES,
                                          SAME_SIZE_POLICIES, BorderSpec,
                                          min_extent, np_pad_mode,
                                          out_shape)

__all__ = [
    "ALIASES", "BorderSpec", "POLICIES", "SAME_SIZE_POLICIES",
    "min_extent", "np_pad_mode", "out_shape",
    "map_index", "valid_mask", "RowGather", "plan_gather", "take_rows",
    "gather_rows", "extend",
]


def map_index(idx: torch.Tensor, n: int, policy: str) -> torch.Tensor:
    """Remap (possibly out-of-range) indices into [0, n).

    ``idx`` may range over [-(w-1), n + w - 1) for window radius (w-1)/2 —
    at most one full reflection is required (guaranteed whenever the frame
    meets ``min_extent``). For ``constant`` the remapped index is clamped
    (the *value* is fixed separately via :func:`valid_mask`).
    """
    policy = ALIASES.get(policy, policy)
    if policy == "neglect":
        return idx  # caller never samples out-of-range under neglect
    if policy == "wrap":
        return torch.remainder(idx, n)
    if policy in ("duplicate", "constant"):
        return idx.clamp(0, n - 1)
    if policy == "mirror_dup":   # symmetric: -1 -> 0, -2 -> 1, n -> n-1
        idx = torch.where(idx < 0, -idx - 1, idx)
        return torch.where(idx >= n, 2 * n - idx - 1, idx)
    if policy == "mirror":       # reflect: -1 -> 1, -2 -> 2, n -> n-2
        idx = idx.abs()
        return torch.where(idx >= n, 2 * n - idx - 2, idx)
    raise ValueError(f"unknown border policy {policy!r}")


def valid_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """True where ``idx`` is inside the frame (for ``constant`` policy)."""
    return (idx >= 0) & (idx < n)


class RowGather(NamedTuple):
    """One :func:`gather_rows` with its remap done ahead of the data: the
    in-range source indices, and for ``constant`` the validity mask (shaped
    for its axis) and the fill at the frame dtype (``None`` otherwise).
    Built once where the geometry is fixed, run by :func:`take_rows`."""

    index: torch.Tensor
    mask: Optional[torch.Tensor]
    fill: Optional[torch.Tensor]


def plan_gather(idx: torch.Tensor, n: int, spec: BorderSpec, *, axis: int,
                ndim: int, dtype: torch.dtype, constant=None) -> RowGather:
    """The :class:`RowGather` of (possibly out-of-range) ``idx`` over an
    axis of length ``n`` of an ``ndim``-dimensional frame of ``dtype``.
    ``constant`` overrides ``spec.constant`` (callers pass the value
    already quantized against the storage dtype)."""
    j = map_index(idx, n, spec.policy)
    if spec.policy != "constant":
        return RowGather(j, None, None)
    c = spec.constant if constant is None else constant
    shape = [1] * ndim
    shape[axis] = idx.shape[0]
    # a Python float lands as float32 first (as the reference's
    # jnp.asarray does), then rounds to the frame dtype; a 0-dim CPU
    # tensor is a scalar to torch.where on any device (no copy)
    return RowGather(j, valid_mask(idx, n).reshape(shape),
                     torch.tensor(c).to(dtype))


def take_rows(x: torch.Tensor, g: RowGather, axis: int) -> torch.Tensor:
    """Gather ``x`` along ``axis`` by a planned :class:`RowGather`: one
    ``index_select``, and one ``where`` under ``constant``."""
    out = torch.index_select(x, axis, g.index)
    return out if g.mask is None else torch.where(g.mask, out, g.fill)


def gather_rows(x: torch.Tensor, idx: torch.Tensor, spec: BorderSpec,
                axis: int = 0, constant=None) -> torch.Tensor:
    """Gather rows/cols of ``x`` along ``axis`` at (possibly out-of-range)
    ``idx`` under ``spec`` — the lean mux: one gather, no padded copy.
    ``constant`` overrides ``spec.constant`` (callers pass the value
    already quantized against the storage dtype)."""
    axis %= x.ndim
    return take_rows(x, plan_gather(idx, x.shape[axis], spec, axis=axis,
                                    ndim=x.ndim, dtype=x.dtype,
                                    constant=constant), axis)


def extend(x: torch.Tensor, radius: int, spec: BorderSpec,
           axes: Tuple[int, int] = (-2, -1), constant=None) -> torch.Tensor:
    """Materialise the (H+2r, W+2r) extended frame under ``spec``.

    The plain versions' path; the CUDA kernel never extends a whole frame,
    it remaps indices tile by tile as it loads shared memory."""
    if spec.policy == "neglect" or radius == 0:
        return x
    ax_h, ax_w = (a % x.ndim for a in axes)
    dev = x.device
    h_idx = torch.arange(-radius, x.shape[ax_h] + radius, device=dev)
    w_idx = torch.arange(-radius, x.shape[ax_w] + radius, device=dev)
    x = gather_rows(x, h_idx, spec, axis=ax_h, constant=constant)
    x = gather_rows(x, w_idx, spec, axis=ax_w, constant=constant)
    return x
