"""Row-sharded 2D filtering: the row buffer, distributed, as a halo ring.

For frames too tall for one device (or for throughput scaling), the frame
is row-sharded over a mesh of devices. Each shard needs the r = (w−1)/2
boundary rows of its neighbours — the *distributed* analogue of the
paper's row buffer. The reference exchanges exactly those rows with two
``ppermute``s under one ``shard_map``; the port keeps its one-controller
shape: one process, a :class:`Mesh` that is an ordered tuple of
``torch.device`` entries, and the halo rows moved between the neighbours'
tensors as device-to-device copies between cards. Where entries repeat
(a ring on one card) the rows already lie on the receiving device and the
exchange is a slice with no copy. Wire bytes = 2·r·W·C·storage per shard
boundary, independent of H.

Each shard's window is [r rows from above | its Hs rows | r rows from
below], remapped by the border policy only at the true frame edges (the
first and last shard) and extended along the columns; its MAC and requant
are one launch of the hand-written ``kernels/filter2d/kernel.py::
filter2d_halo`` on that (Hs + 2r) × (W + 2r) window under a ``neglect``
plan built once at compile time (``core/streaming.py::window_plan``, the
strip scan's step). ``wrap`` is served by the ring itself: the first
shard's top halo arrives from the last shard. A CPU shard runs the
kernel's plain version; a card shard never runs the plain forms. One
shard is one launch over the whole frame under its own policy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dtypes
from repro_torch.core.border_spec import BorderSpec, check_min_extent
from repro_torch.core.borders import take_rows
from repro_torch.core.filter2d import _as_nhwc, _un_nhwc, resolve_requant
from repro_torch.core.requant import RequantSpec
from repro_torch.core.streaming import (filter_window, window_index,
                                        window_plan)
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.filter2d import halo, ops


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The counterpart of a one-axis ``jax.sharding.Mesh`` for the port's
    ring: an ordered, hashable tuple of devices, one row shard each.
    Entries may repeat (``["cuda:0"] * 4`` runs a four-shard ring on one
    card); all are CUDA devices or all the CPU, and a CUDA entry without a
    card raises."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if isinstance(self.devices, (str, torch.device)):
            raise TypeError("a mesh is a sequence of devices; got the single "
                            f"device {self.devices!r}")
        devs = tuple(resolve_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) > 1:
            raise ValueError("a mesh's devices are all CUDA devices or all "
                             f"the CPU; got {[str(d) for d in devs]}")
        object.__setattr__(self, "devices", devs)

    def __str__(self) -> str:
        return f"[{', '.join(str(d) for d in self.devices)}]"


def ring_plans(H: int, W: int, w: int, border: BorderSpec, mesh: Mesh, *,
               dtype: str, requant: Optional[RequantSpec] = None):
    """The kernel plan and planned gathers of one ring, built once at
    compile time: ``(plan, idx)``. Two or more shards share one
    :func:`~repro_torch.core.streaming.window_plan`, and ``idx[i]`` holds
    the window's gathers (:func:`~repro_torch.core.streaming.window_index`,
    already remapped by the policy) on shard ``i``'s device; one shard
    takes the frame's own plan and policy, and ``idx`` is ``None``. Raises
    ``ValueError`` for geometry the ring cannot take."""
    r = (w - 1) // 2
    n = len(mesh.devices)
    if border.policy == "neglect":
        raise ValueError("the sharded executor does not support 'neglect' "
                         "(the ring keeps the frame size)")
    check_min_extent(border, r, H, W)
    if H % n:
        raise ValueError(f"the ring needs H % shards == 0; got H={H} over "
                         f"{n} shards")
    if H // n < r:
        raise ValueError(f"each shard needs at least r rows (Hs >= r); got "
                         f"Hs={H // n}, r={r}")
    if n == 1:
        return halo.make_plan(H, W, w, border, H, W, dtype=dtype,
                              requant=requant), None
    by_dev = {d: window_index(H // n, W, r, border, dtype, d)
              for d in set(mesh.devices)}
    return (window_plan(H // n, W, w, dtype=dtype, requant=requant),
            tuple(by_dev[d] for d in mesh.devices))


def wire_bytes(frame_shape: Sequence[int], w: int, n: int,
               storage_dtype) -> int:
    """Halo bytes one call moves around an ``n``-shard ring: 2·r·W·C rows
    at the storage width per shard (every shard receives r rows from each
    neighbour, the wrap edge included, as the reference's ``ppermute``s
    do); 0 for one shard."""
    if n < 2:
        return 0
    shape = tuple(frame_shape)
    H, W = shape[1:3] if len(shape) == 4 else shape[:2]
    planes = int(np.prod(shape)) // (H * W)
    return n * 2 * ((w - 1) // 2) * W * planes * \
        dtypes.to_torch(storage_dtype).itemsize


def _exchange_halos(shards, r: int):
    """The ring's exchange: shard ``i`` receives the bottom ``r`` rows of
    shard ``i − 1`` and the top ``r`` rows of shard ``i + 1`` (indices mod
    the shard count), at the storage dtype, on its device: a copy between
    cards, and the neighbour's slice itself (no copy) where both shards
    lie on one device. Returns ``(tops, bots)``, one tensor per shard.
    PyTorch orders each copy after the work queued on both devices'
    current streams."""
    n = len(shards)
    Hs = shards[0].shape[1]
    tops = [shards[(i - 1) % n][:, Hs - r:].to(shards[i].device,
                                               non_blocking=True)
            for i in range(n)]
    bots = [shards[(i + 1) % n][:, :r].to(shards[i].device,
                                          non_blocking=True)
            for i in range(n)]
    return tops, bots


def _filter2d_sharded_impl(frame: torch.Tensor, co: torch.Tensor, q,
                           mesh: Mesh, plan, idx, *, border: BorderSpec,
                           form: str) -> torch.Tensor:
    """Row-shard ``frame`` over ``mesh`` and filter with the halo ring
    (``plan`` and ``idx`` from :func:`ring_plans`). ``co`` is the kernel's
    [1, w, w] operand and ``q`` its [1, 2] gains (or ``None``); both ride
    to every shard, so each shard requantises its own tile and the tiles
    stay at storage width until they are gathered, concatenated, on the
    mesh's first device. A host frame goes from pinned memory straight to
    each shard's device."""
    x, add_b, add_c = _as_nhwc(frame)
    devices = mesh.devices
    n = len(devices)
    Hs = x.shape[1] // n
    shards, tag = [], None
    for i, dev in enumerate(devices):
        planes, tag = ops._fold_planes(to_device(x[:, i * Hs:(i + 1) * Hs],
                                                 dev))
        shards.append(planes)
    if n == 1:
        y = filter_window(shards[0], co, q, plan, form)
    else:
        r = plan.rows.r
        remap = border.policy != "wrap"   # under wrap the ring delivers it
        tops, bots = _exchange_halos(shards, r)
        ys = []
        for i, (xs, top, bot) in enumerate(zip(shards, tops, bots)):
            col_idx, first_idx, last_idx = idx[i]
            if remap and i == 0:          # the true frame edges
                ext = take_rows(torch.cat([xs, bot], dim=1), first_idx,
                                axis=1)
            elif remap and i == n - 1:
                ext = take_rows(torch.cat([top, xs], dim=1), last_idx,
                                axis=1)
            else:
                ext = torch.cat([top, xs, bot], dim=1)
            ext = take_rows(ext, col_idx, axis=2)
            dev = xs.device
            ys.append(filter_window(ext, co.to(dev), None if q is None
                                    else q.to(dev), plan, form))
        y = torch.cat([t.to(devices[0], non_blocking=True) for t in ys],
                      dim=2)
    return _un_nhwc(ops._unfold(y, tag, keep_bank=False), add_b, add_c)


def filter2d_sharded(frame: torch.Tensor, coeffs, mesh, *,
                     form: str = "direct",
                     border_policy: str = "mirror",
                     border: Optional[BorderSpec] = None,
                     requant: Optional[RequantSpec] = None) -> torch.Tensor:
    """Row-shard ``frame`` over ``mesh`` (a :class:`Mesh` or a sequence of
    devices) and filter with the halo ring; the result lands on the mesh's
    first device. Semantics identical to ``filter2d(...)`` for every
    same-size policy; H must divide by the shard count with at least r
    rows per shard. Pass a full ``BorderSpec`` via ``border`` (wins over
    ``border_policy``) for non-zero constants; ``requant`` applies the
    fused epilogue per shard.

    Thin wrapper over ``core.pipeline.Filter2D``
    (``execution='sharded'``) — prefer the compiled front door for served
    pipelines.
    """
    from repro_torch.core.pipeline import Filter2D
    frame = torch.as_tensor(frame)
    spec_b = border if border is not None else BorderSpec(border_policy)
    rq = resolve_requant(frame.dtype, requant)
    spec = Filter2D(window=int(np.shape(coeffs)[-1]), form=form,
                    border=spec_b, dtype=dtypes.name(frame.dtype),
                    requant=rq.gain_free() if rq is not None else None)
    cf = spec.compile(frame, "sharded", mesh=mesh)
    return cf(frame, coeffs, gains=rq)
