"""Row-strip streaming executor — the paper's dataflow as a scan of strips.

The FPGA design streams one pixel per clock through a (w−1)-row buffer so a
full frame never needs to be resident. The reference translates that into
a ``jax.lax.scan`` over row strips whose carry is the last r = (w−1)/2
rows of the previous strip — the paper's row buffer. This module is that
scan for the port: a Python loop over strips whose window assembly is
torch index operations, as in the reference:

  * the columns are extended once by the border policy (the column mux);
  * interior windows are [carried r rows | strip | next strip's first r
    rows]; the last strip's lookahead is itself, as in the reference;
  * the first and last strips remap their outer halo by the policy
    (priming and flushing without a stall);
  * ``wrap`` needs the opposite frame edge, which a row buffer no longer
    holds: a prologue captures the r top and bottom rows before the scan
    and splices them in at the last and first strip.

The MAC and the requant of each strip are one launch of the hand-written
``kernels/filter2d/kernel.py::filter2d_halo`` on its (strip_h + 2r) ×
(W + 2r) window with a ``neglect`` plan, which yields exactly the strip's
strip_h × W outputs; the plan is built once at compile time and the gains
are the kernel's runtime operand, so each strip leaves at storage width.
Fixed-point windows enter the kernel at storage width and the kernel
widens them at the MAC (the reference widens the frame before the scan;
the values are the same). A CPU frame runs the kernel's plain version,
so the CPU parity tests drive the same control flow; a card frame never
runs the plain forms. A scan of fewer than two strips is one launch over
the whole frame under its own policy (the reference delegates that case
to ``core.filter2d``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import dtypes
from repro_torch.core.border_spec import (BorderSpec, check_min_extent,
                                          quantize_constant)
from repro_torch.core.borders import plan_gather, take_rows
from repro_torch.core.filter2d import resolve_requant
from repro_torch.core.requant import RequantSpec
from repro_torch.kernels.filter2d import halo
from repro_torch.kernels.filter2d.kernel import filter2d_halo


def strip_height_for_vmem(width: int, channels: int, w: int,
                          vmem_bytes: int = 8 * 2 ** 20,
                          dtype_bytes: int = 4) -> int:
    """Largest strip height whose working set (strip+halo in, strip out,
    double-buffered) fits the VMEM budget — the reference's rule, which
    mirrors the paper's BRAM bound (accounting for the strip geometry;
    the kernel's shared-memory tiling is its own)."""
    per_row = width * channels * dtype_bytes
    # in-strip (+halo), out-strip, x2 double buffering
    h = vmem_bytes // (per_row * 4) - (w - 1)
    return max(8, int(h))


def window_plan(rows: int, W: int, w: int, *, dtype,
                requant: Optional[RequantSpec] = None):
    """The ``neglect`` kernel plan of one (rows + 2r) × (W + 2r) window,
    which yields exactly its rows × W outputs: built once at compile time
    for every window of a strip scan or of a shard ring."""
    r = (w - 1) // 2
    return halo.make_plan(rows + 2 * r, W + 2 * r, w, BorderSpec("neglect"),
                          rows, W, dtype=dtype, requant=requant)


def window_index(rows: int, W: int, r: int, border: BorderSpec, dtype,
                 device):
    """The planned gathers (:class:`~repro_torch.core.borders.RowGather`)
    of a window of ``rows`` output rows of a ``dtype`` frame, on
    ``device``, remapped by ``border`` once: the column extension
    ``[-r, W + r)``, and the row remaps of the first window
    ``[-r, rows + r)`` (over [window | r rows below]) and of the last
    ``[0, rows + 2r)`` (over [r rows above | window]). Each call then
    costs one ``index_select`` per gather (and one ``where`` under
    ``constant``)."""
    dt = dtypes.to_torch(dtype)
    qc = quantize_constant(border.constant, dt)   # the plan's rule
    return tuple(plan_gather(torch.arange(a, b, device=device), n, border,
                             axis=axis, ndim=3, dtype=dt, constant=qc)
                 for a, b, n, axis in ((-r, W + r, W, 2),
                                       (-r, rows + r, rows + r, 1),
                                       (0, rows + 2 * r, rows + r, 1)))


def filter_window(ext: torch.Tensor, co: torch.Tensor, q, plan,
                  form: str) -> torch.Tensor:
    """The MAC and requant of one window: one ``filter2d_halo`` launch on
    ``ext`` under its :func:`window_plan` (the plain version for a CPU
    window) → [M, N, rows, W]."""
    return filter2d_halo(ext.contiguous(), co, plan, q_params=q, form=form)


def strip_plans(H: int, W: int, w: int, border: BorderSpec, strip_h: int, *,
                dtype: str, requant: Optional[RequantSpec] = None,
                device):
    """The kernel plan and planned gathers of one strip scan, built once
    at compile time: ``(n_strips, plan, idx)``. Two or more strips share
    one :func:`window_plan`, and ``idx`` holds :func:`window_index` on
    ``device`` for frames of ``dtype``; a single strip takes the frame's
    own plan and policy, and ``idx`` is ``None``. Raises ``ValueError``
    for geometry the scan cannot take."""
    r = (w - 1) // 2
    if border.policy == "neglect":
        raise ValueError("the streaming executor does not support 'neglect' "
                         "(a row buffer keeps the frame size)")
    if strip_h < 1 or H % strip_h or strip_h < w - 1:
        raise ValueError(f"the strip scan needs H % strip_h == 0 and strip_h "
                         f">= w - 1; got H={H}, strip_h={strip_h}, w={w}")
    n_strips = H // strip_h
    if n_strips < 2:
        return n_strips, halo.make_plan(H, W, w, border, H, W, dtype=dtype,
                                        requant=requant), None
    check_min_extent(border, r, H, W)
    return (n_strips, window_plan(strip_h, W, w, dtype=dtype,
                                  requant=requant),
            window_index(strip_h, W, r, border, dtype, device))


def _scan_planes(planes: torch.Tensor, co: torch.Tensor, q, plan,
                 n_strips: int, idx, *, border: BorderSpec, strip_h: int,
                 form: str) -> torch.Tensor:
    """[M, H, W] planes → [M, N, H, W]: one kernel launch per strip
    (``plan``, ``n_strips`` and ``idx`` from :func:`strip_plans`)."""
    if n_strips < 2:
        return filter2d_halo(planes, co, plan, q_params=q, form=form)
    H = planes.shape[1]
    r = plan.rows.r
    S = strip_h
    col_idx, first_idx, last_idx = idx
    xc = take_rows(planes, col_idx, axis=2)           # [M, H, W + 2r]
    top_rows, bot_rows = xc[:, :r], xc[:, H - r:]     # the wrap prologue
    row_buf = xc[:, :0]
    ys = []
    for i in range(n_strips):
        strip = xc[:, i * S:(i + 1) * S]
        nxt = xc[:, (i + 1) * S:(i + 2) * S] if i + 1 < n_strips else strip
        if i == 0 and border.policy == "wrap":
            ext = torch.cat([bot_rows, strip, nxt[:, :r]], dim=1)
        elif i == 0:
            ext = take_rows(torch.cat([strip, nxt[:, :r]], dim=1),
                            first_idx, axis=1)
        elif i == n_strips - 1 and border.policy == "wrap":
            ext = torch.cat([row_buf, strip, top_rows], dim=1)
        elif i == n_strips - 1:
            ext = take_rows(torch.cat([row_buf, strip], dim=1), last_idx,
                            axis=1)
        else:
            ext = torch.cat([row_buf, strip, nxt[:, :r]], dim=1)
        ys.append(filter_window(ext, co, q, plan, form))
        row_buf = strip[:, S - r:]
    return torch.cat(ys, dim=2)


def filter2d_streaming(frame: torch.Tensor, coeffs, *,
                       form: str = "direct", border_policy: str = "mirror",
                       strip_h: int = 64,
                       border: Optional[BorderSpec] = None,
                       requant: Optional[RequantSpec] = None
                       ) -> torch.Tensor:
    """Filter a frame strip by strip with a carried (w−1)-row buffer, on
    the frame's device.

    Semantics identical to ``filter2d(...)`` for every same-size policy.
    Pass a full ``BorderSpec`` via ``border`` (wins over ``border_policy``)
    for non-zero constants. Frame height must divide by ``strip_h`` and
    ``strip_h >= w-1``. ``requant`` applies the fused epilogue to each
    emitted strip.

    Thin wrapper over ``core.pipeline.Filter2D``
    (``execution='streaming'``), which takes the reference's strip height
    when ``strip_h`` is not given.
    """
    from repro_torch.core.pipeline import Filter2D
    frame = torch.as_tensor(frame)
    spec_b = border if border is not None else BorderSpec(border_policy)
    rq = resolve_requant(frame.dtype, requant)
    spec = Filter2D(window=int(np.shape(coeffs)[-1]), form=form,
                    border=spec_b, dtype=dtypes.name(frame.dtype),
                    requant=rq.gain_free() if rq is not None else None)
    cf = spec.compile(frame, "streaming", strip_h=strip_h,
                      device=frame.device)
    return cf(frame, coeffs, gains=rq)
