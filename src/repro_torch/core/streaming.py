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
from repro_torch.core.border_spec import (BorderSpec, min_extent,
                                          quantize_constant)
from repro_torch.core.borders import gather_rows
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


def strip_plans(H: int, W: int, w: int, border: BorderSpec, strip_h: int, *,
                dtype: str, requant: Optional[RequantSpec] = None,
                device="cpu"):
    """The kernel plan and index vectors of one strip scan, built once at
    compile time: ``(n_strips, plan, idx)``. Two or more strips share one
    ``neglect`` plan over a (strip_h + 2r) × (W + 2r) window, and ``idx``
    holds, on ``device``, the column indices of the extension and the row
    indices of the first and last strips' remaps; a single strip takes the
    frame's own plan and policy, and ``idx`` is ``None``. Raises
    ``ValueError`` for geometry the scan cannot take."""
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
    need = min_extent(border, r)
    if W < need:
        raise ValueError(f"policy {border.policy!r} with radius {r} needs "
                         f"frames of at least {need} columns; got {W}")
    plan = halo.make_plan(strip_h + 2 * r, W + 2 * r, w,
                          BorderSpec("neglect"), strip_h, W, dtype=dtype,
                          requant=requant)
    idx = tuple(torch.arange(a, b, device=device) for a, b in
                ((-r, W + r), (-r, strip_h + r), (0, strip_h + 2 * r)))
    return n_strips, plan, idx


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
    # the constant, quantized against the storage dtype (the plan's rule)
    qc = quantize_constant(border.constant, planes.dtype)
    col_idx, first_idx, last_idx = idx
    xc = gather_rows(planes, col_idx, border, axis=2,
                     constant=qc)                     # [M, H, W + 2r]
    top_rows, bot_rows = xc[:, :r], xc[:, H - r:]     # the wrap prologue
    row_buf = xc[:, :0]
    ys = []
    for i in range(n_strips):
        strip = xc[:, i * S:(i + 1) * S]
        nxt = xc[:, (i + 1) * S:(i + 2) * S] if i + 1 < n_strips else strip
        if i == 0 and border.policy == "wrap":
            ext = torch.cat([bot_rows, strip, nxt[:, :r]], dim=1)
        elif i == 0:
            ext = gather_rows(torch.cat([strip, nxt[:, :r]], dim=1),
                              first_idx, border, axis=1, constant=qc)
        elif i == n_strips - 1 and border.policy == "wrap":
            ext = torch.cat([row_buf, strip, top_rows], dim=1)
        elif i == n_strips - 1:
            ext = gather_rows(torch.cat([row_buf, strip], dim=1), last_idx,
                              border, axis=1, constant=qc)
        else:
            ext = torch.cat([row_buf, strip, nxt[:, :r]], dim=1)
        ys.append(filter2d_halo(ext.contiguous(), co, plan, q_params=q,
                                form=form))
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
