"""Public wrappers for the ``filter2d_halo`` CUDA kernel, and the plane
layout helpers the ``cuda`` executor uses.

``filter2d_cuda``/``filter_bank_cuda`` are the counterparts of the
reference's ``filter2d_pallas``/``filter_bank_pallas``: thin wrappers over
the plan-and-execute front door (``core.pipeline.Filter2D`` →
``CompiledFilter`` with ``execution='cuda'``). The executor folds
batch/channel planes into the kernel's plane dimension (no outer loop of a
2D kernel) and restores the caller's layout afterwards; the filter bank is
the kernel's own loop. On a CPU frame the same path runs the kernel's
plain version (``kernel.filter2d_halo_ref``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import dtypes
from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.filter2d import resolve_requant, resolve_separable
from repro_torch.core.requant import RequantSpec
from repro_torch.kernels.filter2d.halo import LANE


def _fold_planes(frame: torch.Tensor):
    """[H,W] | [H,W,C] | [B,H,W,C] -> (contiguous [M,H,W] planes, tag).

    The plane dim M = B·C is the kernel's grid z dimension; the tag lets
    ``_unfold`` restore the caller's layout from the kernel's
    [M,N,Ho,Wo]."""
    if frame.ndim == 2:
        return frame[None].contiguous(), ("hw",)
    if frame.ndim == 3:                    # [H, W, C]
        C = frame.shape[2]
        return frame.permute(2, 0, 1).contiguous(), ("hwc", C)
    if frame.ndim == 4:                    # [B, H, W, C]
        B, H, W, C = frame.shape
        planes = frame.permute(0, 3, 1, 2).reshape(B * C, H, W)
        return planes.contiguous(), ("bhwc", B, C)
    raise ValueError(f"frames are [H,W] | [H,W,C] | [B,H,W,C]; got shape "
                     f"{tuple(frame.shape)}")


def _unfold(y: torch.Tensor, tag, keep_bank: bool) -> torch.Tensor:
    """y: [M, N, Ho, Wo] -> caller layout (bank dim last when kept)."""
    if tag[0] == "hw":
        y = y[0].permute(1, 2, 0)                  # [Ho, Wo, N]
    elif tag[0] == "hwc":
        y = y.permute(2, 3, 0, 1)                  # [Ho, Wo, C, N]
    else:
        B, C = tag[1], tag[2]
        y = y.reshape(B, C, *y.shape[1:])          # [B, C, N, Ho, Wo]
        y = y.permute(0, 3, 4, 1, 2)               # [B, Ho, Wo, C, N]
    return y if keep_bank else y[..., 0]


def resolve_strip_tile(H: int, W: int, w: int, border: BorderSpec,
                       regime: str, strip_h: int, tile_w: int
                       ) -> Tuple[int, int, int, int]:
    """Clamp strip/tile knobs into the reference's plan geometry:
    ``(S, Tw, Ho, Wo)``. ``small`` is the pixel-cache regime (one strip ×
    one lane-padded tile = the whole plane); ``stream`` keeps multi-strip
    plans at ``S >= 2r`` and lane-aligns column tiles. Accounting only on
    the port (see ``halo.py``)."""
    r = (w - 1) // 2
    if border.same_size:
        Ho, Wo = H, W
    else:
        Ho, Wo = H - 2 * r, W - 2 * r
    if regime == "small":
        S, Tw = Ho, Wo + ((-Wo) % LANE)
    elif regime == "stream":
        S = max(min(strip_h, Ho), min(2 * r, Ho), 1)
        Tw = min(tile_w + ((-tile_w) % LANE), Wo + ((-Wo) % LANE))
    else:
        raise ValueError(regime)
    return S, Tw, Ho, Wo


def filter2d_cuda(frame: torch.Tensor, coeffs, *, form: str = "direct",
                  border: BorderSpec = BorderSpec("mirror"), separable=False,
                  requant: Optional[RequantSpec] = None) -> torch.Tensor:
    """The CUDA-kernel 2D filter on the frame's device. frame: [H,W] |
    [H,W,C] | [B,H,W,C]; every border policy resolved in the kernel;
    ``separable='auto'|True|(u, v)`` routes rank-1 filters through the
    2w-MAC pass; ``requant`` fuses the output scaler into the kernel so
    fixed-point frames leave at storage width. Thin wrapper over the
    front door — prefer ``Filter2D(...).compile(frame, 'cuda')`` for
    served pipelines."""
    from repro_torch.core.pipeline import Filter2D
    frame = torch.as_tensor(frame)
    rq = resolve_requant(frame.dtype, requant)
    uv = resolve_separable(frame.dtype, coeffs, separable)
    window = (int(uv[0].shape[0]) if uv is not None
              else int(torch.as_tensor(coeffs).shape[-1]))
    spec = Filter2D(window=window, form=form, border=border,
                    separable=uv is not None, dtype=dtypes.name(frame.dtype),
                    requant=rq.gain_free() if rq is not None else None)
    cf = spec.compile(frame, "cuda", device=frame.device)
    return cf(frame, uv if uv is not None else coeffs, gains=rq)


def filter_bank_cuda(frame: torch.Tensor, bank, *, form: str = "direct",
                     border: BorderSpec = BorderSpec("mirror"),
                     requant: Optional[RequantSpec] = None) -> torch.Tensor:
    """Apply a bank of N filters in one kernel launch: bank [N, w, w] ->
    output [..., N]. Each thread block loads its input window once and
    reuses it for all N coefficient sets (the coefficient file);
    ``requant`` may carry one (multiplier, shift) per filter."""
    from repro_torch.core.pipeline import Filter2D
    frame = torch.as_tensor(frame)
    bank_t = torch.as_tensor(bank)
    n = int(bank_t.shape[0])
    rq = resolve_requant(frame.dtype, requant, num_filters=n)
    spec = Filter2D(window=int(bank_t.shape[-1]), form=form, border=border,
                    num_filters=n, dtype=dtypes.name(frame.dtype),
                    requant=rq.gain_free() if rq is not None else None)
    cf = spec.compile(frame, "cuda", device=frame.device)
    return cf(frame, bank_t, gains=rq)
