"""Coefficient file: runtime-programmable filter coefficients (paper §I/§II).

The paper's headline design choice is a *general-purpose* multiplier-based
filter whose coefficients are a runtime-writable register file, so one piece
of hardware serves Gaussian blur, Sobel, sharpening, … and higher vision
layers can rewrite the coefficients between frames. A 7×7 filter also serves
5×5 and 3×3 by zeroing the outer ring.

GPU translation: coefficients are a **kernel operand** (copied into the
CUDA kernel's shared memory per block), never a compile-time constant — one
built kernel serves every filter of window ≤ w_max. ``CoefficientFile`` is
that register file as a torch tensor; ``embed_window`` implements the
zero-ring trick. The presets are numpy, the same numbers the reference
package's presets give.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


@dataclasses.dataclass
class CoefficientFile:
    """Runtime coefficient store for a bank of filters of window <= w_max.

    ``table``: [num_slots, w_max, w_max] tensor on ``device`` — the card
    unless the caller passes ``device='cpu'`` (no card raises). Slots are
    rewritable at runtime (`write`), mirroring the paper's coefficient file
    updated by the higher layers of the vision stack without rebuilding.
    """

    w_max: int = 7
    num_slots: int = 8
    dtype: torch.dtype = torch.float32
    device: str = "cuda"

    def __post_init__(self):
        if self.w_max % 2 != 1:
            raise ValueError(f"window must be odd; got w_max={self.w_max}")
        self.table = torch.zeros((self.num_slots, self.w_max, self.w_max),
                                 dtype=self.dtype,
                                 device=resolve_device(self.device))

    @classmethod
    def from_numpy(cls, table, device: str = "cuda") -> "CoefficientFile":
        """A coefficient file holding ``table`` ([num_slots, w, w]) — e.g.
        the ``table`` of a reference-package coefficient file, as numpy."""
        t = torch.from_numpy(np.array(table))     # a copy of the table
        if t.ndim != 3 or t.shape[1] != t.shape[2]:
            raise ValueError("table must be [num_slots, w, w]; got shape "
                             f"{tuple(t.shape)}")
        cf = cls(w_max=int(t.shape[1]), num_slots=int(t.shape[0]),
                 dtype=t.dtype, device=device)
        cf.table = t.to(cf.table.device)
        return cf

    def write(self, slot: int, coeffs) -> None:
        """Write a (w, w) filter (w <= w_max) into ``slot`` (zero-ring pad)."""
        c = torch.as_tensor(np.asarray(coeffs) if not torch.is_tensor(coeffs)
                            else coeffs)
        emb = embed_window(c.to(self.table.device, self.dtype), self.w_max)
        self.table[slot] = emb

    def read(self, slot: int) -> torch.Tensor:
        return self.table[slot]

    def as_bank(self) -> torch.Tensor:
        """[num_slots, w_max, w_max] — one kernel launch applies all slots."""
        return self.table


def embed_window(coeffs: torch.Tensor, w_max: int) -> torch.Tensor:
    """Centre a (w, w) filter inside a (w_max, w_max) zero frame."""
    w = coeffs.shape[-1]
    if coeffs.shape[-2:] != (w, w) or w > w_max or w % 2 != 1:
        raise ValueError(f"cannot embed a {tuple(coeffs.shape)} filter in a "
                         f"{w_max}x{w_max} window")
    pad = (w_max - w) // 2
    return F.pad(coeffs, (pad, pad, pad, pad))


# ---------------------------------------------------------------------------
# Preset filter bank (classic low-level vision coefficients)
# ---------------------------------------------------------------------------


def gaussian(w: int, sigma: Optional[float] = None) -> np.ndarray:
    sigma = sigma if sigma is not None else 0.3 * ((w - 1) * 0.5 - 1) + 0.8
    r = (w - 1) // 2
    ax = np.arange(-r, r + 1, dtype=np.float64)
    g1 = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g1, g1)
    return (k / k.sum()).astype(np.float32)


def box(w: int) -> np.ndarray:
    return np.full((w, w), 1.0 / (w * w), np.float32)


def identity(w: int) -> np.ndarray:
    k = np.zeros((w, w), np.float32)
    k[w // 2, w // 2] = 1.0
    return k


def sobel_x(w: int = 3) -> np.ndarray:
    assert w == 3
    return np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)


def sobel_y(w: int = 3) -> np.ndarray:
    return sobel_x().T.copy()


def laplacian(w: int = 3) -> np.ndarray:
    assert w == 3
    return np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)


def sharpen(w: int = 3) -> np.ndarray:
    assert w == 3
    return np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32)


def emboss(w: int = 3) -> np.ndarray:
    assert w == 3
    return np.array([[-2, -1, 0], [-1, 1, 1], [0, 1, 2]], np.float32)


def motion_blur(w: int) -> np.ndarray:
    k = np.eye(w, dtype=np.float32)
    return k / w


def log_filter(w: int, sigma: Optional[float] = None) -> np.ndarray:
    """Laplacian-of-Gaussian (feature extraction preset)."""
    sigma = sigma if sigma is not None else w / 6.0
    r = (w - 1) // 2
    ax = np.arange(-r, r + 1, dtype=np.float64)
    xx, yy = np.meshgrid(ax, ax)
    rr = xx ** 2 + yy ** 2
    k = (rr - 2 * sigma ** 2) / (sigma ** 4) * np.exp(-rr / (2 * sigma ** 2))
    k -= k.mean()
    return k.astype(np.float32)


PRESETS: Dict[str, object] = {
    "gaussian": gaussian,
    "box": box,
    "identity": identity,
    "sobel_x": sobel_x,
    "sobel_y": sobel_y,
    "laplacian": laplacian,
    "sharpen": sharpen,
    "emboss": emboss,
    "motion_blur": motion_blur,
    "log": log_filter,
}


def preset(name: str, w: int = 3, **kw) -> torch.Tensor:
    fn = PRESETS[name]
    try:
        k = fn(w, **kw)
    except AssertionError:
        # fixed-size presets (sobel/laplacian/...) embedded into a w-window
        return embed_window(torch.from_numpy(fn(3)), w)
    return torch.from_numpy(k)


def default_bank(w_max: int = 7, num_slots: int = 8,
                 device: str = "cuda") -> CoefficientFile:
    """The register file a smart-vision stack would boot with."""
    cf = CoefficientFile(w_max=w_max, num_slots=num_slots, device=device)
    names = ["gaussian", "box", "identity", "sobel_x", "sobel_y",
             "laplacian", "sharpen", "emboss"][:num_slots]
    for i, n in enumerate(names):
        k = PRESETS[n]
        try:
            cf.write(i, k(w_max))
        except AssertionError:
            cf.write(i, k(3))
    return cf


# ---------------------------------------------------------------------------
# Separable decomposition (RIPL / Campos-style 2w fast path)
# ---------------------------------------------------------------------------


def decompose_separable(coeffs, tol: float = 1e-5):
    """Rank-1 (separable) decomposition of a w×w filter, or ``None``.

    A separable filter factors as ``coeffs = outer(u, v)``; applying the two
    1D passes costs 2w MACs/pixel instead of w². Detection is by SVD: the
    filter is accepted as separable iff its second singular value is below
    ``tol`` relative to the first (gaussian/box are exactly rank-1; laplacian,
    sharpen and the diagonal motion blur are correctly rejected).

    Returns ``(u, v)`` float32 arrays of shape [w] with
    ``outer(u, v) ≈ coeffs``, or ``None`` when the filter is not separable
    to within ``tol``.
    """
    k = np.asarray(coeffs, np.float64)
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"expected a square [w, w] filter, got {k.shape}")
    U, s, Vt = np.linalg.svd(k)
    if s[0] == 0.0:                       # zero filter: trivially separable
        z = np.zeros(k.shape[0], np.float32)
        return z, z.copy()
    if k.shape[0] > 1 and s[1] > tol * s[0]:
        return None
    root = math.sqrt(s[0])
    u = U[:, 0] * root
    v = Vt[0] * root
    sign = 1.0 if v[np.argmax(np.abs(v))] >= 0 else -1.0
    return ((u * sign).astype(np.float32), (v * sign).astype(np.float32))


def flops_per_pixel(w: int) -> int:
    """2·w² (paper: w² multipliers + w²-1 adders, counting MAC = 2 flops)."""
    return 2 * w * w


def arithmetic_intensity(w: int, bytes_per_pixel: int = 8) -> float:
    """flops per HBM byte for a single-pass filter (in once + out once)."""
    return flops_per_pixel(w) / bytes_per_pixel
