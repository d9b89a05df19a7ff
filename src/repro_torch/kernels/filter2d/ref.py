"""Plain torch oracle for the ``filter2d_halo`` kernel's front door: the
``core/filter2d`` direct form, which every kernel form must match to float
tolerance (integers exactly)."""
from __future__ import annotations

import torch

from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.filter2d import filter2d as _filter2d


def filter2d_ref(frame: torch.Tensor, coeffs, border_policy: str = "mirror",
                 constant: float = 0.0) -> torch.Tensor:
    return _filter2d(frame, coeffs, form="direct",
                     border=BorderSpec(border_policy, constant))
