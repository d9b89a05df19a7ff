"""The plain torch version of the ``dwconv1d`` kernel: causal depthwise
conv as a shift-multiply-add chain over the k taps, in x's dtype, tap by
tap — the kernel's own order and roundings, so the two agree bit for
bit."""
from __future__ import annotations

import torch


def dwconv1d_ref(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: [B,S,C]; w: [k,C]; b: [C] (x's dtype) -> [B,S,C].

    y[t] = b + sum_d x[t-(k-1)+d] * w[d], zero history (causal).
    """
    B, S, C = x.shape
    k = w.shape[0]
    xp = torch.cat([x.new_zeros((B, k - 1, C)), x], dim=1)
    y = xp[:, 0:S] * w[0]
    for d in range(1, k):
        y = y + xp[:, d:d + S] * w[d]
    return y + b
