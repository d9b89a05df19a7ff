"""Global-norm gradient clipping, as in the reference's ``optim/clip.py``.

The norm stays on the device (no sync); the scale is applied in float32
and cast back, in place: the tree returned is the one given.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.module import tree_leaves


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d), as the
    reference sums them. Not ``torch.linalg.vector_norm``: on the CPU its
    float32 error grows with the tensor (6.5e-4 low at 2^24 values,
    tests/test_torch_optim.py; h2o-danube's embedding gradient has 82M),
    where a sum of squares stays within 1e-6."""
    sums = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(sums).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float) -> Tuple[object, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / max(n, 1e-12))``, n the
    global norm, in place. Returns (tree, n)."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    for x in tree_leaves(tree):
        if x.dtype == torch.float32:
            x.mul_(scale)
        else:
            x.copy_((x.float() * scale).to(x.dtype))
    return tree, n
