"""Global-norm gradient clipping, as in the reference's ``optim/clip.py``.

The norm stays on the device (no sync); the scale is applied in float32
and cast back, in place: the tree returned is the one given. A sharded
leaf (``sharding.placement.ShardedTensor``) counts each element once:
its ``owned_units``, each distinct block once, however many coordinates
hold it. The scale is applied to those units and copied to the
replicas.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.module import tree_leaves
from repro_torch.sharding.placement import ShardedTensor


def _units(tree):
    out = []
    for x in tree_leaves(tree):
        out.extend(x.owned_units() if isinstance(x, ShardedTensor) else [x])
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d), as the
    reference sums them. Not ``torch.linalg.vector_norm``: on the CPU its
    float32 error grows with the tensor (6.5e-4 low at 2^24 values,
    tests/test_torch_optim.py; h2o-danube's embedding gradient has 82M),
    where a sum of squares stays within 1e-6."""
    home = _home(tree)
    sums = [x.float().square().sum().to(home) for x in _units(tree)]
    return torch.stack(sums).sum().sqrt()


def _home(tree) -> torch.device:
    x = tree_leaves(tree)[0]
    return (x.mesh.devices.flat[0] if isinstance(x, ShardedTensor)
            else x.device)


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float) -> Tuple[object, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / max(n, 1e-12))``, n the
    global norm, in place. Returns (tree, n)."""
    n = global_norm(tree)
    scale_by_norm(tree, n, max_norm)
    return tree, n


@torch.no_grad()
def scale_by_norm(tree, n: torch.Tensor, max_norm: float) -> None:
    """The clip of ``clip_by_global_norm`` for a norm ``n`` already
    taken, in place."""
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    for x in _units(tree):
        s = scale.to(x.device)
        if x.dtype == torch.float32:
            x.mul_(s)
        else:
            x.copy_((x.float() * s).to(x.dtype))
    for x in tree_leaves(tree):
        if isinstance(x, ShardedTensor):
            x.sync_replicas()
