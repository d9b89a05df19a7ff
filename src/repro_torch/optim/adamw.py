"""AdamW, as in the reference's ``optim/adamw.py``: the reference's
update, not ``torch.optim.AdamW`` (whose rounding order differs).

The state is a named tuple ``(step, m, v)`` that flattens like the
reference's, so the two packages read each other's checkpoints: ``step``
is a 0-d int32 tensor kept on the host (the schedule reads it with no
device sync), ``m`` and ``v`` float32 trees shaped like the parameters.
The update runs in place, leaf by leaf (each leaf's temporaries freed
before the next). On sharded parameters (``sharding.placement``)
``adamw_init`` gives moments of the same placement, and the mesh step
(``training/spmd.py``) updates each distinct block once
(``owned_units``) and copies it to its replicas. ``adamw_abstract``
gives the state on ``meta`` tensors, for the dry run, and
``opt_state_axes`` its logical axes, as the reference's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models import module as mod
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.sharding.placement import ShardedTensor


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar, on the host
    m: Any                   # float32 tree like params
    v: Any                   # float32 tree like params


def adamw_init(params) -> AdamWState:
    """Zero moments in float32, placed as the parameters (a sharded leaf
    gives sharded moments); the step on the host."""
    def zeros(p):
        if isinstance(p, ShardedTensor):
            return p.map_units(lambda t: torch.zeros_like(
                t, dtype=torch.float32))
        return torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def adamw_abstract(specs, dtype: torch.dtype = torch.float32) -> AdamWState:
    """The state of a ParamSpec tree on ``meta`` tensors (shapes and dtypes
    only), as the reference's ``adamw_abstract``."""
    ab = mod.abstract_params(specs, dtype)
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=ab, v=mod.abstract_params(specs, dtype))


def opt_state_axes(specs) -> AdamWState:
    """Logical axes of the state tree: the parameters' for m and v, none
    for the step."""
    ax = mod.map_specs(lambda s: s.axes, specs)
    return AdamWState(step=(), m=ax, v=ax)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step, in place on ``params`` and ``state``'s m and v.
    ``grads``: a tree like ``params``, or a list of its leaves. Returns
    (params, state) with the step advanced."""
    step = state.step + 1
    t = np.float32(int(step))
    bc1 = float(np.float32(1.0) - np.float32(b1) ** t)   # float32, as the
    bc2 = float(np.float32(1.0) - np.float32(b2) ** t)   # reference's
    for p_, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float()
        m.mul_(b1).add_(g * (1.0 - b1))
        v.mul_(b2).add_(g * g * (1.0 - b2))
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        delta.add_(p_.float() * weight_decay)
        if p_.dtype == torch.float32:
            p_.sub_(delta.mul_(lr))
        else:
            p_.copy_((p_.float() - delta.mul_(lr)).to(p_.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v)
