"""Mixture-of-Experts block, as in the reference's ``models/moe.py``: top-k
routing with capacity-based gather/scatter dispatch (GShard-style
capacity, a sort for the slots, no one-hot dispatch product).

Routing is per batch row: each row's tokens are one routing group, with
its own capacity and its own aux loss (the reference vmaps over rows;
here every function takes the rows as a leading batch dimension). The
router runs in float32; the experts run as three batched products over
[B, E, C, D] in the model dtype (plain large products, which the
reference too leaves to the compiler outside any kernel).

What the port keeps of the reference on purpose:

- ``top_k``'s order: ``jax.lax.top_k`` puts the lower index first on an
  exact tie; ``torch.topk`` promises no order, so the top k come from a
  stable descending sort.
- The sentinel write (reference ``moe.py:87-89``): a dropped assignment
  writes the sentinel token S into slot E·C − 1, which is also the slot
  of expert E−1's last kept assignment when that expert is full. The
  reference's scatter keeps the last write in assignment order (XLA on
  the CPU), so a later drop erases that kept token's expert-E−1 output
  (ROADMAP R3). The port computes that slot's winner explicitly (the
  largest assignment index that writes it), so the result is the same
  on both devices; a CUDA ``index_put_`` with repeated indices would
  pick no defined winner.
- The combine: a scatter-add in the model dtype of the k weighted expert
  outputs of each token into zeros. The reference's indices are
  ``repeat(arange(S), k)``, so each token's k contributions are adjacent:
  they are added in assignment order, one dtype-rounded add at a time,
  with no atomics (deterministic on the card).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.module import p
from repro_torch.sharding.tp import Parts, at


def moe_specs(d: int, d_ff: int, num_experts: int, expert_tp: bool):
    # expert_tp: shard expert FFN dim over 'model' (E < |model|); else EP.
    e_ax = None if expert_tp else "experts"
    f_ax = "mlp" if expert_tp else "expert_mlp"
    return {
        "router": p((d, num_experts), ("embed", None), init="small"),
        "wi": p((num_experts, d, d_ff), (e_ax, "embed", f_ax)),
        "wg": p((num_experts, d, d_ff), (e_ax, "embed", f_ax)),
        "wo": p((num_experts, d_ff, d), (e_ax, f_ax, "embed")),
    }


def capacity(tokens_per_group: int, num_experts: int, k: int,
             capacity_factor: float, pad_to: int = 8) -> int:
    c = int(math.ceil(k * tokens_per_group * capacity_factor / num_experts))
    return max(pad_to, ((c + pad_to - 1) // pad_to) * pad_to)


def route(x: torch.Tensor, router_w: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [..., T, D] -> (weights [..., T, k] float32, experts [..., T, k]
    int64, aux loss [...] float32): softmax over the experts in float32,
    the top k (ties to the lower index), renormalised over the k; the
    Switch-style load-balance loss over the first choice."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)      # renormalise
    E = probs.shape[-1]
    me = probs.mean(dim=-2)
    ce = F.one_hot(top_i[..., 0], E).float().mean(dim=-2)
    aux = E * (me * ce).sum(dim=-1)
    return top_p, top_i, aux


def dispatch_indices(top_i: torch.Tensor, num_experts: int, cap: int,
                     T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based slotting. top_i: [..., T, k] -> (slot of each assignment
    [..., T·k] in [0, E·C), keep mask [..., T·k]): assignments grouped by
    expert in a stable sort, ranked within their expert, and dropped by
    rank beyond ``cap``."""
    lead = top_i.shape[:-2]
    k = top_i.shape[-1]
    flat_e = top_i.reshape(-1, T * k)                    # [G, T·k]
    order = torch.argsort(flat_e, dim=-1, stable=True)   # group by expert
    se = torch.gather(flat_e, -1, order)
    counts = F.one_hot(flat_e, num_experts).sum(dim=-2)  # [G, E]
    starts = torch.cumsum(counts, dim=-1) - counts       # exclusive cumsum
    ranks = (torch.arange(T * k, device=top_i.device)
             - torch.gather(starts, -1, se))
    keep_sorted = ranks < cap
    slot_sorted = se * cap + torch.clamp(ranks, max=cap - 1)
    # unsort back to assignment order
    slot = torch.empty_like(slot_sorted).scatter_(-1, order, slot_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return slot.reshape(lead + (T * k,)), keep.reshape(lead + (T * k,))


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x: [B, N, D], idx: [B, M] -> [B, M, D]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def dispatch_rows(slot: torch.Tensor, keep: torch.Tensor, num_experts: int,
                  cap: int, S: int, k: int) -> torch.Tensor:
    """The token each of the E·C expert slots reads, per row: slot [B,
    S·k], keep [B, S·k] -> [B, E·C], the sentinel S (a zero row) where no
    token is kept. As in the reference, every dropped assignment writes
    the sentinel into slot E·C − 1, and that slot holds the last write in
    assignment order (a kept token's, or a later drop's sentinel)."""
    B = slot.shape[0]
    dev = slot.device
    token_of_assign = torch.arange(S, device=dev).repeat_interleave(k)
    last = num_experts * cap - 1
    # kept assignments own their slots (unique); the dropped ones write
    # into a spare slot E·C, cut off after
    sel = torch.full((B, num_experts * cap + 1), S, dtype=torch.long,
                     device=dev)
    sel.scatter_(1, torch.where(keep, slot, last + 1),
                 token_of_assign.expand(B, -1))
    sel = sel[:, :last + 1]
    # the last write into slot E·C − 1: the largest assignment index
    # whose target it is
    target = torch.where(keep, slot, last)
    a = torch.arange(S * k, device=dev)
    writer = torch.where(target == last, a, -1).amax(dim=-1)   # [B]
    wk = writer.clamp(min=0)
    won = torch.where(keep.gather(-1, wk[:, None])[:, 0],
                      token_of_assign[wk], S)
    sel[:, last] = torch.where(writer >= 0, won, sel[:, last])
    return sel


def tp_experts(tp, num_experts: int, d_ff: int, expert_tp: bool = True):
    """The experts' split at their constraint points (the dispatched rows
    ``act_experts``, their hidden ``act_experts`` then ``act_mlp``) as
    (member, experts, columns) a computing member, or None where neither
    splits: the experts where they divide the axis, else (expert-TP) each
    expert's columns. ``expert_tp`` False (``moe_specs``' EP axes): where
    the hidden's constraint leaves the columns whole (the EP overrides
    give 'expert' to the experts first, and ``act_mlp`` on ('expert',
    'model') is dropped), each member takes its columns as the weights
    lie (``expert_mlp``, on 'model'), as the reference's partitioned
    program computes them; else the other 'model' members sit idle."""
    shape = (1, num_experts, 1, d_ff)
    blocks = tp.blocks(shape, ("act_batch", "act_experts", None, "act_mlp"))
    if not expert_tp and all(b[3] == slice(0, d_ff) for b in blocks):
        blocks = tp.blocks(shape, ("act_batch", "act_experts", None,
                                   "expert_mlp"))
    members = tp.members(blocks)
    if len(members) == 1:
        return None
    return [(m, blocks[m][1], blocks[m][3]) for m in members]


def tp_plan(tp, num_experts: int, d_ff: int, expert_tp: bool = True):
    """The MoE weights' regions at each member (``moe_specs``' shapes,
    ``expert_tp`` its flag), {} where nothing splits: the router whole at
    every computing member, each one's experts or columns of the three
    products."""
    split = tp_experts(tp, num_experts, d_ff, expert_tp)
    if split is None:
        return {}
    every = slice(None)
    out = {k: [None] * tp.n for k in ("router", "wi", "wg", "wo")}
    for m, es, cols in split:
        out["router"][m] = (every, every)
        out["wi"][m] = out["wg"][m] = (es, every, cols)
        out["wo"][m] = (es, cols, every)
    return out


def moe_block(x: torch.Tensor, params, *, num_experts: int, k: int,
              capacity_factor: float = 1.25, act=F.silu, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux loss: the rows' mean). Routing per
    batch row. With ``tp`` and the experts' weights as ``tp.Parts``: each
    member routes the rows itself (the router replicated), runs its
    experts (or, expert-TP, its columns of every expert) on the rows
    dispatched to them and combines its share; the shares are summed
    after the combine, which is linear in the experts' outputs (the
    reference's note at ``moe.py:105-109``: the all-reduce on [B, S, D],
    not on the padded E·C layout). The first member's aux loss is the
    block's."""
    if isinstance(params["wi"], Parts):
        wi = params["wi"]
        return tp.run(x, wi.members, lambda m, xm: _moe(
            xm, at(params, m), num_experts, k, capacity_factor, act,
            first=wi.start(m, 0)))
    return _moe(x, params, num_experts, k, capacity_factor, act)


def _moe(x: torch.Tensor, params, num_experts: int, k: int,
         capacity_factor: float, act, first: int = 0):
    """The block on the experts ``params`` holds: all of them, or those
    from expert ``first`` on (a tensor-parallel member's)."""
    B, S, D = x.shape
    E = num_experts
    cap = capacity(S, E, k, capacity_factor)
    w, idx, aux = route(x, params["router"], k)          # [B, S, k]
    slot, keep = dispatch_indices(idx, E, cap, S)        # [B, S·k]
    sel = dispatch_rows(slot, keep, E, cap, S, k)        # [B, E·C]
    El = params["wi"].shape[0]
    if El < E:                      # this member's experts' slots only
        sel = sel[:, first * cap:(first + El) * cap]
        slot = slot - first * cap
        keep = keep & (slot >= 0) & (slot < El * cap)
        slot = slot.clamp(0, El * cap - 1)
    # gather tokens into [B, E, C, D]; the sentinel row S reads zeros
    xpad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    xe = _gather_rows(xpad, sel).reshape(B, El, cap, D)
    dt = x.dtype
    h = torch.einsum("becd,edf->becf", xe, params["wi"].to(dt))
    g = torch.einsum("becd,edf->becf", xe, params["wg"].to(dt))
    h = act(g) * h
    ye = torch.einsum("becf,efd->becd", h, params["wo"].to(dt))
    # combine: each token's k weighted rows, added in assignment order
    # (assignment a is token a // k's choice a % k)
    contrib = _gather_rows(ye.reshape(B, El * cap, D), slot) * \
        w.reshape(B, S * k, 1).to(dt)
    contrib = torch.where(keep[..., None], contrib, 0).reshape(B, S, k, D)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]
    return y, aux.mean()
