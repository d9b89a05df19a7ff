"""Cross-entropy losses, as in the reference's ``training/loss.py``.

``chunked_ce_from_hidden`` is the production path for large vocabularies:
the head projection and log-softmax run per sequence chunk, so the full
[B, S, V] float32 logit plane never exists. The reference scans over the
chunks under ``jax.lax.scan``; the port loops over them and, where a
gradient will be asked, wraps each chunk's projection and CE in
``torch.utils.checkpoint``, so backward recomputes one chunk's logits at
a time instead of holding every chunk's.

In the mesh train step with tensor parallelism (``tp``, the head as
``tp.Parts`` split by vocabulary, ``sharding/tp.py``) the loss is
vocabulary-parallel, as the reference's partitioned program computes it
at its constraint (``loss.py:61``, ``act_vocab``): each member projects
its vocabulary block of the chunk; the row maximum and the sum of
exponentials are reduced over the members, the target's logit comes from
the member that holds it, and the z-loss squares the global
log-sum-exp. Under ``train_sp`` (the hidden states as the members'
token blocks, ``tp.Seq``) each member takes the CE of its own tokens over
the whole vocabulary (``seq_ce_loss``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.tp import Parts, Seq

IGNORE = -100


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """Per-token CE (+z-loss). logits [*, V]; labels [*] int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp(min=0)[..., None].long())[..., 0]
    ce = lse - tgt
    if z_loss > 0.0:
        ce = ce + z_loss * lse.square()
    mask = (labels != IGNORE).float()
    return ce * mask, mask


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 0.0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over non-ignored tokens. Returns (loss, denom)."""
    ce, mask = _ce_terms(logits, labels, z_loss)
    denom = torch.clamp(mask.sum(), min=1.0)
    return ce.sum() / denom, denom


def chunked_ce_from_hidden(hidden: torch.Tensor, head_w,
                           labels: torch.Tensor, *, chunk: int = 2048,
                           z_loss: float = 0.0, transpose_head: bool = False,
                           tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [B,S,D] @ head -> CE against labels [B,S], chunked over S.

    head_w: [D, V] (or [V, D] with transpose_head=True — tied embeddings),
    or its vocabulary blocks as ``tp.Parts`` with ``tp`` (module note).
    """
    if isinstance(hidden, Seq):
        return seq_ce_loss(hidden, head_w, labels, chunk=chunk,
                           z_loss=z_loss, transpose_head=transpose_head,
                           tp=tp)
    if isinstance(head_w, Parts) and hidden.shape[1] % min(
            chunk, hidden.shape[1]):
        return split_ce_loss(hidden, head_w, labels, z_loss,
                             transpose_head, tp)
    tot, cnt = _ce_sums(hidden, head_w, labels, chunk, z_loss,
                        transpose_head, tp)
    denom = torch.clamp(cnt, min=1.0)
    return tot / denom, denom


def _ce_sums(hidden: torch.Tensor, head_w, labels: torch.Tensor,
             chunk: int, z_loss: float, transpose_head: bool, tp=None):
    """``chunked_ce_from_hidden``'s sum of the CE terms and count of
    labels."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    split = isinstance(head_w, Parts)
    if S % chunk != 0:                       # fall back: rare, test shapes
        ce, mask = _ce_terms(_project(hidden, head_w, transpose_head),
                             labels, z_loss)
        return ce.sum(), mask.sum()

    def body(h, lab, *w):
        if split:
            tot, cnt = _split_terms(h, Parts(w, head_w.index), lab, z_loss,
                                    transpose_head, tp)
            return tp.recomputed_first(tot), cnt
        ce, mask = _ce_terms(_project(h, w[0], transpose_head), lab, z_loss)
        return ce.sum(), mask.sum()

    ws = tuple(head_w.tensors) if split else (head_w,)
    remat = torch.is_grad_enabled() and (
        hidden.requires_grad
        or any(w is not None and w.requires_grad for w in ws))
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        args = (hidden[:, s0:s0 + chunk], labels[:, s0:s0 + chunk], *ws)
        c_tot, c_cnt = (checkpoint(body, *args, use_reentrant=False,
                                   preserve_rng_state=False)
                        if remat else body(*args))
        tot = tot + c_tot
        cnt = cnt + c_cnt
    return tot, cnt


def seq_ce_loss(hidden: Seq, head_w: Parts, labels: torch.Tensor, *,
                chunk: int, z_loss: float, transpose_head: bool, tp
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss under ``train_sp`` (``hidden`` the members' token blocks,
    ``head_w`` every member's whole copy): each member takes the CE of
    its tokens over the whole vocabulary, chunked as
    ``chunked_ce_from_hidden`` (the reference's logits constraint gives
    'model' to the sequence and leaves the vocabulary whole); the sums
    of the CE terms and the counts of labels are all-reduced, so the mean
    over the labels is exact. Returns (loss, denom)."""
    members = range(len(hidden.spans))
    tots, cnts = [], []
    for m, h, lab in zip(tp.live(members), hidden.tensors,
                         tp.replicate(labels, members)):
        lab = lab[:, hidden.spans[m]]

        def part(m_, x, lab=lab):
            return _ce_sums(x, head_w[m_], lab, chunk, z_loss,
                            transpose_head)
        tot, cnt = tp.apply(m, h, part)
        tots.append(tot)
        cnts.append(cnt)
    tot = tp.all_reduce(tots, members)
    denom = torch.clamp(tp.all_reduce(cnts, members), min=1.0)
    return tot / denom, denom


def split_ce_loss(hidden: torch.Tensor, head_w, labels: torch.Tensor,
                  z_loss: float = 0.0, transpose_head: bool = False,
                  tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ce_loss`` of the logits ``hidden`` @ head, vocabulary-parallel
    (module note) and in one piece: the head's blocks as ``tp.Parts``.
    Returns (loss, denom)."""
    tot, cnt = _split_terms(hidden, head_w, labels, z_loss, transpose_head,
                            tp)
    denom = torch.clamp(cnt, min=1.0)
    return tot / denom, denom


def _split_terms(h: torch.Tensor, head_w, labels: torch.Tensor,
                 z_loss: float, transpose: bool, tp):
    """The vocabulary-parallel CE of one chunk: (sum of the CE terms,
    count of labels), on the group's first member (module note)."""
    members = head_w.members
    live = tp.live(members)
    vdim = 0 if transpose else 1
    parts = []
    for m, hm, lab in zip(live, tp.broadcast(h, members),
                          tp.replicate(labels, members)):
        mark = tp.marks(hm)
        with tp.part(m):
            logits = _project(tp.leave(hm) if mark else hm, head_w[m],
                              transpose).float()
        parts.append((m, logits, lab, mark))
    top = tp.all_reduce([lg.detach().amax(dim=-1) for _, lg, _, _ in parts],
                        members, "max")
    sums, tgts = [], []
    for (m, logits, lab, mark), top_m in zip(parts,
                                             tp.replicate(top, members)):
        with tp.part(m):
            n = logits.shape[-1]
            local = lab.long() - head_w.start(m, vdim)
            mine = (local >= 0) & (local < n)
            tgt = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
            tgt = torch.where(mine, tgt, 0.0)
            se = torch.exp(logits - top_m[..., None]).sum(dim=-1)
        if mark:
            se, tgt = tp.enter(m, se, tgt)
        sums.append(se)
        tgts.append(tgt)
    lse = top + torch.log(tp.all_reduce(sums, members))
    ce = lse - tp.all_reduce(tgts, members)
    if z_loss > 0.0:
        ce = ce + z_loss * lse.square()
    mask = (labels != IGNORE).float()
    return (ce * mask).sum(), mask.sum()


def _project(h: torch.Tensor, w: torch.Tensor,
             transpose: bool) -> torch.Tensor:
    if transpose:      # tied embedding table [V, D]
        return h @ w.to(h.dtype).t()
    return h @ w.to(h.dtype)
