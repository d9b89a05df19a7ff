"""Cross-entropy losses, as in the reference's ``training/loss.py``.

``chunked_ce_from_hidden`` is the production path for large vocabularies:
the head projection and log-softmax run per sequence chunk, so the full
[B, S, V] float32 logit plane never exists. The reference scans over the
chunks under ``jax.lax.scan``; the port loops over them and, where a
gradient will be asked, wraps each chunk's projection and CE in
``torch.utils.checkpoint``, so backward recomputes one chunk's logits at
a time instead of holding every chunk's.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

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


def chunked_ce_from_hidden(hidden: torch.Tensor, head_w: torch.Tensor,
                           labels: torch.Tensor, *, chunk: int = 2048,
                           z_loss: float = 0.0, transpose_head: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [B,S,D] @ head -> CE against labels [B,S], chunked over S.

    head_w: [D, V] (or [V, D] with transpose_head=True — tied embeddings).
    """
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    if S % chunk != 0:                       # fall back: rare, test shapes
        logits = _project(hidden, head_w, transpose_head)
        return ce_loss(logits, labels, z_loss)

    def body(h, w, lab):
        ce, mask = _ce_terms(_project(h, w, transpose_head), lab, z_loss)
        return ce.sum(), mask.sum()

    remat = torch.is_grad_enabled() and (hidden.requires_grad
                                         or head_w.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        args = (hidden[:, s0:s0 + chunk], head_w, labels[:, s0:s0 + chunk])
        c_tot, c_cnt = (checkpoint(body, *args, use_reentrant=False,
                                   preserve_rng_state=False)
                        if remat else body(*args))
        tot = tot + c_tot
        cnt = cnt + c_cnt
    denom = torch.clamp(cnt, min=1.0)
    return tot / denom, denom


def _project(h: torch.Tensor, w: torch.Tensor,
             transpose: bool) -> torch.Tensor:
    if transpose:      # tied embedding table [V, D]
        return h @ w.to(h.dtype).t()
    return h @ w.to(h.dtype)
