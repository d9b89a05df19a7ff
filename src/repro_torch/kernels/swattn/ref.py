"""The plain torch version of the ``swattn`` kernel: masked dense
softmax attention, a block of queries at a time.

It repeats the kernel's arithmetic where it rounds: scores in float32
with the scale applied after the dot, the finite ``NEG_INF`` under the
mask, ``l`` summed from the float32 ``p``, ``p`` rounded to ``v``'s dtype
before the PV product, float32 accumulation, the output rounded to
``q``'s dtype. It normalises by the row's final maximum where the kernel
rescales an online one, so the two agree to rounding. Unlike the kernel
it repeats k and v across each GQA group and scores whole rows.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
Q_BLOCK = 1024            # queries scored at once (bounds the score plane)


def swattn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: int, scale: float) -> torch.Tensor:
    """q: [B,S,H,hd]; k, v: [B,S,KV,hd] (H % KV == 0). ``window`` > 0:
    sliding-window causal; 0: full causal. Returns [B,S,H,hd] in q's
    dtype."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    pos = torch.arange(S, device=q.device)
    out = torch.empty_like(q)
    for c0 in range(0, S, Q_BLOCK):
        qc = q[:, c0:c0 + Q_BLOCK].float()
        qpos = pos[c0:c0 + Q_BLOCK, None]
        ok = pos[None, :] <= qpos
        if window > 0:
            ok = ok & (qpos - pos[None, :] < window)
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale
        s = s.masked_fill(~ok, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)).masked_fill(~ok, 0.0)
        den = p.sum(dim=-1).transpose(1, 2)[..., None]          # [B,q,H,1]
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
        out[:, c0:c0 + Q_BLOCK] = (o / den).to(q.dtype)
    return out
