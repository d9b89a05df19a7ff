"""GQA attention for training and scoring (no cache), as in the
reference's ``models/attention.py``: the projections, the position-based
mask and the q-chunked plain ``attend``. The KV-cache half (ring caches,
prefill writes, decode) waits for the prefill/decode slice.

Masking is position-based: every key carries its absolute position (PAD =
-1 never attended, META = -2 always attended — hymba meta tokens act as
attention sinks). The banded CUDA kernel (``kernels/swattn``) replaces
``attend`` where the transformer's kernel gate lets it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.module import p

PAD_POS = -1
META_POS = -2

NEG_INF = -1e30


def attn_specs(d: int, num_heads: int, num_kv: int, head_dim: int,
               use_qk_norm: bool = False):
    specs = {
        "wq": p((d, num_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": p((d, num_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": p((d, num_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": p((num_heads, head_dim, d), ("heads", "head_dim", "embed")),
    }
    if use_qk_norm:
        specs["q_norm"] = p((head_dim,), ("head_dim",), init="ones")
        specs["k_norm"] = p((head_dim,), ("head_dim",), init="ones")
    return specs


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B,S,D] @ [D,H,hd] -> [B,S,H,hd]."""
    D, H, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * hd)).unflatten(-1, (H, hd))


def qkv_project(x: torch.Tensor, params, use_qk_norm: bool = False):
    """x: [B,S,D] -> q [B,S,H,hd], k,v [B,S,Kv,hd] (pre-RoPE)."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if use_qk_norm:
        q = _rms(q, params["q_norm"])
        k = _rms(k, params["k_norm"])
    return q, k, v


def out_project(o: torch.Tensor, params) -> torch.Tensor:
    """[B,S,H,hd] @ [H,hd,D] -> [B,S,D]."""
    H, hd, D = params["wo"].shape
    return o.flatten(-2) @ params["wo"].to(o.dtype).reshape(H * hd, D)


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B,S,Kv,hd] -> [B,S,H,hd] by repetition."""
    Kv = k.shape[2]
    if Kv == num_heads:
        return k
    return k.repeat_interleave(num_heads // Kv, dim=2)


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
          window, sinks: int = 0) -> torch.Tensor:
    """q_pos [B,Sq], kv_pos [B,Skv] -> bool [B,1,Sq,Skv].

    ``sinks`` > 0: the first ``sinks`` absolute positions are always
    attended (hymba meta tokens act as attention sinks), escaping the
    sliding window but not causality.
    """
    qp = q_pos[:, :, None]          # [B,Sq,1]
    kp = kv_pos[:, None, :]         # [B,1,Skv]
    ok = kp != PAD_POS
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        w = int(window)
        in_win = (qp - kp) < w if w > 0 else torch.ones_like(ok)
        if sinks:
            in_win = in_win | (kp < sinks)
        ok = ok & in_win
    ok = ok | (kp == META_POS)
    return ok[:, None, :, :]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
           causal: bool = True, window=None, softcap: float = 0.0,
           q_chunk: int = 1024, scale: Optional[float] = None,
           sinks: int = 0) -> torch.Tensor:
    """Full attention math. q [B,Sq,H,hd]; k,v [B,Skv,H,hd] (kv
    pre-repeated). Loops over q chunks so the [Sq,Skv] scores are never
    all materialised at once. Softmax in float32."""
    B, Sq, H, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    def block(q_blk, qp_blk):
        s = torch.einsum("bqhk,bshk->bhqs", q_blk, k).float() * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        m = _mask(qp_blk, kv_pos, causal, window, sinks)
        s = torch.where(m, s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqs,bshk->bqhk", w, v)

    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        return torch.cat([block(q[:, i:i + q_chunk], q_pos[:, i:i + q_chunk])
                          for i in range(0, Sq, q_chunk)], dim=1)
    return block(q, q_pos)
