"""Selective state-space block (mamba-2 / SSD style), stateless, as in the
reference's ``models/ssm.py``.

Per-head scalar decay (SSD): the chunked-parallel form turns the linear
recurrence into chunk-local "decay-masked attention" (all matmuls) plus
a sequential carry of the [H, dh, N] state over the chunks — the
reference's ``jax.lax.scan`` over chunks becomes a loop.

Shapes: d_in = expand·d_model, H mamba heads, dh = d_in/H, state N. The
conv path runs through the CUDA ``dwconv1d`` kernel with
``use_pallas_conv=True`` (the reference's name for its kernel path), the
plain ``layers.dwconv1d`` otherwise. Streaming state in and out
(``state_in``), the one-token ``ssd_step`` and the state inits wait for
the decode slice.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.dwconv1d import dwconv1d_cuda
from repro_torch.models.layers import dwconv1d, dwconv1d_specs
from repro_torch.models.module import p


def mamba_specs(d: int, *, expand: int, heads: int, state: int,
                conv_width: int):
    d_in = expand * d
    return {
        "in_proj": p((d, 2 * d_in + 2 * state + heads),
                     ("embed", "ssm_inner")),
        "conv": dwconv1d_specs(d_in, conv_width),
        "A_log": p((heads,), (None,), init="zeros"),       # A = -exp(A_log)
        "dt_bias": p((heads,), (None,), init="zeros"),
        "D": p((heads,), (None,), init="ones"),
        "norm": p((d_in,), ("ssm_inner",), init="ones"),
        "out_proj": p((d_in, d), ("ssm_inner", "embed")),
    }


def _split_proj(xz: torch.Tensor, d_in: int, state: int, heads: int):
    x = xz[..., :d_in]
    z = xz[..., d_in:2 * d_in]
    Bmat = xz[..., 2 * d_in:2 * d_in + state]
    Cmat = xz[..., 2 * d_in + state:2 * d_in + 2 * state]
    dt = xz[..., 2 * d_in + 2 * state:]
    return x, z, Bmat, Cmat, dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def ssd_body(h: torch.Tensor, inp):
    """One chunk of the SSD scan. h: [B,H,dh,N] carry; inp: (u, la, B, C)
    chunk slices. Returns (h', y [B,chunk,H,dh])."""
    u_, la_, B_, C_ = inp                              # [B,chunk,...]
    chunk = u_.shape[1]
    idx = torch.arange(chunk, device=u_.device)
    causal = idx[:, None] >= idx[None, :]              # s <= t
    P = torch.cumsum(la_, dim=1)                       # [B,chunk,H] inclusive
    # intra-chunk: decay-masked "attention" (entries in (0,1], stable)
    L = torch.exp(P[:, :, None, :] - P[:, None, :, :])  # [B,t,s,H]
    L = torch.where(causal[None, :, :, None], L, 0.0)
    G = torch.einsum("btn,bsn->bts", C_, B_)           # [B,t,s]
    y_intra = torch.einsum("btsh,bshd->bthd", G[..., None] * L, u_)
    # inter-chunk: carry contribution
    y_inter = torch.einsum("btn,bhdn,bth->bthd", C_, h, torch.exp(P))
    # state update: h' = exp(P_last) ⊙ h + Σ_s exp(P_last - P_s) B_s ⊗ u_s
    dec_last = torch.exp(P[:, -1:, :] - P)             # [B,chunk,H]
    h_new = (torch.exp(P[:, -1])[:, :, None, None] * h
             + torch.einsum("bsh,bshd,bsn->bhdn", dec_last, u_, B_))
    return h_new, y_intra + y_inter


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *,
                chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked-parallel selective scan from a zero state.

    x: [B,S,H,dh]; dt: [B,S,H] (>0); A: [H] (<0); Bm/Cm: [B,S,N].
    Returns (y [B,S,H,dh], h_final [B,H,dh,N]).
    """
    Bb, S, H, dh = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} does not divide into chunks of {chunk}")
    u = x.float() * dt.float()[..., None]            # dt folded into input
    la = dt.float() * A.float()                      # [B,S,H] log-decay <= 0
    Bf, Cf = Bm.float(), Cm.float()
    h = x.new_zeros((Bb, H, dh, N), dtype=torch.float32)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        h, y = ssd_body(h, (u[:, sl], la[:, sl], Bf[:, sl], Cf[:, sl]))
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h


def mamba_block(x: torch.Tensor, params, cfg, *,
                use_pallas_conv: bool = False):
    """x: [B,S,D], stateless (training or scoring). Returns (y [B,S,D],
    {'conv': final conv state or None, 'ssm': final ssm state}).

    ``use_pallas_conv``: the conv through the CUDA ``dwconv1d`` kernel
    (on a CPU tensor, its plain version), which keeps no conv state.
    """
    Bb, S, D = x.shape
    chunk = cfg.ssd_chunk or 256
    # meta tokens etc. may leave S non-divisible: fall back to gcd chunking
    chunk = min(chunk, S)
    if S % chunk:
        chunk = math.gcd(S, chunk)
        if chunk < 16:
            chunk = S
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.mamba_heads or max(1, d_in // 64)
    dh = d_in // H
    N = cfg.ssm_state

    xz = x @ params["in_proj"].to(x.dtype)
    xs, z, Bmat, Cmat, dt = _split_proj(xz, d_in, N, H)
    if use_pallas_conv:
        xs = dwconv1d_cuda(xs, params["conv"]["w"], params["conv"]["b"])
        new_conv = None          # the kernel path keeps no conv state
    else:
        xs, new_conv = dwconv1d(xs, params["conv"])
    xs = F.silu(xs)

    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xs.reshape(Bb, S, H, dh)
    y, h_fin = ssd_chunked(xh, dt, A, Bmat, Cmat, chunk=chunk)
    y = y + xh * params["D"].float()[:, None]
    y = y.reshape(Bb, S, d_in)
    y = _gated_norm(y, z, params["norm"].float())
    y = y.to(x.dtype)
    out = y @ params["out_proj"].to(x.dtype)
    return out, {"conv": new_conv, "ssm": h_fin}
