"""Selective state-space block (mamba-2 / SSD style), as in the reference's
``models/ssm.py``.

Per-head scalar decay (SSD): the chunked-parallel form turns the linear
recurrence into chunk-local "decay-masked attention" (all matmuls) plus
a sequential carry of the [H, dh, N] state over the chunks — the
reference's ``jax.lax.scan`` over chunks becomes a loop.

Shapes: d_in = expand·d_model, H mamba heads, dh = d_in/H, state N. The
conv path runs through the CUDA ``dwconv1d`` kernel with
``use_pallas_conv=True`` (the reference's name for its kernel path), the
plain ``layers.dwconv1d`` otherwise. Streaming (``state_in``): the conv
state is the 1D row buffer (k-1 rows), the ssm state the
infinite-window carry; prefill runs the chunked scan from the carried
state, decode the O(1) recurrent ``ssd_step``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

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
                Bm: torch.Tensor, Cm: torch.Tensor,
                h0: Optional[torch.Tensor] = None, *,
                chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked-parallel selective scan.

    x: [B,S,H,dh]; dt: [B,S,H] (>0); A: [H] (<0); Bm/Cm: [B,S,N].
    h0: [B,H,dh,N] float32 carry, or None (a zero state).
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
    h = (x.new_zeros((Bb, H, dh, N), dtype=torch.float32) if h0 is None
         else h0)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        h, y = ssd_body(h, (u[:, sl], la[:, sl], Bf[:, sl], Cf[:, sl]))
        ys.append(y)
    return torch.cat(ys, dim=1).to(x.dtype), h


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent step. x: [B,H,dh]; dt: [B,H]; Bm/Cm: [B,N];
    h: [B,H,dh,N]. Returns (y [B,H,dh], h')."""
    u = x.float() * dt.float()[..., None]
    dec = torch.exp(dt.float() * A.float())                  # [B,H]
    h = dec[:, :, None, None] * h + u[..., None] * Bm.float()[:, None, None]
    y = torch.einsum("bhdn,bn->bhd", h, Cm.float())
    return y.to(x.dtype), h


def mamba_block(x: torch.Tensor, params, cfg, *, state_in=None,
                use_pallas_conv: bool = False):
    """x: [B,S,D]. ``state_in``: None (training or scoring) or
    {'conv': [B,k-1,d_in], 'ssm': [B,H,dh,N]} to stream on from. Returns
    (y [B,S,D], {'conv': the conv state out (None on the kernel path),
    'ssm': the final ssm state}). S == 1 with a state takes the recurrent
    ``ssd_step``.

    ``use_pallas_conv``: the conv through the CUDA ``dwconv1d`` kernel
    (on a CPU tensor, its plain version), which keeps no conv state, so
    it refuses ``state_in`` as the reference does.
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
        if state_in is not None:
            raise ValueError("the kernel conv path is for stateless "
                             "training and scoring: it keeps no conv state")
        xs = dwconv1d_cuda(xs, params["conv"]["w"], params["conv"]["b"])
        new_conv = None
    else:
        xs, new_conv = dwconv1d(xs, params["conv"],
                                None if state_in is None
                                else state_in["conv"])
    xs = F.silu(xs)

    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = xs.reshape(Bb, S, H, dh)
    h0 = None if state_in is None else state_in["ssm"]
    if S == 1 and h0 is not None:                  # decode fast path
        y, h_fin = ssd_step(xh[:, 0], dt[:, 0], A, Bmat[:, 0], Cmat[:, 0], h0)
        y = y[:, None]
    else:
        y, h_fin = ssd_chunked(xh, dt, A, Bmat, Cmat, h0, chunk=chunk)
    y = y + xh * params["D"].float()[:, None]
    y = y.reshape(Bb, S, d_in)
    y = _gated_norm(y, z, params["norm"].float())
    y = y.to(x.dtype)
    out = y @ params["out_proj"].to(x.dtype)
    return out, {"conv": new_conv, "ssm": h_fin}


def _conv_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def mamba_state_abstract(cfg, batch: int):
    """``mamba_state_init`` on ``meta`` tensors."""
    return mamba_state_init(cfg, batch, device="meta")


def mamba_state_init(cfg, batch: int, *, device):
    """A zero streaming state: the conv's last k-1 inputs and the ssm
    carry."""
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.mamba_heads or max(1, d_in // 64)
    dh = d_in // H
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in),
                            dtype=_conv_dtype(cfg), device=device),
        "ssm": torch.zeros((batch, H, dh, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }
