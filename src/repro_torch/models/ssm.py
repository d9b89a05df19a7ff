"""Selective state-space block (mamba-2 / SSD style), as in the reference's
``models/ssm.py``.

Per-head scalar decay (SSD): the chunked-parallel form turns the linear
recurrence into chunk-local "decay-masked attention" (all matmuls) plus
a sequential carry of the [H, dh, N] state over the chunks — the
reference's ``jax.lax.scan`` over chunks becomes a loop.

On a mesh (``tp``, the weights as ``tp.Parts`` of ``tp_plan``) the
block splits over the group by channels of d_in (``act_ssm``), as the
reference's partitioned program does: each member projects its x and z
channels and the whole B, C, dt tail, runs the conv and the SSD scan on
its channels (each keeping its head's dt, A and D; a block may cut a
head, whose channels then scan as a head of their own width), and its
rows of the out-projection; the gated norm's mean square over the whole
d_in is the sum of the members' sums of squares, and the members'
partial outputs are summed.

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
from repro_torch.sharding.tp import Parts, at


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


def tp_channels(tp, d_in: int):
    """Each computing member's channels of a recurrent layer's inner dim
    (``act_ssm``), None where they do not split."""
    blocks = tp.blocks((1, 1, d_in), ("act_batch", None, "act_ssm"))
    members = tp.members(blocks)
    return None if len(members) == 1 else [(m, blocks[m][2])
                                           for m in members]


def tp_plan(tp, cfg):
    """The mamba block's regions at each member, by leaf path within the
    block, {} where its channels do not split (``mamba_specs``' shapes):
    ``in_proj``'s x and z columns of the member's channels and the whole
    B, C, dt tail (a region of three slices along the columns), the
    conv's and the norm's channels, ``out_proj``'s rows; A, dt_bias and D
    whole at every member."""
    d_in = cfg.ssm_expand * cfg.d_model
    split = tp_channels(tp, d_in)
    if split is None:
        return {}
    every = slice(None)
    out = {k: [None] * tp.n for k in (
        ("in_proj",), ("conv", "w"), ("conv", "b"), ("A_log",),
        ("dt_bias",), ("D",), ("norm",), ("out_proj",))}
    for m, c in split:
        tail = slice(2 * d_in, None)
        out[("in_proj",)][m] = (every, (
            c, slice(d_in + c.start, d_in + c.stop), tail))
        out[("conv", "w")][m] = (c, every)
        out[("conv", "b")][m] = (c,)
        for k in ("A_log", "dt_bias", "D"):
            out[(k,)][m] = (every,)
        out[("norm",)][m] = (c,)
        out[("out_proj",)][m] = (c, every)
    return out


def head_runs(c: slice, dh: int):
    """A channel block ``c`` as runs it scans: (first channel, last + 1,
    first head, heads, width), relative to the block; whole heads in one
    run of width dh, a head the block cuts as a run of one head of its
    width in the block."""
    runs, lo = [], c.start
    while lo < c.stop:
        h = lo // dh
        hi = min(c.stop, (h + 1) * dh)
        if lo == h * dh and hi == (h + 1) * dh and runs and \
                runs[-1][4] == dh and runs[-1][2] + runs[-1][3] == h:
            r = runs[-1]
            runs[-1] = (r[0], hi - c.start, r[2], r[3] + 1, dh)
        else:
            runs.append((lo - c.start, hi - c.start, h, 1, hi - lo))
        lo = hi
    return runs


def _run_state(h: torch.Tensor, c: slice, dh: int, run):
    """A run's block of an ssm state [B, H, dh, N] (a view)."""
    lo, _, h0, nh, width = run
    d0 = c.start + lo - h0 * dh
    return h[:, h0:h0 + nh, d0:d0 + width]


def ssd_body(h: torch.Tensor, inp):
    """One chunk of the SSD scan. h: [B,H,dh,N] carry; inp: (u, la, B, C)
    chunk slices. Returns (h', y [B,chunk,H,dh])."""
    u_, la_, B_, C_ = inp                              # [B,chunk,...]
    chunk = u_.shape[1]
    idx = torch.arange(chunk, device=u_.device)
    causal = idx[:, None] >= idx[None, :]              # s <= t
    P = torch.cumsum(la_, dim=1)                       # [B,chunk,H] inclusive
    # intra-chunk: decay-masked "attention" (entries in (0,1], stable).
    # The mask goes in before the exp: above the diagonal P_t - P_s > 0
    # can overflow to inf, whose masked gradient (inf x 0) would be NaN.
    L = torch.exp(torch.where(causal[None, :, :, None],
                              P[:, :, None, :] - P[:, None, :, :],
                              float("-inf")))                # [B,t,s,H]
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


def _chunk(cfg, S: int) -> int:
    chunk = min(cfg.ssd_chunk or 256, S)
    # meta tokens etc. may leave S non-divisible: fall back to gcd chunking
    if S % chunk:
        chunk = math.gcd(S, chunk)
        if chunk < 16:
            chunk = S
    return chunk


def mamba_block(x: torch.Tensor, params, cfg, *, state_in=None,
                use_pallas_conv: bool = False, tp=None):
    """x: [B,S,D]. ``state_in``: None (training or scoring) or
    {'conv': [B,k-1,d_in], 'ssm': [B,H,dh,N]} to stream on from. Returns
    (y [B,S,D], {'conv': the conv state out (None on the kernel path),
    'ssm': the final ssm state}). S == 1 with a state takes the recurrent
    ``ssd_step``.

    ``use_pallas_conv``: the conv through the CUDA ``dwconv1d`` kernel
    (on a CPU tensor, its plain version), which keeps no conv state, so
    it refuses ``state_in`` as the reference does.

    ``tp`` with the weights as ``tp.Parts`` (``tp_plan``): split over the
    group by channels (module note); ``state_in['conv']`` is then the
    members' blocks (``tp.Parts``, written in place by each member) and
    ``state_in['ssm']`` the rank's whole state on the first member, whose
    blocks go to the members and come back put together (``tp.send``,
    ``tp.put``).
    """
    Bb, S, D = x.shape
    chunk = _chunk(cfg, S)
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.mamba_heads or max(1, d_in // 64)
    dh = d_in // H
    N = cfg.ssm_state
    if isinstance(params["in_proj"], Parts):
        if use_pallas_conv:
            raise ValueError("the kernel conv path runs unsplit: on a "
                             "mesh the block splits its channels")
        return _mamba_split(x, params, cfg, tp, state_in, chunk)

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


def _mamba_split(x, params, cfg, tp, state_in, chunk: int):
    """``mamba_block`` split over ``tp`` by channels (module note)."""
    Bb, S, D = x.shape
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.mamba_heads or max(1, d_in // 64)
    dh = d_in // H
    N = cfg.ssm_state
    members = params["in_proj"].members
    norm = params["norm"]
    h_all = None if state_in is None else state_in["ssm"]

    def scan(m, xm):
        w = at(params, m)
        c = norm.index[m][0]
        n = c.stop - c.start
        xz = xm @ w["in_proj"].to(xm.dtype)
        xs, z = xz[..., :n], xz[..., n:2 * n]
        Bmat, Cmat = xz[..., 2 * n:2 * n + N], xz[..., 2 * n + N:2 * n + 2 * N]
        dt = xz[..., 2 * n + 2 * N:]
        conv = None if state_in is None else state_in["conv"][m]
        xs, new_conv = dwconv1d(xs, w["conv"], conv)
        xs = F.silu(xs)
        dt = F.softplus(dt.float() + w["dt_bias"].float())
        A = -torch.exp(w["A_log"].float())
        Dg = w["D"].float()
        ys, states = [], []
        for run in head_runs(c, dh):
            lo, hi, h0, nh, width = run
            xh = xs[..., lo:hi].reshape(Bb, S, nh, width)
            hs = slice(h0, h0 + nh)
            h0_ = (None if h_all is None
                   else tp.send(_run_state(h_all, c, dh, run), m))
            if S == 1 and h0_ is not None:             # decode fast path
                y, h_fin = ssd_step(xh[:, 0], dt[:, 0, hs], A[hs],
                                    Bmat[:, 0], Cmat[:, 0], h0_)
                y = y[:, None]
            else:
                y, h_fin = ssd_chunked(xh, dt[..., hs], A[hs], Bmat, Cmat,
                                       h0_, chunk=chunk)
            ys.append((y + xh * Dg[hs][:, None]).reshape(Bb, S, hi - lo))
            states.append(h_fin)
        y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)
        convs[m], finals[m] = new_conv, states
        return y.float() * F.silu(z.float())

    gated, convs, finals = [], {}, {}
    for m, xm in zip(tp.live(members), tp.broadcast(x, members)):
        gated.append(tp.apply(m, xm, scan)[0])
    var = tp.mean_square(gated, members, d_in)
    live = tp.live(members)

    def project(m, vm):
        w = at(params, m)
        yf = gated[live.index(m)]
        y = (yf * torch.rsqrt(vm + 1e-6) * w["norm"].float()).to(x.dtype)
        return y @ w["out_proj"].to(x.dtype)

    out = tp.row_sum([tp.apply(m, vm, project)[0]
                      for m, vm in zip(live, var)], members)
    if state_in is None:
        return out, {"conv": None, "ssm": None}
    new_ssm = torch.empty_like(h_all)
    for m in live:
        c = norm.index[m][0]
        for run, h_fin in zip(head_runs(c, dh), finals[m]):
            tp.put(_run_state(new_ssm, c, dh, run), h_fin, m)
    # a probe's members that do not run: their blocks sent and put back
    tp.states_unseen(2 * sum(t.nbytes for t in finals[0]), members)
    conv = state_in["conv"]
    return out, {"conv": Parts([convs.get(m) for m in range(len(
        conv.tensors))], conv.index), "ssm": new_ssm}


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
