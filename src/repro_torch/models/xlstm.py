"""xLSTM blocks, as in the reference's ``models/xlstm.py``: mLSTM (matrix
memory, parallel and chunkwise) and sLSTM (scalar memory, a sequential
scan) — arXiv:2405.04517.

mLSTM's parallel form is attention-like with an exponential-gating decay
matrix D[t,s] = exp(Σ log σ(f) + i[s] − m[t]). The chunkwise form runs it
within chunks and carries the matrix memory (C [B,H,dh,dh], n [B,H,dh],
m [B,H]) across them, the reference's ``jax.lax.scan`` over chunks
becoming a loop; decode takes the recurrent ``_mlstm_step``. Keys are
scaled by 1/√dh where they are inserted, in both, so the two states
interchange.

sLSTM is sequential by design: ``slstm_scan`` is a Python loop over
time (the reference's ``lax.scan``), one ``slstm_step`` of a handful of
small launches per position. Gates and states are float32 throughout;
outputs are cast to the model dtype where the reference casts. The
reference runs both blocks' convs through the plain ``layers.dwconv1d``,
and so does the port.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dwconv1d, dwconv1d_specs, mlp
from repro_torch.models.module import p

NEG_INF = -1e30


def _model_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_specs(d: int, *, heads: int, pf: float = 2.0, conv_width: int = 4):
    d_in = int(pf * d)
    return {
        "up_proj": p((d, 2 * d_in), ("embed", "ssm_inner")),
        "conv": dwconv1d_specs(d_in, conv_width),
        "wq": p((d_in, d_in), ("ssm_inner", None)),
        "wk": p((d_in, d_in), ("ssm_inner", None)),
        "wv": p((d_in, d_in), ("ssm_inner", None)),
        "wi": p((d_in, heads), ("ssm_inner", None), init="small"),
        "wf": p((d_in, heads), ("ssm_inner", None), init="small"),
        "wo_gate": p((d_in, d_in), ("ssm_inner", None), init="small"),
        "norm": p((d_in,), ("ssm_inner",), init="ones"),
        "down_proj": p((d_in, d), ("ssm_inner", "embed")),
    }


def _mlstm_parallel(q, k, v, i_g, f_g):
    """Stabilised fully-parallel mLSTM (O(S²) memory: the chunkwise
    form's oracle). D[t,s] = exp(cumlogf[t] − cumlogf[s] + i[s] − m[t]),
    s ≤ t."""
    B, S, H, dh = q.shape
    logf = F.logsigmoid(f_g.float())                       # [B,S,H]
    cf = torch.cumsum(logf, dim=1)
    idx = torch.arange(S, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    logD = torch.where(causal,
                       cf[:, :, None, :] - cf[:, None, :, :]
                       + i_g.float()[:, None, :, :], NEG_INF)
    m = logD.amax(dim=2, keepdim=True)                     # [B,t,1,H]
    D = torch.exp(logD - m)
    scale = 1.0 / math.sqrt(dh)
    s_qk = torch.einsum("bthd,bshd->btsh", q.float(), k.float()) * scale
    w = s_qk * D
    norm = torch.maximum(w.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
    w = w / norm
    y = torch.einsum("btsh,bshd->bthd", w, v.float())
    return y.to(q.dtype)


def mlstm_chunk_body(carry, inp):
    """One chunk of the chunkwise mLSTM.

    carry: (C [B,H,dk,dv], n [B,H,dk], m [B,H]), the matrix memory in the
    stabilised domain (C and n carry an implicit exp(-m)). inp: (q, k, v
    [B,c,H,dh], logf, i_g [B,c,H] float32). Within the chunk the parallel
    D-masked form; q reads the carried memory decayed through the chunk
    prefix. Returns (the carry at the chunk's end, y [B,c,H,dh] float32).
    """
    C, n, m = carry
    q, k, v, logf, i_g = inp
    dh = q.shape[-1]
    c = q.shape[1]
    # k pre-scaled at insertion (as in _mlstm_step: the states interchange)
    q, v = q.float(), v.float()
    k = k.float() / math.sqrt(dh)

    cf = torch.cumsum(logf, dim=1)                        # [B,c,H] inclusive
    idx = torch.arange(c, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    logD = torch.where(causal,
                       cf[:, :, None, :] - cf[:, None, :, :]
                       + i_g[:, None, :, :], NEG_INF)     # [B,t,s,H]
    m_intra = logD.amax(dim=2)                            # [B,t,H]
    m_carry = cf + m[:, None, :]                          # decayed carry max
    m_t = torch.maximum(m_intra, m_carry)

    D = torch.exp(logD - m_t[:, :, None, :])
    s_qk = torch.einsum("bthd,bshd->btsh", q, k)
    w_intra = s_qk * D
    dec_q = torch.exp(m_carry - m_t)                      # [B,t,H]
    num = (torch.einsum("btsh,bshd->bthd", w_intra, v)
           + torch.einsum("bthd,bhde,bth->bthe", q, C, dec_q))
    den = (w_intra.sum(dim=2)
           + torch.einsum("bthd,bhd,bth->bth", q, n, dec_q))
    den = torch.maximum(den.abs(), torch.exp(-m_t))
    y = num / den[..., None]

    # the carry at the chunk's end: the old memory decayed by exp(cf_last),
    # the chunk's keys decayed to the end, restabilised at m_new
    cf_last = cf[:, -1, :]                                # [B,H]
    m_new = torch.maximum(cf_last + m,
                          (cf_last[:, None] - cf + i_g).amax(dim=1))
    dec_c = torch.exp(cf_last + m - m_new)                # [B,H]
    ins = torch.exp(cf_last[:, None] - cf + i_g - m_new[:, None])  # [B,c,H]
    C = (dec_c[:, :, None, None] * C
         + torch.einsum("bsh,bshd,bshe->bhde", ins, k, v))
    n = dec_c[:, :, None] * n + torch.einsum("bsh,bshd->bhd", ins, k)
    return (C, n, m_new), y


def mlstm_chunkwise(q, k, v, i_g, f_g, *, chunk: int = 256, state=None):
    """Chunked mLSTM: O(S·c) memory. q, k, v [B,S,H,dh]; i_g, f_g
    [B,S,H]; ``state`` a carry as ``mlstm_chunk_body`` takes it, or None
    (the empty memory, m at ``NEG_INF``). Returns (y [B,S,H,dh] in q's
    dtype, the final carry)."""
    B, S, H, dh = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"S={S} does not divide into chunks of {chunk}")
    logf = F.logsigmoid(f_g.float())
    i_gf = i_g.float()
    if state is None:
        state = _mlstm_zero(B, H, dh, q.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        state, y = mlstm_chunk_body(
            state, (q[:, sl], k[:, sl], v[:, sl], logf[:, sl], i_gf[:, sl]))
        ys.append(y)
    return torch.cat(ys, dim=1).to(q.dtype), state


def _mlstm_zero(B: int, H: int, dh: int, device):
    f32 = torch.float32
    return (torch.zeros((B, H, dh, dh), dtype=f32, device=device),
            torch.zeros((B, H, dh), dtype=f32, device=device),
            torch.full((B, H), NEG_INF, dtype=f32, device=device))


def _mlstm_step(q, k, v, i_g, f_g, state):
    """Recurrent step. q, k, v [B,H,dh]; i_g, f_g [B,H]; state (C
    [B,H,dh,dh], n [B,H,dh], m [B,H]). Returns (y [B,H,dh] float32, the
    new state)."""
    C, n, m = state
    q, k, v = q.float(), k.float(), v.float()
    dh = q.shape[-1]
    logf = F.logsigmoid(f_g.float())
    i = i_g.float()
    m_new = torch.maximum(logf + m, i)
    f_act = torch.exp(logf + m - m_new)
    i_act = torch.exp(i - m_new)
    k = k / math.sqrt(dh)
    C = f_act[..., None, None] * C + i_act[..., None, None] * (
        k[..., :, None] * v[..., None, :])               # [B,H,dh_k,dh_v]
    n = f_act[..., None] * n + i_act[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C, q)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], (C, n, m_new)


def _rms_gain(y: torch.Tensor, scale: torch.Tensor, dt: torch.dtype
              ) -> torch.Tensor:
    """The blocks' output norm: y in float32 over its mean square (eps
    1e-6), times ``scale``, cast to ``dt``."""
    yf = y.float()
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + 1e-6) * scale.float()).to(dt)


def mlstm_block(x: torch.Tensor, params, cfg, *, state_in=None):
    """mLSTM block (the residual is the caller's). x: [B,S,D];
    ``state_in``: None, or {'conv': [B,k-1,d_in], 'mlstm': (C, n, m)} to
    stream on from (S == 1 takes ``_mlstm_step``). Returns (y [B,S,D],
    {'conv': the conv state out, 'mlstm': the final memory, None without
    ``state_in``})."""
    B, S, D = x.shape
    H = cfg.num_heads
    dt = x.dtype
    up = x @ params["up_proj"].to(dt)
    d_in = up.shape[-1] // 2
    xm = up[..., :d_in]
    xc, new_conv = dwconv1d(xm, params["conv"],
                            None if state_in is None else state_in["conv"])
    xc = F.silu(xc)
    dh = d_in // H

    def heads(w, src):
        return (src @ w.to(dt)).reshape(B, S, H, dh)

    q = heads(params["wq"], xc)
    k = heads(params["wk"], xc)
    v = heads(params["wv"], xm)    # values from the non-conv path
    i_g = xc @ params["wi"].to(dt)
    f_g = xc @ params["wf"].to(dt)

    if S == 1 and state_in is not None:
        # the step's y stays float32 into the norm, as in the reference
        y, new_m = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_g[:, 0],
                               f_g[:, 0], state_in["mlstm"])
        y = y[:, None]
    else:
        # the reference's chunk rule: 256 where it divides S, else the
        # gcd, and the whole sequence when that is under 16
        chunk = 256 if S % 256 == 0 else (math.gcd(S, 256) or S)
        if chunk < 16:
            chunk = S
        y, fin = mlstm_chunkwise(
            q, k, v, i_g, f_g, chunk=min(chunk, S),
            state=None if state_in is None else state_in["mlstm"])
        new_m = fin if state_in is not None else None
    y = y.reshape(B, S, d_in)
    # gated output and norm, then the down-projection
    o = torch.sigmoid(xm @ params["wo_gate"].to(dt))
    y = _rms_gain(y, params["norm"], dt) * o
    out = y @ params["down_proj"].to(dt)
    return out, {"conv": new_conv, "mlstm": new_m}


def mlstm_state_init(cfg, batch: int, *, device):
    """An empty mLSTM streaming state: the conv's last k-1 inputs (the
    model dtype) and the memory (C, n, m) in float32, m at ``NEG_INF``."""
    d_in = int(2.0 * cfg.d_model)
    H = cfg.num_heads
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in),
                            dtype=_model_dtype(cfg), device=device),
        "mlstm": _mlstm_zero(batch, H, d_in // H, device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_specs(d: int, *, heads: int, conv_width: int = 4):
    f = int(d * 4 / 3) // 2 * 2
    return {
        "conv": dwconv1d_specs(d, conv_width),
        # i, f, z, o gates each get recurrent + input weights (block-diag
        # per head for the recurrent part)
        "w_in": p((d, 4 * d), ("embed", "ssm_inner")),
        "r": p((heads, 4, d // heads, d // heads), (None, None, None, None),
               init="small"),
        "b": p((4 * d,), ("ssm_inner",), init="zeros"),
        "norm": p((d,), ("embed",), init="ones"),
        "ffn": {
            "wi": p((d, f), ("embed", "mlp")),
            "wg": p((d, f), ("embed", "mlp")),
            "wo": p((f, d), ("mlp", "embed")),
        },
    }


def slstm_step(carry, g_t, r, b, heads: int):
    """One sLSTM time step. carry: (c, n, h, m) each [B, d] float32;
    g_t: [B, 4d] input gate pre-activations; r [heads, 4, dh, dh] and b
    [4d], float32. Returns (the new carry, h [B, d])."""
    c, n, h, m = carry
    B, d = c.shape
    dh = d // heads
    hh = h.reshape(B, heads, dh)
    rec = torch.einsum("bhk,hgkl->bhgl", hh, r)            # [B,H,4,dh]
    rec = rec.transpose(1, 2).reshape(B, 4 * d)
    z_all = g_t + rec + b
    zi, zf, zz, zo = z_all.chunk(4, dim=-1)
    log_f = F.logsigmoid(zf)
    m_new = torch.maximum(log_f + m, zi)
    i_act = torch.exp(zi - m_new)
    f_act = torch.exp(log_f + m - m_new)
    c_new = f_act * c + i_act * torch.tanh(zz)
    n_new = f_act * n + i_act
    h_new = torch.sigmoid(zo) * c_new / n_new.clamp_min(1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_zero(B: int, d: int, device):
    """(c, n, h, m): zeros, but n ones."""
    return tuple((torch.ones if i == 1 else torch.zeros)(
        (B, d), dtype=torch.float32, device=device) for i in range(4))


def slstm_scan(gates_in: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
               heads: int, state=None):
    """Sequential sLSTM over time. gates_in: [B,S,4d] pre-activations from
    the input; ``state``: (c, n, h, m) each [B, d] float32, or None (c, h,
    m zero, n one). Returns (h of every step [B,S,d] float32, the final
    state)."""
    B, S, d4 = gates_in.shape
    # casts hoisted out of the loop: the same values every step
    g, r, b = gates_in.float(), r.float(), b.float()
    carry = _slstm_zero(B, d4 // 4, gates_in.device) if state is None \
        else tuple(state)
    hs = []
    for t in range(S):
        carry, h = slstm_step(carry, g[:, t], r, b, heads)
        hs.append(h)
    return torch.stack(hs, dim=1), carry


def slstm_block(x: torch.Tensor, params, cfg, *, state_in=None):
    """sLSTM block (conv, scan, norm, FFN; the residual is the caller's).
    x: [B,S,D]; ``state_in``: None or {'conv': [B,k-1,D], 'slstm': (c, n,
    h, m)}. Returns (y [B,S,D], {'conv', 'slstm'} out)."""
    dt = x.dtype
    xc, new_conv = dwconv1d(x, params["conv"],
                            None if state_in is None else state_in["conv"])
    xc = F.silu(xc)
    gates = xc @ params["w_in"].to(dt)
    hs, new_state = slstm_scan(gates, params["r"], params["b"],
                               cfg.num_heads,
                               None if state_in is None
                               else state_in["slstm"])
    y = _rms_gain(hs.to(dt), params["norm"], dt)
    y = y + mlp(y, params["ffn"])
    return y, {"conv": new_conv, "slstm": new_state}


def slstm_state_init(cfg, batch: int, *, device):
    """An empty sLSTM streaming state: the conv's last k-1 inputs (the
    model dtype) and (c, n, h, m), each [B, d] float32, n one."""
    d = cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d),
                            dtype=_model_dtype(cfg), device=device),
        "slstm": _slstm_zero(batch, d, device),
    }
