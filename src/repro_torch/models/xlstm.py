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

On a mesh (``tp``, the weights as ``tp.Parts`` of ``mlstm_plan`` /
``slstm_plan``), as the reference's partitioned program splits them over
``act_ssm``: the mLSTM by channels of d_in, each member projecting its
channels of the up-projection (never the unread second half), running
the conv on them and taking its rows of the q, k, v, gate and output-gate
projections (a split contraction, the members' partial products summed);
the memory then runs by heads, each member its heads' (where the
channel blocks are whole heads; else whole on the group's first
member), the norm's mean square is summed over the members and
``down_proj``'s rows are split. The sLSTM runs by heads (its recurrence
is block-diagonal by head, so a member's heads scan on their own): each
member its heads' four gate columns of ``w_in`` and ``b`` and its heads
of ``r``, the hidden states put together on the first member, which
runs the conv and the norm; its FFN splits by columns as the gated MLP.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dwconv1d, dwconv1d_specs, mlp,
                                      mlp_plan)
from repro_torch.models.module import p
from repro_torch.models.ssm import tp_channels
from repro_torch.sharding.tp import Parts, at

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


def mlstm_plan(tp, cfg):
    """The mLSTM block's regions at each member, by leaf path within the
    block, {} where its channels do not split (``mlstm_specs``' shapes):
    ``up_proj``'s columns of the member's channels (the first half's: the
    second is never read), the conv's channels, the rows of the q, k, v,
    gate and output-gate projections and of ``down_proj``; the norm's
    channels where the channel blocks are whole heads (the memory runs by
    heads), else the norm whole at the first member, which runs the
    memory and the norm."""
    d_in = int(2.0 * cfg.d_model)
    split = tp_channels(tp, d_in)
    if split is None:
        return {}
    every = slice(None)
    by_heads = _head_blocks(split, d_in // cfg.num_heads)
    rows = ("wq", "wk", "wv", "wi", "wf", "wo_gate", "down_proj")
    names = [("up_proj",), ("conv", "w"), ("conv", "b")] + [
        (k,) for k in rows + (("norm",) if by_heads else ())]
    out = {k: [None] * tp.n for k in names}
    for m, c in split:
        out[("up_proj",)][m] = (every, c)
        out[("conv", "w")][m] = (c, every)
        out[("conv", "b")][m] = (c,)
        for k in rows:
            out[(k,)][m] = (c, every)
        if by_heads:
            out[("norm",)][m] = (c,)
    return out


def _head_blocks(split, dh: int) -> bool:
    """Whether every member's channel block is whole heads."""
    return all(c.start % dh == 0 and c.stop % dh == 0 for _, c in split)


def _heads_of(c: slice, dh: int) -> slice:
    return slice(c.start // dh, c.stop // dh)


def mlstm_block(x: torch.Tensor, params, cfg, *, state_in=None, tp=None):
    """mLSTM block (the residual is the caller's). x: [B,S,D];
    ``state_in``: None, or {'conv': [B,k-1,d_in], 'mlstm': (C, n, m)} to
    stream on from (S == 1 takes ``_mlstm_step``). Returns (y [B,S,D],
    {'conv': the conv state out, 'mlstm': the final memory, None without
    ``state_in``}). ``tp`` with the weights as ``tp.Parts``
    (``mlstm_plan``): split over the group (module note); the conv state
    is then the members' blocks (``tp.Parts``) and the memory the rank's
    whole state on the first member."""
    if isinstance(params["up_proj"], Parts):
        return _mlstm_split(x, params, cfg, tp, state_in)
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

    y, new_m = _memory(q, k, v, i_g, f_g,
                       None if state_in is None else state_in["mlstm"])
    y = y.reshape(B, S, d_in)
    # gated output and norm, then the down-projection
    o = torch.sigmoid(xm @ params["wo_gate"].to(dt))
    y = _rms_gain(y, params["norm"], dt) * o
    out = y @ params["down_proj"].to(dt)
    return out, {"conv": new_conv, "mlstm": new_m}


def _mlstm_chunk(S: int) -> int:
    """The reference's chunk rule: 256 where it divides S, else the gcd,
    and the whole sequence when that is under 16."""
    chunk = 256 if S % 256 == 0 else (math.gcd(S, 256) or S)
    return min(S if chunk < 16 else chunk, S)


def _memory(q, k, v, i_g, f_g, state):
    """The memory's output [B, S, H, dh] and the final memory (None
    without ``state``): S == 1 with a state takes ``_mlstm_step``, whose
    output stays float32 into the norm, as in the reference; else the
    chunkwise form."""
    S = q.shape[1]
    if S == 1 and state is not None:
        y, new = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_g[:, 0],
                             f_g[:, 0], state)
        return y[:, None], new
    y, fin = mlstm_chunkwise(q, k, v, i_g, f_g, chunk=_mlstm_chunk(S),
                             state=state)
    return y, (fin if state is not None else None)


def _mlstm_split(x, params, cfg, tp, state_in):
    """``mlstm_block`` split over ``tp`` (module note)."""
    B, S, D = x.shape
    H = cfg.num_heads
    dt = x.dtype
    d_in = int(2.0 * cfg.d_model)
    dh = d_in // H
    up = params["up_proj"]
    members = up.members
    live = tp.live(members)
    chans = {m: up.index[m][1] for m in members}
    by_heads = isinstance(params["norm"], Parts)

    def project(m, xm):
        w = at(params, m)
        xm_ = xm @ w["up_proj"].to(dt)
        conv = None if state_in is None else state_in["conv"][m]
        xc, new_conv = dwconv1d(xm_, w["conv"], conv)
        xc = F.silu(xc)
        # the partial products of the member's rows, one tensor to sum
        convs[m] = new_conv
        return torch.cat([xc @ w["wq"].to(dt), xc @ w["wk"].to(dt),
                          xm_ @ w["wv"].to(dt), xm_ @ w["wo_gate"].to(dt),
                          xc @ w["wi"].to(dt), xc @ w["wf"].to(dt)], dim=-1)

    convs = {}
    parts = [tp.apply(m, xm, project)[0]
             for m, xm in zip(live, tp.broadcast(x, members))]
    summed = tp.all_reduce(parts, members)

    def split4(t, n):
        """q, k, v, the output gate's input, i and f, of ``n`` channels."""
        return t.split([n] * 4 + [n // dh] * 2, dim=-1)

    mem = None if state_in is None else state_in["mlstm"]
    if by_heads:
        def columns(m):
            """Member m's columns of the sum: its channels of q, k, v and
            the output gate's input, its heads of i and f."""
            c, hs = chans[m], _heads_of(chans[m], dh)
            idx = [torch.arange(c.start, c.stop) + j * d_in
                   for j in range(4)]
            idx += [torch.arange(hs.start, hs.stop) + 4 * d_in + j * H
                    for j in range(2)]
            return (Ellipsis, torch.cat(idx).to(summed.device))
        mine = tp.scatter(summed, [columns(m) if m in chans else None
                                   for m in range(tp.n)], members)
        news = {}

        def memory(m, t):
            c = chans[m]
            n, nh = c.stop - c.start, (c.stop - c.start) // dh
            q, k, v, o, i_g, f_g = split4(t, n)
            hs = _heads_of(c, dh)
            st = (None if mem is None else
                  tuple(tp.send(s_[:, hs], m) for s_ in mem))
            y, new = _memory(q.reshape(B, S, nh, dh), k.reshape(B, S, nh, dh),
                             v.reshape(B, S, nh, dh), i_g, f_g, st)
            news[m] = new
            return y.reshape(B, S, n).float(), torch.sigmoid(o)

        outs = [tp.apply(m, t, memory) for m, t in zip(live, mine)]
        var = tp.mean_square([y for y, _ in outs], members, d_in)

        def down(m, vm):
            w = at(params, m)
            y, o = outs[live.index(m)]
            g = (y * torch.rsqrt(vm + 1e-6) * w["norm"].float()).to(dt) * o
            return g @ w["down_proj"].to(dt)

        out = tp.row_sum([tp.apply(m, vm, down)[0]
                          for m, vm in zip(live, var)], members)
        new_m = None
        if mem is not None:
            new_m = tuple(torch.empty_like(s_) for s_ in mem)
            for m in live:
                hs = _heads_of(chans[m], dh)
                for dst, t in zip(new_m, news[m]):
                    tp.put(dst[:, hs], t, m)
            tp.states_unseen(2 * sum(t.nbytes for t in news[0]), members)
    else:
        # the memory whole on the first member, then each member's
        # channels of its gated output through its rows of down_proj
        q, k, v, o, i_g, f_g = split4(summed, d_in)
        y, new_m = _memory(q.reshape(B, S, H, dh), k.reshape(B, S, H, dh),
                           v.reshape(B, S, H, dh), i_g, f_g, mem)
        g = _rms_gain(y.reshape(B, S, d_in), params["norm"], dt) \
            * torch.sigmoid(o)
        blocks = [None if m not in chans else (Ellipsis, chans[m])
                  for m in range(tp.n)]
        out = tp.row_sum([tp.apply(m, gm, lambda m, gm: gm @ at(
            params, m)["down_proj"].to(dt))[0]
            for m, gm in zip(live, tp.scatter(g, blocks, members))],
            members)
    if state_in is None:
        return out, {"conv": None, "mlstm": None}
    conv = state_in["conv"]
    return out, {"conv": Parts([convs.get(m) for m in range(len(
        conv.tensors))], conv.index), "mlstm": new_m}


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


def mlstm_state_abstract(cfg, batch: int):
    """``mlstm_state_init`` on ``meta`` tensors."""
    return mlstm_state_init(cfg, batch, device="meta")


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


def slstm_plan(tp, cfg):
    """The sLSTM block's regions at each member, by leaf path within the
    block (``slstm_specs``' shapes): where the heads split over the group (``act_ssm`` on the
    heads' channels, in whole heads), each member's four gate columns of
    its heads' channels in ``w_in`` and ``b`` (regions of four slices)
    and its heads of ``r``; and the FFN's columns (``act_mlp``,
    ``layers.mlp_plan``). The conv and the norm stay whole at the first
    member."""
    d, H = cfg.d_model, cfg.num_heads
    out = {("ffn", k): v for k, v in mlp_plan(
        tp, int(d * 4 / 3) // 2 * 2).items()}
    split = tp_channels(tp, d)
    if split is None or not _head_blocks(split, d // H):
        return out
    every = slice(None)
    for k in ("w_in", "b", "r"):
        out[(k,)] = [None] * tp.n
    for m, c in split:
        gates = tuple(slice(j * d + c.start, j * d + c.stop)
                      for j in range(4))
        out[("w_in",)][m] = (every, gates)
        out[("b",)][m] = (gates,)
        out[("r",)][m] = (_heads_of(c, d // H), every, every, every)
    return out


def slstm_block(x: torch.Tensor, params, cfg, *, state_in=None, tp=None):
    """sLSTM block (conv, scan, norm, FFN; the residual is the caller's).
    x: [B,S,D]; ``state_in``: None or {'conv': [B,k-1,D], 'slstm': (c, n,
    h, m)}. Returns (y [B,S,D], {'conv', 'slstm'} out). ``tp`` with the
    weights as ``tp.Parts`` (``slstm_plan``): the scan by heads and the
    FFN by columns (module note); the state stays the rank's whole, on
    the first member."""
    dt = x.dtype
    xc, new_conv = dwconv1d(x, params["conv"],
                            None if state_in is None else state_in["conv"])
    xc = F.silu(xc)
    state = None if state_in is None else state_in["slstm"]
    if isinstance(params["w_in"], Parts):
        hs, new_state = _slstm_split(xc, params, cfg, tp, state)
    else:
        gates = xc @ params["w_in"].to(dt)
        hs, new_state = slstm_scan(gates, params["r"], params["b"],
                                   cfg.num_heads, state)
    y = _rms_gain(hs.to(dt), params["norm"], dt)
    y = y + mlp(y, params["ffn"], tp=tp)
    return y, {"conv": new_conv, "slstm": new_state}


def _slstm_split(xc, params, cfg, tp, state):
    """The sLSTM's scan by heads over ``tp``: each member's heads from its
    gate columns; their hidden states put together on the first member,
    and the new state too (``state``: the rank's whole, or None)."""
    w_in = params["w_in"]
    members = w_in.members
    live = tp.live(members)
    d = cfg.d_model
    dh = d // cfg.num_heads
    chans = {m: slice(params["r"].index[m][0].start * dh,
                      params["r"].index[m][0].stop * dh) for m in members}
    finals = {}

    def scan(m, xm):
        w = at(params, m)
        c = chans[m]
        st = (None if state is None else
              tuple(tp.send(s_[:, c], m) for s_ in state))
        hs, finals[m] = slstm_scan(xm @ w["w_in"].to(xm.dtype), w["r"],
                                   w["b"], (c.stop - c.start) // dh, st)
        return hs

    hs = tp.collect([tp.apply(m, xm, scan)[0]
                     for m, xm in zip(live, tp.broadcast(xc, members))],
                    members, -1)
    if state is None:
        return hs, None
    new = tuple(torch.empty_like(s_) for s_ in state)
    for m in live:
        for dst, t in zip(new, finals[m]):
            tp.put(dst[:, chans[m]], t, m)
    tp.states_unseen(2 * sum(t.nbytes for t in finals[0]), members)
    return hs, new


def slstm_state_init(cfg, batch: int, *, device):
    """An empty sLSTM streaming state: the conv's last k-1 inputs (the
    model dtype) and (c, n, h, m), each [B, d] float32, n one."""
    d = cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d),
                            dtype=_model_dtype(cfg), device=device),
        "slstm": _slstm_zero(batch, d, device),
    }


def slstm_state_abstract(cfg, batch: int):
    """``slstm_state_init`` on ``meta`` tensors."""
    return slstm_state_init(cfg, batch, device="meta")
