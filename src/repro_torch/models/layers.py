"""Shared layers (plain functions over ParamSpec-described params), as in
the reference's ``models/layers.py``. Every use casts its float32
parameter to the activation dtype, except norm scales, which apply in
float32."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.module import p
from repro_torch.sharding.tp import Parts, Seq, at


# -- norms -------------------------------------------------------------------

def rms_norm_specs(d: int):
    return {"scale": p((d,), ("embed",), init="ones")}


def rms_norm(x: torch.Tensor, params, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32. ``x`` a ``tp.Seq`` (``train_sp``): each
    member's tokens, with its copy of the scale (``params`` as
    ``tp.Parts``)."""
    if isinstance(x, Seq):
        return x.map(lambda m, t: rms_norm(t, at(params, m), eps))
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layer_norm_specs(d: int):
    return {"scale": p((d,), ("embed",), init="ones"),
            "bias": p((d,), ("embed",), init="zeros")}


def layer_norm(x: torch.Tensor, params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 with the biased variance (``jnp.var``'s ddof
    0, not ``torch.var``'s default correction of 1)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


# -- gated MLP (SwiGLU) -------------------------------------------------------

def mlp_specs(d: int, f: int):
    return {
        "wi": p((d, f), ("embed", "mlp")),
        "wg": p((d, f), ("embed", "mlp")),
        "wo": p((f, d), ("mlp", "embed")),
    }


def mlp(x: torch.Tensor, params, act=F.silu, tp=None) -> torch.Tensor:
    """With ``tp`` and the weights as ``tp.Parts``: the up and gate
    projections split by columns, the down projection by rows, each
    member's product from its columns, summed over the members."""
    if isinstance(params["wi"], Parts):
        return tp.run(x, params["wi"].members,
                      lambda m, xm: mlp(xm, at(params, m), act))
    if isinstance(x, Seq):      # columns that do not split: on the first
        return tp.run(x, [0], lambda m, xm: mlp(xm, params, act))
    h = x @ params["wi"].to(x.dtype)
    g = x @ params["wg"].to(x.dtype)
    return (act(g) * h) @ params["wo"].to(x.dtype)


def mlp2_specs(d: int, f: int):
    """Ungated 2-matrix MLP with biases (whisper's GELU MLP)."""
    return {"wi": p((d, f), ("embed", "mlp")),
            "bi": p((f,), ("mlp",), init="zeros"),
            "wo": p((f, d), ("mlp", "embed")),
            "bo": p((d,), ("embed",), init="zeros")}


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation; F.gelu's is erf
    return F.gelu(x, approximate="tanh")


def mlp2(x: torch.Tensor, params, act=_gelu_tanh, tp=None) -> torch.Tensor:
    """With ``tp`` and the weights as ``tp.Parts``: ``wi`` and ``bi``
    split by columns, ``wo`` by rows, each member's product from its
    columns, summed over the members; ``bo`` added once, after the
    sum."""
    if isinstance(params["wi"], Parts):
        y = tp.run(x, params["wi"].members,
                   lambda m, xm: _mlp2_columns(xm, at(params, m), act))
    else:
        y = _mlp2_columns(x, params, act)
    return y + params["bo"].to(x.dtype)


def _mlp2_columns(x: torch.Tensor, params, act) -> torch.Tensor:
    h = act(x @ params["wi"].to(x.dtype) + params["bi"].to(x.dtype))
    return h @ params["wo"].to(x.dtype)


# -- embedding ----------------------------------------------------------------

def embed_specs(vocab: int, d: int):
    return {"table": p((vocab, d), ("vocab", "embed"), init="embed")}


def embed(tokens: torch.Tensor, params,
          dtype: torch.dtype = torch.bfloat16, tp=None) -> torch.Tensor:
    """The rows of ``tokens``. With ``tp`` and the table as ``tp.Parts``
    (split by vocabulary): each member looks up the tokens in its rows
    (zeros for the others') and the members' rows are summed."""
    table = params["table"]
    if isinstance(table, Parts):
        parts = []
        for m, tok in zip(tp.live(table.members),
                          tp.replicate(tokens, table.members)):
            with tp.part(m):
                n = table[m].shape[0]
                local = tok - table.start(m, 0)
                mine = (local >= 0) & (local < n)
                rows = table[m][local.clamp(0, n - 1)].to(dtype)
                parts.append(torch.where(mine[..., None], rows,
                                         rows.new_zeros(())))
        return tp.all_reduce(parts, table.members)
    # gather, then cast: the cast is element by element, so this equals
    # casting the whole table first, without reading all of it per call
    return table[tokens].to(dtype)


def embed_seq(tokens: torch.Tensor, params, dtype: torch.dtype, tp,
              spans) -> Seq:
    """The rows of ``tokens`` (on the group's first member) as the
    members' token blocks ``spans`` (``train_sp``): each member looks its
    tokens up in its copy of the table (``params['table']`` as
    ``tp.Parts`` of whole regions)."""
    table = params["table"]
    n = range(len(spans))
    return Seq([embed(tok[:, spans[m]], {"table": table[m]}, dtype)
                for m, tok in zip(tp.live(n), tp.replicate(tokens, n))],
               spans)


def unembed(x: torch.Tensor, params) -> torch.Tensor:
    """Logits from hidden states: [.., d] @ [vocab, d]^T."""
    return x @ params["table"].to(x.dtype).t()


def logits_of(x: torch.Tensor, params, tied: bool, tp=None) -> torch.Tensor:
    """The logits of hidden states ``x``: ``unembed`` of ``params['embed']``
    (``tied``) or ``lm_head`` of ``params['head']``. With ``tp`` and the
    table or head as ``tp.Parts`` (split by vocabulary, as serving on a
    mesh holds them): each member projects its vocabulary block and the
    blocks are put together in order on the group's first member."""
    w = params["embed"]["table"] if tied else params["head"]["w"]
    if not isinstance(w, Parts):
        return (unembed(x, params["embed"]) if tied
                else lm_head(x, params["head"]))
    members, regions = vocab_regions(w, tp, tied)
    parts = []
    for m, xm in zip(tp.live(members), tp.broadcast(x, members)):
        with tp.part(m):
            wm = w[m][regions[m]]
            parts.append(unembed(xm, {"table": wm}) if tied
                         else lm_head(xm, {"w": wm}))
    return tp.assemble(parts, members)


def vocab_regions(w: Parts, tp, tied: bool):
    """The members that project the logits' vocabulary blocks and each
    one's region of its part of the table or head ``w``: the whole part
    where the plan gives vocabulary blocks; where it gives every member
    the whole table (``train_sp``, whose loss projects each member's
    tokens over the whole vocabulary), the block of the last position's
    logits at their constraint (``act_vocab``, as the reference's
    prefill)."""
    vdim = 0 if tied else 1
    V = w[w.members[0]].shape[vdim]
    whole = all(w.index[m][vdim] == slice(None) for m in w.members)
    if not whole:
        return w.members, {m: (slice(None),) * 2 for m in w.members}
    blocks = tp.blocks((1, V), ("act_batch", "act_vocab"))
    members = tp.members(blocks)
    regions = {}
    for m in members:
        ix = [slice(None), slice(None)]
        ix[vdim] = blocks[m][1]
        regions[m] = tuple(ix)
    return members, regions


def tp_vocab(tp, vocab: int):
    """Each computing member's vocabulary block at the logits' constraint
    point (``act_vocab``), None where the vocabulary does not split."""
    blocks = tp.blocks((1, 1, vocab), ("act_batch", "act_seq", "act_vocab"))
    members = tp.members(blocks)
    return None if len(members) == 1 else [(m, blocks[m][2])
                                           for m in members]


def tp_columns(tp, f: int):
    """Each computing member's MLP columns at the hidden activation's
    constraint point (``act_mlp``), None where they do not split."""
    blocks = tp.blocks((1, 1, f), ("act_batch", None, "act_mlp"))
    members = tp.members(blocks)
    return None if len(members) == 1 else [(m, blocks[m][2])
                                           for m in members]


def mlp_plan(tp, f: int, gated: bool = True):
    """The MLP's regions at each member, {} where its columns do not
    split: the gated MLP's (``mlp_specs``' shapes), or with ``gated``
    False the ungated ``mlp2``'s (``wi``, ``bi`` and ``wo``; ``bo`` is
    left whole on the first member, which adds it once)."""
    split = tp_columns(tp, f)
    if split is None:
        return {}
    every = slice(None)
    cols_of = ("wi", "wg") if gated else ("wi",)
    out = {k: [None] * tp.n for k in cols_of + ("wo",)}
    if not gated:
        out["bi"] = [None] * tp.n
    for m, cols in split:
        for k in cols_of:
            out[k][m] = (every, cols)
        out["wo"][m] = (cols, every)
        if not gated:
            out["bi"][m] = (cols,)
    return out


def head_specs(d: int, vocab: int):
    return {"w": p((d, vocab), ("embed", "vocab"))}


def lm_head(x: torch.Tensor, params) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


# -- depthwise causal conv1d (plain path; CUDA kernel in kernels/dwconv1d) ----

def dwconv1d_specs(channels: int, k: int):
    return {"w": p((channels, k), ("ssm_inner", "conv")),
            "b": p((channels,), ("ssm_inner",), init="zeros")}


def dwconv1d(x: torch.Tensor, params,
             state: Optional[torch.Tensor] = None):
    """Causal depthwise conv. x: [B, S, C]; state: [B, k-1, C] carry (the
    last k-1 inputs of the stream so far) or None (zero history).

    Returns (y, new_state): the taps accumulated as shifted multiplies, no
    patch materialisation; new_state is the last k-1 rows of [state; x]."""
    w = params["w"].to(x.dtype)                  # [C, k]
    k = w.shape[1]
    B, S, C = x.shape
    if state is None:
        state = x.new_zeros((B, k - 1, C))
    xp = torch.cat([state, x], dim=1)            # [B, S+k-1, C]
    y = torch.zeros_like(x)
    for i in range(k):                           # k is small (4): unrolled
        y = y + xp[:, i:i + S, :] * w[:, i]
    new_state = xp[:, xp.shape[1] - (k - 1):, :]
    return y + params["b"].to(x.dtype), new_state
