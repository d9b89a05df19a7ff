"""Whisper-style encoder-decoder backbone, as in the reference's
``models/whisper.py`` (the conv frontend is a stub).

Encoder: bidirectional self-attention over precomputed frame embeddings
(the conv1d×2 mel frontend is the reference's stub: the inputs are
[B, S_enc, D]) plus sinusoidal positions. Decoder: learned positions (448
native; a longer target interpolates, the reference's documented
deviation), causal self-attention with a ring cache of
``max_target_positions`` slots, cross-attention against the encoder
states.

Cross-attention K/V is computed once per prefill (``cross_kv``) and read
by every decode step. Every attention is the plain ``attend`` /
``decode_attend``, as in the reference: no kernel runs here. The
reference scans over the stacked layers; the port loops over them, each
cache-less layer under the reference's remat policy
(``transformer._remat``).

On a mesh (``tp``, a data-parallel rank's tensor-parallel group,
``sharding/tp.py``) the leaves ``tp_plan`` splits come as ``tp.Parts``,
as the reference's constraint points split them: the heads of the
encoder's attention and of both decoder attentions (q/k/v on
``act_heads``), both stacks' MLP columns (``act_mlp``) and the tied
vocabulary (``act_vocab``). Each member runs its share and the parts are
summed on the first member, where the residual stream, the norms and
the positions stay. The cross K/V of a member are its key/value heads
over every frame. Where the group holds the caches along their sequence
(``attention.KVBlocks``: the 448-slot self ring and the cross cache,
``cache_seq``), a prefill sends each member's keys and values to the
members whose slots or frames they fill (``transformer.Sends``), and a
decode step attends each member's block of the ring and of the frames
and combines the partials (flash-decode, ``tp.TP.combine``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import rope
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed, embed_specs, layer_norm,
                                       layer_norm_specs, logits_of, mlp2,
                                       mlp2_specs, mlp_plan, tp_vocab)
from repro_torch.models.module import p, stack_specs
from repro_torch.sharding import fsdp
from repro_torch.sharding.tp import Parts, at


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _enc_layer_specs(cfg: ModelConfig):
    hd = cfg.resolved_head_dim()
    return {
        "ln1": layer_norm_specs(cfg.d_model),
        "attn": attn.attn_specs(cfg.d_model, cfg.num_heads,
                                cfg.num_kv_heads, hd),
        "ln2": layer_norm_specs(cfg.d_model),
        "mlp": mlp2_specs(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_specs(cfg: ModelConfig):
    hd = cfg.resolved_head_dim()
    return {
        "ln1": layer_norm_specs(cfg.d_model),
        "self_attn": attn.attn_specs(cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, hd),
        "ln_x": layer_norm_specs(cfg.d_model),
        "cross_attn": attn.attn_specs(cfg.d_model, cfg.num_heads,
                                      cfg.num_kv_heads, hd),
        "ln2": layer_norm_specs(cfg.d_model),
        "mlp": mlp2_specs(cfg.d_model, cfg.d_ff),
    }


def model_specs(cfg: ModelConfig):
    return {
        "embed": embed_specs(cfg.vocab_size, cfg.d_model),   # tied unembed
        "dec_pos": p((cfg.max_target_positions, cfg.d_model),
                     (None, "embed"), init="embed"),
        "encoder": stack_specs(_enc_layer_specs(cfg), cfg.encoder_layers),
        "enc_ln": layer_norm_specs(cfg.d_model),
        "decoder": stack_specs(_dec_layer_specs(cfg), cfg.num_layers),
        "dec_ln": layer_norm_specs(cfg.d_model),
    }


def tp_plan(cfg: ModelConfig, tp, seq_len: Optional[int] = None
            ) -> Dict[tuple, list]:
    """The mesh plan for a tensor-parallel group ``tp``, as
    ``transformer.tp_plan``'s: by leaf path of ``model_specs(cfg)``, each
    member's region (None where it does not read the leaf), for the tied
    table by vocabulary, the encoder's attention and the decoder's self-
    and cross-attention by heads (the cross K/V projections by the
    key/value heads a member's query heads read) and both stacks' MLP
    columns (``bo`` whole). Where the group splits the caches' sequence
    (the decode profile; ``seq_len``: the cross cache's frames), each
    member with a block of the 448-slot ring reads the self-attention
    whole, and each with a block of the frames the cross-attention.
    Under ``kv_seq`` each member reads its query heads and their
    out-projection, and the key and value projections whole, for the
    keys of its block of the tokens or frames (``attention.tp_plan``'s
    ``kv_own``). A
    leaf left out is read whole by the first member: the norms, the
    learned positions, and every part whose dim does not divide the
    group (the reference drops that mapping too)."""
    every = slice(None)
    out: Dict[tuple, list] = {}

    def put(path, regions):
        for name, per in regions.items():
            out[path + (name,)] = [None if ix is None else (every,) + ix
                                   for ix in per]

    vocab = tp_vocab(tp, cfg.vocab_size)
    if vocab is not None:
        rows = [None] * tp.n
        for m, vs in vocab:
            rows[m] = (vs, every)
        out[("embed", "table")] = rows
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    ring = None if seq_len is None else cfg.max_target_positions
    own = tp.ctx.profile == "kv_seq"
    put(("encoder", "attn"), attn.tp_plan(tp, H, Kv, False, kv_own=own))
    put(("decoder", "self_attn"), attn.tp_plan(tp, H, Kv, False, ring,
                                               kv_own=own))
    put(("decoder", "cross_attn"), attn.tp_plan(tp, H, Kv, False, seq_len,
                                                kv_own=own))
    for stack in ("encoder", "decoder"):
        put((stack, "mlp"), mlp_plan(tp, cfg.d_ff, gated=False))
    return out


def _at(tp, t: torch.Tensor):
    """``t`` at each member of the group (None without one)."""
    return None if tp is None else tp.replicate(t, range(tp.n))


def _attention(w, h, pos, cfg: ModelConfig, causal: bool, first: int = 0,
               group=None, cache=None, cur=None) -> torch.Tensor:
    """Self-attention of the normed ``h`` at positions ``pos`` [B, S]:
    every head, or (``group``) the query heads from head ``first`` on.
    With a cache (one layer's ring), the new keys are written into it
    first: one query attends against the cache, a longer chunk within
    itself."""
    q, k, v = attn.qkv_project(h, w)
    if cache is not None:
        attn.write_cache(cache, k, v, cur, pos_new=pos[0])
    H = q.shape[2]
    if cache is not None and q.shape[1] == 1:
        o = attn.decode_attend(q, cache, H, q_pos=pos)
    else:
        o = attn.attend(q, attn.repeat_kv(k, H, first, group),
                        attn.repeat_kv(v, H, first, group), pos, pos,
                        causal=causal)
    return attn.out_project(o, w)


def _self_part(w, h, ctx, cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """``_attention`` without a cache: whole, or with the projections as
    ``tp.Parts`` each member's heads, the out-projections summed."""
    if not isinstance(w["wq"], Parts):
        return _attention(w, h, ctx["pos"], cfg, causal)
    if tfm._kv_spans(ctx["tp"], h.shape[1]):     # kv_seq: a block of keys
        return tfm._attention_cp(w, h, cfg, None, 0.0, 0, ctx["tp"],
                                 [(None, p) for p in ctx["at"]],
                                 causal=causal)
    group = cfg.num_heads // cfg.num_kv_heads
    return ctx["tp"].run(h, w["wq"].members, lambda m, hm: _attention(
        at(w, m), hm, ctx["at"][m], cfg, causal, w["wq"].start(m, 1),
        group))


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _enc_layer(lp, x, ctx, cfg: ModelConfig):
    h = layer_norm(x, lp["ln1"])
    x = x + _self_part(lp["attn"], h, ctx, cfg, causal=False)
    h = layer_norm(x, lp["ln2"])
    return x + mlp2(h, lp["mlp"], tp=ctx["tp"])


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *,
           remat_policy: str = "none", tp=None) -> torch.Tensor:
    """frames: [B, S, D] (the stub frontend's output). Returns the
    encoder states [B, S, D] in the model dtype. ``tp``: the group, the
    plan's leaves as ``tp.Parts`` (module note)."""
    dtype = tfm.model_dtype(cfg)
    B, S, D = frames.shape
    x = frames.to(dtype) + rope.sinusoidal_embedding(
        S, D, dtype, device=frames.device)[None]
    pos = torch.arange(S, dtype=torch.int32,
                       device=frames.device)[None].expand(B, S)
    ctx = {"pos": pos, "tp": tp, "at": _at(tp, pos)}
    run = tfm._remat(_enc_layer, remat_policy)
    for lp in tfm._unstack(params["encoder"], cfg.encoder_layers):
        x = run(lp, x, ctx, cfg)
    return layer_norm(x, params["enc_ln"])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _dec_positions_embed(params, positions: torch.Tensor, cfg: ModelConfig,
                         dtype) -> torch.Tensor:
    """Learned positions, linearly interpolated beyond the native P:
    positions below P index the table; where any is at or past P, those
    are scaled by the largest position of the call into [0, P-1] (so a
    one-token decode step past P reads slot P-1)."""
    table = params["dec_pos"].float()                    # [P, D]
    P = table.shape[0]
    pos = positions.float()
    scaled = torch.where(pos < P, pos,
                         (pos / pos.max().clamp_min(1.0)) * (P - 1))
    lo = torch.floor(scaled).long()
    hi = (lo + 1).clamp_max(P - 1)
    frac = (scaled - lo.float())[..., None]
    emb = table[lo] * (1 - frac) + table[hi] * frac
    return emb.to(dtype)


# the stacked leaves a cache-less forward gathers twice a layer on a mesh
# (``sharding/fsdp.py``): the cross K/V weights, by ``cross_kv`` and by
# their decoder layer
READ_TWICE = (("decoder", "cross_attn", "wk"), ("decoder", "cross_attn", "wv"))


def cross_kv(params, enc_states: torch.Tensor, cfg: ModelConfig, tp=None,
             cache: Optional[attn.KVBlocks] = None):
    """Each decoder layer's cross-attention K/V from the encoder states,
    stacked: {'k', 'v'} [L, B, S_enc, KV, hd] (the decode-time cross
    cache). With the K/V projections as ``tp.Parts`` (the heads split):
    each as ``tp.Parts`` of the members' [L, B, S_enc, KV_m, hd], their
    key/value heads over every frame. ``cache`` (a prefill on a mesh):
    the cross cache as the group holds it along its frames, each layer's
    keys and values sent to the members whose frames they fill."""
    w = params["decoder"]["cross_attn"]
    project = fsdp.hooked(_cross_kv_layer)
    at_members: Dict[int, torch.Tensor] = {}
    S = enc_states.shape[1]
    ks, vs = [], []
    for i, lw in enumerate(tfm._unstack({"wk": w["wk"], "wv": w["wv"]},
                                        cfg.num_layers)):
        sends = (None if cache is None
                 else tfm.Sends(cache.layer(i), S, 0, 0, tp))
        k, v = project(lw, enc_states, tp, at_members, sends)
        ks.append(k)
        vs.append(v)
    return {"k": _stacked(ks), "v": _stacked(vs)}


def _stacked(per_layer) -> object:
    """The layers' K (or V) stacked: a tensor, or ``tp.Parts`` of each
    member's stack."""
    first = per_layer[0]
    if not isinstance(first, Parts):
        return torch.stack(per_layer)
    return Parts([None if t is None else torch.stack([p[m]
                                                      for p in per_layer])
                  for m, t in enumerate(first.tensors)],
                 [None if ix is None else (slice(None),) + ix
                  for ix in first.index])


def _cross_kv_layer(lw, enc_states: torch.Tensor, tp=None, at_members=None,
                    sends=None):
    """One layer's cross K/V, whole or (``tp.Parts``) each member's from
    the encoder states at its device (``at_members``, filled at the first
    layer), sent into the cross cache's blocks where ``sends``."""
    wk, wv = lw["wk"], lw["wv"]
    if not isinstance(wk, Parts):
        k, v = attn._project(enc_states, wk), attn._project(enc_states, wv)
        if sends is not None:
            sends(0, k, v, 0)
        return k, v
    members = wk.members
    if not at_members:
        at_members.update(zip(tp.live(members),
                              tp.broadcast(enc_states, members)))
    spans = tfm._kv_spans(tp, enc_states.shape[1])
    if spans is not None:       # kv_seq: each member's block of the frames
        return _cross_kv_blocks(wk, wv, enc_states, tp, at_members, sends,
                                spans)
    ks, vs = [None] * tp.n, [None] * tp.n
    for m in tp.live(members):
        ks[m], vs[m] = tp.apply(m, at_members[m], lambda j, e: (
            attn._project(e, wk[j]), attn._project(e, wv[j])))
        if sends is not None:
            sends(m, ks[m], vs[m], wk.start(m, 1))
    if sends is not None:
        sends.unseen(wk, enc_states.shape[0], wk[members[0]].shape[-1])
    every = slice(None)
    index = [None if ix is None else (every, every, ix[1], every)
             for ix in wk.index]
    return Parts(ks, index), Parts(vs, index)


def _cross_kv_blocks(wk, wv, enc_states, tp, at_members, sends, spans):
    """``kv_seq``: each member's keys and values of its block of the
    frames (every key/value head, ``tp.Parts`` along the frames), sent
    into the cross cache's blocks where ``sends``."""
    ks, vs = [None] * tp.n, [None] * tp.n
    for m in tp.live(range(tp.n)):
        ks[m], vs[m] = tp.apply(m, at_members[m][:, spans[m]],
                                lambda j, e: (attn._project(e, wk[j]),
                                              attn._project(e, wv[j])))
        if sends is not None:
            sends.tokens(m, ks[m], vs[m], spans[m].start)
    if sends is not None:
        sends.tokens_unseen(enc_states.shape[0], wk[0].shape[-1], spans)
    every = slice(None)
    index = [(every, sp, every, every) for sp in spans]
    return Parts(ks, index), Parts(vs, index)


def _cross(w, h, xk, xv, pos, enc_pos, first: int = 0,
           group=None) -> torch.Tensor:
    """Cross-attention of the normed ``h`` against the encoder's keys and
    values ``xk`` / ``xv`` [B, S_enc, KV, hd]: every head, or
    (``group``) the query heads from ``first`` on."""
    dt = h.dtype
    q = attn._project(h, w["wq"])
    H = q.shape[2]
    o = attn.attend(q, attn.repeat_kv(xk.to(dt), H, first, group),
                    attn.repeat_kv(xv.to(dt), H, first, group), pos, enc_pos,
                    causal=False)
    return attn.out_project(o, w)


def _cross_part(w, h, ctx, cfg: ModelConfig) -> torch.Tensor:
    """The cross-attention sub-block: whole; split by heads (the
    projections and the cross K/V as ``tp.Parts``); under ``kv_seq``
    each member's query heads gathered and attended over its block of
    the frames (``transformer.cp_attend``); or, one token a row
    against a cross cache the group holds along its frames
    (``attention.KVBlocks``), each member's partial over its frames,
    combined (``transformer.combined``)."""
    tp, cross = ctx["tp"], ctx["cross"]
    if isinstance(cross, attn.KVBlocks):
        members = cross.members
        if len(members) == 1:          # the frames whole on the first
            b = cross.blocks[0]
            return _cross(w, h, b["k"], b["v"], ctx["pos"], ctx["enc_pos"])
        scale = 1.0 / math.sqrt(cfg.resolved_head_dim())
        parts = []
        for m, hm in zip(tp.live(members), tp.broadcast(h, members)):
            with tp.part(m):
                q = attn._project(hm, at(w, m)["wq"])
                parts.append(attn.decode_partial(q, cross.blocks[m],
                                                 scale=scale, causal=False))
        return tfm.combined(w, parts, members, tp, h.dtype)
    if not isinstance(w["wq"], Parts):
        return _cross(w, h, cross["k"], cross["v"], ctx["pos"],
                      ctx["enc_pos"])
    spans = (tfm._kv_spans(tp, ctx["enc_at"][0].shape[1])
             if ctx.get("enc_at") else None)
    if spans is not None:       # kv_seq: each member's block of the frames
        n = range(tp.n)
        live = tp.live(n)
        return tfm.cp_attend(
            w, tp.broadcast(h, n),
            [(cross["k"][m], cross["v"][m]) for m in live], ctx["at"],
            [e[:, spans[m]] for m, e in zip(live, ctx["enc_at"])], cfg, tp,
            h.dtype, causal=False)
    group = cfg.num_heads // cfg.num_kv_heads
    return tp.run(h, w["wq"].members, lambda m, hm: _cross(
        at(w, m), hm, cross["k"][m], cross["v"][m], ctx["at"][m],
        ctx["enc_at"][m], w["wq"].start(m, 1), group))


def _dec_layer(lp, x, ctx, cfg: ModelConfig, cache=None):
    """One decoder layer: causal self-attention (with a cache, the new
    keys written into it first: one query attends against the cache, a
    longer chunk within itself; with the ring as ``attention.KVBlocks``,
    ``transformer._prefill_on_blocks`` / ``_decode_on_blocks``),
    cross-attention, the MLP."""
    tp = ctx["tp"]
    h = layer_norm(x, lp["ln1"])
    w = lp["self_attn"]
    if isinstance(cache, attn.KVBlocks):
        on_blocks = (tfm._decode_on_blocks if h.shape[1] == 1
                     else tfm._prefill_on_blocks)
        o = on_blocks(w, h, None, ctx["pos"], cfg, 0, cache, ctx["cur"], 0.0,
                      0, tp, [(None, p) for p in ctx["at"]])
    elif cache is not None:
        o = _attention(w, h, ctx["pos"], cfg, True, cache=cache,
                       cur=ctx["cur"])
    else:
        o = _self_part(w, h, ctx, cfg, causal=True)
    x = x + o
    h = layer_norm(x, lp["ln_x"])
    x = x + _cross_part(lp["cross_attn"], h, ctx, cfg)
    h = layer_norm(x, lp["ln2"])
    return x + mlp2(h, lp["mlp"], tp=tp)


def _frames(xkv) -> int:
    """The encoder frames the cross K/V holds."""
    if isinstance(xkv, attn.KVBlocks):
        return xkv.length
    k = xkv["k"]
    if isinstance(k, Parts):        # by heads, or (kv_seq) by frames
        last = k.index[k.members[-1]][2]
        if last.stop is not None:
            return last.stop
        k = k[k.members[0]]
    return k.shape[2]


def decode(params, tokens: torch.Tensor, positions: torch.Tensor, xkv,
           cfg: ModelConfig, *, self_caches=None, cur: Optional[int] = None,
           remat_policy: str = "none", tp=None, logits: bool = True):
    """The decoder stack. tokens: [B, T]; positions: [B, T] absolute;
    ``xkv``: the stacked cross K/V (``cross_kv``; on a mesh, as it
    returns them, or the cross cache as ``attention.KVBlocks``);
    ``self_caches``: the stacked ring caches ({k, v} [L, B, C, KV, hd],
    pos [L, C]; on a mesh ``attention.KVBlocks``) or None, written in
    place from absolute position ``cur`` (a Python int).
    ``remat_policy`` applies without caches only, as in the reference.
    ``tp``: the group (module note). Returns (logits [B, T, V], or the
    final hidden states [B, T, D] with ``logits=False``; the self
    caches)."""
    dtype = tfm.model_dtype(cfg)
    B, T = tokens.shape
    x = embed(tokens, params["embed"], dtype, tp)
    x = x + _dec_positions_embed(params, positions, cfg, dtype)
    S_enc = _frames(xkv)
    enc_pos = torch.arange(S_enc, dtype=torch.int32,
                           device=x.device)[None].expand(B, S_enc)
    heads_split = (not isinstance(xkv, attn.KVBlocks)
                   and isinstance(xkv["k"], Parts))
    ctx = {"pos": positions, "cur": cur, "enc_pos": enc_pos, "tp": tp,
           "at": _at(tp, positions),
           "enc_at": _at(tp, enc_pos) if heads_split else None}
    run = (fsdp.gathered(_dec_layer) if self_caches is not None
           else tfm._remat(_dec_layer, remat_policy))
    L = cfg.num_layers
    cross = ([xkv.layer(i) for i in range(L)]
             if isinstance(xkv, attn.KVBlocks) else tfm._unstack(xkv, L))
    for i, lp in enumerate(tfm._unstack(params["decoder"], L)):
        c = dict(ctx, cross=cross[i])
        if self_caches is None:
            x = run(lp, x, c, cfg)
        else:
            x = run(lp, x, c, cfg, tfm._layer(self_caches, i))
    x = layer_norm(x, params["dec_ln"])
    if not logits:
        return x, self_caches
    return logits_of(x, params, True, tp), self_caches


def self_cache_init(cfg: ModelConfig, batch: int, *, device):
    """Empty decoder self-attention ring caches, one per layer stacked on
    axis 0: ``max_target_positions`` slots each (``device='meta'``: the
    reference's abstract form)."""
    c = attn.init_cache(batch, cfg.max_target_positions, cfg.num_kv_heads,
                        cfg.resolved_head_dim(), tfm.model_dtype(cfg),
                        device=device)
    return tfm._stack(c, cfg.num_layers)


def cross_cache_init(cfg: ModelConfig, batch: int, s_enc: int, *, device):
    """An empty cross cache ({'k', 'v'} [L, B, s_enc, KV, hd] zeros);
    ``xkv_abstract`` is its ``meta`` form."""
    sh = (cfg.num_layers, batch, s_enc, cfg.num_kv_heads,
          cfg.resolved_head_dim())
    dt = tfm.model_dtype(cfg)
    return {"k": torch.zeros(sh, dtype=dt, device=device),
            "v": torch.zeros(sh, dtype=dt, device=device)}


def xkv_abstract(cfg: ModelConfig, batch: int, s_enc: int):
    """The cross cache of ``s_enc`` encoder frames on ``meta`` tensors, as
    the reference's ``xkv_abstract``."""
    return cross_cache_init(cfg, batch, s_enc, device="meta")
