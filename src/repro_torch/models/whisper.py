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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import rope
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed, embed_specs, layer_norm,
                                       layer_norm_specs, mlp2, mlp2_specs,
                                       unembed)
from repro_torch.models.module import p, stack_specs
from repro_torch.sharding import fsdp


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


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _enc_layer(lp, x, ctx, cfg: ModelConfig):
    h = layer_norm(x, lp["ln1"])
    q, k, v = attn.qkv_project(h, lp["attn"])
    kf = attn.repeat_kv(k, cfg.num_heads)
    vf = attn.repeat_kv(v, cfg.num_heads)
    o = attn.attend(q, kf, vf, ctx["pos"], ctx["pos"], causal=False)
    x = x + attn.out_project(o, lp["attn"])
    h = layer_norm(x, lp["ln2"])
    return x + mlp2(h, lp["mlp"])


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *,
           remat_policy: str = "none") -> torch.Tensor:
    """frames: [B, S, D] (the stub frontend's output). Returns the
    encoder states [B, S, D] in the model dtype."""
    dtype = tfm.model_dtype(cfg)
    B, S, D = frames.shape
    x = frames.to(dtype) + rope.sinusoidal_embedding(
        S, D, dtype, device=frames.device)[None]
    pos = torch.arange(S, dtype=torch.int32,
                       device=frames.device)[None].expand(B, S)
    run = tfm._remat(_enc_layer, remat_policy)
    for lp in tfm._unstack(params["encoder"], cfg.encoder_layers):
        x = run(lp, x, {"pos": pos}, cfg)
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


def cross_kv(params, enc_states: torch.Tensor, cfg: ModelConfig):
    """Each decoder layer's cross-attention K/V from the encoder states,
    stacked: {'k', 'v'} [L, B, S_enc, KV, hd] (the decode-time cross
    cache)."""
    w = params["decoder"]["cross_attn"]
    ks, vs = [], []
    project = fsdp.hooked(_cross_kv_layer)
    for lw in tfm._unstack({"wk": w["wk"], "wv": w["wv"]}, cfg.num_layers):
        k, v = project(lw, enc_states)
        ks.append(k)
        vs.append(v)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _cross_kv_layer(lw, enc_states: torch.Tensor):
    return (attn._project(enc_states, lw["wk"]),
            attn._project(enc_states, lw["wv"]))


def _dec_layer(lp, x, ctx, cfg: ModelConfig, cache=None):
    """One decoder layer: causal self-attention (with a cache, the new
    keys written into it first; one query attends against the cache, a
    longer chunk within itself), cross-attention, the MLP."""
    positions = ctx["positions"]
    h = layer_norm(x, lp["ln1"])
    q, k, v = attn.qkv_project(h, lp["self_attn"])
    if cache is not None:
        attn.write_cache(cache, k, v, ctx["cur"], pos_new=positions[0])
    if cache is not None and q.shape[1] == 1:
        o = attn.decode_attend(q, cache, cfg.num_heads, q_pos=positions)
    else:
        o = attn.attend(q, attn.repeat_kv(k, cfg.num_heads),
                        attn.repeat_kv(v, cfg.num_heads), positions,
                        positions, causal=True)
    x = x + attn.out_project(o, lp["self_attn"])
    h = layer_norm(x, lp["ln_x"])
    dt = h.dtype
    qx = attn._project(h, lp["cross_attn"]["wq"])
    kf = attn.repeat_kv(ctx["xk"].to(dt), cfg.num_heads)
    vf = attn.repeat_kv(ctx["xv"].to(dt), cfg.num_heads)
    ox = attn.attend(qx, kf, vf, positions, ctx["enc_pos"], causal=False)
    x = x + attn.out_project(ox, lp["cross_attn"])
    h = layer_norm(x, lp["ln2"])
    return x + mlp2(h, lp["mlp"])


def decode(params, tokens: torch.Tensor, positions: torch.Tensor, xkv,
           cfg: ModelConfig, *, self_caches=None, cur: Optional[int] = None,
           remat_policy: str = "none"):
    """The decoder stack. tokens: [B, T]; positions: [B, T] absolute;
    ``xkv``: the stacked cross K/V (``cross_kv``); ``self_caches``: the
    stacked ring caches ({k, v} [L, B, C, KV, hd], pos [L, C]) or None,
    written in place from absolute position ``cur`` (a Python int).
    ``remat_policy`` applies without caches only, as in the reference.
    Returns (logits [B, T, V], the self caches)."""
    dtype = tfm.model_dtype(cfg)
    B, T = tokens.shape
    x = embed(tokens, params["embed"], dtype)
    x = x + _dec_positions_embed(params, positions, cfg, dtype)
    S_enc = xkv["k"].shape[2]
    enc_pos = torch.arange(S_enc, dtype=torch.int32,
                           device=x.device)[None].expand(B, S_enc)
    run = (fsdp.gathered(_dec_layer) if self_caches is not None
           else tfm._remat(_dec_layer, remat_policy))
    layers = tfm._unstack(params["decoder"], cfg.num_layers)
    for i, lp in enumerate(layers):
        ctx = {"positions": positions, "cur": cur, "enc_pos": enc_pos,
               "xk": xkv["k"][i], "xv": xkv["v"][i]}
        if self_caches is None:
            x = run(lp, x, ctx, cfg)
        else:
            x = run(lp, x, ctx, cfg, tfm._layer(self_caches, i))
    x = layer_norm(x, params["dec_ln"])
    return unembed(x, params["embed"]), self_caches


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
