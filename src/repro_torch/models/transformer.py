"""Decoder LM: a stage-partitioned stack of layers, as in the reference's
``models/transformer.py``.

Layers are grouped into *stages* — maximal runs of contiguous layers with
identical (kind, attention window). Each stage's parameters are stacked on
a leading ``layers`` axis; where the reference scans over that axis with
``jax.lax.scan``, the port loops over it. This slice runs the ``dense``
kind (attention + gated MLP) without caches, the attention through the
CUDA ``swattn`` kernel where the reference's kernel gate lets it
(``cfg.use_pallas_attn``: no cache, no sinks, no softcap, an int window).
The other kinds (moe, hymba, mamba, mlstm, slstm) and the caches wait for
later slices; ``make_stages`` already partitions every family.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.swattn import swattn_cuda
from repro_torch.models import attention as attn
from repro_torch.models import rope
from repro_torch.models.layers import (embed, embed_specs, head_specs,
                                       lm_head, mlp, mlp_specs, rms_norm,
                                       rms_norm_specs, unembed)
from repro_torch.models.module import p, stack_specs

NOT_PORTED = ("moe", "hymba", "mamba", "mlstm", "slstm")


# ---------------------------------------------------------------------------
# Stage partition
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage:
    kind: str                 # dense | moe | hymba | mamba | mlstm | slstm
    start: int                # first layer index
    count: int
    window: int               # 0 = full attention (attn kinds only)


def layer_kind(cfg: ModelConfig, l: int) -> str:
    if cfg.family == "moe":
        return "moe"
    if cfg.family == "hybrid":
        return "hymba"
    if cfg.family == "ssm":   # xlstm
        if cfg.slstm_every and (l % cfg.slstm_every == cfg.slstm_every - 1):
            return "slstm"
        return "mlstm"
    return "dense"


def layer_window(cfg: ModelConfig, l: int) -> int:
    """Effective attention window of layer l (0 = full)."""
    if cfg.family == "ssm":
        return 0
    if cfg.attn_window <= 0:
        return 0
    if cfg.global_every and (l % cfg.global_every == cfg.global_every - 1):
        return 0                                  # periodic global layer
    if cfg.family == "hybrid" and l in (0, cfg.num_layers // 2,
                                        cfg.num_layers - 1):
        return 0                      # hymba: global at first/middle/last
    return cfg.attn_window


def make_stages(cfg: ModelConfig) -> List[Stage]:
    if cfg.stage_override:
        out, start = [], 0
        for kind, win, count in cfg.stage_override:
            out.append(Stage(kind, start, count, win))
            start += count
        return out
    stages: List[Stage] = []
    for l in range(cfg.num_layers):
        kind, win = layer_kind(cfg, l), layer_window(cfg, l)
        if stages and stages[-1].kind == kind and stages[-1].window == win:
            s = stages[-1]
            stages[-1] = Stage(kind, s.start, s.count + 1, win)
        else:
            stages.append(Stage(kind, l, 1, win))
    return stages


# ---------------------------------------------------------------------------
# Per-layer specs
# ---------------------------------------------------------------------------


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"layer kind {kind!r} is not ported yet (ROADMAP queue 1); the port "
        "runs 'dense'")


def layer_specs(cfg: ModelConfig, kind: str):
    if kind == "dense":
        return {
            "ln1": rms_norm_specs(cfg.d_model),
            "attn": attn.attn_specs(cfg.d_model, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.resolved_head_dim(),
                                    cfg.use_qk_norm),
            "ln2": rms_norm_specs(cfg.d_model),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
        }
    if kind in NOT_PORTED:
        raise _not_ported(kind)
    raise ValueError(kind)


def model_specs(cfg: ModelConfig):
    specs: Dict[str, Any] = {"embed": embed_specs(cfg.vocab_size, cfg.d_model)}
    for i, st in enumerate(make_stages(cfg)):
        specs[f"stage_{i}"] = stack_specs(layer_specs(cfg, st.kind), st.count)
    specs["final_norm"] = rms_norm_specs(cfg.d_model)
    if not cfg.tie_embeddings:
        specs["head"] = head_specs(cfg.d_model, cfg.vocab_size)
    if cfg.num_meta_tokens:
        specs["meta_tokens"] = p((cfg.num_meta_tokens, cfg.d_model),
                                 (None, "embed"), init="embed")
    return specs


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _attention_part(lp, x, cos_sin, q_pos, cfg: ModelConfig, window,
                    softcap: float = 0.0, sinks: int = 0) -> torch.Tensor:
    """The shared attention sub-block, without a cache."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(h, lp["attn"], cfg.use_qk_norm)
    cos, sin = cos_sin
    q = rope.apply_rope(q, cos, sin)
    k = rope.apply_rope(k, cos, sin)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim())
    use_kernel = (cfg.use_pallas_attn and sinks == 0 and softcap == 0.0
                  and isinstance(window, int))
    if use_kernel:
        # the banded CUDA kernel: the online-softmax state stays on chip,
        # no S×S score plane in device memory, k/v read per GQA group
        o = swattn_cuda(q, k, v, window=window, scale=scale)
    else:
        kf = attn.repeat_kv(k, cfg.num_heads)
        vf = attn.repeat_kv(v, cfg.num_heads)
        o = attn.attend(q, kf, vf, q_pos, q_pos, causal=True, window=window,
                        softcap=softcap, scale=scale, sinks=sinks,
                        q_chunk=cfg.q_chunk)
    return attn.out_project(o, lp["attn"])


def dense_block(lp, x, ctx, cfg: ModelConfig) -> torch.Tensor:
    """Attention + gated MLP, pre-norm residual."""
    a = _attention_part(lp, x, ctx["cos_sin"], ctx["q_pos"], cfg,
                        ctx["window"], cfg.attn_logit_softcap, ctx["sinks"])
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"])


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _positions_cos_sin(cfg: ModelConfig, positions: torch.Tensor):
    if cfg.mrope_sections:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")
    return rope.rope_cos_sin(positions, cfg.resolved_head_dim(),
                             cfg.rope_theta)


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def forward(params, inputs: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig, *, logits: bool = True) -> torch.Tensor:
    """Run the decoder stack, without caches.

    inputs: [B,S] int tokens, or [B,S,D] embeddings (embeddings_in archs).
    positions: [B,S] absolute positions. Returns the logits [B,S,V] (the
    final hidden states [B,S,D] with ``logits=False``).
    """
    dtype = model_dtype(cfg)
    if inputs.ndim == 2:
        x = embed(inputs, params["embed"], dtype)
    else:
        x = inputs.to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    cos_sin = _positions_cos_sin(cfg, positions)
    for i, st in enumerate(make_stages(cfg)):
        if st.kind != "dense":
            raise _not_ported(st.kind)
        sp = params[f"stage_{i}"]
        ctx = {"cos_sin": cos_sin, "q_pos": positions, "window": st.window,
               "sinks": cfg.num_meta_tokens}
        for layer in range(st.count):
            lp = _layer(sp, layer)
            x = dense_block(lp, x, ctx, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not logits:
        return x
    if cfg.tie_embeddings:
        return unembed(x, params["embed"])
    return lm_head(x, params["head"])


def _layer(tree, i: int):
    """Layer ``i`` of a stage's stacked params (a view, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]
