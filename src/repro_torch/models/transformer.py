"""Decoder LM: a stage-partitioned stack of layers, as in the reference's
``models/transformer.py``.

Layers are grouped into *stages* — maximal runs of contiguous layers with
identical (kind, attention window). Each stage's parameters are stacked on
a leading ``layers`` axis; where the reference scans over that axis with
``jax.lax.scan``, the port loops over it, the stack unbound once per
stage (so backward stacks the layers' gradients once), each cache-less
layer under the reference's remat policy (``_remat``: plain
``torch.utils.checkpoint`` for ``jax.checkpoint``, selective checkpointing
for its dots policies). Each stage owns a cache of the
length its window needs (a local stage's ring holds only the live window).
The port runs every kind of the reference, with or without caches: the
``dense`` kind (attention + gated MLP), the ``moe`` kind (attention + the
MoE block, whose Switch aux loss ``forward`` sums over layers), the
``hymba`` kind (attention ∥ mamba, then the MLP), and the recurrent kinds
with no attention: ``mamba`` (a pre-norm mamba block), ``mlstm`` and
``slstm`` (xLSTM's blocks); and M-RoPE on text positions (qwen2-vl).

The kernel gate (``cfg.use_pallas_attn``: no sinks, no softcap, an int
window) sends attention through the CUDA ``swattn`` kernel. The
reference's gate also requires no cache, so its prefill runs plain
``attend``; here the gate admits a prefill chunk too (more than one query
with a cache), because a chunk's positions are cur + arange(S), whose
banded causal attention within the chunk is what ``swattn`` computes.
That is a difference of dispatch, not of result. Decode never runs it,
and neither does training: the kernel has no backward and refuses a
gradient, as the reference's does.

The caches are written in place: ``forward`` stores each layer's new keys
and state into its slice of the stage's stacked tensors and returns the
same tree (the reference returns a new tree; a copy here would rewrite
the whole cache on every decode step). A recurrent layer's state (the
conv's last inputs, the ssm carry, xLSTM's memory tuples) is computed
whole and copied into its slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.swattn import swattn_cuda
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rope
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (embed, embed_specs, head_specs,
                                       lm_head, mlp, mlp_specs, rms_norm,
                                       rms_norm_specs, unembed)
from repro_torch.models.module import p, stack_specs

# the reference's layer kinds the port does not run yet: none
NOT_PORTED: tuple = ()

# ---------------------------------------------------------------------------
# Stage partition
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage:
    kind: str                 # dense | moe | hymba | mamba | mlstm | slstm
    start: int                # first layer index
    count: int
    window: int               # 0 = full attention (attn kinds only)

    def cache_len(self, seq_len: int) -> int:
        if self.window > 0:
            return min(self.window, seq_len)
        return seq_len


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


def layer_specs(cfg: ModelConfig, kind: str):
    if kind not in BLOCKS:
        raise ValueError(kind)
    if kind == "mamba":
        return {"ln1": rms_norm_specs(cfg.d_model),
                "mamba": ssm_mod.mamba_specs(
                    cfg.d_model, expand=cfg.ssm_expand,
                    heads=cfg.mamba_heads or 8, state=cfg.ssm_state,
                    conv_width=cfg.ssm_conv_width)}
    if kind == "mlstm":
        return {"ln1": rms_norm_specs(cfg.d_model),
                "mlstm": xlstm_mod.mlstm_specs(
                    cfg.d_model, heads=cfg.num_heads,
                    conv_width=cfg.ssm_conv_width)}
    if kind == "slstm":
        return {"ln1": rms_norm_specs(cfg.d_model),
                "slstm": xlstm_mod.slstm_specs(
                    cfg.d_model, heads=cfg.num_heads,
                    conv_width=cfg.ssm_conv_width)}
    specs = {
        "ln1": rms_norm_specs(cfg.d_model),
        "attn": attn.attn_specs(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                cfg.resolved_head_dim(), cfg.use_qk_norm),
        "ln2": rms_norm_specs(cfg.d_model),
    }
    if kind == "moe":
        # the flag changes only the logical axis names (expert-TP or EP)
        expert_tp = cfg.num_experts < 16 and not cfg.moe_force_ep
        specs["moe"] = moe_mod.moe_specs(cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                                         cfg.num_experts, expert_tp)
        return specs
    if kind == "hymba":
        specs["mamba"] = ssm_mod.mamba_specs(
            cfg.d_model, expand=cfg.ssm_expand, heads=cfg.mamba_heads,
            state=cfg.ssm_state, conv_width=cfg.ssm_conv_width)
    specs["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff)
    return specs


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
# Cache / state trees
# ---------------------------------------------------------------------------


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.kv_cache_dtype == "int8":
        return torch.int8
    return model_dtype(cfg)


def stage_cache_init(cfg: ModelConfig, st: Stage, batch: int, seq_len: int,
                     *, device):
    """A stage's streaming state, each leaf stacked over the stage's
    layers on axis 0: the KV cache (``dense``, ``moe``), ``{'attn': KV
    cache, 'mamba': conv and ssm state}`` (``hymba``), the mamba state
    (``mamba``), or ``{'conv', 'mlstm': (C, n, m)}`` / ``{'conv', 'slstm':
    (c, n, h, m)}`` (``mlstm`` / ``slstm``)."""
    if st.kind not in BLOCKS:
        raise ValueError(st.kind)
    recurrent = {"mamba": ssm_mod.mamba_state_init,
                 "mlstm": xlstm_mod.mlstm_state_init,
                 "slstm": xlstm_mod.slstm_state_init}.get(st.kind)
    if recurrent is not None:
        return _stack(recurrent(cfg, batch, device=device), st.count)
    cl = st.cache_len(seq_len)
    if st.window > 0 and cfg.num_meta_tokens:
        # reserved sink slots: meta tokens never evicted by the ring
        cl = min(cl + cfg.num_meta_tokens, seq_len)
    tree = attn.init_cache(batch, cl, cfg.num_kv_heads,
                           cfg.resolved_head_dim(), cache_dtype(cfg),
                           device=device)
    if st.kind == "hymba":
        tree = {"attn": tree,
                "mamba": ssm_mod.mamba_state_init(cfg, batch,
                                                  device=device)}
    return _stack(tree, st.count)


def cache_init(cfg: ModelConfig, batch: int, seq_len: int, *, device):
    """One stacked cache tree per stage (``seq_len`` counts meta tokens)."""
    return [stage_cache_init(cfg, st, batch, seq_len, device=device)
            for st in make_stages(cfg)]


def _stack(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_stack(v, n) for v in tree)
    return tree[None].repeat((n,) + (1,) * tree.ndim)


def _store(cache, state) -> None:
    """Copy a layer's new streaming ``state`` into its cache slice (a
    matching tree of views; nothing to do without a cache)."""
    if cache is None:
        return
    if isinstance(cache, dict):
        for k, v in cache.items():
            _store(v, state[k])
    elif isinstance(cache, tuple):
        for c, s_ in zip(cache, state, strict=True):
            _store(c, s_)
    else:
        cache.copy_(state)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _attention_part(lp, x, cos_sin, q_pos, cfg: ModelConfig, window,
                    cache=None, cur=None, softcap: float = 0.0,
                    sinks: int = 0) -> torch.Tensor:
    """The shared attention sub-block. With a cache (one layer's slice),
    the new keys and values are written into it first: decode (one query)
    attends against the cache, a prefill chunk within itself."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = attn.qkv_project(h, lp["attn"], cfg.use_qk_norm)
    cos, sin = cos_sin
    q = rope.apply_rope(q, cos, sin)
    k = rope.apply_rope(k, cos, sin)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim())
    decode = cache is not None and q.shape[1] == 1
    if cache is not None:
        attn.write_cache(cache, k, v, cur, pos_new=q_pos[0], sinks=sinks)
    use_kernel = (cfg.use_pallas_attn and not decode and sinks == 0
                  and softcap == 0.0 and isinstance(window, int))
    if decode:
        o = attn.decode_attend(q, cache, cfg.num_heads, window=window,
                               softcap=softcap, scale=scale, q_pos=q_pos,
                               sinks=sinks)
    elif use_kernel:
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


# Every block returns (x', aux): its auxiliary loss (a float32 0-d tensor
# for moe, 0.0 for the kinds that have none), which ``forward`` sums.


def dense_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """Attention + gated MLP, pre-norm residual."""
    x = x + _attention_part(lp, x, ctx["cos_sin"], ctx["q_pos"], cfg,
                            ctx["window"], cache, ctx["cur"],
                            cfg.attn_logit_softcap, ctx["sinks"])
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"]), 0.0


def moe_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """Attention + the MoE block, pre-norm residual. A decode step (one
    query per row) routes the whole batch as one group ([1, B, D]), as
    the reference does; otherwise each row is its own group."""
    x = x + _attention_part(lp, x, ctx["cos_sin"], ctx["q_pos"], cfg,
                            ctx["window"], cache, ctx["cur"],
                            cfg.attn_logit_softcap, ctx["sinks"])
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    B, S, D = h.shape
    if S == 1:
        h = h.reshape(1, B, D)
    y, aux = moe_mod.moe_block(h, lp["moe"], num_experts=cfg.num_experts,
                               k=cfg.num_experts_per_tok,
                               capacity_factor=cfg.capacity_factor)
    return x + y.reshape(B, S, D), aux


def hymba_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """Attention ∥ mamba on the same normed input (the mean of the two
    paths), then the gated MLP. The mamba state streams through
    ``cache['mamba']``, updated in place."""
    a = _attention_part(lp, x, ctx["cos_sin"], ctx["q_pos"], cfg,
                        ctx["window"], None if cache is None
                        else cache["attn"], ctx["cur"], 0.0, ctx["sinks"])
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    cm = None if cache is None else cache["mamba"]
    m, state = ssm_mod.mamba_block(h, lp["mamba"], cfg, state_in=cm)
    _store(cm, state)
    x = x + 0.5 * (a + m)
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h2, lp["mlp"]), 0.0


def mamba_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """A pre-norm mamba block (the plain conv, as in the reference); its
    state streams through ``cache``, updated in place."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, state = ssm_mod.mamba_block(h, lp["mamba"], cfg, state_in=cache)
    _store(cache, state)
    return x + y, 0.0


def mlstm_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """A pre-norm mLSTM block; conv state and memory stream through
    ``cache``, updated in place."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, state = xlstm_mod.mlstm_block(h, lp["mlstm"], cfg, state_in=cache)
    _store(cache, state)
    return x + y, 0.0


def slstm_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """A pre-norm sLSTM block; conv state and (c, n, h, m) stream through
    ``cache``, updated in place."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    y, state = xlstm_mod.slstm_block(h, lp["slstm"], cfg, state_in=cache)
    _store(cache, state)
    return x + y, 0.0


BLOCKS = {"dense": dense_block, "moe": moe_block, "hymba": hymba_block,
          "mamba": mamba_block, "mlstm": mlstm_block, "slstm": slstm_block}


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _positions_cos_sin(cfg: ModelConfig, positions: torch.Tensor):
    hd = cfg.resolved_head_dim()
    if cfg.mrope_sections:
        # text positions: three equal (t, h, w) streams
        return rope.mrope_cos_sin(rope.text_mrope_positions(positions), hd,
                                  cfg.rope_theta, cfg.mrope_sections)
    return rope.rope_cos_sin(positions, hd, cfg.rope_theta)


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def forward(params, inputs: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig, *, caches=None, cur: Optional[int] = None,
            remat_policy: str = "none", logits: bool = True):
    """Run the decoder stack.

    inputs: [B,S] int tokens, or [B,S,D] embeddings (embeddings_in archs).
    positions: [B,S] absolute positions. caches: one tree per stage (from
    ``cache_init``) or None; cur: the absolute position of the chunk's
    first token (prefill 0, decode the position), a Python int, so the
    slots are worked out on the host with no device sync.
    ``remat_policy`` (cache-less only, as in the reference): what backward
    recomputes of each layer (:func:`_remat`). Returns (logits [B,S,V],
    or the final hidden states [B,S,D] with ``logits=False``; the caches,
    written in place, or None; the aux loss summed over layers, a float32
    0-d tensor, 0 where no layer has one).
    """
    dtype = model_dtype(cfg)
    if inputs.ndim == 2:
        x = embed(inputs, params["embed"], dtype)
    else:
        x = inputs.to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    cos_sin = _positions_cos_sin(cfg, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, st in enumerate(make_stages(cfg)):
        block = BLOCKS[st.kind]
        sp = params[f"stage_{i}"]
        ctx = {"cos_sin": cos_sin, "q_pos": positions, "window": st.window,
               "cur": cur, "sinks": cfg.num_meta_tokens}
        # one unbind per stage: backward stacks the layers' gradients once
        # (indexing each layer would add a zero-filled stack per layer)
        layer_params = _unstack(sp, st.count)
        if caches is None:
            run = _remat(block, remat_policy)
            for lp in layer_params:
                x, aux = run(lp, x, ctx, cfg)
                aux_total = aux_total + aux
        else:
            for layer, lp in enumerate(layer_params):
                x, aux = block(lp, x, ctx, cfg, _layer(caches[i], layer))
                aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits:
        x = (unembed(x, params["embed"]) if cfg.tie_embeddings
             else lm_head(x, params["head"]))
    return x, caches, aux_total


def hidden_forward(params, inputs, positions, cfg, **kw):
    return forward(params, inputs, positions, cfg, logits=False, **kw)


def _layer(tree, i: int):
    """Layer ``i`` of a stage's stacked cache (views, no copy: writes to
    a cache's layer land in the stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layer(v, i) for v in tree)
    return tree[i]


def _unstack(tree, n: int) -> List[Dict[str, Any]]:
    """A stage's stacked params as ``n`` per-layer trees, one
    ``torch.unbind`` per leaf."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


# what each policy saves of a layer for backward; the rest is recomputed
_SAVED_OPS = {"dots": ("mm", "bmm", "addmm"),
              "dots_with_no_batch": ("mm", "addmm")}


def _remat(block, policy: str):
    """``block`` with the reference's rematerialisation policy:
    ``'none'`` saves what autograd saves; ``'full'`` saves only the
    layer's input and recomputes the layer in backward (the reference's
    ``jax.checkpoint``); ``'dots'`` saves the outputs of the matrix
    products (``aten.mm``, ``bmm``, ``addmm``) and recomputes the rest,
    ``'dots_with_no_batch'`` those of ``mm`` and ``addmm`` only (its
    ``checkpoint_dots`` and ``checkpoint_dots_with_no_batch_dims``).
    The block's (x', aux) pass through the checkpoint as they are, so a
    moe layer's aux loss keeps its gradient. The blocks draw no random
    numbers, so no RNG state is kept."""
    if policy == "none":
        return block
    if policy == "full":
        context_fn = noop_context_fn
    elif policy in _SAVED_OPS:
        saved = tuple(getattr(torch.ops.aten, op).default
                      for op in _SAVED_OPS[policy])

        def keep(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        def context_fn():
            return create_selective_checkpoint_contexts(keep)
    else:
        raise ValueError(policy)

    def run(lp, x, ctx, cfg):
        return checkpoint(block, lp, x, ctx, cfg, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)
    return run
