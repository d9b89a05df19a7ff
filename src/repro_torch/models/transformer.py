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
whole and copied into its slice; on a mesh each member writes its own
block of a conv state and its heads or channels of the others.
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
from repro_torch.models.layers import (embed, embed_seq, embed_specs,
                                       head_specs, logits_of, mlp, mlp_plan,
                                       mlp_specs, rms_norm, rms_norm_specs,
                                       tp_vocab)
from repro_torch.models.module import p, stack_specs, tree_paths
from repro_torch.sharding import fsdp
from repro_torch.sharding.tp import Parts, Seq, at

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
        specs["moe"] = moe_mod.moe_specs(cfg.d_model, cfg.moe_d_ff or cfg.d_ff,
                                         cfg.num_experts, expert_tp(cfg))
        return specs
    if kind == "hymba":
        specs["mamba"] = ssm_mod.mamba_specs(
            cfg.d_model, expand=cfg.ssm_expand, heads=cfg.mamba_heads,
            state=cfg.ssm_state, conv_width=cfg.ssm_conv_width)
    specs["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff)
    return specs


def expert_tp(cfg: ModelConfig) -> bool:
    """Whether the experts' weights take expert-TP's logical axes (each
    expert's columns on 'model') or EP's (the experts on their own axis);
    the flag changes only the axis names."""
    return cfg.num_experts < 16 and not cfg.moe_force_ep


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


def tp_plan(cfg: ModelConfig, tp, seq_len: Optional[int] = None
            ) -> Dict[tuple, list]:
    """The mesh plan for a tensor-parallel group ``tp``: by leaf path of
    ``model_specs(cfg)``, each member's region of the leaf (None where
    the member does not read it), for the leaves whose blocks split at
    the reference's constraint points: the vocabulary (embedding table,
    head), in each attention-bearing layer the heads, the MLP's columns
    and the experts, and in each recurrent layer its inner dim
    (``act_ssm``): the channels of hymba's mamba part and of the
    ``mamba`` kind (``ssm.tp_plan``), the mLSTM's channels and heads
    (``xlstm.mlstm_plan``), the sLSTM's heads and its FFN's columns
    (``xlstm.slstm_plan``). ``seq_len``: the sequence's tokens, meta
    tokens included (the caches' under the decode profile). Where the
    group splits the KV cache's sequence instead of the heads (the
    decode profile), every member with a block of a stage's cache reads
    that stage's attention projections whole. Where it splits the
    residual stream's sequence (``train_sp``) or the keys' (``kv_seq``),
    each member projects the keys and values of its own tokens and
    reads the key and value projections whole, its query heads and
    their out-projection as under ``train`` (the heads' weight rule);
    under ``train_sp`` every member also reads the norms, the embedding
    table and the head whole. A leaf left out is read whole by the
    group's first member: the norms, hymba's meta tokens, the sLSTM's
    conv and norm, and every part whose dim does not divide the group
    (the reference drops that mapping too)."""
    every = slice(None)
    out: Dict[tuple, list] = {}

    def put(path, regions, stacked=False):
        for name, per in regions.items():
            name = name if isinstance(name, tuple) else (name,)
            out[path + name] = [None if ix is None else
                                ((every,) + ix if stacked else ix)
                                for ix in per]

    decode = seq_len if tp.ctx.profile == "decode" else None
    sp = seq_len is not None and tp.seq_spans(seq_len) is not None
    if sp:
        # the residual stream on the members' tokens: every member reads
        # the norms, and the table and head whole (the loss projects a
        # member's tokens over the whole vocabulary)
        for path, spec in tree_paths(model_specs(cfg)).items():
            if path[-2:-1] in (("ln1",), ("ln2",), ("final_norm",)) or \
                    path[0] in ("embed", "head"):
                out[path] = [(every,) * len(spec.shape)] * tp.n
    vocab = None if sp else tp_vocab(tp, cfg.vocab_size)
    if vocab is not None:
        rows = [None] * tp.n
        cols = [None] * tp.n
        for m, vs in vocab:
            rows[m], cols[m] = (vs, every), (every, vs)
        out[("embed", "table")] = rows
        if not cfg.tie_embeddings:
            out[("head", "w")] = cols
    for i, st in enumerate(make_stages(cfg)):
        key = (f"stage_{i}",)
        if st.kind in ("hymba", "mamba"):
            put(key + ("mamba",), ssm_mod.tp_plan(tp, cfg), True)
        if st.kind == "mlstm":
            put(key + ("mlstm",), xlstm_mod.mlstm_plan(tp, cfg), True)
        if st.kind == "slstm":
            put(key + ("slstm",), xlstm_mod.slstm_plan(tp, cfg), True)
        if st.kind not in ("dense", "moe", "hymba"):
            continue
        put(key + ("attn",), attn.tp_plan(
            tp, cfg.num_heads, cfg.num_kv_heads, cfg.use_qk_norm,
            None if decode is None else stage_cache_len(cfg, st, decode),
            kv_own=sp or _kv_spans(tp, seq_len or 0) is not None), True)
        if st.kind == "moe":
            put(key + ("moe",), moe_mod.tp_plan(
                tp, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff,
                expert_tp(cfg)), True)
        else:
            put(key + ("mlp",), mlp_plan(tp, cfg.d_ff), True)
    return out


# ---------------------------------------------------------------------------
# Cache / state trees
# ---------------------------------------------------------------------------


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.kv_cache_dtype == "int8":
        return torch.int8
    return model_dtype(cfg)


def stage_cache_len(cfg: ModelConfig, st: Stage, seq_len: int) -> int:
    """The slots of an attention stage's KV cache for ``seq_len`` tokens
    (meta tokens included): the window's, and hymba's reserved sink slots
    beside a window's ring (meta tokens never evicted by it)."""
    cl = st.cache_len(seq_len)
    if st.window > 0 and cfg.num_meta_tokens:
        cl = min(cl + cfg.num_meta_tokens, seq_len)
    return cl


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
    cl = stage_cache_len(cfg, st, seq_len)
    tree = attn.init_cache(batch, cl, cfg.num_kv_heads,
                           cfg.resolved_head_dim(), cache_dtype(cfg),
                           device=device)
    if st.kind == "hymba":
        tree = {"attn": tree,
                "mamba": ssm_mod.mamba_state_init(cfg, batch,
                                                  device=device)}
    return _stack(tree, st.count)


def cache_init(cfg: ModelConfig, batch: int, seq_len: int, *, device):
    """One stacked cache tree per stage (``seq_len`` counts meta tokens).
    ``device='meta'`` gives the reference's abstract caches (shapes and
    dtypes, no storage)."""
    return [stage_cache_init(cfg, st, batch, seq_len, device=device)
            for st in make_stages(cfg)]


def cache_logical_axes(cfg: ModelConfig):
    """Logical-axis trees matching ``cache_init`` (for decode
    shardings), as the reference's."""
    out = []
    for st in make_stages(cfg):
        kv = {"k": (None, "act_batch", "cache_seq", None, None),
              "v": (None, "act_batch", "cache_seq", None, None),
              "pos": (None, "cache_seq")}
        if cfg.kv_cache_dtype == "int8":
            kv["k_scale"] = (None, "act_batch", "cache_seq", None)
            kv["v_scale"] = (None, "act_batch", "cache_seq", None)
        mamba = {"conv": (None, "act_batch", None, "act_ssm"),
                 "ssm": (None, "act_batch", None, None, None)}
        if st.kind in ("dense", "moe"):
            out.append(kv)
        elif st.kind == "hymba":
            out.append({"attn": kv, "mamba": mamba})
        elif st.kind == "mamba":
            out.append(mamba)
        elif st.kind == "mlstm":
            out.append({"conv": (None, "act_batch", None, "act_ssm"),
                        "mlstm": ((None, "act_batch", None, None, None),
                                  (None, "act_batch", None, None),
                                  (None, "act_batch", None))})
        elif st.kind == "slstm":
            out.append({"conv": (None, "act_batch", None, None),
                        "slstm": tuple((None, "act_batch", None)
                                       for _ in range(4))})
    return out


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
    elif isinstance(cache, Parts):      # each member's block, its own
        for m in state.members:
            cache[m].copy_(state[m])
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
                    sinks: int = 0, tp=None, pos=None) -> torch.Tensor:
    """The shared attention sub-block. With a cache (one layer's slice),
    the new keys and values are written into it first: decode (one query)
    attends against the cache, a prefill chunk within itself. With
    ``tp`` and the projections as ``tp.Parts`` (the heads split): each
    member attends with its heads (``pos[m]``: the positions' cos, sin
    and positions at member m) and the members' out-projections, a
    row-split product, are summed."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    w = lp["attn"]
    if isinstance(cache, attn.KVBlocks):
        if h.shape[1] == 1:
            return _decode_on_blocks(w, h, cos_sin, q_pos, cfg, window, cache,
                                     cur, softcap, sinks, tp, pos)
        return _prefill_on_blocks(w, h, cos_sin, q_pos, cfg, window, cache,
                                  cur, softcap, sinks, tp, pos)
    if isinstance(h, Seq):
        return _attention_sp(w, h, cfg, window, softcap, sinks, tp, pos)
    if isinstance(w["wq"], Parts) and _kv_spans(tp, h.shape[1]):
        return _attention_cp(w, h, cfg, window, softcap, sinks, tp, pos)
    if isinstance(w["wq"], Parts):
        if cache is not None:
            raise ValueError("split attention writes a cache only as the "
                             "mesh holds it (attention.KVBlocks)")
        group = cfg.num_heads // cfg.num_kv_heads
        return tp.run(h, w["wq"].members, lambda m, hm: _attention(
            at(w, m), hm, pos[m][0], pos[m][1], cfg, window, softcap=softcap,
            sinks=sinks, first=w["wq"].start(m, 1), group=group))
    return _attention(w, h, cos_sin, q_pos, cfg, window, cache, cur,
                      softcap, sinks)


def _prefill_on_blocks(w, h, cos_sin, q_pos, cfg: ModelConfig, window,
                       cache: "attn.KVBlocks", cur, softcap, sinks, tp, pos):
    """A prefill chunk on a mesh whose group holds the cache along its
    sequence: attention as without a cache (the heads split over the
    members where the projections come as ``tp.Parts``, else whole on the
    first member), each member's keys and values of the key/value heads
    it is the first to compute sent to every member whose slots they
    fill (``tp.exchange``), and every block's positions written."""
    sends = Sends(cache, h.shape[1], cur, sinks, tp,
                  {j: pos[j][1][0] for j in cache.blocks})
    if isinstance(h, Seq) or (isinstance(w["wq"], Parts)
                              and _kv_spans(tp, h.shape[1])):
        run = _attention_sp if isinstance(h, Seq) else _attention_cp
        out = run(w, h, cfg, window, softcap, sinks, tp, pos,
                  kv_out=sends.tokens)
        sends.tokens_unseen(h.shape[0], cfg.resolved_head_dim(),
                            _kv_spans(tp, h.shape[1]) or h.spans)
        return out
    if isinstance(w["wq"], Parts):
        group = cfg.num_heads // cfg.num_kv_heads
        wk = w["wk"]
        out = tp.run(h, w["wq"].members, lambda m, hm: _attention(
            at(w, m), hm, pos[m][0], pos[m][1], cfg, window, softcap=softcap,
            sinks=sinks, first=w["wq"].start(m, 1), group=group,
            kv_out=lambda k, v: sends(m, k, v, wk.start(m, 1))))
        sends.unseen(wk, h.shape[0], cfg.resolved_head_dim())
        return out
    return _attention(w, h, cos_sin, q_pos, cfg, window, softcap=softcap,
                      sinks=sinks, kv_out=lambda k, v: sends(0, k, v, 0))


class Sends:
    """A chunk of ``S`` tokens from position ``cur`` written into a KV
    cache a tensor-parallel group holds along its sequence
    (``attention.KVBlocks``): the new positions into every block's 'pos'
    (``pos``: the positions [S] at each member with a block; a cache of
    'k' and 'v' alone takes none), and each member's keys and values, of
    the key/value heads it is the first to compute, sent to every member
    whose slots they fill (``tp.exchange``)."""

    def __init__(self, cache: "attn.KVBlocks", S: int, cur: int, sinks: int,
                 tp, pos: Optional[Dict[int, torch.Tensor]] = None):
        self.cache, self.tp = cache, tp
        self.dtype = cache.blocks[0]["k"].dtype
        self.writes = {j: attn.cache_writes(cache.length, S, cur, sinks,
                                            span)
                       for j, span in cache.spans.items()}
        for j, block in cache.blocks.items():
            if "pos" in block:
                attn.put_entries(block, {"pos": pos[j]}, self.writes[j])
        self.covered = 0

    def __call__(self, m: int, k: torch.Tensor, v: torch.Tensor,
                 kv_first: int) -> None:
        """Member m's keys and values (key/value heads from ``kv_first``
        on) into every block, for the heads no earlier member sent."""
        lo = max(self.covered, kv_first)
        hi = kv_first + k.shape[2]
        if lo >= hi:
            return
        self.covered = hi
        mine = slice(lo - kv_first, hi - kv_first)
        new = attn.new_entries(k[:, :, mine], v[:, :, mine], self.dtype)
        for j in self.cache.spans:
            block = self.cache.blocks.get(j)
            for dst, src in self.writes[j]:
                for name, t in new.items():
                    part = t[:, src]
                    if self.tp is not None:
                        part = self.tp.exchange(part, m, j)
                    if block is not None:
                        block[name][:, dst, lo:hi].copy_(part)

    def tokens(self, m: int, k: torch.Tensor, v: torch.Tensor,
               first: int) -> None:
        """Member m's keys and values of its tokens (every key/value head;
        the chunk's tokens from ``first`` on) into every block whose slots
        they fill: its own block in place, the others' sent
        (``tp.exchange``)."""
        new = attn.new_entries(k, v, self.dtype)
        last = first + k.shape[1]
        for j in self.cache.spans:
            block = self.cache.blocks.get(j)
            for dst, src in self.writes[j]:
                lo, hi = max(src.start, first), min(src.stop, last)
                if lo >= hi:
                    continue
                at_dst = slice(dst.start + lo - src.start,
                               dst.start + hi - src.start)
                for name, t in new.items():
                    part = self.tp.exchange(t[:, lo - first:hi - first], m, j)
                    if block is not None:
                        block[name][:, at_dst].copy_(part)

    def tokens_unseen(self, B: int, hd: int, spans) -> None:
        """A probe's count of what the members it does not run would send
        of their tokens (``spans``: each member's), as its own."""
        if not self.tp.probe:
            return
        per = next(iter(self.cache.blocks.values()))
        size = sum(per[n].element_size() * (hd if n in "kv" else 1)
                   * per[n].shape[2] for n in per if n != "pos")
        for m, sp in enumerate(spans):
            if m == 0:
                continue
            for j in self.cache.spans:
                if j == m:
                    continue
                n = sum(max(0, min(src.stop, sp.stop) - max(src.start,
                                                            sp.start))
                        for _, src in self.writes[j])
                if n:
                    self.tp.exchange_unseen(B * n * size, m, j)

    def unseen(self, wk: Parts, B: int, hd: int) -> None:
        """A probe's count of what the members it does not run would send
        (their key/value heads, the regions of the key projection ``wk``
        [D, KV, hd]), as its own."""
        if not self.tp.probe:
            return
        per = next(iter(self.cache.blocks.values()))
        size = sum(per[n].element_size() * (hd if n in "kv" else 1)
                   for n in per if n != "pos")
        for m in wk.members[1:]:
            lo = max(self.covered, wk.start(m, 1))
            hi = wk.index[m][1].stop
            self.covered = max(self.covered, hi)
            for j in self.cache.spans:
                if j != m and hi > lo:
                    n = sum(src.stop - src.start for _, src in self.writes[j])
                    self.tp.exchange_unseen(B * n * (hi - lo) * size, m, j)


def _kv_spans(tp, S: int):
    """Each member's keys of a chunk of ``S`` where the group splits the
    keys' sequence over every query (``act_kv_seq`` without a cache:
    ``kv_seq``), None where it does not."""
    if tp is None or tp.ctx.profile != "kv_seq":
        return None
    blocks = tp.blocks((1, S), ("act_batch", "act_kv_seq"))
    if len(tp.members(blocks)) != tp.n:
        return None
    return [b[1] for b in blocks]


def _own_kv(w, hm: torch.Tensor, cfg: ModelConfig, cos_sin):
    """A member's keys and values of its tokens ``hm`` (every key/value
    head, after RoPE at ``cos_sin``, their positions)."""
    k = attn._project(hm, w["wk"])
    v = attn._project(hm, w["wv"])
    if cfg.use_qk_norm:
        k = attn._rms(k, w["k_norm"])
    if cos_sin is not None:
        k = rope.apply_rope(k, *cos_sin)
    return k, v


def _own_q(w, hm: torch.Tensor, cfg: ModelConfig, cos_sin):
    """A member's query heads (its region of ``wq``) of ``hm``."""
    q = attn._project(hm, w["wq"])
    if cfg.use_qk_norm:
        q = attn._rms(q, w["q_norm"])
    if cos_sin is not None:
        q = rope.apply_rope(q, *cos_sin)
    return q


def _span(cos_sin, sp: slice):
    return None if cos_sin is None else tuple(t[:, sp] for t in cos_sin)


def _members_kv(w, tp, h_blocks, spans, cfg, pos, kv_out):
    """Each live member's keys and values of its tokens (``h_blocks``:
    its normed inputs there), its operations its own; ``kv_out(m, k, v,
    first)`` is handed them (a prefill writes the cache's blocks)."""
    kvs = []
    for m, hm in zip(tp.live(range(tp.n)), h_blocks):
        k, v = tp.apply(m, hm, lambda m_, x: _own_kv(
            at(w, m_), x, cfg, _span(pos[m_][0], spans[m_])))
        if kv_out is not None:
            kv_out(m, k, v, spans[m].start)
        kvs.append((k, v))
    return kvs


def _attention_sp(w, h: "Seq", cfg: ModelConfig, window, softcap, sinks,
                  tp, pos, kv_out=None) -> "Seq":
    """Attention under ``train_sp`` (Megatron sequence parallelism), as
    the reference's partitioned program computes it: each member projects
    the keys and values of its own tokens (every key/value head), which
    are all-gathered; the normed blocks are all-gathered and each member
    projects its query heads over the whole sequence, attends with them
    (the ``swattn`` kernel where the gate admits it, outside training)
    and out-projects them; the partial outputs are reduce-scattered over
    the tokens. Projections that do not split by heads run whole on the
    first member, over the gathered sequence."""
    if not isinstance(w["wq"], Parts):
        whole = tp.gather(h, [0])[0]
        o = _attention(w, whole, tuple(t for t in pos[0][0]), pos[0][1],
                       cfg, window, softcap=softcap, sinks=sinks,
                       kv_out=None if kv_out is None else (
                           lambda k, v: kv_out(0, k, v, 0)))
        return tp.split(o, h.spans)
    kvs = _members_kv(w, tp, h.tensors, h.spans, cfg, pos, kv_out)
    n = range(tp.n)
    ks = tp.all_gather([k for k, _ in kvs], n, 1)
    vs = tp.all_gather([v for _, v in kvs], n, 1)
    members = w["wq"].members
    group = cfg.num_heads // cfg.num_kv_heads
    kv = dict(zip(tp.live(n), zip(ks, vs)))
    outs = []
    for m, hm in zip(tp.live(members), tp.gather(h, members)):
        outs.append(tp.apply(m, hm, lambda m_, x: attn.out_project(
            _heads_attend(_own_q(at(w, m_), x, cfg, pos[m_][0]),
                          *kv[m_], pos[m_][1], cfg, window, softcap, sinks,
                          w["wq"].start(m_, 1), group), at(w, m_)))[0])
    return tp.scatter_sum(outs, members, h.spans)


def _attention_cp(w, h: torch.Tensor, cfg: ModelConfig, window, softcap,
                  sinks, tp, pos, kv_out=None, causal: bool = True
                  ) -> torch.Tensor:
    """Attention under ``kv_seq`` (context parallelism), as the
    reference's partitioned program computes it: each member projects its
    query heads over every token, and the keys and values of its block
    of the tokens (every key/value head), and attends every query over
    them (``cp_attend``). ``kv_out(m, k, v, first)``: as
    ``_members_kv``'s."""
    spans = _kv_spans(tp, h.shape[1])
    n = range(tp.n)
    hs = tp.broadcast(h, n)
    kvs = _members_kv(w, tp, [x[:, spans[m]] for m, x in
                              zip(tp.live(n), hs)], spans, cfg, pos, kv_out)
    return cp_attend(w, hs, kvs, [p[1] for p in pos],
                     [p[1][:, spans[m]] for m, p in zip(tp.live(n), pos)],
                     cfg, tp, h.dtype, window=window, softcap=softcap,
                     sinks=sinks, causal=causal,
                     cos_sin=[p[0] for p in pos])


def cp_attend(w, hs, kvs, q_pos, kv_pos, cfg: ModelConfig, tp, dtype, *,
              window=None, softcap: float = 0.0, sinks: int = 0,
              causal: bool = True, cos_sin=None) -> torch.Tensor:
    """Context parallelism's attention from each live member's normed
    input ``hs`` (every token) and its block of the keys and values
    ``kvs`` (every key/value head; ``kv_pos``: their positions): each
    member projects its query heads (``w['wq']`` by heads, RoPE at its
    ``cos_sin``), the heads are all-gathered, each member attends every
    query over its block (``attention.attend_partial``), the partials
    are combined (``tp.TP.combine``), each member's heads of the
    combined output are reduce-scattered to it, and the members'
    out-projections of their heads are summed, on the first member."""
    n = range(tp.n)
    cos_sin = cos_sin or [None] * len(hs)
    qs = [tp.apply(m, hm, lambda m_, x, cs=cs: _own_q(at(w, m_), x, cfg,
                                                       cs))[0]
          for m, hm, cs in zip(tp.live(n), hs, cos_sin)]
    qs = tp.all_gather(qs, n, 2)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim())
    parts = []
    for m, q, (k, v), qp, kp in zip(tp.live(n), qs, kvs, q_pos, kv_pos):
        def part(m_, q_, k=k, v=v, qp=qp, kp=kp):
            return attn.attend_partial(
                q_, attn.repeat_kv(k.to(q_.dtype), cfg.num_heads),
                attn.repeat_kv(v.to(q_.dtype), cfg.num_heads), qp, kp,
                causal=causal, window=window, softcap=softcap, scale=scale,
                sinks=sinks, q_chunk=cfg.q_chunk)
        parts.append(tp.apply(m, q, part))
    heads = [w["wq"].index[m][1] for m in n]
    o = tp.reduce_scatter(tp.combine(parts, n), n, heads, 1)
    outs = []
    for m, om in zip(tp.live(n), o):
        outs.append(tp.apply(m, om, lambda m_, x: attn.out_project(
            x.transpose(1, 2).to(dtype), at(w, m_)))[0])
    return tp.all_reduce(outs, n)


def _heads_attend(q, k, v, q_pos, cfg: ModelConfig, window, softcap, sinks,
                  first: int, group: int) -> torch.Tensor:
    """A member's query heads ``q`` (from head ``first`` on) attended
    over the whole sequence's keys and values ``k``, ``v`` (every
    key/value head): the banded ``swattn`` kernel where the gate admits
    it, else plain ``attend``."""
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim())
    kf = attn.repeat_kv(k[:, :, first // group:], q.shape[2], first, group)
    vf = attn.repeat_kv(v[:, :, first // group:], q.shape[2], first, group)
    if (cfg.use_pallas_attn and sinks == 0 and softcap == 0.0
            and isinstance(window, int)):
        return swattn_cuda(q, kf, vf, window=window, scale=scale)
    return attn.attend(q, kf, vf, q_pos, q_pos, causal=True, window=window,
                       softcap=softcap, scale=scale, sinks=sinks,
                       q_chunk=cfg.q_chunk)


def _decode_on_blocks(w, h, cos_sin, q_pos, cfg: ModelConfig, window,
                      cache: "attn.KVBlocks", cur, softcap, sinks, tp, pos):
    """One token a row on a mesh whose group holds the cache along its
    sequence (flash-decode): every member with a block projects the
    token's query, key and value whole (the heads are replicated), the
    member whose slots hold ``cur`` writes its key and value, each
    attends over its block (``attention.decode_partial``), the partials
    are combined (``tp.TP.combine``), and the members' out-projections
    of their rescaled outputs are summed. A cache whole on the first
    member (it does not divide the group) is attended there alone."""
    members = cache.members
    if len(members) == 1:
        return _attention(w, h, cos_sin, q_pos, cfg, window,
                          cache.blocks[0], cur, softcap, sinks,
                          span=cache.spans[0], length=cache.length)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim())
    parts = []
    for m, hm in zip(tp.live(members), tp.broadcast(h, members)):
        with tp.part(m):
            q, k, v = attn.qkv_project(hm, at(w, m), cfg.use_qk_norm)
            q, k = _rope(q, k, pos[m][0])
            block = cache.blocks[m]
            attn.write_cache(block, k, v, cur, pos_new=pos[m][1][0],
                             sinks=sinks, span=cache.spans[m],
                             length=cache.length)
            parts.append(attn.decode_partial(
                q, block, window=window, softcap=softcap, scale=scale,
                q_pos=pos[m][1], sinks=sinks))
    return combined(w, parts, members, tp, h.dtype)


def combined(w, parts, members, tp, dtype) -> torch.Tensor:
    """The members' partial one-token attention (``decode_partial``)
    combined (``tp.TP.combine``), each member's rescaled output
    out-projected with its projections ``w`` and the products summed."""
    outs = []
    for m, o in zip(tp.live(members), tp.combine(parts, members)):
        with tp.part(m):
            o = o.to(dtype).reshape(o.shape[0], 1, -1, o.shape[-1])
            outs.append(attn.out_project(o, at(w, m)))
    return tp.all_reduce(outs, members)


def _rope(q: torch.Tensor, k: torch.Tensor, cos_sin):
    """RoPE on the queries and keys, or none (``cos_sin`` None: whisper,
    whose positions are added to its inputs)."""
    if cos_sin is None:
        return q, k
    cos, sin = cos_sin
    return rope.apply_rope(q, cos, sin), rope.apply_rope(k, cos, sin)


def _attention(w, h, cos_sin, q_pos, cfg: ModelConfig, window, cache=None,
               cur=None, softcap: float = 0.0, sinks: int = 0,
               first: int = 0, group=None, kv_out=None, span=None,
               length=None) -> torch.Tensor:
    """Attention on the normed input ``h`` with the projections ``w``:
    every head, or (``group``) the query heads from head ``first`` on.
    ``kv_out(k, v)``: the keys and values after RoPE are handed to it
    (a prefill on a mesh writes the cache's blocks with them). ``span``
    and ``length``: ``cache`` is that block of a cache's slots."""
    q, k, v = attn.qkv_project(h, w, cfg.use_qk_norm)
    q, k = _rope(q, k, cos_sin)
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim())
    decode = cache is not None and q.shape[1] == 1
    if kv_out is not None:
        kv_out(k, v)
    if cache is not None:
        attn.write_cache(cache, k, v, cur, pos_new=q_pos[0], sinks=sinks,
                         span=span, length=length)
    use_kernel = (cfg.use_pallas_attn and not decode and sinks == 0
                  and softcap == 0.0 and isinstance(window, int))
    H = q.shape[2]
    if decode:
        o = attn.decode_attend(q, cache, cfg.num_heads, window=window,
                               softcap=softcap, scale=scale, q_pos=q_pos,
                               sinks=sinks)
    elif use_kernel and group is None:
        # the banded CUDA kernel: the online-softmax state stays on chip,
        # no S×S score plane in device memory, k/v read per GQA group
        o = swattn_cuda(q, k, v, window=window, scale=scale)
    else:
        kf = attn.repeat_kv(k, H, first, group)
        vf = attn.repeat_kv(v, H, first, group)
        if use_kernel:          # a member's heads, each with its own k/v
            o = swattn_cuda(q, kf, vf, window=window, scale=scale)
        else:
            o = attn.attend(q, kf, vf, q_pos, q_pos, causal=True,
                            window=window, softcap=softcap, scale=scale,
                            sinks=sinks, q_chunk=cfg.q_chunk)
    return attn.out_project(o, w)


# Every block returns (x', aux): its auxiliary loss (a float32 0-d tensor
# for moe, 0.0 for the kinds that have none), which ``forward`` sums.


def _attn_of(lp, x, ctx, cfg: ModelConfig, cache, softcap: float):
    return _attention_part(lp, x, ctx["cos_sin"], ctx["q_pos"], cfg,
                           ctx["window"], cache, ctx["cur"], softcap,
                           ctx["sinks"], ctx.get("tp"), ctx.get("pos"))


def dense_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """Attention + gated MLP, pre-norm residual."""
    x = x + _attn_of(lp, x, ctx, cfg, cache, cfg.attn_logit_softcap)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], tp=ctx.get("tp")), 0.0


def moe_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """Attention + the MoE block, pre-norm residual. A decode step (one
    query per row) routes the whole batch as one group ([1, B, D]), as
    the reference does; otherwise each row is its own group."""
    x = x + _attn_of(lp, x, ctx, cfg, cache, cfg.attn_logit_softcap)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    B, S, D = h.shape
    if S == 1:
        h = h.reshape(1, B, D)
    y, aux = moe_mod.moe_block(h, lp["moe"], num_experts=cfg.num_experts,
                               k=cfg.num_experts_per_tok,
                               capacity_factor=cfg.capacity_factor,
                               tp=ctx.get("tp"))
    return x + (y if isinstance(y, Seq) else y.reshape(B, S, D)), aux


def hymba_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """Attention ∥ mamba on the same normed input (the mean of the two
    paths), then the gated MLP. The mamba state streams through
    ``cache['mamba']``, updated in place."""
    a = _attn_of(lp, x, ctx, cfg, None if cache is None else cache["attn"],
                 0.0)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    cm = None if cache is None else cache["mamba"]
    tp = ctx.get("tp")
    m, state = ssm_mod.mamba_block(_whole(h, tp), lp["mamba"], cfg,
                                   state_in=cm, tp=tp)
    _store(cm, state)
    x = x + 0.5 * (a + _like(m, x, tp))
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h2, lp["mlp"], tp=ctx.get("tp")), 0.0


def mamba_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """A pre-norm mamba block (the plain conv, as in the reference); its
    state streams through ``cache``, updated in place."""
    h = _whole(rms_norm(x, lp["ln1"], cfg.norm_eps), ctx.get("tp"))
    y, state = ssm_mod.mamba_block(h, lp["mamba"], cfg, state_in=cache,
                                   tp=ctx.get("tp"))
    _store(cache, state)
    return x + _like(y, x, ctx.get("tp")), 0.0


def mlstm_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """A pre-norm mLSTM block; conv state and memory stream through
    ``cache``, updated in place."""
    h = _whole(rms_norm(x, lp["ln1"], cfg.norm_eps), ctx.get("tp"))
    y, state = xlstm_mod.mlstm_block(h, lp["mlstm"], cfg, state_in=cache,
                                     tp=ctx.get("tp"))
    _store(cache, state)
    return x + _like(y, x, ctx.get("tp")), 0.0


def slstm_block(lp, x, ctx, cfg: ModelConfig, cache=None):
    """A pre-norm sLSTM block; conv state and (c, n, h, m) stream through
    ``cache``, updated in place."""
    h = _whole(rms_norm(x, lp["ln1"], cfg.norm_eps), ctx.get("tp"))
    y, state = xlstm_mod.slstm_block(h, lp["slstm"], cfg, state_in=cache,
                                     tp=ctx.get("tp"))
    _store(cache, state)
    return x + _like(y, x, ctx.get("tp")), 0.0


def _whole(h, tp):
    """``h``, or under ``train_sp`` (a ``tp.Seq``) its whole sequence on
    the group's first member: the recurrent layers scan the sequence
    there, their inner dim split over the group as under ``train``."""
    return tp.gather(h, [0])[0] if isinstance(h, Seq) else h


def _like(y, x, tp):
    """A block's output ``y`` as the residual stream ``x`` holds it: a
    whole sequence on the first member split into ``x``'s token blocks
    under ``train_sp``."""
    if isinstance(x, Seq) and not isinstance(y, Seq):
        return tp.split(y, x.spans)
    return y


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
            remat_policy: str = "none", logits: bool = True, tp=None):
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

    ``tp`` (a data-parallel rank's tensor-parallel group on a mesh,
    ``sharding/tp.py``): the leaves the plan splits come as ``tp.Parts``
    and their blocks run split over the group (``tp_plan``); the rest
    runs on the group's first member. Where the group splits the
    sequence (``train_sp``) the residual stream is a ``tp.Seq`` of the
    members' token blocks from the embedding to the final norm, and so
    are the hidden states returned; under ``kv_seq`` each member attends
    every query over its block of the keys. With caches (serving on a mesh,
    ``sharding/serve.py``) each stage's KV cache comes as
    ``attention.KVBlocks``, the members' blocks of its sequence, a conv
    state the recurrent layers split as ``tp.Parts`` of the members'
    blocks, and the other recurrent states as the rank's whole tensors;
    the logits are split by vocabulary and put together on the first
    member.
    """
    if tp is not None and caches is None and logits:
        raise ValueError("a tensor-parallel forward without caches is the "
                         "mesh train step's: hidden states out")
    dtype = model_dtype(cfg)
    spans = (tp.seq_spans(inputs.shape[1])
             if tp is not None and inputs.shape[1] > 1 else None)
    if spans is not None and inputs.ndim == 2:
        x = embed_seq(inputs, params["embed"], dtype, tp, spans)
    elif inputs.ndim == 2:
        x = embed(inputs, params["embed"], dtype, tp)
    else:
        x = inputs.to(dtype)
        if spans is not None:
            x = tp.split(x, spans)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    cos_sin = _positions_cos_sin(cfg, positions)
    pos = None
    if tp is not None:          # the positions at every member, once
        cos, sin, at_pos = (tp.replicate(t, range(tp.n))
                            for t in (*cos_sin, positions))
        pos = list(zip(zip(cos, sin), at_pos))
    aux_total = torch.zeros((), dtype=torch.float32,
                            device=tp.home if tp is not None else x.device)
    for i, st in enumerate(make_stages(cfg)):
        block = BLOCKS[st.kind]
        sp = params[f"stage_{i}"]
        ctx = {"cos_sin": cos_sin, "q_pos": positions, "window": st.window,
               "cur": cur, "sinks": cfg.num_meta_tokens, "tp": tp,
               "pos": pos}
        # one unbind per stage: backward stacks the layers' gradients once
        # (indexing each layer would add a zero-filled stack per layer)
        layer_params = _unstack(sp, st.count)
        if caches is None:
            run = _remat(block, remat_policy)
            for lp in layer_params:
                x, aux = run(lp, x, ctx, cfg)
                aux_total = aux_total + aux
        else:
            run = fsdp.gathered(block)
            for layer, lp in enumerate(layer_params):
                x, aux = run(lp, x, ctx, cfg, _layer(caches[i], layer))
                aux_total = aux_total + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits:
        x = logits_of(x, params, cfg.tie_embeddings, tp)
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
    if isinstance(tree, attn.KVBlocks):
        return tree.layer(i)
    if isinstance(tree, Parts):
        return Parts([None if t is None else t[i] for t in tree.tensors],
                     [None if ix is None else ix[1:] for ix in tree.index])
    return tree[i]


def _unstack(tree, n: int) -> List[Dict[str, Any]]:
    """A stage's stacked params as ``n`` per-layer trees, one
    ``torch.unbind`` per leaf; a leaf the mesh step hands in as
    ``fsdp.Stacked`` gives one ``LayerRef`` a layer, which the layer's
    run gathers (``_remat``)."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if isinstance(tree, fsdp.Stacked):
        return tree.layers(n)
    if isinstance(tree, Parts):
        return tree.unbind(n)
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
    numbers, so no RNG state is kept. A layer of ``LayerRef``s (the mesh
    step's) is gathered inside the run: inside the checkpointed function,
    so backward gathers it again, or, under ``'none'``, with its weights
    saved for backward as handles (``sharding/fsdp.py``). With tensor
    parallelism over distinct cards the recomputation is started on the
    rank's own card (``tp.TP.recomputed_first``)."""
    if policy == "none":
        return fsdp.hooked(block)
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

    gathered = fsdp.gathered(block)

    def inner(lp, x, ctx, cfg):
        out = gathered(lp, x, ctx, cfg)
        tp = ctx.get("tp") if isinstance(ctx, dict) else None
        if tp is None:
            return out
        if not isinstance(out, tuple):      # whisper's layers: x' alone
            return tp.recomputed_first(out)
        y, aux = out
        return tp.recomputed_first(y), aux

    def run(lp, x, ctx, cfg):
        return checkpoint(inner, lp, x, ctx, cfg, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)
    return run
