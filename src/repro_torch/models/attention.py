"""GQA attention, as in the reference's ``models/attention.py``: the
projections, the position-based mask, the q-chunked plain ``attend`` for
training and prefill, and the KV cache (contiguous or ring, reserved sink
slots, optional int8 values) with one-token ``decode_attend``.

Masking is position-based: every key carries its absolute position (PAD =
-1 never attended, META = -2 always attended — hymba meta tokens act as
attention sinks). The banded CUDA kernel (``kernels/swattn``) replaces
``attend`` where the transformer's kernel gate lets it; decode attention
is plain torch, as in the reference (einsums, no kernel).

The caches are written in place: ``write_cache`` stores into the
preallocated tensors it is given and returns the same dict. The
reference's ``write_cache`` is functional (under ``jit`` XLA writes in
place); a functional copy here would rewrite the whole cache on every
decode step.

On a mesh (``sharding/serve.py``) a KV cache lies on a data-parallel
rank's tensor-parallel group along its sequence (``cache_seq``), as the
reference places it: ``KVBlocks`` holds each member's block, a range of
the slot space. ``write_cache(..., span=)`` writes into one block the
tokens whose slots fall in it (``cache_writes`` lists them), and
``decode_partial`` gives a member's part of one-token attention over its
block (its row maxima, sums and unnormalised output), which the group
combines flash-decode style (``tp.TP.combine``). ``attend_partial`` is
the same for every query of a chunk over a member's block of its keys
(the ``kv_seq`` profile's context parallelism).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.module import p

PAD_POS = -1
META_POS = -2

NEG_INF = -1e30


def attn_specs(d: int, num_heads: int, num_kv: int, head_dim: int,
               use_qk_norm: bool = False):
    specs = {
        "wq": p((d, num_heads, head_dim), ("embed", "heads", "head_dim")),
        "wk": p((d, num_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wv": p((d, num_kv, head_dim), ("embed", "kv_heads", "head_dim")),
        "wo": p((num_heads, head_dim, d), ("heads", "head_dim", "embed")),
    }
    if use_qk_norm:
        specs["q_norm"] = p((head_dim,), ("head_dim",), init="ones")
        specs["k_norm"] = p((head_dim,), ("head_dim",), init="ones")
    return specs


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B,S,D] @ [D,H,hd] -> [B,S,H,hd]."""
    D, H, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * hd)).unflatten(-1, (H, hd))


def qkv_project(x: torch.Tensor, params, use_qk_norm: bool = False):
    """x: [B,S,D] -> q [B,S,H,hd], k,v [B,S,Kv,hd] (pre-RoPE)."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if use_qk_norm:
        q = _rms(q, params["q_norm"])
        k = _rms(k, params["k_norm"])
    return q, k, v


def out_project(o: torch.Tensor, params) -> torch.Tensor:
    """[B,S,H,hd] @ [H,hd,D] -> [B,S,D]."""
    H, hd, D = params["wo"].shape
    return o.flatten(-2) @ params["wo"].to(o.dtype).reshape(H * hd, D)


def repeat_kv(k: torch.Tensor, num_heads: int, first: int = 0,
              group: Optional[int] = None) -> torch.Tensor:
    """[B,S,Kv,hd] -> [B,S,H,hd] by repetition. With ``group``: the
    ``num_heads`` query heads from head ``first`` on (a tensor-parallel
    member's), each reading key/value head ``head // group``, where
    ``k`` holds the key/value heads from ``first // group`` on."""
    Kv = k.shape[2]
    if group is not None:
        sel = [h // group - first // group
               for h in range(first, first + num_heads)]
        if num_heads % Kv or sel != [j // (num_heads // Kv)
                                     for j in range(num_heads)]:
            return k.index_select(2, torch.tensor(sel, device=k.device))
    if Kv == num_heads:
        return k
    return k.repeat_interleave(num_heads // Kv, dim=2)


def tp_heads(tp, num_heads: int, num_kv: int, rule: str = "act_heads"):
    """The heads' split at the attention's constraint points (q, and
    k / v repeated to the heads: ``act_heads``) as (member, query heads,
    key/value heads) a computing member, or None where the heads do not
    split. A member's key/value heads are those its query heads read:
    its own block where they split with the heads, else the GQA groups of
    its heads, taken from the replicated weights. ``rule``: the logical
    axis the heads' split is read from (``'heads'``: the weights')."""
    blocks = tp.blocks((1, 1, num_heads, 1),
                       ("act_batch", None, rule, None))
    members = tp.members(blocks)
    if len(members) == 1:
        return None
    g = num_heads // num_kv
    return [(m, blocks[m][2], slice(blocks[m][2].start // g,
                                    (blocks[m][2].stop - 1) // g + 1))
            for m in members]


def tp_kv_seq(tp, cache_len: int):
    """The cache sequence's split where the group splits it (the decode
    profile's ``act_kv_seq``): each member's slots, as the cache lies on
    the group (``cache_seq``), as (member, slots) a member with a block of
    its own, or None where it does not split (another profile, or a cache
    length that does not divide the group: the placement is dropped and
    the cache is whole on every member)."""
    if "act_kv_seq" not in tp.ctx.tp_splits():
        return None
    blocks = tp.blocks((1, cache_len), ("act_batch", "cache_seq"))
    members = tp.members(blocks)
    return None if len(members) == 1 else [(m, blocks[m][1])
                                           for m in members]


def tp_plan(tp, num_heads: int, num_kv: int, use_qk_norm: bool,
            cache_len: Optional[int] = None, kv_own: bool = False):
    """Each attention weight's region at each member ({name: [index or
    None a member]}, the shapes of ``attn_specs``), {} where the heads
    do not split. ``cache_len``: the stage's cache where the group splits
    its sequence (decode): the heads are whole there (where the rules
    also map them onto the group, as the EP overrides do, the reference's
    constraint on the cache's keys takes 'model' for the sequence first
    and drops the heads), and each member with a block of the cache reads
    every projection whole; a cache that does not divide the group is
    attended whole on its first member. ``kv_own`` (``train_sp``,
    ``kv_seq``): each member projects the keys and values of its own
    tokens, every key/value head, and reads ``wk``, ``wv`` and the norms
    whole; its query heads are the weights' (the ``heads`` rule, which
    ``kv_seq`` keeps where it leaves ``act_heads`` whole)."""
    every = slice(None)
    names = ("wq", "wk", "wv", "wo") + (("q_norm", "k_norm")
                                        if use_qk_norm else ())
    out = {k: [None] * tp.n for k in names}
    if cache_len is not None:
        seq = tp_kv_seq(tp, cache_len)
        if seq is None:
            return {}
        for m, _ in seq:
            for k in names:
                out[k][m] = (every,) * (1 if k.endswith("norm") else 3)
        return out
    split = tp_heads(tp, num_heads, num_kv, "heads" if kv_own
                     else "act_heads")
    if split is None or kv_own and len(split) != tp.n:
        return {}
    for m, hs, kvs in split:
        out["wq"][m] = (every, hs, every)
        out["wk"][m] = out["wv"][m] = (every, every if kv_own else kvs,
                                       every)
        out["wo"][m] = (hs, every, every)
        if use_qk_norm:
            out["q_norm"][m] = out["k_norm"][m] = (every,)
    return out


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
          window, sinks: int = 0) -> torch.Tensor:
    """q_pos [B,Sq], kv_pos [B,Skv] -> bool [B,1,Sq,Skv].

    ``sinks`` > 0: the first ``sinks`` absolute positions are always
    attended (hymba meta tokens act as attention sinks), escaping the
    sliding window but not causality.
    """
    qp = q_pos[:, :, None]          # [B,Sq,1]
    kp = kv_pos[:, None, :]         # [B,1,Skv]
    ok = kp != PAD_POS
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        w = int(window)
        in_win = (qp - kp) < w if w > 0 else torch.ones_like(ok)
        if sinks:
            in_win = in_win | (kp < sinks)
        ok = ok & in_win
    ok = ok | (kp == META_POS)
    return ok[:, None, :, :]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
           causal: bool = True, window=None, softcap: float = 0.0,
           q_chunk: int = 1024, scale: Optional[float] = None,
           sinks: int = 0) -> torch.Tensor:
    """Full attention math. q [B,Sq,H,hd]; k,v [B,Skv,H,hd] (kv
    pre-repeated). Loops over q chunks so the [Sq,Skv] scores are never
    all materialised at once. Softmax in float32."""
    B, Sq, H, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    def block(q_blk, qp_blk):
        s = torch.einsum("bqhk,bshk->bhqs", q_blk, k).float() * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        m = _mask(qp_blk, kv_pos, causal, window, sinks)
        s = torch.where(m, s, NEG_INF)
        w = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqs,bshk->bqhk", w, v)

    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        return torch.cat([block(q[:, i:i + q_chunk], q_pos[:, i:i + q_chunk])
                          for i in range(0, Sq, q_chunk)], dim=1)
    return block(q, q_pos)


def attend_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                   causal: bool = True, window=None, softcap: float = 0.0,
                   q_chunk: int = 1024, scale: Optional[float] = None,
                   sinks: int = 0):
    """A member's part of :func:`attend` over its block of the keys
    (context parallelism, the ``kv_seq`` profile): q [B,Sq,H,hd] every
    query, k, v [B,Sk,H,hd] the block's keys and values (pre-repeated),
    ``kv_pos`` [B,Sk] their absolute positions, which the mask reads (so
    a block's keys mask as they do in the whole). Returns its row maxima
    ``mx`` and sums of exponentials ``l`` ([B,H,Sq,1], float32) and its
    unnormalised output ``o`` = exp(s − mx) · v ([B,H,Sq,hd], in q's
    dtype), q-chunked as ``attend``; ``tp.TP.combine`` joins the members'
    parts. The softcap comes before the mask, as in ``attend``. A row
    with no key of the block it may attend has ``mx`` = ``NEG_INF`` and
    ``l`` = ``o`` = 0. The maxima carry no gradient: the combined result
    does not depend on them."""
    B, Sq, H, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    def block(q_blk, qp_blk):
        s = torch.einsum("bqhk,bshk->bhqs", q_blk, k).float() * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        m = _mask(qp_blk, kv_pos, causal, window, sinks)
        s = torch.where(m, s, NEG_INF)
        mx = s.detach().amax(dim=-1, keepdim=True)
        p_ = torch.where(m, torch.exp(s - mx), 0.0)
        o = torch.einsum("bhqs,bshk->bhqk", p_.to(q.dtype), v)
        return mx, p_.sum(dim=-1, keepdim=True), o

    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        parts = [block(q[:, i:i + q_chunk], q_pos[:, i:i + q_chunk])
                 for i in range(0, Sq, q_chunk)]
        return tuple(torch.cat(t, dim=2) for t in zip(*parts))
    return block(q, q_pos)


# -- KV cache (contiguous or ring; optional int8 quantisation) ---------------
#
# int8 KV: symmetric per-(position, head) scales over head_dim —
# k_int8[b,s,h,:] * k_scale[b,s,h]. Quantised at write (once per token),
# dequantised at read.

def quantize_kv(x: torch.Tensor):
    """[B,S,KV,hd] -> (int8 values, [B,S,KV] float32 scales). The division
    is in float32 and ``torch.round`` rounds half to even, as ``jnp.round``
    does, so values and scales equal the reference's bit for bit."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def init_cache(batch: int, cache_len: int, num_kv: int, head_dim: int,
               dtype: torch.dtype = torch.bfloat16, *, device):
    """An empty cache: every slot's position is PAD. int8 adds the
    float32 per-(position, head) scales."""
    shape = (batch, cache_len, num_kv, head_dim)
    out = {"k": torch.zeros(shape, dtype=dtype, device=device),
           "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        out["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                     device=device)
        out["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                     device=device)
    # absolute position of each slot; PAD_POS = empty
    out["pos"] = torch.full((cache_len,), PAD_POS, dtype=torch.int32,
                            device=device)
    return out


def cache_abstract(batch: int, cache_len: int, num_kv: int, head_dim: int,
                   dtype: torch.dtype = torch.bfloat16):
    """``init_cache``'s tree on ``meta`` tensors (shapes and dtypes)."""
    return init_cache(batch, cache_len, num_kv, head_dim, dtype,
                      device="meta")


def cache_axes(quantized: bool = False):
    """Logical axes of the cache leaves (sequence-sharded in the decode
    profile)."""
    ax = {"k": ("act_batch", "cache_seq", None, None),
          "v": ("act_batch", "cache_seq", None, None),
          "pos": ("cache_seq",)}
    if quantized:
        ax["k_scale"] = ("act_batch", "cache_seq", None)
        ax["v_scale"] = ("act_batch", "cache_seq", None)
    return ax


def ring_slot(p: int, cache_len: int, sinks: int = 0) -> int:
    """The slot of absolute position ``p``: position p < M lives at slot p
    (a permanent sink slot), p >= M at M + (p − M) % (L − M). M = 0 gives
    the plain ring p % L."""
    if p < sinks:
        return p
    return sinks + (p - sinks) % (cache_len - sinks)


def cache_writes(length: int, S_new: int, cur: int, sinks: int = 0,
                 span: Optional[Tuple[int, int]] = None
                 ) -> List[Tuple[slice, slice]]:
    """Where ``write_cache`` puts a chunk of ``S_new`` tokens from
    absolute position ``cur`` into a cache of ``length`` slots: (slots,
    tokens) pairs of equal length, the slots relative to ``span``'s first
    (a block of the slot space, [lo, hi); the whole cache where None),
    only those that fall in it.

    Slot invariant (uniform across the batch; decode is synchronous), with
    ``sinks`` = M reserved slots: see :func:`ring_slot`. The sink slots
    hold hymba's meta tokens and are never evicted. Two cases:

      S_new <  L : decode / short prefill — the chunk goes to the slots
                   from ``ring_slot(cur)`` on. A chunk that would run past
                   the last slot is refused: the reference's
                   ``dynamic_update_slice`` silently moves its start back
                   (a clamp), which breaks the slot invariant.
      S_new >= L : window prefill — the sink prefix goes to its reserved
                   slots; of the rest only the last L − M tokens are kept,
                   each at its ring slot (the reference's roll), a write
                   that spans every block.
    """
    L, M = length, sinks
    W = L - M
    if S_new < L:
        start = ring_slot(cur, L, M)
        if start + S_new > L:
            raise ValueError(
                f"a chunk of {S_new} tokens from position {cur} (slot "
                f"{start}) would wrap past the last of {L} cache slots; "
                "write it in chunks that end at the ring's edge")
        runs = [(start, 0, S_new)]
    else:
        first = cur + (S_new - W)             # abs position of the tail's [0]
        shift = ring_slot(first, L, M) - M
        runs = [(0, 0, M), (M + shift, S_new - W, W - shift),
                (M, S_new - shift, shift)]
    lo, hi = span if span is not None else (0, L)
    out = []
    for dst, src, n in runs:
        a, b = max(dst, lo), min(dst + n, hi)
        if a < b:
            out.append((slice(a - lo, b - lo),
                        slice(src + a - dst, src + b - dst)))
    return out


def new_entries(k_new: torch.Tensor, v_new: torch.Tensor, dtype):
    """A chunk's keys and values as a cache of ``dtype`` stores them:
    {'k', 'v'}, quantised with their 'k_scale' / 'v_scale' for int8."""
    if dtype != torch.int8:
        return {"k": k_new, "v": v_new}
    k, ks = quantize_kv(k_new)
    v, vs = quantize_kv(v_new)
    return {"k": k, "v": v, "k_scale": ks, "v_scale": vs}


def put_entries(cache, new, writes) -> None:
    """Copy ``new``'s tokens (``new_entries``, and 'pos' where given)
    into ``cache`` at ``writes`` (``cache_writes``' pairs)."""
    for dst, src in writes:
        for name, t in new.items():
            if name == "pos":
                cache[name][dst].copy_(t[src])
            else:
                cache[name][:, dst].copy_(t[:, src])


def write_cache(cache, k_new: torch.Tensor, v_new: torch.Tensor, cur: int,
                pos_new: Optional[torch.Tensor] = None, sinks: int = 0,
                span: Optional[Tuple[int, int]] = None,
                length: Optional[int] = None):
    """Insert [B, S_new, Kv, hd] into the ring at absolute position
    ``cur`` (a Python int), in place; returns ``cache``. The slots are
    :func:`cache_writes`'. ``span`` (with ``length``, the whole cache's
    slots): ``cache`` is the block [lo, hi) of the slot space, and only
    the tokens whose slots fall in it are written.

    ``pos_new``: [S_new] absolute positions (defaults to cur + arange).
    """
    S_new = k_new.shape[1]
    if pos_new is None:
        pos_new = cur + torch.arange(S_new, dtype=torch.int32,
                                     device=k_new.device)
    writes = cache_writes(cache["k"].shape[1] if span is None else length,
                          S_new, cur, sinks, span)
    new = new_entries(k_new, v_new, cache["k"].dtype)
    new["pos"] = pos_new
    put_entries(cache, new, writes)
    return cache


class KVBlocks:
    """A KV cache as a tensor-parallel group holds it on a mesh: the
    cache's ``length`` slots lie along 'model' (``cache_seq``), and each
    member m of ``spans`` (the members with a block of their own, in the
    group's order) holds the slots ``spans[m]`` = (lo, hi) in
    ``blocks[m]``, a tree of ``init_cache``'s leaves over those slots (on
    the member's device; absent where the member does not run, as a dry
    run's probe). A cache that does not divide the group is whole on
    its first member: ``spans`` = {0: (0, length)}."""

    def __init__(self, blocks: Dict[int, dict],
                 spans: Dict[int, Tuple[int, int]], length: int):
        self.blocks, self.spans, self.length = blocks, spans, length

    @property
    def members(self) -> List[int]:
        return list(self.spans)

    def layer(self, i: int) -> "KVBlocks":
        """Layer ``i`` of a stage's stacked blocks (views)."""
        return KVBlocks({m: {k: v[i] for k, v in b.items()}
                         for m, b in self.blocks.items()},
                        self.spans, self.length)


def decode_attend(q: torch.Tensor, cache, num_heads: int, *, window=None,
                  softcap: float = 0.0, scale: Optional[float] = None,
                  q_pos: Optional[torch.Tensor] = None,
                  sinks: int = 0) -> torch.Tensor:
    """One-token attention against the cache. q: [B,1,H,hd].

    The reference repeats the cache's KV heads to H before ``attend``;
    here each query head reads its KV head through a grouped view
    ([B,KV,G,hd] against [B,L,KV,hd]), the same values without the H/KV
    copies of the cache. Softmax in float32, as in ``attend``.
    """
    B, _, H, hd = q.shape
    if q_pos is None:
        q_pos = cache["pos"].max()[None, None].expand(B, 1)
    s, cv = _decode_scores(q, cache, window, softcap, scale, q_pos, sinks)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgl,blkd->bkgd", w, cv)
    return o.reshape(B, 1, H, hd)


def _decode_scores(q, cache, window, softcap, scale, q_pos, sinks,
                   causal: bool = True):
    """The masked float32 scores [B, KV, G, L] of one query per row
    against the cache's keys, and its values (dequantised). ``causal``
    False: no mask (a cross cache of encoder frames, every key valid)."""
    B, _, H, hd = q.shape
    ck, cv = cache["k"], cache["v"]
    if ck.dtype == torch.int8:
        ck = dequantize_kv(ck, cache["k_scale"], q.dtype)
        cv = dequantize_kv(cv, cache["v_scale"], q.dtype)
    KV = ck.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,blkd->bkgl", qg, ck).float() * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if not causal:
        return s, cv
    kv_pos = cache["pos"][None].expand(B, -1)
    m = _mask(q_pos, kv_pos, True, window, sinks)          # [B,1,1,L]
    return torch.where(m, s, NEG_INF), cv


def decode_partial(q: torch.Tensor, cache, *, window=None,
                   softcap: float = 0.0, scale: Optional[float] = None,
                   q_pos: Optional[torch.Tensor] = None, sinks: int = 0,
                   causal: bool = True):
    """A member's part of :func:`decode_attend` over its block of the
    cache (flash-decode): its row maxima ``mx`` and sums of exponentials
    ``l`` ([B, KV, G, 1], float32) and its unnormalised output ``o`` =
    exp(s − mx) · v ([B, KV, G, hd], in q's dtype). A block with no key a
    row may attend has ``mx`` = ``NEG_INF``, and the combine scales it
    to nothing. ``causal`` False: every key of the block is attended
    (whisper's cross-attention over its block of encoder frames, a cache
    of 'k' and 'v' alone)."""
    s, cv = _decode_scores(q, cache, window, softcap, scale, q_pos, sinks,
                           causal)
    mx = s.amax(dim=-1, keepdim=True)
    p_ = torch.exp(s - mx)
    o = torch.einsum("bkgl,blkd->bkgd", p_.to(q.dtype), cv)
    return mx, p_.sum(dim=-1, keepdim=True), o
