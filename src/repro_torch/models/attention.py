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
"""
from __future__ import annotations

import math
from typing import Optional

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


def tp_heads(tp, num_heads: int, num_kv: int):
    """The heads' split at the attention's constraint points (q, and
    k / v repeated to the heads: ``act_heads``) as (member, query heads,
    key/value heads) a computing member, or None where the heads do not
    split. A member's key/value heads are those its query heads read:
    its own block where they split with the heads, else the GQA groups of
    its heads, taken from the replicated weights."""
    blocks = tp.blocks((1, 1, num_heads, 1),
                       ("act_batch", None, "act_heads", None))
    members = tp.members(blocks)
    if len(members) == 1:
        return None
    g = num_heads // num_kv
    return [(m, blocks[m][2], slice(blocks[m][2].start // g,
                                    (blocks[m][2].stop - 1) // g + 1))
            for m in members]


def tp_plan(tp, num_heads: int, num_kv: int, use_qk_norm: bool):
    """Each attention weight's region at each member ({name: [index or
    None a member]}, the shapes of ``attn_specs``), {} where the heads
    do not split."""
    split = tp_heads(tp, num_heads, num_kv)
    if split is None:
        return {}
    every = slice(None)
    out = {k: [None] * tp.n for k in ("wq", "wk", "wv", "wo")}
    if use_qk_norm:
        out.update(q_norm=[None] * tp.n, k_norm=[None] * tp.n)
    for m, hs, kvs in split:
        out["wq"][m] = (every, hs, every)
        out["wk"][m] = out["wv"][m] = (every, kvs, every)
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


def write_cache(cache, k_new: torch.Tensor, v_new: torch.Tensor, cur: int,
                pos_new: Optional[torch.Tensor] = None, sinks: int = 0):
    """Insert [B, S_new, Kv, hd] into the ring at absolute position
    ``cur`` (a Python int), in place; returns ``cache``.

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
                   each at its ring slot.

    ``pos_new``: [S_new] absolute positions (defaults to cur + arange).
    """
    L = cache["k"].shape[1]
    S_new = k_new.shape[1]
    quant = cache["k"].dtype == torch.int8
    if quant:
        k_new, ks_new = quantize_kv(k_new)
        v_new, vs_new = quantize_kv(v_new)
    if pos_new is None:
        pos_new = cur + torch.arange(S_new, dtype=torch.int32,
                                     device=k_new.device)
    new = {"k": k_new, "v": v_new, "pos": pos_new}
    if quant:
        new["k_scale"], new["v_scale"] = ks_new, vs_new
    M = sinks
    W = L - M

    def put(dst: slice, src: slice) -> None:
        for name, t in new.items():
            if name == "pos":
                cache[name][dst].copy_(t[src])
            else:
                cache[name][:, dst].copy_(t[:, src])

    if S_new < L:
        start = ring_slot(cur, L, M)
        if start + S_new > L:
            raise ValueError(
                f"a chunk of {S_new} tokens from position {cur} (slot "
                f"{start}) would wrap past the last of {L} cache slots; "
                "write it in chunks that end at the ring's edge")
        put(slice(start, start + S_new), slice(None))
        return cache
    # eviction write: sinks to their reserved slots, the ring tail for the
    # rest, each token at its slot (the reference's roll)
    first = cur + (S_new - W)                 # abs position of the tail's [0]
    shift = ring_slot(first, L, M) - M
    put(slice(0, M), slice(0, M))
    put(slice(M + shift, L), slice(S_new - W, S_new - shift))
    put(slice(M, M + shift), slice(S_new - shift, S_new))
    return cache


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
    ck, cv = cache["k"], cache["v"]
    if ck.dtype == torch.int8:
        ck = dequantize_kv(ck, cache["k_scale"], q.dtype)
        cv = dequantize_kv(cv, cache["v_scale"], q.dtype)
    KV = ck.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kv_pos = cache["pos"][None].expand(B, -1)
    if q_pos is None:
        q_pos = cache["pos"].max()[None, None].expand(B, 1)
    qg = q.reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,blkd->bkgl", qg, ck).float() * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    m = _mask(q_pos, kv_pos, True, window, sinks)          # [B,1,1,L]
    s = torch.where(m, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgl,blkd->bkgd", w, cv)
    return o.reshape(B, 1, H, hd)
