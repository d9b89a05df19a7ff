"""Model registry: one bundle per architecture family, as in the
reference's ``models/registry.py``.

``build(run_config, device='cuda')`` returns a :class:`ModelBundle` with

  init_params(generator, dtype)        -> params (on the bundle's device)
  train_forward(params, batch)         -> (logits, aux_loss)
  loss_fn(params, batch, ...)          -> (loss, (aux_loss, denom))
  prefill(params, batch, tp=None)      -> (last_logits, caches)
  decode_step(params, inp, caches, cur, tp=None) -> (logits, caches)
  cache_init(batch, seq_len)           -> empty caches
  cache_abstract(batch, seq_len)       -> the same on ``meta`` tensors
  cache_axes()                         -> the caches' logical axes
  input_specs(kind)                    -> a batch of ``meta`` tensors

for every family of the reference's model registry: the decoder LMs
(``dense``, ``moe``, ``ssm`` — xLSTM's mLSTM and sLSTM —, ``hybrid`` and
``vlm``; hymba-style meta tokens and qwen2-vl's M-RoPE on text positions
included) and the whisper encoder-decoder (``encdec``: batches of
``frames``, ``dec_tokens`` and ``labels``; caches ``{'self', 'cross'}``).
The spatial-filter config (``filter``) is no model: ``build`` refuses it,
as the reference does, and ``repro_torch.core`` serves it.
``cache_abstract`` and ``input_specs`` are the reference's
``ShapeDtypeStruct`` trees as ``meta`` tensors (shapes and dtypes, no
storage: the dry run's inputs, ``launch/dryrun.py``); ``cache_axes``
gives the logical axes the decode profile shards the caches by. The
reference has no
generation loop, and neither has the port: a caller runs
``decode_step`` once per token.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import module as mod
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whisper_mod
from repro_torch.models.layers import embed, logits_of, unembed
from repro_torch.sharding.tp import Parts, Seq
from repro_torch.training.loss import (ce_loss, chunked_ce_from_hidden,
                                       split_ce_loss)

META = "meta_tokens"


@dataclasses.dataclass
class ModelBundle:
    cfg: RunConfig
    specs: Any
    device: torch.device
    init_params: Callable       # (generator, dtype) -> params
    train_forward: Callable     # (params, batch) -> (logits, aux)
    loss_fn: Callable           # (params, batch, ...) -> (loss, (aux, denom))
    prefill: Callable           # (params, batch, tp) -> (last logits, caches)
    decode_step: Callable       # (params, inp, caches, cur, tp) -> ...
    cache_init: Callable        # (batch, seq_len) -> caches
    cache_abstract: Callable    # (batch, seq_len) -> meta caches
    cache_axes: Callable        # () -> the caches' logical axes
    input_specs: Callable       # (kind) -> {name: meta tensor}


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _init_params(specs, device: torch.device) -> Callable:
    def init_params(generator: torch.Generator,
                    dtype: torch.dtype = torch.float32):
        """Random parameters from ``generator`` (on the bundle's device)."""
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, bundle on "
                             f"{device}")
        return mod.init_params(specs, generator, dtype)
    return init_params


def _lm_bundle(rc: RunConfig, device: torch.device) -> ModelBundle:
    mc = rc.model
    specs = tfm.model_specs(mc)
    M = mc.num_meta_tokens
    dt = tfm.model_dtype(mc)
    init_params = _init_params(specs, device)

    def _with_meta(params, x, positions):
        """Prepend learnable meta tokens (hymba); shift positions by M."""
        B = x.shape[0]
        meta = params[META].to(x.dtype)[None].expand(B, M, x.shape[-1])
        mpos = torch.arange(M, dtype=positions.dtype,
                            device=x.device)[None].expand(B, M)
        return (torch.cat([meta, x], dim=1),
                torch.cat([mpos, positions + M], dim=1))

    def _prompt(params, batch, tp=None):
        """The prompt's inputs and [B, S(+M)] positions from 0, the meta
        tokens prepended."""
        inputs = torch.as_tensor(batch["inputs"], device=device)
        B, S = inputs.shape[0], inputs.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=device)[None].expand(B, S)
        if M:
            table = params["embed"]["table"]
            if isinstance(table, Parts) and tp.seq_spans(S + M):
                table = table[0]        # train_sp: whole at every member
            x = (embed(inputs, {"table": table}, dt, tp)
                 if inputs.ndim == 2 else inputs.to(dt))
            inputs, positions = _with_meta(params, x, positions)
        return inputs, positions

    def train_forward(params, batch, remat_policy: str = "none"):
        """The cache-less forward: [B,S] tokens (or [B,S,D] embeddings)
        in ``batch['inputs']`` -> ([B,S,V] logits, the aux loss summed
        over layers: moe's load-balance loss, 0 for the other kinds)."""
        inputs, positions = _prompt(params, batch)
        logits, _, aux = tfm.forward(params, inputs, positions, mc,
                                     remat_policy=remat_policy)
        if M:
            logits = logits[:, M:]
        return logits, aux

    def loss_fn(params, batch, remat_policy: str = "none",
                loss_chunk: int = 2048, z_loss: float = 0.0,
                aux_weight: float = 0.01, tp=None):
        """Mean next-token CE of ``batch['labels']`` [B,S] (``IGNORE``
        skipped) from the cache-less forward of ``batch['inputs']``, the
        head projected per ``loss_chunk`` positions, the meta tokens'
        hidden states dropped first. Returns (loss + aux_weight · aux,
        (aux, the count of labels)). ``tp``: the mesh train step's
        tensor-parallel group (``tfm.forward``; the loss then
        vocabulary-parallel)."""
        inputs, positions = _prompt(params, batch, tp)
        hidden, _, aux = tfm.forward(params, inputs, positions, mc,
                                     remat_policy=remat_policy, logits=False,
                                     tp=tp)
        if M:
            hidden = (drop_front(hidden, M, tp) if isinstance(hidden, Seq)
                      else hidden[:, M:])
        if mc.tie_embeddings:
            head_w, tr = params["embed"]["table"], True
        else:
            head_w, tr = params["head"]["w"], False
        labels = torch.as_tensor(batch["labels"], device=device)
        loss, denom = chunked_ce_from_hidden(
            hidden, head_w, labels, chunk=loss_chunk, z_loss=z_loss,
            transpose_head=tr, tp=tp)
        return loss + aux_weight * aux, (aux, denom)

    def cache_init(batch: int, seq_len: int):
        """Empty caches for ``batch`` streams of up to ``seq_len`` tokens
        (the meta tokens' slots added)."""
        return tfm.cache_init(mc, batch, seq_len + M, device=device)

    def prefill(params, batch, tp=None, caches=None):
        """The prompt ([B,S] tokens or [B,S,D] embeddings) into fresh
        caches sized ``rc.shape.seq_len`` (+ M). Returns ([B,V] logits of
        the last position, caches). Only the last position is projected
        to the vocabulary (the reference's stream-out discipline).
        ``tp`` (serving on a mesh, ``sharding/serve.py``): a data-parallel
        rank's tensor-parallel group (``tfm.forward``), and ``caches`` the
        rank's empty caches as the mesh holds them."""
        if tp is not None and caches is None:
            raise ValueError("a prefill on a mesh writes the caches the mesh "
                             "holds: pass the rank's caches")
        inputs, positions = _prompt(params, batch, tp)
        if caches is None:
            caches = cache_init(inputs.shape[0], rc.shape.seq_len)
        hidden, caches, _ = tfm.forward(params, inputs, positions, mc,
                                        caches=caches, cur=0, logits=False,
                                        tp=tp)
        if isinstance(hidden, Seq):     # the last token, on the last member
            last = tp.exchange(hidden.tensors[-1][:, -1], tp.n - 1, 0)
        else:
            last = hidden[:, -1]
        logits = logits_of(last, params, mc.tie_embeddings, tp)
        return logits, caches

    def decode_step(params, inp, caches, cur: int, tp=None):
        """One token per stream: ``inp`` [B,1] tokens (or [B,1,D]
        embeddings) at absolute position ``cur`` (a Python int; with meta
        tokens, the prompt's length + M for the first step). The caches
        are written in place. Returns ([B,V] logits, caches). ``tp``: as
        ``prefill``'s, the caches the rank's as the mesh holds them."""
        cur = operator.index(cur)
        inp = torch.as_tensor(inp, device=device)
        positions = torch.full((inp.shape[0], 1), cur, dtype=torch.int32,
                               device=device)
        logits, caches, _ = tfm.forward(params, inp, positions, mc,
                                        caches=caches, cur=cur, tp=tp)
        return logits[:, -1], caches

    def cache_abstract(batch: int, seq_len: int):
        return tfm.cache_init(mc, batch, seq_len + M, device="meta")

    def input_specs(kind: str):
        """The batch of a ``kind`` ('train', 'prefill', 'decode') cell at
        ``rc.shape``, as ``meta`` tensors."""
        B, S = rc.shape.global_batch, rc.shape.seq_len
        if mc.embeddings_in:
            tok, one = _meta((B, S, mc.d_model), dt), _meta((B, 1, mc.d_model),
                                                          dt)
        else:
            tok, one = _meta((B, S), torch.int32), _meta((B, 1), torch.int32)
        if kind == "train":
            return {"inputs": tok, "labels": _meta((B, S), torch.int32)}
        if kind == "prefill":
            return {"inputs": tok}
        if kind == "decode":
            return {"inputs": one}
        raise ValueError(kind)

    return ModelBundle(cfg=rc, specs=specs, device=device,
                       init_params=init_params, train_forward=train_forward,
                       loss_fn=loss_fn, prefill=prefill,
                       decode_step=decode_step, cache_init=cache_init,
                       cache_abstract=cache_abstract,
                       cache_axes=lambda: tfm.cache_logical_axes(mc),
                       input_specs=input_specs)


# ---------------------------------------------------------------------------
# Whisper (enc-dec)
# ---------------------------------------------------------------------------


def _whisper_bundle(rc: RunConfig, device: torch.device) -> ModelBundle:
    mc = rc.model
    specs = whisper_mod.model_specs(mc)

    def _positions(B: int, T: int):
        return torch.arange(T, dtype=torch.int32,
                            device=device)[None].expand(B, T)

    def _decoded(params, batch, remat_policy, tp=None, logits=True):
        """``batch['frames']`` [B,S_enc,D] through the encoder and its
        cross K/V, ``batch['dec_tokens']`` [B,T] through the decoder:
        the logits, or the final hidden states."""
        frames = torch.as_tensor(batch["frames"], device=device)
        tokens = torch.as_tensor(batch["dec_tokens"], device=device)
        enc = whisper_mod.encode(params, frames, mc,
                                 remat_policy=remat_policy, tp=tp)
        xkv = whisper_mod.cross_kv(params, enc, mc, tp=tp)
        B, T = tokens.shape
        out, _ = whisper_mod.decode(params, tokens, _positions(B, T), xkv,
                                    mc, remat_policy=remat_policy, tp=tp,
                                    logits=logits)
        return out

    def train_forward(params, batch, remat_policy: str = "none"):
        """The cache-less forward: ``batch['frames']`` [B,S_enc,D] through
        the encoder, ``batch['dec_tokens']`` [B,T] through the decoder.
        Returns ([B,T,V] logits, a float32 0-d zero: no aux loss)."""
        logits = _decoded(params, batch, remat_policy)
        return logits, torch.zeros((), dtype=torch.float32, device=device)

    def loss_fn(params, batch, remat_policy: str = "none",
                loss_chunk: int = 2048, z_loss: float = 0.0,
                aux_weight: float = 0.01, tp=None):
        """Mean CE of ``batch['labels']`` [B,T] over the whole logit plane
        (``ce_loss``, as the reference; ``loss_chunk`` and ``aux_weight``
        are the LM bundle's arguments, unused here). ``tp``: the mesh
        train step's tensor-parallel group; with the tied table split by
        vocabulary the loss is vocabulary-parallel (``split_ce_loss``:
        the same function, its sums over the vocabulary blocks). Returns
        (loss, (0, the count of labels))."""
        hidden = _decoded(params, batch, remat_policy, tp, logits=False)
        labels = torch.as_tensor(batch["labels"], device=device)
        table = params["embed"]["table"]
        if isinstance(table, Parts):
            loss, denom = split_ce_loss(hidden, table, labels, z_loss,
                                        transpose_head=True, tp=tp)
        else:
            loss, denom = ce_loss(unembed(hidden, params["embed"]), labels,
                                  z_loss)
        return loss, (torch.zeros((), dtype=torch.float32, device=device),
                      denom)

    def cache_init(batch: int, seq_len: int):
        """Empty caches: the decoder's self rings and a zero cross cache
        for ``seq_len`` encoder frames."""
        return {"self": whisper_mod.self_cache_init(mc, batch, device=device),
                "cross": whisper_mod.cross_cache_init(mc, batch, seq_len,
                                                      device=device)}

    def prefill(params, batch, tp=None, caches=None):
        """Encode ``batch['frames']`` once, build the cross K/V, and run
        the decoder prompt ``batch['dec_tokens']`` [B,T0] into fresh self
        caches. Returns ([B,V] logits of the prompt's last position,
        {'self', 'cross'}). ``caches`` (serving on a mesh): the empty
        caches the mesh holds, written in place; ``tp`` (with it the
        caches as ``attention.KVBlocks``): the rank's tensor-parallel
        group (``whisper.decode``)."""
        if tp is not None and caches is None:
            raise ValueError("a prefill on a mesh writes the caches the mesh "
                             "holds: pass the rank's caches")
        frames = torch.as_tensor(batch["frames"], device=device)
        sot = torch.as_tensor(batch["dec_tokens"], device=device)
        enc = whisper_mod.encode(params, frames, mc, tp=tp)
        xkv = whisper_mod.cross_kv(params, enc, mc, tp=tp, cache=(
            None if tp is None else caches["cross"]))
        B, T0 = sot.shape
        self_c = (whisper_mod.self_cache_init(mc, B, device=device)
                  if caches is None else caches["self"])
        logits, self_c = whisper_mod.decode(params, sot, _positions(B, T0),
                                            xkv, mc, self_caches=self_c,
                                            cur=0, tp=tp)
        if caches is not None:
            if tp is None:
                tfm._store(caches["cross"], xkv)
            xkv = caches["cross"]
        return logits[:, -1], {"self": self_c, "cross": xkv}

    def decode_step(params, inp, caches, cur: int, tp=None):
        """One token per stream: ``inp`` [B,1] at absolute position
        ``cur`` (a Python int), against the cross cache; the self rings
        are written in place. Returns ([B,V] logits, caches). ``tp``: as
        ``prefill``'s."""
        cur = operator.index(cur)
        inp = torch.as_tensor(inp, device=device)
        positions = torch.full((inp.shape[0], 1), cur, dtype=torch.int32,
                               device=device)
        logits, _ = whisper_mod.decode(params, inp, positions,
                                       caches["cross"], mc,
                                       self_caches=caches["self"], cur=cur,
                                       tp=tp)
        return logits[:, -1], caches

    def cache_abstract(batch: int, seq_len: int):
        return {"self": whisper_mod.self_cache_init(mc, batch, device="meta"),
                "cross": whisper_mod.xkv_abstract(mc, batch, seq_len)}

    def cache_axes():
        kv = {"k": (None, "act_batch", "cache_seq", None, None),
              "v": (None, "act_batch", "cache_seq", None, None),
              "pos": (None, "cache_seq")}
        xkv = {"k": (None, "act_batch", "cache_seq", None, None),
               "v": (None, "act_batch", "cache_seq", None, None)}
        return {"self": kv, "cross": xkv}

    def input_specs(kind: str):
        """The batch of a ``kind`` cell at ``rc.shape`` (``seq_len``
        encoder frames; ``max_target_positions`` decoder tokens to train,
        an 8-token prompt to prefill), as ``meta`` tensors."""
        B, S = rc.shape.global_batch, rc.shape.seq_len
        frames = _meta((B, S, mc.d_model), tfm.model_dtype(mc))
        T = mc.max_target_positions
        if kind == "train":
            return {"frames": frames,
                    "dec_tokens": _meta((B, T), torch.int32),
                    "labels": _meta((B, T), torch.int32)}
        if kind == "prefill":
            return {"frames": frames, "dec_tokens": _meta((B, 8), torch.int32)}
        if kind == "decode":
            return {"inputs": _meta((B, 1), torch.int32)}
        raise ValueError(kind)

    return ModelBundle(cfg=rc, specs=specs, device=device,
                       init_params=_init_params(specs, device),
                       train_forward=train_forward, loss_fn=loss_fn,
                       prefill=prefill, decode_step=decode_step,
                       cache_init=cache_init, cache_abstract=cache_abstract,
                       cache_axes=cache_axes, input_specs=input_specs)


def drop_front(hidden: Seq, M: int, tp) -> Seq:
    """The hidden states of ``train_sp``'s token blocks without their
    first ``M`` (hymba's meta tokens), split again over the group: put
    together on the first member, cut, and scattered."""
    whole = tp.gather(hidden, [0])[0][:, M:]
    spans = tp.seq_spans(whole.shape[1])
    return whole if spans is None else tp.split(whole, spans)


def tp_plan(rc: RunConfig, tp):
    """The mesh plan for a tensor-parallel group ``tp``
    (``transformer.tp_plan``, whisper's ``whisper.tp_plan``; where the
    group splits the caches' sequence, for caches of ``rc.shape.seq_len``
    tokens and the meta tokens, or whisper's cross cache of that many
    frames)."""
    seq = rc.shape.seq_len + rc.model.num_meta_tokens
    if rc.model.family == "encdec":
        return whisper_mod.tp_plan(
            rc.model, tp, seq if tp.ctx.profile == "decode" else None)
    return tfm.tp_plan(rc.model, tp, seq)


def build(rc: RunConfig, device="cuda") -> ModelBundle:
    """The bundle of ``rc``'s model on ``device`` (the card unless the
    caller passes ``device='cpu'``; no card raises; ``'meta'``: shapes
    only, for the dry run)."""
    if rc.model.family == "filter":
        raise ValueError("the spatial-filter config is served by "
                         "repro_torch.core, see examples/video_pipeline.py")
    dev = (torch.device("meta") if torch.device(device).type == "meta"
           else resolve_device(device))
    if rc.model.family == "encdec":
        return _whisper_bundle(rc, dev)
    return _lm_bundle(rc, dev)
