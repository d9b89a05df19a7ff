"""Model registry: one bundle per architecture family, as in the
reference's ``models/registry.py``.

``build(run_config, device='cuda')`` returns a :class:`ModelBundle` with

  init_params(generator, dtype)        -> params (on the bundle's device)
  train_forward(params, batch)         -> (logits, aux_loss)
  loss_fn(params, batch, ...)          -> (loss, (aux_loss, denom))
  prefill(params, batch)               -> (last_logits, caches)
  decode_step(params, inp, caches, cur) -> (logits, caches)
  cache_init(batch, seq_len)           -> empty caches

for every family of the reference's model registry: the decoder LMs
(``dense``, ``moe``, ``ssm`` — xLSTM's mLSTM and sLSTM —, ``hybrid`` and
``vlm``; hymba-style meta tokens and qwen2-vl's M-RoPE on text positions
included) and the whisper encoder-decoder (``encdec``: batches of
``frames``, ``dec_tokens`` and ``labels``; caches ``{'self', 'cross'}``).
The spatial-filter config (``filter``) is no model: ``build`` refuses it,
as the reference does, and ``repro_torch.core`` serves it.
``cache_init`` is the concrete twin of the reference's
``cache_abstract``. The abstract cache and its logical axes and
``input_specs`` wait for the sharding slice. The reference has no
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
from repro_torch.models.layers import embed, lm_head, unembed
from repro_torch.training.loss import ce_loss, chunked_ce_from_hidden

META = "meta_tokens"


@dataclasses.dataclass
class ModelBundle:
    cfg: RunConfig
    specs: Any
    device: torch.device
    init_params: Callable       # (generator, dtype) -> params
    train_forward: Callable     # (params, batch) -> (logits, aux)
    loss_fn: Callable           # (params, batch, ...) -> (loss, (aux, denom))
    prefill: Callable           # (params, batch) -> (last logits, caches)
    decode_step: Callable       # (params, inp, caches, cur) -> (logits, caches)
    cache_init: Callable        # (batch, seq_len) -> caches


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

    def _prompt(params, batch):
        """The prompt's inputs and [B, S(+M)] positions from 0, the meta
        tokens prepended."""
        inputs = torch.as_tensor(batch["inputs"], device=device)
        B, S = inputs.shape[0], inputs.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=device)[None].expand(B, S)
        if M:
            x = (embed(inputs, params["embed"], dt) if inputs.ndim == 2
                 else inputs.to(dt))
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
                aux_weight: float = 0.01):
        """Mean next-token CE of ``batch['labels']`` [B,S] (``IGNORE``
        skipped) from the cache-less forward of ``batch['inputs']``, the
        head projected per ``loss_chunk`` positions, the meta tokens'
        hidden states dropped first. Returns (loss + aux_weight · aux,
        (aux, the count of labels))."""
        inputs, positions = _prompt(params, batch)
        hidden, _, aux = tfm.forward(params, inputs, positions, mc,
                                     remat_policy=remat_policy, logits=False)
        if M:
            hidden = hidden[:, M:]
        if mc.tie_embeddings:
            head_w, tr = params["embed"]["table"], True
        else:
            head_w, tr = params["head"]["w"], False
        labels = torch.as_tensor(batch["labels"], device=device)
        loss, denom = chunked_ce_from_hidden(
            hidden, head_w, labels, chunk=loss_chunk, z_loss=z_loss,
            transpose_head=tr)
        return loss + aux_weight * aux, (aux, denom)

    def cache_init(batch: int, seq_len: int):
        """Empty caches for ``batch`` streams of up to ``seq_len`` tokens
        (the meta tokens' slots added)."""
        return tfm.cache_init(mc, batch, seq_len + M, device=device)

    def prefill(params, batch):
        """The prompt ([B,S] tokens or [B,S,D] embeddings) into fresh
        caches sized ``rc.shape.seq_len`` (+ M). Returns ([B,V] logits of
        the last position, caches). Only the last position is projected
        to the vocabulary (the reference's stream-out discipline)."""
        inputs, positions = _prompt(params, batch)
        caches = cache_init(inputs.shape[0], rc.shape.seq_len)
        hidden, caches, _ = tfm.forward(params, inputs, positions, mc,
                                        caches=caches, cur=0, logits=False)
        last = hidden[:, -1]
        logits = (unembed(last, params["embed"]) if mc.tie_embeddings
                  else lm_head(last, params["head"]))
        return logits, caches

    def decode_step(params, inp, caches, cur: int):
        """One token per stream: ``inp`` [B,1] tokens (or [B,1,D]
        embeddings) at absolute position ``cur`` (a Python int; with meta
        tokens, the prompt's length + M for the first step). The caches
        are written in place. Returns ([B,V] logits, caches)."""
        cur = operator.index(cur)
        inp = torch.as_tensor(inp, device=device)
        positions = torch.full((inp.shape[0], 1), cur, dtype=torch.int32,
                               device=device)
        logits, caches, _ = tfm.forward(params, inp, positions, mc,
                                        caches=caches, cur=cur)
        return logits[:, -1], caches

    return ModelBundle(cfg=rc, specs=specs, device=device,
                       init_params=init_params, train_forward=train_forward,
                       loss_fn=loss_fn, prefill=prefill,
                       decode_step=decode_step, cache_init=cache_init)


# ---------------------------------------------------------------------------
# Whisper (enc-dec)
# ---------------------------------------------------------------------------


def _whisper_bundle(rc: RunConfig, device: torch.device) -> ModelBundle:
    mc = rc.model
    specs = whisper_mod.model_specs(mc)

    def _positions(B: int, T: int):
        return torch.arange(T, dtype=torch.int32,
                            device=device)[None].expand(B, T)

    def train_forward(params, batch, remat_policy: str = "none"):
        """The cache-less forward: ``batch['frames']`` [B,S_enc,D] through
        the encoder, ``batch['dec_tokens']`` [B,T] through the decoder.
        Returns ([B,T,V] logits, a float32 0-d zero: no aux loss)."""
        frames = torch.as_tensor(batch["frames"], device=device)
        tokens = torch.as_tensor(batch["dec_tokens"], device=device)
        enc = whisper_mod.encode(params, frames, mc,
                                 remat_policy=remat_policy)
        xkv = whisper_mod.cross_kv(params, enc, mc)
        B, T = tokens.shape
        logits, _ = whisper_mod.decode(params, tokens, _positions(B, T), xkv,
                                       mc, remat_policy=remat_policy)
        return logits, torch.zeros((), dtype=torch.float32, device=device)

    def loss_fn(params, batch, remat_policy: str = "none",
                loss_chunk: int = 2048, z_loss: float = 0.0,
                aux_weight: float = 0.01):
        """Mean CE of ``batch['labels']`` [B,T] over the whole logit plane
        (``ce_loss``, as the reference; ``loss_chunk`` and ``aux_weight``
        are the LM bundle's arguments, unused here). Returns (loss, (0,
        the count of labels))."""
        logits, aux = train_forward(params, batch, remat_policy=remat_policy)
        labels = torch.as_tensor(batch["labels"], device=device)
        loss, denom = ce_loss(logits, labels, z_loss)
        return loss, (aux, denom)

    def cache_init(batch: int, seq_len: int):
        """Empty caches: the decoder's self rings and a zero cross cache
        for ``seq_len`` encoder frames."""
        return {"self": whisper_mod.self_cache_init(mc, batch, device=device),
                "cross": whisper_mod.cross_cache_init(mc, batch, seq_len,
                                                      device=device)}

    def prefill(params, batch):
        """Encode ``batch['frames']`` once, build the cross K/V, and run
        the decoder prompt ``batch['dec_tokens']`` [B,T0] into fresh self
        caches. Returns ([B,V] logits of the prompt's last position,
        {'self', 'cross'})."""
        frames = torch.as_tensor(batch["frames"], device=device)
        sot = torch.as_tensor(batch["dec_tokens"], device=device)
        enc = whisper_mod.encode(params, frames, mc)
        xkv = whisper_mod.cross_kv(params, enc, mc)
        B, T0 = sot.shape
        self_c = whisper_mod.self_cache_init(mc, B, device=device)
        logits, self_c = whisper_mod.decode(params, sot, _positions(B, T0),
                                            xkv, mc, self_caches=self_c,
                                            cur=0)
        return logits[:, -1], {"self": self_c, "cross": xkv}

    def decode_step(params, inp, caches, cur: int):
        """One token per stream: ``inp`` [B,1] at absolute position
        ``cur`` (a Python int), against the cross cache; the self rings
        are written in place. Returns ([B,V] logits, caches)."""
        cur = operator.index(cur)
        inp = torch.as_tensor(inp, device=device)
        positions = torch.full((inp.shape[0], 1), cur, dtype=torch.int32,
                               device=device)
        logits, _ = whisper_mod.decode(params, inp, positions,
                                       caches["cross"], mc,
                                       self_caches=caches["self"], cur=cur)
        return logits[:, -1], caches

    return ModelBundle(cfg=rc, specs=specs, device=device,
                       init_params=_init_params(specs, device),
                       train_forward=train_forward, loss_fn=loss_fn,
                       prefill=prefill, decode_step=decode_step,
                       cache_init=cache_init)


def build(rc: RunConfig, device="cuda") -> ModelBundle:
    """The bundle of ``rc``'s model on ``device`` (the card unless the
    caller passes ``device='cpu'``; no card raises)."""
    if rc.model.family == "filter":
        raise ValueError("the spatial-filter config is served by "
                         "repro_torch.core, see examples/video_pipeline.py")
    dev = resolve_device(device)
    if rc.model.family == "encdec":
        return _whisper_bundle(rc, dev)
    return _lm_bundle(rc, dev)
