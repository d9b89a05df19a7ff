"""Model registry: one bundle per architecture family, as in the
reference's ``models/registry.py``.

``build(run_config, device='cuda')`` returns a :class:`ModelBundle` with

  init_params(generator, dtype)   -> params (on the bundle's device)
  train_forward(params, batch)    -> (logits, aux_loss)

for the decoder-LM families. This slice ports the cache-less forward
(scoring a batch of sequences, forward only) of the ``dense`` family,
hymba-style meta tokens included. The loss, ``prefill``,
``decode_step`` and the caches, and the other families, wait for later
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import module as mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import embed

META = "meta_tokens"


@dataclasses.dataclass
class ModelBundle:
    cfg: RunConfig
    specs: Any
    device: torch.device
    init_params: Callable       # (generator, dtype) -> params
    train_forward: Callable     # (params, batch) -> (logits, aux)


def _lm_bundle(rc: RunConfig, device: torch.device) -> ModelBundle:
    mc = rc.model
    specs = tfm.model_specs(mc)
    M = mc.num_meta_tokens
    dt = tfm.model_dtype(mc)

    def init_params(generator: torch.Generator,
                    dtype: torch.dtype = torch.float32):
        """Random parameters from ``generator`` (on the bundle's device)."""
        if generator.device.type != device.type:
            raise ValueError(f"generator on {generator.device}, bundle on "
                             f"{device}")
        return mod.init_params(specs, generator, dtype)

    def _with_meta(params, x, positions):
        """Prepend learnable meta tokens (hymba); shift positions by M."""
        B = x.shape[0]
        meta = params[META].to(x.dtype)[None].expand(B, M, x.shape[-1])
        mpos = torch.arange(M, dtype=positions.dtype,
                            device=x.device)[None].expand(B, M)
        return (torch.cat([meta, x], dim=1),
                torch.cat([mpos, positions + M], dim=1))

    def train_forward(params, batch):
        """The cache-less forward: [B,S] tokens (or [B,S,D] embeddings)
        in ``batch['inputs']`` -> ([B,S,V] logits, aux loss 0)."""
        inputs = torch.as_tensor(batch["inputs"], device=device)
        B, S = inputs.shape[0], inputs.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=device)[None].expand(B, S)
        if M:
            x = (embed(inputs, params["embed"], dt) if inputs.ndim == 2
                 else inputs.to(dt))
            inputs, positions = _with_meta(params, x, positions)
        logits = tfm.forward(params, inputs, positions, mc)
        if M:
            logits = logits[:, M:]
        return logits, torch.zeros((), dtype=torch.float32, device=device)

    return ModelBundle(cfg=rc, specs=specs, device=device,
                       init_params=init_params, train_forward=train_forward)


def build(rc: RunConfig, device="cuda") -> ModelBundle:
    """The bundle of ``rc``'s model on ``device`` (the card unless the
    caller passes ``device='cpu'``; no card raises)."""
    dev = resolve_device(device)
    if rc.model.family in ("dense", "moe", "ssm", "hybrid", "vlm"):
        return _lm_bundle(rc, dev)
    raise NotImplementedError(f"family {rc.model.family!r} is not ported")
