"""Shared layers (plain functions over ParamSpec-described params), as in
the reference's ``models/layers.py``. Every use casts its float32
parameter to the activation dtype, except norm scales, which apply in
float32."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.module import p


# -- norms -------------------------------------------------------------------

def rms_norm_specs(d: int):
    return {"scale": p((d,), ("embed",), init="ones")}


def rms_norm(x: torch.Tensor, params, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layer_norm_specs(d: int):
    return {"scale": p((d,), ("embed",), init="ones"),
            "bias": p((d,), ("embed",), init="zeros")}


def layer_norm(x: torch.Tensor, params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 with the biased variance (``jnp.var``'s ddof
    0, not ``torch.var``'s default correction of 1)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


# -- gated MLP (SwiGLU) -------------------------------------------------------

def mlp_specs(d: int, f: int):
    return {
        "wi": p((d, f), ("embed", "mlp")),
        "wg": p((d, f), ("embed", "mlp")),
        "wo": p((f, d), ("mlp", "embed")),
    }


def mlp(x: torch.Tensor, params, act=F.silu) -> torch.Tensor:
    h = x @ params["wi"].to(x.dtype)
    g = x @ params["wg"].to(x.dtype)
    return (act(g) * h) @ params["wo"].to(x.dtype)


def mlp2_specs(d: int, f: int):
    """Ungated 2-matrix MLP with biases (whisper's GELU MLP)."""
    return {"wi": p((d, f), ("embed", "mlp")),
            "bi": p((f,), ("mlp",), init="zeros"),
            "wo": p((f, d), ("mlp", "embed")),
            "bo": p((d,), ("embed",), init="zeros")}


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation; F.gelu's is erf
    return F.gelu(x, approximate="tanh")


def mlp2(x: torch.Tensor, params, act=_gelu_tanh) -> torch.Tensor:
    h = act(x @ params["wi"].to(x.dtype) + params["bi"].to(x.dtype))
    return h @ params["wo"].to(x.dtype) + params["bo"].to(x.dtype)


# -- embedding ----------------------------------------------------------------

def embed_specs(vocab: int, d: int):
    return {"table": p((vocab, d), ("vocab", "embed"), init="embed")}


def embed(tokens: torch.Tensor, params,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    # gather, then cast: the cast is element by element, so this equals
    # casting the whole table first, without reading all of it per call
    return params["table"][tokens].to(dtype)


def unembed(x: torch.Tensor, params) -> torch.Tensor:
    """Logits from hidden states: [.., d] @ [vocab, d]^T."""
    return x @ params["table"].to(x.dtype).t()


def head_specs(d: int, vocab: int):
    return {"w": p((d, vocab), ("embed", "vocab"))}


def lm_head(x: torch.Tensor, params) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


# -- depthwise causal conv1d (plain path; CUDA kernel in kernels/dwconv1d) ----

def dwconv1d_specs(channels: int, k: int):
    return {"w": p((channels, k), ("ssm_inner", "conv")),
            "b": p((channels,), ("ssm_inner",), init="zeros")}


def dwconv1d(x: torch.Tensor, params,
             state: Optional[torch.Tensor] = None):
    """Causal depthwise conv. x: [B, S, C]; state: [B, k-1, C] carry (the
    last k-1 inputs of the stream so far) or None (zero history).

    Returns (y, new_state): the taps accumulated as shifted multiplies, no
    patch materialisation; new_state is the last k-1 rows of [state; x]."""
    w = params["w"].to(x.dtype)                  # [C, k]
    k = w.shape[1]
    B, S, C = x.shape
    if state is None:
        state = x.new_zeros((B, k - 1, C))
    xp = torch.cat([state, x], dim=1)            # [B, S+k-1, C]
    y = torch.zeros_like(x)
    for i in range(k):                           # k is small (4): unrolled
        y = y + xp[:, i:i + S, :] * w[:, i]
    new_state = xp[:, xp.shape[1] - (k - 1):, :]
    return y + params["b"].to(x.dtype), new_state
