"""Rotary position embeddings, standard RoPE and Qwen2-VL's M-RoPE, as in
the reference's ``models/rope.py``: float32 angles and rotation, cast
back.

M-RoPE splits the head_dim/2 frequency channels into (t, h, w) sections
and rotates each section by its own positional stream; text tokens carry
three equal streams and reduce exactly to standard RoPE.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: [..., S] int -> cos/sin [..., S, head_dim//2] float32."""
    ang = positions[..., None].float() * _freqs(head_dim, theta,
                                                positions.device)
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: [3, ..., S] int (the t, h, w streams); ``sections`` sum
    to head_dim//2. -> cos/sin [..., S, head_dim//2] float32, channel
    block i rotated by stream i."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"sections {sections} do not sum to head_dim/2 = "
                         f"{head_dim // 2}")
    ang_all = positions[..., None].float() * _freqs(head_dim, theta,
                                                    positions.device)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[i, ..., start:start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang), torch.sin(ang)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """Text-only input: three equal streams. positions [...] -> [3, ...]."""
    return positions[None].expand((3,) + tuple(positions.shape))


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; cos/sin: [B, S, D//2] or [S, D//2] (broadcast)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if cos.ndim == 2:  # [S, half] -> broadcast over batch and heads
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:              # [B, S, half]
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
