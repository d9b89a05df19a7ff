"""int8 error-feedback gradient compression, as in the reference's
``optim/compression.py``: quantise g + err to int8 with one float32 scale
per tensor and carry the quantisation residual into the next step (error
feedback keeps the scheme unbiased in the long run).

The data-parallel step that reduces the compressed gradients over the
slow 'pod' axis is ``training/dp_shardmap.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.module import tree_leaves, tree_map


def int8_ef_compress(g: torch.Tensor, err: torch.Tensor, fma: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantise g+err to int8. Returns (q, scale, new_err). The division
    is in float32 and ``torch.round`` rounds half to even, as ``jnp.round``
    does, so ``q`` equals the reference's bit for bit. ``new_err`` is
    ``gf - q * scale`` rounded after each operation, as the reference's
    function gives run alone; with ``fma`` it is rounded once, as XLA
    compiles it inside a jitted step (the multiply and subtract contracted
    into one FMA; the reference's data-parallel step): the product is
    exact in float64 (8 bits times 24) and so is the difference, which is
    then rounded to float32."""
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    if fma:
        new_err = (gf.double() - q.double() * scale.double()).float()
    else:
        new_err = gf - q.float() * scale
    return q, scale, new_err


def int8_ef_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, errs):
    """Tree-mapped compress: returns (q_tree, scale_tree, err_tree)."""
    outs = [int8_ef_compress(g, e)
            for g, e in zip(tree_leaves(grads), tree_leaves(errs))]
    trees = []
    for i in range(3):
        it = iter(o[i] for o in outs)
        trees.append(tree_map(lambda _, it=it: next(it), grads))
    return tuple(trees)
