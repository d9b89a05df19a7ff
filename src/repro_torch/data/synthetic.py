"""Deterministic synthetic data pipelines, as in the reference's
``data/synthetic.py``; the numpy arrays are the reference's bit for bit.

Tokens are a counter-mode hash of (seed, step, position) — any host can
materialise exactly its shard of any batch without coordination: the
pipeline has no state beyond the step number (restart at step N
reproduces batch N). ``make_train_batch`` builds the batch on the host
and hands it to the device through pinned memory, or, given a mesh and
its batch shardings, places it: each coordinate gets the rows
``jax.device_put`` of the same global batch gives it (pod-major over
('pod', 'data'), ``placement.NamedSharding``). One process drives every
coordinate, so the global batch is built once on the host, where the
reference's hosts each build only their rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.device import resolve_device, to_device


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """xorshift-mult avalanche over uint32 (vectorised, deterministic)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x7feb352d)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(0x846ca68b)) & np.uint32(0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    return x


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_np(self, step: int, lo: int = 0, hi: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        """Rows [lo, hi) of global batch ``step`` (host shard)."""
        hi = self.global_batch if hi is None else hi
        rows = np.arange(lo, hi, dtype=np.uint32)[:, None]
        cols = np.arange(self.seq_len + 1, dtype=np.uint32)[None, :]
        base = (np.uint32(self.seed) * np.uint32(2654435761)
                + np.uint32(step) * np.uint32(97531))
        h = _hash_u32(base + rows * np.uint32(131071) + cols)
        toks = (h % np.uint32(self.vocab_size)).astype(np.int32)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class SyntheticFrames:
    """Deterministic image/video frames (for the filter pipeline + stubs)."""
    height: int
    width: int
    channels: int = 1
    seed: int = 0

    def frame_np(self, index: int) -> np.ndarray:
        yy = np.arange(self.height, dtype=np.uint32)[:, None, None]
        xx = np.arange(self.width, dtype=np.uint32)[None, :, None]
        cc = np.arange(self.channels, dtype=np.uint32)[None, None, :]
        h = _hash_u32(np.uint32(self.seed + index * 7919)
                      + yy * np.uint32(31337) + xx * np.uint32(271)
                      + cc * np.uint32(77))
        # smooth-ish content: blend hash noise with gradients
        noise = (h % 256).astype(np.float32) / 255.0
        gx = np.linspace(0, 1, self.width, dtype=np.float32)[None, :, None]
        gy = np.linspace(0, 1, self.height, dtype=np.float32)[:, None, None]
        return 0.5 * noise + 0.25 * gx + 0.25 * gy


def video_stream(h: int, w: int, c: int = 1, seed: int = 0):
    """Infinite deterministic frame generator."""
    src = SyntheticFrames(h, w, c, seed)
    i = 0
    while True:
        yield src.frame_np(i)
        i += 1


def make_train_batch(rc: RunConfig, step: int, device, mesh=None,
                     batch_sharding=None) -> Dict[str, torch.Tensor]:
    """The global batch for ``step`` on ``device``: tokens and labels, or
    for stub-frontend configs (``embeddings_in``) float32 embeddings and
    labels, or for enc-dec configs frames, decoder tokens and labels.
    With ``mesh`` and ``batch_sharding`` (a ``NamedSharding``, or a dict of
    them by key) each array is placed by its sharding instead
    (``ShardedTensor``s; ``device`` is then unused)."""
    mc, sh = rc.model, rc.shape
    if mc.family == "encdec":
        # frames + decoder tokens
        toks = SyntheticTokens(mc.vocab_size, mc.max_target_positions,
                               sh.global_batch, rc.train.seed)
        tb = toks.batch_np(step)
        rng = np.random.default_rng(rc.train.seed + step)
        frames = rng.standard_normal(
            (sh.global_batch, sh.seq_len, mc.d_model)).astype(np.float32)
        batch_np = {"frames": frames, "dec_tokens": tb["inputs"],
                    "labels": tb["labels"]}
    elif mc.embeddings_in:
        rng = np.random.default_rng(rc.train.seed + step)
        emb = rng.standard_normal(
            (sh.global_batch, sh.seq_len, mc.d_model)).astype(np.float32)
        toks = SyntheticTokens(mc.vocab_size, sh.seq_len, sh.global_batch,
                               rc.train.seed)
        batch_np = {"inputs": emb,
                    "labels": toks.batch_np(step)["labels"]}
    else:
        toks = SyntheticTokens(mc.vocab_size, sh.seq_len, sh.global_batch,
                               rc.train.seed)
        batch_np = toks.batch_np(step)
    if mesh is not None and batch_sharding is not None:
        out = {}
        for k, v in batch_np.items():
            sharding = (batch_sharding[k] if isinstance(batch_sharding, dict)
                        else batch_sharding)
            first = sharding.mesh.devices.flat[0]
            out[k] = sharding.shard(to_device(v, first))
        return out
    dev = resolve_device(device)
    return {k: to_device(v, dev) for k, v in batch_np.items()}
