"""Checkpointing with atomic publish and async save, on the reference's
on-disk layout (``checkpoint/store.py``), so each package reads the
other's checkpoints.

Layout:  <dir>/step_<N>/
           manifest.json        {path -> {file, shape, dtype}} + metadata
           <flat-key>.npy       one file per leaf
         <dir>/step_<N>.tmp     staging dir, renamed atomically on publish

Keys join the tree's path with ``::``; list and tuple entries (the
optimiser state's named tuple included) are ``#i``. numpy has no
bfloat16: a bfloat16 leaf is widened to float32 (exact) and its dtype
recorded, and restores as bfloat16.

Leaves are stored as logical (unsharded) arrays: a sharded leaf
(``sharding.placement.ShardedTensor``) is gathered to the host first.
``restore_checkpoint`` puts each leaf on the device of the template's
leaf in its place, or, given ``shardings``, places it by the
``NamedSharding`` in its place: that is the elastic restart (the
checkpoint has no memory of the mesh that wrote it). The reference's
trainer computes such a tree and never passes it (its
``trainer.py:49-54``), and its ``restore_checkpoint`` pairs flat leaves
with flat shardings (``store.py:112-117``), which with ``{'params': …,
'opt': None}`` would pair the optimiser's leaves (they sort first) with
the parameters' shardings. Here ``shardings`` is a tree shaped like the
template, walked with it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.module import tree_map
from repro_torch.sharding.placement import NamedSharding, ShardedTensor

SEP = "::"


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, prefix + (f"#{i}",)))
    elif tree is None:
        pass
    else:
        out[SEP.join(prefix)] = tree
    return out


def _unflatten_into(template, flat: Dict[str, Any], prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten_into(v, flat, prefix + (f"#{i}",))
               for i, v in enumerate(template)]
        return type(template)(seq) if not hasattr(template, "_fields") \
            else type(template)(*seq)
    if template is None:
        return None
    return flat[SEP.join(prefix)]


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array, dtype name): bfloat16 widened to float32, named
    ``bfloat16``."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    if not torch.is_tensor(leaf):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    metadata: Optional[Dict] = None) -> str:
    """Write a checkpoint atomically; returns the published path."""
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "metadata": metadata or {}}
    for key, leaf in flat.items():
        arr, dtype = _to_numpy(leaf)
        fn = key.replace("/", "_") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)            # atomic publish
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, template, *, step: Optional[int] = None,
                       shardings=None) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` (a tree of tensors or
    ``ShardedTensor``s): each leaf as a tensor of its recorded dtype on
    the device of the template's leaf (a sharded template leaf: placed as
    it is). ``shardings``, a tree shaped like ``template``, places a leaf
    by the ``NamedSharding`` in its place; a ``None`` there (a leaf or a
    whole subtree) keeps the template's placement. Returns (tree,
    step)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for key, info in manifest["leaves"].items():
        t = torch.from_numpy(np.load(os.path.join(path, info["file"])))
        if info["dtype"] == "bfloat16":
            t = t.to(torch.bfloat16)
        flat[key] = t
    tree = _unflatten_into(template, flat)
    return _place(tree, template, shardings), step


def _place(tree, template, shardings):
    """Each leaf of ``tree`` by its sharding, else as its template leaf."""
    if isinstance(shardings, NamedSharding):
        return shardings.shard(tree)
    if shardings is None:
        def place(t, like):
            if isinstance(like, ShardedTensor):
                return like.sharding.shard(t)
            return t.to(like.device) if torch.is_tensor(like) else t
        return tree_map(place, tree, template)
    if isinstance(tree, dict):
        return {k: _place(v, template[k], shardings[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [_place(v, t, s) for v, t, s in zip(tree, template, shardings)]
        return type(tree)(*seq) if hasattr(tree, "_fields") \
            else type(tree)(seq)
    raise ValueError(f"shardings {shardings!r} for the leaf {tree!r}")


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at-most-one in flight.

    ``save`` snapshots to host memory synchronously and publishes on the
    worker thread, so the train loop never blocks on the filesystem.
    The snapshot is a copy of every leaf (a sharded leaf gathered): the
    port's parameters and optimiser state are updated in place, and a CPU
    tensor's ``numpy()`` shares its memory, so without the copy the next
    step would tear the checkpoint being written. ``wait()`` drains
    (called before exit and by the preemption handler)."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None

    def save(self, step: int, tree, metadata=None):
        self.wait()

        def snapshot(x):
            if isinstance(x, ShardedTensor):
                return x.gather("cpu", copy=True)
            if torch.is_tensor(x):
                return x.detach().to("cpu", copy=True)
            return np.array(x)
        host_tree = tree_map(snapshot, tree)

        def work():
            save_checkpoint(self.ckpt_dir, step, host_tree,
                            metadata=metadata)
            self.last_saved = step

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
