"""Pipeline parallelism: the reference's GPipe schedule
(``training/pipeline.py``, a ``shard_map`` over a 'stage' mesh axis) on
a ``DeviceMesh`` with the one-controller collectives of
``sharding/collectives.py``.

The schedule runs T = M + P − 1 ticks; at tick t, stage s processes
microbatch t − s. Each tick's outputs move one stage up by a
``ppermute`` (s → s+1), and the last stage's buffer is replicated by a
``psum`` over the stages. The backward is autograd through the schedule:
the transposes of ``ppermute`` and ``psum`` run the wire the other way.

As in the reference, every stage runs every tick: stage 0 reads
microbatch ``clip(t, 0, M−1)`` on the drain ticks too, later stages run
on the zeros a ``ppermute`` gives before their first microbatch
arrives, and an invalid emit of the last stage writes the slot's old
value back. None of that reaches the output or the gradients; it is the
bubble, (P − 1) / (M + P − 1) of the stage-ticks. One process drives the
stages one after another, so on one card (stages on repeated entries)
the schedule takes the time of all of them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from repro_torch.models.module import tree_map
from repro_torch.sharding.collectives import (MeshValue, axis_index,
                                              ppermute, psum)
from repro_torch.sharding.mesh import DeviceMesh


def pipeline_apply(layer_fn: Callable, params_stacked, x_mb: torch.Tensor,
                   mesh: DeviceMesh, *, axis: str = "stage") -> torch.Tensor:
    """Run a stacked layer sequence as a GPipe pipeline over ``axis``.

    layer_fn(params_one_stage, x) -> y        (one stage's computation)
    params_stacked: leaves [P_stages, ...]; stage s's slice is used on the
    mesh's s-th ``axis`` entry (moved there, a view where it lies already).
    x_mb: [M, mb, ...] microbatched inputs.
    Returns [M, mb, ...] outputs on the device of the first ``axis`` entry
    (stage 0's), differentiable. The entries along the other axes of the
    mesh would compute the same values (the reference replicates over
    them); the schedule runs on their coordinate 0.
    """
    stages = mesh.sub(**{a: 0 for a in mesh.axis_names if a != axis})
    n_stage = stages.shape[axis]
    M = x_mb.shape[0]
    T = M + n_stage - 1
    sidx = axis_index(stages, axis)
    last = n_stage - 1
    per = stage_slices(params_stacked, n_stage)
    p_stage = {c: tree_map(lambda a, c=c: a.to(stages.device(c)), per[c[0]])
               for c in stages.coords()}
    x_on = {c: x_mb.to(stages.device(c)) for c in stages.coords()}
    fwd = [(i, i + 1) for i in range(n_stage - 1)]  # stage s -> s+1

    prev_out = MeshValue.build(stages, lambda c, dev: torch.zeros_like(
        x_on[c][0]))
    # the output buffer, one slot per microbatch at every stage
    out_buf = {c: [torch.zeros_like(x_on[c][0]) for _ in range(M)]
               for c in stages.coords()}
    for t in range(T):
        # stage-to-stage wire: the previous tick's output moves one stage up
        recv = ppermute(prev_out, axis, fwd)
        mb_idx = min(max(t, 0), M - 1)
        emit_idx = min(max(t - last, 0), M - 1)
        y = {}
        for c in stages.coords():
            x_in = x_on[c][mb_idx] if sidx[c] == 0 else recv[c]
            y[c] = layer_fn(p_stage[c], x_in)
            # the last stage emits microbatch t-(P-1) when it is valid;
            # otherwise the slot keeps its old value
            valid = t >= last and sidx[c] == last
            if valid:
                out_buf[c][emit_idx] = y[c]
        prev_out = MeshValue(stages, y)
    # replicate the result: only the last stage holds real outputs
    total = psum(MeshValue.build(
        stages, lambda c, dev: torch.stack(out_buf[c]) if sidx[c] == last
        else torch.zeros_like(x_on[c])), axis)
    return total[(0,)]


def stage_slices(params_stacked, n: int) -> List[Dict[str, Any]]:
    """Each stage's slice of a tree of stacked leaves, by one
    ``torch.unbind`` a leaf: the backward stacks the stages' gradients
    once (indexing a stage per slice would add a zero-filled copy of the
    whole leaf per stage)."""
    if isinstance(params_stacked, dict):
        per_key = {k: stage_slices(v, n) for k, v in params_stacked.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    out = list(params_stacked.unbind(0))
    if len(out) != n:
        raise ValueError(f"a leaf of {len(out)} stages for {n} stages")
    return out


def pipeline_loss_fn(layer_fn: Callable, loss_fn: Callable,
                     mesh: DeviceMesh, *, axis: str = "stage") -> Callable:
    """(params_stacked, x_mb, y_mb) -> scalar loss through the pipeline,
    on stage 0's device. Differentiable: its backward is the GPipe
    backward schedule."""
    def f(params_stacked, x_mb, y_mb):
        out = pipeline_apply(layer_fn, params_stacked, x_mb, mesh,
                             axis=axis)
        return loss_fn(out, y_mb.to(out.device))
    return f
