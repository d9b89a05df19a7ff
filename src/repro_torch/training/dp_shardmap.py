"""Explicit data-parallel train step with hierarchical compressed
gradients, as the reference's ``training/dp_shardmap.py`` (a
``shard_map`` over the data-parallel axes), on a ``DeviceMesh`` with the
one-controller collectives of ``sharding/collectives.py``.

Reduction schedule, the reference's:

  1. mean over 'data' (the fast intra-pod axis, float32);
  2. int8 error-feedback quantise, each pod with its own scale;
  3. sum over 'pod' of the int8 values as int32;
  4. dequantise by the largest of the pods' scales, divide by the pod
     count; each pod keeps its quantisation residual for the next step.

The batch is sharded over ('pod', 'data'), pod-major; the parameters are
replicated. Where the mesh's entries are one card the replicas are one
tensor, not copies; on several cards each other card gets a copy of the
parameters for its ranks' gradients, and the update runs once, on the
mesh's first entry, and is copied out. Ranks that differ only along
'model' (or any axis but 'pod' and 'data') see the same batch shard and
compute the same values in the reference; here they are computed once.
The ranks run one after another: on one card the step takes the time of
all of them. Each rank's gradients are reduced leaf by leaf as soon as
its pod's ranks are done, so the step holds the parameters, AdamW's
moments, the residuals, the finished pods' means and one pod's rank
gradients, never every rank's at once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import registry
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               cosine_warmup, int8_ef_compress,
                               int8_ef_decompress)
from repro_torch.sharding.collectives import MeshValue, pmax, pmean, psum
from repro_torch.sharding.mesh import Coord, DeviceMesh, mesh_device
from repro_torch.training.step import make_grad_fn


def _dp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def reduce_over_pod(g: MeshValue, e: MeshValue
                    ) -> Tuple[MeshValue, MeshValue, MeshValue, MeshValue]:
    """One leaf's compressed reduction over a 1-d ('pod',) mesh: ``g`` each
    pod's (data-mean) gradient, ``e`` its residual. Returns (the reduced
    gradient, the new residuals, each pod's int8 ``q``, the int32 sum) at
    every pod, as the reference's ``reduce_leaf``
    (``dp_shardmap.py:58-66``)."""
    mesh = g.mesh
    # the residual in one rounding, as XLA compiles the reference's step
    comp = {c: int8_ef_compress(g[c], e[c], fma=True) for c in mesh.coords()}
    q = MeshValue(mesh, {c: v[0] for c, v in comp.items()})
    # each pod quantises with ITS OWN scale; the sum is dequantised by the
    # pmax of the scales (the reference's "shared dequant scale"), and the
    # residual each pod keeps is against its own scale, not the shared one
    scale = MeshValue(mesh, {c: v[1] for c, v in comp.items()})
    new_e = MeshValue(mesh, {c: v[2] for c, v in comp.items()})
    acc = psum(q.map(lambda c, x: x.to(torch.int32)), "pod")
    shared = pmax(scale, "pod")
    npod = psum(MeshValue.build(mesh, lambda c, dev: torch.ones(
        (), dtype=torch.float32, device=dev)), "pod")
    out = MeshValue(mesh, {c: int8_ef_decompress(acc[c], shared[c]) / npod[c]
                           for c in mesh.coords()})
    return out, new_e, q, acc


def make_compressed_dp_step(bundle, rc: RunConfig, mesh: DeviceMesh
                            ) -> Callable:
    """``step(params, opt_state, err, batch) -> (params, opt_state, err,
    metrics)``, in place: the batch sharded over ('pod', 'data'), the
    parameters replicated, the gradients reduced hierarchically with int8
    EF across 'pod' (``init_error_feedback`` makes ``err``). ``bundle`` is
    built on the mesh's first entry, where ``params``, ``opt_state``,
    ``err`` and the metrics (``loss``, ``grad_norm`` before clipping,
    ``lr``) live. As with ``make_train_step``, the reduced and clipped
    gradients stay in each parameter's ``.grad`` until the next step."""
    tc = rc.train
    axes = _dp_axes(mesh)
    dp = mesh.sub(**{a: 0 for a in mesh.axis_names if a not in axes})
    home = dp.devices.flat[0]
    if mesh_device(bundle.device) != home:
        raise ValueError(f"bundle on {bundle.device}, the mesh's first "
                         f"entry is {home}")
    # each rank: loss_fn(params, batch_shard, remat_policy=, loss_chunk=,
    # z_loss=) with no microbatching, as the reference's loss_for
    rc1 = rc.replace(train=dataclasses.replace(tc, microbatch=0))
    grad_fns = {home: make_grad_fn(bundle, rc1)}
    for dev in dp.distinct_devices()[1:]:
        grad_fns[dev] = make_grad_fn(registry.build(rc1, device=dev), rc1)
    n_pod = dict(dp.shape).get("pod", 1)
    n_rank = dp.size
    rank_of = {c: r for r, c in enumerate(dp.coords())}    # pod-major

    def rank_grads(params_on: Dict, coord: Coord, batch, rows: int):
        dev = dp.device(coord)
        r = rank_of[coord]
        shard = {k: v[r * rows:(r + 1) * rows].to(dev)
                 for k, v in batch.items()}
        params = params_on[dev]
        loss, _ = grad_fns[dev](params, shard)
        grads = []
        for p_ in tree_leaves(params):
            grads.append(p_.grad)
            p_.grad = None
        return loss, grads

    def pod_mean(params_on, p: int, batch, rows: int, losses: Dict
                 ) -> List[torch.Tensor]:
        """Pod ``p``'s gradients, the float32 mean over 'data', leaf by
        leaf as the ranks' gradients are released."""
        sub = dp.sub(pod=p) if "pod" in axes else dp
        ranks = {}
        for c in sub.coords():
            coord = ((p,) if "pod" in axes else ()) + c
            losses[coord], ranks[c] = rank_grads(params_on, coord, batch,
                                                 rows)
        if "data" not in axes:
            return ranks[()]
        out = []
        for i in range(len(ranks[(0,)])):
            mv = MeshValue(sub, {c: g[i] for c, g in ranks.items()})
            out.append(pmean(mv, "data")[(0,)])
            for g in ranks.values():
                g[i] = None
        return out

    def step(params, opt_state, err, batch):
        B = next(iter(batch.values())).shape[0]
        if B % n_rank:
            raise ValueError(f"batch {B} does not split over {n_rank} "
                             f"data-parallel ranks")
        rows = B // n_rank
        params_on = {home: params}
        for dev in dp.distinct_devices()[1:]:
            params_on[dev] = tree_map(lambda x, dev=dev: x.to(dev), params)
        losses = {}
        means = [pod_mean(params_on, p, batch, rows, losses)
                 for p in range(n_pod)]
        loss = MeshValue(dp, losses)
        if "data" in axes:
            loss = pmean(loss, "data")
        if "pod" in axes:
            # after the data mean every data rank of a pod holds the same
            # gradient, so the pod reduction runs once, over data rank 0
            # (the reference runs it on every data rank, to the same end)
            pods = dp.sub(data=0) if "data" in axes else dp
            err_leaves = tree_leaves(err)
            grads = []
            for i, e_all in enumerate(err_leaves):
                g = MeshValue(pods, {(p,): means[p][i] for p in range(n_pod)})
                e = MeshValue.build(pods, lambda c, dev: e_all[c[0]].to(dev))
                out, new_e, _, _ = reduce_over_pod(g, e)
                for p in range(n_pod):
                    e_all[p].copy_(new_e[(p,)])
                    means[p][i] = None
                grads.append(out[(0,)])
            loss = pmean(loss, "pod")
        else:
            # no 'pod' axis: no compression, only the data mean (the
            # reference on a (data, model) mesh); err passes through
            grads = means[0]
        loss = loss[tuple(0 for _ in dp.axis_names)]
        grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
        # the schedule reads step + 1 before adamw_update advances it
        lr = cosine_warmup(int(opt_state.step) + 1, peak_lr=tc.learning_rate,
                           warmup_steps=tc.warmup_steps,
                           total_steps=tc.total_steps)
        params, opt_state = adamw_update(
            params, grads, opt_state, lr=lr, b1=tc.b1, b2=tc.b2, eps=tc.eps,
            weight_decay=tc.weight_decay)
        for p_, g in zip(tree_leaves(params), grads):
            p_.grad = g
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return params, opt_state, err, metrics

    return step


def init_error_feedback(params, mesh: DeviceMesh):
    """Per-pod EF residuals: leaves [n_pod, ...] float32 (``n_pod`` 1
    without a 'pod' axis), on the parameters' device."""
    n_pod = dict(mesh.shape).get("pod", 1)
    return tree_map(lambda p_: torch.zeros((n_pod,) + tuple(p_.shape),
                                           dtype=torch.float32,
                                           device=p_.device), params)
