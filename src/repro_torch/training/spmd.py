"""The train step on a mesh: the reference's ``make_train_step(bundle,
rc, shd=ctx)`` under ``jax.jit`` on a mesh, where XLA partitions the
weights by ``sharding.rules`` and inserts the collectives. Torch has no
SPMD partitioner; here one process drives every coordinate, and every
move of bytes is an explicit gather or reduce-scatter.

Storage: the parameters, AdamW's moments and the batch are
``ShardedTensor``s placed by ``ctx.sharding`` (``sharding/placement.py``).

Compute (ZeRO-3 over every axis the weights are sharded on): the global
batch is split into microbatches first, as the reference's scan
(``step.py:34-54``), and each microbatch's rows then over the
data-parallel ranks (the axes ``act_batch`` maps to, pod-major). Each
rank gathers the whole parameter tree onto its device and runs the
port's single-device body there with ``shd=None``. Its loss is weighted
by its share of the microbatch's labels (``rank_weight``: its count of
labels that are not ``IGNORE`` over the microbatch's, counted from the
labels before the forward) and its aux loss by its share of the rows,
so the ranks' sum is the reference's token mean and row mean. Ranks
that differ only along the other axes ('model', 'expert') hold the same
rows and are computed once. The gradients are summed in float32 over
the ranks (on one device by autograd, into one ``.grad``; across
devices on each block's owner) and left, block by block, on the
coordinates that own them (a reduce-scatter). The clip's norm counts
each distinct block once; the schedule and AdamW run once per distinct
block; the blocks are then copied to their replicas on other devices.

What the 'model' axis does here: it shards storage, not compute. The
values are the reference's, but no activation is split over 'model' as
XLA's tensor parallelism splits it, and a rank gathers the whole tree at
once (per-layer gathering is an open item, ``ROADMAP.md``). On one card
whose entries make the mesh, a gather returns the one stored tensor (no
copy) and the reduce-scatter leaves views of one gradient: ``traffic``
counts those bytes as ``local``, and bytes between distinct cards as
``moved``.
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import registry
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import adamw_update, cosine_warmup, global_norm
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.clip import scale_by_norm
from repro_torch.sharding.collectives import Traffic
from repro_torch.sharding.mesh import Coord, DeviceMesh, mesh_device
from repro_torch.sharding.placement import ShardedTensor
from repro_torch.sharding.rules import ShardingCtx
from repro_torch.training.loss import IGNORE


def dp_axes(ctx: ShardingCtx) -> Tuple[str, ...]:
    """The mesh axes the batch rows are split over (``act_batch``'s)."""
    rule = ctx.rules.get("act_batch")
    rule = (rule,) if isinstance(rule, str) else tuple(rule or ())
    return tuple(a for a in rule if a in ctx.mesh.axis_names)


def rank_coords(mesh: DeviceMesh, axes: Tuple[str, ...]) -> List[Coord]:
    """One coordinate per data-parallel rank, in the batch's row order
    (row-major over ``axes``), every other axis at 0."""
    idx = [mesh.axis_names.index(a) for a in axes]
    out = []
    for c in mesh.coords():
        if all(k == 0 for i, k in enumerate(c) if i not in idx):
            out.append(c)
    return sorted(out, key=lambda c: tuple(c[i] for i in idx))


def rank_weight(count: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """A rank's share of its microbatch's token mean: its labels over the
    microbatch's (at least 1, as the reference's denominator)."""
    return count / total


def grad_norm(leaves: List[ShardedTensor],
              units: List[List[torch.Tensor]]) -> torch.Tensor:
    """The clip's global norm over each leaf's owned gradient blocks:
    every element once."""
    return global_norm([u for us in units for u in us])


def make_spmd_train_step(bundle, rc: RunConfig, ctx: ShardingCtx):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on ``ctx.mesh``, in place: ``params``, ``opt_state``'s moments and
    ``batch`` are trees of ``ShardedTensor``s (``train_loop(mesh=)``
    places them). ``bundle`` is built on the mesh's first entry, where the
    metrics live: ``loss``, ``aux_loss``, ``grad_norm`` (before
    clipping) as 0-d tensors, ``lr`` (float) and ``step`` (int). After a
    call, ``step.traffic`` holds that step's ``Traffic`` by kind:
    ``gathered`` (weights onto the ranks), ``reduce_scattered``
    (gradients to their owners), ``replicas`` (updated blocks to their
    copies) and ``batch``."""
    tc = rc.train
    mesh = ctx.mesh
    home = mesh.devices.flat[0]
    if mesh_device(bundle.device) != home:
        raise ValueError(f"bundle on {bundle.device}, the mesh's first "
                         f"entry is {home}")
    ranks = rank_coords(mesh, dp_axes(ctx))
    devices = list(dict.fromkeys(mesh.device(c) for c in ranks))
    bundles = {home: bundle}
    for dev in devices:
        if dev not in bundles:
            bundles[dev] = registry.build(rc, device=dev)
    aux_weight = inspect.signature(bundle.loss_fn).parameters[
        "aux_weight"].default

    def step(params, opt_state: AdamWState, batch: Dict[str, ShardedTensor]):
        traffic = {k: Traffic() for k in ("gathered", "reduce_scattered",
                                          "replicas", "batch")}
        leaves = tree_leaves(params)
        B = next(iter(batch.values())).shape[0]
        mb = tc.microbatch or B
        if B % mb:
            raise ValueError(f"batch {B} does not divide into microbatches "
                             f"of {mb}")
        n = B // mb
        # a microbatch that does not split over the ranks is computed by
        # the first (the reference's batch sharding is then dropped:
        # every rank holds every row)
        active = ranks if mb % len(ranks) == 0 else ranks[:1]
        rows = mb // len(active)
        first: Dict[torch.device, Coord] = {}
        for c in active:
            first.setdefault(mesh.device(c), c)
        used = list(first)
        full: Dict[torch.device, List[torch.Tensor]] = {}
        data = {}
        for dev, at in first.items():
            full[dev] = [x.gather(dev, traffic["gathered"], at)
                         for x in leaves]
            data[dev] = {k: v.gather(dev, traffic["batch"], at)
                         for k, v in batch.items()}
        for c in active:              # ranks that share a device's gather
            if first[mesh.device(c)] != c:
                for x in leaves:
                    x.count_gather(mesh.device(c), traffic["gathered"], c)
        trees = {}
        for dev in used:
            by_id = {id(x): t for x, t in zip(leaves, full[dev])}
            trees[dev] = tree_map(lambda x, by_id=by_id: by_id[id(x)], params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=home)
        aux_sum = torch.zeros((), dtype=torch.float32, device=home)
        for dev in used:
            for t in full[dev]:
                t.grad = None
                t.requires_grad_(True)
        try:
            for i in range(n):
                labels = data[home]["labels"][i * mb:(i + 1) * mb]
                total = torch.clamp((labels != IGNORE).sum().float(), min=1.0)
                for r, c in enumerate(active):
                    dev = mesh.device(c)
                    lo = i * mb + r * rows
                    sub = {k: v[lo:lo + rows] for k, v in data[dev].items()}
                    count = (sub["labels"] != IGNORE).sum().float()
                    w = rank_weight(count, total.to(dev))
                    ce, (aux, _) = bundles[dev].loss_fn(
                        trees[dev], sub, remat_policy=tc.remat_policy,
                        loss_chunk=tc.loss_chunk, z_loss=tc.z_loss,
                        aux_weight=0.0)
                    obj = ce * w + aux * (aux_weight / len(active))
                    obj.backward()
                    loss_sum += obj.detach().to(home)
                    aux_sum += (aux.detach() / len(active)).to(home)
        finally:
            for dev in used:
                for t in full[dev]:
                    t.requires_grad_(False)
        grads = {}
        for dev in used:
            grads[dev] = [t.grad if t.grad is not None
                          else torch.zeros_like(t) for t in full[dev]]
            if n > 1:
                torch._foreach_mul_(grads[dev], 1.0 / n)
        # reduce-scatter: each owned block's gradient summed over the
        # devices that computed ranks, on its owner
        g_units, p_units, m_units, v_units = [], [], [], []
        for li, x in enumerate(leaves):
            mine = []
            for owner, key in x.owned_keys():
                idx = (None if key is None
                       else x.sharding.key_index(key, x.shape))
                acc = None
                for dev in used:
                    part = grads[dev][li] if idx is None \
                        else grads[dev][li][idx]
                    part = part.to(owner)
                    acc = part if acc is None else acc + part
                mine.append(acc)
            for c in active:
                x.count_scatter(c, traffic["reduce_scattered"])
            g_units.append(mine)
            p_units.extend(x.owned_units())
        for tree, out in ((opt_state.m, m_units), (opt_state.v, v_units)):
            for x in tree_leaves(tree):
                out.extend(x.owned_units())
        gnorm = grad_norm(leaves, g_units)
        flat_g = [u for us in g_units for u in us]
        scale_by_norm(flat_g, gnorm, tc.grad_clip)
        # the schedule reads step + 1 before adamw_update advances it
        lr = cosine_warmup(int(opt_state.step) + 1, peak_lr=tc.learning_rate,
                           warmup_steps=tc.warmup_steps,
                           total_steps=tc.total_steps)
        _, new = adamw_update(p_units, flat_g,
                              AdamWState(opt_state.step, m_units, v_units),
                              lr=lr, b1=tc.b1, b2=tc.b2, eps=tc.eps,
                              weight_decay=tc.weight_decay)
        for x in (leaves + tree_leaves(opt_state.m)
                  + tree_leaves(opt_state.v)):
            x.sync_replicas(traffic["replicas"])
        for dev in used:
            for t in full[dev]:
                t.grad = None
        step.traffic = traffic
        metrics = {"loss": loss_sum / n, "aux_loss": aux_sum / n,
                   "grad_norm": gnorm, "lr": lr, "step": int(new.step)}
        return params, AdamWState(new.step, opt_state.m, opt_state.v), \
            metrics

    step.traffic = None
    return step
