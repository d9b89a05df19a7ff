"""The train step on a mesh: the reference's ``make_train_step(bundle,
rc, shd=ctx)`` under ``jax.jit`` on a mesh, where XLA partitions the
weights by ``sharding.rules`` and inserts the collectives. Torch has no
SPMD partitioner; here one process drives every coordinate, and every
move of bytes is an explicit gather or reduce-scatter.

Storage: the parameters, AdamW's moments and the batch are
``ShardedTensor``s placed by ``ctx.sharding`` (``sharding/placement.py``).

Compute (ZeRO-3 over every axis the weights are sharded on, one layer at
a time, as XLA gathers inside the reference's scan over the layers): the
global batch is split into microbatches first, as the reference's scan
(``step.py:34-54``), and each microbatch's rows then over the
data-parallel ranks (the axes ``act_batch`` maps to, pod-major), one
rank after another. A rank runs the port's single-device body on a tree
whose leaves outside the stacks (embedding, head, final norm) it has
gathered for the microbatch, and whose stacked leaves are handles
(``stacked_leaf``): each layer's run gathers that layer, in forward and
again in backward, and sends its float32 gradient to the blocks' owners
(``sharding/fsdp.py``), so a coordinate holds one layer's weights and
gradients at a time beside the leaves outside the stacks
(``step.gathered_peak``, ``fsdp.peak_bytes``). Its loss is weighted by
its share of the microbatch's labels (``rank_weight``: its count of
labels that are not ``IGNORE`` over the microbatch's, counted from the
labels before the forward) and its aux loss by its share of the rows,
so the ranks' sum is the reference's token mean and row mean. The
gradients accumulate in float32 on their owners over the ranks and
microbatches (the reference accumulates in float32 too,
``step.py:49-52``) and are scaled by 1 / microbatches. The clip's norm
counts each distinct block once; the schedule and AdamW run once per
distinct block; the blocks are then copied to their replicas on other
devices.

What the 'model' axis does here: tensor parallelism, as the reference's
partitioned program splits the train profile's constraint points. A
rank is a group of coordinates, its own and those that differ from it
only along the tensor-parallel axes (``ShardingCtx.tp_axes``: 'model'),
and every one of them computes: each gathers its own block of the split
weights over the other axes only (the model's plan,
``registry.tp_plan``) and runs its query heads (with the key/value heads
they read), its MLP columns, its experts or expert columns, and its
vocabulary block of the embedding and of the loss (whisper: the heads of
its encoder's and decoder's attentions, its cross K/V for those heads,
both stacks' MLP columns and the tied vocabulary, ``whisper.tp_plan``),
and the recurrent layers' inner dim (``act_ssm``): its channels of
hymba's mamba part and of the ``mamba`` kind, of the mLSTM (its heads'
memory where the channel blocks are whole heads) and its heads of the
sLSTM, whose FFN splits by columns; the members' partial outputs are
summed where the reference's program all-reduces (``sharding/tp.py``),
and so are the sums of squares of the recurrent layers' norms. The
residual stream, the norms, RoPE, the residual adds and the sLSTM's conv
and norm run once a rank, on its own coordinate. On one card whose
entries make the mesh, a gather returns an alias of the one stored
tensor (no copy), the sums and copies move nothing and the
reduce-scatter adds into views of the owners' accumulators: ``traffic``
counts those bytes as ``local``, and bytes between distinct cards as
``moved``.
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import registry
from repro_torch.models.module import tree_leaves, tree_map, tree_paths
from repro_torch.optim import adamw_update, cosine_warmup, global_norm
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.clip import scale_by_norm
from repro_torch.sharding import fsdp
from repro_torch.sharding.collectives import TPCounts, Traffic
from repro_torch.sharding.mesh import Coord, DeviceMesh, mesh_device
from repro_torch.sharding.placement import ShardedTensor
from repro_torch.sharding.rules import ShardingCtx
from repro_torch.sharding.tp import TP, CoordFlops
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


def group_coords(mesh: DeviceMesh, coord: Coord,
                 axes: Tuple[str, ...]) -> List[Coord]:
    """``coord``'s tensor-parallel group: the coordinates that differ
    from it only along ``axes``, row-major over them (``coord`` first
    where its indices there are 0)."""
    idx = [mesh.axis_names.index(a) for a in axes]
    return sorted((c for c in mesh.coords()
                   if all(c[i] == coord[i] for i in range(len(c))
                          if i not in idx)),
                  key=lambda c: tuple(c[i] for i in idx))


def tp_plan(rc: RunConfig, ctx: ShardingCtx):
    """The model's tensor-parallel plan on ``ctx``'s mesh, by leaf path
    (``registry.tp_plan``), or None where a rank computes alone: no
    tensor-parallel axes (or a profile that splits the sequence over
    them), or a model the port does not split."""
    if ctx.tp_size() == 1:
        return None
    probe = TP(ctx, [ctx.mesh.devices.flat[0]] * ctx.tp_size())
    return registry.tp_plan(rc, probe)


def stacked_leaf(x: ShardedTensor, rank: fsdp.Group):
    """How the step hands a model a stacked leaf: a handle whose layers
    the layer's run gathers one at a time (``sharding/fsdp.py``)."""
    return fsdp.Stacked(x, rank)


def make_spmd_train_step(bundle, rc: RunConfig, ctx: ShardingCtx,
                         count_flops: bool = False):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on ``ctx.mesh``, in place: ``params``, ``opt_state``'s moments and
    ``batch`` are trees of ``ShardedTensor``s (``train_loop(mesh=)``
    places them). ``bundle`` is built on the mesh's first entry, where the
    metrics live: ``loss``, ``aux_loss``, ``grad_norm`` (before
    clipping) as 0-d tensors, ``lr`` (float) and ``step`` (int). After a
    call, ``step.traffic`` holds that step's ``Traffic`` by kind:
    ``gathered`` (weights onto the coordinates: each layer in forward and
    again in backward, the other leaves once, per microbatch and
    coordinate), ``reduce_scattered`` (gradients to their owners, per
    microbatch and coordinate), ``all_reduced`` (tensor parallelism's
    sums: one of a split block's output in forward and one of its
    input's gradient in backward, ``sharding/collectives.py``),
    ``states`` (the sLSTM's hidden states put together on a rank's first
    member from its members' heads, and their gradient's blocks sent
    back), ``copies`` (the single controller's own copies of a replicated
    tensor), ``replicas`` (updated blocks to their copies) and ``batch``;
    and ``step.gathered_peak`` the most bytes of gathered weights and
    their float32 gradients a coordinate held at once (``fsdp.peak_bytes``
    of the specs and the plan). With ``count_flops``,
    ``step.coord_flops`` maps every coordinate to its matmul flops for
    the step (``tp.CoordFlops``: forward, backward and recomputation; 0
    for a coordinate that computes nothing), else None."""
    tc = rc.train
    mesh = ctx.mesh
    home = mesh.devices.flat[0]
    if mesh_device(bundle.device) != home:
        raise ValueError(f"bundle on {bundle.device}, the mesh's first "
                         f"entry is {home}")
    ranks = rank_coords(mesh, dp_axes(ctx))
    plan = tp_plan(rc, ctx)
    groups = {c: (group_coords(mesh, c, ctx.tp_axes()) if plan is not None
                  else [c]) for c in ranks}
    specs_at = tree_paths(bundle.specs)
    devices = list(dict.fromkeys(mesh.device(c) for c in ranks))
    bundles = {home: bundle}
    for dev in devices:
        if dev not in bundles:
            bundles[dev] = registry.build(rc, device=dev)
    aux_weight = inspect.signature(bundle.loss_fn).parameters[
        "aux_weight"].default

    def step(params, opt_state: AdamWState, batch: Dict[str, ShardedTensor]):
        traffic = {k: Traffic() for k in ("gathered", "reduce_scattered",
                                          "all_reduced", "tp_gathered",
                                          "tp_scattered", "states", "copies",
                                          "replicas", "batch")}
        leaves = tree_leaves(params)
        at_path = tree_paths(params)
        if set(at_path) != set(specs_at):
            raise ValueError("the parameters' tree is not the bundle's")
        by_id = ({id(x): plan[p] for p, x in at_path.items() if p in plan}
                 if plan is not None else {})
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
        data = {}
        for c in active:
            dev = mesh.device(c)
            if dev not in data:
                data[dev] = {k: v.gather(dev, traffic["batch"], c)
                             for k, v in batch.items()}
        # the owners' float32 gradient accumulators
        accs = {id(x): [torch.zeros(u.shape, dtype=torch.float32,
                                    device=u.device)
                        for u in x.owned_units()] for x in leaves}
        ledgers = {c: fsdp.Ledger() for c in mesh.coords()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=home)
        aux_sum = torch.zeros((), dtype=torch.float32, device=home)
        flops = CoordFlops() if count_flops else None

        def run_rank(c, lo, total):
            """Rank ``c``'s forward and backward of its rows from ``lo``:
            (its weighted loss, its aux loss), detached."""
            dev = mesh.device(c)
            members = groups[c]
            group = fsdp.Group([fsdp.Rank(mesh.device(m), m, traffic,
                                          ledgers[m], accs)
                                for m in members], by_id)
            kw = {}
            if len(members) > 1:
                kw["tp"] = TP(ctx, [mesh.device(m) for m in members],
                              TPCounts(traffic["all_reduced"],
                                       traffic["copies"],
                                       lambda: group.in_backward,
                                       states=traffic["states"],
                                       tp_gathered=traffic["tp_gathered"],
                                       tp_scattered=traffic["tp_scattered"]),
                              names=members if flops is not None else None)
            sub = {k: v[lo:lo + rows] for k, v in data[dev].items()}
            count = (sub["labels"] != IGNORE).sum().float()
            w = rank_weight(count, total.to(dev))
            tree = tree_map(lambda x, s: (stacked_leaf(x, group)
                                          if fsdp.stacked(s)
                                          else group.gather_whole(x)),
                            params, bundle.specs)
            ce, (aux, _) = bundles[dev].loss_fn(
                tree, sub, remat_policy=tc.remat_policy,
                loss_chunk=tc.loss_chunk, z_loss=tc.z_loss, aux_weight=0.0,
                **kw)
            del tree
            obj = ce * w + aux * (aux_weight / len(active))
            group.backward(obj)
            return obj.detach(), aux.detach()

        with flops if flops is not None else contextlib.nullcontext():
            for i in range(n):
                labels = data[home]["labels"][i * mb:(i + 1) * mb]
                total = torch.clamp((labels != IGNORE).sum().float(),
                                    min=1.0)
                for r, c in enumerate(active):
                    if flops is not None:
                        flops.default = c
                    obj, aux = run_rank(c, i * mb + r * rows, total)
                    loss_sum += obj.to(home)
                    aux_sum += (aux / len(active)).to(home)
        g_units = [accs[id(x)] for x in leaves]
        if n > 1:
            torch._foreach_mul_([u for us in g_units for u in us], 1.0 / n)
        p_units, m_units, v_units = [], [], []
        for x in leaves:
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
        step.traffic = traffic
        step.gathered_peak = max(x.peak for x in ledgers.values())
        step.coord_flops = (None if flops is None else
                            {c: flops.by_scope().get(c, 0)
                             for c in mesh.coords()})
        metrics = {"loss": loss_sum / n, "aux_loss": aux_sum / n,
                   "grad_norm": gnorm, "lr": lr, "step": int(new.step)}
        return params, AdamWState(new.step, opt_state.m, opt_state.v), \
            metrics

    step.traffic = None
    step.gathered_peak = None
    step.coord_flops = None
    return step
