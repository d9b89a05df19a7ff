"""Multi-pod dry run, as the reference's ``launch/dryrun.py``: every
(architecture x shape x mesh) cell is built on the production meshes
(16 x 16, and 2 x 16 x 16) and its per-device footprint reckoned,
without a card and without allocating the model.

For each cell the step the shape names is built, on ``meta`` tensors
(shapes and dtypes, no storage) and on a mesh of ``meta`` entries:
  train_4k             -> the mesh train step (``training/spmd.py``)
  prefill_32k          -> prefill (cache build + last-token logits)
  decode_32k/long_500k -> decode_step (one token against a seq_len cache)
with the reference's profile choice (``build_lowered``): ``decode`` for
decode cells; ``train_sp`` / ``zero1`` / ``kv_seq`` / ``dp_only`` by
``rc.sharding_profile`` (``--profile sp`` / ``zero1`` / ``cp`` /
``dp``); ``zero1``'s moments on the train profile's placement;
``EP_OVERRIDES`` for ``ep``. Under ``train_sp`` (sequence parallelism)
and ``kv_seq`` (context parallelism) a rank keeps its 'model' group, as
under ``train``: the train step and the prefill split the sequence of
the residual stream, or of the keys, over it (``tp_splits``); a decode
cell runs the ``decode`` profile whatever ``rc.sharding_profile`` says.

The port has no XLA lowering, so its figures come from its own
placements and its own step. Per device:

  argument_bytes   the step's arguments as placed: parameters, AdamW's
                   moments and step, the batch, the caches and ``cur``
                   (exact: each leaf's block; equal to the reference's
                   compiled ``argument_size_in_bytes``);
  output_bytes     train: the updated parameters and moments, as placed,
                   and the five metrics; prefill / decode: one rank's
                   logits and caches for its rows;
  gathered_bytes   the most a device's step holds gathered at once:
                   ``fsdp.peak_bytes`` of the specs and the profile's
                   tensor-parallel plan (``spmd.tp_plan``): the leaves
                   outside the stacks and the largest layer of any stack,
                   each split leaf at the coordinate's region and the
                   others whole, as the mesh step and the mesh serving
                   functions (``sharding/serve.py``) gather one layer at
                   a time and count in their ``gathered_peak``: to
                   train, weights and float32 gradients; to prefill or
                   decode, the weights alone (forward only);
  temp_bytes, generated_code_bytes
                   XLA's, which the port cannot give: ``null``;
  matmul_flops_per_device
                   ``torch.utils.flop_counter.FlopCounterMode`` over one
                   device's body on ``meta`` (its rows of the batch; to
                   train, forward and backward): the matmuls and
                   attention products it counts, not XLA's flops (the
                   reference's ``flops_per_device``, ``null`` here). On
                   a mesh with a tensor-parallel axis it is one
                   coordinate's: the first of its data-parallel rank's
                   group (``sharding/tp.py``), which runs its share of
                   every split product (to decode: its block of the KV
                   cache, flash-decode; whisper's: its blocks of the
                   self ring and of the cross cache's frames) and the
                   parts that run once a rank; the other members' shares
                   are not run (a probe);
  tp_members       the coordinates of a rank's tensor-parallel group that
                   compute (1: none split);
  all_reduced_bytes_per_device
                   the bytes a coordinate sends into tensor
                   parallelism's sums (to decode: the flash-decode
                   combine's maxima, sums and outputs), on average over
                   its group (``traffic``'s ``all_reduced``, from the
                   probe's count: the members but the first send their
                   parts);
  all_gathered_bytes_per_device, reduce_scattered_bytes_per_device
                   the same for the group's all-gathers and
                   reduce-scatters (``tp_gathered``, ``tp_scattered``):
                   under ``train_sp`` the members' token blocks gathered
                   before each split block and its outputs scattered over
                   the tokens, and the keys and values each member
                   projects from its own tokens; under ``kv_seq`` the
                   query heads gathered and each member's heads of the
                   combined attention output; 0 under ``train``;
  dropped_shardings
                   the placements that fell back to replication because
                   a dim does not divide: of the weights, the batch and
                   the caches. The step also resolves the reference's
                   activation constraints (``ShardingCtx.tp_blocks``), but
                   once per step build, where the reference's count takes
                   them in once per trace; those drops are not counted,
                   and the two totals differ by design;
  fits             ``argument_bytes + gathered_bytes`` within the H100's
                   80 GB (activations not counted).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b \\
      --shape train_4k [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (ARCH_IDS, RunConfig, get_model_config,
                                      resolve, supported_shapes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import module as mod
from repro_torch.models import registry
from repro_torch.models.attention import KVBlocks
from repro_torch.models.module import tree_leaves
from repro_torch.optim.adamw import AdamWState, adamw_abstract
from repro_torch.sharding import fsdp
from repro_torch.sharding import rules as shd_rules
from repro_torch.sharding import serve as serve_mod
from repro_torch.sharding.collectives import TPCounts, Traffic
from repro_torch.sharding.placement import NamedSharding
from repro_torch.sharding.tp import TP, Parts, take_region
from repro_torch.training import spmd
from repro_torch.training.spmd import dp_axes

HBM_BYTES = 80e9          # the H100's 80 GB


def _is_axes_leaf(ax) -> bool:
    return (isinstance(ax, tuple)
            and all(e is None or isinstance(e, str) for e in ax))


def tree_shardings(ab, ax, ctx: shd_rules.ShardingCtx):
    """Zip an abstract tree with its logical-axes tree -> NamedShardings."""
    if ab is None:
        return None
    if isinstance(ab, dict):
        return {k: tree_shardings(ab[k], ax[k], ctx) for k in ab}
    if isinstance(ab, (list, tuple)):
        return type(ab)(tree_shardings(a, x, ctx) for a, x in zip(ab, ax))
    if not _is_axes_leaf(ax):
        raise ValueError(f"axes {ax!r} for the leaf {tuple(ab.shape)}")
    return ctx.sharding(ab.shape, ax)


def batch_shardings(specs: Dict[str, torch.Tensor],
                    ctx: shd_rules.ShardingCtx):
    return {k: ctx.sharding(s.shape, ("act_batch",)
                            + (None,) * (len(s.shape) - 1))
            for k, s in specs.items()}


def placed_bytes(tree, shardings, read=None) -> int:
    """Bytes one device holds of ``tree`` (meta tensors) placed by
    ``shardings`` (a matching tree; ``None``: whole on every device),
    counting only the leaves whose ``id`` is in ``read`` where it is
    given. Every block is the same size, so every device holds the
    same."""
    if isinstance(shardings, NamedSharding) or shardings is None:
        if tree is None:
            return 0
        if not torch.is_tensor(tree):
            return sum(placed_bytes(t, None, read) for t in tree_leaves(tree))
        if read is not None and id(tree) not in read:
            return 0
        shape = (shardings.shard_shape(tree.shape) if shardings is not None
                 else tuple(tree.shape))
        return math.prod(shape) * tree.element_size()
    if isinstance(tree, dict):
        return sum(placed_bytes(tree[k], shardings[k], read) for k in tree)
    return sum(placed_bytes(t, s, read) for t, s in zip(tree, shardings))


class _Reads(TorchDispatchMode):
    """Records every tensor an operation reads (a view's base with it, and
    the tensor a ``detach`` aliases; a view itself reads nothing): an
    argument no operation reads is left out of the argument bytes, as
    ``jax.jit`` prunes an unused argument from the compiled program."""

    def __init__(self):
        super().__init__()
        self.ids = set()
        self.alias = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.is_view:
            out = func(*args, **kwargs)
            if func is torch.ops.aten.detach.default:
                self.alias[id(out)] = args[0]
            return out
        for t in _pytree_leaves((args, kwargs)):
            while isinstance(t, torch.Tensor):
                self.ids.add(id(t))
                t = t._base if t._base is not None else self.alias.get(id(t))
        return func(*args, **kwargs)


def logical_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _profile(rc: RunConfig, kind: str):
    overrides = shd_rules.EP_OVERRIDES if rc.sharding_profile == "ep" else ()
    if kind == "decode":
        profile = "decode"
    elif rc.sharding_profile in ("sp", "zero1", "cp", "dp"):
        profile = {"sp": "train_sp", "zero1": "zero1",
                   "cp": "kv_seq", "dp": "dp_only"}[rc.sharding_profile]
    else:
        profile = "train"
    return profile, overrides


def _rank_rows(B: int, ctx: shd_rules.ShardingCtx) -> int:
    """A rank's rows: the batch split over the data-parallel axes, or
    whole where it does not divide (the batch placement dropped)."""
    R = math.prod(ctx.mesh.shape[a] for a in dp_axes(ctx))
    return B // R if B % R == 0 else B


def _has_key(tree, key: str) -> bool:
    if isinstance(tree, dict):
        return key in tree or any(_has_key(v, key) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_key(v, key) for v in tree)
    return False


def _rows(tree, rows: int, axes=None):
    """The first ``rows`` of a batch dict, or of a cache tree along its
    ``act_batch`` axis (``axes``: the cache's logical axes)."""
    if axes is None:
        return {k: v[:rows] for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: _rows(tree[k], rows, axes[k]) for k in tree}
    if isinstance(tree, (list, tuple)) and not _is_axes_leaf(axes):
        return type(tree)(_rows(t, rows, a) for t, a in zip(tree, axes))
    if "act_batch" in axes:
        return tree.narrow(axes.index("act_batch"), 0, rows)
    return tree


def build_cell(rc: RunConfig, mesh, kind: str,
               param_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The cell's arguments with their placements (``args``: (tree,
    shardings) pairs; ``cur``: whether a decode step takes its position),
    and one rank's body (``body()``, to count its flops and reads). kind
    in {train, prefill, decode, score}: ``score`` is the cache-less
    forward of every position with no gradient (``train_forward``).
    ``param_dtype``: the parameters in that dtype (a model served from
    bfloat16 weights), else their specs' (float32)."""
    bundle = registry.build(rc, device="meta")
    profile, overrides = _profile(rc, kind)
    ctx = shd_rules.make_ctx(mesh, profile, overrides)
    pshard = ctx.spec_tree_shardings(bundle.specs)
    params_ab = mod.abstract_params(bundle.specs, param_dtype)
    B, S = rc.shape.global_batch, rc.shape.seq_len
    rows = _rank_rows(B, ctx)
    cur = False
    plan, tp, counts = None, None, None
    back = {"on": False}            # training's backward: sums are copies
    if kind in ("train", "prefill", "decode"):
        plan = spmd.tp_plan(rc, ctx)
    if plan is not None:
        counts = TPCounts(Traffic(), Traffic(), lambda: back["on"],
                          exchanged=Traffic(), logits=Traffic(),
                          states=Traffic(), tp_gathered=Traffic(),
                          tp_scattered=Traffic())
        tp = TP(ctx, ["meta"] * ctx.tp_size(), counts, probe=True)
    kw = {} if tp is None else {"tp": tp}
    gathered = fsdp.peak_bytes(bundle.specs, param_dtype, plan,
                               grads=kind == "train")
    def split():
        """The probe's tree, its regions taken inside the body (a region
        of several slices is a new tensor: its read of the argument is
        recorded there)."""
        return params_ab if plan is None else _split(params_ab, plan)
    axes = bundle.cache_axes()
    if kind == "train":
        # ZeRO-1: the moments keep the FSDP (data-sharded) layout though
        # the weights are replicated over 'data'
        mv = (shd_rules.make_ctx(mesh, "train").spec_tree_shardings(
            bundle.specs) if rc.sharding_profile == "zero1" else pshard)
        bspecs = bundle.input_specs("train")
        args = [(params_ab, pshard),
                (adamw_abstract(bundle.specs), AdamWState(None, mv, mv)),
                (bspecs, batch_shardings(bspecs, ctx))]
        tc = rc.train

        def body():
            for t in tree_leaves(params_ab):
                t.requires_grad_(True)
            loss, _ = bundle.loss_fn(split(), _rows(bspecs, rows),
                                     remat_policy=tc.remat_policy,
                                     loss_chunk=tc.loss_chunk,
                                     z_loss=tc.z_loss, **kw)
            back["on"] = True
            try:
                loss.backward()
            finally:
                back["on"] = False
            return None
    elif kind == "prefill":
        bspecs = bundle.input_specs("prefill")
        args = [(params_ab, pshard), (bspecs, batch_shardings(bspecs, ctx))]

        @torch.no_grad()
        def body():
            caches = (None if tp is None else probe_caches(
                bundle.cache_abstract(rows, S), axes, ctx))
            logits, caches = bundle.prefill(split(), _rows(bspecs, rows),
                                            caches=caches, **kw)
            return logits, probe_tree(caches)
    elif kind == "score":
        bspecs = bundle.input_specs("prefill")
        args = [(params_ab, pshard), (bspecs, batch_shardings(bspecs, ctx))]

        @torch.no_grad()
        def body():
            return bundle.train_forward(params_ab, _rows(bspecs, rows))[0]
    elif kind == "decode":
        caches_ab = bundle.cache_abstract(B, S)
        ispec = bundle.input_specs("decode")
        args = [(params_ab, pshard), (ispec, batch_shardings(ispec, ctx)),
                (caches_ab, tree_shardings(caches_ab, axes, ctx))]
        # the position writes the attention caches' slots ('pos'); a
        # recurrent model's step does not read it
        cur = _has_key(caches_ab, "pos")

        @torch.no_grad()
        def body():
            view = _rows(caches_ab, rows, axes)
            if tp is not None:
                view = probe_caches(view, axes, ctx)
            logits, caches = bundle.decode_step(
                split(), _rows(ispec, rows)["inputs"], view, S - 1, **kw)
            return logits, probe_tree(caches)
    else:
        raise ValueError(kind)
    return {"ctx": ctx, "args": args, "cur": cur, "train": kind == "train",
            "gathered_bytes": gathered, "rank_rows": rows, "body": body,
            "specs": bundle.specs, "plan": plan,
            "tp_members": 1 if tp is None else tp_members(plan),
            "tp_counts": counts}


def probe_caches(tree, axes, ctx: shd_rules.ShardingCtx):
    """A rank's caches (``meta``) as its tensor-parallel group's first
    member holds them: each KV cache (whisper's cross cache too, its
    length from its keys) as ``attention.KVBlocks`` of the member's block
    along ``cache_seq`` (the group's spans as the caches are placed), a
    conv state split along ``act_ssm`` as ``tp.Parts`` of the member's
    block, the other leaves whole."""
    def kv(t, ax):
        _, _, L = serve_mod.kv_length(t, ax)
        spans: Dict[int, Tuple[int, int]] = {}
        for m, b in enumerate(ctx.tp_blocks((1, L),
                                            ("act_batch", "cache_seq"))):
            lo, hi, _ = b[1].indices(L)
            if (lo, hi) not in spans.values():
                spans[m] = (lo, hi)
        lo, hi = spans[0]
        block = {k: v.narrow(ax[k].index("cache_seq"), lo, hi - lo)
                 for k, v in t.items()}
        return KVBlocks({0: block}, spans, L)

    def leaf(x, ax):
        if "act_ssm" not in ax:
            return x
        blocks = ctx.tp_blocks(x.shape, [a if a == "act_ssm" else None
                                         for a in ax])
        if len(TP.members(blocks)) == 1:
            return x
        return Parts([x[blocks[0]]] + [None] * (len(blocks) - 1), blocks)
    return serve_mod.map_cache(tree, axes, kv, leaf)


def probe_tree(caches):
    """The caches a probe's body returns, its KV blocks and conv state
    blocks as tensors."""
    if isinstance(caches, KVBlocks):
        return caches.blocks[0]
    if isinstance(caches, Parts):
        return caches[0]
    if isinstance(caches, dict):
        return {k: probe_tree(v) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return type(caches)(probe_tree(v) for v in caches)
    return caches


def _split(tree, plan, path=()):
    """``tree`` with each leaf the plan splits as ``tp.Parts`` of its
    members' regions (views on ``meta``)."""
    if isinstance(tree, dict):
        return {k: _split(v, plan, path + (k,)) for k, v in tree.items()}
    p = plan.get(path)
    if p is None:
        return tree
    return Parts([None if ix is None else take_region(tree, ix) for ix in p],
                 p)


def tp_members(plan) -> int:
    """The members of a group that compute under ``plan``."""
    return len({m for p in plan.values() for m, ix in enumerate(p)
                if ix is not None}) or 1


def unique_bytes(cell: Dict[str, Any], read, outs) -> Tuple[int, int]:
    """(argument bytes, output bytes) of one device for a ``build_cell``
    cell whose body read the tensors of ids ``read`` and returned
    ``outs``: each argument as placed, read once, and each output written
    once."""
    # the train step updates every parameter and moment: all are read
    args = sum(placed_bytes(t, sh, None if cell["train"] else read)
               for t, sh in cell["args"])
    args += 4 * cell["cur"]
    if cell["train"]:       # the parameters and moments as placed, metrics
        out_bytes = sum(placed_bytes(t, sh) for t, sh in cell["args"][:2])
        out_bytes += 5 * 4
    else:
        out_bytes = logical_bytes(outs)
    return args, out_bytes


def shape_kind(shape_name: str) -> str:
    return {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode", "long_500k": "decode"}[shape_name]


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rc: Optional[RunConfig] = None, mesh=None) -> Dict[str, Any]:
    """One cell's report (``rc`` and ``mesh`` given: that run config and
    mesh in place of the production ones)."""
    if mesh is None:
        mesh = make_production_mesh(["meta"] * 512, multi_pod=multi_pod)
    if rc is None:
        rc = resolve(arch, shape_name, multi_pod=multi_pod)
    kind = shape_kind(shape_name)
    t0 = time.time()
    cell = build_cell(rc, mesh, kind)
    t_build = time.time() - t0
    t0 = time.time()
    with FlopCounterMode(display=False) as fc, _Reads() as reads:
        outs = cell["body"]()
    t_flops = time.time() - t0
    args, out_bytes = unique_bytes(cell, reads.ids, outs)
    return {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": mesh_name(mesh), "devices": mesh.size,
        "build_s": round(t_build, 2), "flops_s": round(t_flops, 2),
        "rank_rows": cell["rank_rows"],
        "matmul_flops_per_device": fc.get_total_flops(),
        "tp_members": cell["tp_members"],
        "all_reduced_bytes_per_device": (
            None if cell["tp_counts"] is None
            else cell["tp_counts"].all_reduced.local / cell["tp_members"]),
        "all_gathered_bytes_per_device": (
            None if cell["tp_counts"] is None
            else cell["tp_counts"].tp_gathered.local / cell["tp_members"]),
        "reduce_scattered_bytes_per_device": (
            None if cell["tp_counts"] is None
            else cell["tp_counts"].tp_scattered.local / cell["tp_members"]),
        "flops_per_device": None, "bytes_per_device": None,
        "memory": {"argument_bytes": args, "output_bytes": out_bytes,
                   "gathered_bytes": cell["gathered_bytes"],
                   "temp_bytes": None, "generated_code_bytes": None},
        "dropped_shardings": len(cell["ctx"].dropped),
        "fits": args + cell["gathered_bytes"] <= HBM_BYTES,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="dir for per-cell JSON")
    ap.add_argument("--profile", default="default",
                    help="the run config's sharding profile (sp: train_sp, "
                    "cp: kv_seq, zero1, dp, as the reference's "
                    "build_lowered maps them)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape, mp) for arch in ARCH_IDS
                 for shape in supported_shapes(get_model_config(arch))
                 for mp in (False, True)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, args.multi_pod)]
    else:
        ap.error("--arch/--shape or --all")

    failures = []
    for arch, shape, mp in cells:
        tag = f"{arch}/{shape}/{'2x16x16' if mp else '16x16'}"
        if args.profile != "default":
            tag += f"/{args.profile}"
        try:
            rep = run_cell(arch, shape, mp, rc=resolve(
                arch, shape, multi_pod=mp, sharding_profile=args.profile))
        except Exception as e:  # noqa: BLE001 - report and continue
            print(f"[dryrun] FAIL {tag}: {type(e).__name__}: {e}")
            failures.append((tag, str(e)))
            continue
        mem = rep["memory"]
        print(f"[dryrun] OK   {tag}: args "
              f"{mem['argument_bytes'] / 2 ** 30:.2f} GiB/dev, gathered "
              f"{mem['gathered_bytes'] / 2 ** 30:.2f} GiB/dev, matmul "
              f"flops/dev {rep['matmul_flops_per_device']:.3e} "
              f"({rep['tp_members']} tensor-parallel), dropped "
              f"{rep['dropped_shardings']}, fits {rep['fits']}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fn = os.path.join(args.out, tag.replace("/", "__") + ".json")
            with open(fn, "w") as f:
                json.dump(rep, f, indent=1)
    if failures:
        print(f"[dryrun] {len(failures)} failures")
        sys.exit(1)
    print(f"[dryrun] all {len(cells)} cells built")


if __name__ == "__main__":
    main()
