"""Roofline terms per (arch x shape) cell, as the reference's
``launch/roofline.py``, from the port's own counts and in NVIDIA H100
constants (``obs/roofline.py``):

  compute_s    = flops_per_device / PEAK_OPS_PER_S[the model's dtype]
  memory_s     = bytes_per_device / HBM_BW
  collective_s = collective_bytes_per_device / link_bw(devices)

No card and no allocation: every cell is built on ``meta`` tensors and a
mesh of ``meta`` entries by the dry run's ``build_cell``, and one rank's
body is run under two counters.

What is counted, per device: one coordinate of a data-parallel rank's
tensor-parallel group (to train, ``training/spmd.py``; to prefill or
decode, ``sharding/serve.py``: each computes its share of the split
products, to decode its block of the KV cache, the first also what runs
once a rank), the dry run's probe (``launch/dryrun.py``); to score (the
cache-less forward with no gradient), a data-parallel rank.

  flops   ``torch.utils.flop_counter.FlopCounterMode``: the matmuls and
          attention products the device's body runs (to train: forward,
          backward and the remat policy's recomputation). The reference
          reads XLA's HLO flops, which also take in elementwise work. The
          CUDA ``swattn`` gate counts the kernel's banded pairs
          (``kernels/swattn/kernel.py::band_flops``), not S x S.
  bytes   :class:`EagerBytes`: for every operation that is not a view, the
          bytes of its tensor inputs and outputs. This is the port's eager
          traffic (each operation reads its operands from device memory
          and writes its result there), the counterpart of XLA's
          post-fusion "bytes accessed"; no L2 reuse is credited, so small
          operands can beat it.
  unique  the arguments read once plus the outputs written once (the dry
          run's ``argument_bytes + output_bytes``, less the caches a
          decode step returns written in place, of which it writes one
          slot): a hard lower bound on the memory traffic.
  collective bytes
          from the port's placements and its count, not parsed from HLO
          (the port has none; the reference's ``parse_collective_bytes``
          is not carried), as one ``make_spmd_train_step`` step counts
          them in its ``Traffic``, averaged over the coordinates that
          compute: the parts of every weight a coordinate gathers from
          the other coordinates (its region of a split weight, the
          others whole) and, to train, those of its float32 gradient it
          sends to their owners (``gathered``, ``reduce_scattered``):
          every microbatch, the stacked leaves a layer at a time in
          forward and again in backward, the other leaves once; and,
          with tensor parallelism, the bytes each member sends into the
          group's sums (``all_reduced``: each split block's output in
          forward, its input's gradient in backward, the loss's row
          maxima, sums and target logits; to decode, the flash-decode
          combine; ``train_sp``'s all-gathers of the members' token
          blocks and reduce-scatters of the split blocks' outputs,
          ``kv_seq``'s of the query heads and of the combined output's
          heads, ``tp_gathered`` / ``tp_scattered``, counted with the
          all-gathers and the reduce-scatters), and, serving, the keys
          and values a prefill member
          sends to the members whose cache slots they fill (an
          all-to-all) and the logits' vocabulary blocks put together,
          counted by the classes' probe runs. Keyed by the reference's op names under
          its ``_WIRE_FACTOR`` convention (x 1 for all-gather and
          reduce-scatter, x 2 for all-reduce), with the bytes a ring
          carries as the op's bytes: (K - 1) blocks of a weight split K
          ways, where the reference counts the whole gathered result
          (K / (K - 1) of that) and the scattered block (1 / (K - 1) of
          that); a sum's (n − 1) members' parts.

**Counting by layer class** (the reference's scan correction). A cell is
not counted by running its whole model: F₀ is counted on the depth-0
model (embed, final norm, head, loss), and F₁ and F₂ on a stage of one
and of two layers of each distinct (kind, window) class
(``ModelConfig.stage_override``), and

  F(cell) = F₀ + Σ_class n_class · a + s_class · b,
  a = F₂ − F₁ (a layer),  b = F₁ − F₀ − a (a stage)

over the class's n layers in s stages. A stage has a cost of its own: a
prefill makes one layer's cache and repeats it over the stage's layers.
Whisper has one encoder and one decoder stack and no decoder of zero
layers (no cross K/V to stack): F₀ is one layer of each, F₁ = F₀, and F₂
one more encoder or decoder layer. The combination equals a direct count
of the whole model exactly (flops, eager bytes, unique bytes;
``tests/test_torch_roofline.py``). The analysis configs take
``q_chunk=0``, ``loss_chunk=10**9`` and ``microbatch=0``, as the
reference's; none of them changes the products.

**The recurrences.** ``ssm.py::ssd_body``, ``xlstm.py::mlstm_chunk_body``
and ``xlstm.py::slstm_step`` run in Python loops over their chunks or
time steps (sLSTM: one trip a token, 32,768 at ``prefill_32k``). Within a
class count each loop runs its first ``k`` bodies and hands the remaining
trips the last body's outputs, detached (no operation counted); with
F(k) counted at k = 2 and 3,

  F_class = F(2) + (trips − 2) · (F(3) − F(2))

exactly: the trips between the first and the last are alike, and the
difference is one body in its context (the views it reads, autograd's
backward of it and the remat recomputation), where the reference
multiplies a standalone body by 3 to train. The loops are found by name
(``_LOOPS``): each calls its body as a module global.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch yi_6b \\
      --shape train_4k [--profile ep] [--out FILE]
  PYTHONPATH=src python -m repro_torch.launch.roofline --all --out FILE
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils._pytree import tree_map as _pytree_map
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (ARCH_IDS, RunConfig, get_model_config,
                                      resolve, supported_shapes)
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_moe_mesh, make_production_mesh
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import whisper
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.module import tree_leaves, tree_paths
from repro_torch.models.transformer import make_stages
from repro_torch.obs.roofline import HBM_BW, PEAK_OPS_PER_S, link_bw
from repro_torch.sharding import fsdp
from repro_torch.sharding.tp import region_pieces
from repro_torch.training import spmd
from repro_torch.training.spmd import dp_axes

# wire bytes per op byte (the reference's convention, ring algorithms), for
# the collectives the port's mesh step issues
_WIRE_FACTOR = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-reduce": 2.0,
                "all-to-all": 1.0}
# the recurrences' (module, loop, body): each loop calls its body by name
_LOOPS = ((ssm_mod, "ssd_chunked", "ssd_body"),
          (xlstm_mod, "mlstm_chunkwise", "mlstm_chunk_body"),
          (xlstm_mod, "slstm_scan", "slstm_step"))
_KEYS = ("flops", "bytes", "unique", "all_reduce", "tp_gather",
         "tp_scatter", "exchange", "logits",
         "states")


class EagerBytes(TorchDispatchMode):
    """Counts, for every operation that is not a view, the bytes of its
    tensor inputs and outputs (a tensor counted each time it appears)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            for t in _pytree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


@contextlib.contextmanager
def cut_trips(keep: int):
    """Within the block, each call of a recurrence loop (``_LOOPS``) runs
    its first ``keep`` bodies; the later trips get the last body's
    outputs detached, so no operation of theirs is counted. Yields a list
    that receives each loop call's trip count."""
    trips: List[int] = []
    saved = []
    for mod, loop, body in _LOOPS:
        real_loop, real_body = getattr(mod, loop), getattr(mod, body)
        state = {"n": 0, "out": None}

        def cut_body(*a, _real=real_body, _state=state, **kw):
            _state["n"] += 1
            if _state["n"] <= keep:
                _state["out"] = _real(*a, **kw)
                return _state["out"]
            return _pytree_map(lambda t: t.detach()
                               if isinstance(t, torch.Tensor) else t,
                               _state["out"])

        def counted_loop(*a, _real=real_loop, _state=state, **kw):
            _state["n"] = 0
            out = _real(*a, **kw)
            trips.append(_state["n"])
            return out
        saved += [(mod, loop, real_loop), (mod, body, real_body)]
        setattr(mod, loop, counted_loop)
        setattr(mod, body, cut_body)
    try:
        yield trips
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _count_body(cell: Dict[str, Any], keep: Optional[int]
                ) -> Tuple[Dict[str, float], int]:
    """One rank's body of ``cell`` counted (``keep``: its loops cut to
    that many bodies; None: run whole). Returns ({flops, bytes, unique},
    the loops' trip count, 0 where none ran). ``unique`` leaves out a
    decode step's position (``cur``), which ``combine`` adds once."""
    reads = dr._Reads()
    with contextlib.ExitStack() as stack:
        trips = (stack.enter_context(cut_trips(keep)) if keep is not None
                 else [])
        fc = stack.enter_context(FlopCounterMode(display=False))
        eb = stack.enter_context(EagerBytes())
        stack.enter_context(reads)
        outs = cell["body"]()
    args, out_bytes = dr.unique_bytes(cell, reads.ids, outs)
    # a decode step's caches come back written in place: the step reads
    # them (an argument) and writes one slot of each, not the whole cache
    held = {id(t) for tree, _ in cell["args"] for t in tree_leaves(tree)}
    out_bytes -= sum(t.numel() * t.element_size() for t in tree_leaves(outs)
                     if id(t) in held or id(t._base) in held)
    if len(set(trips)) > 1:
        raise ValueError(f"the loops of one class ran {sorted(set(trips))} "
                         "trips")
    counts = cell["tp_counts"]

    def moved(kind):
        t = None if counts is None else getattr(counts, kind)
        return float(0 if t is None else t.local)
    return ({"flops": float(fc.get_total_flops()), "bytes": float(eb.bytes),
             "unique": float(args + out_bytes - 4 * cell["cur"]),
             "all_reduce": moved("all_reduced"),
             "tp_gather": moved("tp_gathered"),
             "tp_scatter": moved("tp_scattered"),
             "exchange": moved("exchanged"), "logits": moved("logits"),
             "states": moved("states")},
            trips[0] if trips else 0)


def count_cell(rc: RunConfig, mesh, kind: str,
               param_dtype: Optional[torch.dtype] = None,
               cut: bool = True) -> Dict[str, float]:
    """``rc``'s model counted as it is (one rank's body): {flops, bytes,
    unique, trips, cur}. ``cut``: each recurrence loop's trips reckoned
    from two cut runs (module note), else run whole."""
    cell = dr.build_cell(rc, mesh, kind, param_dtype)
    extra = {"cur": int(cell["cur"])}
    if not cut:
        got, trips = _count_body(cell, None)
        return {**got, "trips": trips, **extra}
    f2, trips = _count_body(cell, 2)
    if trips <= 2:
        return {**f2, "trips": trips, **extra}
    f3, _ = _count_body(dr.build_cell(rc, mesh, kind, param_dtype), 3)
    return {**{k: f2[k] + (trips - 2) * (f3[k] - f2[k]) for k in _KEYS},
            "trips": trips, **extra}


def _analysis_rc(rc: RunConfig, **model) -> RunConfig:
    mc = dataclasses.replace(rc.model, q_chunk=0, **model)
    tr = dataclasses.replace(rc.train, loss_chunk=10 ** 9, microbatch=0)
    return dataclasses.replace(rc, model=mc, train=tr)


def layer_classes(mc) -> List[Tuple[str, int, int, int]]:
    """Distinct (kind, window) classes with their total layer and stage
    counts: (kind, window, layers, stages)."""
    agg: Dict[Tuple[str, int], List[int]] = {}
    for st in make_stages(mc):
        n = agg.setdefault((st.kind, st.window), [0, 0])
        n[0] += st.count
        n[1] += 1
    return [(k, w, n, s) for (k, w), (n, s) in agg.items()]


def class_counts(rc: RunConfig, mesh, kind: str,
                 param_dtype: Optional[torch.dtype] = None
                 ) -> Dict[str, Any]:
    """The depth-0 count and, for each class, the counts of a stage of one
    layer and of two: {"base": F₀, "classes": [(label, layers, stages,
    F_1, F_2), ...]}."""
    mc = rc.model

    def at(**model):
        return count_cell(_analysis_rc(rc, **model), mesh, kind, param_dtype)
    if mc.family == "encdec":
        # a decoder of no layers stacks no cross K/V: the base is one
        # layer of each, F_1 = F₀ and F_2 one layer more of the one
        one = at(encoder_layers=1, num_layers=1)
        return {"base": one,
                "classes": [
                    ("encoder", mc.encoder_layers, 1, one,
                     at(encoder_layers=2, num_layers=1)),
                    ("decoder", mc.num_layers, 1, one,
                     at(encoder_layers=1, num_layers=2))]}
    classes = [(f"{k}/w{w}", n, s,
                at(stage_override=((k, w, 1),), num_layers=1),
                at(stage_override=((k, w, 2),), num_layers=2))
               for k, w, n, s in layer_classes(mc)]
    return {"base": at(stage_override=(), num_layers=0), "classes": classes}


def combine(counts: Dict[str, Any]) -> Dict[str, float]:
    """F₀ + Σ_class (layers · a + stages · b) for each key of ``_KEYS``,
    where a = F_2 − F_1 is a layer's cost and b = F_1 − F₀ − a a stage's
    own (the prefill's cache of a stage, made once and repeated over its
    layers); a decode step's position counted once."""
    base = counts["base"]
    tot = {k: base[k] for k in _KEYS}
    cur = base["cur"]
    for _, n, s, f1, f2 in counts["classes"]:
        for k in _KEYS:
            a = f2[k] - f1[k]
            tot[k] += n * a + s * (f1[k] - base[k] - a)
        cur = max(cur, f1["cur"])
    tot["unique"] += 4 * cur
    return tot


def _active_ranks(rc: RunConfig, ctx, kind: str) -> int:
    """The coordinates that compute: the data-parallel ranks that do
    (``make_spmd_train_step``'s ``active``: all where a microbatch splits
    over them, else the first; the mesh serving functions' likewise for
    the batch), times the members of each one's tensor-parallel group
    that compute (``dryrun.build_cell``'s ``tp_members``; none split to
    score)."""
    R = math.prod(ctx.mesh.shape[a] for a in dp_axes(ctx))
    B = rc.shape.global_batch
    mb = (rc.train.microbatch or B) if kind == "train" else B
    dp = R if mb % R == 0 else 1
    if kind == "score":
        return dp
    plan = spmd.tp_plan(rc, ctx)
    return dp * (1 if plan is None else dr.tp_members(plan))


def collective_bytes(rc: RunConfig, mesh, kind: str,
                     param_dtype: Optional[torch.dtype] = None,
                     moves: Optional[Dict[str, float]] = None
                     ) -> Dict[str, Any]:
    """The collective bytes of one computing coordinate, averaged over
    those that compute, by op kind (``_WIRE_FACTOR`` applied), and their
    count (``ranks``): each computing coordinate gathers the parts of
    every weight its data-parallel rank's plan gives it (its region of a
    split weight, else the weight whole on the rank's first coordinate,
    ``spmd.tp_plan``) from the other coordinates; to train, it sends
    those of the weight's float32 gradient to their owners. To train, a
    coordinate does so every microbatch, gathering a stacked leaf a layer
    at a time in forward and again in backward (``sharding/fsdp.py``;
    whisper's cross K/V weights twice each way, ``whisper.READ_TWICE``,
    and to prefill twice: by ``cross_kv`` and by their decoder layer; a
    decode step gathers no encoder layer) and the other leaves once; and with tensor parallelism each member
    sends its part of the group's moves over the step: the sums
    (``all_reduce``: to decode, the flash-decode combine's maxima, sums
    and outputs; the recurrent layers' partial products and the sums of
    squares of their norms), the recurrent layers' blocks (``states``,
    an all-gather: the sLSTM's hidden states put together and, serving,
    the members' blocks of the whole states sent and put back), and,
    serving, the prefill's keys and values sent to
    the members whose cache slots they fill (``exchange``, an
    all-to-all) and the vocabulary blocks of the logits put together
    (``logits``, an all-gather): the classes' probe count of one rank's
    body (``moves``: ``combine(class_counts)``, counted here where not
    given), scaled from the probe's rows to the batch's."""
    cell = dr.build_cell(rc, mesh, kind, param_dtype)
    params, shardings = cell["args"][0]
    ctx, plan = cell["ctx"], cell["plan"]
    train = kind == "train"
    twice = set(whisper.READ_TWICE) if rc.model.family == "encdec" else ()
    # a decode step runs no encoder: its layers are never gathered
    unread = (("encoder",) if rc.model.family == "encdec"
              and kind == "decode" else ())
    sh_at = tree_paths(shardings)
    specs = tree_paths(cell["specs"])
    # every data-parallel rank's group moves as much as the first's
    first = spmd.rank_coords(mesh, dp_axes(ctx))[0]
    group = (spmd.group_coords(mesh, first, ctx.tp_axes())
             if plan is not None else [first])
    coords = _active_ranks(rc, ctx, kind)
    dp = coords // (1 if plan is None else dr.tp_members(plan))
    gathered = scattered = 0
    for path, t in tree_paths(params).items():
        if path[0] in unread:
            continue
        sh = sh_at[path]
        regions = plan.get(path) if plan is not None else None
        passes = 2 if path in twice and kind != "decode" else 1
        if train and fsdp.stacked(specs[path]):
            passes *= 2
        for m, at in enumerate(group):
            if regions is None and m:
                continue            # the first member's, whole
            index = None if regions is None else regions[m]
            if regions is not None and index is None:
                continue
            pieces = [None] if index is None else region_pieces(index)[1]
            n = dp * sum(k for ix in pieces
                         for _, k in sh.foreign(t.shape, at, ix))
            gathered += passes * n * t.element_size()
            scattered += n * 4
    by_kind = {}
    B = rc.shape.global_batch
    if train:
        n = B // (rc.train.microbatch or B)
        gathered, scattered = n * gathered, n * scattered
        by_kind["reduce-scatter"] = (scattered / coords
                                     * _WIRE_FACTOR["reduce-scatter"])
    if plan is not None and kind != "score":
        if moves is None:
            moves = combine(class_counts(rc, mesh, kind, param_dtype))
        ranks = B // cell["rank_rows"]
        by_kind["all-reduce"] = (moves["all_reduce"] * ranks / coords
                                 * _WIRE_FACTOR["all-reduce"])
        if moves["tp_scatter"]:
            by_kind["reduce-scatter"] = by_kind.get("reduce-scatter", 0.0) \
                + (moves["tp_scatter"] * ranks / coords
                   * _WIRE_FACTOR["reduce-scatter"])
        gathered += moves["states"] * ranks + moves["tp_gather"] * ranks
        if not train:
            gathered += moves["logits"] * ranks
            by_kind["all-to-all"] = (moves["exchange"] * ranks / coords
                                     * _WIRE_FACTOR["all-to-all"])
    by_kind = {"all-gather": gathered / coords * _WIRE_FACTOR["all-gather"],
               **by_kind}
    return {"by_kind": by_kind, "ranks": coords}


# ---------------------------------------------------------------------------
# model flops (analytic, the reference's definition)
# ---------------------------------------------------------------------------


def model_flops(rc: RunConfig, kind: str) -> float:
    mc = rc.model
    B, S = rc.shape.global_batch, rc.shape.seq_len
    n_active = mc.active_param_count()
    embed = mc.d_model * mc.vocab_size * (1 if mc.tie_embeddings else 2)
    n = max(n_active - embed, 1)
    if kind == "train":
        tokens = B * (mc.max_target_positions if mc.family == "encdec"
                      else S)
        return 6.0 * n * tokens
    if kind in ("prefill", "score"):
        return 2.0 * n * B * S
    return 2.0 * n * B                    # decode: one token per row


# ---------------------------------------------------------------------------
# per-cell roofline
# ---------------------------------------------------------------------------


def _profiled(arch: str, shape_name: str, profile: str, rc, mesh):
    if mesh is None:
        mesh = (make_moe_mesh(["meta"] * 512) if profile == "ep"
                else make_production_mesh(["meta"] * 512))
    if rc is None:
        rc = resolve(arch, shape_name, multi_pod=False,
                     sharding_profile=profile)
        if profile == "ep":
            rc = rc.replace(model=dataclasses.replace(rc.model,
                                                      moe_force_ep=True))
        if profile == "kv8":
            rc = rc.replace(model=dataclasses.replace(
                rc.model, kv_cache_dtype="int8"))
    return rc, mesh


def analyze_cell(arch: str, shape_name: str, *, verbose: bool = True,
                 profile: str = "default", rc: Optional[RunConfig] = None,
                 mesh=None, kind: Optional[str] = None,
                 param_dtype: Optional[torch.dtype] = None
                 ) -> Dict[str, Any]:
    """One cell's report, with the reference's keys and the port's
    (``coll_by_kind``, ``peak_ops``, ``hbm_bw``, ``link_bw``, ``counts``,
    ``unique_bytes_per_device``, ``unique_memory_s``). ``rc`` and
    ``mesh`` given: that run config and mesh in place of the production
    ones (16 x 16 of ``meta`` entries; the EP mesh for ``profile='ep'``);
    ``kind``: the step counted, else the shape's (``score``: the
    cache-less forward); ``param_dtype``: the weights' dtype where it is
    not their specs' float32."""
    rc, mesh = _profiled(arch, shape_name, profile, rc, mesh)
    kind = kind or dr.shape_kind(shape_name)
    counts = class_counts(rc, mesh, kind, param_dtype)
    tot = combine(counts)
    coll = collective_bytes(rc, mesh, kind, param_dtype, tot)
    coll_total = sum(coll["by_kind"].values())
    n_dev = mesh.size
    peak = PEAK_OPS_PER_S[rc.model.dtype]
    link = link_bw(n_dev)
    compute_t = tot["flops"] / peak
    memory_t = tot["bytes"] / HBM_BW
    coll_t = coll_total / link
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_t}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rc, kind)
    trips = {c[0]: c[3]["trips"] for c in counts["classes"] if c[3]["trips"]}
    report = {
        "arch": arch, "shape": shape_name, "kind": kind, "devices": n_dev,
        "flops_per_device": tot["flops"], "bytes_per_device": tot["bytes"],
        "collective_bytes_per_device": coll_total,
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf,
        "profile": profile,
        "useful_ratio": mf / max(tot["flops"] * coll["ranks"], 1.0),
        "bound_step_s": max(terms.values()),
        "roofline_fraction": min(1.0, (mf / n_dev / peak)
                                 / max(max(terms.values()), 1e-12)),
        "unique_bytes_per_device": tot["unique"],
        "unique_memory_s": tot["unique"] / HBM_BW,
        "coll_by_kind": coll["by_kind"], "ranks": coll["ranks"],
        "peak_ops": peak, "peak_dtype": rc.model.dtype, "hbm_bw": HBM_BW,
        "link_bw": link,
        "counts": (f"one device's body on meta, FlopCounterMode matmul and "
                   f"attention flops, eager bytes of every non-view op; "
                   f"depth 0 + {len(counts['classes'])} classes (layers, "
                   f"stages) {[c[:3] for c in counts['classes']]}"
                   + (f"; recurrence trips {trips}" if trips else "")
                   + "; collectives from the placements and the "
                   "classes' count of the tensor-parallel sums"),
    }
    if verbose:
        print(f"[roofline] {arch}/{shape_name}: "
              f"C {compute_t*1e3:.2f}ms M {memory_t*1e3:.2f}ms "
              f"X {coll_t*1e3:.2f}ms -> {report['dominant']}-bound, "
              f"useful {report['useful_ratio']:.2f}, "
              f"roofline {report['roofline_fraction']:.2%}", flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", default="default")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS
                 for shape in supported_shapes(get_model_config(arch))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")
    reports = []
    for arch, shape in cells:
        try:
            reports.append(analyze_cell(arch, shape, profile=args.profile))
        except Exception as e:  # noqa: BLE001 - report and continue
            print(f"[roofline] FAIL {arch}/{shape}: "
                  f"{type(e).__name__}: {e}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
        print(f"[roofline] wrote {len(reports)} reports to {args.out}")
    if len(reports) < len(cells):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
