"""The verifier pass pipeline over the ring's event trace.

Five passes under the reference's names (``src/repro/analysis/passes.py``),
each checking one invariant of the CUDA ring
(``kernels/filter2d/csrc/filter2d_halo_ring.cuh``) in its own terms:

``dma_pairing``  Every stage fill announced by ``ExpectTx`` is completed by
                 exactly its ``Load``'s bytes, and a TMA load is announced;
                 each consumer warp waits for the fill exactly once, at the
                 parity of the stage's phase, and the producer waits for the
                 stage's release at the parity before it. A fill that no
                 warp waits for outlives the block ("never waited"); a wait
                 with no fill before it matches nothing.

``bank_hazard``  No stage is refilled before all of its last use's consumer
                 warps have arrived ("rewritten while" it is read). Every
                 ``Read`` finds its own item's window in the stage — the box
                 that last landed there covers the rows and columns the plan
                 says the item needs, from the item's plane — and reads
                 inside it after its own wait ("stale" otherwise). The plan
                 is the ground truth, as the serial path's fill schedule was
                 in the reference.

``read_once``    Frame bytes loaded per sweep (the in-frame part of every
                 box) equal ``halo.ring_read_amplification(plan)`` × the
                 frame's bytes × the chunk count, and every output pixel of
                 every filter is stored exactly once.

``width_lint``   The ring holds, and loads move, storage-width elements; a
                 fixed-point frame widens only to the int32 accumulator,
                 never to float ("floating"); the border constant written
                 into the ring is representable at storage width.

``vmem_budget``  Each launch's shared memory equals
                 ``halo.smem_working_set`` for its chunk and fits a block's
                 shared memory.

``dma_pairing``, ``bank_hazard`` and ``read_once``'s counters come from one
walk over each block's events in sequence order (:func:`simulate`).

To add a pass: write ``def pass_x(ctx) -> list[Finding]``, register it in
``PASSES`` — ``run_passes`` threads the shared :class:`Context` through.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.ir import (Arrive, ExpectTx, KernelIR, Load,
                                     MuxWrite, Read, Store, WaitEmpty,
                                     WaitFull, acc_kind)
from repro_torch.analysis.report import Finding
from repro_torch.core import dtypes
from repro_torch.core.border_spec import quantize_constant
from repro_torch.kernels.filter2d import halo
from repro_torch.kernels.filter2d.halo import HaloPlan


@dataclasses.dataclass
class Context:
    """Everything a pass sees: the schedule, the plan and the limit."""

    kir: KernelIR
    plan: HaloPlan
    key: str
    smem_limit: int = halo.SMEM_BLOCK_LIMIT


class _Dedup:
    """Caps repeated findings: one Finding per (pass, template), counting
    further occurrences instead of re-emitting."""

    def __init__(self, key: str):
        self.key = key
        self._found: Dict[tuple, dict] = {}

    def add(self, passname: str, template: str, message: str, step,
            ref: Optional[str] = None, detail: Optional[str] = None):
        k = (passname, template, ref)
        if k in self._found:
            self._found[k]["count"] += 1
            return
        self._found[k] = dict(passname=passname, message=message,
                              key=self.key, ref=ref,
                              grid_step=tuple(int(x) for x in step)
                              if step is not None else None,
                              detail=detail, count=1)

    def findings(self) -> List[Finding]:
        return [Finding(**d) for d in self._found.values()]


def _clip(lo: int, n: int, extent: int) -> int:
    return max(0, min(lo + n, extent) - max(lo, 0))


def _in_frame_bytes(ld: Load, frame: Tuple[int, int, int]) -> int:
    M, H, W = frame
    if not 0 <= ld.plane < M:
        return 0
    return (_clip(ld.row0, ld.rows, H) * _clip(ld.col0, ld.cols, W)
            * ld.elem_bytes)


# ---------------------------------------------------------------------------
# The walk (dma_pairing + bank_hazard + read_once's counters)
# ---------------------------------------------------------------------------


def simulate(ctx: Context) -> Tuple[List[Finding], Dict[str, float]]:
    """One walk over every block's events in sequence order, producing the
    dynamic passes' findings and the byte counters ``read_once`` checks."""
    kir = ctx.kir
    dd = _Dedup(ctx.key)
    warps = kir.contract.consumer_warps
    tma = kir.contract.loader == "tma"
    loaded = stored = 0
    for (launch, block), evs in sorted(kir.blocks().items()):
        fills = defaultdict(int)     # stage -> fills so far
        landed: Dict[int, Load] = {}           # stage -> last Load
        use: Dict[int, Tuple[int, set]] = {}   # stage -> (item, arrived)
        waits: Dict[Tuple[int, int], dict] = {}  # (item, stage) -> warp→n
        waited: Dict[Tuple[int, int], set] = defaultdict(set)
        pending_tx: Dict[int, ExpectTx] = {}
        for e in evs:
            step = (launch, block, e.item)
            if isinstance(e, WaitEmpty):
                want = (fills[e.stage] & 1) ^ 1
                if e.parity != want:
                    dd.add("dma_pairing", "empty-parity",
                           f"producer waits on stage {e.stage}'s empty "
                           f"barrier at parity {e.parity} before its fill "
                           f"{fills[e.stage]} (phase parity {want})", step,
                           ref="empty_bar")
            elif isinstance(e, ExpectTx):
                pending_tx[e.stage] = e
            elif isinstance(e, Load):
                nbytes = e.rows * e.cols * e.elem_bytes
                tx = pending_tx.pop(e.stage, None)
                if tma and tx is None:
                    dd.add("dma_pairing", "unannounced",
                           f"TMA load into stage {e.stage} with no expect-tx:"
                           " its full barrier does not wait for the bytes",
                           step, ref="full_bar")
                elif tx is not None and tx.bytes != nbytes:
                    dd.add("dma_pairing", "tx-bytes",
                           f"stage {e.stage}'s fill announces {tx.bytes} B "
                           f"but its load moves {nbytes} B", step,
                           ref="full_bar")
                prev = use.get(e.stage)
                if prev is not None and len(prev[1]) < warps:
                    dd.add("bank_hazard", "war-ring",
                           f"stage {e.stage} rewritten while its last use "
                           f"(item {prev[0]}) is still read: "
                           f"{len(prev[1])} of {warps} consumer warps had "
                           "arrived", step, ref="ring")
                old = landed.get(e.stage)
                if old is not None and not waited[(old.item, e.stage)]:
                    dd.add("dma_pairing", "unwaited-start",
                           f"fill of stage {e.stage} for item {old.item} is "
                           "never waited — it is overwritten by the next "
                           "fill", (launch, block, old.item), ref="ring")
                fills[e.stage] += 1
                landed[e.stage] = e
                use[e.stage] = (e.item, set())
                waits[(e.item, e.stage)] = defaultdict(int)
                loaded += _in_frame_bytes(e, kir.frame)
            elif isinstance(e, WaitFull):
                ld = landed.get(e.stage)
                if ld is None or ld.item != e.item:
                    dd.add("dma_pairing", "unmatched-wait",
                           f"warp {e.warp} waits on stage {e.stage} for item "
                           f"{e.item} with no fill of it in flight", step,
                           ref="full_bar")
                    continue
                want = (fills[e.stage] - 1) & 1
                if e.parity != want:
                    dd.add("dma_pairing", "full-parity",
                           f"warp {e.warp} waits on stage {e.stage} at "
                           f"parity {e.parity} for its fill "
                           f"{fills[e.stage] - 1} (phase parity {want})",
                           step, ref="full_bar")
                w = waits[(e.item, e.stage)]
                w[e.warp] += 1
                if w[e.warp] > 1:
                    dd.add("dma_pairing", "double-wait",
                           f"warp {e.warp} waits twice for stage {e.stage}'s"
                           f" fill of item {e.item}", step, ref="full_bar")
                waited[(e.item, e.stage)].add(e.warp)
            elif isinstance(e, Read):
                ld = landed.get(e.stage)
                problem = _stale(kir, e, ld, waited)
                if problem:
                    dd.add("bank_hazard", "stale-ring",
                           f"stage {e.stage} holds stale contents for item "
                           f"{e.item}: {problem}", step, ref="ring")
            elif isinstance(e, Store):
                stored += e.bytes
            elif isinstance(e, Arrive):
                u = use.get(e.stage)
                if u is None or u[0] != e.item:
                    dd.add("bank_hazard", "stray-arrive",
                           f"warp {e.warp} releases stage {e.stage} for item "
                           f"{e.item}, which the stage does not hold", step,
                           ref="empty_bar")
                    continue
                if e.warp in u[1]:
                    dd.add("bank_hazard", "double-arrive",
                           f"warp {e.warp} releases stage {e.stage} twice",
                           step, ref="empty_bar")
                u[1].add(e.warp)
            elif not isinstance(e, MuxWrite):
                dd.add("dma_pairing", "unknown", f"unknown event {e!r}",
                       step)
        for (item, stage), ws in sorted(waited.items()):
            if 0 < len(ws) < warps:
                dd.add("dma_pairing", "partial-wait",
                       f"stage {stage}'s fill of item {item} is waited by "
                       f"{len(ws)} of {warps} consumer warps",
                       (launch, block, item), ref="full_bar")
        for stage, ld in sorted(landed.items()):
            if not waited[(ld.item, stage)]:
                dd.add("dma_pairing", "unwaited-start",
                       f"fill of stage {stage} for item {ld.item} "
                       f"({ld.rows * ld.cols * ld.elem_bytes} B, loader "
                       f"{ld.loader!r}) is never waited — it is still in "
                       "flight when the block exits", (launch, block,
                                                       ld.item), ref="ring")
    return dd.findings(), {"frame_bytes_loaded": float(loaded),
                           "out_bytes_stored": float(stored)}


def _stale(kir: KernelIR, rd: Read, ld: Optional[Load], waited) -> str:
    """Why a Read's stage does not hold its item's window ('' if it does):
    the plan's window for the item is frame rows [y0 - r, y0 + SH + r) and
    columns [x0 - r, x0 + TILE_W + r) of its plane."""
    if ld is None:
        return "no window has landed in it"
    if rd.warp not in waited[(ld.item, rd.stage)]:
        return f"warp {rd.warp} reads before waiting for the fill"
    g = kir.geometry
    m, tile, strip = kir.item_coords(rd.item)
    y0, x0 = strip * g.strip_h, tile * halo.RING_TILE_W
    if ld.plane != m:
        return (f"the stage holds plane {ld.plane}'s window, the item "
                f"needs plane {m}")
    if not (ld.row0 <= y0 - g.r and ld.row0 + ld.rows >= y0 + g.strip_h
            + g.r and ld.col0 <= x0 - g.r
            and ld.col0 + ld.cols >= x0 + halo.RING_TILE_W + g.r):
        return (f"its box (rows {ld.row0}+{ld.rows}, cols "
                f"{ld.col0}+{ld.cols}) misses the item's window (rows "
                f"{y0 - g.r}..{y0 + g.strip_h + g.r}, cols {x0 - g.r}.."
                f"{x0 + halo.RING_TILE_W + g.r})")
    if (rd.row0 < 0 or rd.col0 < 0 or rd.row0 + rd.rows > ld.rows
            or rd.col0 + rd.cols > ld.cols):
        return (f"warp {rd.warp} reads rows {rd.row0}+{rd.rows}, cols "
                f"{rd.col0}+{rd.cols} outside the {ld.rows} x {ld.cols} box")
    return ""


# ---------------------------------------------------------------------------
# The passes
# ---------------------------------------------------------------------------


def pass_dynamic(ctx: Context) -> Tuple[List[Finding], Dict[str, float]]:
    """dma_pairing + bank_hazard findings from one walk."""
    return simulate(ctx)


def pass_read_once(ctx: Context, stats: Dict[str, float]) -> List[Finding]:
    kir, plan = ctx.kir, ctx.plan
    M, H, W = kir.frame
    elem = dtypes.to_torch(kir.contract.storage_dtype).itemsize
    frame_bytes = M * H * W * elem
    chunks = len(kir.contract.chunks)
    amp = halo.ring_read_amplification(plan)
    want = round(amp * H * W) * M * elem * chunks     # an exact integer
    got = int(stats.get("frame_bytes_loaded", 0))
    stats["read_amplification_traced"] = got / max(frame_bytes * chunks, 1)
    stats["read_amplification_bound"] = amp
    stats["coeff_chunks"] = float(chunks)
    out: List[Finding] = []
    if got != want:
        out.append(Finding(
            passname="read_once", key=ctx.key, ref="frame",
            message=f"frame bytes loaded per sweep differ from the plan: "
                    f"{got} B loaded vs halo.ring_read_amplification "
                    f"{amp:.4f}x x {frame_bytes} B x {chunks} chunk(s) = "
                    f"{want} B"))
    Ho, Wo = kir.out
    so = dtypes.to_torch(kir.contract.out_dtype).itemsize
    want_out = M * kir.contract.num_filters * Ho * Wo * so
    got_out = int(stats.get("out_bytes_stored", 0))
    if got_out != want_out:
        out.append(Finding(
            passname="read_once", key=ctx.key, ref="out",
            message=f"output bytes stored differ from one store per pixel: "
                    f"{got_out} B vs {want_out} B"))
    return out


def pass_width_lint(ctx: Context) -> List[Finding]:
    kir, plan = ctx.kir, ctx.plan
    out: List[Finding] = []
    storage = kir.contract.storage_dtype
    elem = dtypes.to_torch(storage).itemsize
    fixed = dtypes.is_fixed_point(storage)
    seen = set()

    def once(tag, f):
        if tag not in seen:
            seen.add(tag)
            out.append(f)

    for e in kir.events:
        if isinstance(e, (Load, Read)) and e.elem_bytes != elem:
            once(("width", type(e).__name__), Finding(
                passname="width_lint", key=ctx.key, ref="ring",
                message=f"the ring holds {e.elem_bytes}-byte elements, not "
                        f"the storage dtype {storage} ({elem} B) — the "
                        "stream must sit in shared memory at storage width"))
        elif isinstance(e, Read) and e.acc_kind != acc_kind(storage):
            if fixed and e.acc_kind.startswith("float"):
                once("float", Finding(
                    passname="width_lint", key=ctx.key, ref="ring",
                    message="stream data is converted to floating point "
                            f"({storage} -> {e.acc_kind}) before the MAC — "
                            "the fixed-point path must widen to int32 "
                            "only"))
            else:
                once("acc", Finding(
                    passname="width_lint", key=ctx.key, ref="ring",
                    message=f"stream data widens {storage} -> "
                            f"{e.acc_kind}; only the "
                            f"{acc_kind(storage)} accumulator is allowed"))
        elif isinstance(e, MuxWrite) and e.value is not None:
            q = quantize_constant(e.value, storage)
            if float(q) != float(e.value):
                once("const", Finding(
                    passname="width_lint", key=ctx.key, ref="ring",
                    message=f"border constant {e.value!r} written into the "
                            f"{storage} stream is not representable at "
                            f"storage width (quantizes to {q!r})"))
    if fixed and plan.constant != quantize_constant(plan.constant, storage):
        out.append(Finding(
            passname="width_lint", key=ctx.key, ref="ring",
            message=f"plan constant {plan.constant!r} is not quantized to "
                    f"the storage dtype {storage}"))
    return out


def pass_vmem_budget(ctx: Context) -> List[Finding]:
    kir, plan = ctx.kir, ctx.plan
    out: List[Finding] = []
    for ln in kir.launches:
        planned = halo.smem_working_set(plan, num_filters=ln.n1 - ln.n0,
                                        separable=kir.contract.separable)
        if ln.smem_bytes != planned:
            parts = ", ".join(f"{k}={v}" for k, v in ln.smem_parts)
            out.append(Finding(
                passname="vmem_budget", key=ctx.key, ref="ring",
                message=f"traced shared memory {ln.smem_bytes} B of launch "
                        f"{ln.launch} != smem_working_set {planned} B",
                detail=f"traced parts: {parts}" if parts else None))
        if ln.smem_bytes > ctx.smem_limit:
            out.append(Finding(
                passname="vmem_budget", key=ctx.key, ref="ring",
                message=f"traced shared memory {ln.smem_bytes} B of launch "
                        f"{ln.launch} exceeds the per-block shared memory "
                        f"limit {ctx.smem_limit} B"))
    return out


# The pass catalogue: name -> one-line description (docs + CLI listing).
PASSES = {
    "dma_pairing": "every stage fill announced by expect-tx completed by "
                   "its load's bytes; each consumer warp waits for it "
                   "once at the phase's parity; nothing in flight at exit",
    "bank_hazard": "no stage refilled before all its consumer warps "
                   "arrive; every read finds its own item's window from "
                   "the plan (the stale-ring class)",
    "read_once": "frame bytes loaded per sweep equal "
                 "halo.ring_read_amplification(plan) x frame x chunks; "
                 "every output stored once",
    "width_lint": "fixed-point storage discipline: storage-width ring, "
                  "int32-only widening, storage-representable constants",
    "vmem_budget": "each launch's shared memory equals smem_working_set "
                   "and fits a block",
}


def run_passes(ctx: Context) -> Tuple[List[Finding], Dict[str, float]]:
    """Run the full pipeline over one call's schedule."""
    findings, stats = pass_dynamic(ctx)
    findings += pass_read_once(ctx, stats)
    findings += pass_width_lint(ctx)
    findings += pass_vmem_budget(ctx)
    return findings, stats
