"""The verifier's IR: an event trace of the CUDA ring's schedule.

The reference verifier lowers the Pallas kernel's jaxpr into a dataflow IR
(``src/repro/analysis/ir.py``). The port's kernel is a CUDA ring
(``kernels/filter2d/csrc/filter2d_halo_ring.cuh``) with no jaxpr: persistent
blocks, one producer warp, ``STAGES`` shared-memory stages behind
full/empty mbarrier pairs. Its IR is therefore the ring's *schedule* as
events, each tagged with its launch (bank chunk), block, item and the
block's sequence number:

  * producer — :class:`WaitEmpty` (the stage's empty barrier at a parity),
    :class:`ExpectTx` (the bytes the full barrier waits for, TMA only),
    :class:`Load` (the window box: plane, first row and column, rows,
    columns, element bytes, loader);
  * consumers, per warp — :class:`WaitFull`, :class:`MuxWrite` (border
    slots written, and the constant written when the policy is
    ``constant``), :class:`Read` (the part of the stage the warp reads, in
    the box's coordinates, and the accumulator it widens to),
    :class:`Store` (the output rectangle of one filter), :class:`Arrive`.

A :class:`KernelIR` holds the contract, the ring geometry, the launches
(chunk, blocks, shared memory) and the events. It has two sources:

  * :func:`schedule_model` — what the ring does, from its rules (block b
    takes items b, b + G, …; the producer refills a stage once all the
    consumer warps of its last use have arrived), as Python; the verifier
    runs it on the CPU, and seeded-bug variants subclass :class:`RingModel`;
  * :func:`from_device_log` — the log the trace build
    (``kernels/filter2d/trace.py``) writes on the card.

:func:`schedule_diff` holds two IRs equal: per block, the producer's events
in order and each item's consumer events as a multiset (the warps run
concurrently, so only their barrier order is fixed).
"""
from __future__ import annotations

import dataclasses
import math
import struct
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

from repro_torch.core import dtypes
from repro_torch.core.border_spec import BorderSpec, out_shape
from repro_torch.kernels.filter2d import halo
from repro_torch.kernels.filter2d.contract import KernelContract
from repro_torch.kernels.filter2d.halo import HaloPlan, RingGeometry


class AnalysisError(Exception):
    """The schedule cannot be built or decoded (CLI exit code 2)."""


# ---------------------------------------------------------------------------
# Event records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Event:
    """Every event's tags: the launch (its index among the call's bank
    chunks), the block, the item and the block's sequence number."""

    launch: int
    block: int
    item: int
    seq: int

    def body(self) -> tuple:
        """The event without its sequence number (what two sources of the
        same schedule must agree on)."""
        d = dataclasses.asdict(self)
        d.pop("seq")
        return (type(self).__name__,) + tuple(d.values())


@dataclasses.dataclass(frozen=True)
class WaitEmpty(Event):
    stage: int
    parity: int


@dataclasses.dataclass(frozen=True)
class ExpectTx(Event):
    stage: int
    bytes: int


@dataclasses.dataclass(frozen=True)
class Load(Event):
    stage: int
    plane: int
    row0: int
    col0: int
    rows: int
    cols: int
    elem_bytes: int
    loader: str


@dataclasses.dataclass(frozen=True)
class WaitFull(Event):
    stage: int
    parity: int
    warp: int


@dataclasses.dataclass(frozen=True)
class MuxWrite(Event):
    stage: int
    warp: int
    slots: int
    value: Optional[float]          # the constant written (constant policy)


@dataclasses.dataclass(frozen=True)
class Read(Event):
    stage: int
    warp: int
    row0: int
    col0: int
    rows: int
    cols: int
    elem_bytes: int
    acc_kind: str                   # 'int32' | 'float32'


@dataclasses.dataclass(frozen=True)
class Store(Event):
    warp: int
    plane: int
    filter: int
    row0: int
    col0: int
    rows: int
    cols: int
    bytes: int


@dataclasses.dataclass(frozen=True)
class Arrive(Event):
    stage: int
    warp: int


PRODUCER = (WaitEmpty, ExpectTx, Load)


@dataclasses.dataclass(frozen=True)
class LaunchInfo:
    """One launch of the call: its chunk ``[n0, n1)`` of the bank, its
    blocks and its dynamic shared memory (``smem_parts`` by role where
    the source knows them)."""

    launch: int
    n0: int
    n1: int
    blocks: int
    smem_bytes: int
    smem_parts: Tuple[Tuple[str, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class KernelIR:
    """One call's schedule: the contract, the ring geometry, the frame
    ``(M, H, W)`` and output ``(Ho, Wo)``, the output shift (r under
    neglect, else 0), the launches and the events in each block's order."""

    name: str
    source: str                     # 'model' | 'device'
    contract: KernelContract
    geometry: RingGeometry
    frame: Tuple[int, int, int]
    out: Tuple[int, int]
    shift: int
    policy: str
    launches: Tuple[LaunchInfo, ...]
    events: Tuple[Event, ...]

    def blocks(self) -> Dict[Tuple[int, int], List[Event]]:
        """(launch, block) → its events in sequence order."""
        out: Dict[Tuple[int, int], List[Event]] = defaultdict(list)
        for e in self.events:
            out[(e.launch, e.block)].append(e)
        for v in out.values():
            v.sort(key=lambda e: e.seq)
        return dict(out)

    def item_coords(self, item: int) -> Tuple[int, int, int]:
        """(plane, tile, strip) of an item, by the contract's order."""
        M, H, W = self.frame
        tiles, strips, _ = halo.ring_items(self.geometry, H, W, M)
        m, rem = divmod(item, tiles * strips)
        return m, rem // strips, rem % strips


def acc_kind(storage_dtype) -> str:
    """The accumulator the kernel widens a frame to."""
    return "int32" if dtypes.is_fixed_point(storage_dtype) else "float32"


def storage_value(value: float, storage_dtype) -> float:
    """A double as the storage dtype holds it (the kernel's
    ``from_double<T>``: round to nearest for float types, C's truncation
    toward zero for integers)."""
    name = dtypes.name(storage_dtype)
    if name == "float32":
        return struct.unpack("f", struct.pack("f", value))[0]
    if name == "bfloat16":
        import torch
        return float(torch.tensor(value, dtype=torch.float32)
                     .to(torch.bfloat16).float())
    return float(math.trunc(value))


# ---------------------------------------------------------------------------
# The schedule model
# ---------------------------------------------------------------------------


def _span(lo: int, hi: int, n: int) -> Tuple[int, int]:
    return min(max(lo, 0), n), min(max(hi, 0), n)


class RingModel:
    """The ring's schedule as the kernel's rules state it, for one call.

    ``run()`` emits every launch's events in one valid order: per block,
    the producer fills stages as far as the empty barriers let it, and the
    consumer warps of an item wait, mux, read and store, then arrive one by
    one; each arrival may let the producer refill. The methods below are
    the rules; a seeded-bug variant overrides one of them."""

    def __init__(self, contract: KernelContract, geometry: RingGeometry,
                 plan: HaloPlan, M: int, blocks: int):
        self.contract, self.geo, self.plan = contract, geometry, plan
        self.M, self.H, self.W = M, plan.rows.extent, plan.cols.extent
        self.blocks_req = int(blocks)
        w = 2 * plan.rows.r + 1
        self.Ho, self.Wo = out_shape(self.H, self.W, w,
                                     BorderSpec(plan.policy))
        self.shift = plan.rows.r - plan.rows.off
        self.tiles, self.strips, self.items = halo.ring_items(
            geometry, self.H, self.W, M)
        self.storage_bytes = dtypes.to_torch(contract.storage_dtype).itemsize
        self.out_bytes = dtypes.to_torch(contract.out_dtype).itemsize
        self.const = storage_value(plan.constant, contract.storage_dtype)

    # -- the rules ----------------------------------------------------------

    def chunks(self) -> Tuple[Tuple[int, int], ...]:
        return self.contract.chunks

    def empty_arrivals(self) -> int:
        """Arrivals the producer's empty wait needs before a refill."""
        return self.contract.arrivals

    def producer_items(self, n_items: int) -> int:
        """Items the producer fills in a block of ``n_items``."""
        return n_items

    def load_box(self, item: int, m: int, ywin0: int, bx0: int
                 ) -> Tuple[int, int, int, int, int]:
        """(plane, row0, col0, rows, cols) of an item's TMA box."""
        return m, ywin0, bx0, self.geo.eh, self.geo.box_w

    def read_acc_kind(self) -> str:
        return acc_kind(self.contract.storage_dtype)

    def smem_parts(self, n: int) -> Tuple[Tuple[str, int], ...]:
        """The launch's shared memory by role, for ``n`` filters."""
        g, S = self.geo, halo.RING_STAGES
        words = halo.ring_coeff_words(g.w, self.contract.separable)
        return (("align", 128), ("ring", S * g.stage),
                ("full_bar", 8 * S), ("empty_bar", 8 * S),
                ("coeffs", n * words * halo.COEFF_BYTES), ("qparams", n * 8))

    # -- the schedule -------------------------------------------------------

    def grid(self) -> int:
        return max(1, min(self.blocks_req, self.items))

    def run(self) -> KernelIR:
        events: List[Event] = []
        launches = []
        for launch, (n0, n1) in enumerate(self.chunks()):
            parts = self.smem_parts(n1 - n0)
            G = self.grid()
            launches.append(LaunchInfo(launch, n0, n1, G,
                                       sum(b for _, b in parts), parts))
            for b in range(G):
                events += self._block(launch, b, G, n0, n1)
        return KernelIR(
            name="filter2d_halo", source="model", contract=self.contract,
            geometry=self.geo, frame=(self.M, self.H, self.W),
            out=(self.Ho, self.Wo), shift=self.shift,
            policy=self.plan.policy, launches=tuple(launches),
            events=tuple(events))

    def _block(self, launch: int, b: int, G: int, n0: int, n1: int
               ) -> List[Event]:
        its = list(range(b, self.items, G))
        n_prod = self.producer_items(len(its))
        need = self.empty_arrivals()
        S = self.contract.stages
        out: List[Event] = []
        arrived = Counter()
        state = {"seq": 0, "pk": 0}

        def tag(item):
            s = state["seq"]
            state["seq"] += 1
            return dict(launch=launch, block=b, item=item, seq=s)

        def produce():
            while state["pk"] < n_prod:
                k = state["pk"]
                if k >= S and arrived[k - S] < need:
                    return
                it = b + k * G
                out.extend(self._producer(it, k, tag))
                state["pk"] += 1

        produce()
        for k, it in enumerate(its):
            consumer = self._consumers(it, k, n0, n1, tag)
            for e in consumer:
                out.append(e)
            for wi in range(self.contract.consumer_warps):
                out.append(Arrive(**tag(it), stage=k % S, warp=wi))
                arrived[k] += 1
                produce()
        return out

    def _producer(self, it: int, k: int, tag) -> List[Event]:
        g, S = self.geo, self.contract.stages
        s = k % S
        per_plane = self.tiles * self.strips
        m, rem = divmod(it, per_plane)
        ywin0 = (rem % self.strips) * g.strip_h - g.r
        bx0 = (rem // self.strips) * halo.RING_TILE_W - g.lead
        ev = [WaitEmpty(**tag(it), stage=s, parity=((k // S) & 1) ^ 1)]
        plane, row0, col0, rows, cols = self.load_box(it, m, ywin0, bx0)
        tma = self.contract.loader == "tma"
        if tma:
            ev.append(ExpectTx(**tag(it), stage=s, bytes=g.eh * g.pitch))
        ev.append(Load(**tag(it), stage=s, plane=plane, row0=row0,
                       col0=col0, rows=rows, cols=cols,
                       elem_bytes=self.storage_bytes,
                       loader=self.contract.loader))
        return ev

    def _consumers(self, it: int, k: int, n0: int, n1: int, tag
                   ) -> List[Event]:
        g, S = self.geo, self.contract.stages
        s = k % S
        m, rem = divmod(it, self.tiles * self.strips)
        tile, strip = rem // self.strips, rem % self.strips
        y0, x0 = strip * g.strip_h, tile * halo.RING_TILE_W
        ywin0 = y0 - g.r
        warps = self.contract.consumer_warps
        ev: List[Event] = [WaitFull(**tag(it), stage=s, parity=(k // S) & 1,
                                    warp=wi) for wi in range(warps)]
        edge = self.plan.policy != "neglect" and (
            ywin0 < 0 or ywin0 + g.eh > self.H or x0 - g.r < 0
            or x0 + halo.RING_TILE_W + g.r > self.W)
        if edge:
            total = self._mux_slots(ywin0, x0)
            full, rest = divmod(total, halo.RING_CONSUMERS)
            value = self.const if self.plan.policy == "constant" else None
            ev += [MuxWrite(**tag(it), stage=s, warp=wi,
                            slots=full * 32 + min(max(rest - 32 * wi, 0), 32),
                            value=value) for wi in range(warps)]
        for wi in range(warps):
            ev += self._warp_reads(it, s, wi, m, y0, x0, n0, n1, tag)
        return ev

    def _mux_slots(self, ywin0: int, x0: int) -> int:
        """``ring.cuh::mux``'s slot count for an item's window."""
        g, H, W, r = self.geo, self.H, self.W, self.geo.r
        EH, EW = g.eh, halo.RING_TILE_W + 2 * r
        xwin0 = x0 - r
        rows = _span(-r - ywin0, H + r - ywin0, EH)
        cols = _span(-r - xwin0, W + r - xwin0, EW)
        top = _span(-r - ywin0, -ywin0, EH)
        bot = _span(H - ywin0, H + r - ywin0, EH)
        lft = _span(-r - xwin0, -xwin0, EW)
        rgt = _span(W - xwin0, W + r - xwin0, EW)
        nt, nl = top[1] - top[0], lft[1] - lft[0]
        nr, nc = nt + bot[1] - bot[0], nl + rgt[1] - rgt[0]
        nw, nh = cols[1] - cols[0], rows[1] - rows[0]
        return nr * nw + nh * nc

    def _warp_reads(self, it, s, wi, m, y0, x0, n0, n1, tag) -> List[Event]:
        """A warp's Read and Stores over its active lanes (those whose
        ROWS x C outputs meet the output)."""
        g = self.geo
        C, ROWS, TX = g.cols_per_thread, g.rows_per_thread, g.tx
        sh = self.shift
        tids = range(32 * wi, 32 * wi + 32)
        tys = sorted({t // TX for t in tids})
        txs = sorted({t % TX for t in tids})
        ty_ok = [ty for ty in tys
                 if y0 + ty * ROWS - sh < self.Ho
                 and y0 + ty * ROWS + ROWS > sh]
        tx_ok = [tx for tx in txs
                 if x0 + tx * C - sh < self.Wo and x0 + tx * C + C > sh]
        if not ty_ok or not tx_ok:
            return []
        r0 = min(ty_ok) * ROWS
        r1 = max(ty_ok) * ROWS + ROWS + 2 * g.r
        c0 = min(tx_ok) * C + g.lead - g.r
        c1 = max(tx_ok) * C + g.lead + g.r + C
        Y0 = max(y0 + min(ty_ok) * ROWS - sh, 0)
        Y1 = min(y0 + max(ty_ok) * ROWS - sh + ROWS, self.Ho)
        X0 = max(x0 + min(tx_ok) * C - sh, 0)
        X1 = min(x0 + max(tx_ok) * C - sh + C, self.Wo)
        ev: List[Event] = [Read(**tag(it), stage=s, warp=wi, row0=r0,
                                col0=c0, rows=r1 - r0, cols=c1 - c0,
                                elem_bytes=self.storage_bytes,
                                acc_kind=self.read_acc_kind())]
        for f in range(n0, n1):
            ev.append(Store(**tag(it), warp=wi, plane=m, filter=f, row0=Y0,
                            col0=X0, rows=Y1 - Y0, cols=X1 - X0,
                            bytes=(Y1 - Y0) * (X1 - X0) * self.out_bytes))
        return ev


def schedule_model(contract: KernelContract, geometry: RingGeometry,
                   plan: HaloPlan, M: int, blocks: int) -> KernelIR:
    """The ring's schedule for one call of ``M`` planes under ``plan``, on
    ``blocks`` blocks per launch (at most one per item)."""
    return RingModel(contract, geometry, plan, M, blocks).run()


# ---------------------------------------------------------------------------
# The card's log
# ---------------------------------------------------------------------------

_LOADERS = {0: "thread", 1: "tma"}
_ACC = {1: "int32", 2: "float32"}


def from_device_log(log, *, contract: KernelContract, plan: HaloPlan,
                    M: int) -> KernelIR:
    """Decode the trace build's log (``kernels/filter2d/trace.py::
    traced_call``: an int32 [records, 16] tensor or array, a header row per
    launch then its events) into a :class:`KernelIR`."""
    import numpy as np
    rows = np.asarray(log.cpu() if hasattr(log, "cpu") else log,
                      dtype=np.int64)
    if rows.ndim != 2 or rows.shape[1] != 16:
        raise AnalysisError(f"a trace log is [records, 16]; got "
                            f"{rows.shape}")
    geo = halo.plan_ring_geometry(plan)
    H, W = plan.rows.extent, plan.cols.extent
    Ho, Wo = out_shape(H, W, 2 * plan.rows.r + 1, BorderSpec(plan.policy))
    launches, events = [], []
    for r in rows.tolist():
        kind, launch, block, item, seq, stage, warp = r[:7]
        a = r[7:]
        if kind == 0:                     # the host's header row
            launches.append(LaunchInfo(launch=launch, n0=r[3], n1=r[4],
                                       blocks=r[2], smem_bytes=r[5]))
            continue
        t = dict(launch=launch, block=block, item=item, seq=seq)
        if kind == 1:
            events.append(WaitEmpty(**t, stage=stage, parity=a[0]))
        elif kind == 2:
            events.append(ExpectTx(**t, stage=stage, bytes=a[0]))
        elif kind == 3:
            events.append(Load(**t, stage=stage, plane=a[0], row0=a[1],
                               col0=a[2], rows=a[3], cols=a[4],
                               elem_bytes=a[5], loader=_LOADERS[a[6]]))
        elif kind == 4:
            events.append(WaitFull(**t, stage=stage, parity=a[0], warp=warp))
        elif kind == 5:
            bits = (a[2] & 0xffffffff) | ((a[3] & 0xffffffff) << 32)
            value = struct.unpack("<d", struct.pack("<Q", bits))[0]
            events.append(MuxWrite(**t, stage=stage, warp=warp, slots=a[0],
                                   value=value if a[1] else None))
        elif kind == 6:
            events.append(Read(**t, stage=stage, warp=warp, row0=a[0],
                               col0=a[1], rows=a[2], cols=a[3],
                               elem_bytes=a[4], acc_kind=_ACC[a[5]]))
        elif kind == 7:
            events.append(Arrive(**t, stage=stage, warp=warp))
        elif kind == 8:
            events.append(Store(**t, warp=warp, plane=a[0], filter=a[1],
                                row0=a[2], col0=a[3], rows=a[4], cols=a[5],
                                bytes=a[6]))
        else:
            raise AnalysisError(f"unknown event kind {kind} in the log")
    if not launches:
        raise AnalysisError("the log has no launch header")
    return KernelIR(name="filter2d_halo", source="device", contract=contract,
                    geometry=geo, frame=(M, H, W), out=(Ho, Wo),
                    shift=plan.rows.r - plan.rows.off, policy=plan.policy,
                    launches=tuple(launches), events=tuple(events))


def schedule_diff(a: KernelIR, b: KernelIR, limit: int = 5) -> List[str]:
    """Where two schedules of one call differ (empty when they agree):
    the launches' chunks and blocks, each block's producer events in
    order, and each item's consumer events as a multiset."""
    diffs: List[str] = []
    la = [(x.launch, x.n0, x.n1, x.blocks) for x in a.launches]
    lb = [(x.launch, x.n0, x.n1, x.blocks) for x in b.launches]
    if la != lb:
        diffs.append(f"launches differ: {la} vs {lb}")
    ba, bb = a.blocks(), b.blocks()
    if set(ba) != set(bb):
        diffs.append(f"blocks differ: {sorted(set(ba) ^ set(bb))[:limit]}")
    for key in sorted(set(ba) & set(bb)):
        pa = [e.body() for e in ba[key] if isinstance(e, PRODUCER)]
        pb = [e.body() for e in bb[key] if isinstance(e, PRODUCER)]
        if pa != pb:
            at = next((i for i, (x, y) in enumerate(zip(pa, pb)) if x != y),
                      min(len(pa), len(pb)))
            diffs.append(f"(launch, block) {key}: producer event {at} "
                         f"differs: {pa[at:at + 1]} vs {pb[at:at + 1]} "
                         f"({len(pa)} vs {len(pb)} events)")
        ca, cb = defaultdict(Counter), defaultdict(Counter)
        for e in ba[key]:
            if not isinstance(e, PRODUCER):
                ca[e.item][e.body()] += 1
        for e in bb[key]:
            if not isinstance(e, PRODUCER):
                cb[e.item][e.body()] += 1
        for it in sorted(set(ca) | set(cb)):
            if ca[it] != cb[it]:
                extra = list((ca[it] - cb[it]).elements())[:2]
                missing = list((cb[it] - ca[it]).elements())[:2]
                diffs.append(f"(launch, block) {key} item {it}: consumer "
                             f"events differ: only in the first "
                             f"{extra}, only in the second {missing}")
        if len(diffs) >= limit:
            break
    return diffs[:limit]
