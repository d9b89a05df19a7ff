"""Static halo planning: the reference's strip/tile geometry and byte
accounting, kept so the port's pipelines report the same plan.

The reference's Pallas kernel streams each (row strip × lane-aligned column
tile) window from HBM into a VMEM scratch with halo margins and resolves
the border policy on the scratch edges. ``make_plan`` turns (frame, window,
strip, tile, BorderSpec) geometry into per-edge ``AxisClass`` records;
``derive_strip_tile`` sizes strip and tile against a VMEM budget; the
``*_bytes_per_pixel`` functions and ``read_amplification`` state the HBM
traffic of that schedule.

The port keeps this planning half verbatim (parity-tested against the
reference) as *accounting*: ``CompiledFilter.plan`` is the reference's
plan for the same spec and geometry, and plan-time errors (frames below a
policy's ``min_extent``) surface at compile time exactly as they do there.
The CUDA kernel (``kernels/filter2d/csrc``) does **not** take its thread
block tiling from ``strip_h``/``tile_w``: those are sized for a TPU core's
VMEM, while a Hopper thread block holds at most 227 KB of shared memory
and many blocks run at once. The kernel uses its own fixed output tile
(see ``kernels/filter2d/kernel.py``); the plan's ``policy``, ``constant``
(already quantized to the storage dtype), radius, offset and ``requant``
are what it reads.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import dtypes
from repro_torch.core.border_spec import (BorderSpec, check_min_extent,
                                          quantize_constant)
from repro_torch.core.requant import RequantSpec
from repro_torch.obs import events as obs_events

LANE = 128  # the reference TPU lane width: last-dim alignment of the plan

# Default per-step VMEM budget for derived strip/tile geometry (the
# reference's default; it sizes the accounting plan, not the CUDA tiling).
DEFAULT_VMEM_BUDGET = 8 * 2 ** 20


# ---------------------------------------------------------------------------
# Static geometry: axis classes and the halo plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AxisClass:
    """Static DMA/mux geometry of one *edge* block along one axis.

    The scratch window of block ``index`` covers frame elements
    ``[index·B - off, index·B - off + B + 2r)``. ``size`` in-frame elements
    starting at frame ``src0`` land at scratch offset ``dst0``; ``head``
    elements before the frame and ``tail`` elements past it are halo slots
    the policy mux fills. Window slots past ``dst0 + size + tail`` feed only
    cropped outputs and are left untouched.
    """

    index: int
    src0: int
    dst0: int
    size: int
    head: int
    tail: int


@dataclasses.dataclass(frozen=True)
class AxisPlan:
    """One axis (rows or cols) of the halo plan: frame extent ``extent``
    split into ``n`` grid blocks of ``block`` output elements, window
    radius ``r``, window offset ``off`` (r for same-size policies, 0 for
    neglect), and the static edge classes. Blocks not covered by an edge
    class are *interior*: full-size windows at dynamic offset
    ``index·block - off``, entirely in-frame."""

    extent: int
    block: int
    n: int
    r: int
    off: int
    specials: Tuple[AxisClass, ...]


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """The full static plan: row axis × col axis × policy. ``eh × ew`` is
    the VMEM scratch (``ew`` lane-padded); hashable, closed over by the
    kernel body. ``dtype_bytes`` is the *storage* width the stream moves
    at (1 for int8 frames — the paper's B=8 pixel bus), and ``constant``
    is already quantized against that storage dtype.

    The output side is plan geometry too: ``out_dtype_bytes`` is the
    width each pixel is *written* at, and ``requant`` (when set) is the
    fused scale→round→saturate epilogue that narrows the int32
    accumulator back to storage width before the store — the write-side
    half of the paper's B-bit bus."""

    policy: str
    constant: float
    rows: AxisPlan
    cols: AxisPlan
    eh: int
    ew: int
    dtype_bytes: int = 4
    out_dtype_bytes: int = 4
    requant: Optional[RequantSpec] = None
    acc_bytes: int = 4                   # MAC accumulator width (int32/float)


def _axis_class(i: int, L: int, B: int, r: int, off: int) -> AxisClass:
    a = i * B - off                       # scratch 0 ≡ frame element a
    src0 = max(a, 0)
    b = min(L, a + B + 2 * r)
    size = b - src0
    assert size >= 1, (i, L, B, r, off)
    # halo slots past the frame that still feed valid (un-cropped) outputs
    tail = max(0, min(off, a + B + 2 * r - L))
    return AxisClass(index=i, src0=src0, dst0=src0 - a, size=size,
                     head=src0 - a, tail=tail)


def _axis_plan(L: int, B: int, r: int, same_size: bool) -> AxisPlan:
    off = r if same_size else 0
    out_extent = L if same_size else L - 2 * r
    assert out_extent >= 1 and B >= 1, (L, r, B)
    n = max(1, -(-out_extent // B))      # B may exceed out_extent (lane pad)
    if n > 1:
        # with B >= 2r only the first and the last two blocks can touch a
        # frame edge; everything else is interior (proved by B > r twice)
        assert B >= 2 * r, (B, r)
    specials = {}
    for i in (0, n - 2, n - 1):
        if i < 0 or i in specials:
            continue
        c = _axis_class(i, L, B, r, off)
        if c.head or c.tail or c.size < B + 2 * r:
            specials[i] = c
    for i in range(n):                    # interior blocks are fully in-frame
        if i not in specials:
            a = i * B - off
            assert a >= 0 and a + B + 2 * r <= L, (i, a, L)
    return AxisPlan(extent=L, block=B, n=n, r=r, off=off,
                    specials=tuple(specials[k] for k in sorted(specials)))


def datapath_byte_widths(dtype, requant: Optional[RequantSpec] = None
                         ) -> Tuple[int, int, int]:
    """(storage, accumulator, output) byte widths of one datapath.

    THE single statement of the fixed-point width rule (paper §IV):
    integer frames stream at storage width and accumulate in int32; the
    output leaves at the accumulator width unless a requantising epilogue
    narrows it back to its storage dtype. ``make_plan``,
    ``derive_strip_tile`` and the ``CompiledFilter`` planner all consume
    this one helper so the auto-selection estimate can never drift from
    the plan the kernel runs."""
    db = dtypes.itemsize(dtype)
    integer = dtypes.is_integer(dtype)
    acc = 4 if integer else db
    out = requant.dtype_bytes if requant is not None else acc
    return db, acc, out


def make_plan(H: int, W: int, w: int, spec: BorderSpec, strip_h: int,
              tile_w: int, dtype=np.float32,
              requant: Optional[RequantSpec] = None) -> HaloPlan:
    """Build the static halo plan for an (H, W) frame, w×w window, strip
    height ``strip_h`` and lane-aligned tile width ``tile_w``. ``dtype``
    is the frame's *storage* dtype: it sets the plan's byte accounting
    (``read_bytes_per_pixel``) and quantizes the ``constant(c)`` border
    value to what the narrow stream can actually hold — the same shared
    rule (``border_spec.quantize_constant``) the core oracle applies.

    ``requant`` bakes the fused output scaler into the plan: integer
    frames then *write* at the spec's storage width instead of the int32
    accumulator's 4 bytes (``out_dtype_bytes`` follows suit — the number
    ``hbm_write_bytes_per_pixel`` reports). Float frames take no requant.
    """
    r = (w - 1) // 2
    check_min_extent(spec, r, H, W)
    integer = dtypes.is_integer(dtype)
    if requant is not None and not integer:
        raise ValueError("requant is the fixed-point epilogue; "
                         f"storage dtype {dtypes.name(dtype)} takes none")
    db, acc_bytes, out_bytes = datapath_byte_widths(dtype, requant)
    rows = _axis_plan(H, strip_h, r, spec.same_size)
    cols = _axis_plan(W, tile_w, r, spec.same_size)
    eh = rows.block + 2 * r
    ew = cols.block + 2 * r
    ew += (-ew) % LANE
    return HaloPlan(policy=spec.policy,
                    constant=quantize_constant(spec.constant, dtype),
                    rows=rows, cols=cols, eh=eh, ew=ew,
                    dtype_bytes=db, out_dtype_bytes=out_bytes,
                    requant=requant, acc_bytes=acc_bytes)


def derive_strip_tile(H: int, W: int, w: int, *, dtype=np.float32,
                      vmem_budget: int = DEFAULT_VMEM_BUDGET,
                      num_filters: int = 1, separable: bool = False,
                      requant: Optional[RequantSpec] = None,
                      same_size: bool = True,
                      strip_h: Optional[int] = None,
                      tile_w: Optional[int] = None,
                      overlap: bool = True) -> Tuple[int, int]:
    """Pick ``(strip_h, tile_w)`` for a stream plan from a VMEM budget.

    The autotuning rule the ROADMAP asked for, from static accounting only
    (the same terms as ``stream_vmem_working_set``). With
    ``overlap`` (the default — the double-buffered kernel) the scratch and
    the output tile are both banked ×2, so each bank sees half the
    effective budget; the selection co-models that doubling rather than
    halving the budget after the fact.

    Both knobs free: every lane-aligned tile width from the full output
    width down to one lane is a candidate; each gets the deepest strip the
    (banked) budget holds at that width, and the candidate minimising the
    read amplification (1 + 2r/strip)(1 + 2r/tile) wins — with a 2% slack
    in favour of *wider* tiles, which amortise the row-mux work and DMA
    descriptors over longer rows at equal traffic. Narrow storage dtypes
    and a requantised output tile free bank bytes, which lands here as
    deeper strips (or full-width tiles at the same depth).

    A caller-supplied ``strip_h``/``tile_w`` is honoured verbatim (clamped
    to the frame) and only the *free* knob is derived against it: a fixed
    tile gets the deepest strip the budget holds at that width; a fixed
    strip gets the widest tile that still fits that many rows.

    Edge cases clamp instead of overderiving: frames narrower than one
    lane tile or shallower than ``max(2r, 8)`` collapse to the degenerate
    1-strip/1-tile plan (``strip_h <= Ho``, ``tile_w <= wo_pad`` always),
    and starved budgets clamp to the minimum viable strip — the plan then
    overruns the budget rather than breaking the ``strip >= 2r`` invariant
    multi-strip plans require.
    """
    r = (w - 1) // 2
    Ho = H if same_size else max(H - 2 * r, 1)
    Wo = W if same_size else max(W - 2 * r, 1)
    db, acc_b, out_b = datapath_byte_widths(dtype, requant)
    coeff = num_filters * (2 * w if separable else w * w) * acc_b
    s_min = max(2 * r, 8)
    wo_pad = Wo + (-Wo) % LANE
    banks = 2 if overlap else 1

    def _traced(s: int, t: int, cands=(), why: str = "") -> Tuple[int, int]:
        # decision-trace emission: the candidate scan and the winner land
        # as one PlanEvent when observability is on; pure pass-through off
        if obs_events.enabled():
            obs_events.emit(obs_events.PlanEvent(
                H=int(H), W=int(W), window=int(w),
                dtype=dtypes.name(dtype), vmem_budget=int(vmem_budget),
                overlap=bool(overlap),
                candidates=tuple((int(ct), int(cs), float(ca))
                                 for ct, cs, ca in cands),
                strip_h=int(s), tile_w=int(t), why=why))
        return s, t

    def max_strip(tile: int) -> int:
        ew = tile + 2 * r
        ew += (-ew) % LANE
        per_row = banks * (ew * db + tile * out_b)
        avail = vmem_budget - coeff - banks * 2 * r * ew * db
        return int(avail // per_row) if avail > 0 else 0

    def clamp_strip(s: int) -> int:
        s = max(s, s_min)
        if s > 8:
            # sublane-align deep strips, never dropping below the s_min
            # floor (multi-strip plans require strip >= 2r)
            s = max(s - s % 8, s_min)
        return max(min(s, Ho), 1)

    if tile_w is not None:
        tile = max(min(tile_w + (-tile_w) % LANE, wo_pad), LANE)
        if strip_h is not None:
            return _traced(max(min(int(strip_h), Ho), 1), int(tile),
                           why="caller fixed both knobs (clamped to frame)")
        return _traced(clamp_strip(max_strip(tile)), int(tile),
                       why=f"caller fixed tile_w={int(tile)}: deepest "
                           "strip the banked budget holds at that width")

    if strip_h is not None:
        # fixed strip: widest tile whose banked budget holds that many rows
        want = max(int(strip_h), s_min)
        tile = wo_pad
        while max_strip(tile) < want and tile > LANE:
            tile = max(LANE, tile // 2 - (tile // 2) % LANE)
        return _traced(max(min(int(strip_h), Ho), 1), int(tile),
                       why=f"caller fixed strip_h={int(strip_h)}: widest "
                           "tile whose banked budget holds that depth")

    cands = []                            # widest tile first
    tile = wo_pad
    while True:
        s = clamp_strip(max_strip(tile))
        amp = (1 + 2 * r / s) * (1 + 2 * r / tile)
        cands.append((tile, s, amp))
        if tile <= LANE:
            break
        tile = max(LANE, tile // 2 - (tile // 2) % LANE)
    best = min(a for _, _, a in cands)
    for tile, s, amp in cands:
        if amp <= best * 1.02:            # widest within 2% of optimal
            return _traced(s, int(tile), cands=cands,
                           why=f"widest tile within 2% of the minimum "
                               f"read amplification ({best:.4f}) over "
                               f"{len(cands)} lane-aligned candidates")
    raise AssertionError("unreachable: best candidate always qualifies")


def read_amplification(plan: HaloPlan) -> float:
    """HBM elements DMA'd per plane / frame elements — the cost analysis of
    the read-once claim. The main DMAs factor as (Σ row sizes)(Σ col sizes);
    wrap adds its O(r)-wide opposite-edge and corner fetches. ≈1 + 2r/S +
    2r/Tw at the defaults; the pre-materialized layout this engine replaced
    cost an extra full read+write frame pass on top of that."""
    def sizes(ax: AxisPlan):
        by_idx = {c.index: c for c in ax.specials}
        return sum(by_idx[i].size if i in by_idx else ax.block + 2 * ax.r
                   for i in range(ax.n))

    rs, cs = sizes(plan.rows), sizes(plan.cols)
    total = rs * cs
    if plan.policy == "wrap":
        rh = sum(c.head + c.tail for c in plan.rows.specials)
        ch = sum(c.head + c.tail for c in plan.cols.specials)
        total += rh * cs + ch * rs + rh * ch
    return total / float(plan.rows.extent * plan.cols.extent)


def read_bytes_per_pixel(plan: HaloPlan) -> float:
    """HBM bytes *read* per frame pixel — the dtype-aware restatement of
    the read-once claim. An int8 stream reads ≈1.05 bytes/pixel at the
    default strip/tile sizes where float32 reads ≈4.2: the paper's 4×
    narrow-wordlength win, asserted structurally from the plan rather
    than measured."""
    return read_amplification(plan) * plan.dtype_bytes


def hbm_write_bytes_per_pixel(plan: HaloPlan) -> float:
    """HBM bytes *written* per output pixel — the write-side twin of
    ``read_bytes_per_pixel``, from the same static plan. One store per
    output pixel at ``out_dtype_bytes``: 4 for the wide accumulator
    (int32 / float32), the storage width when the plan carries a
    requantising epilogue — an int8-in/int8-out plan writes 1 byte/pixel,
    closing the paper's B-bit bus in BOTH directions."""
    return float(plan.out_dtype_bytes)


def hbm_bytes_per_pixel(plan: HaloPlan,
                        out_dtype_bytes: Optional[int] = None) -> float:
    """Total HBM round-trip traffic per pixel: the read side from the plan
    (storage dtype × read amplification) plus one output write at the
    plan's write width (``out_dtype_bytes`` overrides — kept for callers
    accounting a different epilogue than the plan's). An int8 frame with
    an int8 requant epilogue rounds to ≈2 bytes/pixel where the
    pre-epilogue datapath paid ≈5."""
    if out_dtype_bytes is None:
        out_dtype_bytes = plan.out_dtype_bytes
    return read_bytes_per_pixel(plan) + float(out_dtype_bytes)


# ---------------------------------------------------------------------------
# Working-set accounting of the reference kernel's schedule
# ---------------------------------------------------------------------------


def stream_vmem_working_set(strip_h: int, tile_w: int, w: int,
                            dtype_bytes: int = 4, *,
                            separable: bool = False,
                            num_filters: int = 1,
                            acc_dtype_bytes: int = None,
                            out_dtype_bytes: int = None,
                            ext_banks: int = 1,
                            out_banks: int = 1) -> int:
    """Bytes resident in VMEM per stream grid step (the row-buffer bound).

    ``ext_banks`` × the halo-extended scratch + ``out_banks`` × the output
    tile + the coefficient file. A function of (strip_h, tile_w, w, banks)
    ONLY — never of the frame dimensions; this is the invariant the 2D
    tiling exists to provide. The in-kernel halo engine keeps the scratch
    single-purpose (strip buffer AND line buffer in one block, DMA'd from
    HBM directly — no second input tile); the double-buffered kernel banks
    that scratch and the output tile ×2 (pass the counts
    :func:`plan_banks` computes) to overlap the next strip's DMA and the
    previous tile's store with the reduction.

    Dtype-aware in both directions: ``dtype_bytes`` is the *storage* width
    (the scratch the DMA fills), ``acc_dtype_bytes`` the accumulator width
    (defaults to the storage width — pass 4 for the fixed-point
    int8/int16-in datapath, where the scratch shrinks 4×/2× but the
    coefficient file stays wide), and ``out_dtype_bytes`` the width of the
    output tile (defaults to the accumulator width; pass the storage width
    when the plan carries the requantising epilogue — the output tile then
    shrinks 4× along with the write-side HBM traffic, freeing VMEM for
    deeper strips).
    """
    if acc_dtype_bytes is None:
        acc_dtype_bytes = dtype_bytes
    if out_dtype_bytes is None:
        out_dtype_bytes = acc_dtype_bytes
    r = (w - 1) // 2
    ew = tile_w + 2 * r
    ew += (-ew) % LANE                   # lane padding, as the plan lays out
    ext_scratch = ext_banks * (strip_h + 2 * r) * ew * dtype_bytes
    out_tile = out_banks * strip_h * tile_w * out_dtype_bytes
    coeff = num_filters * (2 * w if separable else w * w) * acc_dtype_bytes
    return ext_scratch + out_tile + coeff


def plan_banks(plan: HaloPlan, num_filters: int = 1,
               overlap: bool = True) -> tuple:
    """(ext_banks, out_banks) the reference kernel allocates for this plan
    (``src/repro/kernels/filter2d/kernel.py::plan_banks``).

    The input scratch is double-banked only when there is a next strip to
    prefetch (``rows.n > 1``); the output buffer only when there is a
    later step to pre-wait behind (more than one (strip, filter) step per
    tile). Accounting of the reference's Pallas schedule: the CUDA
    kernel's ring of shared-memory stages is its own."""
    if not overlap:
        return 1, 1
    ext_banks = 2 if plan.rows.n > 1 else 1
    out_banks = 2 if plan.rows.n * num_filters > 1 else 1
    return ext_banks, out_banks


def plan_vmem_working_set(plan: HaloPlan, *, num_filters: int = 1,
                          separable: bool = False,
                          overlap: bool = True) -> int:
    """VMEM bytes per grid step of the reference schedule, straight from a
    built plan (``src/repro/kernels/filter2d/kernel.py::
    plan_vmem_working_set``): the plan's ``eh × ew`` scratch at storage
    width, the ``strip × tile`` output tile at the plan's write width and
    the coefficient file at the accumulator width, each times the bank
    count :func:`plan_banks` gives."""
    w = 2 * plan.rows.r + 1
    ext_banks, out_banks = plan_banks(plan, num_filters, overlap)
    scratch = ext_banks * plan.eh * plan.ew * plan.dtype_bytes
    out_tile = (out_banks * plan.rows.block * plan.cols.block
                * plan.out_dtype_bytes)
    coeff = num_filters * (2 * w if separable else w * w) * plan.acc_bytes
    return scratch + out_tile + coeff


# ---------------------------------------------------------------------------
# The Hopper planning mode: the CUDA ring's own geometry and shared memory
# ---------------------------------------------------------------------------
#
# Python twins of ``csrc/filter2d_halo_ring.cuh::geometry`` and
# ``smem_bytes``: the thread-block tiling the kernel really runs, a ring of
# STAGES windows of (strip + 2r) rows per block, held in shared memory
# beside the coefficient file. ``kernel.py::geometry`` reads the same
# numbers from the built library; ``chip_smoke.py`` holds the two equal.
# The reference accounting above stays what ``explain()`` reports; these
# figures feed the kernel verifier (``repro_torch.analysis``) and the
# compile-time refusal of windows the ring cannot hold.

RING_TILE_W = 128            # centre columns per item
RING_CONSUMERS = 256         # consumer threads: 8 warps
RING_THREADS = RING_CONSUMERS + 32   # and one producer warp
RING_STAGES = 3              # windows in the ring
# an H100 block's opt-in dynamic shared memory (227 KiB), and its SM's
# (228 KiB, 1 KiB of it reserved per resident block)
SMEM_BLOCK_LIMIT = 227 * 1024
SMEM_SM_BYTES = 228 * 1024
SMEM_BLOCK_RESERVED = 1024
MAX_THREADS_PER_SM = 2048
H100_SMS = 132               # the SXM5 part's SMs
TMA_BOX_LIMIT = 256          # a TMA box is at most 256 elements a side
# the coefficient file's bytes per launch: beside three stages of <= 21 KiB
# (w <= 7) it keeps two blocks on an SM; a larger bank is split into
# launches of as many filters as fit (at least one, if the block fits)
COEFF_FILE_BYTES = 24 * 1024
COEFF_BYTES = 4              # float32 or int32 coefficients
# the generic tree's counter (``ring.cuh::tree_levels``): its level cases
# (a kernel each), the smallest of which that holds w*w a launch takes,
# and the levels a push settles in the tap's own code before it carries
TREE_LEVEL_CASES = (8, 10, 12, 13)
TREE_TAPS_LIMIT = 1 << TREE_LEVEL_CASES[-1]   # w*w < 2^13: w <= 89
TREE_LOW = 4
RING_CHUNK = 16              # a window row's taps run in chunks of 16
# the largest window with an instantiation of its own; every larger odd
# window runs the generic one (``ring.cuh::dispatch``)
RING_FIXED_MAX = 7

GEOMETRY_KEYS = ("tile_w", "strip_h", "cols_per_thread", "rows_per_thread",
                 "threads", "stages", "stage_bytes", "row_pitch_bytes")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class RingGeometry:
    """The ring's tile geometry for storage bytes ``s``, output bytes
    ``so`` and window ``w`` (``ring.cuh::geometry``). ``lead`` is the box's
    columns left of the tile (r·s rounded up to 16 bytes, at least 16),
    ``box_w`` × ``eh`` the TMA box (= one stage's rows of ``pitch``
    bytes), ``stage`` the 128-byte aligned stage."""

    s: int
    so: int
    w: int
    r: int
    cols_per_thread: int
    rows_per_thread: int
    tx: int
    strip_h: int
    eh: int
    g: int
    pitch: int
    stage: int
    lead: int
    box_w: int

    def as_dict(self) -> dict:
        """The keys of ``kernel.py::geometry`` (the library's own)."""
        return dict(zip(GEOMETRY_KEYS, (
            RING_TILE_W, self.strip_h, self.cols_per_thread,
            self.rows_per_thread, RING_THREADS, RING_STAGES, self.stage,
            self.pitch)))


def ring_geometry(s: int, so: int, w: int) -> RingGeometry:
    """Twin of ``filter2d_halo_ring.cuh::geometry(s, so, w)``: a thread
    takes 16 bytes of output columns and 4 rows (2 at 16 columns), and
    the float32 generic window (w > 7) 8 x 2 outputs."""
    r = w // 2
    wide = w > RING_FIXED_MAX and s == 4 and so == 4
    C = 8 if wide else 16 // so
    ROWS = 2 if wide or C == 16 else 4
    TX = RING_TILE_W // C
    SH = (RING_CONSUMERS // TX) * ROWS
    lead_bytes = _round_up(r * s, 16) if r * s > 16 else 16
    pitch = _round_up(RING_TILE_W * s + lead_bytes + _round_up(r * s, 4), 16)
    return RingGeometry(s=s, so=so, w=w, r=r, cols_per_thread=C,
                        rows_per_thread=ROWS, tx=TX, strip_h=SH,
                        eh=SH + 2 * r, g=min(C * s, 16), pitch=pitch,
                        stage=_round_up((SH + 2 * r) * pitch, 128),
                        lead=lead_bytes // s, box_w=pitch // s)


def plan_ring_geometry(plan: HaloPlan) -> RingGeometry:
    """The ring geometry of the launch that runs ``plan`` (its storage
    and output widths and window)."""
    return ring_geometry(plan.dtype_bytes, plan.out_dtype_bytes,
                         2 * plan.rows.r + 1)


def ring_coeff_words(w: int, separable: bool) -> int:
    """Twin of ``ring.cuh::coeff_words``: the 4-byte words of one filter
    in the launch's coefficient file. A window with an instantiation of
    its own (w ≤ 7) keeps the bank's layout; the generic path pads each
    filter row (w of them, or the separable u and v) to a multiple of 4
    words, room enough for the packed bytes of its dp4a route too."""
    rows = 2 if separable else w
    return rows * (w if w <= RING_FIXED_MAX else _round_up(w, 4))


def ring_smem_bytes(geo: RingGeometry, num_filters: int,
                    separable: bool = False) -> int:
    """Twin of ``ring.cuh::smem_bytes``: a launch's dynamic shared memory
    for ``num_filters`` filters — alignment slack, the ring, the full and
    empty barriers, the coefficients and the requant table."""
    return (128 + RING_STAGES * geo.stage + 16 * RING_STAGES
            + num_filters * ring_coeff_words(geo.w, separable)
            * COEFF_BYTES
            + num_filters * 8)


def chunk_filters(geo: RingGeometry, separable: bool = False) -> int:
    """Filters per launch: as many as the coefficient file holds (at least
    one), and no more than leave the block within its shared memory; 0
    when not even one filter fits beside the ring."""
    per = ring_coeff_words(geo.w, separable) * COEFF_BYTES + 8
    room = SMEM_BLOCK_LIMIT - ring_smem_bytes(geo, 0)
    return max(0, min(max(1, COEFF_FILE_BYTES // per), room // per))


def ring_refusal(geo: RingGeometry, separable: bool = False
                 ) -> Optional[str]:
    """Why the ring cannot run this geometry (``None`` when it can): a
    TMA box past 256 elements a side, a window whose three stages and one
    filter's coefficients pass the block's shared memory, or a generic
    tree past its counter."""
    if geo.box_w > TMA_BOX_LIMIT or geo.eh > TMA_BOX_LIMIT:
        return (f"its TMA box of {geo.box_w} x {geo.eh} elements passes the "
                f"limit of {TMA_BOX_LIMIT} a side")
    need = ring_smem_bytes(geo, 1, separable)
    if need > SMEM_BLOCK_LIMIT:
        return (f"{RING_STAGES} stages of {geo.stage} B and one filter's "
                f"coefficients take {need} B of shared memory, past the "
                f"{SMEM_BLOCK_LIMIT} B a block may hold")
    # the tree runs for float frames only (integer frames fold in every
    # form): storage and output of one width, 4 or 2 bytes; never for the
    # separable form
    tree = not separable and geo.s == geo.so and geo.s in (2, 4)
    if tree and geo.w * geo.w >= TREE_TAPS_LIMIT:
        return f"its {geo.w * geo.w} taps pass the tree's {TREE_TAPS_LIMIT}"
    return None


def tree_levels(w: int) -> int:
    """Twin of ``ring.cuh::tree_levels``: the counter levels a generic tree
    launch of window ``w`` takes, the smallest case that holds w*w."""
    for levels in TREE_LEVEL_CASES:
        if w * w < 1 << levels:
            return levels
    raise ValueError(f"w={w}: {w * w} taps pass the tree's "
                     f"{TREE_TAPS_LIMIT}")


def tree_schedule_sum(products, w: int) -> np.ndarray:
    """The generic tree's sums as the kernel forms them
    (``ring.cuh::tree_chunk`` and ``tree_fold``): ``products`` is
    [w*w, P] float32, the taps of P pixels in raster order. Each window
    row's taps run in chunks of 16; a push of tap t adds the blocks its
    trailing ones complete (each level's left block first), settling the
    levels below ``TREE_LOW`` at once and leaving a push that climbs past
    them as the chunk's carry, which goes up the higher levels after the
    chunk. The blocks left, one per set bit of w*w, fold from the right.
    numpy's float32 adds round as ``__fadd_rn`` does."""
    p = np.asarray(products, dtype=np.float32)
    if p.shape[0] != w * w:
        raise ValueError(f"{p.shape[0]} products for w={w}")
    levels = tree_levels(w)
    st = [None] * levels
    for i in range(w):
        for j0 in range(0, w, RING_CHUNK):
            t0 = i * w + j0
            carry = None
            for t in range(t0, t0 + min(RING_CHUNK, w - j0)):
                v, L = p[t], 0
                while (t >> L) & 1 and L < TREE_LOW:
                    v = st[L] + v
                    L += 1
                if L < TREE_LOW:
                    st[L] = v
                else:
                    carry = (t, v)
            if carry is not None:
                tc, v = carry
                L = TREE_LOW
                while (tc >> L) & 1:
                    v = st[L] + v
                    L += 1
                st[L] = v
    out = None
    for L in range(levels):
        if (w * w >> L) & 1:
            out = st[L] if out is None else st[L] + out
    return out


def max_ring_window(s: int, so: int, separable: bool = False) -> int:
    """The largest odd window the ring runs for these widths."""
    best, w = 0, 1
    while ring_refusal(ring_geometry(s, so, w), separable) is None:
        best, w = w, w + 2
    return best


def check_ring_fits(w: int, dtype, requant: Optional[RequantSpec] = None,
                    separable: bool = False) -> None:
    """Refuse, at compile time, a window the CUDA ring cannot run for
    frames of ``dtype`` (its message names the limit and the largest
    window that fits); windows that fit pass."""
    s, _, so = datapath_byte_widths(dtype, requant)
    why = ring_refusal(ring_geometry(s, so, w), separable)
    if why is not None:
        raise ValueError(
            f"the CUDA kernel cannot run w={w} for {dtypes.name(dtype)} "
            f"frames: {why}; the largest window it runs for them is "
            f"{max_ring_window(s, so, separable)}")


def coeff_chunks(num_filters: int, geo: RingGeometry,
                 separable: bool = False) -> Tuple[Tuple[int, int], ...]:
    """The bank's launches: ``(n0, n1)`` filter ranges of at most
    :func:`chunk_filters` each, in order."""
    per = chunk_filters(geo, separable)
    if per < 1:
        raise ValueError(f"no filter fits beside the ring for w={geo.w}")
    return tuple((n0, min(n0 + per, num_filters))
                 for n0 in range(0, num_filters, per))


def smem_working_set(plan: HaloPlan, *, num_filters: int = 1,
                     separable: bool = False) -> int:
    """Shared memory of one ring launch for ``plan`` — the Hopper
    counterpart of :func:`plan_vmem_working_set`: the three stages, the
    barriers, and the coefficient file of the launch's chunk (the bank's
    first, and largest, when it takes several)."""
    geo = plan_ring_geometry(plan)
    n = coeff_chunks(num_filters, geo, separable)[0]
    return ring_smem_bytes(geo, n[1] - n[0], separable)


def ring_items(geo: RingGeometry, H: int, W: int, M: int
               ) -> Tuple[int, int, int]:
    """(tiles, strips, items) of one launch over [M, H, W] planes:
    centres cover the frame for every policy."""
    tiles = -(-W // RING_TILE_W)
    strips = -(-H // geo.strip_h)
    return tiles, strips, M * tiles * strips


def ring_blocks(geo: RingGeometry, smem: int, items: int,
                sms: int = H100_SMS) -> int:
    """The blocks a launch takes as far as shared memory and threads
    decide (the card's occupancy query may also count registers): as many
    as fit on the SMs at once, at most one per item."""
    per_sm = min(MAX_THREADS_PER_SM // RING_THREADS,
                 SMEM_SM_BYTES // (smem + SMEM_BLOCK_RESERVED))
    return max(1, min(items, per_sm * sms))


def _clipped(lo: int, n: int, extent: int) -> int:
    return max(0, min(lo + n, extent) - max(lo, 0))


def ring_read_amplification(plan: HaloPlan) -> float:
    """Frame bytes the ring loads per sweep over the frame's bytes, per
    coefficient chunk: every item's box of ``eh`` rows from ``r`` above
    its strip and ``box_w`` columns from ``lead`` left of its tile, only
    its in-frame part read from memory (TMA fills the rest with zeros; the
    per-thread loader writes them). Factors as (Σ rows)(Σ cols)."""
    geo = plan_ring_geometry(plan)
    H, W = plan.rows.extent, plan.cols.extent
    tiles, strips, _ = ring_items(geo, H, W, 1)
    rows = sum(_clipped(i * geo.strip_h - geo.r, geo.eh, H)
               for i in range(strips))
    cols = sum(_clipped(j * RING_TILE_W - geo.lead, geo.box_w, W)
               for j in range(tiles))
    return rows * cols / float(H * W)
