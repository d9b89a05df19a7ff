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
