"""The kernel's *declared* dataflow contract, in the CUDA ring's terms.

The kernel verifier (``repro_torch.analysis``) checks an event trace of the
ring's schedule against invariants, but a trace only carries stage
numbers, warps and boxes, not meanings. This module is where the kernel
publishes the meanings: which operand is the frame and which the
coefficient file, what lives in shared memory (the ring of windows, the
full and empty barriers, the coefficients, the requant table), the order
items are taken in, how many stages and warps the ring has, which loader
fills it, and how a bank is cut into launches. It lives beside the code
that makes it true, so the analysis imports the kernels package and never
the reverse — the counterpart of ``src/repro/kernels/filter2d/
contract.py``.

``KernelContract`` is pure data (hashable, ``dataclasses.asdict``-able);
``kernel.py::kernel_contract`` builds one from the plan, the bank, the
form, the storage dtype and the loader. The reference's ``grid_order``,
``overlap`` and bank counts are not carried: the ring has one schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Shared-memory role vocabulary (what the verifier's passes key on):
#   ring      — the STAGES windows the producer fills and the consumers read
#   full_bar  — one mbarrier per stage: the window has landed
#   empty_bar — one mbarrier per stage: every consumer warp is done with it
#   coeffs    — the launch's chunk of the coefficient bank
#   qparams   — the chunk's requant (multiplier, shift) table
SMEM_ROLES = ("ring", "full_bar", "empty_bar", "coeffs", "qparams")

# Item-order vocabulary: items run plane, then column tile, then row strip
# (the reference grid's order); every filter of a chunk is applied to an
# item's window before the next item (the bank innermost).
ITEM_ROLES = ("plane", "tile", "strip", "filter")


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declared dataflow roles of one ``filter2d_halo`` call.

    ``operands``/``outputs`` name the launch's tensors; ``smem`` the
    shared-memory regions in layout order; ``items`` the item order,
    outermost first. ``stages`` windows in the ring, filled by
    ``producer_warps`` (one elected thread under TMA, the warp's 32 lanes
    otherwise) and released by one arrival of each of ``consumer_warps``.
    ``chunks`` are the bank's launches as ``(n0, n1)`` filter ranges."""

    operands: Tuple[str, ...]         # ("frame", "coeffs"[, "qparams"])
    outputs: Tuple[str, ...]          # ("out",)
    smem: Tuple[str, ...]             # roles from SMEM_ROLES, in order
    items: Tuple[str, ...]            # roles from ITEM_ROLES, outermost first
    stages: int
    producer_warps: int
    consumer_warps: int
    loader: str                       # 'tma' | 'thread'
    num_filters: int
    form: str
    has_requant: bool
    storage_dtype: str
    out_dtype: str
    chunks: Tuple[Tuple[int, int], ...]

    @property
    def separable(self) -> bool:
        return self.form == "separable"

    @property
    def arrivals(self) -> int:
        """Arrivals that release a stage: one per consumer warp."""
        return self.consumer_warps
