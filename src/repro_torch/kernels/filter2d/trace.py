"""The trace build of ``filter2d_halo``: the same kernel source compiled
with ``-DF2D_TRACE`` into a library of its own (``build/
filter2d_halo_trace/``, built at first use like the others), whose launch
also writes the ring's schedule as an event log.

The producer warp and every consumer warp append one record per ring event
(wait on an empty or full barrier, expected bytes, load, border mux, read
of a stage, store, arrival) to a device buffer, numbered by a per-block
shared-memory counter: the producer takes its number after its wait
returns, a consumer before it arrives, so the numbers order the events as
the barriers do. ``repro_torch.analysis.ir.from_device_log`` decodes the
log and the verifier's passes check it.

Only the verifier and ``chip_smoke.py``'s phases 3b, 6d and 6e load this
library; the main path never does. It builds the float32 and int8 units
(the dtypes of the verifier's sweep), the uint8 unit (whose generic window,
like int8's, picks its MAC route per block at run time: :func:`mac_routes`)
and the C entry.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import KernelLibrary
from repro_torch.kernels.filter2d import _build, halo
from repro_torch.kernels.filter2d import kernel as K
from repro_torch.kernels.filter2d.halo import HaloPlan

TRACE_DTYPES = (torch.float32, torch.int8, torch.uint8)
REC_INTS = 16                  # ints per record (ring.cuh REC_INTS)
EV_LAUNCH = 0                  # a header row the host writes per launch
EV_READ = 6                    # a consumer warp's read of a stage (ring.cuh)

# filter2d_halo_trace_launch: filter2d_halo_launch's arguments up to the
# output's bank size, then the blocks, the log and its counter, the
# capacity, the launch's index and first filter, the info int[4], the
# stream
LIBRARY = KernelLibrary(
    "filter2d_halo_trace", _build.CSRC, {
        "filter2d_halo_trace_launch": (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_double]
            + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2),
        "filter2d_halo_geometry": [ctypes.c_int] * 3 + [ctypes.c_void_p],
        "filter2d_halo_smem": [ctypes.c_int] * 5},
    defines=("F2D_TRACE",),
    only=("filter2d_halo.cu", "filter2d_halo_f32.cu", "filter2d_halo_i8.cu",
          "filter2d_halo_u8.cu"))


def capacity(plan: HaloPlan, M: int, n: int) -> int:
    """Records one launch of ``n`` filters can write at most: per item the
    producer's three, and each consumer warp's wait, mux, read, ``n``
    stores and arrival."""
    geo = halo.plan_ring_geometry(plan)
    _, _, items = halo.ring_items(geo, plan.rows.extent, plan.cols.extent, M)
    return items * (3 + (halo.RING_CONSUMERS // 32) * (4 + n))


def traced_call(planes: torch.Tensor, coeffs: torch.Tensor, plan: HaloPlan,
                *, q_params: Optional[torch.Tensor] = None,
                form: str = "direct", loader: Optional[str] = None,
                blocks: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``filter2d_halo`` through the trace build: ``(out, log)``.

    The same operands and result as :func:`kernel.filter2d_halo` (on a
    CUDA tensor), one launch per chunk of the bank. ``loader`` forces
    ``'thread'`` on a frame TMA could take (``None``: the frame's own,
    :func:`kernel.loader_for`); ``blocks`` > 0 fixes each launch's grid.
    ``log`` is an int32 [records, REC_INTS] CPU tensor: per launch one
    header row ``{EV_LAUNCH, launch, blocks, n0, n1, smem bytes, tiles,
    strips, 0...}`` and then its events. A launch error, or a log that
    overflowed its buffer, raises. Leaves ``filter2d_halo``'s counts
    alone: this is not the main path."""
    if planes.device.type != "cuda":
        raise ValueError("the trace build runs on the card; got "
                         f"{planes.device}")
    if planes.dtype not in TRACE_DTYPES:
        raise TypeError(f"the trace build takes {TRACE_DTYPES}; got "
                        f"{planes.dtype}")
    own = K.loader_for(planes)
    loader = own if loader is None else loader
    if loader == "tma" and own != "tma":
        raise ValueError("this frame cannot take the TMA loader")
    out, launches = K.launch_args(planes, coeffs, plan, q_params, form,
                                  loader)
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    rows = []
    with torch.cuda.device(planes.device):
        for launch, (n0, n1, args) in enumerate(launches):
            cap = capacity(plan, planes.shape[0], n1 - n0)
            rec = torch.zeros((cap, REC_INTS), dtype=torch.int32,
                              device=planes.device)
            count = torch.zeros(1, dtype=torch.int32, device=planes.device)
            info = (ctypes.c_int * 4)()
            rc = lib.filter2d_halo_trace_launch(
                *args, int(blocks), rec.data_ptr(), count.data_ptr(), cap,
                launch, n0, info, stream)
            if rc != 0:
                raise RuntimeError(f"filter2d_halo trace launch failed with "
                                   f"CUDA error {rc}")
            torch.cuda.synchronize(planes.device)
            n = int(count.item())
            if n > cap:
                raise RuntimeError(f"trace log overflowed: {n} records for "
                                   f"{cap}")
            head = torch.zeros((1, REC_INTS), dtype=torch.int32)
            head[0, :8] = torch.tensor([EV_LAUNCH, launch, info[1], n0, n1,
                                        info[0], info[2], info[3]])
            rows += [head, rec[:n].cpu()]
    return out, torch.cat(rows)


def mac_routes(log) -> Dict[str, int]:
    """The reads of a :func:`traced_call` log by the route their block's
    products took: ``'dp4a'`` (an 8-bit direct launch of the generic window
    whose coefficient file the block packed, every coefficient in a signed
    byte), ``'int32 MAC'`` (any other integer launch) or ``'float'``. A
    read record's sixth payload int is its accumulator (1: int32, 2:
    float32) and its seventh the block's packed flag; header rows are
    skipped."""
    rows = torch.as_tensor(log).reshape(-1, REC_INTS)
    reads = rows[rows[:, 0] == EV_READ]
    acc, packed = reads[:, 12], reads[:, 13]
    return {"dp4a": int(((acc == 1) & (packed != 0)).sum()),
            "int32 MAC": int(((acc == 1) & (packed == 0)).sum()),
            "float": int((acc == 2).sum())}
