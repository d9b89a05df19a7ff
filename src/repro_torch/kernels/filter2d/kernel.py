"""The ``filter2d_halo`` kernel wrapper: CUDA on the card, plain torch on
the CPU.

Replaces the TPU kernel ``src/repro/kernels/filter2d/kernel.py::
filter2d_halo`` (``_halo_kernel``, with the halo engine of
``kernels/filter2d/halo.py`` and the fused ``apply_requant`` epilogue) by
a kernel written by hand in CUDA C++ for ``sm_90a``:
``csrc/filter2d_halo_ring.cuh`` (its header comment states the design and
what bounds it). On an H100 the kernel is bound by HBM bytes at w ≤ 7:
about 8 B/px for float32 in and out, about 2 B/px for an int8 frame with
an int8 requantised output, against 3.35 TB/s.

What it computes, exactly as the reference kernel does: a w×w
**correlation** of M planes with an N-filter bank (or [N, 2, w] separable
factors), the border policy resolved on chip (``neglect`` shrinks the
output by w−1), one of the reduction forms, and an optional per-filter
requantising epilogue whose [N, 2] int32 (multiplier, shift) table is a
runtime operand — swapping gains rebuilds nothing.

What differs from the reference kernel, on purpose:

  * persistent blocks walk 128-column × SH-row items of the reference
    grid's order, each window loaded into a ring of shared-memory stages
    while the previous one is reduced (the plan's VMEM-sized strip/tile is
    accounting only, see ``halo.py``; :func:`geometry` gives the kernel's
    own); the output is the exact [M, N, Ho, Wo], with the ragged edge
    masked — there is no padded output to crop;
  * windows arrive by TMA when the frame allows it (:func:`loader_for`),
    else by per-thread loads into the same ring; the choice is the
    frame's, not the caller's;
  * bfloat16 frames load at bfloat16 and accumulate in float32 (the
    reference accumulates at the storage dtype), so bfloat16 results
    differ from the reference by bfloat16 rounding (tests hold 3e-2);
  * float coefficients reach the kernel as float32, integer-frame
    coefficients as int32 (the reference's operand types).

Every odd window runs: w ≤ 7 on an instantiation each, larger windows on
one generic instantiation per dtype and form; a window whose ring cannot
fit a block is refused when a pipeline is compiled
(``halo.check_ring_fits``). A bank larger than the coefficient file runs
as one launch per chunk of filters (``halo.coeff_chunks``), each writing
its slice of the one output.

``filter2d_halo`` launches the kernel for a CUDA tensor and runs the plain
version ``filter2d_halo_ref`` for a CPU tensor, and only then: there is no
fallback from the card to the plain version. ``filter2d_halo.launches``
counts kernel launches (one per chunk), ``filter2d_halo.tma_launches``
those that took the TMA loader, and ``filter2d_halo.calls`` the wrapper's
calls on any device (the verifier's count of an executable's calls).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import dtypes
from repro_torch.core.border_spec import BorderSpec, out_shape
from repro_torch.core.borders import extend
from repro_torch.core.filter2d import apply_requant, wrap_i32
from repro_torch.kernels.filter2d import _build, halo
from repro_torch.kernels.filter2d.contract import (ITEM_ROLES, SMEM_ROLES,
                                                   KernelContract)
from repro_torch.kernels.filter2d.halo import GEOMETRY_KEYS, HaloPlan

# TMA takes a frame whose base and row pitch are multiples of 16 bytes
TMA_ALIGN = 16

FORMS = ("direct", "transposed", "tree", "compress", "separable")
# the storage dtypes the kernel takes, and the executors that launch it
KERNEL_DTYPES = ("float32", "bfloat16", "int8", "uint8", "int16")
RING_EXECUTIONS = ("cuda", "streaming", "sharded")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.uint8: 3, torch.int16: 4, torch.int32: 5}
_POLICY_CODE = {"neglect": 0, "constant": 1, "wrap": 2, "duplicate": 3,
                "mirror_dup": 4, "mirror": 5}
_FORM_CODE = {"direct": 0, "transposed": 0, "tree": 1, "compress": 2,
              "separable": 3}
_ROUNDING_CODE = {"truncate": 0, "nearest": 1, "nearest_even": 2}


def acc_dtype(storage_dtype) -> torch.dtype:
    """The dtype the port's kernel accumulates in: int32 for fixed-point
    frames (the paper's B-bit pixels onto a wide DSP48 accumulator),
    float32 for float32/bfloat16/float16 frames, float64 for float64."""
    if dtypes.is_fixed_point(storage_dtype):
        return torch.int32
    if dtypes.name(storage_dtype) == "float64":
        return torch.float64
    return torch.float32


def out_dtype(plan: HaloPlan, storage_dtype) -> torch.dtype:
    """The dtype each output pixel is *stored* at — plan geometry: the
    requant storage dtype when the plan carries the fused epilogue, int32
    for other fixed-point frames, else the frame dtype."""
    if plan.requant is not None:
        return dtypes.to_torch(plan.requant.dtype)
    if dtypes.is_fixed_point(storage_dtype):
        return torch.int32
    return dtypes.to_torch(storage_dtype)


def _reduce_taps(ext, coeffs, Ho: int, Wo: int, w: int, form: str):
    """w² shifted-product reduction in the reference kernel's order."""
    prods = [ext[..., i:i + Ho, j:j + Wo] * coeffs[i, j]
             for i in range(w) for j in range(w)]
    if form in ("direct", "transposed"):     # left fold, raster order
        out = prods[0]
        for p_ in prods[1:]:
            out = out + p_
        return out
    if form == "tree":                       # pairwise log-depth tree
        while len(prods) > 1:
            nxt = [prods[k] + prods[k + 1]
                   for k in range(0, len(prods) - 1, 2)]
            if len(prods) % 2:
                nxt.append(prods[-1])
            prods = nxt
        return prods[0]
    if form == "compress":                   # groups of 6, then a chain
        partials = []
        for k in range(0, len(prods), 6):
            g = prods[k:k + 6]
            s = g[0]
            for t in g[1:]:
                s = s + t
            partials.append(s)
        out = partials[0]
        for s in partials[1:]:
            out = out + s
        return out
    raise ValueError(f"unknown form {form!r}")


def _reduce_separable(ext, u, v, Ho: int, Wo: int, w: int, fixed: bool):
    """Column pass (``v`` along the width, every window row), then the row
    pass (``u`` along the height)."""
    h = None
    for j in range(w):
        t = ext[..., :, j:j + Wo] * v[j]
        h = t if h is None else h + t
    if fixed:                                # the kernel's int32 wrap
        h = wrap_i32(h).to(torch.int64)
    y = None
    for i in range(w):
        t = h[..., i:i + Ho, :] * u[i]
        y = t if y is None else y + t
    return y


def filter2d_halo_ref(planes: torch.Tensor, coeffs: torch.Tensor,
                      plan: HaloPlan, *, q_params: Optional[torch.Tensor] = None,
                      form: str = "direct") -> torch.Tensor:
    """The plain torch version of the CUDA kernel, on any device: the same
    arguments, the same [M, N, Ho, Wo] result. Float frames accumulate in
    float32 (float64 for float64) in the kernel's order, integer frames
    exactly and then wrapped to int32, then the epilogue. The CPU path of
    :func:`filter2d_halo`, and the card-side oracle of the kernel."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; choose from {FORMS}")
    M, H, W = planes.shape
    N, w = coeffs.shape[0], coeffs.shape[-1]
    r = (w - 1) // 2
    border = BorderSpec(plan.policy, plan.constant)
    fixed = dtypes.is_fixed_point(planes.dtype)
    acc = torch.int64 if fixed else acc_dtype(planes.dtype)
    ext = extend(planes, r, border, constant=plan.constant).to(acc)
    Ho, Wo = out_shape(H, W, w, border)
    co = coeffs.to(acc)
    if plan.requant is not None and q_params is None:
        q_params = torch.tensor(plan.requant.params(N), dtype=torch.int32,
                                device=planes.device)
    odt = out_dtype(plan, planes.dtype)
    outs = []
    for f in range(N):
        if form == "separable":
            y = _reduce_separable(ext, co[f, 0], co[f, 1], Ho, Wo, w, fixed)
        else:
            y = _reduce_taps(ext, co[f], Ho, Wo, w, form)
        if fixed:
            y = wrap_i32(y)
        if plan.requant is not None:
            y = apply_requant(y, q_params[f, 0], q_params[f, 1],
                              rounding=plan.requant.rounding, out_dtype=odt)
        outs.append(y.to(odt))
    return torch.stack(outs, dim=1)


def loader_for(planes: torch.Tensor) -> str:
    """The loader the kernel takes for ``planes``: ``'tma'`` when the frame
    can be a TMA tensor map — its first element on a 16-byte boundary
    (``data_ptr`` counts a view's storage offset) and its row pitch, W
    times the element size, a multiple of 16 bytes — else ``'thread'``
    (per-thread loads into the same ring). A function of shape, dtype and
    address only; not a caller's option."""
    W = planes.shape[-1]
    aligned = (planes.data_ptr() % TMA_ALIGN == 0
               and W * planes.element_size() % TMA_ALIGN == 0)
    return "tma" if aligned else "thread"


def geometry(storage_dtype: torch.dtype, out_dtype: torch.dtype,
             w: int) -> dict:
    """The built kernel's tile geometry for these dtypes and window, from
    the library itself (``filter2d_halo_geometry``): tile and strip, each
    thread's output block, threads per block, ring stages and the bytes of
    one stage. Needs the CUDA toolkit (it loads the library)."""
    g = (ctypes.c_int * len(GEOMETRY_KEYS))()
    rc = _build.load_library().filter2d_halo_geometry(
        _DTYPE_CODE[storage_dtype], _DTYPE_CODE[out_dtype], w, g)
    if rc != 0:
        raise ValueError(f"no geometry for {storage_dtype} -> {out_dtype}")
    return dict(zip(GEOMETRY_KEYS, g))


def smem_bytes(storage_dtype: torch.dtype, out_dtype: torch.dtype, w: int,
               form: str, num_filters: int) -> int:
    """The dynamic shared memory the built library sizes a launch of
    ``num_filters`` filters with (``filter2d_halo_smem``; its Python twin
    is ``halo.ring_smem_bytes``). Needs the CUDA toolkit."""
    n = _build.load_library().filter2d_halo_smem(
        _DTYPE_CODE[storage_dtype], _DTYPE_CODE[out_dtype], w,
        _FORM_CODE[form], num_filters)
    if n < 0:
        raise ValueError(f"no launch for {storage_dtype} -> {out_dtype}")
    return n


def kernel_contract(plan: HaloPlan, num_filters: int, form: str,
                    storage_dtype, loader: str) -> KernelContract:
    """The kernel's declared contract for one call under ``plan``: the
    operands, the shared-memory roles, the item order, the ring and its
    warps, the loader, the form and epilogue, and the bank's chunks
    (``halo.coeff_chunks``) — the counterpart of the reference's
    ``kernel_contract`` (``src/repro/kernels/filter2d/kernel.py:177``)."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; choose from {FORMS}")
    if loader not in ("tma", "thread"):
        raise ValueError(f"loader is 'tma' or 'thread'; got {loader!r}")
    rq = plan.requant is not None
    geo = halo.plan_ring_geometry(plan)
    return KernelContract(
        operands=("frame", "coeffs") + (("qparams",) if rq else ()),
        outputs=("out",),
        smem=SMEM_ROLES, items=ITEM_ROLES,
        stages=halo.RING_STAGES, producer_warps=1,
        consumer_warps=halo.RING_CONSUMERS // 32, loader=loader,
        num_filters=int(num_filters), form=form, has_requant=rq,
        storage_dtype=dtypes.name(storage_dtype),
        out_dtype=dtypes.name(out_dtype(plan, storage_dtype)),
        chunks=halo.coeff_chunks(num_filters, geo, form == "separable"))


def check_operands(planes, coeffs, plan, q_params, form):
    """What the kernel takes; anything else raises before a launch. Runs on
    tensors of any device (the CPU tests call it)."""
    dev = planes.device
    if planes.dtype not in _DTYPE_CODE or planes.dtype == torch.int32:
        raise TypeError(f"the CUDA kernel takes float32, bfloat16, int8, "
                        f"uint8 or int16 planes; got {planes.dtype}")
    if planes.ndim != 3 or not planes.is_contiguous():
        raise ValueError("planes must be a contiguous [M, H, W] tensor; got "
                         f"shape {tuple(planes.shape)}")
    _, H, W = planes.shape
    if (H, W) != (plan.rows.extent, plan.cols.extent):
        raise ValueError(f"plan is for {plan.rows.extent}x"
                         f"{plan.cols.extent} frames; got {H}x{W}")
    w = coeffs.shape[-1]
    if w != 2 * plan.rows.r + 1:
        raise ValueError(f"the coefficients' window must match the plan's "
                         f"w={2 * plan.rows.r + 1}; got w={w}")
    want_c = torch.int32 if dtypes.is_fixed_point(planes.dtype) \
        else torch.float32
    shape_ok = (coeffs.ndim == 3 and coeffs.shape[1] == (
        2 if form == "separable" else w))
    if (coeffs.device != dev or coeffs.dtype != want_c or not shape_ok
            or not coeffs.is_contiguous()):
        raise ValueError(f"coeffs must be a contiguous {want_c} "
                         f"[N, {'2' if form == 'separable' else 'w'}, w] "
                         f"tensor on {dev}; got {coeffs.dtype} "
                         f"{tuple(coeffs.shape)} on {coeffs.device}")
    if plan.requant is not None:
        n = coeffs.shape[0]
        if (q_params.device != dev or q_params.dtype != torch.int32
                or tuple(q_params.shape) != (n, 2)
                or not q_params.is_contiguous()):
            raise ValueError(f"q_params must be a contiguous int32 [{n}, 2] "
                             f"tensor on {dev}")
    elif q_params is not None:
        raise ValueError("q_params given but the plan carries no requant")


def filter2d_halo(planes: torch.Tensor, coeffs: torch.Tensor, plan: HaloPlan,
                  *, q_params: Optional[torch.Tensor] = None,
                  form: str = "direct") -> torch.Tensor:
    """Streaming 2D filter with the border policy on the read path.

    planes: [M, H, W] raw frame planes at their storage dtype. coeffs:
    [N, w, w] filter bank, or [N, 2, w] (u, v) factors for
    ``form='separable'`` — float32 for float frames, int32 for fixed-point
    frames. ``q_params``: the [N, 2] int32 (multiplier, shift) table when
    ``plan.requant`` is set (defaults to the plan spec's own gains).
    Returns [M, N, Ho, Wo] at :func:`out_dtype`.

    A CUDA tensor launches the kernel on ``torch.cuda.current_stream()``
    (the call returns before the card finishes), once per chunk of the
    bank (``halo.coeff_chunks``); a CPU tensor runs
    :func:`filter2d_halo_ref`.
    """
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; choose from {FORMS}")
    filter2d_halo.calls += 1
    if planes.device.type == "cpu":
        return filter2d_halo_ref(planes, coeffs, plan, q_params=q_params,
                                 form=form)
    if planes.device.type != "cuda":
        raise ValueError(f"no filter2d_halo for device {planes.device}")
    loader = loader_for(planes)
    out, launches = launch_args(planes, coeffs, plan, q_params, form, loader)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        for _, _, args in launches:
            rc = lib.filter2d_halo_launch(*args, stream)
            if rc != 0:
                raise RuntimeError(f"filter2d_halo launch failed with CUDA "
                                   f"error {rc}")
            filter2d_halo.launches += 1
            filter2d_halo.tma_launches += loader == "tma"
    return out


def launch_args(planes: torch.Tensor, coeffs: torch.Tensor, plan: HaloPlan,
                q_params: Optional[torch.Tensor], form: str, loader: str):
    """The checked operands of a launch on the card: ``(out, launches)``,
    the empty [M, N, Ho, Wo] output and, per chunk of the bank
    (``halo.coeff_chunks``), ``(n0, n1, args)`` with the leading C
    arguments of the launch that writes filters [n0, n1) of ``out``."""
    if plan.requant is not None and q_params is None:
        q_params = torch.tensor(plan.requant.params(coeffs.shape[0]),
                                dtype=torch.int32, device=planes.device)
    check_operands(planes, coeffs, plan, q_params, form)
    M, H, W = planes.shape
    N, w = coeffs.shape[0], coeffs.shape[-1]
    Ho, Wo = out_shape(H, W, w, BorderSpec(plan.policy))
    odt = out_dtype(plan, planes.dtype)
    out = torch.empty((M, N, Ho, Wo), dtype=odt, device=planes.device)
    # the constant, rounded to the storage dtype (exact as a double)
    const = float(torch.tensor(plan.constant).to(planes.dtype).double())
    chunks = halo.coeff_chunks(N, halo.plan_ring_geometry(plan),
                               form == "separable")
    return out, [(n0, n1, (
        planes.data_ptr(), coeffs[n0:n1].data_ptr(),
        q_params[n0:n1].data_ptr() if q_params is not None else None,
        out[:, n0:n1].data_ptr(), M, H, W, n1 - n0, Ho, Wo, w, plan.rows.off,
        _POLICY_CODE[plan.policy], const, _DTYPE_CODE[planes.dtype],
        _DTYPE_CODE[odt], _FORM_CODE[form],
        _ROUNDING_CODE[plan.requant.rounding] if plan.requant else -1,
        int(loader == "tma"), N)) for n0, n1 in chunks]


filter2d_halo.launches = 0
filter2d_halo.tma_launches = 0
filter2d_halo.calls = 0
