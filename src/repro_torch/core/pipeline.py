"""The plan-and-execute front door: ``Filter2D`` spec → ``CompiledFilter``.

The paper's thesis is that a 2D filter is a *static structure* — window,
form, border policy, wordlengths — that is planned once and then streamed
at line rate with runtime-swappable coefficients (§I: one bitstream serves
every filter). This module is that split for the PyTorch port:

  * :class:`Filter2D` — the hashable spec: window size, reduction form,
    :class:`~repro_torch.core.border_spec.BorderSpec`, separable mode,
    bank size, the frame's storage-dtype contract and the (gain-free half
    of the) :class:`~repro_torch.core.requant.RequantSpec` epilogue.
  * ``spec.compile(frame_spec, execution=..., device=...)`` — plans once:
    resolves the executor, builds the reference's static ``HaloPlan``
    accounting for the geometry (plan-time errors surface here), and
    binds the executor.
  * :class:`CompiledFilter` — ``__call__(frame, coeffs_or_factors,
    gains=None)``: coefficients, separable factors and per-filter requant
    gains are runtime operands of the kernel, so swapping any of them
    builds nothing (``cache_size()`` counts the kernel variants a
    pipeline has launched: 1 after the first call, and still 1 after any
    number of swaps).

Executors: ``'cuda'`` runs the hand-written kernel
(``kernels/filter2d/kernel.py::filter2d_halo``; the counterpart of the
reference's ``'pallas'``); ``'streaming'`` scans row strips with a carried
row buffer and runs each strip's MAC through the same kernel
(``core/streaming.py``); ``'xla'`` is the library-convolution baseline
(``F.conv2d``, the reference's compiler-inferred yardstick); ``'core'``
runs the plain torch versions of ``core/filter2d``; ``'sharded'`` splits
the frame into row shards over a mesh of devices and runs each shard's
MAC through the same kernel after a halo ring exchange
(``core/distributed.py``). ``'auto'`` is ``'sharded'`` when a mesh is
given, else ``'cuda'`` on a CUDA device and ``'core'`` on the CPU; it
never picks ``'xla'`` or ``'streaming'``. Pipelines run on ``device``
('cuda' unless the caller asks for the CPU; a mesh's first device when a
mesh is given); asking for a card that is not there raises — nothing
carries on silently on the CPU.

``CompiledFilter.explain()`` is the plan report: what was compiled, why,
and what it should cost, every byte figure restated from the plan's
accounting and the roofline stated in the H100's constants
(``obs/roofline.py``). ``CompiledFilter.verify()`` runs the kernel
verifier (``repro_torch.analysis``) over what the pipeline launches.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import dtypes
from repro_torch.core.border_spec import (BorderSpec, check_min_extent,
                                          quantize_constant)
from repro_torch.core.distributed import (Mesh, _filter2d_sharded_impl,
                                          ring_plans, wire_bytes)
from repro_torch.core.filter2d import (FORMS, _filter2d_impl,
                                       _filter2d_sep_impl,
                                       _filter2d_xla_impl, _filter_bank_impl,
                                       apply_requant, apply_requant_params,
                                       is_fixed_point, macs_per_pixel,
                                       resolve_requant,
                                       xla_fixed_convolutions)
from repro_torch.core.requant import RequantSpec
from repro_torch.core.streaming import (_scan_planes, strip_height_for_vmem,
                                        strip_plans)
from repro_torch.device import resolve_device, to_device
from repro_torch.kernels.filter2d import halo, ops
from repro_torch.kernels.filter2d import kernel as K
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profiler as obs_profiler
from repro_torch.obs import roofline as obs_roofline

DEFAULT_VMEM_BUDGET = halo.DEFAULT_VMEM_BUDGET

EXECUTIONS = ("auto", "core", "cuda", "sharded", "streaming", "xla")


@dataclasses.dataclass(frozen=True)
class Filter2D:
    """The static structure of a 2D filter — everything that shapes the
    pipeline, nothing that can be swapped at line rate.

    ``window``      w of the w×w stencil (the ``(w-1)/2``-radius halo).
    ``form``        reduction layout (paper §II): direct | transposed |
                    tree | compress.
    ``border``      :class:`BorderSpec` policy (+ constant) — paper §III.
                    A bare policy string is accepted and normalised.
    ``separable``   ``True`` plans the 2w-MAC two-pass pipeline; calls
                    then take ``(u, v)`` factor operands instead of a
                    ``[w, w]`` coefficient block.
    ``num_filters`` bank size N; calls take ``[N, w, w]`` coefficients and
                    outputs grow a trailing bank axis.
    ``dtype``       the frame's *storage* dtype contract (name): float
                    dtypes stream as-is; int8/uint8/int16 take the
                    fixed-point datapath (storage-width stream, int32
                    MAC — paper §IV). ``'bfloat16'`` is a name here too.
    ``requant``     the fused output-scaler epilogue policy; the
                    (multiplier, shift) gains ride every call
                    (``gains=``), defaulting to the ones carried here.

    Hashable and comparable by value: the compile-cache key.
    """

    window: int
    form: str = "direct"
    border: BorderSpec = BorderSpec("mirror")
    separable: bool = False
    num_filters: int = 1
    dtype: str = "float32"
    requant: Optional[RequantSpec] = None

    def __post_init__(self):
        object.__setattr__(self, "window", int(self.window))
        if self.window < 1:
            raise ValueError(f"window must be >= 1; got {self.window}")
        if self.form not in FORMS:
            raise ValueError(f"unknown form {self.form!r}; choose from "
                             f"{FORMS}")
        if isinstance(self.border, str):
            object.__setattr__(self, "border", BorderSpec(self.border))
        if not isinstance(self.border, BorderSpec):
            raise TypeError("border must be a BorderSpec (or a policy "
                            f"name); got {type(self.border).__name__}")
        object.__setattr__(self, "separable", bool(self.separable))
        object.__setattr__(self, "num_filters", int(self.num_filters))
        if self.num_filters < 1:
            raise ValueError("num_filters must be >= 1")
        if self.separable and self.num_filters > 1:
            raise ValueError("separable pipelines are single-filter: "
                             "factor banks are not supported")
        name = dtypes.name(self.dtype)
        object.__setattr__(self, "dtype", name)
        if not (dtypes.is_float(name) or is_fixed_point(name)):
            raise ValueError(
                f"dtype {name!r} is not a supported storage contract: "
                "float dtypes or the fixed-point set int8/uint8/int16")
        if self.requant is not None:
            resolve_requant(name, self.requant, num_filters=self.num_filters)

    @property
    def radius(self) -> int:
        return (self.window - 1) // 2

    def compile(self, frame_spec, execution: str = "auto", *,
                device=None, mesh=None, strip_h: Optional[int] = None,
                profile_dump: Optional[str] = None) -> "CompiledFilter":
        """Plan the pipeline for one frame geometry, executor and device.

        ``frame_spec``: a shape tuple ([H,W] | [H,W,C] | [B,H,W,C]) or a
        tensor/array, whose dtype must match the spec's storage contract.
        ``device`` defaults to the card; ``device='cpu'`` asks for the CPU.
        ``mesh`` (a :class:`~repro_torch.core.distributed.Mesh` or a
        sequence of devices, repeats allowed) drives the ``'sharded'``
        ring, which ``'auto'`` then picks; its first device is the
        pipeline's device, and a ``device`` given beside it must be that
        one.
        ``strip_h`` shapes the ``'streaming'`` scan and no other executor
        (the CUDA kernel's tiling is its own); when it is not given, the
        scan takes the reference's strip height for its default 8 MiB
        VMEM budget. ``profile_dump`` (opt-in) captures the first
        call under ``torch.profiler`` and writes its Chrome trace into
        that directory. Results are memoised: the same (spec, geometry,
        executor, device, knobs) returns the same ``CompiledFilter``.
        """
        shape = _frame_shape(frame_spec, self.dtype)
        if execution not in EXECUTIONS:
            raise ValueError(f"unknown execution {execution!r}; choose "
                             f"from {EXECUTIONS}")
        if execution != "streaming" and strip_h is not None:
            raise ValueError(
                "strip_h shapes the 'streaming' strip scan only; "
                f"execution={execution!r} does not take it (the CUDA "
                "kernel's tiling is its own)")
        if mesh is None:
            if execution == "sharded":
                raise ValueError("execution='sharded' needs a mesh")
            dev = resolve_device("cuda" if device is None else device)
        else:
            if execution not in ("sharded", "auto"):
                raise ValueError(f"a mesh was supplied but execution is "
                                 f"{execution!r}; meshes drive 'sharded' "
                                 "(or 'auto')")
            if not isinstance(mesh, Mesh):
                mesh = Mesh(mesh)
            dev = mesh.devices[0]
            if device is not None and resolve_device(device) != dev:
                raise ValueError(f"device={str(device)!r} disagrees with the "
                                 f"mesh's first device {dev}")
        return _compiled(self, shape, execution, dev, mesh,
                         None if strip_h is None else int(strip_h),
                         None if profile_dump is None else str(profile_dump))


def _frame_shape(frame_spec, dtype_name: str) -> Tuple[int, ...]:
    if isinstance(frame_spec, (tuple, list)):
        shape = tuple(int(s) for s in frame_spec)
    else:
        try:
            shape = tuple(int(s) for s in frame_spec.shape)
            got = dtypes.name(frame_spec.dtype)
        except AttributeError:
            raise TypeError(
                "frame_spec must be a shape tuple or a tensor/array; got "
                f"{type(frame_spec).__name__}") from None
        if got != dtype_name:
            raise ValueError(
                f"frame dtype {got!r} disagrees with the spec's storage "
                f"contract {dtype_name!r}; build a spec for this dtype")
    if len(shape) not in (2, 3, 4):
        raise ValueError("frames are [H,W] | [H,W,C] | [B,H,W,C]; got "
                         f"shape {shape}")
    return shape


@functools.lru_cache(maxsize=256)
def _compiled(spec, shape, execution, device, mesh=None, strip_h=None,
              profile_dump=None) -> "CompiledFilter":
    return CompiledFilter(spec, shape, execution, device=device, mesh=mesh,
                          strip_h=strip_h, profile_dump=profile_dump)


class CompiledFilter:
    """One planned filter pipeline (build via ``Filter2D.compile``).

    ``__call__(frame, coeffs_or_factors, gains=None)`` runs it on the
    pipeline's device and returns the result there: coefficients
    (``[w, w]``, ``[N, w, w]`` for banks, or ``(u, v)`` factors for
    separable pipelines) and requant gains are runtime operands, so
    swapping them reuses the same kernel variant.

    ``self.plan`` is the reference's static
    :class:`~repro_torch.kernels.filter2d.halo.HaloPlan` accounting for
    this geometry: for the ``cuda`` executor the plan the reference's
    Pallas kernel would run (pixel-cache regime when the frame-resident
    working set fits the reference's default 8 MiB VMEM budget, else the
    stream geometry derived from that budget); for ``streaming`` the
    reference's strip-scan accounting plan at ``strip_h``; for ``core``
    and ``xla`` and ``sharded`` the accounting-only plan.
    ``hbm_bytes_per_pixel()``, ``vmem_working_set()`` and ``explain()``
    report it. ``n_strips`` is the number of kernel launches one
    ``streaming`` call makes; ``n_shards`` the number one ``sharded`` call
    makes, and ``wire_bytes`` the halo bytes its ring moves per call
    (``None`` for the other executors).
    """

    def __init__(self, spec: Filter2D, frame_shape: Tuple[int, ...],
                 execution: str, *, device: torch.device, mesh=None,
                 strip_h: Optional[int] = None,
                 profile_dump: Optional[str] = None):
        t_compile0 = time.perf_counter()
        self.spec = spec
        self.frame_shape = frame_shape
        self.device = device
        self.mesh = mesh
        self.profile_dump = profile_dump
        self._profiled = False
        self._verify_report = None     # cached by verify()
        self.vmem_budget = DEFAULT_VMEM_BUDGET
        nd = len(frame_shape)
        self._H, self._W = frame_shape[1:3] if nd == 4 else frame_shape[:2]
        self._C = frame_shape[-1] if nd >= 3 else 1
        w, r = spec.window, spec.radius
        db, acc_b, out_b = halo.datapath_byte_widths(spec.dtype, spec.requant)
        same = spec.border.same_size
        Ho = self._H if same else max(self._H - 2 * r, 1)
        Wo = self._W if same else max(self._W - 2 * r, 1)
        # the reference's frame-resident (pixel-cache) working set, with the
        # output tile lane-padded as its small-regime plan lays it out
        wo_pad = Wo + (-Wo) % halo.LANE
        self.resident_vmem_bytes = halo.stream_vmem_working_set(
            Ho, wo_pad, w, db, separable=spec.separable,
            num_filters=spec.num_filters, acc_dtype_bytes=acc_b,
            out_dtype_bytes=out_b,
            out_banks=2 if spec.num_filters > 1 else 1)

        requested = execution
        if execution == "auto" and mesh is not None:
            execution = "sharded"
            self.selection = ("mesh", "a mesh was supplied -> halo-exchange "
                                      "ring executor")
        elif execution == "auto":
            execution = "cuda" if device.type == "cuda" else "core"
            self.selection = ("device", f"{device.type} device -> "
                                        f"{execution!r} executor")
        else:
            self.selection = ("explicit",
                              f"execution={execution!r} requested")
        self.execution = execution
        if execution in ("xla", "streaming", "sharded"):
            if spec.num_filters > 1:
                raise ValueError(f"execution={execution!r} runs single "
                                 "filters; banks take 'core' or 'cuda'")
            if spec.separable:
                raise ValueError(f"execution={execution!r} has no "
                                 "separable path; use 'core' or 'cuda'")
        if (execution == "xla" and is_fixed_point(spec.dtype)
                and not xla_fixed_convolutions(spec.dtype, spec.window)):
            raise ValueError(
                f"execution='xla' convolves fixed-point frames as two "
                f"float64 halves, exact while max|x|·2¹⁶·w² <= 2⁵³ (for "
                f"int16, w² < 2²²); got {spec.dtype} w={spec.window}")
        if execution in ("core", "xla") and same:
            # the plain versions extend the whole frame by index remaps
            check_min_extent(spec.border, r, self._H, self._W)
        if execution in K.RING_EXECUTIONS and spec.dtype in K.KERNEL_DTYPES:
            # the executors that run filter2d_halo: a window whose ring
            # cannot fit a block is refused here, not at the first call
            halo.check_ring_fits(w, spec.dtype, spec.requant,
                                 separable=spec.separable)

        gain_free = (spec.requant.gain_free() if spec.requant is not None
                     else None)
        self.regime = self.strip_h = self.tile_w = self.n_strips = None
        self.n_shards = self.wire_bytes = None
        if execution == "cuda":
            self.regime = ("small" if self.resident_vmem_bytes
                           <= self.vmem_budget else "stream")
            strip_h, tile_w = Ho, Wo
            if self.regime == "stream":
                strip_h, tile_w = halo.derive_strip_tile(
                    self._H, self._W, w, dtype=spec.dtype,
                    vmem_budget=self.vmem_budget,
                    num_filters=spec.num_filters, separable=spec.separable,
                    requant=spec.requant, same_size=same)
            S, Tw, _, _ = ops.resolve_strip_tile(
                self._H, self._W, w, spec.border, self.regime, strip_h,
                tile_w)
            self.strip_h, self.tile_w = S, Tw
            # the kernel reads policy, constant, radius and epilogue from
            # this plan; frames below the policy's minimum extent raise here
            self.plan = halo.make_plan(self._H, self._W, w, spec.border, S,
                                       Tw, dtype=spec.dtype,
                                       requant=gain_free)
        else:
            if execution == "streaming":
                # the reference's scan widens fixed-point strips to the
                # int32 accumulator: its strip is derived at that width
                self.strip_h = (self._streaming_strip(acc_b)
                                if strip_h is None else int(strip_h))
                # the kernel plan of every strip; bad geometry raises here
                self.n_strips, self._strip_plan, self._strip_idx = \
                    strip_plans(self._H, self._W, w, spec.border,
                                self.strip_h, dtype=spec.dtype,
                                requant=gain_free, device=device)
            elif execution == "sharded":
                # the window plan and index vectors of every shard; bad
                # geometry raises here
                self.n_shards = len(mesh.devices)
                self._ring_plan, self._ring_idx = ring_plans(
                    self._H, self._W, w, spec.border, mesh,
                    dtype=spec.dtype, requant=gain_free)
                self.wire_bytes = wire_bytes(frame_shape, w, self.n_shards,
                                             spec.dtype)
                self.selection = (self.selection[0], (
                    f"{self.selection[1]}; {self.n_shards} row shards of "
                    f"{self._H // self.n_shards} rows over {mesh}, "
                    f"{self.wire_bytes} B of storage-width halo rows per "
                    "call"))
            try:                 # accounting only; the impl validates
                self.plan = halo.make_plan(
                    self._H, self._W, w, spec.border,
                    Ho if self.strip_h is None else self.strip_h, Wo,
                    dtype=spec.dtype, requant=gain_free)
            except (ValueError, AssertionError):
                self.plan = None

        with obs_profiler.annotate("repro_torch.pipeline.compile"):
            self._fn = self._build()
        self._variants = set()
        planes = 1
        if nd == 4:
            planes = frame_shape[0] * frame_shape[3]
        elif nd == 3:
            planes = frame_shape[2]
        self._pixels_per_call = self._H * self._W * planes
        self._obs_key = (f"{self.execution}"
                         f"{'/' + self.regime if self.regime else ''}"
                         f"/{spec.dtype}/w{spec.window}"
                         f"/{self._H}x{self._W}")
        if obs_events.enabled():
            self._emit_compile_events(requested,
                                      time.perf_counter() - t_compile0)

    def _emit_compile_events(self, requested: str, wall_s: float) -> None:
        if requested == "auto":
            obs_events.emit(obs_events.AutoSelectEvent(
                rule=self.selection[0], execution=self.execution,
                reason=self.selection[1],
                resident_vmem_bytes=int(self.resident_vmem_bytes),
                vmem_budget=int(self.vmem_budget),
                has_mesh=self.mesh is not None))
        eb, ob = self._plan_banks()
        ws = self.vmem_working_set()
        bpp = self.hbm_bytes_per_pixel()
        obs_events.emit(obs_events.CompileEvent(
            key=self._obs_key, spec=repr(self.spec),
            spec_hash=hash(self.spec), frame_shape=self.frame_shape,
            execution=self.execution, regime=self.regime,
            strip_h=self.strip_h, tile_w=self.tile_w, ext_banks=eb,
            out_banks=ob, vmem_working_set=None if ws is None else int(ws),
            hbm_bytes_per_pixel=None if bpp is None else float(bpp),
            wall_ms=wall_s * 1e3))
        obs_metrics.REGISTRY.counter("pipeline.compiles").inc()

    def _streaming_strip(self, dtype_bytes: int) -> int:
        """Largest divisor of H within the budget-derived strip height
        (the scan needs H % strip == 0 and strip >= w-1) — the
        reference's rule."""
        H, w = self._H, self.spec.window
        target = strip_height_for_vmem(self._W, self._C, w,
                                       self.vmem_budget, dtype_bytes)
        lo = max(w - 1, 1)
        divs = [d for d in range(1, H + 1) if H % d == 0]
        ok = [d for d in divs if lo <= d <= max(target, lo)]
        if ok:
            return max(ok)
        over = [d for d in divs if d >= lo]
        return min(over) if over else H

    # -- executor ----------------------------------------------------------

    def _build(self):
        spec = self.spec
        border = spec.border
        rq = spec.requant
        fixed = is_fixed_point(spec.dtype)
        n = spec.num_filters

        def _epilogue(y, q):
            if rq is None:
                return y
            if n > 1:                     # bank axis is last: [.., N]
                return apply_requant(y, q[:, 0], q[:, 1],
                                     rounding=rq.rounding,
                                     out_dtype=rq.dtype)
            return apply_requant_params(y, q, rq)

        if self.execution == "core":
            qc = quantize_constant(border.constant, spec.dtype)
            if spec.separable:
                def impl(frame, co, q):
                    return _epilogue(_filter2d_sep_impl(
                        frame, co[0], co[1], border=border,
                        border_constant=qc), q)
            elif n == 1:
                def impl(frame, co, q):
                    return _epilogue(_filter2d_impl(
                        frame, co, form=spec.form, border=border,
                        border_constant=qc), q)
            else:
                def impl(frame, co, q):
                    return _epilogue(_filter_bank_impl(
                        frame, co, border=border, border_constant=qc), q)
            return impl

        if self.execution == "xla":
            def impl(frame, co, q):
                return _epilogue(_filter2d_xla_impl(frame, co,
                                                    border=border), q)
            return impl

        plan = self.plan
        form = "separable" if spec.separable else spec.form
        cdt = (torch.int32 if fixed else torch.float64
               if spec.dtype == "float64" else torch.float32)

        if self.execution == "sharded":
            mesh, ring_plan, ring_idx = (self.mesh, self._ring_plan,
                                         self._ring_idx)

            def impl(frame, co, q):
                # the gains ride to every shard: each requantises its own
                # tile, so the gathered tiles stay storage-width
                return _filter2d_sharded_impl(
                    frame, co.to(cdt)[None].contiguous(), q, mesh,
                    ring_plan, ring_idx, border=border, form=form)
            return impl

        if self.execution == "streaming":
            strip_plan, n_strips = self._strip_plan, self.n_strips
            strip_idx, strip_h = self._strip_idx, self.strip_h

            def impl(frame, co, q):
                # each emitted strip is requantised by its own launch: the
                # output stream leaves at storage width strip by strip
                planes, tag = ops._fold_planes(frame)
                y = _scan_planes(planes, co.to(cdt)[None].contiguous(), q,
                                 strip_plan, n_strips, strip_idx,
                                 border=border,
                                 strip_h=strip_h, form=form)
                return ops._unfold(y, tag, keep_bank=False)
            return impl

        def impl(frame, co, q):
            planes, tag = ops._fold_planes(frame)
            co_k = co.to(cdt)
            if spec.separable or n == 1:
                co_k = co_k[None]
            y = K.filter2d_halo(planes, co_k.contiguous(), plan, q_params=q,
                                form=form)
            return ops._unfold(y, tag, keep_bank=n > 1)
        return impl

    # -- operand normalisation ---------------------------------------------

    def _coeff_operand(self, coeffs) -> torch.Tensor:
        w, n = self.spec.window, self.spec.num_filters
        if self.spec.separable:
            if isinstance(coeffs, (tuple, list)):
                if len(coeffs) != 2:
                    raise ValueError("separable pipelines take (u, v) — "
                                     "exactly two 1D factors")
                co = torch.stack([to_device(c, self.device)
                                  for c in coeffs])
            else:
                co = coeffs if torch.is_tensor(coeffs) else \
                    torch.as_tensor(np.asarray(coeffs))
            if tuple(co.shape) != (2, w):
                raise ValueError(
                    f"separable pipeline takes (u, v) factors of length "
                    f"{w} (operand shape (2, {w})); got {tuple(co.shape)}")
            return to_device(co, self.device)
        co = coeffs if torch.is_tensor(coeffs) else \
            torch.as_tensor(np.asarray(coeffs))
        want = (w, w) if n == 1 else (n, w, w)
        if tuple(co.shape) != want:
            raise ValueError(f"this pipeline takes coefficients of shape "
                             f"{want}; got {tuple(co.shape)}")
        return to_device(co, self.device)

    def _gain_operand(self, gains) -> torch.Tensor:
        rq, n = self.spec.requant, self.spec.num_filters
        if gains is None:
            g = torch.tensor(rq.params(n), dtype=torch.int32)
        elif isinstance(gains, RequantSpec):
            if gains.gain_free() != rq.gain_free():
                raise ValueError(
                    "gains spec disagrees with the compiled epilogue "
                    f"(rounding/storage dtype): {gains.gain_free()} vs "
                    f"{rq.gain_free()}; compile for a new epilogue")
            g = torch.tensor(gains.params(n), dtype=torch.int32)
        else:
            g = (gains if torch.is_tensor(gains)
                 else torch.as_tensor(np.asarray(gains))).to(torch.int32)
            if tuple(g.shape) == (2,):
                g = g[None].expand(n, 2)
            if tuple(g.shape) != (n, 2):
                raise ValueError(f"gains must be a RequantSpec, a "
                                 f"(multiplier, shift) pair or an [{n}, 2] "
                                 f"table; got shape {tuple(g.shape)}")
            if g.device.type == "cpu" and bool(
                    ((g[:, 1] < 0) | (g[:, 1] > 31)).any()):
                raise ValueError("requant shifts must be in [0, 31]")
        return to_device(g.contiguous(), self.device)

    # -- execution ---------------------------------------------------------

    def __call__(self, frame, coeffs, gains=None):
        if self.execution != "sharded":   # the ring places its own shards
            frame = to_device(frame, self.device)
        if tuple(frame.shape) != self.frame_shape:
            raise ValueError(
                f"pipeline compiled for frame shape {self.frame_shape}; "
                f"got {tuple(frame.shape)} — compile for the new geometry")
        if dtypes.name(frame.dtype) != self.spec.dtype:
            raise ValueError(
                f"pipeline compiled for dtype {self.spec.dtype!r}; got "
                f"{dtypes.name(frame.dtype)!r}")
        co = self._coeff_operand(coeffs)
        if self.spec.requant is None:
            if gains is not None:
                raise ValueError("gains supplied but the spec carries no "
                                 "requant epilogue")
            q = None
        else:
            q = self._gain_operand(gains)
        # the default path: one attribute test, then straight into the
        # executor — observability off costs a single branch
        if obs_events._TRACE is None and self.profile_dump is None:
            self._variants.add(q is not None)
            return self._fn(frame, co, q)
        return self._instrumented_call(frame, co, q)

    def _instrumented_call(self, frame, co, q):
        """Timed execution: wall time until the device finished the call,
        one :class:`ExecuteEvent` + a latency histogram sample per call
        when tracing is on, and the first call captured under
        ``torch.profiler`` when ``profile_dump`` is set."""
        dump = None
        if self.profile_dump is not None and not self._profiled:
            self._profiled = True          # capture the first call only
            dump = self.profile_dump
        size0 = self.cache_size()
        t0 = time.perf_counter()
        with obs_profiler.profile_dump(dump):
            with obs_profiler.annotate("repro_torch.pipeline.call"):
                self._variants.add(q is not None)
                y = self._fn(frame, co, q)
                for dev in (set(self.mesh.devices) if self.mesh is not None
                            else {self.device}):
                    if dev.type == "cuda":
                        torch.cuda.current_stream(dev).synchronize()
        wall_s = max(time.perf_counter() - t0, 1e-9)
        size1 = self.cache_size()
        if obs_events._TRACE is not None:
            wall_us = wall_s * 1e6
            obs_events.emit(obs_events.ExecuteEvent(
                key=self._obs_key, wall_us=wall_us,
                pixels_per_s=self._pixels_per_call / wall_s,
                cache_hit=size1 == size0, cache_size=size1))
            reg = obs_metrics.REGISTRY
            reg.histogram(f"call/{self._obs_key}").record(wall_us)
            reg.counter("pipeline.calls").inc()
            reg.counter("pipeline.recompiles" if size1 > size0
                        else "pipeline.cache_hits").inc()
        return y

    # -- introspection -----------------------------------------------------

    def cache_size(self) -> int:
        """Kernel variants this pipeline has launched: 1 after the first
        call, and *still* 1 after any number of coefficient / factor /
        gain swaps — the served-pipeline invariant."""
        return len(self._variants)

    def vmem_working_set(self) -> Optional[int]:
        """Per-step VMEM bytes of the reference schedule for this plan —
        both scratch banks counted for ``cuda``, whose plan is the
        reference's double-buffered Pallas one. Accounting: the CUDA
        kernel's shared-memory ring is its own."""
        if self.plan is None:
            return None
        return halo.plan_vmem_working_set(
            self.plan, num_filters=self.spec.num_filters,
            separable=self.spec.separable,
            overlap=self.execution == "cuda")

    def hbm_bytes_per_pixel(self) -> Optional[float]:
        """Static HBM round-trip bytes/pixel of the reference plan."""
        if self.plan is None:
            return None
        return halo.hbm_bytes_per_pixel(self.plan)

    def _plan_banks(self) -> Tuple[Optional[int], Optional[int]]:
        """(halo-scratch, output-tile) bank counts of the reference
        schedule for ``cuda``; ``(None, None)`` for the other executors."""
        if self.execution != "cuda" or self.plan is None:
            return None, None
        return halo.plan_banks(self.plan, num_filters=self.spec.num_filters)

    def _roofline(self) -> dict:
        """The two-ceiling prediction for this pipeline's work (flops and
        bytes per pixel from the plan) in the constants of the H100 part
        it runs on — the SXM5 part for a pipeline planned on the CPU."""
        part = obs_roofline.PARTS[obs_roofline.part_of(
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else None)]
        spec = self.spec
        flops = 2.0 * macs_per_pixel(spec.window, form=spec.form,
                                     separable=spec.separable) \
            * spec.num_filters
        # float16/float64 frames are stated against the float32 rate
        peak = part.peak_ops.get(spec.dtype, part.peak_ops["float32"])
        roof = obs_roofline.predicted_pixel_rate(
            flops, self.hbm_bytes_per_pixel(), peak_flops=peak,
            hbm_bw=part.hbm_bw)
        roof["part"] = part.name
        return roof

    def verify(self):
        """Run the kernel verifier over this pipeline
        (:func:`repro_torch.analysis.verify`): a
        :class:`~repro_torch.analysis.report.Report`, clean when every
        invariant of the ring's schedule holds for each launch the
        executor makes (the trace alone for ``core`` / ``xla``, which
        launch no kernel). The result is cached and surfaces in
        :meth:`explain`."""
        from repro_torch import analysis  # deferred: analysis sits above us
        self._verify_report = analysis.verify(self)
        return self._verify_report

    def explain(self, as_dict: bool = False, verify: bool = False):
        """The plan report: what compiled, why, and what it should cost.

        Every byte figure here IS the existing static accounting —
        ``vmem_working_set()`` / ``hbm_bytes_per_pixel()`` /
        ``halo.read_amplification`` — restated, not re-derived, plus the
        two-ceiling roofline prediction (:meth:`_roofline`). The keys are
        the reference's, and the byte figures its accounting (the ring's
        own shared memory and read amplification are in the verifier's
        stats). ``verify=True`` runs :meth:`verify` first (if not already
        cached) so the ``verify`` key carries its ``clean``, ``findings``,
        ``error`` and ``passes``. ``as_dict=True`` returns the
        machine-readable twin."""
        if verify and self._verify_report is None:
            self.verify()
        vr = self._verify_report
        spec, plan = self.spec, self.plan
        eb, ob = self._plan_banks()
        ws = self.vmem_working_set()
        bpp = self.hbm_bytes_per_pixel()
        d = {
            "spec": {
                "window": spec.window, "form": spec.form,
                "border": spec.border.policy, "separable": spec.separable,
                "num_filters": spec.num_filters, "dtype": spec.dtype,
                "requant": None if spec.requant is None
                           else repr(spec.requant),
            },
            "frame": {"shape": self.frame_shape,
                      "pixels_per_call": self._pixels_per_call},
            "execution": {"executor": self.execution, "regime": self.regime,
                          "rule": self.selection[0],
                          "why": self.selection[1]},
            "geometry": None if plan is None else {
                "strip_h": self.strip_h, "tile_w": self.tile_w,
                "strips": plan.rows.n, "tiles": plan.cols.n,
                "ext_banks": eb, "out_banks": ob,
                "scratch_eh": plan.eh, "scratch_ew": plan.ew,
            },
            "vmem": {
                "working_set_bytes": None if ws is None else int(ws),
                "budget_bytes": int(self.vmem_budget),
                "resident_estimate_bytes": int(self.resident_vmem_bytes),
                "fits_budget": None if ws is None
                               else bool(ws <= self.vmem_budget),
            },
            "hbm": None if plan is None else {
                "read_bytes_per_pixel": halo.read_bytes_per_pixel(plan),
                "write_bytes_per_pixel":
                    halo.hbm_write_bytes_per_pixel(plan),
                "bytes_per_pixel": bpp,
                "read_amplification": halo.read_amplification(plan),
            },
            "roofline": self._roofline(),
            "verify": None if vr is None else {
                "clean": vr.clean,
                "findings": [
                    {"passname": f.passname, "message": f.message,
                     "ref": f.ref, "count": f.count}
                    for f in vr.findings],
                "error": vr.error,
                "passes": list(vr.passes),
            },
        }
        if as_dict:
            return d
        return self._render_explain(d)

    def _render_explain(self, d) -> str:
        def _b(n):
            if n is None:
                return "n/a"
            return (f"{n / 2**20:.2f} MiB" if n >= 2**20
                    else f"{n / 2**10:.1f} KiB" if n >= 2**10
                    else f"{n} B")
        s, e, g, v, h, r = (d["spec"], d["execution"], d["geometry"],
                            d["vmem"], d["hbm"], d["roofline"])
        lines = [
            f"CompiledFilter: {s['window']}x{s['window']} "
            + ("separable " if s["separable"] else "")
            + f"{s['form']} filter"
            + (f" bank[{s['num_filters']}]" if s["num_filters"] > 1 else "")
            + f", {s['dtype']}, border={s['border']}"
            + (f", requant={s['requant']}" if s["requant"] else ""),
            f"  frame     {d['frame']['shape']} "
            f"({d['frame']['pixels_per_call']} px/call)",
            f"  executor  {e['executor']}"
            + (f" regime={e['regime']!r}" if e["regime"] else "")
            + f" [{e['rule']}] — {e['why']}",
        ]
        if g is not None:
            lines.append(
                f"  geometry  {g['strips']} strips x {g['tiles']} tiles "
                f"(strip_h={g['strip_h']}, tile_w={g['tile_w']}), scratch "
                f"{g['scratch_eh']}x{g['scratch_ew']}"
                + (f", banks ext={g['ext_banks']} out={g['out_banks']}"
                   if g["ext_banks"] is not None else ""))
        lines.append(
            f"  vmem      working set {_b(v['working_set_bytes'])} of "
            f"{_b(v['budget_bytes'])} budget"
            + ("" if v["fits_budget"] is None
               else " (fits)" if v["fits_budget"] else " (OVER)")
            + f"; frame-resident est. {_b(v['resident_estimate_bytes'])}"
            + " (reference accounting)")
        if h is not None:
            lines.append(
                f"  hbm       {h['bytes_per_pixel']:.3f} B/px round trip "
                f"(read {h['read_bytes_per_pixel']:.3f} + write "
                f"{h['write_bytes_per_pixel']:.3f}), read amplification "
                f"{h['read_amplification']:.4f}x")
        lines.append(
            f"  roofline  {r['predicted_pixels_per_s']:.3e} px/s "
            f"({r['bound']}-bound; {r['flops_per_pixel']:.0f} flop/px, "
            + (f"{r['bytes_per_pixel']:.3f} B/px" if r["bytes_per_pixel"]
               is not None else "bytes unknown")
            + f"; {r['part']}: {r['peak_flops']:.3g} op/s, "
            f"{r['hbm_bw']:.3g} B/s)")
        vr = d["verify"]
        if vr is not None:
            if vr["error"] is not None:
                lines.append(f"  verify    TRACE ERROR — {vr['error']}")
            elif vr["clean"]:
                lines.append(f"  verify    clean "
                             f"({len(vr['passes'])} passes)")
            else:
                lines.append(f"  verify    {len(vr['findings'])} "
                             "finding(s):")
                for f in vr["findings"]:
                    n = f" x{f['count']}" if f["count"] > 1 else ""
                    lines.append(f"    [{f['passname']}]{n} {f['message']}")
        return "\n".join(lines)

    def _explain_line(self) -> str:
        """One-line plan summary (folded into ``__repr__``)."""
        eb, ob = self._plan_banks()
        bits = [self._obs_key, f"rule={self.selection[0]}"]
        if self.plan is not None:
            bits.append(f"{self.plan.rows.n}x{self.plan.cols.n} grid")
        if eb is not None:
            bits.append(f"banks ext={eb} out={ob}")
        ws = self.vmem_working_set()
        if ws is not None:
            bits.append(f"vmem {ws}/{self.vmem_budget} B")
        bpp = self.hbm_bytes_per_pixel()
        if bpp is not None:
            bits.append(f"{bpp:.2f} B/px")
        return " | ".join(bits)

    def __repr__(self) -> str:
        geo = ""
        if self.execution == "cuda":
            geo = (f", plan regime={self.regime!r}, strip_h={self.strip_h},"
                   f" tile_w={self.tile_w}")
        elif self.execution == "streaming":
            geo = f", strip_h={self.strip_h}"
        elif self.execution == "sharded":
            geo = (f", mesh={self.mesh}, shards={self.n_shards}, "
                   f"wire_bytes={self.wire_bytes}")
        return (f"CompiledFilter({self.spec!r}, frame={self.frame_shape}, "
                f"execution={self.execution!r}, device={self.device}{geo})"
                f"\n  <{self._explain_line()}>")


# -- batch admission (the serving engine's substrate) -----------------------
#
# A compiled pipeline folds batch and channel planes into the kernel's plane
# dimension ([B, H, W, C] frames stream as B*C planes through one launch),
# which is exactly the degree of freedom a serving layer wants: k
# independent same-geometry requests stack into the plane dim of ONE
# dispatch. These helpers are the admission arithmetic — stable bucket
# identity, stacking with zero-padding to a static batch, and the inverse
# split — kept next to the front door so the geometry rules live in one
# place.


def batched_shape(frame_shape: Sequence[int], batch: int) -> Tuple[int, ...]:
    """The [B, H, W, C] pipeline geometry a wave of ``batch`` frames of
    ``frame_shape`` ([H, W] or [H, W, C]) compiles for. Already-batched
    4-D shapes are rejected: the batch dim belongs to the admission
    layer, not the request."""
    shape = tuple(int(s) for s in frame_shape)
    if len(shape) == 2:
        shape = shape + (1,)
    if len(shape) != 3:
        raise ValueError("serving frames are [H, W] or [H, W, C]; got "
                         f"shape {tuple(frame_shape)}")
    if batch < 1:
        raise ValueError(f"batch must be >= 1; got {batch}")
    return (int(batch),) + shape


def bucket_key(spec: Filter2D, frame_shape: Sequence[int], *,
               batch: int = 1, execution: str = "auto",
               device="cuda") -> str:
    """Stable digest naming one warm-cache bucket: the (spec, frame
    geometry, dtype) identity plus every compile knob. Two requests with
    equal keys are servable by the same ``CompiledFilter``."""
    shape = batched_shape(frame_shape, batch)
    payload = (repr(spec), shape, execution,
               str(torch.device(device)))
    return hashlib.sha1(repr(payload).encode()).hexdigest()[:16]


def admit_batch(frames: Sequence, batch: int, *,
                pin_memory: bool = False) -> torch.Tensor:
    """Stack up to ``batch`` same-geometry host frames (numpy arrays or
    CPU tensors) into the [B, H, W, C] plane layout, zero-padding the tail
    so the dispatch shape is static. ``pin_memory`` stacks straight into
    page-locked memory, ready for a non-blocking copy to the card."""
    if not frames:
        raise ValueError("admit_batch needs at least one frame")
    if len(frames) > batch:
        raise ValueError(f"wave of {len(frames)} frames exceeds the "
                         f"batch size {batch}")
    ts = [f if torch.is_tensor(f) else torch.as_tensor(np.asarray(f))
          for f in frames]
    shape, dtype = tuple(ts[0].shape), ts[0].dtype
    for t in ts[1:]:
        if tuple(t.shape) != shape:
            raise ValueError("waves are same-geometry by construction: "
                             f"got {tuple(t.shape)} in a {shape} wave")
        if t.dtype != dtype:
            raise ValueError("waves are same-dtype by construction (a "
                             f"stack would silently promote): got "
                             f"{t.dtype} in a {dtype} wave")
    if len(shape) not in (2, 3):
        raise ValueError("serving frames are [H, W] or [H, W, C]; got "
                         f"shape {shape}")
    full = batched_shape(shape, batch)
    x = torch.zeros(full, dtype=dtype, pin_memory=pin_memory)
    for i, t in enumerate(ts):
        x[i].copy_(t.reshape(full[1:]))
    return x


def split_batch(y, count: int, frame_ndim: int) -> List:
    """Undo :func:`admit_batch` on a pipeline output: the first ``count``
    planes (padding dropped), each squeezed back to the request's rank —
    2-D requests lose the synthesised channel axis; bank pipelines keep
    their trailing bank axis."""
    outs = []
    for i in range(count):
        yi = y[i]
        if frame_ndim == 2:
            # [H, W, 1] or [H, W, 1, N] -> [H, W] / [H, W, N]
            yi = yi[:, :, 0]
        outs.append(yi)
    return outs
