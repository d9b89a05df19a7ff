"""Verification entry points: schedule, run the pass pipeline.

:func:`verify` takes a built :class:`~repro_torch.core.pipeline.
CompiledFilter` and verifies what it will actually run: the executable is
run once on zero operands to count its ``filter2d_halo`` calls (the stat
that stands where the reference counts ``pallas_calls``), and — for the
executors that launch the kernel (``'cuda'``, ``'streaming'``,
``'sharded'``) — every distinct launch they make is scheduled and analysed
under both loaders and at two block counts: one block walking every item
in the reference grid's order, and the grid the ring's geometry takes
(the counterpart of the reference's two grid orders). ``'core'`` and
``'xla'`` launch no kernel, which the report states rather than assumes:
the run must succeed and make no ``filter2d_halo`` call.

:func:`verify_kernel` is the door for one launch configuration: a plan, a
bank, a form, a dtype, planes, a loader and a block count; ``schedule``
replaces the shipped :func:`~repro_torch.analysis.ir.schedule_model` with
any callable of the same arguments returning a :class:`KernelIR` (the
seeded-bug fixtures enter here, and ``chip_smoke.py`` hands in the card's
own log).

:func:`sweep` runs the executor × dtype × border matrix of the reference
(``src/repro/analysis/verify.py:208-302``) with ``'pallas'`` read as
``'cuda'``. Every entry returns a Report — a failure before the passes is
a Report with ``error`` set (CLI exit code 2), never an unhandled raise.
"""
from __future__ import annotations

import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.ir import KernelIR, schedule_model
from repro_torch.analysis.passes import Context, PASSES, run_passes
from repro_torch.analysis.report import Report
from repro_torch.core import dtypes
from repro_torch.core.border_spec import POLICIES, BorderSpec
from repro_torch.kernels.filter2d import halo
from repro_torch.kernels.filter2d import kernel as K
from repro_torch.kernels.filter2d.halo import HaloPlan

PASS_NAMES = tuple(PASSES)
LOADERS = ("tma", "thread")


def default_blocks(plan: HaloPlan, num_filters: int, form: str, M: int
                   ) -> int:
    """The grid the ring's geometry takes for this launch
    (``halo.ring_blocks`` at the first chunk's shared memory)."""
    geo = halo.plan_ring_geometry(plan)
    sep = form == "separable"
    n0, n1 = halo.coeff_chunks(num_filters, geo, sep)[0]
    _, _, items = halo.ring_items(geo, plan.rows.extent, plan.cols.extent, M)
    return halo.ring_blocks(geo, halo.ring_smem_bytes(geo, n1 - n0, sep),
                            items)


def verify_kernel(plan: HaloPlan, *, num_filters: int = 1,
                  form: str = "direct", dtype="float32", M: int = 1,
                  loader: str = "tma", blocks: Optional[int] = None,
                  schedule: Optional[Callable[..., KernelIR]] = None,
                  key: Optional[str] = None) -> Report:
    """Schedule one call of the kernel and run every pass.

    ``schedule(contract, geometry, plan, M, blocks)`` defaults to the
    shipped :func:`schedule_model`; ``blocks`` to
    :func:`default_blocks`."""
    name = dtypes.name(dtype)
    key = key or f"kernel/{name}/{plan.policy}/{loader}"
    try:
        ct = K.kernel_contract(plan, num_filters, form, name, loader)
        geo = halo.plan_ring_geometry(plan)
        if blocks is None:
            blocks = default_blocks(plan, num_filters, form, M)
        kir = (schedule or schedule_model)(ct, geo, plan, M, blocks)
        findings, stats = run_passes(Context(kir=kir, plan=plan, key=key))
        stats.update(
            events=float(len(kir.events)), blocks=float(blocks),
            smem_bytes=float(max(ln.smem_bytes for ln in kir.launches)),
            smem_working_set=float(halo.smem_working_set(
                plan, num_filters=num_filters,
                separable=form == "separable")))
        report = Report(key=key, passes=PASS_NAMES,
                        findings=tuple(findings),
                        stats=tuple(sorted(stats.items())))
    except Exception as e:                     # -> CLI exit code 2
        report = Report(key=key, error=_err(e))
    report.emit()
    return report


def _err(e: Exception) -> str:
    tb = traceback.format_exc(limit=3).strip().splitlines()
    return f"{type(e).__name__}: {e} | " + " / ".join(tb[-2:])


def planes_of(frame_shape: Tuple[int, ...]) -> int:
    if len(frame_shape) == 4:
        return frame_shape[0] * frame_shape[3]
    if len(frame_shape) == 3:
        return frame_shape[2]
    return 1


def _operands(cf):
    """Zero operands of the pipeline's call, on its device."""
    spec = cf.spec
    dt = dtypes.to_torch(spec.dtype)
    dev = cf.device
    frame = torch.zeros(cf.frame_shape, dtype=dt, device=dev)
    w, n = spec.window, spec.num_filters
    cdt = torch.int32 if dtypes.is_fixed_point(spec.dtype) else torch.float32
    if spec.separable:
        co = torch.zeros((2, w), dtype=cdt, device=dev)
    else:
        co = torch.zeros((w, w) if n == 1 else (n, w, w), dtype=cdt,
                         device=dev)
    return frame, co


def _halo_calls(cf) -> int:
    """``filter2d_halo`` calls one call of the pipeline makes."""
    frame, co = _operands(cf)
    before = K.filter2d_halo.calls
    cf(frame, co)
    return K.filter2d_halo.calls - before


def launch_plan(cf) -> HaloPlan:
    """The plan of the pipeline's kernel launches (every strip of a scan
    and every shard of a ring shares one)."""
    if cf.execution == "streaming":
        return cf._strip_plan
    if cf.execution == "sharded":
        return cf._ring_plan
    return cf.plan


def verify(cf, blocks: Optional[Sequence[int]] = None) -> Report:
    """Verify a compiled pipeline: count its kernel calls, and on the
    executors that launch the kernel analyse each distinct launch under
    both loaders at every block count in ``blocks`` (default: 1 and the
    geometry's own grid)."""
    spec = cf.spec
    key = (f"{cf.execution}{'/' + cf.regime if cf.regime else ''}"
           f"/{spec.dtype}/{spec.border.policy}")
    try:
        n_calls = _halo_calls(cf)
    except Exception as e:
        report = Report(key=key, error=_err(e))
        report.emit()
        return report

    stats = [("filter2d_halo_calls", float(n_calls))]
    if cf.execution not in K.RING_EXECUTIONS:
        if n_calls:
            report = Report(key=key, error=f"executor {cf.execution!r} "
                            f"made {n_calls} filter2d_halo calls; the "
                            "analysis has no contract for them")
        else:
            report = Report(key=key, passes=("trace",), stats=tuple(stats))
        report.emit()
        return report

    want = {"cuda": 1, "streaming": cf.n_strips,
            "sharded": cf.n_shards}[cf.execution]
    if n_calls != want:
        report = Report(key=key, error=f"{cf.execution} executor made "
                        f"{n_calls} filter2d_halo calls (expected {want})")
        report.emit()
        return report

    plan = launch_plan(cf)
    form = "separable" if spec.separable else spec.form
    M = planes_of(cf.frame_shape)
    if blocks is None:
        blocks = sorted({1, default_blocks(plan, spec.num_filters, form, M)})
    report = Report(key=key, stats=tuple(stats))
    for loader in LOADERS:
        for b in blocks:
            sub = verify_kernel(plan, num_filters=spec.num_filters,
                                form=form, dtype=spec.dtype, M=M,
                                loader=loader, blocks=b,
                                key=f"{key}/{loader}/b{b}")
            report = report.merge(sub)
    report.emit()
    return report


# ---------------------------------------------------------------------------
# The sweep matrix (the CLI)
# ---------------------------------------------------------------------------

SWEEP_FRAME = (24, 300)          # 3 strips x 3 tiles at strip 8, tile 128
SWEEP_WINDOW = 5
SWEEP_STRIP, SWEEP_TILE = 8, 128
SWEEP_DTYPES = ("float32", "int8")
EXECUTORS = ("core", "xla", "streaming", "sharded", "cuda")


def _executor(name: str) -> str:
    """The reference's executor names, ``'pallas'`` read as ``'cuda'``."""
    return "cuda" if name == "pallas" else name


def _borders() -> List[BorderSpec]:
    out = []
    for p in POLICIES:
        out.append(BorderSpec(p, 7.25) if p == "constant" else BorderSpec(p))
    return out


def sweep_configs(executors: Optional[Sequence[str]] = None,
                  dtypes: Optional[Sequence[str]] = None,
                  borders: Optional[Sequence[str]] = None
                  ) -> List[dict]:
    """The shipped-configuration matrix: 5 executors × dtypes × border
    policies, the ``'cuda'`` lanes twice (``overlap``: the geometry's own
    grid; ``serial``: one block through every item), plus a bank of 3, the
    separable form and the int8 requant epilogue."""
    execs = tuple(_executor(e) for e in (executors or EXECUTORS))
    dts = tuple(dtypes or SWEEP_DTYPES)
    bds = ([BorderSpec(b, 7.25) if b == "constant" else BorderSpec(b)
            for b in borders] if borders else _borders())
    cfgs: List[dict] = []
    for ex in execs:
        for dt in dts:
            for b in bds:
                if ex in ("streaming", "sharded") and b.policy == "neglect":
                    continue                 # those executors reject it
                overlaps = (True, False) if ex == "cuda" else (True,)
                for ov in overlaps:
                    cfgs.append(dict(execution=ex, dtype=dt, border=b,
                                     overlap=ov))
    if "cuda" in execs:
        # structure extras: the bank, the separable form and the requant
        # epilogue all shape the kernel
        if "float32" in dts:
            cfgs.append(dict(execution="cuda", dtype="float32",
                             border=BorderSpec("mirror"), overlap=True,
                             num_filters=3))
            cfgs.append(dict(execution="cuda", dtype="float32",
                             border=BorderSpec("mirror"), overlap=True,
                             separable=True))
        if "int8" in dts:
            from repro_torch.core.requant import RequantSpec
            cfgs.append(dict(execution="cuda", dtype="int8",
                             border=BorderSpec("mirror"), overlap=True,
                             requant=RequantSpec(1, 7, dtype="int8")))
    return cfgs


def compile_cfg(cfg: dict, device="cpu"):
    """The configuration's pipeline, on ``device``: the sweep's frame and
    window; the strip scan at the reference's strip of 8 rows; the ring on
    one entry of ``device``."""
    from repro_torch.core.pipeline import Filter2D
    spec = Filter2D(window=SWEEP_WINDOW, border=cfg["border"],
                    dtype=cfg["dtype"],
                    num_filters=cfg.get("num_filters", 1),
                    separable=cfg.get("separable", False),
                    requant=cfg.get("requant"))
    ex = cfg["execution"]
    if ex == "sharded":
        return spec.compile(SWEEP_FRAME, ex, mesh=[device])
    return spec.compile(SWEEP_FRAME, ex, device=device,
                        strip_h=SWEEP_STRIP if ex == "streaming" else None)


def cfg_blocks(cf, cfg: dict) -> Optional[Tuple[int, ...]]:
    """Block counts a configuration verifies at: one block on the
    ``serial`` lane, the geometry's grid on ``overlap``'s."""
    if cf.execution not in K.RING_EXECUTIONS:
        return None
    if not cfg["overlap"]:
        return (1,)
    spec = cf.spec
    return (default_blocks(launch_plan(cf), spec.num_filters,
                           "separable" if spec.separable else spec.form,
                           planes_of(cf.frame_shape)),)


def cfg_key(cfg: dict) -> str:
    bits = [cfg["execution"], cfg["dtype"], cfg["border"].policy,
            "overlap" if cfg["overlap"] else "serial"]
    if cfg.get("num_filters", 1) > 1:
        bits.append(f"bank{cfg['num_filters']}")
    if cfg.get("separable"):
        bits.append("separable")
    if cfg.get("requant") is not None:
        bits.append("requant")
    return "/".join(bits)


def sweep(executors: Optional[Sequence[str]] = None,
          dtypes: Optional[Sequence[str]] = None,
          borders: Optional[Sequence[str]] = None,
          progress=None) -> Dict[str, Report]:
    """Run :func:`verify` over the whole shipped matrix on the CPU;
    returns ``{config key: Report}``. Compile failures become error
    Reports."""
    out: Dict[str, Report] = {}
    for cfg in sweep_configs(executors, dtypes, borders):
        k = cfg_key(cfg)
        try:
            cf = compile_cfg(cfg)
            blocks = cfg_blocks(cf, cfg)
        except Exception as e:
            out[k] = Report(key=k, error=_err(e))
            continue
        out[k] = verify(cf, blocks=blocks)
        if progress is not None:
            progress(k, out[k])
    return out


__all__ = ["EXECUTORS", "LOADERS", "PASS_NAMES",
           "SWEEP_DTYPES", "cfg_blocks", "cfg_key", "compile_cfg",
           "launch_plan", "planes_of", "sweep", "sweep_configs", "verify",
           "verify_kernel"]
