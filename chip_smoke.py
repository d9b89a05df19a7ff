#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure exits non-zero:

  1. devices  — the card's name and count, and ``nvidia-smi``'s name and
                power limit. No card is a failure.
  2. build    — builds the CUDA ``filter2d_halo`` kernel from ``src/`` into
                ``build/`` (one ``nvcc`` per source, all at once) and
                summarises ``-Xptxas -v``: registers, shared memory, spills
                (the full report stays in ``build/``).
  3. kernel   — holds the kernel against its plain torch version
                (``filter2d_halo_ref``) on the card: 6 border policies
                (non-zero constant), 4 forms + separable, w ∈ {3, 5, 7},
                float32/bfloat16/int8/uint8/int16, banks of 4, requant in
                all 3 roundings on the integer frames, ragged [3, 67, 301]
                planes, an all-max overflow edge and full-HD [3, 1440,
                1920] planes. Integers bit-exact; float32 within
                rtol=atol=3e-4; bfloat16 within 3e-2.
  4. serving  — ``FilterServeEngine(batch_size=4, device='cuda')`` serves
                32 requests drawn from ``build_mix(rng, scale=15)`` (1440x1920
                float32 w5 mirror for two tenants, 960x1440 float32 w3
                replicate, 960x1440 int8 w3 unity requant). Each result is
                held against ``filter2d_halo_ref`` on the card; recompiles
                must equal buckets, errors 0, and the kernel's launch
                counter must grow by exactly one per wave.
  5. timing   — CUDA events after warm-up at each bucket's serving shape:
                the kernel, its bound (HBM bytes over 3.35 TB/s, and the
                operations over the peak for the input type), the plain
                version, and for float32 ``F.conv2d`` on a pre-padded frame
                with TF32 off (a yardstick the port never calls); then
                where one served wave's time goes (host stacking, copy
                in, pipeline call, copy out).

The line before the last is the ``kernels`` JSON summary; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12              # H100 SXM data sheet
PEAK_OPS_PER_S = {                     # dense, per input type (data sheet)
    "float32": 67e12, "bfloat16": 989e12, "int8": 1979e12,
    "uint8": 1979e12, "int16": 67e12,
}
TOL = {"float32": 3e-4, "bfloat16": 3e-2}
POLICIES = ("neglect", "constant", "wrap", "duplicate", "mirror_dup",
            "mirror")
FORMS = ("direct", "transposed", "tree", "compress", "separable")
ROUNDINGS = ("truncate", "nearest", "nearest_even")
KERNEL_SOURCE = "src/repro_torch/kernels/filter2d/csrc/filter2d_halo.cuh"
REPLACES = "src/repro/kernels/filter2d/kernel.py:349"


def ptxas_summary(text: str):
    """(kernel, registers, static shared memory bytes, spill bytes) per
    kernel instantiation in a ``-Xptxas -v`` report."""
    import re
    rows, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            rows.append((name, int(m.group(1)), int(m.group(2)), spill))
            name = None
    return rows


def kernel_label(mangled: str) -> str:
    """``filter2d_halo<storage,acc,out,wW,form>`` from a mangled name."""
    import re
    m = re.search(r"filter2d_halo_kernelI(.*?)Li(\d+)ELi(\d+)E", mangled)
    if not m:
        return mangled
    codes = {"f": "f32", "i": "i32", "a": "i8", "h": "u8", "s": "i16",
             "13__nv_bfloat16": "bf16", "S1_": "bf16"}  # S1_: repeated type
    types = re.findall(r"13__nv_bfloat16|S1_|[fiahs]", m.group(1))
    form = ("fold", "tree", "compress", "separable")[int(m.group(3))]
    return (f"filter2d_halo<{','.join(codes[t] for t in types)},"
            f"w{m.group(2)},{form}>")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, torch, card: str):
        self.torch = torch
        self.card = card
        self.max_err = {}

    def say(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)

    # -- phase 3 -------------------------------------------------------------

    def _inputs(self, rng, dt, M, H, W, N, w, form):
        import numpy as np
        torch = self.torch
        dev = "cuda"
        if dt in ("float32", "bfloat16"):
            x = torch.from_numpy(rng.standard_normal((M, H, W))
                                 .astype(np.float32))
            x = x.to(getattr(torch, dt))
            shape = (N, 2, w) if form == "separable" else (N, w, w)
            co = torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32) / w)
        else:
            info = np.iinfo(dt)
            x = torch.from_numpy(rng.integers(info.min, int(info.max) + 1,
                                              (M, H, W)).astype(dt))
            shape = (N, 2, w) if form == "separable" else (N, w, w)
            co = torch.from_numpy(rng.integers(-8, 9, shape)
                                  .astype(np.int32))
        return x.to(dev), co.to(dev)

    def check_case(self, rng, dt, policy, form, w, *, M=3, H=67, W=301,
                   N=4, rounding=None, x=None, co=None):
        import numpy as np
        torch = self.torch
        from repro_torch.core.border_spec import BorderSpec
        from repro_torch.core.requant import RequantSpec
        from repro_torch.kernels.filter2d import halo
        from repro_torch.kernels.filter2d.kernel import (filter2d_halo,
                                                         filter2d_halo_ref)
        if x is None:
            x, co = self._inputs(rng, dt, M, H, W, N, w, form)
        M, H, W = x.shape
        N = co.shape[0]
        const = 3.7 if dt in TOL else -300.0
        rq = None if rounding is None else RequantSpec(
            rounding=rounding, dtype=dt)
        plan = halo.make_plan(H, W, w, BorderSpec(policy, const), H, W,
                              dtype=dt, requant=rq)
        q = None
        if rq is not None:
            q = torch.from_numpy(np.stack(
                [rng.integers(-(1 << 12), 1 << 12, N),
                 rng.integers(0, 21, N)], axis=1).astype(np.int32))
            q[0, 1] = 0                      # the shift-0 edge
            q = q.cuda()
        got = filter2d_halo(x, co, plan, q_params=q, form=form)
        ref = filter2d_halo_ref(x, co, plan, q_params=q, form=form)
        torch.cuda.synchronize()
        case = (f"{dt} {policy} {form} w{w} N{N} [{M},{H},{W}] "
                f"requant={rounding}")
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{case}: shape/dtype {tuple(got.shape)} "
                                 f"{got.dtype} vs {tuple(ref.shape)} "
                                 f"{ref.dtype}")
        if dt in TOL:
            g, r = got.float(), ref.float()
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{case}: non-finite output")
            err = float((g - r).abs().max())
            tol = TOL[dt]
            if not torch.allclose(g, r, rtol=tol, atol=tol):
                raise AssertionError(f"{case}: max |err| {err} over "
                                     f"rtol=atol={tol}")
        else:
            if not torch.equal(got, ref):
                diff = int((got.long() - ref.long()).abs().max())
                raise AssertionError(f"{case}: not bit-exact (max diff "
                                     f"{diff})")
            err = 0.0
        self.max_err[dt] = max(self.max_err.get(dt, 0.0), err)
        return err

    def kernel_phase(self):
        import numpy as np
        torch = self.torch
        rng = np.random.default_rng(11)
        n = 0
        for dt in ("float32", "bfloat16", "int8", "uint8", "int16"):
            for policy in POLICIES:
                for form in FORMS:
                    for w in (3, 5, 7):
                        N = 1 if form == "separable" else 4
                        self.check_case(rng, dt, policy, form, w, N=N)
                        n += 1
                        if dt not in TOL:
                            rounding = ROUNDINGS[n % 3]
                            self.check_case(rng, dt, policy, form, w, N=N,
                                            rounding=rounding)
                            n += 1
        for rounding in ROUNDINGS:           # every rounding, every int dtype
            for dt in ("int8", "uint8", "int16"):
                self.check_case(rng, dt, "mirror", "direct", 5, N=4,
                                rounding=rounding)
                n += 1
        # all-max overflow edge: the int32 MAC must wrap like the reference
        x = torch.full((2, 40, 70), 32767, dtype=torch.int16, device="cuda")
        co = torch.full((2, 7, 7), 1 << 20, dtype=torch.int32, device="cuda")
        self.check_case(rng, "int16", "duplicate", "direct", 7, x=x, co=co)
        self.check_case(rng, "int16", "duplicate", "direct", 7, x=x, co=co,
                        rounding="nearest")
        n += 2
        # full-HD planes
        self.check_case(rng, "float32", "mirror", "direct", 5, M=3, H=1440,
                        W=1920, N=1)
        self.check_case(rng, "int8", "mirror", "direct", 3, M=3, H=1440,
                        W=1920, N=1, rounding="nearest")
        n += 2
        for dt, e in self.max_err.items():
            self.say(f"kernel phase: {dt} max |kernel - plain| = {e!r}")
        self.say(f"kernel phase: {n} cases agree")

    # -- phase 4 -------------------------------------------------------------

    def serving_phase(self, seed: int = 0, requests: int = 32):
        import numpy as np
        torch = self.torch
        from repro_torch.core.pipeline import batched_shape
        from repro_torch.kernels.filter2d import kernel as K
        from repro_torch.kernels.filter2d import ops
        from repro_torch.serving.bench import build_mix
        from repro_torch.serving.engine import FilterServeEngine

        rng = np.random.default_rng(seed)
        templates = build_mix(rng, scale=15)
        weights = np.asarray([t.weight for t in templates])
        picks = rng.choice(len(templates), size=requests,
                           p=weights / weights.sum())
        picks[:len(templates)] = np.arange(len(templates))  # every template
        engine = FilterServeEngine(batch_size=4, device="cuda")
        try:
            K.filter2d_halo.launches = 0
            t0 = time.perf_counter()
            handles = [(ti, engine.submit(
                templates[ti].frame, templates[ti].coeffs,
                spec=templates[ti].spec, gains=templates[ti].gains,
                tenant=templates[ti].tenant)) for ti in picks]
            if not engine.drain(timeout=600):
                raise AssertionError("serving phase: drain timed out")
            wall = time.perf_counter() - t0
            launches = K.filter2d_halo.launches
            stats = engine.stats()
            buckets = engine.cache_size()
        finally:
            engine.shutdown()
        # the bucket pipelines' plans and executors, for the references
        expect = {}
        for ti, t in enumerate(templates):
            cf = t.spec.compile(batched_shape(t.frame.shape, 4), "auto",
                                device="cuda")
            if cf.execution != "cuda":
                raise AssertionError(f"auto resolved to {cf.execution!r} on "
                                     "a card")
            planes, _ = ops._fold_planes(torch.from_numpy(t.frame).cuda())
            co = torch.as_tensor(np.asarray(t.coeffs)).cuda()
            co = co.to(torch.int32 if t.spec.requant else torch.float32)
            q = None
            if t.gains is not None:
                q = torch.tensor(t.gains.params(1), dtype=torch.int32,
                                 device="cuda")
            y = K.filter2d_halo_ref(planes, co[None], cf.plan, q_params=q,
                                    form=t.spec.form)
            expect[ti] = y[0, 0].cpu()
        for ti, h in handles:
            got = h.result(timeout=60)
            ref = expect[ti]
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"serving: {templates[ti].name} shape "
                                     f"{tuple(got.shape)} vs "
                                     f"{tuple(ref.shape)}")
            if got.is_floating_point():
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError("serving: non-finite output")
                if not torch.allclose(got, ref, rtol=3e-4, atol=3e-4):
                    raise AssertionError(f"serving: {templates[ti].name} "
                                         "disagrees with the plain version")
            elif not torch.equal(got, ref):
                raise AssertionError(f"serving: {templates[ti].name} not "
                                     "bit-exact")
        n_buckets = len({t.bucket for t in templates})
        if stats["errors"] or stats["completed"] != requests:
            raise AssertionError(f"serving: stats {stats}")
        if not stats["recompiles"] == buckets == n_buckets:
            raise AssertionError(f"serving: recompiles {stats['recompiles']}"
                                 f" vs buckets {buckets}/{n_buckets}")
        if launches != stats["waves"]:
            raise AssertionError(f"serving: {launches} kernel launches for "
                                 f"{stats['waves']} waves")
        pixels = sum(h.pixels for _, h in handles)
        self.say(f"serving phase: {requests} requests, {stats['waves']} "
                 f"waves, {launches} kernel launches, recompiles "
                 f"{stats['recompiles']} == buckets {buckets}, errors 0")
        self.say(f"serving phase: sustained {pixels / wall!r} px/s "
                 f"({pixels} px in {wall!r} s, burst submit, batch 4, "
                 "host frames in and out)")
        return launches, templates

    # -- phase 5 -------------------------------------------------------------

    def _time(self, fn, iters: int, warmup: int = 3) -> float:
        """Device ms per call: CUDA events around ``iters`` calls that
        were all queued while the card was held busy by a sleep kernel, so
        the host's per-call Python overhead does not pace the launches."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)       # ~0.1 s of device clock
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()          # the sleep outlasted queueing
        end.synchronize()
        if not covered:
            raise AssertionError("timing: the launches were not all queued "
                                 "before the covering sleep ended")
        return start.elapsed_time(end) / iters

    def wave_breakdown(self, templates, reps: int = 5):
        """Where one served wave's time goes, per bucket: stacking the
        batch into pinned host memory (host clock), the copy to the card,
        the pipeline call (kernel, plus the operands' small copies), and
        the copy back (CUDA events); medians over ``reps`` waves."""
        import numpy as np
        torch = self.torch
        from repro_torch.core.pipeline import admit_batch, batched_shape
        seen = set()
        for t in templates:
            if t.bucket in seen:
                continue
            seen.add(t.bucket)
            cf = t.spec.compile(batched_shape(t.frame.shape, 4), "cuda",
                                device="cuda")
            parts = []
            for _ in range(reps + 1):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                t0 = time.perf_counter()
                x = admit_batch([t.frame] * 4, 4, pin_memory=True)
                t1 = time.perf_counter()
                ev[0].record()
                xd = x.to("cuda", non_blocking=True)
                ev[1].record()
                y = cf(xd, t.coeffs, gains=t.gains)
                ev[2].record()
                yh = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                yh.copy_(y, non_blocking=True)
                ev[3].record()
                ev[3].synchronize()
                t2 = time.perf_counter()
                parts.append(((t1 - t0) * 1e3, ev[0].elapsed_time(ev[1]),
                              ev[1].elapsed_time(ev[2]),
                              ev[2].elapsed_time(ev[3]), (t2 - t0) * 1e3))
            med = [float(v) for v in np.median(np.asarray(parts[1:]),
                                               axis=0)]
            self.say(f"wave {t.bucket} batch 4 {tuple(x.shape)} "
                     f"{t.spec.dtype}: host stack {med[0]!r} ms, copy in "
                     f"{med[1]!r} ms, pipeline call {med[2]!r} ms, copy out "
                     f"{med[3]!r} ms, wall {med[4]!r} ms (medians of {reps})")

    def timing_phase(self, templates):
        import numpy as np
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core.borders import extend
        from repro_torch.core.pipeline import batched_shape
        from repro_torch.kernels.filter2d import kernel as K
        rows = {}
        saved = K.filter2d_halo.launches
        for t in templates:
            if t.bucket in rows:
                continue
            cf = t.spec.compile(batched_shape(t.frame.shape, 4), "cuda",
                                device="cuda")
            planes = torch.from_numpy(np.stack([t.frame] * 4)).cuda()
            fixed = t.spec.requant is not None
            co = torch.as_tensor(np.asarray(t.coeffs)).cuda()
            co = co.to(torch.int32 if fixed else torch.float32)[None]
            co = co.contiguous()
            q = None
            if t.gains is not None:
                q = torch.tensor(t.gains.params(1), dtype=torch.int32,
                                 device="cuda")
            M, H, W = planes.shape
            w = t.spec.window

            def kern():
                return K.filter2d_halo(planes, co, cf.plan, q_params=q,
                                       form=t.spec.form)

            def plain():
                return K.filter2d_halo_ref(planes, co, cf.plan, q_params=q,
                                           form=t.spec.form)

            ms = self._time(kern, 50)
            plain_ms = self._time(plain, 5, warmup=1)
            lib_ms = None
            if not fixed:
                torch.backends.cudnn.allow_tf32 = False
                xp = extend(planes, w // 2, t.spec.border)[:, None]
                wt = co[:, None]

                def lib():
                    return F.conv2d(xp, wt)
                err = float((lib()[:, 0] - kern()[:, 0]).abs().max())
                if err > 1e-3:
                    raise AssertionError(f"yardstick conv2d disagrees: {err}")
                lib_ms = self._time(lib, 50)
            out = kern()
            bytes_moved = (planes.numel() * planes.element_size()
                           + out.numel() * out.element_size())
            ops = 2 * w * w * out.numel()
            bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_OPS_PER_S[t.spec.dtype] * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            row = {"bucket": t.bucket, "shape": [M, H, W], "w": w,
                   "dtype": t.spec.dtype, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": bound_ms,
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations",
                   "bytes": bytes_moved, "ops": ops,
                   "bytes_ms": bytes_ms, "ops_ms": ops_ms}
            rows[t.bucket] = row
            self.say(f"timing {t.bucket} planes [{M},{H},{W}] w{w} "
                     f"{t.spec.dtype}: kernel {ms!r} ms, bound {bound_ms!r} "
                     f"ms ({row['bound_by']}: {bytes_moved} B / 3.35 TB/s = "
                     f"{bytes_ms!r} ms; {ops} ops / "
                     f"{PEAK_OPS_PER_S[t.spec.dtype]:.3g} op/s = "
                     f"{ops_ms!r} ms), plain {plain_ms!r} ms, library "
                     f"{lib_ms!r} ms, {bytes_moved / (ms * 1e-3) / 1e12!r} "
                     "TB/s achieved")
        K.filter2d_halo.launches = saved
        return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    card = card_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name} x{count}", flush=True)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels.filter2d import _build
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.load_library()
    smoke = Smoke(torch, card)
    kernels = ptxas_summary(_build.PTXAS_LOG.read_text())
    if not kernels:
        raise AssertionError("no kernel in the ptxas report")
    for mangled, nreg, smem, spill in kernels:
        print(f"ptxas {kernel_label(mangled)}: {nreg} registers, {smem} B "
              f"static shared memory, {spill} B spilled")
    regs = [k[1] for k in kernels]
    smem = [k[2] for k in kernels]
    smoke.say(f"ptxas: {len(kernels)} kernel instantiations, registers "
              f"{min(regs)}..{max(regs)}, static shared memory "
              f"{min(smem)}..{max(smem)} B, spill bytes "
              f"{sum(k[3] for k in kernels)} (full report: "
              f"{_build.PTXAS_LOG.relative_to(ROOT)})")
    smoke.say(f"build: {lib.relative_to(ROOT)} in "
              f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    smoke.kernel_phase()
    smoke.say(f"kernel phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, templates = smoke.serving_phase()
    smoke.say(f"serving phase took {time.perf_counter() - t0:.1f} s")
    rows = smoke.timing_phase(templates)
    smoke.wave_breakdown(templates)
    main_row = rows["w5f32"]
    summary = {"kernels": [{
        "name": "filter2d_halo", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(smoke.max_err.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], "buckets": list(rows.values()),
        "card": card}]}
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
