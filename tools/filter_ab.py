"""Time the filter kernel's generic window (W = 0: every window past 7)
across kernel source trees, on the card.

    python3 tools/filter_ab.py --tree parent=DIR \
        --edit mb1 '__launch_bounds__(NT, W == 0 ? 2 : 1)' \
                   '__launch_bounds__(NT, 1)'

Builds the filter library from this checkout's ``csrc/`` ("this"), from
each ``--tree NAME=DIR`` (another checkout's ``csrc/``, for example the
parent commit's from ``git archive``) and from each ``--edit NAME OLD NEW``
(a copy of this ``csrc/`` with the text OLD of ``filter2d_halo_ring.cuh``
replaced by NEW), all under ``build/``. Prints every library's registers
and spills of the generic instantiations. Then, for each row of
``ROWS`` ([4,960,1440] frames, a mirror border, one filter), holds every
library's output against the plain version bit for bit and times the
libraries in turns (a, b, c, c, b, a), each time CUDA events over 50
queued calls (``chip_smoke.Smoke._time``). Prints one line per row and,
last, the rows as JSON. Exits 1 on a mismatch, 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (label, storage dtype, w, form, requant dtype or None, a coefficient of
# 200: the int32 MAC route of an 8-bit bank)
ROWS = (
    ("f32 w9", "float32", 9, "direct", None, False),
    ("f32 w13", "float32", 13, "direct", None, False),
    ("f32 compress w9", "float32", 9, "compress", None, False),
    ("f32 tree w9", "float32", 9, "tree", None, False),
    ("f32 tree w13", "float32", 13, "tree", None, False),
    ("bf16 tree w9", "bfloat16", 9, "tree", None, False),
    ("bf16 w9", "bfloat16", 9, "direct", None, False),
    ("bf16 compress w9", "bfloat16", 9, "compress", None, False),
    ("bf16 compress w13", "bfloat16", 13, "compress", None, False),
    ("bf16 separable w13", "bfloat16", 13, "separable", None, False),
    ("i16 w9 -> i32", "int16", 9, "direct", None, False),
    ("i16 w9 -> i16", "int16", 9, "direct", "int16", False),
    ("i16 w13 -> i16", "int16", 13, "direct", "int16", False),
    ("i16 separable w13 -> i16", "int16", 13, "separable", "int16", False),
    ("i16 w9 -> i8", "int16", 9, "direct", "int8", False),
    ("i16 separable w13 -> u8", "int16", 13, "separable", "uint8", False),
    ("i8 w9 -> i8 dp4a", "int8", 9, "direct", "int8", False),
    ("i8 w9 -> i16 dp4a", "int8", 9, "direct", "int16", False),
    ("i8 w9 -> i16 int32 MAC", "int8", 9, "direct", "int16", True),
    ("i8 separable w13 -> i8", "int8", 13, "separable", "int8", False),
    ("u8 w9 -> u8 dp4a", "uint8", 9, "direct", "uint8", False),
    ("u8 w9 -> i16 dp4a", "uint8", 9, "direct", "int16", False),
    ("u8 separable w13 -> u8", "uint8", 13, "separable", "uint8", False),
)


def edited_copy(src: Path, dst: Path, old: str, new: str) -> Path:
    """``src`` copied to ``dst`` with ``old`` replaced by ``new`` in the
    ring header; raises if ``old`` is not there exactly once."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    ring = dst / "filter2d_halo_ring.cuh"
    text = ring.read_text()
    if text.count(old) != 1:
        raise ValueError(f"{old!r} occurs {text.count(old)} times in "
                         f"{ring.name}")
    ring.write_text(text.replace(old, new))
    return dst


def row_inputs(torch, rng, dt, w, form, rq, wide, shape=(4, 960, 1440)):
    """(planes, coefficients, plan, q_params) of a row, on the card."""
    import numpy as np
    from repro_torch.core.border_spec import BorderSpec
    from repro_torch.core.requant import RequantSpec
    from repro_torch.kernels.filter2d import halo
    M, H, W = shape
    if dt in ("float32", "bfloat16"):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        x = x.to(getattr(torch, dt))
    else:
        info = np.iinfo(dt)
        x = torch.from_numpy(rng.integers(info.min, int(info.max) + 1,
                                          shape).astype(dt))
    cshape = (1, 2, w) if form == "separable" else (1, w, w)
    if dt in ("float32", "bfloat16"):
        co = torch.from_numpy((rng.standard_normal(cshape) / w)
                              .astype(np.float32))
    else:
        co = torch.from_numpy(rng.integers(-8, 9, cshape).astype(np.int32))
        if wide:
            co.view(-1)[0] = 200
    spec = None if rq is None else RequantSpec(multiplier=3, shift=6,
                                               rounding="nearest", dtype=rq)
    plan = halo.make_plan(H, W, w, BorderSpec("mirror"), H, W, dtype=dt,
                          requant=spec)
    q = None if spec is None else torch.tensor(spec.params(1),
                                               dtype=torch.int32)
    return (x.cuda(), co.cuda(), plan, None if q is None else q.cuda())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--edit", action="append", nargs=3, default=[],
                    metavar=("NAME", "OLD", "NEW"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("filter_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import _build as KB
    from repro_torch.kernels.filter2d import _build as FB
    from repro_torch.kernels.filter2d import kernel as K
    from repro_torch.obs import roofline
    card = CS.card_line()
    print(card, flush=True)
    sig = FB.LIBRARY.signatures
    libs = {"this": KB.KernelLibrary("f2d_ab_this", FB.CSRC, sig)}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        libs[name] = KB.KernelLibrary(f"f2d_ab_{name}", Path(path), sig)
    for name, old, new in args.edit:
        d = edited_copy(Path(FB.CSRC), ROOT / "build" / f"f2d_ab_src_{name}",
                        old, new)
        libs[name] = KB.KernelLibrary(f"f2d_ab_{name}", d, sig)
    t0 = time.perf_counter()
    KB.build_all(list(libs.values()), verbose=True)
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    for name, lib in libs.items():
        for m, regs, _, spill in CS.ptxas_summary(lib.ptxas_log.read_text()):
            label = CS.kernel_label(m)
            if ",w0," in label:
                print(f"ptxas {name} {label}: {regs} registers, {spill} B "
                      "spilled", flush=True)
    loaded = {name: lib.load() for name, lib in libs.items()}
    smoke = CS.Smoke(torch, card, roofline.PARTS[roofline.part_of(
        torch.cuda.get_device_name(0))])
    rng = np.random.default_rng(27)
    own = K._build.load_library
    bad, out = 0, {}
    try:
        for label, dt, w, form, rq, wide in ROWS:
            x, co, plan, q = row_inputs(torch, rng, dt, w, form, rq, wide)
            ref = K.filter2d_halo_ref(x, co, plan, q_params=q, form=form)

            def run():
                return K.filter2d_halo(x, co, plan, q_params=q, form=form)
            times = {name: [] for name in loaded}
            order = list(loaded.items())
            for name, lib in order + order[::-1]:
                K._build.load_library = lambda lib=lib: lib
                if not torch.equal(run(), ref):
                    bad += 1
                    print(f"MISMATCH {name} {label}", flush=True)
                times[name].append(smoke._time(run, 50))
            out[label] = times
            mean = {k: sum(v) / len(v) for k, v in times.items()}
            print(f"{card} ab {label}: " + ", ".join(
                f"{k} {v!r} ms ({mean[k] / mean['this']!r} of this)"
                for k, v in times.items()), flush=True)
    finally:
        K._build.load_library = own
    print(json.dumps({"card": card, "rows": out, "mismatches": bad}),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
