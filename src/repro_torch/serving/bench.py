"""Open-loop serving bench: Poisson arrivals through FilterServeEngine.

  PYTHONPATH=src python -m repro_torch.serving.bench --duration 20 \
      --rate 40 --scale 15 --json SERVE_h100.json --obs-jsonl OBS.jsonl

Runs on the card unless ``--device cpu`` is given.

*Open loop*: arrival times are drawn up front from an exponential
inter-arrival distribution and requests are submitted on that schedule
regardless of completions — the driver never waits for the engine, so a
slow engine shows up as queue growth and latency, not as a silently
reduced offered load (the closed-loop failure mode that flatters every
serving benchmark). The request mix is heterogeneous by construction:
two tenants sharing one (spec, geometry) bucket with different
coefficients (tenant swaps must ride the zero-recompile contract), a
second float geometry, and an int8 requantised pipeline.

Everything reported comes from ``obs.REGISTRY`` — the engine's serve.*
counters and histograms are the measurement substrate: p50/p99 request
latency from ``serve/request_us``, queue depth from ``serve/queue_depth``,
sustained pixels/s from the pixel counter over the driver wall clock.
``--json`` writes a ``bench_trajectory_v1`` payload: an aggregate row
(sustained ``pixels_per_s``, latency and queue percentiles) and one row
per bucket (wave percentiles, the plan's analytic
``hbm_bytes_per_pixel``). The payload names the device it ran on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import platform
import sys
import time
from typing import List

import numpy as np

import torch

from repro_torch import obs
from repro_torch.core import filters
from repro_torch.core.border_spec import BorderSpec
from repro_torch.core.pipeline import Filter2D, batched_shape, resolve_device
from repro_torch.core.requant import RequantSpec
from repro_torch.serving.engine import FilterServeEngine


@dataclasses.dataclass(frozen=True)
class Template:
    """One request archetype in the synthetic mix."""

    name: str            # row label (unique per template)
    bucket: str          # bucket label (templates sharing a compiled
                         # executable share this)
    spec: Filter2D
    frame: np.ndarray
    coeffs: np.ndarray
    gains: object
    tenant: str
    weight: float


def build_mix(rng: np.random.Generator,
              scale: int = 1) -> List[Template]:
    """The heterogeneous request mix (3 buckets, 4 tenants): two tenants
    sharing one bucket with different coefficients, a smaller-window
    float bucket, and an int8 unity-requant bucket. ``scale`` multiplies
    the frame edge lengths (1 = test-sized; 15 = 1440×1920 and 960×1440
    frames). The draws follow the reference's ``build_mix`` exactly, so
    one seed gives both packages the same mix."""
    h1, w1 = 96 * scale, 128 * scale
    h2, w2 = 64 * scale, 96 * scale
    f32 = Filter2D(window=5, border=BorderSpec("mirror"))
    frame1 = rng.standard_normal((h1, w1)).astype(np.float32)
    f3 = Filter2D(window=3, border=BorderSpec("replicate"))
    frame2 = rng.standard_normal((h2, w2)).astype(np.float32)
    ki = rng.integers(-4, 5, (3, 3)).astype(np.int32)
    if int(ki.sum()) == 0:
        ki[1, 1] += 1       # unity_gain rejects zero-gain kernels
    rq = RequantSpec.unity_gain(ki, "int8")
    i8 = Filter2D(window=3, dtype="int8", requant=rq.gain_free())
    frame3 = rng.integers(-20, 20, (h2, w2)).astype(np.int8)
    return [
        Template(name="w5f32/alpha", bucket="w5f32", spec=f32,
                 frame=frame1, coeffs=filters.gaussian(5), gains=None,
                 tenant="alpha", weight=0.4),
        Template(name="w5f32/beta", bucket="w5f32", spec=f32,
                 frame=frame1, coeffs=filters.box(5), gains=None,
                 tenant="beta", weight=0.3),
        Template(name="w3f32/gamma", bucket="w3f32", spec=f3,
                 frame=frame2, coeffs=filters.gaussian(3), gains=None,
                 tenant="gamma", weight=0.2),
        Template(name="w3i8/delta", bucket="w3i8", spec=i8,
                 frame=frame3, coeffs=ki, gains=rq,
                 tenant="delta", weight=0.1),
    ]


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3e}" if (v and abs(v) >= 1e4) else f"{v:.2f}"
    return str(v)


def _derived(d: dict) -> str:
    return ";".join(f"{k}={_fmt(v)}" for k, v in d.items() if v is not None)


def run_bench(*, duration_s: float = 5.0, rate_rps: float = 40.0,
              batch_size: int = 4, cache_slots: int = 8,
              execution: str = "auto", device="cuda", scale: int = 1,
              seed: int = 0) -> dict:
    """Drive the engine open-loop for ``duration_s`` at ``rate_rps``
    offered requests/s over ``build_mix(rng, scale)`` on ``device``;
    returns the ``bench_trajectory_v1`` payload.

    Requires ``obs`` tracing to be ON (the registry is the measurement
    substrate); resets ``obs.REGISTRY`` so the exported numbers belong
    to this run alone.
    """
    if not obs.enabled():
        raise RuntimeError("run_bench needs obs tracing on: call "
                           "obs.enable() (or pass --obs-jsonl) first")
    obs.REGISTRY.reset()
    rng = np.random.default_rng(seed)
    templates = build_mix(rng, scale)
    weights = np.asarray([t.weight for t in templates])
    weights = weights / weights.sum()

    dev = resolve_device(device)
    engine = FilterServeEngine(batch_size=batch_size,
                               cache_slots=cache_slots,
                               execution=execution, device=dev)

    # Warmup: every bucket compiles exactly once here; the open-loop
    # phase must then be 100% warm — serve.recompiles stays pinned at
    # num_buckets for the whole run (the acceptance invariant).
    for t in templates:
        engine.submit(t.frame, t.coeffs, spec=t.spec, gains=t.gains,
                      tenant=t.tenant)
    engine.drain()
    num_buckets = engine.cache_size()
    warm_recompiles = obs.REGISTRY.counter("serve.recompiles").value
    if warm_recompiles != num_buckets:
        raise RuntimeError(
            f"warmup compiled {warm_recompiles} buckets, cache holds "
            f"{num_buckets} — the bucket key is unstable")
    # Steady-state window: drop the warmup samples (their latency is
    # compile time, not serving latency). Any serve.recompiles increment
    # from here on is a warm-contract violation, checked below.
    obs.REGISTRY.reset()

    # Pre-draw the open-loop schedule: exponential gaps at the offered
    # rate, template choices by mix weight.
    n_max = max(int(math.ceil(duration_s * rate_rps * 2)), 16)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, size=n_max))
    arrivals = arrivals[arrivals < duration_s]
    choices = rng.choice(len(templates), size=len(arrivals), p=weights)

    submitted = []
    t0 = time.perf_counter()
    for offset, ti in zip(arrivals, choices):
        now = time.perf_counter()
        wait = t0 + offset - now
        if wait > 0:
            time.sleep(wait)
        t = templates[ti]
        submitted.append(engine.submit(
            t.frame, t.coeffs, spec=t.spec, gains=t.gains,
            tenant=t.tenant))
    engine.drain()
    wall_s = max(time.perf_counter() - t0, 1e-9)
    engine.shutdown()
    stats = engine.stats()
    if stats["errors"]:
        raise RuntimeError(f"{stats['errors']} request(s) errored during "
                           "the open-loop run")

    reg = obs.REGISTRY
    post_recompiles = reg.counter("serve.recompiles").value
    if post_recompiles:
        raise RuntimeError(
            f"{post_recompiles} recompile(s) after warmup — a post-warmup "
            "request missed the warm cache (zero-recompile contract broken)")
    req = reg.histogram("serve/request_us").summary()
    queue = reg.histogram("serve/queue_depth").summary()
    pixels = sum(r.pixels for r in submitted)
    rows = [{
        "name": f"serve/open_loop/{execution}",
        "us_per_call": req["p50"],
        "pixels_per_s": pixels / wall_s,
        "p50_us": req["p50"], "p90_us": req["p90"], "p99_us": req["p99"],
        "mean_us": req["mean"], "max_us": req["max"],
        "queue_p50": queue["p50"], "queue_p99": queue["p99"],
        "requests": len(submitted), "waves": stats["waves"],
        "buckets": num_buckets, "recompiles": stats["recompiles"],
        "cache_hits": stats["cache_hits"],
        "padded_planes": stats["padded_planes"],
        "offered_rps": rate_rps, "batch": batch_size,
        "cache_slots": cache_slots,
    }]
    seen = set()
    for t in templates:
        if t.bucket in seen:
            continue
        seen.add(t.bucket)
        key8 = engine.bucket_key_for(t.spec, t.frame.shape)[:8]
        wave = reg.histogram(f"serve/wave_us/{key8}").summary()
        pipe = t.spec.compile(
            batched_shape(t.frame.shape, batch_size), execution, device=dev)
        bpp = pipe.hbm_bytes_per_pixel()
        rows.append({
            "name": f"serve/bucket/{t.bucket}",
            "us_per_call": wave["p50"],
            "p50_us": wave["p50"], "p99_us": wave["p99"],
            "mean_us": wave["mean"], "count": wave["count"],
            "hbm_bytes_per_pixel": (None if bpp is None
                                    else round(float(bpp), 4)),
            "window": t.spec.window, "dtype": t.spec.dtype,
            "frame_h": t.frame.shape[0], "frame_w": t.frame.shape[1],
            "execution": pipe.execution, "batch": batch_size,
        })
        rows[-1] = {k: v for k, v in rows[-1].items() if v is not None}
    return {
        "schema": "bench_trajectory_v1",
        "created_unix": time.time(),
        "lane": "serve",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "scale": scale,
        "duration_s": duration_s,
        "offered_rps": rate_rps,
        "failures": 0,
        "rows": rows,
        "obs_metrics": reg.export(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="open-loop Poisson serving bench over "
                    "FilterServeEngine")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="open-loop phase length in seconds")
    ap.add_argument("--rate", type=float, default=40.0,
                    help="offered load, requests/s")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-slots", type=int, default=8)
    ap.add_argument("--execution", default="auto",
                    help="executor knob passed to every bucket compile")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--scale", type=int, default=1,
                    help="frame edge multiplier of the request mix")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the bench_trajectory_v1 record here")
    ap.add_argument("--obs-jsonl", default=None, metavar="PATH",
                    help="stream obs events (incl. serve_wave) to this "
                         "JSONL file")
    args = ap.parse_args(argv)

    obs.enable(jsonl=args.obs_jsonl)
    try:
        payload = run_bench(duration_s=args.duration, rate_rps=args.rate,
                            batch_size=args.batch,
                            cache_slots=args.cache_slots,
                            execution=args.execution, device=args.device,
                            scale=args.scale, seed=args.seed)
    finally:
        n = obs.get_trace().emitted if obs.get_trace() else 0
        obs.disable()
    print("name,us_per_call,derived")
    for r in payload["rows"]:
        rest = {k: v for k, v in r.items()
                if k not in ("name", "us_per_call")}
        print(f"{r['name']},{r['us_per_call']:.1f},{_derived(rest)}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=1)
        print(f"# wrote {len(payload['rows'])} rows -> {args.json}",
              file=sys.stderr)
    if args.obs_jsonl:
        print(f"# wrote {n} obs events -> {args.obs_jsonl}",
              file=sys.stderr)
    agg = payload["rows"][0]
    print(f"# p50={agg['p50_us']:.0f}us p99={agg['p99_us']:.0f}us "
          f"sustained={agg['pixels_per_s']:.3e} px/s "
          f"recompiles={agg['recompiles']} (buckets={agg['buckets']})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
