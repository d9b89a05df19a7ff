"""Batched filter serving: a multi-tenant request queue over the
``Filter2D`` -> ``CompiledFilter`` front door, on one card.

The paper's cores sustain one pixel per cycle *under continuous load*;
the port's analogue of continuous load is a stream of heterogeneous
frame-filter requests from many tenants. ``FilterServeEngine`` is that
front end: fixed slots, warm compiled pipelines, one background worker:

  * **Buckets.** Every request carries a :class:`~repro_torch.core.
    pipeline.Filter2D` spec and a frame; requests with the same (spec,
    frame geometry, dtype, compile knobs) identity — ``core.pipeline.
    bucket_key`` — are servable by the same compiled pipeline. The
    engine keeps a bounded LRU of warm ``CompiledFilter``s, one per
    bucket; a cold bucket compiles (``serve.recompiles``), a warm one
    dispatches immediately (``serve.cache_hits``).
  * **Waves.** Within a bucket, requests whose coefficients/gains agree
    (grouped per tenant) are batched into the pipeline's *plane grid
    dim* — k frames stack into one ``[B, H, W, C]`` dispatch
    (``core.pipeline.admit_batch``), zero-padded to the engine's static
    batch size so every wave is one kernel launch of one shape.
  * **Tenant swaps are free.** Coefficients, separable factors and
    requant gains are runtime operands of the kernel, so tenant A's wave
    and tenant B's wave alternate through the same bucket with zero
    recompiles — the paper's runtime coefficient file, multi-tenant.
  * **Overlap.** One background worker thread runs admission, dispatch
    and copy-out as a software pipeline. On a card, dispatching a wave
    is explicit asynchronous CUDA work on the engine's own stream: the
    wave is stacked into pinned host memory and copied to the card with
    ``non_blocking=True``, the kernel is launched, a non-blocking copy
    into a pinned host buffer is started, and a CUDA event is recorded —
    so ``_dispatch`` returns before the card finishes, and wave k+1 is
    admitted and dispatched *before* wave k's copy-out is waited on (on
    that event, never on a device-wide synchronise). Submitters never
    block on the device at all. On the CPU the same loop runs the plain
    path synchronously.

Instrumentation: the engine keeps its own always-on counters
(:meth:`FilterServeEngine.stats`) and, when ``repro_torch.obs`` tracing
is on, mirrors them into ``obs.REGISTRY`` (counters ``serve.requests``,
``serve.waves``, ``serve.cache_hits``, ``serve.recompiles``,
``serve.evictions``, ``serve.pixels``, ``serve.errors``,
``serve.cancelled``; histograms ``serve/request_us``, ``serve/wave_us``,
``serve/wave_us/<bucket8>``, ``serve/queue_depth``) and emits one
:class:`~repro_torch.obs.events.ServeWaveEvent` per wave.
``serving/bench.py`` drives the engine under an open-loop Poisson arrival
process.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dtypes
from repro_torch.core.pipeline import (Filter2D, admit_batch, batched_shape,
                                       bucket_key, resolve_device,
                                       split_batch)
from repro_torch.core.requant import RequantSpec
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics


def _operand_digest(x):
    """In-process identity of a coefficient/factor/gain operand: waves
    only batch requests whose operands are bytewise identical, so one
    dispatch's traced operands are correct for every rider."""
    if x is None:
        return None
    if isinstance(x, RequantSpec):
        return repr(x)
    if isinstance(x, (tuple, list)):
        return tuple(_operand_digest(e) for e in x)
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        return (tuple(t.shape), str(t.dtype),
                hash(t.reshape(-1).view(torch.uint8).numpy().tobytes()))
    a = np.asarray(x)
    return (a.shape, a.dtype.str, hash(a.tobytes()))


@dataclasses.dataclass
class FilterRequest:
    """One in-flight job: a frame, the filter structure to run it
    through, and the tenant's runtime operands. The engine fills
    ``result`` (or ``error``) and the timestamps; callers block on
    :meth:`result` or poll :meth:`done`."""

    rid: int
    frame: object                       # [H, W] | [H, W, C] host array
    spec: Filter2D
    coeffs: object                      # [w, w] | [N, w, w] | (u, v)
    gains: object = None
    tenant: str = "default"
    submit_t: float = 0.0
    admit_t: Optional[float] = None
    done_t: Optional[float] = None

    def __post_init__(self):
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._key: Optional[str] = None
        self._sig = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        """Block until served; returns the filtered frame as a CPU tensor
        (request rank restored) or raises the error the wave hit."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not served within "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-result wall time (None until served)."""
        if self.done_t is None:
            return None
        return self.done_t - self.submit_t

    @property
    def pixels(self) -> int:
        h, w = self.frame.shape[:2]
        planes = self.frame.shape[2] if len(self.frame.shape) == 3 else 1
        return int(h) * int(w) * int(planes)


class FilterServeEngine:
    """The batched, bucketed, LRU-warmed serving front end (see module
    docstring). Construction starts the worker; ``shutdown(drain=True)``
    (or the context manager) stops it after the queue empties.

    ``batch_size``   static planes per dispatch — waves are zero-padded
                     up to it, so each bucket owns exactly ONE compiled
                     pipeline of one shape regardless of traffic.
    ``cache_slots``  warm buckets resident at once. The LRU models the
                     paper's "one bitstream serves every filter" claim
                     under multi-tenant heterogeneity: hot (spec,
                     geometry) pairs stay compiled, cold ones recompile
                     on return (``stats()['recompiles']`` counts engine-
                     level cold-bucket compiles).
    ``execution`` passes through to ``Filter2D.compile`` for every
    bucket.
    ``device``       where the buckets run: the card unless the caller
                     asks for ``'cpu'``; a card that is not there raises.
    ``compile_fn``   test seam: ``(spec, batched_shape) -> callable`` —
                     default is the real front door.
    """

    def __init__(self, *, batch_size: int = 4, cache_slots: int = 8,
                 execution: str = "auto",
                 device="cuda",
                 compile_fn: Optional[Callable] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1; got {batch_size}")
        if cache_slots < 1:
            raise ValueError(f"cache_slots must be >= 1; got {cache_slots}")
        self.batch_size = int(batch_size)
        self.cache_slots = int(cache_slots)
        self.execution = execution
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        # the engine's own stream: every wave's copies and launch queue
        # here, so the worker's dispatches never wait on other work
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self._compile_fn = compile_fn or self._default_compile

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue: deque[FilterRequest] = deque()
        self._cache: "OrderedDict[str, object]" = OrderedDict()
        self._pending = 0
        self._stop = False
        self._rid = 0
        self._stats = {
            "requests": 0, "completed": 0, "waves": 0, "cache_hits": 0,
            "recompiles": 0, "evictions": 0, "pixels": 0,
            "padded_planes": 0, "errors": 0, "cancelled": 0,
        }
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="filter-serve-worker")
        self._worker.start()

    # -- public API ---------------------------------------------------------

    def submit(self, frame, coeffs, *, spec: Filter2D, gains=None,
               tenant: str = "default") -> FilterRequest:
        """Enqueue one frame-filter job; returns immediately with the
        request handle. Thread-safe: any number of submitters."""
        if not isinstance(spec, Filter2D):
            raise TypeError("spec must be a Filter2D; got "
                            f"{type(spec).__name__}")
        if len(frame.shape) not in (2, 3):
            raise ValueError("serving frames are [H, W] or [H, W, C]; "
                             f"got shape {tuple(frame.shape)}")
        got = dtypes.name(frame.dtype)
        if got != spec.dtype:
            raise ValueError(f"frame dtype {got!r} disagrees with the "
                             f"spec's storage contract {spec.dtype!r}")
        req = FilterRequest(rid=0, frame=frame, spec=spec, coeffs=coeffs,
                            gains=gains, tenant=tenant,
                            submit_t=time.perf_counter())
        req._key = self.bucket_key_for(spec, frame.shape)
        req._sig = (tenant, _operand_digest(coeffs), _operand_digest(gains))
        with self._work:
            if self._stop:
                raise RuntimeError("engine is shut down")
            self._rid += 1
            req.rid = self._rid
            self._queue.append(req)
            self._pending += 1
            self._stats["requests"] += 1
            depth = len(self._queue)
            self._work.notify_all()
        if obs_events.enabled():
            reg = obs_metrics.REGISTRY
            reg.counter("serve.requests").inc()
            reg.histogram("serve/queue_depth").record(depth)
        return req

    def bucket_key_for(self, spec: Filter2D, frame_shape) -> str:
        """The warm-cache bucket a (spec, frame geometry) pair lands in
        under this engine's knobs (``core.pipeline.bucket_key``)."""
        return bucket_key(spec, tuple(frame_shape), batch=self.batch_size,
                          execution=self.execution,
                          device=self.device)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request has been served (or
        errored). Returns False on timeout."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._work:
            while self._pending > 0:
                rem = (None if deadline is None
                       else deadline - time.perf_counter())
                if rem is not None and rem <= 0:
                    return False
                self._work.wait(rem)
        return True

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the worker. ``drain=True`` (default) serves everything
        already queued first; ``drain=False`` cancels queued requests
        (their ``result()`` raises). Idempotent."""
        cancelled: List[FilterRequest] = []
        with self._work:
            self._stop = True
            if not drain:
                cancelled = list(self._queue)
                self._queue.clear()
            self._work.notify_all()
        for req in cancelled:
            req._error = RuntimeError("engine shut down before this "
                                      "request was served")
            req.done_t = time.perf_counter()
            req._event.set()
        if cancelled:
            with self._work:
                self._pending -= len(cancelled)
                self._stats["cancelled"] += len(cancelled)
                self._work.notify_all()
            if obs_events.enabled():
                obs_metrics.REGISTRY.counter("serve.cancelled").inc(
                    len(cancelled))
        self._worker.join(timeout)

    def __enter__(self) -> "FilterServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)

    def cache_size(self) -> int:
        """Warm buckets resident right now (<= ``cache_slots``)."""
        with self._lock:
            return len(self._cache)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def stats(self) -> dict:
        """Snapshot of the engine counters (always on, obs or not)."""
        with self._lock:
            return dict(self._stats)

    # -- scheduling ---------------------------------------------------------

    def _default_compile(self, spec: Filter2D, shape: Tuple[int, ...]):
        return spec.compile(shape, self.execution, device=self.device)

    def _next_wave(self, block: bool):
        """Pop the head-of-line request plus every queued request that
        can ride its dispatch (same bucket, same operand signature), up
        to the batch size; everything skipped keeps its queue order."""
        with self._work:
            while block and not self._queue and not self._stop:
                self._work.wait()
            if not self._queue:
                return None
            head = self._queue.popleft()
            wave = [head]
            keep: deque[FilterRequest] = deque()
            while self._queue and len(wave) < self.batch_size:
                r = self._queue.popleft()
                if r._key == head._key and r._sig == head._sig:
                    wave.append(r)
                else:
                    keep.append(r)
            keep.extend(self._queue)
            self._queue = keep
            depth = len(self._queue)
        return head._key, wave, depth

    def _get_pipeline(self, key: str, req: FilterRequest):
        """Warm-LRU lookup; a miss compiles (outside the lock) and may
        evict the least-recently-used bucket."""
        with self._lock:
            pipe = self._cache.get(key)
            if pipe is not None:
                self._cache.move_to_end(key)
                self._stats["cache_hits"] += 1
                return pipe, True
        shape = batched_shape(req.frame.shape, self.batch_size)
        pipe = self._compile_fn(req.spec, shape)
        with self._lock:
            self._cache[key] = pipe
            self._cache.move_to_end(key)
            self._stats["recompiles"] += 1
            while len(self._cache) > self.cache_slots:
                self._cache.popitem(last=False)
                self._stats["evictions"] += 1
        if obs_events.enabled():
            obs_metrics.REGISTRY.counter("serve.recompiles").inc()
        return pipe, False

    def _dispatch(self, key: str, wave: List[FilterRequest], depth: int):
        """Admit + launch one wave; returns the in-flight record without
        blocking on the device. On a card (the worker has made the
        engine's stream current): pinned host stack → non-blocking copy
        to the card → kernel launch → non-blocking copy into a pinned
        host buffer → an event recorded behind it. Copy-out is waited on
        in :meth:`_complete`, by which time the *next* wave has already
        been admitted and dispatched."""
        pipe, hit = self._get_pipeline(key, wave[0])
        if hit and obs_events.enabled():
            obs_metrics.REGISTRY.counter("serve.cache_hits").inc()
        t0 = time.perf_counter()
        for r in wave:
            r.admit_t = t0
        x = admit_batch([r.frame for r in wave], self.batch_size,
                        pin_memory=self._cuda)
        if self._cuda:
            x = x.to(self.device, non_blocking=True)
        head = wave[0]
        if head.gains is not None:
            y = pipe(x, head.coeffs, gains=head.gains)
        else:
            y = pipe(x, head.coeffs)
        done = None
        if self._cuda:
            y_host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            y_host.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            y = y_host
        return key, wave, y, done, t0, hit, depth

    def _complete(self, inflight) -> None:
        """Wait for one wave's copy-out (its event, not the whole device),
        split the results back per request, and wake the waiters."""
        key, wave, y, done, t0, hit, depth = inflight
        if done is not None:
            done.synchronize()
        now = time.perf_counter()
        wall_s = max(now - t0, 1e-9)
        outs = split_batch(y, len(wave), len(wave[0].frame.shape))
        pixels = 0
        for r, out in zip(wave, outs):
            r._result = out
            r.done_t = now
            pixels += r.pixels
            r._event.set()
        padded = self.batch_size - len(wave)
        with self._work:
            self._pending -= len(wave)
            self._stats["completed"] += len(wave)
            self._stats["waves"] += 1
            self._stats["pixels"] += pixels
            self._stats["padded_planes"] += padded
            self._work.notify_all()
        if obs_events.enabled():
            reg = obs_metrics.REGISTRY
            reg.counter("serve.waves").inc()
            reg.counter("serve.pixels").inc(pixels)
            wall_us = wall_s * 1e6
            reg.histogram("serve/wave_us").record(wall_us)
            reg.histogram(f"serve/wave_us/{key[:8]}").record(wall_us)
            for r in wave:
                reg.histogram("serve/request_us").record(
                    (now - r.submit_t) * 1e6)
            obs_events.emit(obs_events.ServeWaveEvent(
                key=key, tenant=wave[0].tenant, batch=len(wave),
                padded=padded, cache_hit=hit, queue_depth=depth,
                wall_us=wall_us, pixels_per_s=pixels / wall_s))

    def _fail_wave(self, wave: List[FilterRequest],
                   err: BaseException) -> None:
        now = time.perf_counter()
        for r in wave:
            r._error = err
            r.done_t = now
            r._event.set()
        with self._work:
            self._pending -= len(wave)
            self._stats["errors"] += len(wave)
            self._work.notify_all()
        if obs_events.enabled():
            obs_metrics.REGISTRY.counter("serve.errors").inc(len(wave))

    def _run(self) -> None:
        """The worker: a two-stage software pipeline. Each turn admits +
        dispatches wave k+1 (if any work is queued) and only *then*
        copies out wave k — so the host-side batching of the next wave
        overlaps the device computing the current one. On a card the
        engine's stream is current for the worker's whole life."""
        if self._cuda:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                self._loop()
        else:
            self._loop()

    def _loop(self) -> None:
        inflight = None
        while True:
            picked = self._next_wave(block=inflight is None)
            nxt = None
            if picked is not None:
                key, wave, depth = picked
                try:
                    nxt = self._dispatch(key, wave, depth)
                except Exception as e:  # noqa: BLE001 — fail the wave only
                    self._fail_wave(wave, e)
            if inflight is not None:
                try:
                    self._complete(inflight)
                except Exception as e:  # noqa: BLE001
                    _, wave, *_ = inflight
                    self._fail_wave([r for r in wave if not r.done()], e)
            inflight = nxt
            if inflight is None:
                with self._work:
                    if self._stop and not self._queue:
                        return
