"""Structured event trace: what the pipeline *decided* and what it *did*.

The paper's whole argument is an accounting argument — DSP counts, line
buffer BRAM, border overhead. The port makes the same claims from static
plans (``HaloPlan`` byte accounting, the kernel-variant counter, the
derive-scan winner). This module gives every decision and every execution
a typed, queryable record (a near-verbatim copy of the reference's):

  * :class:`PlanEvent`     — one ``derive_strip_tile`` candidate scan:
    every (tile, strip, amplification) candidate considered, the winner,
    and why it won;
  * :class:`AutoSelectEvent` — one ``execution='auto'`` decision: which
    rule fired and the static accounting inputs it compared;
  * :class:`CompileEvent`  — one ``CompiledFilter`` construction: spec,
    geometry, resolved executor, plan accounting, wall time;
  * :class:`ExecuteEvent`  — one pipeline call (tracing on): wall time up
    to the device finishing, pixels/s, cache hit vs new kernel variant
    (detected from the ``cache_size()`` counter);
  * :class:`ServeWaveEvent` — one serving-engine wave.

Events land in an in-memory ring (bounded, thread-safe) and optionally in
a JSONL sink — one ``json.dumps`` line per event.

Zero-overhead-when-off is the design invariant: the enabled check is one
module-attribute test (``_TRACE is None``) and every emitter guards on it.
Events are host-side records; nothing here touches a tensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import deque
from typing import ClassVar, List, Optional, Tuple

__all__ = [
    "AutoSelectEvent", "CompileEvent", "ExecuteEvent", "PlanEvent",
    "ServeWaveEvent", "Trace", "disable", "emit", "enable", "enabled",
    "events", "get_trace", "tracing",
]

DEFAULT_CAPACITY = 4096


@dataclasses.dataclass(frozen=True)
class PlanEvent:
    """One ``derive_strip_tile`` scan: the candidates and the winner."""

    kind: ClassVar[str] = "plan"
    H: int
    W: int
    window: int
    dtype: str
    vmem_budget: int
    overlap: bool
    # (tile_w, strip_h, read_amplification) per candidate, widest first;
    # empty when a caller-fixed knob short-circuited the scan
    candidates: Tuple[Tuple[int, int, float], ...]
    strip_h: int
    tile_w: int
    why: str


@dataclasses.dataclass(frozen=True)
class AutoSelectEvent:
    """One ``execution='auto'`` decision and its accounting inputs."""

    kind: ClassVar[str] = "auto_select"
    rule: str                     # mesh | pixel_cache | row_buffer | ...
    execution: str                # the resolved executor
    reason: str                   # the rule, in words, with the numbers
    resident_vmem_bytes: int      # the frame-resident working-set estimate
    vmem_budget: int
    has_mesh: bool


@dataclasses.dataclass(frozen=True)
class CompileEvent:
    """One ``CompiledFilter`` construction (plan + executor build)."""

    kind: ClassVar[str] = "compile"
    key: str                      # the pipeline's obs key (executor/dtype/…)
    spec: str                     # repr of the Filter2D spec
    spec_hash: int
    frame_shape: Tuple[int, ...]
    execution: str
    regime: Optional[str]
    strip_h: Optional[int]
    tile_w: Optional[int]
    ext_banks: Optional[int]
    out_banks: Optional[int]
    vmem_working_set: Optional[int]
    hbm_bytes_per_pixel: Optional[float]
    wall_ms: float


@dataclasses.dataclass(frozen=True)
class ExecuteEvent:
    """One pipeline call, timed until the device finished it."""

    kind: ClassVar[str] = "execute"
    key: str
    wall_us: float
    pixels_per_s: float
    cache_hit: bool               # False = a new kernel variant this call
    cache_size: int               # the kernel-variant counter after the call


@dataclasses.dataclass(frozen=True)
class ServeWaveEvent:
    """One serving-engine wave: a bucket's batched dispatch, timed from
    admission to host copy-out (``FilterServeEngine`` emits these when
    tracing is on — the per-wave twin of the per-call ExecuteEvent)."""

    kind: ClassVar[str] = "serve_wave"
    key: str                      # bucket digest (core.pipeline.bucket_key)
    tenant: str
    batch: int                    # real requests in the wave
    padded: int                   # zero planes padded to the static batch
    cache_hit: bool               # bucket executable was warm
    queue_depth: int              # queue length left behind at admission
    wall_us: float                # dispatch -> copy-out wall time
    pixels_per_s: float           # real (unpadded) pixels over wall time


def _to_record(seq: int, t: float, event) -> dict:
    rec = {"seq": seq, "t": t, "kind": event.kind}
    rec.update(dataclasses.asdict(event))
    return rec


class Trace:
    """Bounded in-memory event ring + optional JSONL sink.

    Thread-safe: emitters from any thread append under one lock; readers
    get snapshots. The ring drops oldest-first at ``capacity`` (the JSONL
    sink, when set, keeps everything — it is the durable record)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 jsonl: Optional[str] = None):
        self.capacity = int(capacity)
        self.jsonl_path = jsonl
        self._ring = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = open(jsonl, "a") if jsonl else None

    def emit(self, event) -> None:
        with self._lock:
            self._seq += 1
            rec = _to_record(self._seq, time.time(), event)
            self._ring.append((rec, event))
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")

    def events(self, kind: Optional[str] = None) -> List:
        """Snapshot of the ring's events (oldest first), optionally
        filtered by ``kind``."""
        with self._lock:
            items = list(self._ring)
        return [e for rec, e in items if kind is None or rec["kind"] == kind]

    def records(self, kind: Optional[str] = None) -> List[dict]:
        """Snapshot as JSON-ready dicts (what the JSONL sink writes)."""
        with self._lock:
            items = list(self._ring)
        return [rec for rec, _ in items
                if kind is None or rec["kind"] == kind]

    @property
    def emitted(self) -> int:
        """Total events emitted (>= len(ring) once the ring wraps)."""
        with self._lock:
            return self._seq

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# The one switch everything guards on: None = observability off.
_TRACE: Optional[Trace] = None


def enable(capacity: int = DEFAULT_CAPACITY,
           jsonl: Optional[str] = None) -> Trace:
    """Turn tracing on (replacing any active trace); returns the Trace."""
    global _TRACE
    if _TRACE is not None:
        _TRACE.close()
    _TRACE = Trace(capacity=capacity, jsonl=jsonl)
    return _TRACE


def disable() -> None:
    """Turn tracing off and close the JSONL sink (if any)."""
    global _TRACE
    if _TRACE is not None:
        _TRACE.close()
    _TRACE = None


def enabled() -> bool:
    return _TRACE is not None


def get_trace() -> Optional[Trace]:
    return _TRACE


def emit(event) -> None:
    """Emit when tracing is on; a no-op branch when off."""
    t = _TRACE
    if t is not None:
        t.emit(event)


def events(kind: Optional[str] = None) -> List:
    t = _TRACE
    return t.events(kind) if t is not None else []


@contextlib.contextmanager
def tracing(capacity: int = DEFAULT_CAPACITY, jsonl: Optional[str] = None):
    """``with obs.tracing() as trace: ...`` — scoped enable/disable."""
    trace = enable(capacity=capacity, jsonl=jsonl)
    try:
        yield trace
    finally:
        disable()
