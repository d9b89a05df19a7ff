"""Process-wide counters + latency histograms with p50/p90/p99 export.

The serving/bench substrate: ``REGISTRY`` is one thread-safe process-wide
registry of named :class:`Counter` and :class:`Histogram` instruments.
Pipelines record call latencies here when tracing is on; the serving
engine counts requests/waves through it; the serving bench derives its
percentile row keys from the same :func:`percentiles` arithmetic so a
``p99_us=`` on a bench row and a ``p99`` in a metrics export mean the
same estimator. A near-verbatim copy of the reference's registry.

``REGISTRY.export()`` emits JSON aligned with the ``BENCH_*.json`` row
schema (``{"schema": ..., "rows": [{"name": ..., <metrics>}]}``).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

__all__ = ["Counter", "Histogram", "Registry", "REGISTRY", "percentiles"]

# Bounded per-histogram sample reservoir: percentile queries see the most
# recent window, running count/sum/extrema see everything ever recorded.
DEFAULT_RESERVOIR = 4096

PERCENTILES = (50.0, 90.0, 99.0)


def percentiles(samples: Sequence[float],
                qs: Iterable[float] = PERCENTILES) -> Tuple[float, ...]:
    """The one percentile estimator every obs consumer shares (numpy
    linear interpolation): bench rows, histogram summaries, explain()."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.size == 0:
        return tuple(float("nan") for _ in qs)
    return tuple(float(np.percentile(arr, q)) for q in qs)


class Counter:
    """Monotonic thread-safe counter."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Histogram:
    """Thread-safe latency histogram: bounded sample reservoir + running
    aggregates. ``summary()`` reports count/mean/min/max over everything
    recorded and p50/p90/p99 over the most recent reservoir window."""

    def __init__(self, name: str, reservoir: int = DEFAULT_RESERVOIR):
        self.name = name
        self._samples = deque(maxlen=int(reservoir))
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def record(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._samples.append(v)
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, q: float) -> float:
        with self._lock:
            snapshot = list(self._samples)
        return percentiles(snapshot, (q,))[0]

    def summary(self) -> Dict[str, float]:
        with self._lock:
            snapshot = list(self._samples)
            count, total = self._count, self._sum
            lo, hi = self._min, self._max
        p50, p90, p99 = percentiles(snapshot, PERCENTILES)
        return {"count": count,
                "mean": total / count if count else float("nan"),
                "min": lo if count else float("nan"),
                "max": hi if count else float("nan"),
                "p50": p50, "p90": p90, "p99": p99}


class Registry:
    """Named-instrument registry; get-or-create semantics per name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def histogram(self, name: str,
                  reservoir: int = DEFAULT_RESERVOIR) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, reservoir)
            return h

    def counters(self) -> Dict[str, int]:
        with self._lock:
            items = list(self._counters.items())
        return {name: c.value for name, c in items}

    def histograms(self) -> Dict[str, Histogram]:
        with self._lock:
            return dict(self._histograms)

    def reset(self) -> None:
        """Drop every instrument (tests; never called on a hot path)."""
        with self._lock:
            self._counters.clear()
            self._histograms.clear()

    def export_rows(self) -> List[dict]:
        """Instruments as ``BENCH_*.json``-shaped rows: counters become
        ``{"name": "counter/<n>", "value": v}``; histograms become
        ``{"name": "latency/<n>", "us_per_call": p50, "p50_us": ...,
        "p90_us": ..., "p99_us": ..., "count": ...}`` — the same key
        vocabulary bench rows carry."""
        rows: List[dict] = []
        for name, value in sorted(self.counters().items()):
            rows.append({"name": f"counter/{name}", "value": value})
        for name, hist in sorted(self.histograms().items()):
            s = hist.summary()
            rows.append({"name": f"latency/{name}",
                         "us_per_call": s["p50"],
                         "p50_us": s["p50"], "p90_us": s["p90"],
                         "p99_us": s["p99"], "mean_us": s["mean"],
                         "max_us": s["max"], "count": s["count"]})
        return rows

    def export(self) -> dict:
        return {"schema": "obs_metrics_v1", "rows": self.export_rows()}


# The process-wide registry every hook records into.
REGISTRY = Registry()
