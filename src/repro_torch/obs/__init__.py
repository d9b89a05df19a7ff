"""repro_torch.obs — event trace, metrics registry and profiler hooks,
behind one switch.

``obs.enable(jsonl=...)`` / ``obs.disable()`` / ``obs.tracing()``: on,
plan decisions, ``execution='auto'`` selections, compiles, per-call
executions and serving waves land as typed events in a bounded ring (and
optionally a JSONL sink), latencies and counts land in
:data:`metrics.REGISTRY`, and the compile and call phases get
``torch.profiler`` (and, on a card, NVTX) ranges. Off (the default):
every hook is a single attribute-test branch.

``CompiledFilter.explain()`` is the plan report built on the same
accounting; ``obs.roofline`` holds the H100 constants and the
two-ceiling roofline model every analytic pixel-rate claim is stated in.
"""
from repro_torch.obs import events, metrics, roofline
from repro_torch.obs.events import (AutoSelectEvent, CompileEvent,
                                    ExecuteEvent, PlanEvent, ServeWaveEvent,
                                    Trace, disable, emit, enable, enabled,
                                    get_trace, tracing)
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.profiler import annotate, profile_dump

__all__ = [
    "AutoSelectEvent", "CompileEvent", "ExecuteEvent", "PlanEvent",
    "REGISTRY", "ServeWaveEvent", "Trace", "annotate", "disable", "emit",
    "enable", "enabled", "events", "get_trace", "metrics", "profile_dump",
    "roofline", "tracing",
]
