"""repro_torch.obs — event trace and metrics registry, behind one switch.

``obs.enable(jsonl=...)`` / ``obs.disable()`` / ``obs.tracing()``: on,
plan decisions, ``execution='auto'`` selections, compiles, per-call
executions and serving waves land as typed events in a bounded ring (and
optionally a JSONL sink), and latencies and counts land in
:data:`metrics.REGISTRY`. Off (the default): every hook is a single
attribute-test branch.
"""
from repro_torch.obs import events, metrics
from repro_torch.obs.events import (AutoSelectEvent, CompileEvent,
                                    ExecuteEvent, PlanEvent, ServeWaveEvent,
                                    Trace, disable, emit, enable, enabled,
                                    get_trace, tracing)
from repro_torch.obs.metrics import REGISTRY

__all__ = [
    "AutoSelectEvent", "CompileEvent", "ExecuteEvent", "PlanEvent",
    "REGISTRY", "ServeWaveEvent", "Trace", "disable", "emit", "enable",
    "enabled", "events", "get_trace", "metrics", "tracing",
]
