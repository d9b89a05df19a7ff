"""``torch.profiler`` hooks, gated on the obs switch.

  * :func:`annotate` — a host-side ``torch.profiler.record_function``
    range (plus an NVTX range on a card) for the plan/compile/call phases.
    Returns a ``nullcontext`` when observability is off, so the default
    path pays one branch.
  * :func:`profile_dump` — the opt-in capture knob
    (``Filter2D.compile(..., profile_dump=dir)``): wraps one call in
    ``torch.profiler.profile`` and writes its Chrome trace into that
    directory, without the caller touching the profiler API.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from repro_torch.obs import events as _events

__all__ = ["annotate", "profile_dump"]


def annotate(name: str):
    """A ``record_function`` (and, on a card, NVTX) range when
    observability is on; a no-op when off."""
    if not _events.enabled():
        return contextlib.nullcontext()
    return _ranges(name)


@contextlib.contextmanager
def _ranges(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def profile_dump(log_dir: Optional[str]):
    """``torch.profiler.profile`` around the block, its Chrome trace
    written to ``log_dir/repro_torch.<pid>.<ns>.trace.json`` (no-op when
    ``None``). Traces the card too when there is one."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        str(log_dir), f"repro_torch.{os.getpid()}.{time.time_ns()}"
                      ".trace.json"))
