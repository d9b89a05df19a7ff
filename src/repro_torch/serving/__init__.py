"""repro_torch.serving — batched filter serving over the pipeline front door.

:class:`FilterServeEngine` turns the one-frame-at-a-time
``CompiledFilter`` API into a multi-tenant service on one card:
heterogeneous ``(frame, spec, coeffs, gains, tenant)`` requests land in a
thread-safe queue, are bucketed by ``(Filter2D spec, frame geometry,
dtype, compile knobs)`` into a bounded warm LRU of compiled pipelines, and
dispatch as zero-padded batches folded into the kernel's plane dimension.
``serving.bench`` is the open-loop Poisson driver that measures it.
"""
from repro_torch.serving.engine import FilterRequest, FilterServeEngine

__all__ = ["FilterRequest", "FilterServeEngine"]
