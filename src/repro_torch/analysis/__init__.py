"""Kernel verifier: the CUDA ring's schedule checked against its
invariants — the port's counterpart of the reference's static verifier
(``src/repro/analysis``).

The ring (``kernels/filter2d/csrc/filter2d_halo_ring.cuh``) reproduces a
hand-scheduled FPGA datapath in software — overlapped window loads, a
ring of shared-memory stages, storage-width words — and its invariants
(every stage fill waited exactly once, no stage refilled while it is
read, read-once from memory, narrow words end to end, shared memory
within a block) are checked here. ``verify`` takes a
:class:`~repro_torch.core.pipeline.CompiledFilter`, schedules each launch
it makes as an event trace (:mod:`repro_torch.analysis.ir`: the schedule
model on the CPU, or the trace build's log on the card) and runs the pass
pipeline (:mod:`repro_torch.analysis.passes`) over it, producing a typed
:class:`~repro_torch.analysis.report.Report` on the ``repro_torch.obs``
event/JSONL conventions.

    from repro_torch import analysis
    report = analysis.verify(cf)          # cf: a CompiledFilter
    assert report.clean, report.render()

``python -m repro_torch.analysis --sweep`` runs the executor × dtype ×
border matrix on the CPU.
"""
from repro_torch.analysis.ir import (KernelIR, from_device_log,
                                     schedule_diff, schedule_model)
from repro_torch.analysis.passes import PASSES, run_passes
from repro_torch.analysis.report import Finding, Report, load_report
from repro_torch.analysis.verify import (sweep, sweep_configs, verify,
                                         verify_kernel)

__all__ = [
    "Finding", "KernelIR", "PASSES", "Report", "from_device_log",
    "load_report", "run_passes", "schedule_diff", "schedule_model", "sweep",
    "sweep_configs", "verify", "verify_kernel",
]
