"""The paper's contribution in PyTorch: high-throughput 2D spatial filtering.

Submodules (each the counterpart of the reference package's module of the
same name):
  border_spec  — the policy-neutral BorderSpec + aliases (paper Table IV)
  borders      — border policies as lean index remaps (paper §III)
  filters      — runtime coefficient file + preset bank (paper §I/§II)
  filter2d     — direct/transposed/tree/compress forms, plain torch (§II)
  requant      — the fused output-scaler spec + numpy reference (paper §IV)
  streaming    — row-strip streaming executor with carried row buffer
  distributed  — row-sharded executor: a halo ring over a device mesh
  pipeline     — the plan-and-execute front door: Filter2D → CompiledFilter
  dtypes       — storage-dtype names (numpy has no bfloat16)
"""
from repro_torch.core.border_spec import (ALIASES, POLICIES,
                                          SAME_SIZE_POLICIES, BorderSpec,
                                          np_pad_mode, out_shape,
                                          quantize_constant)
from repro_torch.core.filter2d import (FORMS, filter2d, filter2d_xla,
                                       filter_bank, macs_per_pixel,
                                       reduction_depth)
from repro_torch.core.distributed import Mesh, filter2d_sharded
from repro_torch.core.filters import (CoefficientFile, decompose_separable,
                                      default_bank, preset)
from repro_torch.core.pipeline import (DEFAULT_VMEM_BUDGET, EXECUTIONS,
                                       CompiledFilter, Filter2D)
from repro_torch.core.requant import RequantSpec, requantize_ref
from repro_torch.core.streaming import (filter2d_streaming,
                                        strip_height_for_vmem)

__all__ = [
    "ALIASES", "BorderSpec", "CoefficientFile", "CompiledFilter",
    "DEFAULT_VMEM_BUDGET", "EXECUTIONS", "FORMS", "Filter2D", "Mesh",
    "POLICIES", "RequantSpec", "SAME_SIZE_POLICIES", "decompose_separable",
    "default_bank", "filter2d", "filter2d_sharded", "filter2d_streaming",
    "filter2d_xla", "filter_bank", "macs_per_pixel", "np_pad_mode",
    "out_shape", "preset",
    "quantize_constant", "reduction_depth", "requantize_ref",
    "strip_height_for_vmem",
]
