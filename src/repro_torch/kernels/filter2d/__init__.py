from repro_torch.core.requant import RequantSpec
from repro_torch.kernels.filter2d.halo import (DEFAULT_VMEM_BUDGET, HaloPlan,
                                               derive_strip_tile,
                                               hbm_bytes_per_pixel,
                                               hbm_write_bytes_per_pixel,
                                               make_plan, read_amplification,
                                               read_bytes_per_pixel)
from repro_torch.kernels.filter2d.kernel import (acc_dtype, filter2d_halo,
                                                 filter2d_halo_ref, out_dtype)
from repro_torch.kernels.filter2d.ops import (filter2d_cuda,
                                              filter_bank_cuda)
from repro_torch.kernels.filter2d.ref import filter2d_ref

__all__ = [
    "DEFAULT_VMEM_BUDGET", "HaloPlan", "RequantSpec", "acc_dtype",
    "derive_strip_tile", "filter2d_cuda", "filter2d_halo",
    "filter2d_halo_ref", "filter2d_ref", "filter_bank_cuda",
    "hbm_bytes_per_pixel", "hbm_write_bytes_per_pixel", "make_plan",
    "out_dtype", "read_amplification", "read_bytes_per_pixel",
]
