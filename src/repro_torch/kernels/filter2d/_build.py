"""Build and load the CUDA ``filter2d_halo`` kernel: ``csrc/`` as one
:class:`~repro_torch.kernels._build.KernelLibrary` in
``build/filter2d_halo/`` (the shared machinery is in
``repro_torch/kernels/_build.py``).

    python -m repro_torch.kernels.filter2d._build   # build and print ptxas
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import KernelLibrary

CSRC = Path(__file__).resolve().parent / "csrc"
# filter2d_halo_launch: 4 pointers, 9 ints, the border constant as a
# double, 4 ints, the loader flag, the output's bank size, the stream;
# filter2d_halo_geometry: 3 ints and an int[8] to fill;
# filter2d_halo_smem: 5 ints
LIBRARY = KernelLibrary("filter2d_halo", CSRC, {
    "filter2d_halo_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                             + [ctypes.c_double] + [ctypes.c_int] * 6
                             + [ctypes.c_void_p]),
    "filter2d_halo_geometry": [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "filter2d_halo_smem": [ctypes.c_int] * 5})
PTXAS_LOG = LIBRARY.ptxas_log
build = LIBRARY.build
load_library = LIBRARY.load
_sources = LIBRARY.sources


if __name__ == "__main__":
    print(build(verbose=True))
    print(PTXAS_LOG.read_text())
