"""Build and load the CUDA ``dwconv1d`` kernel: ``csrc/`` as one
:class:`~repro_torch.kernels._build.KernelLibrary` in ``build/dwconv1d/``.

    python -m repro_torch.kernels.dwconv1d._build   # build and print ptxas
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import KernelLibrary

CSRC = Path(__file__).resolve().parent / "csrc"
# dwconv1d_launch(x, w, b, y, B, S, C, k, dtype, stream)
LIBRARY = KernelLibrary("dwconv1d", CSRC, {
    "dwconv1d_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])})
load_library = LIBRARY.load


if __name__ == "__main__":
    print(LIBRARY.build(verbose=True))
    print(LIBRARY.ptxas_log.read_text())
