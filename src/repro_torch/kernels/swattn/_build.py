"""Build and load the CUDA ``swattn`` kernel: ``csrc/`` as one
:class:`~repro_torch.kernels._build.KernelLibrary` in ``build/swattn/``.

    python -m repro_torch.kernels.swattn._build   # build and print ptxas
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels._build import KernelLibrary

CSRC = Path(__file__).resolve().parent / "csrc"
# swattn_launch(q, k, v, o, B, S, H, KV, hd, window, scale, dtype, stream);
# swattn_tile_keys(dtype); swattn_tile_queries(dtype)
LIBRARY = KernelLibrary("swattn", CSRC, {
    "swattn_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                      + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "swattn_tile_keys": [ctypes.c_int],
    "swattn_tile_queries": [ctypes.c_int]})
load_library = LIBRARY.load


if __name__ == "__main__":
    print(LIBRARY.build(verbose=True))
    print(LIBRARY.ptxas_log.read_text())
