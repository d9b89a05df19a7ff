"""Storage-dtype names shared by the specs, the planner and the kernels.

numpy has no ``bfloat16``, so the port names every dtype by string (the
form ``Filter2D.dtype`` and ``RequantSpec.dtype`` carry) and maps names
onto torch for tensors and onto byte widths and integer ranges here.
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH = {
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64,
}

# Narrow storage dtypes that run the fixed-point contract: stream at the
# narrow width, multiply-accumulate in int32 (paper §IV, B=8 pixels onto
# a 48-bit DSP48 accumulator).
FIXED_POINT = ("int8", "uint8", "int16")
FLOATS = ("float16", "bfloat16", "float32", "float64")


def name(dtype) -> str:
    """Canonical name of a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and dtype in _TORCH:
        return dtype
    return np.dtype(dtype).name


def to_torch(dtype) -> torch.dtype:
    n = name(dtype)
    if n not in _TORCH:
        raise ValueError(f"dtype {n!r} has no torch counterpart here")
    return _TORCH[n]


def itemsize(dtype) -> int:
    return to_torch(dtype).itemsize


def is_integer(dtype) -> bool:
    n = name(dtype)
    return n.startswith("int") or n.startswith("uint")


def is_fixed_point(dtype) -> bool:
    """True for frame dtypes that take the int32-accumulate datapath."""
    return name(dtype) in FIXED_POINT


def is_float(dtype) -> bool:
    return name(dtype) in FLOATS
