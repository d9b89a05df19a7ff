"""Analytic roofline arithmetic and the NVIDIA H100 constants it is stated in.

One source of truth for the peak numbers the port quotes:
``CompiledFilter.explain()`` derives its predicted pixel rate from them and
``chip_smoke.py`` states every kernel's bound in them. The model is the
two-ceiling roofline of the reference's ``obs/roofline.py``: a kernel that
issues ``f`` operations and moves ``b`` device-memory bytes per output
pixel sustains at most ``min(peak / f, bandwidth / b)`` pixels/s.

The constants are NVIDIA's data-sheet figures per H100 part, dense rates
without sparsity, at each part's full power limit (700 W for SXM5); a card
set below its limit runs slower under load. Per input type, on the units
the port's kernels use: float32 on the CUDA cores, bfloat16 on the tensor
cores, and the filter's int8/uint8/int16 frames as an int32 × int32 MAC on
the 64 IMAD lanes of an SM, half the 128 float32 lanes (Hopper
architecture white paper): 132 SMs × 64 lanes × 2 ops × 1.98 GHz =
33.5e12 op/s on the SXM5 part.

The links a collective crosses, per GPU and per direction (the rates the
mesh roofline of ``launch/roofline.py`` divides its collective bytes by):

- ``NVLINK_BW``, 450e9 B/s: NVLink 4 within an 8-GPU HGX H100 node, 18
  links of 25 GB/s each way (900 GB/s both ways; NVIDIA H100 data sheet,
  HGX H100 and DGX H100 system descriptions);
- ``INTER_NODE_BW``, 50e9 B/s: across nodes, one 400 Gb/s NDR InfiniBand
  port (ConnectX-7) per GPU, the DGX H100 / DGX SuperPOD layout. That it
  equals the TPU v5e's inter-chip figure (50 GB/s) is a coincidence.

``link_bw(devices)`` picks between them: a mesh of at most
``NVLINK_DOMAIN`` (8) devices fits one node; a larger one has an axis
that crosses nodes (both axes of the 16 x 16 production mesh do), and its
collectives run at the inter-node rate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

__all__ = ["HBM_BW", "INTER_NODE_BW", "NVLINK_BW", "NVLINK_DOMAIN", "PARTS",
           "PEAK_FLOPS", "PEAK_OPS_PER_S", "Part", "link_bw", "part_of",
           "predicted_pixel_rate"]


@dataclasses.dataclass(frozen=True)
class Part:
    """One H100 part: its name, device-memory rate and peak operations per
    second by input type."""

    name: str
    hbm_bw: float
    peak_ops: Mapping[str, float]


def _peaks(float32: float, bfloat16: float) -> Dict[str, float]:
    imad = float32 / 2                    # 64 IMAD lanes vs 128 FP32 lanes
    return {"float32": float32, "bfloat16": bfloat16, "int8": imad,
            "uint8": imad, "int16": imad}


PARTS = {
    "sxm5": Part("H100 SXM5", 3.35e12, _peaks(67e12, 989e12)),
    "pcie": Part("H100 PCIe", 2.0e12, _peaks(51e12, 756e12)),
    "nvl": Part("H100 NVL", 3.9e12, _peaks(60e12, 835e12)),
}

# the SXM5 part ("NVIDIA H100 80GB HBM3"): the card the port is measured on
HBM_BW = PARTS["sxm5"].hbm_bw
PEAK_OPS_PER_S = dict(PARTS["sxm5"].peak_ops)
PEAK_FLOPS = PEAK_OPS_PER_S["float32"]


NVLINK_BW = 450e9          # B/s per GPU per direction, NVLink 4 (HGX H100)
INTER_NODE_BW = 50e9       # B/s per GPU per direction, one 400 Gb/s NDR port
NVLINK_DOMAIN = 8          # GPUs an HGX H100 node joins by NVLink


def link_bw(devices: int) -> float:
    """The per-GPU link rate a collective over a mesh of ``devices`` runs
    at: NVLink within one node, the inter-node port past it."""
    return NVLINK_BW if devices <= NVLINK_DOMAIN else INTER_NODE_BW


def part_of(device_name: Optional[str]) -> str:
    """The ``PARTS`` key for a ``torch.cuda.get_device_name`` string: the
    PCIe and NVL parts by name, the SXM5 part otherwise (and for ``None``,
    a pipeline planned on the CPU)."""
    name = (device_name or "").lower()
    if "pcie" in name:
        return "pcie"
    if "nvl" in name:
        return "nvl"
    return "sxm5"


def predicted_pixel_rate(flops_per_pixel: float,
                         bytes_per_pixel: Optional[float],
                         peak_flops: float = PEAK_FLOPS,
                         hbm_bw: float = HBM_BW) -> Dict[str, float]:
    """Both roofline ceilings and the binding one, per output pixel.

    Returns ``compute_bound_pixels_per_s``, ``memory_bound_pixels_per_s``
    (``inf`` when the respective cost is zero/unknown), the ``min`` of the
    two as ``predicted_pixels_per_s``, and ``bound`` naming the ceiling.
    """
    compute = (peak_flops / flops_per_pixel if flops_per_pixel
               else float("inf"))
    memory = (hbm_bw / bytes_per_pixel if bytes_per_pixel
              else float("inf"))
    return {
        "flops_per_pixel": float(flops_per_pixel),
        "bytes_per_pixel": (float(bytes_per_pixel)
                            if bytes_per_pixel else None),
        "compute_bound_pixels_per_s": compute,
        "memory_bound_pixels_per_s": memory,
        "predicted_pixels_per_s": min(compute, memory),
        "bound": "compute" if compute < memory else "memory",
        "peak_flops": float(peak_flops),
        "hbm_bw": float(hbm_bw),
    }
