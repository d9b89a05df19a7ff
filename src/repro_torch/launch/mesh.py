"""Production mesh construction, as the reference's ``launch/mesh.py``,
over devices the caller names.

The reference's ``jax.make_mesh`` takes the devices of its runtime; here
each function takes them explicitly (a ``DeviceMesh`` entry is any
``torch.device``, and may repeat), uses the first ``prod(shape)`` and
raises where fewer are given. None of them fills a mesh by repeating a
card on its own. ``["meta"] * 512`` gives the production meshes with no
device behind them: the dry run's (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.sharding.mesh import DeviceMesh, make_mesh


def make_production_mesh(devices: Sequence, *,
                         multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_moe_mesh(devices: Sequence, *, multi_pod: bool = False,
                  experts: int = 8) -> DeviceMesh:
    """Same chips, re-axed for expert parallelism: the 16-way 'model' axis
    splits into ('expert', 'model') = (experts, 16 // experts). Attention
    and MLP TP span both sub-axes; MoE experts shard over 'expert'."""
    m = 16 // experts
    shape = (2, 16, experts, m) if multi_pod else (16, experts, m)
    axes = (("pod", "data", "expert", "model") if multi_pod
            else ("data", "expert", "model"))
    return make_mesh(shape, axes, devices)


def make_test_mesh(devices: Sequence, shape=(2, 2),
                   axes=("data", "model")) -> DeviceMesh:
    """A small mesh for tests (on the CPU, ``["cpu"] * n``)."""
    return make_mesh(shape, axes, devices)
