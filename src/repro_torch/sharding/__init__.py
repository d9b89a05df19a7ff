"""Sharding: logical-axis rules (``rules``), a mesh of named axes over
torch devices (``mesh``), one-controller collectives over it
(``collectives``), tensors placed on it by a ``PartitionSpec``
(``placement``), the mesh train step's per-layer gathering (``fsdp``)
and its tensor parallelism over 'model' (``tp``)."""
from repro_torch.sharding.mesh import DeviceMesh, make_mesh
from repro_torch.sharding.placement import NamedSharding, ShardedTensor
from repro_torch.sharding.rules import (EP_OVERRIDES, PartitionSpec,
                                        ShardingCtx, make_ctx, make_rules,
                                        null_ctx)

__all__ = ["DeviceMesh", "EP_OVERRIDES", "NamedSharding", "PartitionSpec",
           "ShardedTensor", "ShardingCtx", "make_ctx", "make_mesh",
           "make_rules", "null_ctx"]
