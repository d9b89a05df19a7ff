"""Sharding: logical-axis rules (``rules``), a mesh of named axes over
torch devices (``mesh``) and one-controller collectives over it
(``collectives``)."""
from repro_torch.sharding.mesh import DeviceMesh, make_mesh
from repro_torch.sharding.rules import (EP_OVERRIDES, PartitionSpec,
                                        ShardingCtx, make_ctx, make_rules,
                                        null_ctx)

__all__ = ["DeviceMesh", "EP_OVERRIDES", "PartitionSpec", "ShardingCtx",
           "make_ctx", "make_mesh", "make_rules", "null_ctx"]
