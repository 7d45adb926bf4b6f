"""Multi-device runtime on `torch.distributed` (counterpart of
`ibx.parallel`): one rank a partition (`ShardedDomain`, the generic gather
path) or a chunk of blocks (`ShardedBlockDomain`, the block marches), the
mesh of the initialised process group (`make_device_mesh`), the per-rank
ghost BC of the gather path (`sharded_impose_bc`) and a local launcher
(`spawn`)."""
from .block_sharding import ShardedBlockDomain
from .launch import spawn
from .sharding import (DeviceMesh, ShardedDomain, make_device_mesh,
                       sharded_impose_bc)

__all__ = ["DeviceMesh", "ShardedBlockDomain", "ShardedDomain",
           "make_device_mesh", "sharded_impose_bc", "spawn"]
