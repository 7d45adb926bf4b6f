"""Multi-device runtime on `torch.distributed` (counterpart of
`ibx.parallel`): one rank a partition (`ShardedDomain`, the generic gather
path) or a chunk of blocks (`ShardedBlockDomain`, the block marches), the
mesh of the initialised process group (`make_device_mesh`), the per-rank
ghost BC of the gather path (`sharded_impose_bc`), a local launcher
(`spawn`) and the group of one rank in this process (`one_rank_group`)."""
from .block_sharding import ShardedBlockDomain
from .launch import one_rank_group, spawn
from .sharding import (DeviceMesh, ShardedDomain, make_device_mesh,
                       sharded_impose_bc)

__all__ = ["DeviceMesh", "ShardedBlockDomain", "ShardedDomain",
           "make_device_mesh", "one_rank_group", "sharded_impose_bc", "spawn"]
