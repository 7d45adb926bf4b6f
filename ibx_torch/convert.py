"""Numpy tables -> the port's device tables.

The solver has no learned weights: what both packages are handed, and what
the tests hand to both, is the compiled mesh. `tables_from_numpy` takes
the block tables as numpy arrays (the fields of the JAX package's
`BlockTables`, or `ibx_torch.topology.blocks.build_block_tables_raw`
output) and the ghost-family dict of `_collect_families`, and returns the
port's `BlockTables` and `GhostBC` on ``device``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from .topology.blocked_bc import GhostBC
from .topology.blocks import BlockTables


def tables_from_numpy(bt_fields: Dict[str, object], families: dict,
                      names: Sequence[str], device
                      ) -> Tuple[BlockTables, GhostBC]:
    bt = BlockTables.from_numpy(bt_fields, device)
    bc = GhostBC.from_numpy(families, names, bt.block_size ** bt.nd, device)
    return bt, bc
