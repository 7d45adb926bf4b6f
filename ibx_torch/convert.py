"""Numpy tables -> the port's device tables.

The solver has no learned weights: what both packages are handed, and what
the tests hand to both, is the compiled mesh. `tables_from_numpy` takes
the block tables as numpy arrays (the fields of the JAX package's
`BlockTables`, or `ibx_torch.topology.blocks.build_block_tables_raw`
output) and the ghost-family dict of `_collect_families`, and returns the
port's `BlockTables` and `GhostBC` on ``device``, for a 2D or a 3D mesh
(the kernel tables of `BlockTables` exist at nd = 3 only). The ghost
families' image distances come across with them
(`GhostBC.image_distances`, in the dict's row order).

The gather path's tables come across the same way: `stencil_from_numpy`,
`partition_from_numpy`, `boundary_from_numpy` and
`fused_boundary_from_numpy` take the fields of the JAX package's `Stencil`,
`Partition`, `Boundary` and `FusedBoundary` as numpy arrays (a `Stencil`
field as its ``(idx, w)`` pair or a dict with those keys) and return the
port's objects on ``device``, index tables as int64.

A case's flat state comes across with `state_from_numpy`: the JAX case's
``P0`` (and, for RANS, ``Rt0``) as numpy arrays -> float32 tensors on
``device``. The cut-cell wall's tables come across with
`cut3_from_numpy` (`geometry.cutcell.cut_metrics_2d` output -> the
``cut3`` of `ops.block_ops.euler_rhs_grid`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.block_ops import to_blocks
from .ops.operators import Partition
from .ops.stencil import Stencil, stencil_from_padded
from .topology.blocked_bc import GhostBC
from .topology.blocks import BlockTables
from .topology.domain import Boundary, FusedBoundary, _f32, _i64


def tables_from_numpy(bt_fields: Dict[str, object], families: dict,
                      names: Sequence[str], device,
                      dense_families: Optional[Sequence[str]] = None,
                      ) -> Tuple[BlockTables, GhostBC]:
    """``dense_families`` is accepted and ignored (`GhostBC.from_numpy`)."""
    bt = BlockTables.from_numpy(bt_fields, device)
    bc = GhostBC.from_numpy(families, names, bt.block_size ** bt.nd, device,
                            dense_families=dense_families)
    return bt, bc


def cut3_from_numpy(cm: dict, bt: BlockTables, device) -> dict:
    """`cut_metrics_2d` output -> the ``cut3`` tables of `euler_rhs_grid`
    on ``bt``'s block grid: index tables int64, weights float32, the
    fluid fraction and its inverse as block grids."""
    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def grid(a):
        return to_blocks(bt, f32(a)[:, None])

    return dict(
        owner=tuple(i64(o) for o in cm["owner"]),
        neighbor=tuple(i64(n) for n in cm["neighbor"]),
        wr=tuple(f32(w) for w in cm["wr"]),
        wl=tuple(f32(w) for w in cm["wl"]),
        wall_cells=i64(cm["wall_cells"]),
        wall_coef=f32(cm["wall_coef"]),
        xw_rel=f32(cm["xw_rel"]),
        inv_alpha3=grid(cm["inv_alpha"]),
        alpha3=grid(cm["alpha"])[..., 0],
    )


def state_from_numpy(*arrays, device) -> Tuple[torch.Tensor, ...]:
    """Flat state arrays (``P`` [N, 2+nd], ``Rt`` [N], ...) -> float32
    tensors on ``device``, one per array."""
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in arrays)


def stencil_from_numpy(st, device) -> Stencil:
    """``st``: an ``(idx, w)`` pair or a dict with those keys."""
    idx, w = (st["idx"], st["w"]) if isinstance(st, dict) else st
    return stencil_from_padded(idx, w).to(device)


def partition_from_numpy(f: Dict[str, object], device) -> Partition:
    """``f``: the fields of a `Partition` by name; ``face_owner``,
    ``face_neighbor``, ``acc_left`` and ``acc_right`` are per-dim
    sequences."""
    return Partition(
        centers=_f32(f["centers"], device),
        spacing=_f32(f["spacing"], device),
        face_owner=tuple(_i64(a, device) for a in f["face_owner"]),
        face_neighbor=tuple(_i64(a, device) for a in f["face_neighbor"]),
        acc_left=tuple(stencil_from_numpy(s, device) for s in f["acc_left"]),
        acc_right=tuple(stencil_from_numpy(s, device)
                        for s in f["acc_right"]),
        own_mask=_f32(f["own_mask"], device),
        n_own=int(f["n_own"]), n_dom=int(f["n_dom"]), nd=int(f["nd"]),
    )


def boundary_from_numpy(f: Dict[str, object], device) -> Boundary:
    """``f``: the fields of a `Boundary` by name."""
    return Boundary(
        ghost=_i64(f["ghost"], device),
        interp=stencil_from_numpy(f["interp"], device),
        n_ghost=int(f["n_ghost"]),
        **{k: _f32(f[k], device) for k in (
            "projections", "normals", "image_distances", "ghost_distances",
            "eta", "valid")},
    )


def fused_boundary_from_numpy(f: Dict[str, object], device) -> FusedBoundary:
    """``f``: the fields of a `FusedBoundary` by name."""
    return FusedBoundary(
        ghost=_i64(f["ghost"], device),
        interp=stencil_from_numpy(f["interp"], device),
        normals=_f32(f["normals"], device),
        eta=_f32(f["eta"], device),
        family=_i64(f["family"], device),
        names=tuple(f["names"]),
    )
