"""Block-structured octree/quadtree mesh generation (host side).

Counterpart of reference ``src/mesher.jl:811-1112``. The reference refines
per-node recursively; here refinement is level-synchronous — every sweep
evaluates all active blocks' criteria as one vectorized batch (the
DistanceField KDTree query is the hot loop) and splits them at once. Leaves
("blocks") each hold a ``block_size^nd`` Cartesian cell grid; cell ordering is
block-major with axis-0-fastest within the block, matching the reference's
``get_cells`` ordering (``src/mesher.jl:1064-1112``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .distance import DistanceField, refine_orderly
from .stereolitography import Stereolitography


def refine_octree(
    refinement_criteria: Sequence[Tuple],
    origin: np.ndarray,
    widths: np.ndarray,
    growth_ratio: float = 1.1,
    max_sweeps: int = 64,
):
    """Split the hypercube until every (distance_fn, h) criterion is met.

    A block with max width L and circumradius R stays active for criterion
    (df, h) while ``max((growth_ratio - 1) * (df(center) - R), h) < L``
    (reference ``src/mesher.jl:811-862``). Splits seek isotropy: each axis is
    divided into ``round(w / w_min) + 1`` pieces.

    Returns (block_origins [B, nd], block_widths [B, nd]).
    """
    origin = np.asarray(origin, dtype=np.float64)
    widths = np.asarray(widths, dtype=np.float64)
    nd = origin.size

    active_o = origin[None, :]
    active_w = widths[None, :]
    done_o, done_w = [], []

    for _ in range(max_sweeps):
        if active_o.shape[0] == 0:
            break
        centers = active_o + active_w / 2
        L = active_w.max(axis=1)
        R = np.sqrt((active_w ** 2).sum(axis=1)) / 2

        needs_split = np.zeros(active_o.shape[0], dtype=bool)
        for df, h in refinement_criteria:
            dist = np.asarray(df(centers), dtype=np.float64)
            lmax = np.maximum((growth_ratio - 1.0) * (dist - R), h)
            needs_split |= lmax < L

        done_o.append(active_o[~needs_split])
        done_w.append(active_w[~needs_split])
        active_o = active_o[needs_split]
        active_w = active_w[needs_split]
        if active_o.shape[0] == 0:
            break

        wmin = active_w.min(axis=1)
        nsplit = np.round(active_w / wmin[:, None]).astype(np.int64) + 1

        new_o, new_w = [], []
        # group by split signature so each group expands as one vectorized op
        sigs = {tuple(row) for row in nsplit}
        for sig in sigs:
            mask = np.all(nsplit == np.asarray(sig), axis=1)
            o = active_o[mask]
            w = active_w[mask]
            cw = w / np.asarray(sig, dtype=np.float64)
            # child offsets: product of ranges, axis-0 fastest (parity with
            # Julia Iterators.product collection order)
            grids = np.meshgrid(
                *[np.arange(s) for s in sig], indexing="ij"
            )
            offs = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
            child_o = (
                o[:, None, :] + offs[None, :, :] * cw[:, None, :]
            ).reshape(-1, nd)
            child_w = np.repeat(cw, offs.shape[0], axis=0)
            new_o.append(child_o)
            new_w.append(child_w)
        active_o = np.concatenate(new_o, axis=0)
        active_w = np.concatenate(new_w, axis=0)

    done_o.append(active_o)
    done_w.append(active_w)
    return (
        np.concatenate(done_o, axis=0).astype(np.float32),
        np.concatenate(done_w, axis=0).astype(np.float32),
    )


@dataclasses.dataclass
class Mesh:
    """Block-octree mesh (reference ``src/mesher.jl:926-933``).

    block_origins/block_widths: float32[n_blocks, nd]; each block holds
    ``block_size^nd`` equal Cartesian cells.
    """

    origin: np.ndarray
    widths: np.ndarray
    block_size: int
    block_origins: np.ndarray
    block_widths: np.ndarray
    distance_fields: Dict[str, DistanceField]

    @property
    def ndim(self) -> int:
        return self.block_origins.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.block_origins.shape[0]

    def __len__(self) -> int:
        return self.block_size ** self.ndim * self.n_blocks

    def coarsen(self, block_size: int) -> "Mesh":
        """Same block tree, fewer cells per block (multigrid levels;
        reference ``src/ImmersedBoundary.jl:1366-1368``)."""
        return Mesh(
            self.origin, self.widths, block_size,
            self.block_origins, self.block_widths, self.distance_fields,
        )


def build_mesh(
    origin,
    widths,
    *surfaces,
    growth_ratio: float = 2.0,
    tolerance: float = 1e-7,
    block_size: int = 8,
    refinement_regions: Sequence[Tuple] = (),
    verbose: bool = False,
) -> Mesh:
    """Generate a mesh from surfaces (reference ``src/mesher.jl:972-1046``).

    ``surfaces``: tuples ``(name, Stereolitography, h)``. Surfaces are
    orderly refined (finest first) into distance fields; octree criteria are
    the refinement regions plus each surface's distance field, with cell
    sizes scaled by ``block_size`` (cells -> blocks).
    """
    origin = np.asarray(origin, dtype=np.float32)
    widths = np.asarray(widths, dtype=np.float32)

    hs = {name: h for name, _, h in surfaces}
    dfields_list = refine_orderly(
        [(stl, h) for _, stl, h in surfaces],
        refinement_regions=refinement_regions,
        growth_ratio=growth_ratio,
        tolerance=tolerance,
    )
    dfields = {name: df for (name, _, _), df in zip(surfaces, dfields_list)}

    criteria = [(df, h * block_size) for df, h in refinement_regions]
    for name, df in dfields.items():
        criteria.append((df, hs[name] * block_size))

    block_origins, block_widths = refine_octree(
        criteria, origin, widths, growth_ratio
    )
    return Mesh(origin, widths, int(block_size),
                block_origins, block_widths, dfields)


def _cell_offsets(block_size: int, nd: int, margin: int = 0) -> np.ndarray:
    """Per-block normalized cell-center coordinates, axis-0 fastest.

    Matches Julia's product order in ``_range_prod``
    (reference ``src/mesher.jl:1048-1088``).
    """
    coords = (np.arange(block_size + 2 * margin, dtype=np.float64)
              + 0.5 - margin) / block_size
    grids = np.meshgrid(*([coords] * nd), indexing="ij")
    return np.stack([g.reshape(-1, order="F") for g in grids], axis=1)


def get_cells(msh: Mesh, block_range: Optional[np.ndarray] = None,
              margin: int = 0):
    """Expand blocks into per-cell centers/widths (+ margin mask).

    Reference ``src/mesher.jl:1064-1112``. Defines the global cell ordering:
    block-major; within a block, axis-0-fastest product order.
    Returns (centers [N, nd], widths [N, nd], is_margin [N]).
    """
    bo = msh.block_origins
    bw = msh.block_widths
    if block_range is not None:
        bo = bo[block_range]
        bw = bw[block_range]
    nd = bo.shape[1]
    offs = _cell_offsets(msh.block_size, nd, margin)        # [npb, nd]
    centers = (bo[:, None, :] + offs[None, :, :] * bw[:, None, :]).reshape(-1, nd)
    widths = np.repeat(bw / msh.block_size, offs.shape[0], axis=0)

    npb = offs.shape[0]
    side = msh.block_size + 2 * margin
    idx = np.arange(side, dtype=np.int64) + 1 - margin
    grids = np.meshgrid(*([idx] * nd), indexing="ij")
    ig = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
    is_margin_block = ~np.all((ig >= 1) & (ig <= msh.block_size), axis=1)
    is_margin = np.tile(is_margin_block, bo.shape[0])

    return centers.astype(np.float32), widths.astype(np.float32), is_margin
