"""Domain compiler, host side only: octree mesh -> cells, faces and the
global ghost-cell boundary tables.

Numpy copy of the host parts of `ibx/topology/domain.py` (cells and faces,
`_build_host_boundary` and the STL ghost-band logic of ``Domain.__init__``).
The partitions, postprocessing surfaces and device placement of the JAX
package are not ported: the port's device tables are built from these
arrays by `ibx_torch.topology.blocks` and `ibx_torch.topology.blocked_bc`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

from ..geometry.inside import points_inside
from ..geometry.octree import Mesh, get_cells
from .faces import hcube_faces, octree2faces_blocks
from .ghosts import ghosts_and_projections_hcube, ghosts_and_projections_stl
from .interp import interpolator

_EPS32 = float(np.finfo(np.float32).eps)


@dataclasses.dataclass
class HostBoundary:
    """Global boundary tables of one family."""

    ghosts: np.ndarray          # int64[G] global cell ids
    projections: np.ndarray     # f32[G, nd]
    normals: np.ndarray         # f32[G, nd]
    image_distances: np.ndarray
    ghost_distances: np.ndarray
    interp_idx: np.ndarray      # int64[G, k] global cell ids
    interp_w: np.ndarray        # f32[G, k]


def _build_host_boundary(
    centers: np.ndarray,
    widths: np.ndarray,
    tree: cKDTree,
    ghosts: np.ndarray,
    projs: np.ndarray,
    ghost_ratio: float,
    exclude_cells: Optional[np.ndarray] = None,
    reflect_solid: bool = False,
    axis_stencils: bool = False,
) -> HostBoundary:
    """Ghost geometry + image-point stencils
    (reference ``src/ImmersedBoundary.jl:422-448``); see the JAX package's
    `_build_host_boundary` for the reasons behind ``exclude_cells``,
    ``w_cap=1.5`` and the 2-point ``axis_stencils``."""
    gc = centers[ghosts]
    normals = gc - projs
    gd = np.sqrt((normals.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    # divide by max(gd, eps), NOT gd + eps: hypercube ghost normals must
    # come out as EXACT unit axis vectors
    normals = normals / np.maximum(gd, _EPS32)[:, None]
    diam = np.sqrt((widths[ghosts].astype(np.float64) ** 2).sum(1)).astype(np.float32)
    image_d = diam * ghost_ratio + _EPS32
    if reflect_solid and exclude_cells is not None:
        ins_g = exclude_cells[ghosts]
        normals = np.where(ins_g[:, None], -normals, normals)
    images = projs + normals * image_d[:, None]
    if axis_stencils and ghosts.size:
        # hypercube-family image stencils: the two straddling cells of the
        # ghost's own column (exact linear interpolation)
        d_axis = np.abs(normals).argmax(axis=1)
        _, knn = tree.query(images, k=2, workers=-1)
        c0 = centers[knn[:, 0]]
        c1 = centers[knn[:, 1]]
        h_g = widths[ghosts].max(axis=1)
        ar = np.arange(ghosts.size)
        lat_ok = np.ones(ghosts.size, bool)
        for dd in range(centers.shape[1]):
            ld = dd != d_axis
            lat_ok &= np.where(
                ld,
                (np.abs(c0[:, dd] - images[:, dd]) < 0.05 * h_g)
                & (np.abs(c1[:, dd] - images[:, dd]) < 0.05 * h_g),
                True,
            )
        a0 = c0[ar, d_axis]
        a1 = c1[ar, d_axis]
        sep_ok = np.abs(a1 - a0) > 0.5 * h_g
        t = (images[ar, d_axis] - a0) / np.where(sep_ok, a1 - a0, 1.0)
        ok = lat_ok & sep_ok & (t > -0.1) & (t < 1.1)
        idx2 = np.stack([knn[:, 0], knn[:, 1]], axis=1).astype(np.int64)
        w2 = np.stack([1.0 - t, t], axis=1).astype(np.float32)
        if ok.all():
            return HostBoundary(
                ghosts=ghosts.astype(np.int64),
                projections=projs.astype(np.float32),
                normals=normals.astype(np.float32),
                image_distances=image_d,
                ghost_distances=gd,
                interp_idx=idx2,
                interp_w=w2,
            )
        # mixed: kNN-fit the non-conforming ghosts, keep the axis pairs
        ki, kw = interpolator(centers, images[~ok], tree, linear=True,
                              w_cap=1.5)
        K = max(2, ki.shape[1])
        idx_f = np.zeros((ghosts.size, K), np.int64)
        w_f = np.zeros((ghosts.size, K), np.float32)
        idx_f[ok, :2] = idx2[ok]
        idx_f[ok, 2:] = idx2[ok, :1]
        w_f[ok, :2] = w2[ok]
        ki = ki.astype(np.int64)
        idx_f[~ok, :ki.shape[1]] = ki
        idx_f[~ok, ki.shape[1]:] = ki[:, :1]
        w_f[~ok, :ki.shape[1]] = kw
        return HostBoundary(
            ghosts=ghosts.astype(np.int64),
            projections=projs.astype(np.float32),
            normals=normals.astype(np.float32),
            image_distances=image_d,
            ghost_distances=gd,
            interp_idx=idx_f,
            interp_w=w_f,
        )
    if exclude_cells is not None and exclude_cells.any():
        src = np.nonzero(~exclude_cells)[0]
        idx, w = interpolator(centers[src], images, linear=True, w_cap=1.5)
        idx = src[idx.astype(np.int64)].astype(idx.dtype)
    else:
        idx, w = interpolator(centers, images, tree, linear=True, w_cap=1.5)
    return HostBoundary(
        ghosts=ghosts.astype(np.int64),
        projections=projs.astype(np.float32),
        normals=normals.astype(np.float32),
        image_distances=image_d,
        ghost_distances=gd,
        interp_idx=np.asarray(idx, dtype=np.int64),
        interp_w=np.asarray(w, dtype=np.float32),
    )


class Domain:
    """Host-side compiled domain: cells, faces and the global ghost
    boundaries of the named families (the single-partition subset of the
    JAX package's `Domain`)."""

    def __init__(
        self,
        msh: Mesh,
        *,
        ghost_layer_ratio: float = 1.5,
        hypercube_families: Sequence[Tuple[str, Sequence[Tuple[int, bool]]]] = (),
        verbose: bool = False,
    ):
        self.mesh = msh
        self.nd = msh.ndim
        self._verbose = bool(verbose)
        self._t0 = time.time()
        self._t_stage = self._t0
        self.build_timings: Dict[str, float] = {}
        centers, widths, _ = get_cells(msh)
        N = centers.shape[0]
        self.ncells = N
        self.centers = centers
        self.widths = widths
        self._stage("cells", f"{N} cells")

        origins = centers - widths / 2
        fdim, fo, fn = octree2faces_blocks(msh, origins, widths)
        hdim, ho, hn = hcube_faces(msh.origin, msh.widths, origins, widths)
        self.face_dim = np.concatenate([fdim, hdim])
        self.face_owner = np.concatenate([fo, ho])
        self.face_neighbor = np.concatenate([fn, hn])
        self._stage("faces", f"{self.face_dim.size} faces")

        tree = cKDTree(centers)
        self._host_boundaries: Dict[str, HostBoundary] = {}
        for bname, bfaces in hypercube_families:
            ghosts, projs = ghosts_and_projections_hcube(
                list(bfaces), msh.origin, msh.widths, centers, widths,
                ghost_layer_ratio=ghost_layer_ratio,
            )
            self._host_boundaries[bname] = _build_host_boundary(
                centers, widths, tree, ghosts, projs, ghost_layer_ratio,
                axis_stencils=True,
            )
            self._stage(f"boundary[{bname}]", f"{ghosts.size} ghosts")

        for bname, dfield in msh.distance_fields.items():
            ghosts, projs = ghosts_and_projections_stl(
                dfield, centers, widths, ghost_layer_ratio=ghost_layer_ratio
            )
            self._stage(f"ghosts[{bname}]", f"{ghosts.size} ghosts")
            # ban in-solid cells from image stencils (no BC feedback loop
            # through unsolved values at thin geometry)
            inside = None
            if dfield.stl.simplices.shape[0] and ghosts.size:
                inside = np.zeros(N, bool)
                inside[ghosts] = points_inside(dfield.stl, centers[ghosts])
            self._host_boundaries[bname] = _build_host_boundary(
                centers, widths, tree, ghosts, projs, ghost_layer_ratio,
                exclude_cells=inside,
            )
        self._stage(
            "boundaries",
            f"{sum(hb.ghosts.size for hb in self._host_boundaries.values())}"
            " ghosts",
        )
        if self._verbose:
            print(f"[ibx_torch.Domain] total {time.time() - self._t0:.2f}s")

    def _stage(self, name: str, note: str = "") -> None:
        """Record (and optionally print) a build-stage wall-clock."""
        now = time.time()
        self.build_timings[name] = now - self._t_stage
        if self._verbose:
            extra = f" ({note})" if note else ""
            print(f"[ibx_torch.Domain] {name}: "
                  f"{self.build_timings[name]:.2f}s{extra}", flush=True)
        self._t_stage = now
