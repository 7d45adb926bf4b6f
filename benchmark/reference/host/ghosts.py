"""Ghost-cell detection and surface projection (host side).

Counterpart of reference ``src/ImmersedBoundary.jl:194-326``. Ghost cells are
cells within ``ghost_layer_ratio`` circumdiameters of a boundary (the band
straddles the wall — the distance field is unsigned); each gets an exact
projection onto the boundary.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .distance import DistanceField


def ghosts_and_projections_stl(
    dfield: DistanceField,
    centers: np.ndarray,
    widths: np.ndarray,
    *,
    ghost_layer_ratio: float = 1.5,
):
    """Ghosts near an STL surface (reference ``src/ImmersedBoundary.jl:194-230``).

    KDTree prescreen at 2x the band width, exact projection among candidates,
    final mask at ``dist <= circumdiameter * ghost_layer_ratio``.
    Returns (ghost_indices int64[G], projections float32[G, nd]).
    """
    diams = np.sqrt((widths.astype(np.float64) ** 2).sum(1))
    band = diams * ghost_layer_ratio
    r_s = getattr(dfield, "simplex_radius", 0.0)
    approx = dfield(centers)
    # exact superset: a ghost needs d_true <= band; the center-distance
    # approximation overestimates d_true by at most the simplex radius plus
    # (far tier only) the coarse cover radius (DistanceField.query_error)
    q_err = getattr(dfield, "query_error", 0.0)
    cand = np.nonzero(approx - q_err <= band + r_s)[0]
    if cand.size == 0:
        return cand.astype(np.int64), np.zeros((0, centers.shape[1]), np.float32)
    # candidate radius: the true nearest simplex's center lies within
    # d_true + r_s; capping at band + 2 r_s keeps the result exact for every
    # cell that can pass the band test while keeping ball queries (and
    # memory) bounded on fine 3D meshes
    R = np.minimum(np.maximum(approx[cand], 0.0), band[cand]) \
        + 2.0 * r_s + 1e-12
    # upper bound on the nearest-center distance skips projection's
    # full-tree k=1 (slow for far points); empty-ball fallbacks only occur
    # beyond the band and are masked out below
    d_init = np.maximum(approx[cand], 0.0) + q_err + 1e-6
    projs = np.empty((cand.size, centers.shape[1]), np.float32)
    dists = np.empty(cand.size, np.float32)
    CH = 262144
    for i in range(0, cand.size, CH):
        sl = slice(i, min(i + CH, cand.size))
        projs[sl], dists[sl] = dfield.projection(
            centers[cand[sl]], R=R[sl], d_init=d_init[sl]
        )
    mask = dists <= diams[cand] * ghost_layer_ratio
    # rows whose ball search stayed empty come back with NaN projections;
    # when such a row is still inside the band (the tiered distance
    # over-estimated the candidate radius bound) it IS a ghost and needs a
    # real projection — re-run those few rows with a fresh radius bound.
    # (Before round 3 these silently kept centers[0] as their projection.)
    bad = np.isnan(projs[:, 0]) & mask
    if bad.any():
        idx = np.nonzero(bad)[0]
        projs[idx], dists[idx] = dfield.projection(
            centers[cand[idx]],
            R=dists[idx].astype(np.float64) + 2.0 * r_s + 1e-6,
        )
        mask = dists <= diams[cand] * ghost_layer_ratio
        assert not (np.isnan(projs[:, 0]) & mask).any()
    return cand[mask].astype(np.int64), projs[mask]


def ghosts_and_projections_hcube(
    faces: List[Tuple[int, bool]],
    hcube_origin: np.ndarray,
    hcube_widths: np.ndarray,
    centers: np.ndarray,
    widths: np.ndarray,
    *,
    ghost_layer_ratio: float = 1.5,
):
    """Ghosts near outer hypercube planes (reference
    ``src/ImmersedBoundary.jl:258-305``).

    ``faces``: list of (dim, front) plane selectors. Projection per cell is
    the nearest selected plane point; a cell is a ghost if within the band of
    ANY selected plane.
    """
    hcube_origin = np.asarray(hcube_origin, dtype=np.float64)
    hcube_widths = np.asarray(hcube_widths, dtype=np.float64)
    centers = np.asarray(centers, dtype=np.float64)
    diams = np.sqrt((widths.astype(np.float64) ** 2).sum(1))

    N = centers.shape[0]
    best_d = np.full(N, np.inf)
    projs = np.zeros_like(centers)
    mask = np.zeros(N, dtype=bool)
    for dim, front in faces:
        plane = (
            hcube_origin[dim] + hcube_widths[dim] if front else hcube_origin[dim]
        )
        p = centers.copy()
        p[:, dim] = plane
        d = np.abs(centers[:, dim] - plane)
        better = d < best_d
        best_d = np.where(better, d, best_d)
        projs[better] = p[better]
        mask |= d < diams * ghost_layer_ratio

    ghosts = np.nonzero(mask)[0].astype(np.int64)
    return ghosts, projs[ghosts].astype(np.float32)
