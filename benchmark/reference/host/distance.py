"""Distance functions and approximate surface distance fields (host side).

Counterpart of reference ``src/mesher.jl:27-122`` (analytic refinement-region
primitives) and ``src/mesher.jl:736-801`` (KDTree distance field + exact
projection among candidates). All callables take float[Q, nd] point batches
and return float[Q] distances — the interface consumed by surface refinement
and octree generation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

from .refine import project_on_simplices, refine_to_length
from .stereolitography import (
    Stereolitography,
    centers_and_normals,
    simplex_coordinates,
)


@dataclasses.dataclass
class Box:
    """Exterior distance to an axis-aligned box (reference ``src/mesher.jl:27-46``)."""

    origin: np.ndarray
    widths: np.ndarray

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        o = np.asarray(self.origin, dtype=np.float64)
        w = np.asarray(self.widths, dtype=np.float64)
        d = np.maximum(np.maximum(o - pts, pts - (o + w)), 0.0)
        return np.sqrt((d ** 2).sum(axis=1))


@dataclasses.dataclass
class Ball:
    """Exterior distance to a ball (reference ``src/mesher.jl:58-76``)."""

    center: np.ndarray
    radius: float

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        c = np.asarray(self.center, dtype=np.float64)
        return np.maximum(
            0.0, np.sqrt(((pts - c) ** 2).sum(axis=1)) - self.radius
        )


@dataclasses.dataclass
class Line:
    """Distance to a segment (reference ``src/mesher.jl:94-122``)."""

    p1: np.ndarray
    p2: np.ndarray

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        p1 = np.asarray(self.p1, dtype=np.float64)
        p2 = np.asarray(self.p2, dtype=np.float64)
        m = p2 - p1
        xi = ((pts - p1) @ m) / (m @ m)
        xi = np.clip(xi, 0.0, 1.0)
        proj = p1 + xi[:, None] * m
        return np.sqrt(((pts - proj) ** 2).sum(axis=1))


def _farthest_points(pts: np.ndarray, k: int) -> np.ndarray:
    """Greedy farthest-point subsample (near-optimal cover radius).

    Point ORDER in the cloud may be spatially clustered (surface refinement
    recursion), so strided subsampling gives terrible covers; FPS costs
    O(M k) vectorized flops and keeps the two-tier distance split tight.
    """
    pts = pts.astype(np.float32)
    M = pts.shape[0]
    k = min(k, M)
    chosen = np.empty((k,) + pts.shape[1:], np.float32)
    chosen[0] = pts[0]
    d = ((pts - chosen[0]) ** 2).sum(axis=1)
    for i in range(1, k):
        j = int(d.argmax())
        chosen[i] = pts[j]
        d = np.minimum(d, ((pts - chosen[i]) ** 2).sum(axis=1))
    return chosen


class DistanceField:
    """Approximate unsigned distance to a surface via a KDTree over simplex
    centers, with exact projection among in-range candidates.

    Reference ``src/mesher.jl:736-801``: ``__call__`` returns the
    nearest-simplex-center distance (approximate); :meth:`projection` refines
    by exact point-to-simplex projection over all candidates within radius R.
    """

    def __init__(self, stl: Stereolitography, *, h: float = 0.0,
                 leaf_size: int = 25):
        if h > 0.0:
            stl = refine_to_length(stl, h)
        self.stl = stl
        self.centers, _ = centers_and_normals(stl)
        self.tree = cKDTree(self.centers, leafsize=leaf_size)
        self._coords = simplex_coordinates(stl)
        # max center-to-vertex distance: bounds how far a simplex's center
        # can be from its nearest point (used to tighten candidate radii)
        self.simplex_radius = float(np.sqrt(
            ((self._coords - self.centers[:, None, :]) ** 2)
            .sum(axis=2).max()
        )) if self._coords.size else 0.0
        # two-tier acceleration: k=1 queries from FAR points against a
        # compact surface manifold are pathological for kd-trees (thousands
        # of near-equidistant centers defeat pruning; measured ~270 us/query
        # at 170k centers — and the pathology survives subsampled TREES
        # too). Far points instead use a brute-force minimum over a few
        # hundred subsampled centers (pure vectorized numpy, ~ns/point);
        # near points get the exact full-tree value. Far values overestimate
        # the center distance by at most ``query_error``.
        M = self.centers.shape[0]
        if M > 4096:
            # one FPS run; its prefixes are themselves FPS subsamples
            chosen = _farthest_points(self.centers, 2048)
            self._sub = chosen[:384]
            self._sub2 = chosen
            self.query_error = float(
                self._brute_min(self.centers, self._sub).max())
            self._r2 = float(
                self._brute_min(self.centers, self._sub2).max())
        else:
            self._sub = None
            self.query_error = 0.0
            self._r2 = 0.0

    @staticmethod
    def _brute_min(pts: np.ndarray, sub: np.ndarray,
                   chunk: int = 0) -> np.ndarray:
        out = np.empty(pts.shape[0], np.float32)
        subT = np.ascontiguousarray(sub.T.astype(np.float32))
        s2 = (sub.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
        # block so the [chunk, k] distance matrix stays cache-resident:
        # the K=2/3 "matmul" is pure bandwidth, and a 65536-row chunk
        # (100-500 MB of temporaries) ran at ~140 MFLOP/s on this box —
        # 80+ s per flagship-build call; cache-blocked it is ~100x faster
        if chunk <= 0:
            chunk = max(512, (1 << 21) // max(1, sub.shape[0]))
        for i in range(0, pts.shape[0], chunk):
            q = pts[i:i + chunk]
            d2 = (q ** 2).sum(axis=1)[:, None] - 2.0 * (q @ subT)
            d2 += s2[None, :]
            out[i:i + chunk] = np.sqrt(np.maximum(d2.min(axis=1), 0.0))
        return out

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        """Nearest-simplex-center distance; values beyond the exact tier may
        overestimate by at most ``query_error`` (three-tier acceleration —
        kd-tree k=1 queries against a surface manifold are only fast when
        the query point is CLOSE)."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float32))
        if self._sub is None:
            d, _ = self.tree.query(pts, k=1, workers=-1)
            return d
        d = self._brute_min(pts, self._sub)
        mid = d - self.query_error <= 8.0 * self.query_error
        if mid.any():
            d_mid = self._brute_min(pts[mid], self._sub2)
            d[mid] = d_mid
            near = np.zeros(pts.shape[0], bool)
            near[mid] = d_mid - self._r2 <= 4.0 * self._r2
            if near.any():
                d_near, _ = self.tree.query(pts[near], k=1, workers=-1)
                d[near] = d_near
        return d

    def projection(self, pts: np.ndarray, R: Optional[np.ndarray] = None,
                   d_init: Optional[np.ndarray] = None):
        """Exact projection of each point onto the surface.

        R: per-point candidate search radius (0 / None disables the exact
        pass, returning the nearest simplex center — matching the reference's
        behavior for ``R <= d``). ``d_init``: optional UPPER bound on the
        nearest-center distance (e.g. from the tiered ``__call__`` plus its
        error) — skips the full-tree k=1 query, which is pathologically slow
        for points far from the surface; callers using it must not rely on
        the fallback value for points whose ball search stays empty.
        Returns (projections [Q, nd], distances [Q]).
        """
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float32))
        if d_init is None:
            d, nearest = self.tree.query(pts, k=1, workers=-1)
            proj = self.centers[nearest].copy()
            dist = d.astype(np.float64)
        else:
            # NaN marks "no projection computed": rows whose ball search
            # stays empty keep it, so misuse fails loudly instead of
            # returning plausible-looking garbage coordinates
            proj = np.full((pts.shape[0], pts.shape[1]), np.nan, np.float32)
            dist = np.asarray(d_init, np.float64).copy()

        if R is None:
            return proj, dist.astype(np.float32)
        R = np.broadcast_to(np.asarray(R, dtype=np.float64), (pts.shape[0],))
        # with a (possibly loose) d_init upper bound, every point must get a
        # ball search — R > dist could wrongly skip true in-band points
        active = np.ones(pts.shape[0], bool) if d_init is not None \
            else R > dist
        if not np.any(active):
            return proj, dist.astype(np.float32)

        act_idx = np.nonzero(active)[0]
        cand_lists = self.tree.query_ball_point(
            pts[act_idx], R[act_idx], workers=-1
        )
        counts = np.fromiter((len(c) for c in cand_lists), dtype=np.int64,
                             count=len(cand_lists))
        if counts.sum() == 0:
            return proj, dist.astype(np.float32)
        flat_pt = np.repeat(act_idx, counts)
        flat_simp = np.concatenate(
            [np.asarray(c, dtype=np.int64) for c in cand_lists if len(c)]
        )
        # cache-blocked exact projection: the unblocked form materializes
        # [Q, k, nd] f64 gathers plus ~15 [Q, nd] temporaries inside
        # project_on_triangles (Q = tens of millions of (point, simplex)
        # candidate pairs on 3D meshes — measured 118 s of the 5.3M-cell
        # sphere build); 256k-row chunks keep every temporary
        # cache-resident. cand_d stays f64 (the min/tie selection below
        # compares against the f64 dist bound); the selected projections
        # are returned as f32 regardless.
        Q = flat_pt.shape[0]
        cand_proj = np.empty((Q, pts.shape[1]), np.float32)
        cand_d = np.empty(Q, np.float64)
        CH = 1 << 18
        for i in range(0, Q, CH):
            sl = slice(i, min(i + CH, Q))
            p_sl = pts[flat_pt[sl]].astype(np.float64)
            cp = project_on_simplices(
                self._coords[flat_simp[sl]].astype(np.float64), p_sl
            )
            cand_proj[sl] = cp
            cand_d[sl] = np.sqrt(((cp - p_sl) ** 2).sum(axis=1))

        # segment-min over candidates of the same point
        better_d = dist.copy()
        np.minimum.at(better_d, flat_pt, cand_d)
        take = cand_d <= better_d[flat_pt] + 0.0
        # among ties keep the first by overwriting in reverse order
        proj_out = proj.astype(np.float64)
        order = np.argsort(cand_d, kind="stable")[::-1]
        sel = order[take[order]]
        proj_out[flat_pt[sel]] = cand_proj[sel]
        return proj_out.astype(np.float32), better_d.astype(np.float32)


def refine_orderly(
    surfaces: Sequence[Tuple[Stereolitography, float]],
    *,
    refinement_regions: Sequence[Tuple] = (),
    ratio: float = 0.5,
    growth_ratio: float = 2.0,
    tolerance: float = 1e-7,
):
    """Refine surfaces finest-first; each refined surface becomes a
    refinement region for the next (reference ``src/mesher.jl:878-918``).

    surfaces: sequence of (stl, h). Returns DistanceFields in input order.
    """
    order = np.argsort([h for _, h in surfaces], kind="stable")
    regions = [(df, href * ratio) for df, href in refinement_regions]
    result = {}
    for i in order:
        stl, h = surfaces[i]
        h = h * ratio
        refined = refine_to_length(
            stl, h,
            tolerance=tolerance,
            refinement_regions=regions,
            growth_ratio=growth_ratio,
        )
        dfield = DistanceField(refined)
        result[int(i)] = dfield
        regions.append((dfield, h))
    return [result[int(i)] for i in range(len(surfaces))]
