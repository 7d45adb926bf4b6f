"""Surface refinement, feature detection, and simplex projection (host side).

Counterpart of reference ``src/mesher.jl:438-728``. The reference refines each
simplex by per-simplex recursion; here refinement is level-synchronous over
the whole simplex soup (all violating simplices split per sweep), which
vectorizes the distance-field queries that dominate cost.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .stereolitography import (
    Stereolitography,
    centers_and_normals,
    merge_points,
    simplex_coordinates,
)

_EPS32 = float(np.finfo(np.float32).eps)


def _local_target(h, phalf, L, refinement_regions, growth_ratio):
    """hloc = min(h, min_r max((df_r(mid) - L) * (gr - 1), href_r)).

    Reference ``src/mesher.jl:459-464``.
    """
    hloc = np.full(L.shape, h, dtype=np.float64)
    for df, href in refinement_regions:
        cand = np.maximum(
            (np.asarray(df(phalf), dtype=np.float64) - L) * (growth_ratio - 1.0),
            href,
        )
        hloc = np.minimum(hloc, cand)
    return hloc


def refine_to_length(
    stl: Stereolitography,
    h: float,
    *,
    tolerance: float = 1e-7,
    growth_ratio: float = 1.1,
    refinement_regions: Sequence[Tuple] = (),
    max_sweeps: int = 64,
) -> Stereolitography:
    """Split simplices by longest-violating-edge bisection until every edge
    meets its (possibly region-dependent) target length.

    Reference ``src/mesher.jl:438-528``. Each sweep splits every simplex whose
    worst edge violates its target; the two children replace it. Points are
    deduplicated at the end via :func:`merge_points`.
    """
    coords = simplex_coordinates(stl).astype(np.float64)  # [M, k, nd]
    k = coords.shape[1]

    done = []
    for _ in range(max_sweeps):
        if coords.shape[0] == 0:
            break
        M = coords.shape[0]
        nxt = np.roll(np.arange(k), -1)
        p1 = coords                       # [M, k, nd]
        p2 = coords[:, nxt]               # [M, k, nd]
        mid = 0.5 * (p1 + p2)
        L = np.sqrt(((p2 - p1) ** 2).sum(-1))  # [M, k]
        hloc = _local_target(
            h, mid.reshape(-1, coords.shape[2]), L.reshape(-1),
            refinement_regions, growth_ratio,
        ).reshape(M, k)
        violation = L - hloc
        worst = violation.argmax(axis=1)
        worst_v = violation[np.arange(M), worst]
        split = worst_v > 0.0

        done.append(coords[~split])
        coords = coords[split]
        if coords.shape[0] == 0:
            break
        e = worst[split]
        j = nxt[e]
        m = 0.5 * (
            coords[np.arange(coords.shape[0]), e]
            + coords[np.arange(coords.shape[0]), j]
        )
        a = coords.copy()
        a[np.arange(a.shape[0]), j] = m       # child A: p_next -> mid
        b = coords.copy()
        b[np.arange(b.shape[0]), e] = m       # child B: p_i -> mid
        coords = np.concatenate([a, b], axis=0)

    done.append(coords)
    allc = np.concatenate(done, axis=0)
    M = allc.shape[0]
    points = allc.reshape(M * k, -1).astype(np.float32)
    simplices = np.arange(M * k, dtype=np.int64).reshape(M, k)
    return merge_points(
        Stereolitography(points, simplices), tolerance=tolerance
    )


def feature_regions(
    stl: Stereolitography,
    *,
    angle: float = 15.0,
    radius: float = np.inf,
    include_boundaries: bool = False,
) -> Stereolitography:
    """Sub-surface of simplices at sharp dihedral edges / tight curvature.

    Reference ``src/mesher.jl:670-728``: pair simplices sharing a face (the
    (k-1)-subsimplex obtained by dropping one vertex), compute the angle
    between their normals and the center distance, and keep simplices where
    ``θ > angle`` (degrees) or ``d / θ < radius`` (curvature proxy); unpaired
    border simplices are kept when ``include_boundaries``.
    """
    simp = stl.simplices
    M, k = simp.shape
    # enumerate faces: for each pivot vertex, the remaining k-1 sorted indices
    faces = []
    owners = []
    for pivot in range(k):
        sub = np.delete(simp, pivot, axis=1)
        faces.append(np.sort(sub, axis=1))
        owners.append(np.arange(M))
    faces = np.concatenate(faces, 0)
    owners = np.concatenate(owners, 0)

    order = np.lexsort(faces.T[::-1])
    faces_s = faces[order]
    owners_s = owners[order]
    same = np.all(faces_s[1:] == faces_s[:-1], axis=1)
    i_edges = owners_s[:-1][same]
    j_edges = owners_s[1:][same]
    # border faces pair a simplex with itself
    paired = np.zeros(faces_s.shape[0], dtype=bool)
    paired[:-1][same] = True
    paired[1:][same] = True
    border = owners_s[~paired]
    i_all = np.concatenate([i_edges, border])
    j_all = np.concatenate([j_edges, border])

    centers, normals = centers_and_normals(stl)
    nrm = normals / (
        np.sqrt((normals ** 2).sum(1, keepdims=True)) + _EPS32
    )
    angle_rad = np.deg2rad(max(angle, 1.0))
    max_cos = np.cos(np.deg2rad(0.05))
    cosang = np.minimum((nrm[i_all] * nrm[j_all]).sum(1), max_cos)
    theta = np.arccos(np.clip(cosang, -1.0, 1.0))
    d = np.sqrt(((centers[i_all] - centers[j_all]) ** 2).sum(1))

    keep_edge = (d / theta < radius) | (theta > angle_rad)
    if include_boundaries:
        keep_edge |= i_all == j_all

    included = np.zeros(M, dtype=bool)
    included[i_all[keep_edge]] = True
    included[j_all[keep_edge]] = True
    return Stereolitography(stl.points, stl.simplices[included])


def project_on_segments(seg: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Project each point onto its segment (batched).

    seg: [Q, 2, nd]; pts: [Q, nd] -> [Q, nd]. Matches the k=2 branch of
    ``proj2simplex`` (reference ``src/mesher.jl:549-567``).
    """
    p0 = seg[:, 0]
    u = seg[:, 1] - p0
    uu = (u * u).sum(1)
    # guard the zero-length case by masking, NOT by adding an epsilon to
    # the denominator: uu ~ L^2 is 3.5e-8 for the 1.9e-4-long segments of a
    # wall_h=5e-4 airfoil polyline, so `uu + eps32` dragged every interior
    # foot point ~4x toward p0 — vertex-snapped projections and +-25 deg
    # ghost-normal noise that grew under wall refinement (the round-3
    # "fine-mesh accuracy floor" was mostly this bug)
    xi = ((pts - p0) * u).sum(1) / np.where(uu > 0.0, uu, 1.0)
    xi = np.clip(np.where(uu > 0.0, xi, 0.0), 0.0, 1.0)
    return p0 + u * xi[:, None]


def project_on_triangles(tri: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Project each point onto its 3D triangle (batched).

    tri: [Q, 3, nd]; pts: [Q, nd] -> [Q, nd]. Replaces the recursive
    pinv-based ``proj2simplex`` (reference ``src/mesher.jl:544-596``) with the
    standard closed-form barycentric clamp: interior projection when the
    barycentric coordinates admit it, otherwise the nearest of the three edge
    projections.
    """
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0
    w = pts - p0
    a = (e1 * e1).sum(1)
    b = (e1 * e2).sum(1)
    c = (e2 * e2).sum(1)
    d1 = (w * e1).sum(1)
    d2 = (w * e2).sum(1)
    # degeneracy must be judged RELATIVE to the triangle scale: det ~ L^4
    # is ~1e-14 for 3e-4-sized triangles, so `det + eps32` obliterated the
    # true determinant on fine meshes (projections collapsed to the p0
    # corner). Degenerate (sliver) triangles fall through to the edge path.
    det = a * c - b * b
    good = det > 1e-12 * a * c
    det_safe = np.where(good, det, 1.0)
    s = (c * d1 - b * d2) / det_safe
    t = (a * d2 - b * d1) / det_safe
    interior = good & (s >= -_EPS32) & (t >= -_EPS32) & (s + t <= 1.0 + _EPS32)
    proj_in = p0 + e1 * s[:, None] + e2 * t[:, None]

    # edge candidates
    best = np.full(pts.shape[0], np.inf)
    proj = np.empty_like(pts)
    for ea, eb in ((p0, p1), (p1, p2), (p2, p0)):
        seg = np.stack([ea, eb], axis=1)
        cand = project_on_segments(seg, pts)
        dist = ((cand - pts) ** 2).sum(1)
        better = dist < best
        best = np.where(better, dist, best)
        proj[better] = cand[better]

    proj[interior] = proj_in[interior]
    return proj


def _project_on_ksimplices(simp: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Batched projection onto (k-1)-simplices for arbitrary k >= 4.

    The reference's recursive ``proj2simplex`` (``src/mesher.jl:544-596``:
    pinv projection onto the affine hull, recursing into the k facets when
    the barycentric solution leaves the simplex), re-derived with the
    scale-free degeneracy guards of the k <= 3 closed forms (a fixed
    epsilon on a Gram determinant ~ L^(2(k-1)) collapses at small simplex
    scale — the round-3 projection-bug class).
    """
    Q, k, nd = simp.shape
    p0 = simp[:, 0]
    E = simp[:, 1:] - p0[:, None]                  # [Q, k-1, nd]
    G = E @ np.transpose(E, (0, 2, 1))             # [Q, k-1, k-1] Gram
    rhs = (E @ (pts - p0)[:, :, None])[..., 0]     # [Q, k-1]
    det = np.linalg.det(G)
    scale = np.prod(np.einsum("qij,qij->qi", E, E), axis=1)  # prod |e_i|^2
    good = det > 1e-12 * np.maximum(scale, 0.0)
    G_safe = np.where(good[:, None, None], G,
                      np.eye(k - 1, dtype=G.dtype)[None])
    lam = np.linalg.solve(G_safe, rhs[..., None])[..., 0]    # [Q, k-1]
    interior = good & (lam >= -_EPS32).all(axis=1) \
        & (lam.sum(axis=1) <= 1.0 + _EPS32)
    proj_in = p0 + np.einsum("qi,qid->qd", lam, E)

    # facet recursion: drop one vertex at a time, keep the nearest foot
    best = np.full(Q, np.inf)
    proj = np.empty_like(pts)
    for drop in range(k):
        face = np.concatenate([simp[:, :drop], simp[:, drop + 1:]], axis=1)
        cand = project_on_simplices(face, pts)
        dist = ((cand - pts) ** 2).sum(1)
        better = dist < best
        best = np.where(better, dist, best)
        proj[better] = cand[better]

    proj[interior] = proj_in[interior]
    return proj


def project_on_simplices(simplex_coords: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Dispatch batched projection by simplex arity (closed forms for
    k <= 3, the recursive facet walk beyond — full parity with the
    reference's arbitrary-arity ``proj2simplex``)."""
    kk = simplex_coords.shape[1]
    if kk == 1:
        return simplex_coords[:, 0]
    if kk == 2:
        return project_on_segments(simplex_coords, pts)
    if kk == 3:
        return project_on_triangles(simplex_coords, pts)
    return _project_on_ksimplices(simplex_coords, pts)
