"""Triangulated surface container and the helpers the sphere case needs.

Verbatim numpy copy of the parts of `ibx/geometry/stereolitography.py`
that the 3D sphere build uses (surface concatenation, tolerance-based
point merging, simplex centers and normals); the STL/Selig readers and
polyline constructors are not ported. Convention change vs the
Julia reference: arrays are row-major — ``points`` is [n_points, nd] and
``simplices`` is [n_simplices, k] with 0-based indices.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Stereolitography:
    """Surface soup: vertex coordinates + simplex vertex indices.

    points: float32[n_points, nd]; simplices: int64[n_simplices, k]
    (k = 2 for 2D polylines, 3 for triangles).
    """

    points: np.ndarray
    simplices: np.ndarray

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float32)
        self.simplices = np.asarray(self.simplices, dtype=np.int64)

    @property
    def ndim(self) -> int:
        return self.points.shape[1]


def concatenate(*stls: Stereolitography) -> Stereolitography:
    """Concatenate surfaces, offsetting indices (reference ``src/mesher.jl:415-431``)."""
    pts = []
    simps = []
    offset = 0
    for s in stls:
        pts.append(s.points)
        simps.append(s.simplices + offset)
        offset += s.points.shape[0]
    return Stereolitography(np.concatenate(pts, 0), np.concatenate(simps, 0))


def merge_points(
    *stls: Stereolitography,
    tolerance: float = 1e-7,
    clean_degenerate: bool = True,
) -> Stereolitography:
    """Merge duplicate vertices by tolerance hashing; drop degenerate simplices.

    Reference ``src/mesher.jl:351-407``: quantize coordinates to ``tolerance``,
    unify points with identical tags (keeping first occurrence in input order),
    remap simplices, and optionally remove simplices with repeated vertices.
    """
    full = concatenate(*stls)
    tags = np.round(full.points.astype(np.float64) / tolerance).astype(np.int64)
    _, first_idx, inverse = np.unique(
        tags, axis=0, return_index=True, return_inverse=True
    )
    # renumber unique points by order of first appearance (matches reference)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    new_points = full.points[np.sort(first_idx)]
    new_simplices = rank[inverse][full.simplices]
    if clean_degenerate:
        k = new_simplices.shape[1]
        ok = np.ones(new_simplices.shape[0], dtype=bool)
        for i in range(k):
            for j in range(i + 1, k):
                ok &= new_simplices[:, i] != new_simplices[:, j]
        new_simplices = new_simplices[ok]
    return Stereolitography(new_points, new_simplices)


def simplex_coordinates(stl: Stereolitography) -> np.ndarray:
    """Gather simplex vertex coordinates: float32[n_simplices, k, nd]."""
    return stl.points[stl.simplices]


def centers_and_normals(stl: Stereolitography):
    """Simplex centers and (area-scaled) normals.

    Reference ``src/mesher.jl:601-660``. 2D: normal of segment v = p1-p0 is
    (v_y, -v_x), magnitude = length. 3D: cross(p1-p0, p2-p0); note the
    reference leaves the cross product un-halved, so its magnitude is twice
    the triangle area — replicated verbatim for output parity (the factor is
    consistent between `areas` and integral weights used downstream).
    """
    coords = simplex_coordinates(stl)  # [M, k, nd]
    centers = coords.mean(axis=1)
    nd = coords.shape[2]
    if nd == 2:
        v = coords[:, 1] - coords[:, 0]
        normals = np.stack([v[:, 1], -v[:, 0]], axis=1)
    else:
        a = coords[:, 1] - coords[:, 0]
        b = coords[:, 2] - coords[:, 0]
        normals = np.cross(a, b)
    return centers.astype(np.float32), normals.astype(np.float32)
