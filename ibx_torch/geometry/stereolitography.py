"""Triangulated/segmented surface containers and readers.

Verbatim numpy copy of `ibx/geometry/stereolitography.py` (reference
``src/mesher.jl:124-431``): binary/ASCII STL, Selig ``.dat`` airfoils,
polyline constructors and the section loft, surface concatenation,
tolerance-based point merging, simplex centers and normals. Convention
change vs the Julia reference: arrays are row-major — ``points`` is
[n_points, nd] and ``simplices`` is [n_simplices, k] with 0-based indices.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

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


def polyline(points: np.ndarray, closed: bool = True) -> Stereolitography:
    """2D surface from an ordered point loop (reference ``src/mesher.jl:250-267``)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    idx = np.arange(n, dtype=np.int64)
    if closed:
        simplices = np.stack([idx, np.roll(idx, -1)], axis=1)
    else:
        simplices = np.stack([idx[:-1], idx[1:]], axis=1)
    return Stereolitography(points, simplices)


def loft_polyline(
    section: Stereolitography,
    z0: float,
    z1: float,
    n_sections: int = 2,
    cap: bool = True,
) -> Stereolitography:
    """Extrude a closed 2D section loop into a closed 3D triangulated
    surface (straight wing): stations at ``n_sections`` equispaced z
    planes, quad side panels split into triangles, end caps as centroid
    fans. ``section.points`` must be in loop order (as produced by
    `polyline` / the Selig ``.dat`` loader).

    No counterpart in the reference (its 3D workloads read STL files);
    used to assemble the 3D wing RANS workload from the committed RAE2822
    section. Triangles are oriented so normals point OUTWARD (assuming a
    counterclockwise section loop; flip z0/z1 otherwise is not needed —
    orientation only matters through `centers_and_normals` consumers that
    use unsigned distances/areas).
    """
    pts2 = np.asarray(section.points, dtype=np.float64)
    n = pts2.shape[0]
    zs = np.linspace(float(z0), float(z1), int(n_sections))
    rings = [
        np.concatenate([pts2, np.full((n, 1), z)], axis=1) for z in zs
    ]
    points = np.concatenate(rings, axis=0)
    tris = []
    i = np.arange(n, dtype=np.int64)
    j = (i + 1) % n
    for k in range(len(zs) - 1):
        a = k * n + i
        b = k * n + j
        c = (k + 1) * n + i
        d = (k + 1) * n + j
        tris.append(np.stack([a, b, d], axis=1))
        tris.append(np.stack([a, d, c], axis=1))
    if cap:
        centroid = pts2.mean(axis=0)
        c0 = np.concatenate([centroid, [zs[0]]])[None, :]
        c1 = np.concatenate([centroid, [zs[-1]]])[None, :]
        i0 = points.shape[0]
        i1 = i0 + 1
        points = np.concatenate([points, c0, c1], axis=0)
        tris.append(np.stack(
            [np.full(n, i0, np.int64), j, i], axis=1))          # z0 cap
        base = (len(zs) - 1) * n
        tris.append(np.stack(
            [np.full(n, i1, np.int64), base + i, base + j], axis=1))
    return Stereolitography(points.astype(np.float32),
                            np.concatenate(tris, axis=0))


def _is_ascii_stl(path: str) -> bool:
    with open(path, "rb") as fh:
        head = fh.read(5)
    return head == b"solid"


def _read_stl_ascii(path: str):
    verts = []
    faces = []
    face = []
    with open(path, "r") as fh:
        for raw in fh:
            line = raw.strip()
            if line.startswith("vertex"):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
                face.append(len(verts) - 1)
            elif line.startswith("facet normal"):
                face = []
            elif line.startswith("endloop"):
                faces.append(face)
    return (
        np.asarray(verts, dtype=np.float32),
        np.asarray(faces, dtype=np.int64),
    )


def _read_stl_binary(path: str):
    with open(path, "rb") as fh:
        data = fh.read()
    ntri = int(np.frombuffer(data[80:84], dtype=np.uint32)[0])
    rec = np.dtype(
        [
            ("normal", np.float32, (3,)),
            ("v", np.float32, (3, 3)),
            ("attr", np.uint16),
        ]
    )
    tris = np.frombuffer(data[84 : 84 + ntri * rec.itemsize], dtype=rec)
    points = tris["v"].reshape(-1, 3).astype(np.float32)
    simplices = np.arange(3 * ntri, dtype=np.int64).reshape(-1, 3)
    return points, simplices


def read_stl(path: str) -> Stereolitography:
    """Read binary or ASCII STL (reference ``src/mesher.jl:124-227``)."""
    if _is_ascii_stl(path):
        pts, simp = _read_stl_ascii(path)
    else:
        pts, simp = _read_stl_binary(path)
    return Stereolitography(pts, simp)


def load_surface(path: str, closed: bool = True) -> Stereolitography:
    """Load a surface from ``.stl`` or Selig ``.dat`` (2-column airfoil).

    Reference ``src/mesher.jl:279-296``.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".dat":
        coords = np.loadtxt(path, dtype=np.float32)
        return polyline(coords, closed=closed)
    return read_stl(path)


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
