"""A sphere of diameter 1 in a cubic box: an icosahedron refined to a
surface size and put back on the sphere, a wall cell size, and every side
of the box a farfield."""

from __future__ import annotations

import numpy as np

from ..domain import box_sides
from ..host.octree import build_mesh
from ..host.refine import refine_to_length
from ..host.stereolitography import Stereolitography, merge_points


def icosphere(radius: float, h: float) -> Stereolitography:
    phi = (1 + np.sqrt(5)) / 2
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], dtype=np.float32)
    verts /= np.linalg.norm(verts[0])
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    stl = refine_to_length(Stereolitography(verts * radius, faces),
                           h * radius)
    stl.points = stl.points * (
        radius / np.linalg.norm(stl.points, axis=1))[:, None]
    return stl

# the configuration's keys that fix the mesh
GEOMETRY = ["wall_h", "surface_h", "farfield", "block_size"]


def geometry(cfg):
    stl = merge_points(icosphere(0.5, float(cfg["surface_h"])))
    ff = float(cfg["farfield"])
    msh = build_mesh([-ff] * 3, [2 * ff] * 3,
                     ("wall", stl, float(cfg["wall_h"])),
                     block_size=int(cfg["block_size"]))
    return msh, stl, [("farfield", box_sides(3))]


def freestream(cfg):
    """[p, T, u, 0, 0] at the configuration's Mach number."""
    T, p = float(cfg["T_inf"]), float(cfg["p_inf"])
    V = float(cfg["mach"]) * np.sqrt(1.4 * 283.0 * T)
    return np.array([p, T, V, 0.0, 0.0])
