"""The RAE2822 airfoil in a square box (AGARD-AR-138, 1979): the Selig
coordinates, a wall cell size, a finer size within 0.05 chords of the
surface's features, and every side of the box a farfield."""

from __future__ import annotations

import os

import numpy as np

from ..domain import box_sides
from ..host.distance import DistanceField
from ..host.octree import build_mesh
from ..host.refine import feature_regions
from ..host.stereolitography import load_surface, merge_points

DAT = os.path.join(os.path.dirname(__file__), os.pardir, "data",
                   "rae2822.dat")


def surface():
    return merge_points(load_surface(DAT))

# the configuration's keys that fix the mesh
GEOMETRY = ["wall_h", "feature_h", "farfield", "block_size"]


def geometry(cfg):
    stl = surface()
    ff = float(cfg["farfield"])
    msh = build_mesh(
        [-ff, -ff], [2 * ff, 2 * ff], ("wall", stl, float(cfg["wall_h"])),
        refinement_regions=[(DistanceField(feature_regions(stl, radius=0.05)),
                             float(cfg["feature_h"]))],
        block_size=int(cfg["block_size"]))
    return msh, stl, [("farfield", box_sides(2))]


def freestream(cfg):
    """[p, T, u, v] at the configuration's Mach number and incidence."""
    T, p = float(cfg["T_inf"]), float(cfg["p_inf"])
    V = float(cfg["mach"]) * np.sqrt(1.4 * 283.0 * T)
    al = np.deg2rad(float(cfg["alpha_deg"]))
    return np.array([p, T, V * np.cos(al), V * np.sin(al)])
