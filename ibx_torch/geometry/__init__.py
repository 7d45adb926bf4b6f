"""Host geometry: numpy copies of the JAX package's `ibx.geometry`
modules (surfaces and readers, distance fields, the octree mesher,
surface refinement and feature regions, point-in-solid tests)."""
from .distance import Ball, Box, DistanceField, Line, refine_orderly
from .octree import Mesh, build_mesh, get_cells, refine_octree
from .refine import (
    feature_regions,
    project_on_segments,
    project_on_simplices,
    project_on_triangles,
    refine_to_length,
)
from .stereolitography import (
    Stereolitography,
    centers_and_normals,
    concatenate,
    load_surface,
    merge_points,
    polyline,
    read_stl,
    simplex_coordinates,
)

__all__ = [
    "Ball", "Box", "DistanceField", "Line", "refine_orderly",
    "Mesh", "build_mesh", "get_cells", "refine_octree",
    "feature_regions", "refine_to_length",
    "project_on_segments", "project_on_simplices", "project_on_triangles",
    "Stereolitography", "centers_and_normals", "concatenate", "load_surface",
    "merge_points", "polyline", "read_stl", "simplex_coordinates",
]
