"""Host topology compile (numpy) and the device tables it feeds: the
`Domain` with its boundaries, surfaces, partitions and ghost-BC executor,
faces, ghosts, interpolation stencils, the block tables and the block
march's `GhostBC`."""
from .domain import Boundary, Domain, Surface, surface_integral
from .faces import hcube_faces, octree2faces
from .ghosts import ghosts_and_projections_hcube, ghosts_and_projections_stl
from .interp import idw_weights, interpolator, linear_weights

__all__ = [
    "Boundary", "Domain", "Surface", "surface_integral",
    "hcube_faces", "octree2faces",
    "ghosts_and_projections_hcube", "ghosts_and_projections_stl",
    "interpolator", "linear_weights", "idw_weights",
]
