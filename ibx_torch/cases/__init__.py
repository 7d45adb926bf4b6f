from .flat_plate import (
    FlatPlateCase,
    build_flat_plate,
    cf_prandtl,
    cf_schultz_grunow,
    skin_friction_profile,
)
from .rae2822 import Rae2822Case, build_rae2822, force_coefficients, wall_cp
from .rae2822_block_sharded import build_rae2822_block_sharded
from .rae2822_rans import (Rae2822RansCase, build_rae2822_rans,
                           wall_skin_friction)
from .rae2822_sharded import build_rae2822_sharded
from .sphere3d import Sphere3dCase, build_sphere3d
from .sphere3d_block_sharded import build_sphere3d_block_sharded
from .wing3d_rans_fas import Wing3dCase, build_wing3d_rans_fas

__all__ = [
    "FlatPlateCase",
    "Rae2822Case",
    "Rae2822RansCase",
    "Sphere3dCase",
    "Wing3dCase",
    "build_flat_plate",
    "build_rae2822",
    "build_rae2822_block_sharded",
    "build_rae2822_rans",
    "build_rae2822_sharded",
    "build_sphere3d",
    "build_sphere3d_block_sharded",
    "build_wing3d_rans_fas",
    "cf_prandtl",
    "cf_schultz_grunow",
    "force_coefficients",
    "skin_friction_profile",
    "wall_cp",
    "wall_skin_friction",
]
