from .rae2822 import Rae2822Case, build_rae2822, force_coefficients, wall_cp
from .sphere3d import Sphere3dCase, build_sphere3d

__all__ = [
    "Rae2822Case",
    "Sphere3dCase",
    "build_rae2822",
    "build_sphere3d",
    "force_coefficients",
    "wall_cp",
]
