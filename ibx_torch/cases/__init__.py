from .sphere3d import build_sphere3d

__all__ = ["build_sphere3d"]
