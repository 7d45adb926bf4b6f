"""Checkpoint and restore of solver state (`checkpoint`) and the VTK XML
writers (`vtk`)."""
from .checkpoint import load_checkpoint, save_checkpoint
from .vtk import export_mesh_vtk, export_vtk, write_vtp, write_vtr

__all__ = ["export_mesh_vtk", "export_vtk", "load_checkpoint",
           "save_checkpoint", "write_vtp", "write_vtr"]
