"""VTK XML export (host side, dependency-free): the JAX package's
writers, fed from tensors (every field comes to the host with
``.detach().cpu().numpy()`` at entry, as `checkpoint` does) or arrays.

Counterpart of reference ``src/mesher.jl:1114-1185`` and
``src/ImmersedBoundary.jl:1249-1329``: a folder holding a ``VOLUME`` multiblock
(one rectilinear grid per octree block) and a ``SURFACE`` multiblock (one
polydata per STL family), with cell fields reshaped from the global
block-major cell ordering.
"""

from __future__ import annotations

import base64
import os
import shutil
import struct
from typing import Dict, Optional

import numpy as np
import torch

from .checkpoint import _host


def _b64_dataarray(name: str, arr: np.ndarray, n_comp: int) -> str:
    arr = np.ascontiguousarray(arr, dtype=arr.dtype)
    raw = arr.tobytes()
    payload = struct.pack("<Q", len(raw)) + raw
    b64 = base64.b64encode(payload).decode()
    vtype = {
        np.dtype(np.float32): "Float32",
        np.dtype(np.float64): "Float64",
        np.dtype(np.int32): "Int32",
        np.dtype(np.int64): "Int64",
    }[arr.dtype]
    return (
        f'<DataArray type="{vtype}" Name="{name}" '
        f'NumberOfComponents="{n_comp}" format="binary">{b64}</DataArray>'
    )


def _cell_fields_xml(fields: Dict[str, np.ndarray], sel) -> str:
    parts = []
    for name, v in fields.items():
        v = _host(v)
        vv = v[sel]
        if vv.ndim == 1:
            vv = vv[:, None]
        parts.append(_b64_dataarray(name, vv.astype(np.float32), vv.shape[1]))
    return "\n".join(parts)


def write_vtr(path: str, origin, widths, block_size: int,
              fields: Dict[str, np.ndarray], sel) -> None:
    """One octree block as a rectilinear grid with cell data."""
    nd = len(origin)
    ext = [block_size, block_size, block_size if nd == 3 else 0]
    coords = []
    for d in range(3):
        if d < nd:
            c = np.linspace(origin[d], origin[d] + widths[d],
                            block_size + 1, dtype=np.float32)
        else:
            c = np.zeros(1, dtype=np.float32)
        coords.append(_b64_dataarray("xyz"[d], c, 1))
    with open(path, "w") as fh:
        fh.write(
            '<?xml version="1.0"?>\n'
            '<VTKFile type="RectilinearGrid" version="1.0" '
            'byte_order="LittleEndian" header_type="UInt64">\n'
            f'<RectilinearGrid WholeExtent="0 {ext[0]} 0 {ext[1]} 0 {ext[2]}">\n'
            f'<Piece Extent="0 {ext[0]} 0 {ext[1]} 0 {ext[2]}">\n'
            "<Coordinates>\n" + "\n".join(coords) + "\n</Coordinates>\n"
            "<CellData>\n" + _cell_fields_xml(fields, sel) + "\n</CellData>\n"
            "</Piece>\n</RectilinearGrid>\n</VTKFile>\n"
        )


def write_vtp(path: str, points: np.ndarray, simplices: np.ndarray,
              cell_fields: Dict[str, np.ndarray]) -> None:
    """Surface polydata (lines in 2D, triangles in 3D)."""
    points, simplices = _host(points), _host(simplices)
    n_pts, nd = points.shape
    pts3 = np.zeros((n_pts, 3), dtype=np.float32)
    pts3[:, :nd] = points
    k = simplices.shape[1]
    conn = simplices.astype(np.int64).reshape(-1)
    offs = (np.arange(simplices.shape[0], dtype=np.int64) + 1) * k
    tag = "Lines" if k == 2 else "Polys"
    n_cells = simplices.shape[0]
    with open(path, "w") as fh:
        fh.write(
            '<?xml version="1.0"?>\n'
            '<VTKFile type="PolyData" version="1.0" '
            'byte_order="LittleEndian" header_type="UInt64">\n'
            "<PolyData>\n"
            f'<Piece NumberOfPoints="{n_pts}" '
            f'NumberOf{tag}="{n_cells}">\n'
            "<Points>\n"
            + _b64_dataarray("points", pts3, 3)
            + "\n</Points>\n"
            f"<{tag}>\n"
            + _b64_dataarray("connectivity", conn, 1)
            + "\n"
            + _b64_dataarray("offsets", offs, 1)
            + f"\n</{tag}>\n"
            "<CellData>\n"
            + _cell_fields_xml(cell_fields, slice(None))
            + "\n</CellData>\n"
            "</Piece>\n</PolyData>\n</VTKFile>\n"
        )


def _write_vtm(path: str, names) -> None:
    entries = "\n".join(
        f'<DataSet index="{i}" file="{n}"/>' for i, n in enumerate(names)
    )
    with open(path, "w") as fh:
        fh.write(
            '<?xml version="1.0"?>\n'
            '<VTKFile type="vtkMultiBlockDataSet" version="1.0" '
            'byte_order="LittleEndian">\n'
            "<vtkMultiBlockDataSet>\n" + entries +
            "\n</vtkMultiBlockDataSet>\n</VTKFile>\n"
        )


def export_mesh_vtk(folder: str, msh, block_indices=None, **fields) -> None:
    """VOLUME multiblock for a Mesh (reference ``src/mesher.jl:1138-1185``)."""
    nd = msh.ndim
    npb = msh.block_size ** nd
    if block_indices is None:
        block_indices = range(msh.n_blocks)
    os.makedirs(folder, exist_ok=True)
    names = []
    np_fields = {k: _host(v) for k, v in fields.items()}
    for b in block_indices:
        name = f"block_{b}.vtr"
        sel = slice(b * npb, (b + 1) * npb)
        write_vtr(
            os.path.join(folder, name),
            msh.block_origins[b], msh.block_widths[b], msh.block_size,
            np_fields, sel,
        )
        names.append(name)
    _write_vtm(os.path.join(folder, "VOLUME.vtm"), names)


def export_vtk(folder: str, dom, block_indices=None, *,
               surface_data: Optional[Dict] = None,
               export_volume: bool = True,
               export_surface: bool = True,
               **fields) -> None:
    """Domain export (reference ``src/ImmersedBoundary.jl:1277-1329``).

    ``fields`` are global cell arrays; they are written as volume cell data
    and sampled onto each surface through its wall interpolator.
    ``surface_data[name]`` adds explicit per-surface cell arrays.
    """
    if os.path.isdir(folder):
        shutil.rmtree(folder)
    os.makedirs(folder)
    if export_volume:
        export_mesh_vtk(folder, dom.mesh, block_indices, **fields)
    if export_surface:
        names = []
        for sname, surf in dom.surfaces.items():
            data = {k: _host(surf(torch.as_tensor(_host(v))))
                    for k, v in fields.items()}
            if surface_data and sname in surface_data:
                for k, v in surface_data[sname].items():
                    data[k] = _host(v)
            fname = f"{sname}.vtp"
            write_vtp(
                os.path.join(folder, fname),
                surf.stl.points, surf.stl.simplices, data,
            )
            names.append(fname)
        _write_vtm(os.path.join(folder, "SURFACE.vtm"), names)
