"""The port's VTK writers (`ibx_torch.io`) write the JAX package's files
byte for byte: the 3D rectilinear blocks and triangle polydata of
tests/test_vtk3d.py, fed from tensors, and a whole `export_vtk` of the
16,768-cell RAE2822 domain with a cell field (its volume byte-identical,
its surface sampling within float32 rounding)."""

import base64
import os
import re
import struct

import numpy as np
import pytest
import torch

from ibx.cases import build_rae2822 as jx_build_rae2822
from ibx.geometry import Mesh
from ibx.io import export_mesh_vtk as jx_export_mesh_vtk
from ibx.io import export_vtk as jx_export_vtk
from ibx.io import write_vtp as jx_write_vtp

from ibx_torch.cases import build_rae2822
from ibx_torch.io import export_mesh_vtk, export_vtk, write_vtp

torch.set_num_threads(2)


def _files(folder):
    return {n: open(os.path.join(folder, n), "rb").read()
            for n in sorted(os.listdir(folder))}


def test_mesh_export_byte_identical(tmp_path):
    """tests/test_vtk3d.py's two-block 3D mesh and cell field: the same
    ``VOLUME.vtm`` and ``block_*.vtr`` bytes, the field given as a tensor
    to the port and as an array to the JAX package."""
    msh = Mesh(
        origin=np.zeros(3, np.float32), widths=np.ones(3, np.float32),
        block_size=2,
        block_origins=np.array([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]],
                               np.float32),
        block_widths=np.full((2, 3), 0.5, np.float32),
        distance_fields={},
    )
    u = np.arange(16, dtype=np.float32)
    jx_export_mesh_vtk(str(tmp_path / "jx"), msh, u=u)
    export_mesh_vtk(str(tmp_path / "pt"), msh, u=torch.as_tensor(u))
    ref, out = _files(tmp_path / "jx"), _files(tmp_path / "pt")
    assert set(ref) == {"VOLUME.vtm", "block_0.vtr", "block_1.vtr"}
    assert ref == out


def test_vtp_byte_identical(tmp_path):
    """tests/test_vtk3d.py's triangle polydata, from tensors."""
    pts = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    simp = np.array([[0, 1, 2]], np.int64)
    q = np.array([1.0], np.float32)
    jx_write_vtp(str(tmp_path / "a.vtp"), pts, simp, {"q": q})
    write_vtp(str(tmp_path / "b.vtp"), torch.as_tensor(pts),
              torch.as_tensor(simp), {"q": torch.as_tensor(q)})
    assert (tmp_path / "a.vtp").read_bytes() == (tmp_path / "b.vtp").read_bytes()


def _arrays(xml: bytes):
    """Name -> float32 values of every binary DataArray of a file."""
    out = {}
    for name, b64 in re.findall(rb'Name="([^"]+)"[^>]*>([^<]*)<', xml):
        raw = base64.b64decode(b64)
        (n,) = struct.unpack("<Q", raw[:8])
        out[name.decode()] = raw[8:8 + n]
    return out


@pytest.mark.parametrize("volume", [True, False], ids=["volume", "surface"])
def test_domain_export_matches(tmp_path, volume):
    """`export_vtk` of the RAE2822 domain (wall_h=8e-2) with the initial
    pressure as a cell field: every volume file byte-identical; the wall
    surface file identical but for the sampled field, which agrees within
    rtol 1e-6 (the port's wall interpolator sums in its own order)."""
    kw = dict(wall_h=8e-2, feature_h=4e-2)
    jx = jx_build_rae2822(**kw)
    pt = build_rae2822(device="cpu", **kw)
    p = np.array(jx.P0)[:, 0]
    jx_export_vtk(str(tmp_path / "jx"), jx.dom, p=p,
                  export_volume=volume, export_surface=not volume)
    export_vtk(str(tmp_path / "pt"), pt.dom, p=torch.as_tensor(p),
               export_volume=volume, export_surface=not volume)
    ref, out = _files(tmp_path / "jx"), _files(tmp_path / "pt")
    assert set(ref) == set(out)
    if volume:
        assert len(ref) == pt.dom.mesh.n_blocks + 1
        assert ref == out
        return
    assert set(ref) == {"SURFACE.vtm", "wall.vtp"}
    assert ref["SURFACE.vtm"] == out["SURFACE.vtm"]
    a, b = _arrays(ref["wall.vtp"]), _arrays(out["wall.vtp"])
    assert set(a) == {"points", "connectivity", "offsets", "p"}
    for k in ("points", "connectivity", "offsets"):
        assert a[k] == b[k], k
    pa, pb = (np.frombuffer(x[k], np.float32) for x, k in ((a, "p"), (b, "p")))
    np.testing.assert_allclose(pb, pa, rtol=1e-6)
