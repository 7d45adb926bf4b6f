"""The port's own host build of the 2D airfoil case (its numpy copies of
the surface readers, mesher, face, ghost, stencil, surface and block-table
compilers) equals the JAX package's, bit for bit, on the RAE2822 case at
wall_h=8e-2 (the fixture of tests/test_block_ops.py). The initial state
goes through each package's ghost BC on its own framework and is held to
2e-5 per channel (as tests/test_torch_sphere3d.py)."""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from ibx.cases import build_rae2822 as jx_build_rae2822
from ibx.cases.rae2822 import RAE_DAT as JX_RAE_DAT
from ibx.geometry import stereolitography as jx_stl
from ibx.topology.blocked_bc import _collect_families as jx_families
from ibx.topology.domain import Domain as JxDomain

from ibx_torch.cases import build_rae2822
from ibx_torch.cases.rae2822 import RAE_DAT
from ibx_torch.geometry import stereolitography as pt_stl
from ibx_torch.topology.blocked_bc import _collect_families
from ibx_torch.topology.blocks import build_block_tables
from ibx_torch.topology.domain import Domain

from test_torch_kernels import FAMILIES, chan_err, ibx_fields

torch.set_num_threads(2)
SMALL = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7)


@pytest.fixture(scope="module")
def cases():
    jx = jx_build_rae2822(**SMALL)
    pt = build_rae2822(device="cpu", **SMALL)
    assert pt.dom.ncells == jx.dom.ncells == 16768
    return jx, pt


def _equal(a, b, path="") -> None:
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), path


def _families_equal(jdom, pdom):
    ref = jx_families(jdom, FAMILIES)
    out = _collect_families(pdom, FAMILIES)
    assert set(ref) == set(out)
    for k in ref:
        _equal(ref[k], out[k], k)
    return out


def test_dat_bytes_equal():
    """The port reads its own copy of the airfoil coordinates."""
    assert "ibx_torch" in Path(RAE_DAT).parts
    assert Path(RAE_DAT).read_bytes() == Path(JX_RAE_DAT).read_bytes()


def test_cells_and_faces_equal(cases):
    jx, pt = cases
    for name in ("centers", "widths", "face_dim", "face_owner",
                 "face_neighbor"):
        _equal(getattr(jx.dom, name), getattr(pt.dom, name), name)


def test_block_tables_equal(cases):
    """Every field of the host compiler's output, the sparse ones too."""
    jx, pt = cases
    ref = ibx_fields(jx.grid["bt"])
    out = build_block_tables(pt.dom)
    assert set(ref) == set(out)
    assert {"sp_owner", "sp_neighbor", "sp_wr", "sp_wl",
            "spacing_flat"} <= set(out)
    for k in ref:
        _equal(ref[k], out[k], k)
    assert pt.bt.nd == 2 and pt.bt.n_sparse == 0
    # the 2D kernels' tables: meta, nbr_table and fold_rows in the 3D
    # layout, zero past nd
    bt = pt.bt
    meta, nbr = bt.meta.numpy(), bt.nbr_table.numpy()
    np.testing.assert_array_equal(meta[:, :2], bt.h.numpy())
    for d in range(2):
        for s in range(2):
            np.testing.assert_array_equal(meta[:, 3 + 2 * d + s],
                                          out["edge_valid"][d][s])
            np.testing.assert_array_equal(meta[:, 9 + 2 * d + s],
                                          out["bnd"][d][s])
            np.testing.assert_array_equal(nbr[:, 2 * d + s],
                                          out["nbr"][d][s])
    assert not meta[:, [2, 7, 8, 13, 14, 15]].any() and not nbr[:, 4:].any()
    rows = bt.fold_rows.numpy()
    n_ifc = sum(int(bt.fs_block[d][s].shape[0] + bt.cs_block[d][s].shape[0])
                for d in range(2) for s in range(2))
    assert rows.shape == (bt.n_blocks, 4)
    np.testing.assert_array_equal(np.sort(rows[rows >= 0]), np.arange(n_ifc))


def test_ghost_families_equal(cases):
    jx, pt = cases
    fams = _families_equal(jx.dom, pt.dom)
    assert fams["normals"].shape[1] == 2


def test_active_mask_equal(cases):
    jx, pt = cases
    _equal(jx.grid["active3"], pt.active3.numpy(), "active3")
    assert jx.grid["fix3"] is None and pt.fix3 is None


def test_initial_state_matches(cases):
    """P0 after the ghost BC: 2e-5 per channel; frozen interior cells that
    are no ghosts (none on this coarse mesh, some on finer ones) keep an
    exactly zero velocity in both."""
    jx, pt = cases
    ref, out = np.asarray(jx.P0), pt.P0.numpy()
    assert chan_err(ref, out) < 2e-5, chan_err(ref, out)
    frozen = pt.active3.numpy().reshape(-1) == 0
    ghost = np.zeros(frozen.shape, bool)
    ghost[_collect_families(pt.dom, FAMILIES)["ghosts"]] = True
    sel = frozen & ~ghost
    assert (out[sel, 2:] == 0).all() and (ref[sel, 2:] == 0).all()


def test_wall_surface_equal(cases):
    """Points, offsets, unit normals, areas and both interpolators' stencil
    indices and weights of the wall surface."""
    jx, pt = cases
    js, ps = jx.dom.surfaces["wall"], pt.dom.surfaces["wall"]
    for name in ("points", "offsets", "normals", "areas"):
        _equal(getattr(js, name), getattr(ps, name), name)
    for name in ("interpolator", "offset_interpolator"):
        jt, pt_ = getattr(js, name), getattr(ps, name)
        _equal(jt.idx, pt_.idx.numpy(), name + ".idx")
        _equal(jt.w, pt_.w.numpy(), name + ".w")
    _equal(js.stl.points, ps.stl.points, "stl.points")
    _equal(js.stl.simplices, ps.stl.simplices, "stl.simplices")


@pytest.mark.parametrize("keyword", ["fluid_ghost_ratio",
                                     "reflect_solid_images",
                                     "solve_inside_cells"])
def test_domain_keywords_equal(cases, keyword):
    """The host-side `Domain` keywords of the flagged wall deviations give
    the same ghost families in both packages, and change them."""
    jx, pt = cases
    inside = pt.active3.numpy().reshape(-1) == 0
    kw = {"fluid_ghost_ratio": dict(fluid_ghost_ratio=0.5),
          "reflect_solid_images": dict(reflect_solid_images=True),
          "solve_inside_cells": dict(solve_inside_cells=inside)}[keyword]
    hf = [("farfield", [(0, False), (0, True), (1, False), (1, True)])]
    jdom = JxDomain(jx.dom.mesh, hypercube_families=hf, **kw)
    pdom = Domain(pt.dom.mesh, hypercube_families=hf, device="cpu", **kw)
    fams = _families_equal(jdom, pdom)
    base = _collect_families(pt.dom, FAMILIES)
    if keyword == "reflect_solid_images":
        assert not np.array_equal(fams["normals"], base["normals"])
    else:
        assert fams["ghosts"].size < base["ghosts"].size


def _write_stl(path: Path, binary: bool) -> None:
    rng = np.random.default_rng(2)
    tris = rng.uniform(-1, 1, (5, 3, 3)).astype(np.float32)
    if binary:
        with open(path, "wb") as fh:
            fh.write(b"binary stl".ljust(80, b" "))
            fh.write(struct.pack("<I", len(tris)))
            for t in tris:
                fh.write(struct.pack("<12fH", 0.0, 0.0, 1.0,
                                     *t.reshape(-1).tolist(), 0))
        return
    with open(path, "w") as fh:
        fh.write("solid s\n")
        for t in tris:
            fh.write("facet normal 0 0 1\n outer loop\n")
            for v in t:
                fh.write("  vertex %r %r %r\n" % tuple(float(c) for c in v))
            fh.write(" endloop\nendfacet\n")
        fh.write("endsolid s\n")


@pytest.mark.parametrize("reader", ["polyline_closed", "polyline_open",
                                    "load_dat", "loft_polyline",
                                    "stl_ascii", "stl_binary"])
def test_surface_readers_equal(reader, tmp_path):
    """The surface constructors and readers the port had left out, on
    small inputs made here: bit-equal points and simplices."""
    rng = np.random.default_rng(1)
    th = np.linspace(0, 2 * np.pi, 9, endpoint=False)
    loop = np.stack([np.cos(th), 0.3 * np.sin(th)], axis=1) \
        + 0.01 * rng.standard_normal((9, 2))
    if reader.startswith("polyline"):
        closed = reader.endswith("closed")
        ref, out = (m.polyline(loop, closed=closed)
                    for m in (jx_stl, pt_stl))
        assert out.simplices.shape[0] == (9 if closed else 8)
    elif reader == "load_dat":
        path = tmp_path / "foil.dat"
        np.savetxt(path, loop)
        ref, out = (m.load_surface(str(path)) for m in (jx_stl, pt_stl))
        assert out.points.shape == (9, 2)
    elif reader == "loft_polyline":
        ref, out = (m.loft_polyline(m.polyline(loop), -0.5, 0.5,
                                    n_sections=3)
                    for m in (jx_stl, pt_stl))
        assert out.points.shape == (3 * 9 + 2, 3)
    else:
        path = tmp_path / "s.stl"
        _write_stl(path, binary=reader == "stl_binary")
        ref, out = (m.load_surface(str(path)) for m in (jx_stl, pt_stl))
        assert out.points.shape == (15, 3) and out.simplices.shape == (5, 3)
    _equal(ref.points, out.points, "points")
    _equal(ref.simplices, out.simplices, "simplices")
    rc, rn = jx_stl.centers_and_normals(ref)
    oc, on = pt_stl.centers_and_normals(out)
    _equal(rc, oc, "centers")
    _equal(rn, on, "normals")


def test_tables_are_jax_free(cases):
    """What the port's case holds is torch and numpy, never a JAX array."""
    _, pt = cases
    leaves = [pt.P0, pt.active3, pt.bt.h, pt.bc.w,
              pt.dom.surfaces["wall"].interpolator.w]
    assert all(isinstance(x, torch.Tensor) for x in leaves)
    assert not any(isinstance(x, jax.Array) for x in
                   (pt.dom.centers, pt.P_inf,
                    pt.dom.surfaces["wall"].areas))
