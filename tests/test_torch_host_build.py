"""The port's own host build (its numpy copies of the geometry, face,
ghost, stencil and block-table compilers) equals the JAX package's, bit
for bit, on the bs=4 sphere case."""

import numpy as np
import pytest
import torch

import jax

from ibx.cases import build_sphere3d as jx_build_sphere3d
from ibx.ops import pallas_rhs as pr
from ibx.topology.blocked_bc import _collect_families as jx_families

from ibx_torch.cases import build_sphere3d
from ibx_torch.topology.blocked_bc import _collect_families
from ibx_torch.topology.blocks import build_block_tables

from test_torch_kernels import FAMILIES, ibx_fields

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cases():
    jx = jx_build_sphere3d(wall_h=0.25, block_size=4)
    pt = build_sphere3d(wall_h=0.25, block_size=4, device="cpu")
    return jx, pt


def _equal(a, b, path="") -> None:
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.array_equal(a, b), path


def test_cells_and_faces_equal(cases):
    jx, pt = cases
    for name in ("centers", "widths", "face_dim", "face_owner",
                 "face_neighbor"):
        _equal(getattr(jx.dom, name), getattr(pt.dom, name), name)


def test_block_tables_equal(cases):
    jx, pt = cases
    ref = ibx_fields(jx.grid["bt"])
    out = build_block_tables(pt.dom)
    assert set(ref) == set(out)
    for k in ref:
        _equal(ref[k], out[k], k)


def test_ghost_families_equal(cases):
    jx, pt = cases
    ref = jx_families(jx.dom, FAMILIES)
    out = _collect_families(pt.dom, FAMILIES)
    assert set(ref) == set(out)
    for k in ref:
        _equal(ref[k], out[k], k)


def test_active_mask_equal(cases):
    jx, pt = cases
    bt = jx.grid["bt"]
    ref = pr.cs_split(bt, jax.numpy.asarray(jx.grid["active3"])[..., None])
    _equal(ref, pt.active_cs.numpy(), "active")


def test_cut_metrics_equal():
    """`ibx_torch.geometry.cutcell` (a numpy copy) gives the JAX package's
    fluid fractions and cut-cell wall tables bit for bit on the slanted
    wedge of tests/test_cutcell.py:25 (25 degrees, wall_h=0.05)."""
    from ibx.geometry import build_mesh
    from ibx.geometry import cutcell as jx_cc
    from ibx.geometry.inside import points_inside
    from ibx.geometry.octree import get_cells
    from ibx.geometry.stereolitography import polyline
    from ibx.topology.domain import Domain as JxDomain

    from ibx_torch.geometry import cutcell as cc

    th = np.deg2rad(25.0)
    t = np.array([np.cos(th), np.sin(th)])
    n = np.array([-np.sin(th), np.cos(th)])
    p0, p1 = np.array([0.5, 0.25]) - 5.0 * t, np.array([0.5, 0.25]) + 5.0 * t
    stl = polyline(np.stack([p0, p1, p1 - 6.0 * n, p0 - 6.0 * n]),
                   closed=True)
    msh = build_mesh([0.0, 0.0], [1.0, 1.0], ("wall", stl, 0.05),
                     block_size=8)
    dist = msh.distance_fields["wall"]
    centers, widths, _ = get_cells(msh)
    inside = points_inside(stl, centers)
    alpha = jx_cc.fluid_fractions_2d(stl, dist, centers, widths, inside)
    assert np.array_equal(
        alpha, cc.fluid_fractions_2d(stl, dist, centers, widths, inside))
    solved = ~inside | (alpha > 0.05)
    dom = JxDomain(msh, fluid_ghost_ratio=0.0, reflect_solid_images=True,
                   solve_inside_cells=inside & (alpha > 0.05))
    args = (stl, dist, dom.centers, dom.widths, solved, dom.face_dim,
            dom.face_owner, dom.face_neighbor)
    ref = jx_cc.cut_metrics_2d(*args, alpha=alpha)
    out = cc.cut_metrics_2d(*args, alpha=alpha)
    assert set(ref) == set(out) and ref["n_cut_faces"] > 0
    for k in ref:
        _equal(ref[k], out[k], k)
