"""The cut-cell wall (``build_rae2822(cutcell=True)``, a flagged deviation
of both packages) on the port's block march: the host tables of
`ibx_torch.geometry.cutcell` on the airfoil bit-equal to the JAX
package's, the exact steady state of a parallel freestream over a slanted
wall (tests/test_cutcell.py:87) on the port, and the ``cut3`` RHS, one
step and 5 steps against the JAX package's on the 16,768-cell airfoil
(wall_h=8e-2)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ibx.cases import build_rae2822 as jx_build_rae2822
from ibx.ops.block_ops import euler_rhs_grid as jx_euler_rhs_grid
from ibx.ops.block_ops import to_blocks as jx_to_blocks

from ibx_torch import geometry as tg
from ibx_torch.cases import build_rae2822
from ibx_torch.convert import cut3_from_numpy, tables_from_numpy
from ibx_torch.geometry.cutcell import cut_metrics_2d, fluid_fractions_2d
from ibx_torch.geometry.inside import points_inside
from ibx_torch.ops import kernels as K
from ibx_torch.ops.block_ops import euler_rhs_grid, rk2_step_grid, to_blocks
from ibx_torch.physics.bc import apply_flow_bc, flow_bc
from ibx_torch.physics.fluid import make_fluid, physicality_guard
from ibx_torch.topology.blocked_bc import _collect_families
from ibx_torch.topology.blocks import build_block_tables
from ibx_torch.topology.domain import Domain

from test_torch_kernels import chan_err

torch.set_num_threads(2)
SMALL = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7, cutcell=True)


@pytest.fixture(scope="module")
def cases():
    jx = jx_build_rae2822(**SMALL)
    pt = build_rae2822(device="cpu", **SMALL)
    return jx, pt


def _perturbed(case, seed):
    rng = np.random.default_rng(seed)
    P = case.P0.numpy().copy()
    P[:, 2:] += rng.normal(0.0, 30.0, P[:, 2:].shape).astype(np.float32)
    return P


def test_cut_tables_bit_equal(cases):
    """The case's ``cut3`` tables (cut faces and their apertures a dim,
    wall cells, wall vectors and offsets, alpha and 1/alpha), its solved
    set and the options ``cutcell`` forces equal the JAX case's."""
    jx, pt = cases
    ref = jx.grid["cut3"]
    for key in ("owner", "neighbor", "wr", "wl"):
        for d in range(2):
            assert np.array_equal(np.asarray(ref[key][d]),
                                  pt.cut3[key][d].numpy()), (key, d)
    for key in ("wall_cells", "wall_coef", "xw_rel", "inv_alpha3",
                "alpha3"):
        assert np.array_equal(np.asarray(ref[key]),
                              pt.cut3[key].numpy()), key
    assert pt.cut3["owner"][0].shape[0] > 0
    assert pt.cut3["wall_cells"].shape[0] > 0
    assert np.array_equal(np.asarray(jx.grid["active3"]), pt.active3.numpy())
    assert pt.mirror == ("wall",)


def test_rhs_and_dt_match(cases):
    """`euler_rhs_grid` with ``cut3`` (cut-face flux removal, the wall
    pressure term, 1/alpha) from a perturbed state against the JAX
    package's jitted RHS: R within 2e-4 per channel (measured 1.3e-6) and
    dt (scaled by alpha) within rtol 1e-4 (measured 1.9e-7); the cut
    terms move R by more than 1e-3."""
    jx, pt = cases
    P = _perturbed(pt, 4)
    bt, cut3 = jx.grid["bt"], jx.grid["cut3"]
    R, dt, _ = jax.jit(lambda P3: jx_euler_rhs_grid(
        bt, jx.fluid, P3, with_dt=True, cfl=0.7, cut3=cut3))(
            jx_to_blocks(bt, jnp.asarray(P)))
    Rp, dtp, _ = euler_rhs_grid(pt.bt, pt.fluid,
                                to_blocks(pt.bt, torch.as_tensor(P)),
                                with_dt=True, cfl=0.7, cut3=pt.cut3)
    R = np.asarray(R).reshape(-1, 4)
    assert chan_err(R, Rp.reshape(-1, 4).numpy()) < 2e-4, \
        chan_err(R, Rp.reshape(-1, 4).numpy())
    dt = np.asarray(dt).ravel()
    assert np.abs(dtp.numpy().ravel() - dt).max() <= 1e-4 * np.abs(dt).max()
    plain = euler_rhs_grid(pt.bt, pt.fluid,
                           to_blocks(pt.bt, torch.as_tensor(P)))
    assert chan_err(R, plain.reshape(-1, 4).numpy()) > 1e-3


def test_march_matches(cases):
    """One `case.step` from a perturbed state within 1e-4 per channel with
    its resnorm at rtol 1e-4 (measured 8.4e-7), and 5 steps of
    `case.march` from the initial state within 1e-3 (measured 3.9e-5)
    against the JAX case's jitted march; no kernel launched."""
    jx, pt = cases
    assert np.array_equal(np.asarray(jx.P0), pt.P0.numpy())
    P = _perturbed(pt, 5)
    K.reset_launches()
    ref, res_ref = jx.step(jnp.asarray(P))
    out, res = pt.step(torch.as_tensor(P))
    assert chan_err(ref, out.numpy()) < 1e-4, chan_err(ref, out.numpy())
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))
    ref = np.asarray(jx.march(jx.P0, 5))
    out = pt.march(pt.P0, 5).numpy()
    assert np.isfinite(out).all()
    assert chan_err(ref, out) < 1e-3, chan_err(ref, out)
    assert not any(K.launches.values())


def test_cutcell_needs_the_block_path():
    """As in the JAX package: the gather march refuses ``cutcell``."""
    with pytest.raises(ValueError, match="block fast path"):
        build_rae2822(device="cpu", use_blocks=False, **SMALL)


def _slant_case(theta_deg=25.0):
    """Box [0,1]^2 with a solid wedge below the line through (0.5, 0.25)
    at angle theta (tests/test_cutcell.py:25), by the port's host code."""
    th = np.deg2rad(theta_deg)
    t = np.array([np.cos(th), np.sin(th)])
    p0 = np.array([0.5, 0.25]) - 5.0 * t
    p1 = np.array([0.5, 0.25]) + 5.0 * t
    n = np.array([-np.sin(th), np.cos(th)])
    stl = tg.polyline(np.stack([p0, p1, p1 - 6.0 * n, p0 - 6.0 * n]),
                      closed=True)
    msh = tg.build_mesh([0.0, 0.0], [1.0, 1.0], ("wall", stl, 0.05),
                        block_size=8)
    centers, widths, _ = tg.get_cells(msh)
    inside = points_inside(stl, centers)
    alpha = fluid_fractions_2d(stl, msh.distance_fields["wall"], centers,
                               widths, inside)
    solved = ~inside | (alpha > 0.05)
    dom = Domain(
        msh,
        hypercube_families=[
            ("farfield", [(0, False), (0, True), (1, False), (1, True)]),
        ],
        fluid_ghost_ratio=0.0, reflect_solid_images=True,
        solve_inside_cells=inside & (alpha > 0.05), device="cpu")
    cm = cut_metrics_2d(stl, msh.distance_fields["wall"], dom.centers,
                        dom.widths, solved, dom.face_dim, dom.face_owner,
                        dom.face_neighbor, alpha=alpha)
    return dom, solved, cm, t


def test_slanted_wall_parallel_freestream_is_steady():
    """The watertight closure on the port: a freestream parallel to a flat
    wall at 25 degrees is a discrete steady state. The momentum residual
    of the solved cells under 2e-3 of rho V^2 / h and 5 RK2 steps drift
    under 5e-3 of V (the bounds of tests/test_cutcell.py:87-148)."""
    dom, solved, cm, t = _slant_case()
    fluid = make_fluid()
    T_inf, p_inf = 288.15, 101325.0
    V = 0.4 * float(np.sqrt(1.4 * 283.0 * T_inf))
    P_inf = np.array([p_inf, T_inf, V * t[0], V * t[1]], np.float32)
    names = ["farfield", "wall"]
    bt, bc = tables_from_numpy(build_block_tables(dom),
                               _collect_families(dom, names), names, "cpu")
    far = flow_bc(fluid, P_inf, device="cpu")
    wall = flow_bc(fluid, [p_inf, T_inf, 0.0], normal_flow=True,
                   device="cpu")
    fns = {"farfield": lambda Pi, nrm: apply_flow_bc(far, Pi, nrm),
           "wall": lambda Pi, nrm: apply_flow_bc(wall, Pi, nrm)}

    def bcs3(P3):
        return bc.apply_grid(P3, fns, guard=physicality_guard,
                             mirror=("wall",))

    P3 = bcs3(to_blocks(bt, torch.as_tensor(
        np.tile(P_inf, (dom.ncells, 1)))).clone())
    cut3 = cut3_from_numpy(cm, bt, "cpu")
    solved3 = to_blocks(bt, torch.as_tensor(
        solved.astype(np.float32))[:, None])[..., 0]
    R = euler_rhs_grid(bt, fluid, P3, cut3=cut3) * solved3[..., None]
    scale = p_inf / (283.0 * T_inf) * V * V / 0.05
    r_cut = float(R[..., 2:4].abs().max()) / scale
    assert r_cut < 2e-3, r_cut
    Pm = P3
    for _ in range(5):
        Pm, _ = rk2_step_grid(bt, fluid, Pm, bcs3, cfl=0.7,
                              active3=solved3, cut3=cut3)
    drift = float((Pm - P3)[..., 2:4].abs().max()) / V
    assert drift < 5e-3, drift
