"""Port parity of FAS-Euler (`ibx_torch.solve.fas_euler.FasEuler`) against
`ibx.solve.fas_euler.FasEuler` on RAE2822 at wall_h=8e-2 (16,768 cells),
the gather case of both packages (`build_rae2822(..., use_blocks=False)`)
with a 2-level hierarchy (3 domains) built by the BC recipe of
tests/test_fas_euler.py:21-55: family-by-family `Domain.impose_bc` and the
in-solid cells frozen.

The port's solvers take the JAX package's transfer tables
(`convert.stencil_from_numpy`; the host build is held bit-equal in
tests/test_torch_mgrid.py) and the same numpy states
(`convert.state_from_numpy`). ``_f`` at every level with both smoothers
(the JAX side op by op) agrees within 2e-4 per channel scaled by the
channel's max; one ``cycle(n_iter=2)`` (the JAX ``while_loop`` compiles its
body, and XLA under ``jit`` moves du by 4e-4, ROADMAP queue 3 item 7(c))
within 1e-3 on the state and 1e-3 relative on the ratio. Then the
reference's property tests, on the port alone."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.cases import build_rae2822 as jx_build_rae2822
from ibx.cases.rae2822 import RAE_DAT as JX_RAE_DAT
from ibx.geometry import load_surface as jx_load_surface
from ibx.geometry import merge_points as jx_merge_points
from ibx.geometry.inside import points_inside as jx_points_inside
from ibx.physics import apply_flow_bc as jx_apply_flow_bc
from ibx.physics import flow_bc as jx_flow_bc
from ibx.solve.fas_euler import FasEuler as JxFasEuler

from ibx_torch.cases import build_rae2822
from ibx_torch.cases.rae2822 import RAE_DAT
from ibx_torch.convert import state_from_numpy, stencil_from_numpy
from ibx_torch.geometry import load_surface, merge_points
from ibx_torch.geometry.inside import points_inside
from ibx_torch.ops import kernels as K
from ibx_torch.physics import apply_flow_bc, flow_bc
from ibx_torch.solve import FasEuler

from test_torch_kernels import chan_err
from test_torch_stencil import st_np

torch.set_num_threads(2)
SMALL = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7, use_blocks=False)
# smoother -> cfl, as in tests/test_fas_euler.py's two solvers
SMOOTHERS = {"euler": 0.5, "rk2": 0.7}


def make_solvers(case, fe_cls, flow_bc_, apply_flow_bc_, stl, inside,
                 **bc_kw):
    """One `FasEuler` a smoother over ``case.dom`` (max_levels=2), with the
    ghost BCs of tests/test_fas_euler.py:33-46."""
    fluid = case.fluid
    P_inf = np.asarray(case.P_inf, np.float32)
    far = flow_bc_(fluid, P_inf, **bc_kw)
    wall = flow_bc_(fluid, [float(P_inf[0]), float(P_inf[1]), 0.0],
                    normal_flow=True, **bc_kw)

    def make_bcs(d):
        def apply_bcs(P):
            P = d.impose_bc(
                "farfield",
                lambda b, Pi: apply_flow_bc_(far, Pi, b.normals), P)
            P = d.impose_bc(
                "wall", lambda b, Pi: apply_flow_bc_(wall, Pi, b.normals), P)
            return P
        return apply_bcs

    return {sm: fe_cls(case.dom, fluid, make_bcs, max_levels=2, cfl=cfl,
                       smoother=sm, inside_fn=lambda c: inside(stl, c))
            for sm, cfl in SMOOTHERS.items()}


@pytest.fixture(scope="module")
def setup():
    jx = jx_build_rae2822(**SMALL)
    jfe = make_solvers(jx, JxFasEuler, jx_flow_bc, jx_apply_flow_bc,
                       jx_merge_points(jx_load_surface(JX_RAE_DAT)),
                       jx_points_inside)
    pt = build_rae2822(device="cpu", **SMALL)
    fe = make_solvers(pt, FasEuler, flow_bc, apply_flow_bc,
                      merge_points(load_surface(RAE_DAT)), points_inside,
                      device="cpu")
    for sm in SMOOTHERS:
        j, t = jfe[sm], fe[sm]
        assert [d.ncells for d in t.domains] == [d.ncells for d in j.domains]
        t.coarseners = [stencil_from_numpy(st_np(c), "cpu")
                        for c in j.coarseners]
        t.prolongators = [stencil_from_numpy(st_np(p), "cpu")
                          for p in j.prolongators]
    return jx, jfe, fe, pt


def _perturbed(jx, seed=0):
    """The case's freestream state with a smooth perturbation and noise in
    u and v."""
    rng = np.random.default_rng(seed)
    P = np.array(jx.P0, np.float32)
    x, y = jx.dom.centers[:, 0], jx.dom.centers[:, 1]
    P[:, 0] *= 1.0 + 0.05 * np.sin(x) * np.cos(y)
    P[:, 1] *= 1.0 + 0.02 * np.cos(x)
    P[:, 2] += 20.0 * np.sin(y) + 5.0 * rng.standard_normal(P.shape[0])
    P[:, 3] += 10.0 * np.cos(x) + 5.0 * rng.standard_normal(P.shape[0])
    return P


def _level_states(jfe, P):
    """The JAX solver's conserved state at every level: the fine state of
    ``P`` and its coarsenings, as numpy."""
    Q = jfe.init_state(jnp.asarray(P))
    out = [np.array(Q)]
    for c in jfe.coarseners:
        Q = c(Q)
        out.append(np.array(Q))
    return out


def test_levels_and_masks(setup):
    """Both hierarchies have the same levels, and every level's freeze mask
    lies on its domain's device."""
    _, jfe, fe, _ = setup
    t = fe["rk2"]
    assert len(t.domains) == 3
    for j_act, act, d in zip(jfe["rk2"].active, t.active, t.domains):
        assert act.device == d.device
        np.testing.assert_array_equal(act.numpy(), np.asarray(j_act))


@pytest.mark.parametrize("smoother", list(SMOOTHERS))
@pytest.mark.parametrize("level", [0, 1, 2])
def test_f_matches_ibx(setup, smoother, level):
    """``_f(level, Q)`` (the JAX side op by op): < 2e-4 per channel."""
    jx, jfe, fe, _ = setup
    Q = _level_states(jfe[smoother], _perturbed(jx))[level]
    rj, oj = jfe[smoother]._f(level, jnp.asarray(Q))
    K.reset_launches()
    rt, ot = fe[smoother]._f(level, *state_from_numpy(Q, device="cpu"))
    assert not any(K.launches.values())
    assert chan_err(np.asarray(rj), rt.numpy()) < 2e-4
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_cycle_matches_ibx(setup):
    """One ``cycle(n_iter=2)`` of the rk2 smoother: the state within 1e-3
    per channel, the ratio within 1e-3 relative."""
    jx, jfe, fe, _ = setup
    P = _perturbed(jx)
    Qj, rj = jfe["rk2"].cycle(jfe["rk2"].init_state(jnp.asarray(P)),
                              n_iter=2)
    Qt, rt = fe["rk2"].cycle(
        fe["rk2"].init_state(*state_from_numpy(P, device="cpu")), n_iter=2)
    assert chan_err(np.asarray(Qj), Qt.numpy()) < 1e-3
    assert abs(float(rt) - float(rj)) < 1e-3 * abs(float(rj))


def _physical(fe, Q):
    """The physical ranges on the active (fluid) cells."""
    P = fe.primitives(Q).numpy()
    act = fe.active[0].numpy() > 0
    assert P[act, 0].min() > 1e3 and P[act, 0].max() < 1e6
    assert (P[act, 1] > 50).all()


def test_fas_euler_cycles(setup):
    """tests/test_fas_euler.py::test_fas_euler_cycles on the port."""
    fe, pt = setup[2]["euler"], setup[3]
    Q = fe.init_state(pt.P0)
    ratios = []
    for _ in range(4):
        Q, r = fe.cycle(Q, n_iter=10, rtol=1e-3)
        ratios.append(float(r))
    assert torch.isfinite(Q).all()
    assert min(ratios) < 1.0
    _physical(fe, Q)


def _l2(r):
    return float(torch.sqrt((r.float() ** 2).sum()))


def test_fas_vs_smoothing(setup):
    """tests/test_fas_euler.py::test_fas_vs_smoothing on the port."""
    fe, pt = setup[2]["euler"], setup[3]
    Qc = Qs = fe.init_state(pt.P0)
    for _ in range(3):
        Qc, _ = fe.cycle(Qc, n_iter=10, rtol=1e-6)
        Qs, _ = fe.smooth_only(Qs, n_iter=10, rtol=1e-6)
    nc = _l2(fe._f(0, Qc)[0])
    ns = _l2(fe._f(0, Qs)[0])
    assert np.isfinite(nc) and np.isfinite(ns)
    assert nc < ns * 2.0


def test_fas_euler_rk2_smoother(setup):
    """tests/test_fas_euler.py::test_fas_euler_rk2_smoother on the port."""
    fe, pt = setup[2]["rk2"], setup[3]
    Q = fe.init_state(pt.P0)
    norms = []
    for _ in range(4):
        Q, _ = fe.cycle(Q, n_iter=10, rtol=1e-6)
        norms.append(_l2(fe._f(0, Q)[0]))
    assert np.isfinite(norms).all()
    assert norms[-1] < norms[0]
    _physical(fe, Q)
