"""Port parity of the matrix-free point-implicit solver
(`ibx_torch.solve.point_implicit`, `ibx_torch.solve.point_implicit_euler`)
against the JAX package's.

The two packages draw their Hutchinson probes from different generators, so
whole-step parity is held through the step's deterministic parts:
- the Hutchinson estimate is exact on row-local maps whatever the probes
  (the vector and 2x2 cases of tests/test_solve.py:33-48);
- `_block_inv` and `PIPreconditioner` on the same seeded blocks: 1e-5
  relative;
- `Linearization` (`torch.func.jvp`) against `jax.jvp` on the coupled map
  of tests/test_solve.py:50-84, and on the backward-Euler map ``g`` of
  `point_implicit_step` at the RAE2822 block fixture (wall_h=8e-2, 16,768
  cells; the JAX package's block tables and ghost families through
  `convert.tables_from_numpy`; the JAX side op by op: under ``jit`` XLA
  moves the JVP by 0.2-0.33 per channel near the limiter's kinks,
  `scripts/torch_solve_parity.py`): 2e-4 per channel. The limiter and the
  JST sensor take `ops.operators.abs_select` so that the derivative of
  ``|x|`` at 0 is JAX's;
- `solve` with the same map, right-hand side and inverse diagonal, with and
  without multigrid cycling: x within 1e-4 relative, the ratio too.

Then the reference's block-system test on the port and one port step on
the fixture (finite, the linear solve making progress). The step at nd = 3
is held in `tests/test_torch_point_implicit_3d.py`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ibx.cases import build_rae2822 as jx_build_rae2822
from ibx.ops import block_ops as jbo
from ibx.physics import fluid as jfluid
from ibx.solve import multigrid_levels as jx_levels
from ibx.solve import point_implicit as jpi

from ibx_torch.convert import state_from_numpy, stencil_from_numpy
from ibx_torch.ops import kernels as K
from ibx_torch.ops.block_ops import to_blocks, to_flat
from ibx_torch.physics.fluid import make_fluid
from ibx_torch.solve import (Linearization, Multigrid, PIPreconditioner,
                             hutchinson_block_diagonal, linearize,
                             point_implicit_step, solve)
from ibx_torch.solve.point_implicit import _block_inv
from ibx_torch.solve.point_implicit_euler import newton_map

from test_torch_block_ops_2d import perturbed, port_case
from test_torch_kernels import chan_err
from test_torch_stencil import st_np

torch.set_num_threads(2)
CFL = 5.0


def _rel(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


# -- Hutchinson on row-local maps -------------------------------------------

def test_hutchinson_diagonal_vector():
    """tests/test_solve.py::test_hutchinson_diagonal_vector on the port."""
    d = torch.linspace(1.0, 3.0, 32)
    est = hutchinson_block_diagonal(lambda x: d * x, torch.ones(32), 8)
    np.testing.assert_allclose(est.numpy(), d.numpy(), rtol=1e-5)


def test_hutchinson_block_diagonal_matrix():
    """tests/test_solve.py::test_hutchinson_block_diagonal_matrix on the
    port, with the default generator and with a caller's one."""
    rng = np.random.default_rng(1)
    B = _t(rng.normal(size=(16, 2, 2)))

    def f(X):
        return torch.einsum("nji,ni->nj", B, X)

    g = torch.Generator()
    g.manual_seed(123)
    for gen in (None, g):
        D = hutchinson_block_diagonal(f, torch.ones((16, 2)), 16,
                                      generator=gen)
        np.testing.assert_allclose(D.numpy(), B.numpy(), atol=1e-4)


# -- the preconditioner ------------------------------------------------------

def _blocks(N=512, k=4, seed=3):
    """Diagonally dominant seeded blocks, as the Newton blocks are."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(N, k, k)).astype(np.float32)
    D += (4.0 + rng.uniform(size=(N, 1, 1)) * 10.0) * np.eye(
        k, dtype=np.float32)
    return D * (10.0 ** rng.uniform(-2, 3, size=(N, 1, 1))).astype(
        np.float32)


@pytest.mark.parametrize("k", [2, 4])
def test_block_inv_and_preconditioner_match_ibx(k):
    D = _blocks(k=k)
    Dinv_j = np.asarray(jpi._block_inv(jnp.asarray(D)))
    Dinv = _block_inv(_t(D))
    assert _rel(Dinv_j, Dinv.numpy()) < 1e-5
    v = np.random.default_rng(4).normal(size=(D.shape[0], k)).astype(
        np.float32)
    pj = jpi.PIPreconditioner(jnp.asarray(Dinv_j))(jnp.asarray(v))
    pt = PIPreconditioner(_t(Dinv_j))(_t(v))
    assert _rel(pj, pt.numpy()) < 1e-5
    # the vector case is a product with the inverse diagonal
    pv = PIPreconditioner(_t(Dinv_j[:, 0, 0]))(_t(v[:, 0]))
    np.testing.assert_array_equal(pv.numpy(), (v[:, 0] * Dinv_j[:, 0, 0]))


# -- the coupled map of tests/test_solve.py:50-84 ----------------------------

def _coupled(seed=2, N=64, m=3):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(N, m, m)).astype(np.float32) * 0.1
    B += np.eye(m, dtype=np.float32) * 2.0
    x_true = rng.normal(size=(N, m)).astype(np.float32)
    return B, x_true


def _coupled_f(B, x_true, xp, einsum, roll):
    Bx = xp(B)
    xt = xp(x_true)
    b = einsum("nji,ni->nj", Bx, xt) + 0.1 * roll(xt)

    def f(X):
        y = einsum("nji,ni->nj", Bx, X)
        return y + 0.1 * roll(X) - b
    return f


def _jax_coupled():
    B, x_true = _coupled()
    return _coupled_f(B, x_true, jnp.asarray, jnp.einsum,
                      lambda a: jnp.roll(a, 1, axis=0))


def _port_coupled():
    B, x_true = _coupled()
    return _coupled_f(B, x_true, _t, torch.einsum,
                      lambda a: torch.roll(a, 1, dims=0))


def test_linearization_matches_jax_jvp_coupled():
    jf, tf = _jax_coupled(), _port_coupled()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    ref = jax.jvp(jf, (jnp.asarray(x),), (jnp.asarray(v),))[1]
    A = Linearization(tf, _t(x), tf(_t(x)))
    assert chan_err(np.asarray(ref), A(_t(v)).numpy()) < 2e-4


@pytest.mark.parametrize("mg", [False, True])
def test_solve_matches_ibx(mg):
    """`solve` against the JAX package's with the same map, right-hand
    side and inverse diagonal (the JAX package's estimate); with ``mg``
    through three multigrid levels of a random 2D cloud (the JAX package's
    tables)."""
    jf, tf = _jax_coupled(), _port_coupled()
    x0 = np.zeros((64, 3), np.float32)
    jA, jb, jprec = jpi.linearize(jf, jnp.asarray(x0),
                                  n_hutchinson_samples=30)
    A = Linearization(tf, _t(x0), tf(_t(x0)))
    prec = PIPreconditioner(_t(np.asarray(jprec.inverse_diagonal)))
    b = _t(np.asarray(jb))
    jmg = tmg = None
    if mg:
        X = np.random.default_rng(6).uniform(size=(64, 2)).astype(
            np.float32)
        jmg = jx_levels(X, 2)
        tmg = Multigrid(
            [stencil_from_numpy(st_np(c), "cpu") for c in jmg.coarseners],
            [stencil_from_numpy(st_np(p), "cpu") for p in jmg.prolongators])
    xj, rj = jpi.solve(jA, jb, jprec, n_iter=40, rtol=1e-5, multigrid=jmg)
    xt, rt = solve(A, b, prec, n_iter=40, rtol=1e-5, multigrid=tmg)
    assert _rel(xj, xt.numpy()) < 1e-4
    assert abs(float(rt) - float(rj)) < 1e-4 * abs(float(rj)) + 1e-7


def test_point_implicit_solves_block_system():
    """tests/test_solve.py::test_point_implicit_solves_block_system on the
    port."""
    f = _port_coupled()
    _, x_true = _coupled()
    A, rhs, prec = linearize(f, torch.zeros((64, 3)),
                             n_hutchinson_samples=30)
    x, ratio = solve(A, rhs, prec, n_iter=200, rtol=1e-5)
    assert float(ratio) < 1e-4
    np.testing.assert_allclose(x.numpy(), x_true, atol=1e-2)


# -- the Euler step ----------------------------------------------------------

def rae_case():
    """(JAX block case, its freeze mask, the port's tables, flat ghost BC
    and freeze mask) at wall_h=8e-2."""
    jx = jx_build_rae2822(wall_h=8e-2, feature_h=4e-2, cfl=0.7)
    tb, apply_bcs3, active3 = port_case(jx)

    def apply_bcs(P):
        return to_flat(tb, apply_bcs3(to_blocks(tb, P.clone())))

    active = np.asarray(jx.grid["active3"]).reshape(-1)
    return jx, jnp.asarray(active), tb, apply_bcs, _t(active)


@pytest.fixture(scope="module")
def rae():
    return rae_case()


def _jax_newton_map(jx, P, active, freeze_limiter):
    """``g`` and ``Qn`` of `ibx.solve.point_implicit_euler`'s step, line for
    line (the JAX package builds them inside the step)."""
    bt, fluid, apply_bcs = jx.grid["bt"], jx.fluid, jx.apply_bcs
    Qn = jfluid.primitive2state(fluid, jnp.asarray(P))
    Pb = apply_bcs(jfluid.physicality_guard(
        jfluid.state2primitive(fluid, Qn)))
    _, dt, frozen_n = jbo.euler_rhs_block(bt, fluid, Pb, with_dt=True,
                                          cfl=CFL)
    frozen = frozen_n if freeze_limiter else None

    def residual(Q):
        Pq = apply_bcs(jfluid.physicality_guard(
            jfluid.state2primitive(fluid, Q)))
        return jbo.euler_rhs_block(bt, fluid, Pq,
                                   frozen=frozen) * active[:, None]
    dt = dt * active + (1.0 - active)
    inv_dt = (1.0 / dt)[:, None]

    def g(Q):
        return (Q - Qn) * inv_dt - residual(Q)
    return g, Qn


@pytest.mark.parametrize("freeze_limiter", [False, True])
def test_linearization_matches_jax_jvp_euler(rae, freeze_limiter):
    """The JVP of the point-implicit map ``g`` at a perturbed state: 2e-4
    per channel; ``g`` itself too."""
    jx, jact, tb, apply_bcs, tact = rae
    P = perturbed(jx)
    jg, jQn = _jax_newton_map(jx, P, jact, freeze_limiter)
    rng = np.random.default_rng(9)
    scale = np.abs(np.asarray(jQn)).max(axis=0)
    v = (rng.normal(size=P.shape) * 1e-3 * scale).astype(np.float32)
    ref_g, ref_jvp = jax.jvp(jg, (jQn,), (jnp.asarray(v),))
    K.reset_launches()
    g, Qn = newton_map(tb, make_fluid(), *state_from_numpy(P, device="cpu"),
                       apply_bcs, cfl=CFL, active=tact,
                       freeze_limiter=freeze_limiter)
    out = Linearization(g, Qn, g(Qn))(_t(v))
    assert not any(K.launches.values())
    assert chan_err(np.asarray(jQn), Qn.numpy()) < 1e-6
    assert chan_err(np.asarray(ref_g), g(Qn).numpy()) < 2e-4
    assert chan_err(np.asarray(ref_jvp), out.numpy()) < 2e-4


def test_point_implicit_step_on_rae2822(rae):
    """One port step from a perturbed state at the reference's settings
    (tests/test_point_implicit_euler.py: cfl 5, relax 0.8, the freeze
    mask): finite, and the linear solve makes progress."""
    jx, _, tb, apply_bcs, tact = rae
    P, = state_from_numpy(perturbed(jx), device="cpu")
    P1, ratio = point_implicit_step(tb, make_fluid(), P, apply_bcs,
                                    cfl=CFL, active=tact, relax=0.8)
    assert P1.shape == P.shape and torch.isfinite(P1).all()
    assert float(ratio) < 1.0
