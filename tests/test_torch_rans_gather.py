"""Port parity for RANS on the generic gather march
(`build_rae2822_rans(use_blocks=False)`, `solve.rans`'s ``rans_rhs`` /
``local_dt`` on `ops.operators` and `solve.euler.euler_rhs`, the family by
family `Domain.impose_bc` over (P, Rt)) against the JAX package on the
RANS airfoil at wall_h=8e-2, feature_h=4e-2, block_size=8 (16,768 cells);
and the port's block march against its gather march, 5 steps at the
reference's own bounds (tests/test_rans.py::
test_rans_block_path_matches_generic).

``rans_rhs`` and ``local_dt`` are closures of the step in both packages;
the test reads them from the step's closure cells. The JAX side runs
jitted. Measured (`scripts/torch_rans_parity.py`, CPU): R_flow 2.5e-6 per
channel scaled, dRt/dt 3.5e-7 of its max, dt 3.6e-7; one step P 4.5e-6
per channel against the jitted JAX step (1.5e-7 against its op-by-op
run), Rt 3.1e-7 of max|Rt|, resnorm equal; the port's block march vs its
gather march after 5 steps P 3.7e-7, Rt 8.1e-8."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ibx.cases.rae2822_rans import build_rae2822_rans as jx_build

from ibx_torch.cases import build_rae2822_rans
from ibx_torch.convert import state_from_numpy
from ibx_torch.ops import kernels as K

from test_torch_rans import SMALL, chan_err, perturbed_state, rel_max

torch.set_num_threads(2)


def closure_var(fn, name):
    """The value ``name`` that ``fn`` (or the function a `jax.jit`
    wraps) closes over."""
    fn = getattr(fn, "__wrapped__", fn)
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.fixture(scope="module")
def cases():
    jx = jx_build(use_blocks=False, **SMALL)
    pt = build_rae2822_rans(use_blocks=False, device="cpu", **SMALL)
    return jx, pt


def test_initial_state_matches(cases):
    """P0 / Rt0 against the JAX gather case's: < 2e-5."""
    jx, pt = cases
    assert chan_err(jx.P0, pt.P0.numpy()) < 2e-5
    assert rel_max(jx.Rt0, pt.Rt0.numpy()) < 2e-5


def test_gather_rhs_and_dt_match(cases):
    """The gather march's ``rans_rhs`` (dQ/dt, dRt/dt) and ``local_dt``:
    R_flow < 2e-4 per channel scaled (+1e-3), dRt/dt < 2e-4 of its max,
    dt rtol 1e-4."""
    jx, pt = cases
    P, Rt = perturbed_state(jx, seed=1)
    R_j, T_j = jax.jit(closure_var(jx.step, "rans_rhs"))(P, Rt)
    dt_j = jax.jit(closure_var(jx.step, "local_dt"))(P, Rt)
    Pt, Rtt = state_from_numpy(P, Rt, device="cpu")
    K.reset_launches()
    R_t, T_t = closure_var(pt.step, "rans_rhs")(Pt, Rtt)
    dt_t = closure_var(pt.step, "local_dt")(Pt, Rtt)
    assert not any(K.launches.values())
    assert chan_err(R_j, R_t.numpy(), floor=1e-3) < 2e-4
    assert rel_max(T_j, T_t.numpy()) < 2e-4
    np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j), rtol=1e-4)


def test_gather_step_matches(cases):
    """One `case.step` of the gather march: P < 1e-4 per channel, Rt <
    1e-3 of max|Rt|, resnorm rtol 1e-4; no kernel launched."""
    jx, pt = cases
    P, Rt = perturbed_state(jx, seed=2)
    Pj, Rj, rj = jx.step(jnp.asarray(P), jnp.asarray(Rt))
    K.reset_launches()
    Pp, Rp, rp = pt.step(*state_from_numpy(P, Rt, device="cpu"))
    assert not any(K.launches.values())
    assert chan_err(Pj, Pp.numpy()) < 1e-4
    assert rel_max(Rj, Rp.numpy()) < 1e-3
    assert abs(float(rp) - float(rj)) <= 1e-4 * abs(float(rj))


def test_block_march_matches_gather_march(cases):
    """The port's two marches, 5 steps from the initial state: P < 2e-4
    per channel, Rt < 2e-3 of max|Rt| (the bounds of tests/test_rans.py);
    `case.march` equals 5 `case.step` calls on both."""
    _, pg = cases
    pb = build_rae2822_rans(device="cpu", **SMALL)
    np.testing.assert_allclose(pb.P0.numpy(), pg.P0.numpy(), rtol=2e-5)
    Pb, Rb = pb.P0, pb.Rt0
    Pg, Rg = pg.P0, pg.Rt0
    for _ in range(5):
        Pb, Rb, _ = pb.step(Pb, Rb)
        Pg, Rg, _ = pg.step(Pg, Rg)
    assert chan_err(Pg.numpy(), Pb.numpy()) < 2e-4
    assert rel_max(Rg.numpy(), Rb.numpy()) < 2e-3
    for case, (P5, R5) in ((pb, (Pb, Rb)), (pg, (Pg, Rg))):
        Pm, Rm = case.march(case.P0, case.Rt0, 5)
        assert torch.equal(Pm, P5) and torch.equal(Rm, R5)
