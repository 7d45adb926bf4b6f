"""Port parity on the bs=4 sphere case: the ghost BC, the initial state,
one RK2 step and a 5-step march of `ibx_torch.cases.build_sphere3d`
(device="cpu", kernels on their plain versions) against the JAX package's
case, and the gather branch (``use_blocks=False``) against the JAX
package's and against the port's grid march."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.cases import build_sphere3d as jx_build_sphere3d
from ibx.ops import pallas_rhs as pr
from ibx.ops.block_ops import to_blocks
from ibx.physics.fluid import physicality_guard as jx_guard
from ibx.topology.blocked_bc import _collect_families

from ibx_torch.cases import build_sphere3d
from ibx_torch.cases.sphere3d import gather_case
from ibx_torch.convert import tables_from_numpy
from ibx_torch.physics.fluid import physicality_guard

from test_torch_kernels import FAMILIES, chan_err, ibx_fields, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cases():
    jx = jx_build_sphere3d(wall_h=0.25, block_size=4)
    pt = build_sphere3d(wall_h=0.25, block_size=4, device="cpu")
    assert pt.dom.ncells == jx.dom.ncells == 18432
    return jx, pt


def _perturbed_flat(case):
    """Smooth + random perturbation of the JAX case's initial state."""
    rng = np.random.default_rng(11)
    P = np.array(case.P0, np.float32)
    x = case.dom.centers
    P[:, 0] *= 1 + 0.05 * np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    P[:, 1] *= 1 + 0.03 * np.cos(1.5 * x[:, 2])
    P[:, 2] += 30 * np.sin(x[:, 1] + x[:, 2])
    P[:, 3] += 25 * np.cos(x[:, 0]) * np.sin(x[:, 2])
    P[:, 4] += 20 * rng.standard_normal(P.shape[0])
    return P.astype(np.float32)


def test_ghost_bc_matches_blocked_bc(cases):
    """GhostBC.apply_cs vs BlockedBC.cs on the same tables and state:
    2e-5 per channel (as test_blocked_bc.py); other cells untouched."""
    jx, pt = cases
    bt, bbc = jx.grid["bt"], jx.grid["bbc"]
    tb, bc = tables_from_numpy(ibx_fields(bt),
                               _collect_families(jx.dom, FAMILIES),
                               FAMILIES, "cpu")
    Pc = np.asarray(pr.cs_split(bt, to_blocks(bt, jnp.asarray(
        _perturbed_flat(jx)))))
    ref = np.asarray(bbc.cs(jnp.asarray(Pc), jx.grid["bc_fns"],
                            guard=jx_guard))
    out = bc.apply_cs(t(Pc), pt.bc_fns, guard=physicality_guard).numpy()
    assert chan_err(ref, out) < 2e-5, chan_err(ref, out)
    ghost = np.zeros(Pc.shape[0] * 64, bool)
    ghost[_collect_families(jx.dom, FAMILIES)["ghosts"]] = True
    keep = ~ghost.reshape(Pc.shape[0], 1, 4, 16).repeat(5, axis=1)
    assert np.array_equal(out[keep], Pc[keep])


def test_initial_state_matches(cases):
    jx, pt = cases
    ref = np.asarray(jx.P0)
    assert chan_err(ref, pt.P0.numpy()) < 2e-5


def test_step_matches_rk2_step_cs(cases):
    """One port step vs `rk2_step_cs` + `BlockedBC.cs`: < 1e-4 per
    channel; resnorm to 1e-4 relative."""
    jx, pt = cases
    bt, bbc, fns = jx.grid["bt"], jx.grid["bbc"], jx.grid["bc_fns"]
    P = _perturbed_flat(jx)
    active_cs = pr.cs_split(bt, jx.grid["active3"][..., None])
    ref, res_ref = pr.rk2_step_cs(
        bt, jx.fluid, pr.cs_split(bt, to_blocks(bt, jnp.asarray(P))),
        lambda Pc: bbc.cs(Pc, fns, guard=jx_guard), cfl=0.7,
        active_cs=active_cs)
    ref = np.asarray(pr.cs_merge(bt, ref)).reshape(-1, 5)
    out, res = pt.step(t(P))
    assert chan_err(ref, out.numpy()) < 1e-4, chan_err(ref, out.numpy())
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))


def test_march5_matches_case_march(cases):
    """5 steps from the JAX case's initial state vs its `march` (the XLA
    grid path at bs=4): < 1e-3 per channel (as test_block_ops.py)."""
    jx, pt = cases
    ref = np.asarray(jx.march(jx.P0, 5))
    out = pt.march(t(np.asarray(jx.P0)), 5).numpy()
    assert np.isfinite(out).all()
    assert chan_err(ref, out) < 1e-3, chan_err(ref, out)


@pytest.fixture(scope="module")
def gather():
    jx = jx_build_sphere3d(wall_h=0.25, block_size=4, use_blocks=False)
    pt = build_sphere3d(wall_h=0.25, block_size=4, use_blocks=False,
                        device="cpu")
    return jx, pt


def test_gather_case_matches(cases, gather):
    """``use_blocks=False`` at nd = 3: initial state 2e-5, one step from a
    perturbed state 1e-4 with its resnorm, 3 steps of `case.march` 1e-3
    against the JAX gather case, and under 1e-3 against the port's own grid
    march; no kernel launch is counted and the block-only options raise."""
    from ibx_torch.ops import kernels as K

    _, blk = cases
    jx, pt = gather
    assert pt.bt is None and jx.grid is None
    assert pt.dom.partitions[0].acc_left[2].width == 4
    assert chan_err(np.asarray(jx.P0), pt.P0.numpy()) < 2e-5
    P = _perturbed_flat(jx)
    ref, res_ref = jx.step(jnp.asarray(P))
    K.reset_launches()
    out, res = pt.step(t(P))
    assert chan_err(ref, out.numpy()) < 1e-4, chan_err(ref, out.numpy())
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))
    ref = np.asarray(jx.march(jx.P0, 3))
    out = pt.march(t(np.asarray(jx.P0)), 3).numpy()
    assert chan_err(ref, out) < 1e-3, chan_err(ref, out)
    assert not any(K.launches.values())
    grid = blk.march(t(np.asarray(jx.P0)), 3, grid=True).numpy()
    assert chan_err(grid, out) < 1e-3, chan_err(grid, out)
    with pytest.raises(ValueError, match="block marches"):
        pt.step(pt.P0, grid=True)


def test_gather_case_of_a_block_case(gather):
    """`gather_case` of a block case is what ``use_blocks=False`` builds:
    the same Domain, a bit-equal solved mask and initial state, and a
    bit-equal step."""
    _, pt = gather
    blk = build_sphere3d(wall_h=0.25, block_size=4, device="cpu")
    g = gather_case(blk)
    assert g.dom is blk.dom and g.bt is None and blk.bt is not None
    assert torch.equal(g.active, pt.active) and torch.equal(g.P0, pt.P0)
    P = t(_perturbed_flat(pt))
    (a, ra), (b, rb) = g.step(P), pt.step(P)
    assert torch.equal(a, b) and float(ra) == float(rb)
    assert gather_case(g) is g
