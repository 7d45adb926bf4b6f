"""Port parity for RANS on the block march: `ibx_torch.solve.rans.
rans_rhs_grid` and one `case.step` of `ibx_torch.cases.build_rae2822_rans`
(device="cpu") against the JAX package's, on the RANS airfoil at
wall_h=8e-2, feature_h=4e-2, block_size=8 (16,768 cells) from a seeded
perturbed (P, Rt); the initial state; `wall_skin_friction` and `wall_cp`.

The JAX side runs its jitted step and a jitted `rans_rhs_grid`: op by op,
its first block step spends minutes in per-primitive compiles on the CPU.
Measured (`scripts/torch_rans_parity.py`, CPU): R_flow 2.4e-6 per channel
scaled, T3 3.2e-7 of max|T3|, dt 2.4e-7; one step P 7.0e-6 per channel
against the jitted JAX step (6.2e-7 against its op-by-op run; the two JAX
runs differ by the same 7.0e-6), Rt 2.7e-7 of max|Rt|, resnorm 3.0e-7;
P0 1.2e-7, Rt0 2.4e-7; Cf 6.0e-7, Cp 1.5e-8 absolute. No kernel is
launched: none lies on the RANS marches in either package."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ibx.cases.rae2822 import wall_cp as jx_wall_cp
from ibx.cases.rae2822_rans import build_rae2822_rans as jx_build
from ibx.cases.rae2822_rans import wall_skin_friction as jx_wall_cf
from ibx.ops import block_ops as jbo
from ibx.solve import rans as jrans
from ibx.topology.blocked_bc import _collect_families as jx_families
from ibx.topology.blocks import build_block_tables as jx_block_tables

from ibx_torch.cases import build_rae2822_rans, wall_cp, wall_skin_friction
from ibx_torch.convert import state_from_numpy, tables_from_numpy
from ibx_torch.ops import block_ops as bo
from ibx_torch.ops import kernels as K
from ibx_torch.solve.rans import rans_rhs_grid

torch.set_num_threads(2)
SMALL = dict(wall_h=8e-2, feature_h=4e-2, block_size=8)
NAMES = ["farfield", "wall"]


def ibx_fields(bt):
    """The JAX package's BlockTables fields as numpy arrays."""
    return {f.name: jax.tree_util.tree_map(np.asarray, getattr(bt, f.name))
            for f in dataclasses.fields(bt)}


def chan_err(ref, out, floor=0.0):
    """Max |out - ref| per channel (last axis) over that channel's max
    |ref| (+ ``floor``); an all-zero channel is held to its absolute
    error."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    ref, out = ref.reshape(-1, ref.shape[-1]), out.reshape(-1, ref.shape[-1])
    scale = np.abs(ref).max(axis=0) + floor
    scale = np.where(scale > 0, scale, 1.0)
    return float((np.abs(out - ref).max(axis=0) / scale).max())


def rel_max(ref, out):
    """Max |out - ref| over max |ref|."""
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(out, np.float64) - ref).max()
                 / np.abs(ref).max())


def perturbed_state(case, seed=0):
    """(P, Rt) as numpy: the case's initial state with a smooth
    perturbation and noise in u and v, and an eddy viscosity of 1 to 20
    times the freestream seed."""
    rng = np.random.default_rng(seed)
    P = np.array(case.P0, np.float32)
    x, y = case.dom.centers[:, 0], case.dom.centers[:, 1]
    P[:, 0] *= 1.0 + 0.05 * np.sin(x) * np.cos(y)
    P[:, 1] *= 1.0 + 0.02 * np.cos(x)
    P[:, 2] += 20.0 * np.sin(y) + 5.0 * rng.standard_normal(P.shape[0])
    P[:, 3] += 10.0 * np.cos(x) + 5.0 * rng.standard_normal(P.shape[0])
    Rt = case.Rt_inf * (1.0 + 19.0 * rng.uniform(size=P.shape[0]))
    return P.astype(np.float32), Rt.astype(np.float32)


@pytest.fixture(scope="module")
def cases():
    jx = jx_build(**SMALL)
    pt = build_rae2822_rans(device="cpu", **SMALL)
    return jx, pt


def test_signature_matches_ibx():
    """Same parameters, names and defaults as the JAX builder, plus
    ``device="cuda"``."""
    ref = inspect.signature(jx_build).parameters
    out = inspect.signature(build_rae2822_rans).parameters
    assert list(out)[:-1] == list(ref) and list(out)[-1] == "device"
    assert out["device"].default == "cuda"
    for name, p in ref.items():
        assert out[name].default == p.default, name


def test_initial_state_matches(cases):
    """P0 / Rt0 (the freestream through the sequential `impose_bc` wall
    functions) against the JAX case's: < 2e-5; the case's constants."""
    jx, pt = cases
    assert pt.dom.ncells == jx.dom.ncells == 16_768
    assert chan_err(jx.P0, pt.P0.numpy()) < 2e-5
    assert rel_max(jx.Rt0, pt.Rt0.numpy()) < 2e-5
    np.testing.assert_allclose(pt.Rt_inf, jx.Rt_inf, rtol=1e-6)
    np.testing.assert_allclose(pt.fluid.mu_ref, float(jx.fluid.mu_ref),
                               rtol=1e-6)
    np.testing.assert_array_equal(pt.P_inf, jx.P_inf)


def test_rans_rhs_grid_matches(cases):
    """`rans_rhs_grid` on the fused state, the same tables in both
    packages: R_flow < 2e-4 per channel scaled (+1e-3, the RHS tolerance
    of tests/test_block_ops.py), T3 < 2e-4 of max|T3|, dt rtol 1e-4."""
    jx, pt = cases
    jbt = jx_block_tables(jx.dom)
    tb, _ = tables_from_numpy(ibx_fields(jbt), jx_families(jx.dom, NAMES),
                              NAMES, "cpu")
    P, Rt = perturbed_state(jx)
    S = np.concatenate([P, Rt[:, None]], axis=1)
    R_j, T_j, dt_j = jax.jit(
        lambda bt, S3: jrans.rans_rhs_grid(bt, jx.fluid, S3, cfl=0.5))(
            jbt, jbo.to_blocks(jbt, jnp.asarray(S)))
    K.reset_launches()
    R_t, T_t, dt_t = rans_rhs_grid(tb, pt.fluid,
                                   bo.to_blocks(tb, torch.as_tensor(S)),
                                   cfl=0.5)
    assert not any(K.launches.values())
    assert chan_err(R_j, R_t.numpy(), floor=1e-3) < 2e-4
    assert rel_max(T_j, T_t.numpy()) < 2e-4
    np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j), rtol=1e-4)
    assert np.abs(np.asarray(T_j)).max() > 0


def test_block_step_matches(cases):
    """One `case.step` of the block march from the perturbed state: P <
    1e-4 per channel, Rt < 1e-3 of max|Rt|, resnorm rtol 1e-4; no kernel
    launched, the inputs left as they were."""
    jx, pt = cases
    P, Rt = perturbed_state(jx)
    Pj, Rj, rj = jx.step(jnp.asarray(P), jnp.asarray(Rt))
    Pt, Rtt = state_from_numpy(P, Rt, device="cpu")
    K.reset_launches()
    Pp, Rp, rp = pt.step(Pt, Rtt)
    assert not any(K.launches.values())
    assert Pp.shape == P.shape and Rp.shape == Rt.shape
    assert chan_err(Pj, Pp.numpy()) < 1e-4
    assert rel_max(Rj, Rp.numpy()) < 1e-3
    assert abs(float(rp) - float(rj)) <= 1e-4 * abs(float(rj))
    assert np.array_equal(Pt.numpy(), P) and np.array_equal(Rtt.numpy(), Rt)


def test_wall_skin_friction_and_cp_match(cases):
    """`wall_skin_friction` and `wall_cp` (reused from the Euler case) on
    one state: rtol 1e-5 (Cp also within 1e-5 absolute, it is O(1))."""
    jx, pt = cases
    P, _ = perturbed_state(jx)
    cf_j = jx_wall_cf(jx, jnp.asarray(P))
    cf_t = wall_skin_friction(pt, torch.as_tensor(P))
    assert cf_t.dtype == np.float32 and np.isfinite(cf_t).all()
    np.testing.assert_allclose(cf_t, cf_j, rtol=1e-5)
    np.testing.assert_allclose(wall_cp(pt, torch.as_tensor(P)),
                               jx_wall_cp(jx, jnp.asarray(P)),
                               rtol=1e-5, atol=1e-5)
