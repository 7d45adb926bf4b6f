"""Port parity of the physics on random states: transforms, guard, HLL
flux and both flow-BC families, `ibx_torch.physics` against `ibx.physics`
(rel 1e-6 per channel)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.physics import bc as jbc
from ibx.physics import fluid as jfl
from ibx.physics import flux as jfx

from ibx_torch.physics import bc as tbc
from ibx_torch.physics import fluid as tfl
from ibx_torch.physics import flux as tfx

from test_torch_kernels import chan_err

torch.set_num_threads(2)
N = 4096
P_INF = np.array([101325.0, 288.15, 102.1, 0.0, 0.0], np.float32)


def _states(seed, unphysical=False):
    rng = np.random.default_rng(seed)
    P = np.empty((N, 5), np.float32)
    P[:, 0] = 101325.0 * rng.uniform(0.5, 1.5, N)
    P[:, 1] = 288.15 * rng.uniform(0.5, 1.5, N)
    P[:, 2:] = rng.normal(0.0, 150.0, (N, 3))
    if unphysical:
        # trip every guard: negative p, huge T and |u|
        P[::7, 0] = -rng.uniform(1.0, 1e3, P[::7].shape[0])
        P[1::7, 1] = rng.uniform(3e4, 1e5, P[1::7].shape[0])
        P[2::7, 2:] *= 50.0
    return P


def _normals(seed):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(N, 3))
    return (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)


def _close(ref, out):
    assert chan_err(np.asarray(ref), out.numpy(), axis=-1) < 1e-6, \
        chan_err(np.asarray(ref), out.numpy(), axis=-1)


def test_transforms_and_guard():
    jf, tf = jfl.make_fluid(), tfl.make_fluid()
    P = _states(0)
    _close(jfl.speed_of_sound(jf, jnp.asarray(P[:, 1]))[:, None],
           tfl.speed_of_sound(tf, torch.tensor(P[:, 1]))[:, None])
    Q = np.asarray(jfl.primitive2state(jf, jnp.asarray(P)))
    _close(Q, tfl.primitive2state(tf, torch.tensor(P)))
    _close(jfl.state2primitive_guarded(jf, jnp.asarray(Q)),
           tfl.state2primitive_guarded(tf, torch.tensor(Q)))
    Pu = _states(1, unphysical=True)
    _close(jfl.physicality_guard(jnp.asarray(Pu)),
           tfl.physicality_guard(torch.tensor(Pu)))


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_hll_flux(dim):
    jf, tf = jfl.make_fluid(), tfl.make_fluid()
    PL, PR = _states(2), _states(3)
    _close(jfx.inviscid_fluxes_hll(jf, jnp.asarray(PL), jnp.asarray(PR), dim),
           tfx.inviscid_fluxes_hll(tf, torch.tensor(PL), torch.tensor(PR),
                                   dim))


@pytest.mark.parametrize("normal_flow", [False, True])
def test_flow_bc_families(normal_flow):
    """Farfield (characteristic switching) and slip wall (normal_flow)."""
    jf, tf = jfl.make_fluid(), tfl.make_fluid()
    Pinf = P_INF if not normal_flow else [101325.0, 288.15, 0.0]
    jb = jbc.flow_bc(jf, Pinf, normal_flow=normal_flow)
    tb = tbc.flow_bc(tf, Pinf, normal_flow=normal_flow, device="cpu")
    P, nrm = _states(4), _normals(5)
    # a few supersonic image states exercise the Mach switch
    P[::5, 2:] *= 4.0
    _close(jbc.apply_flow_bc(jb, jnp.asarray(P), jnp.asarray(nrm)),
           tbc.apply_flow_bc(tb, torch.tensor(P), torch.tensor(nrm)))
