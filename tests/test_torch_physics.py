"""Port parity of the physics on random states: transforms, guard,
transport laws, the HLL flux (integer and normal-vector ``dim``), the
dissipative flux, the sensors, the viscous fluxes (integer and
normal-vector ``dim``, flat and grid layouts) and both flow-BC families,
`ibx_torch.physics` against `ibx.physics` (rel 1e-6 per channel), and the
Couette value of tests/test_physics.py."""

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


def test_state2primitive_and_transport():
    """`state2primitive` (unguarded), Sutherland-style viscosity (2/3
    exponent) and the polynomial conductivity, also with another fluid."""
    P = _states(6)
    for kw in ({}, dict(k=0.03, mu_ref=2e-5, T_ref=300.0, S=120.0)):
        jf, tf = jfl.make_fluid(**kw), tfl.make_fluid(**kw)
        Q = np.asarray(jfl.primitive2state(jf, jnp.asarray(P)))
        _close(jfl.state2primitive(jf, jnp.asarray(Q)),
               tfl.state2primitive(tf, torch.tensor(Q)))
        T = P[:, 1:2]
        T[::9] = 3.0                                  # under the 10 K clamp
        _close(jfl.dynamic_viscosity(jf, jnp.asarray(T)),
               tfl.dynamic_viscosity(tf, torch.tensor(T)))
        _close(jfl.heat_conductivity(jf, jnp.asarray(T)),
               tfl.heat_conductivity(tf, torch.tensor(T)))
    f = tfl.make_fluid()
    np.testing.assert_allclose(
        float(tfl.dynamic_viscosity(f, torch.tensor(273.15))), 1.716e-5,
        rtol=1e-6)
    np.testing.assert_allclose(
        float(tfl.heat_conductivity(f, torch.tensor(300.0))),
        0.00646 + 6.468e-5 * 300.0, rtol=1e-5)


def test_hll_flux_normal_matrix():
    """``dim`` as a [N, nd] tensor of unit normals, with and without the
    Einfeldt ``fix``; an axis normal reproduces the integer form."""
    jf, tf = jfl.make_fluid(), tfl.make_fluid()
    PL, PR, n = _states(7), _states(8), _normals(9)
    fix = np.random.default_rng(10).uniform(size=(N, 1)).astype(np.float32)
    for kj, kt in (({}, {}), (dict(fix=jnp.asarray(fix)),
                              dict(fix=torch.tensor(fix)))):
        _close(jfx.inviscid_fluxes_hll(jf, jnp.asarray(PL), jnp.asarray(PR),
                                       jnp.asarray(n), **kj),
               tfx.inviscid_fluxes_hll(tf, torch.tensor(PL), torch.tensor(PR),
                                       torch.tensor(n), **kt))
    ex = np.zeros((N, 3), np.float32)
    ex[:, 1] = 1.0
    a = tfx.inviscid_fluxes_hll(tf, torch.tensor(PL), torch.tensor(PR),
                                torch.tensor(ex))
    b = tfx.inviscid_fluxes_hll(tf, torch.tensor(PL), torch.tensor(PR), 1)
    assert chan_err(b.numpy(), a.numpy(), axis=-1) < 1e-6


@pytest.mark.parametrize("dim", [0, 2, "normals"])
def test_dissipative_flux_and_alias(dim):
    """Central flux + sensor-scaled dissipation, array and scalar sensors;
    `inviscid_fluxes` dispatches on arity as in the JAX package."""
    jf, tf = jfl.make_fluid(), tfl.make_fluid()
    PL, PR = _states(11), _states(12)
    rng = np.random.default_rng(13)
    nuL = rng.uniform(size=N).astype(np.float32)
    nuR = rng.uniform(size=N).astype(np.float32)
    dj = jnp.asarray(_normals(14)) if dim == "normals" else dim
    dt_ = torch.tensor(_normals(14)) if dim == "normals" else dim
    a = [jnp.asarray(PL), jnp.asarray(PR)]
    b = [torch.tensor(PL), torch.tensor(PR)]
    _close(jfx.inviscid_fluxes_dissipative(jf, *a, jnp.asarray(nuL),
                                           jnp.asarray(nuR), dj),
           tfx.inviscid_fluxes_dissipative(tf, *b, torch.tensor(nuL),
                                           torch.tensor(nuR), dt_))
    _close(jfx.inviscid_fluxes(jf, *a, 0.3, 0.1, dj),
           tfx.inviscid_fluxes(tf, *b, 0.3, 0.1, dt_))
    _close(jfx.inviscid_fluxes(jf, *a, dj), tfx.inviscid_fluxes(tf, *b, dt_))
    with pytest.raises(TypeError):
        tfx.inviscid_fluxes(tf, *b, 0.3, dt_)


def test_sensors():
    """`jst_sensor_3pt` and `shock_sensor` (2D and 3D gradient tensors),
    and the limits of tests/test_physics.py::test_sensors."""
    rng = np.random.default_rng(15)
    a, b, c = (rng.uniform(0.5, 2.0, N).astype(np.float32) for _ in range(3))
    ref = jfx.jst_sensor_3pt(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    out = tfx.jst_sensor_3pt(torch.tensor(a), torch.tensor(b),
                             torch.tensor(c))
    _close(ref[:, None], out[:, None])
    for nd in (2, 3):
        g = [[rng.standard_normal(N).astype(np.float32) for _ in range(nd)]
             for _ in range(nd)]
        ref = jfx.shock_sensor([[jnp.asarray(x) for x in r] for r in g])
        out = tfx.shock_sensor([[torch.tensor(x) for x in r] for r in g])
        _close(ref[:, None], out[:, None])
    one, zero = torch.ones(4), torch.zeros(4)
    np.testing.assert_allclose(
        tfx.shock_sensor(((one, zero), (zero, one))).numpy(), 1.0)
    assert float(tfx.shock_sensor(((zero, -one), (one, zero))).max()) < 1e-5
    s = float(tfx.jst_sensor_3pt(torch.tensor(1.0), torch.tensor(2.0),
                                 torch.tensor(1.0)))
    np.testing.assert_allclose(s, 1.0, rtol=1e-5)


@pytest.mark.parametrize("dim", [0, 1, 2, "normals"])
@pytest.mark.parametrize("mu_t", ["zero", "scalar", "field"])
def test_viscous_fluxes(dim, mu_t):
    """Flat [N, 5] and grid [16, 16, 16, 5] layouts."""
    jf, tf = jfl.make_fluid(), tfl.make_fluid()
    rng = np.random.default_rng(16)
    P = _states(17)
    G = [(rng.standard_normal(P.shape) * [50.0, 5.0, 30.0, 30.0, 30.0])
         .astype(np.float32) for _ in range(3)]
    n = _normals(18)
    mu = {"zero": 0.0, "scalar": 2e-4,
          "field": rng.uniform(0, 1e-3, N).astype(np.float32)}[mu_t]
    for shape in ((N,), (16, 16, 16)):
        r = lambda a: a.reshape(shape + a.shape[1:])     # noqa: E731
        dj = jnp.asarray(r(n)) if dim == "normals" else dim
        dt_ = torch.tensor(r(n)) if dim == "normals" else dim
        mj = jnp.asarray(r(mu)) if mu_t == "field" else mu
        mt = torch.tensor(r(mu)) if mu_t == "field" else mu
        ref = jfx.viscous_fluxes(jf, jnp.asarray(r(P)),
                                 [jnp.asarray(r(g)) for g in G], dj, mu_t=mj)
        out = tfx.viscous_fluxes(tf, torch.tensor(r(P)),
                                 [torch.tensor(r(g)) for g in G], dt_,
                                 mu_t=mt)
        assert out.shape == shape + (5,)
        _close(ref, out)


def test_viscous_fluxes_couette():
    """tests/test_physics.py::test_viscous_fluxes_couette on the port: pure
    shear du/dy = s gives F_x through y-faces = mu * s, energy tau * u."""
    f = tfl.make_fluid()
    T, s = 288.15, 50.0
    P = torch.tensor([[1.0e5, T, 10.0, 0.0]])
    grad_y = torch.tensor([[0.0, 0.0, s, 0.0]])
    F = tfx.viscous_fluxes(f, P, (torch.zeros((1, 4)), grad_y), 1).numpy()
    mu = float(tfl.dynamic_viscosity(f, torch.tensor(T)))
    np.testing.assert_allclose(F[0, 2], mu * s, rtol=1e-5)
    np.testing.assert_allclose(F[0, 1], mu * s * 10.0, rtol=1e-5)
