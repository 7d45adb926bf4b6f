"""Port parity for the RANS physics: `ibx_torch.physics.turbulence`,
`ibx_torch.physics.ibl`, the rest of `ibx_torch.physics.fluid`
(`reynolds_number`, `adjust_reynolds`, `isa_atmosphere`,
`streamwise_direction`, `TimeAverage`) and the wall-model arguments of
`ibx_torch.physics.bc.apply_flow_bc`, against the JAX package on the same
seeded numpy inputs; and the port's version of the reference's wall-model
pipeline (tests/test_viscous.py::test_wall_model_pipeline) on the same
channel mesh in both packages.

Tolerances: rtol 1e-5 for the wall function (y+ from 1e-2 to 1e4), the
closures and the pipeline, with a floor of 1e-7 of each array's largest
value (see `close`); rtol 1e-6 for the fluid helpers and the wall-model
BC."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.physics import bc as jbc
from ibx.physics import fluid as jfl
from ibx.physics import ibl as jibl
from ibx.physics import turbulence as jtu

from ibx_torch.physics import bc as pbc
from ibx_torch.physics import fluid as pfl
from ibx_torch.physics import ibl as pibl
from ibx_torch.physics import turbulence as ptu

torch.set_num_threads(2)
RTOL = 1e-5


def f32(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def close(ref, out, rtol=RTOL, atol=0.0):
    """Every array of ``ref`` (a JAX result, tuple or dict of them)
    against ``out`` (the port's), elementwise to ``rtol``. An element also
    passes within 1e-7 of its array's max |ref|: where y+ is 1e-2,
    ``1 - exp(-y+/A)`` cancels and the two libraries' exp differ in the
    last bit (1.9e-15 on a mu_t of 1.8e-14, next to 0.08 in the same
    array)."""
    if isinstance(ref, dict):
        assert set(ref) == set(out)
        for k in ref:
            close(ref[k], out[k], rtol, atol)
        return
    if isinstance(ref, tuple):
        assert type(ref).__name__ == type(out).__name__
        for r, o in zip(ref, out):
            close(r, o, rtol, atol)
        return
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    atol = max(atol, 1e-7 * float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


def both(a):
    return jnp.asarray(a), torch.as_tensor(a)


def test_wall_function_over_yplus():
    """`wall_function` (and through it `wall_function_units` and
    `von_karman`) over y+ from 1e-2 to 1e4: Rey = u y / nu from 1e-4 to
    3e5."""
    rng = np.random.default_rng(0)
    n = 400
    y = (10.0 ** rng.uniform(-5, -1, n)).astype(np.float32)
    nu = np.float32(1.5e-5) * (1 + 0.1 * f32(rng, n))
    rey = (10.0 ** np.linspace(-4, 5.5, n)).astype(np.float32)
    u = (rey * nu / y).astype(np.float32)
    ref = jtu.wall_function(*(jnp.asarray(a) for a in (y, u, nu)))
    out = ptu.wall_function(*(torch.as_tensor(a) for a in (y, u, nu)))
    close(ref, out)
    yp = out.u_tau.numpy() * y / nu
    assert yp.min() < 2e-2 and yp.max() > 1e4
    units = ptu.wall_function_units(torch.as_tensor(rey), n_iter=7,
                                    omega_fixed_point=0.6)
    close(jtu.wall_function_units(jnp.asarray(rey), n_iter=7,
                                  omega_fixed_point=0.6), units)
    yj, yt = both(10.0 ** np.linspace(-2, 4, 50).astype(np.float32))
    close(jtu.von_karman(yj, kappa=0.4, C=5.0),
          ptu.von_karman(yt, kappa=0.4, C=5.0))


def test_closures():
    """`shear_rate`, `smagorinsky_nu_sgs`, `standard_k_epsilon`,
    `wray_agarwal` (its 10 R cap active on part of the rows),
    `ducros_sensor` in 2D and 3D, `wale_nu_sgs`, and their ValueErrors."""
    rng = np.random.default_rng(1)
    N = 256
    g2 = [[f32(rng, N, lo=-50, hi=50) for _ in range(2)] for _ in range(2)]
    g3 = [[f32(rng, N, lo=-50, hi=50) for _ in range(3)] for _ in range(3)]
    J2 = [[jnp.asarray(a) for a in r] for r in g2]
    T2 = [[torch.as_tensor(a) for a in r] for r in g2]
    J3 = [[jnp.asarray(a) for a in r] for r in g3]
    T3 = [[torch.as_tensor(a) for a in r] for r in g3]
    Sj, St = jtu.shear_rate(J2), ptu.shear_rate(T2)
    close(Sj, St)
    close(jtu.shear_rate(J3), ptu.shear_rate(T3))
    dj, dt = both(f32(rng, N, lo=1e-3, hi=1e-1))
    close(jtu.smagorinsky_nu_sgs(dj, Sj, Cs=0.2),
          ptu.smagorinsky_nu_sgs(dt, St, Cs=0.2))
    kj, kt = both(f32(rng, N, lo=0.1, hi=10.0))
    ej, et = both(f32(rng, N, lo=1.0, hi=100.0))
    close(jtu.standard_k_epsilon(kj, ej, Sj),
          ptu.standard_k_epsilon(kt, et, St))
    Rj, Rt = both(f32(rng, N, lo=0.0, hi=1e-2))
    gR = f32(rng, N, 2, lo=-1.0, hi=1.0)
    gS = f32(rng, N, 2, lo=-1e4, hi=1e4)
    wa_j = jtu.wray_agarwal(Rj, Sj, jnp.asarray(gR), jnp.asarray(gS))
    wa_t = ptu.wray_agarwal(Rt, St, torch.as_tensor(gR), torch.as_tensor(gS))
    close(wa_j, wa_t)
    capped = np.asarray(wa_j["S"]) == 10.0 * np.asarray(Rj)
    assert 0 < capped.mean() < 1
    close(jtu.ducros_sensor(J2), ptu.ducros_sensor(T2))
    close(jtu.ducros_sensor(J3), ptu.ducros_sensor(T3))
    close(jtu.wale_nu_sgs(dj, J3), ptu.wale_nu_sgs(dt, T3))
    with pytest.raises(ValueError):
        ptu.wale_nu_sgs(dt, T2)
    with pytest.raises(ValueError):
        ptu.ducros_sensor([[T2[0][0]]])


@pytest.mark.parametrize("pg", ["none", "field"])
def test_ibl(pg):
    """`white_H`, `white_Cf`, `theta_closure` and `m_closure` (with a
    scalar density, and with a pressure-gradient field and a density
    field)."""
    rng = np.random.default_rng(2)
    N = 300
    Lam = f32(rng, N, lo=-6e-3, hi=6e-3)
    Re = (10.0 ** rng.uniform(1.5, 6.5, N)).astype(np.float32)
    close(jibl.white_H(jnp.asarray(Lam), jnp.asarray(Re)),
          pibl.white_H(torch.as_tensor(Lam), torch.as_tensor(Re)))
    close(jibl.white_Cf(jnp.asarray(Lam), jnp.asarray(Re)),
          pibl.white_Cf(torch.as_tensor(Lam), torch.as_tensor(Re)))
    theta = f32(rng, N, lo=1e-4, hi=3e-3)
    vel = np.stack([f32(rng, N, lo=20, hi=60), f32(rng, N, lo=-5, hi=5)], 1)
    kw_j, kw_t = {}, {}
    if pg == "field":
        grad = f32(rng, N, 2, lo=-2e3, hi=2e3)
        rho = f32(rng, N, lo=0.8, hi=1.3)
        kw_j = dict(pressure_gradient=jnp.asarray(grad), rho=jnp.asarray(rho))
        kw_t = dict(pressure_gradient=torch.as_tensor(grad),
                    rho=torch.as_tensor(rho))
    st_j = jibl.theta_closure(jnp.asarray(theta), jnp.asarray(vel), 1.5e-5,
                              **kw_j)
    st_t = pibl.theta_closure(torch.as_tensor(theta), torch.as_tensor(vel),
                              1.5e-5, **kw_t)
    close(st_j, st_t)
    m = np.asarray(st_j.m)
    close(jibl.m_closure(jnp.asarray(m), jnp.asarray(vel), 1.5e-5, **kw_j),
          pibl.m_closure(torch.as_tensor(m), torch.as_tensor(vel), 1.5e-5,
                         **kw_t))


def test_fluid_helpers():
    """`reynolds_number`, `adjust_reynolds` (the RANS cases' mu_ref),
    `isa_atmosphere` in every layer, `streamwise_direction` and
    `TimeAverage` with a scalar and a per-channel dt: rtol 1e-6."""
    jf, pf = jfl.make_fluid(), pfl.make_fluid()
    for P in ([101325.0, 288.15, 235.0, 9.5], [1.0e5, 288.15, 100.0, 0.0],
              [2.2e4, 216.65, 70.0, 0.0, 3.0]):
        P = np.asarray(P, np.float32)
        np.testing.assert_allclose(float(pfl.reynolds_number(pf, P, 1.3)),
                                   float(jfl.reynolds_number(jf, P, 1.3)),
                                   rtol=1e-6)
        for Re in (6.5e6, 5e6, 6e5):
            a = jfl.adjust_reynolds(jf, P, 1.0, Re)
            b = pfl.adjust_reynolds(pf, P, 1.0, Re)
            np.testing.assert_allclose(b.mu_ref, float(a.mu_ref), rtol=1e-6)
            assert (b.R, b.gamma, b.T_ref, b.S) == (pf.R, pf.gamma, pf.T_ref,
                                                    pf.S)
            np.testing.assert_allclose(
                float(pfl.reynolds_number(b, P, 1.0)), Re, rtol=1e-5)
    for h, kw in ((0.0, dict(Mach=0.5, direction=[1.0, 0.0])),
                  (5000.0, dict(dT=10.0, V=200.0, direction=[1.0, 0.2, 0.1])),
                  (11000.0, {}), (25000.0, dict(Mach=2.0)),
                  (40000.0, {}), (49000.0, {}), (60000.0, {}),
                  (80000.0, dict(dT=-5.0))):
        fj, Pj = jfl.isa_atmosphere(h, **kw)
        fp, Pp = pfl.isa_atmosphere(h, **kw)
        assert Pp.dtype == np.float32
        np.testing.assert_allclose(Pp, Pj, rtol=1e-6)
        assert fp == pf
    with pytest.raises(ValueError):
        pfl.isa_atmosphere(-1.0)
    for args in ((2.31,), (3.0, 1.5), (-4.0, 0.0)):
        np.testing.assert_array_equal(pfl.streamwise_direction(*args),
                                      jfl.streamwise_direction(*args))
    rng = np.random.default_rng(3)
    ta_j, ta_t = jfl.TimeAverage(5.0), pfl.TimeAverage(5.0)
    for i in range(6):
        Q = f32(rng, 40, 4, lo=0, hi=10)
        dt = 0.5 if i % 2 else f32(rng, 4, lo=0.1, hi=1.0)
        mj = ta_j.push(Q, dt)
        mt = ta_t.push(torch.as_tensor(Q), torch.as_tensor(dt))
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6)
        np.testing.assert_allclose(ta_t.sigma.numpy(),
                                   np.asarray(ta_j.sigma), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["wall_model", "transpiration",
                                  "farfield_wall_model"])
def test_apply_flow_bc_wall_model(mode):
    """`apply_flow_bc` with ``du_dn`` + ``image_distances`` (slip wall and
    characteristic farfield) and with ``transpiration``, through
    `FlowBC.__call__` and the function: rtol 1e-6; either wall-model
    argument alone raises."""
    rng = np.random.default_rng(4)
    G = 500
    jf, pf = jfl.make_fluid(), pfl.make_fluid()
    P = np.stack([f32(rng, G, lo=9e4, hi=1.1e5), f32(rng, G, lo=250, hi=320),
                  f32(rng, G, lo=-300, hi=300), f32(rng, G, lo=-300, hi=300)],
                 1)
    ang = f32(rng, G, lo=0, hi=2 * np.pi)
    nrm = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
    if mode == "farfield_wall_model":
        Pinf = [101325.0, 288.15, 240.0, 9.0]
        bj = jbc.flow_bc(jf, Pinf)
        bt = pbc.flow_bc(pf, Pinf, device="cpu")
    else:
        bj = jbc.flow_bc(jf, [101325.0, 288.15, 0.0], normal_flow=True)
        bt = pbc.flow_bc(pf, [101325.0, 288.15, 0.0], normal_flow=True,
                         device="cpu")
    kw = {}
    if mode == "transpiration":
        kw = dict(transpiration=f32(rng, G, lo=-2, hi=2))
    else:
        kw = dict(du_dn=f32(rng, G, lo=0, hi=2e3),
                  image_distances=f32(rng, G, lo=1e-3, hi=2e-2))
    ref = jbc.apply_flow_bc(bj, jnp.asarray(P), jnp.asarray(nrm),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    kt = {k: torch.as_tensor(v) for k, v in kw.items()}
    out = pbc.apply_flow_bc(bt, torch.as_tensor(P), torch.as_tensor(nrm),
                            **kt)
    close(ref, out, rtol=1e-6, atol=1e-3)
    close(ref, bt(torch.as_tensor(P), torch.as_tensor(nrm), **kt),
          rtol=1e-6, atol=1e-3)
    plain = pbc.apply_flow_bc(bt, torch.as_tensor(P), torch.as_tensor(nrm))
    assert (out - plain).abs().max() > 1e-3          # the argument acted
    for one in ("du_dn", "image_distances"):
        with pytest.raises(ValueError, match="together"):
            pbc.apply_flow_bc(bt, torch.as_tensor(P), torch.as_tensor(nrm),
                              **{one: torch.ones(G)})


def test_wall_model_pipeline():
    """tests/test_viscous.py::test_wall_model_pipeline in both packages on
    the same channel mesh: wall function at the wall-model offset points
    (u_tau, nu_t, du_dn, ...) and the Wray-Agarwal source terms from the
    resolved field's gradients, rtol 1e-5."""
    from ibx.geometry import build_mesh as jx_build_mesh
    from ibx.geometry import polyline as jx_polyline
    from ibx.ops import operators as jops
    from ibx.topology import Domain as JxDomain

    from ibx_torch.geometry import build_mesh, polyline
    from ibx_torch.ops import operators as ops
    from ibx_torch.topology import Domain

    pts = np.array([[0.0, 0.0], [1.0, 0.0]])
    hc = [("io", [(0, False), (0, True), (1, True)])]
    jdom = JxDomain(jx_build_mesh([0.0, 0.0], [1.0, 1.0],
                                  ("wall", jx_polyline(pts, closed=False),
                                   5e-2), block_size=4),
                    hypercube_families=hc)
    pdom = Domain(build_mesh([0.0, 0.0], [1.0, 1.0],
                             ("wall", polyline(pts, closed=False), 5e-2),
                             block_size=4),
                  hypercube_families=hc, device="cpu")
    np.testing.assert_array_equal(pdom.centers, jdom.centers)

    def pipeline(dom, xp, tu, op, fl, surf_call):
        N = dom.ncells
        u = xp(50.0 * dom.centers[:, 1].astype(np.float32))
        surf = dom.surfaces["wall"]
        u_off = surf_call(surf, u)
        y = xp(surf.offsets * 1.5)
        nu = float(fl.dynamic_viscosity(fl.make_fluid(),
                                        xp(np.float32(288.15)))) / 1.2
        ws = tu.wall_function(y, abs(u_off) + 1e-3,
                              xp(np.full(u_off.shape, nu, np.float32)))
        part = dom.partitions[0]
        zero = xp(np.zeros(N, np.float32))
        g = [[op.cell_gradient(part, u, j) for j in range(2)],
             [op.cell_gradient(part, zero, j) for j in range(2)]]
        S = tu.shear_rate(g)
        Rf = xp(np.full(N, 3 * nu, np.float32))
        stack = jnp.stack if xp is jnp.asarray else torch.stack
        gR = stack([op.cell_gradient(part, Rf, j) for j in range(2)], 1)
        gS = stack([op.cell_gradient(part, S, j) for j in range(2)], 1)
        return ws, tu.wray_agarwal(Rf, S, gR, gS)

    ws_j, wa_j = pipeline(jdom, jnp.asarray, jtu, jops, jfl,
                          lambda s, u: s.at_offset(u))
    ws_t, wa_t = pipeline(pdom, torch.as_tensor, ptu, ops, pfl,
                          lambda s, u: s.at_offset(u))
    assert np.isfinite(ws_t.du_dn.numpy()).all()
    assert (ws_t.nu_t.numpy() >= 0).all()
    close(ws_j, ws_t)
    close(wa_j, wa_t, atol=1e-9)
