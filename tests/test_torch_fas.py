"""Port parity of the FAS cycle (`ibx_torch.solve.fas`) against
`ibx.solve.fas` on the pseudo-time diffusion problem of
tests/test_solve.py:100-142: the port's residual runs on its own
`ops.operators` and `Domain.impose_bc` over its own hierarchy, and takes
the JAX package's transfer tables (`convert.stencil_from_numpy`), so both
cycles see the same operators. Q and the reduction ratio agree within
1e-5 relative for the V-cycle and for smoothing only, and a counting ``f``
shows both loops stop at the same iteration on every level (the JAX side
counts with `jax.debug.callback`, since its ``while_loop`` traces ``f``
once). Plus the reference's own check, on the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ibx.geometry import build_mesh as jx_build_mesh
from ibx.geometry import polyline as jx_polyline
from ibx.ops import operators as jops
from ibx.solve import fas as jx_fas
from ibx.solve import multigrid as jx_multigrid
from ibx.topology import Domain as JxDomain

from ibx_torch.convert import stencil_from_numpy
from ibx_torch.geometry import build_mesh, polyline
from ibx_torch.ops import operators as ops
from ibx_torch.solve import fas, multigrid
from ibx_torch.topology.domain import Domain

from test_torch_mgrid import OUTER, diffusion_mesh
from test_torch_stencil import st_np

torch.set_num_threads(2)


def _residual(doms, o, ones_like, zeros_like, count=None):
    """``f(level, u)`` of tests/test_solve.py::test_fas_accelerates_diffusion
    over either package's domains and operators ``o``."""
    def f(lvl, u):
        if count is not None:
            count(lvl)
        d = doms[lvl]
        part = d.partitions[0]
        u = d.impose_bc("lower", lambda b, i: ones_like(i), u)
        u = d.impose_bc("outer", lambda b, i: zeros_like(i), u)
        r = zeros_like(u)
        bound = zeros_like(u)
        for dim in range(2):
            r = r + o.green_gauss(part, o.face_gradient(part, u, dim), dim)
            bound = bound + o.unsigned_green_gauss(
                part, 1.0 / o.face_distance(part, dim), dim)
        omega = 0.5 / bound
        return r * omega, ones_like(u)  # pre-relaxed residual, omega=1
    return f


@pytest.fixture(scope="module")
def setup():
    jd = JxDomain(diffusion_mesh(jx_build_mesh, jx_polyline),
                  hypercube_families=OUTER)
    td = Domain(diffusion_mesh(build_mesh, polyline),
                hypercube_families=OUTER, device="cpu")
    jh = jx_multigrid(jd)
    th = multigrid(td)
    jdoms = [jd] + list(jh.coarse_domains)
    tdoms = [td] + list(th.coarse_domains)
    cs = [stencil_from_numpy(st_np(c), "cpu") for c in jh.coarseners]
    ps = [stencil_from_numpy(st_np(p), "cpu") for p in jh.prolongators]
    return jdoms, jh, tdoms, cs, ps


def _u0(n, seed=0):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.uniform(size=n)).astype(np.float32)


def _rel(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("cycle", [True, False])
@pytest.mark.parametrize("n_iter,rtol", [(20, 1e-3), (50, 0.5)])
def test_fas_matches_ibx(setup, cycle, n_iter, rtol):
    """(20, 1e-3) stops on the iteration count, (50, 0.5) on the residual
    drop, at the same iteration of every level in both packages."""
    jdoms, jh, tdoms, cs, ps = setup
    jcount, tcount = {}, {}

    def jbump(lvl):
        jax.debug.callback(
            lambda: jcount.__setitem__(lvl, jcount.get(lvl, 0) + 1))

    def tbump(lvl):
        tcount[lvl] = tcount.get(lvl, 0) + 1

    jf = _residual(jdoms, jops, jnp.ones_like, jnp.zeros_like, count=jbump)
    tf = _residual(tdoms, ops, torch.ones_like, torch.zeros_like,
                   count=tbump)
    u0 = _u0(tdoms[0].ncells)
    kw = dict(n_iter=n_iter, rtol=rtol)
    if cycle:
        uj, rj = jx_fas(jf, jnp.asarray(u0), coarseners=jh.coarseners,
                        prolongators=jh.prolongators, **kw)
        ut, rt = fas(tf, torch.as_tensor(u0), coarseners=cs,
                     prolongators=ps, **kw)
    else:
        uj, rj = jx_fas(jf, jnp.asarray(u0), **kw)
        ut, rt = fas(tf, torch.as_tensor(u0), **kw)
    jax.effects_barrier()
    assert _rel(uj, ut) < 1e-5
    assert abs(float(rt) - float(rj)) < 1e-5 * abs(float(rj))
    assert jcount == tcount
    # the cycle smooths levels 0-2 of the four (the last coarsener is
    # never recursed into); each level calls f once before its loop, then
    # once an iteration
    assert sorted(tcount) == ([0, 1, 2] if cycle else [0])
    assert all(1 < n <= n_iter + 1 for n in tcount.values())
    # stopped on the residual drop, or on the count
    assert (tcount[0] < n_iter + 1) == (rtol > 0.1)


def test_fas_accelerates_diffusion(setup):
    """tests/test_solve.py::test_fas_accelerates_diffusion on the port,
    over the port's own hierarchy."""
    _, _, tdoms, _, _ = setup
    hier = multigrid(tdoms[0])
    doms = [tdoms[0]] + list(hier.coarse_domains)
    f = _residual(doms, ops, torch.ones_like, torch.zeros_like)
    u0 = torch.zeros(doms[0].ncells)
    u_fas, ratio_fas = fas(
        f, u0, coarseners=hier.coarseners, prolongators=hier.prolongators,
        n_iter=20, rtol=1e-3)
    assert float(ratio_fas) < 1.0
    u_sm, ratio_sm = fas(f, u0, n_iter=20, rtol=1e-3)
    r_fas, _ = f(0, u_fas)
    r_sm, _ = f(0, u_sm)
    assert float(r_fas.abs().max()) <= float(r_sm.abs().max()) * 1.5
    assert torch.isfinite(u_fas).all()
