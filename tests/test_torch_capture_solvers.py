"""The captured solver loops (`utils.graphs.GraphedLoop`: the FAS cycle,
the point-implicit solve and step) on the CPU, where no CUDA graph
exists: the pieces run eagerly there, split as the card captures them.

Each test runs the loop as it stood before the split, written out here
as the oracle (`todays_fas`, `todays_solve`, `todays_step`), then the split
path, with every head, body and tail under the capture guard of
`test_torch_capture.py` (no host upload or read, no data-dependent
shape; the stop rule's read sits between the pieces): ``Q``/``x``/``P``
and the ratio bit-equal to the oracle's, and the same iterations on
every level. ``graph=True`` on a CPU state raises where a call keeps
its captures (`FasEuler`, `point_implicit_step`), and a keeper holds one
capture a loop, replaced when the arguments change. The fixtures are the
port tests' sizes: `FasEuler` (rk2, max_levels=2) on the RAE2822 gather
case at wall_h=8e-2 (16,768 cells), a FAS cycle and `solve` on small
synthetic problems whose stop rule ends loops early, and the
point-implicit step, two steps each, on the block case of the same mesh
(nd = 2, a caller's generator) and on the bs=4 sphere at wall_h=0.25
(nd = 3, 18,432 cells, the default generator). The steps
take one Hutchinson sample and two Krylov iterations: the split does
not depend on them, and each JVP of the block RHS costs about half a
second here."""

import weakref

import numpy as np
import pytest
import torch

from ibx_torch.cases import build_rae2822, build_sphere3d
from ibx_torch.cases.rae2822 import RAE_DAT
from ibx_torch.geometry import load_surface, merge_points
from ibx_torch.geometry.inside import points_inside
from ibx_torch.physics import apply_flow_bc, flow_bc
from ibx_torch.physics.fluid import physicality_guard, state2primitive
from ibx_torch.solve import (FasEuler, Linearization, PIPreconditioner,
                             fas, linearize, multigrid_levels,
                             point_implicit_step, solve)
from ibx_torch.solve.point_implicit import _EPS, _dot, _proj_along
from ibx_torch.solve.point_implicit_euler import newton_map
from ibx_torch.solve import fas_euler, point_implicit_euler
from ibx_torch.utils.graphs import GraphedLoop, Graphs, Piece

from test_torch_capture import CaptureGuard

torch.set_num_threads(2)

RAE = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7)
_EPS32 = float(np.finfo(np.float32).eps)


# -- the loops as they stood before the split (the oracle) -------------------

def _l2(r):
    return torch.sqrt((r.float() ** 2).sum())


def todays_fas(f, Q, *, coarseners=(), prolongators=(), prescribed_f=None,
               multigrid_level=0, n_iter=50, rtol=0.1, atol=1e-7,
               iterations=None):
    """`solve.fas.fas` before the split; ``iterations[level]`` counts each
    level's smoothing iterations."""
    level = multigrid_level
    fQ, omega = f(level, Q)
    if prescribed_f is not None:
        source = prescribed_f - fQ
    else:
        source = torch.zeros_like(fQ)
    r = fQ + source
    nr0 = _l2(r)
    if len(coarseners) > 1:
        coarsen = coarseners[0]
        prolong = prolongators[0]
        Qc = coarsen(Q)
        Qc_old = Qc
        pfQc = coarsen(r)
        Qc, _ = todays_fas(
            f, Qc, coarseners=coarseners[1:], prolongators=prolongators[1:],
            prescribed_f=pfQc, multigrid_level=level + 1, n_iter=n_iter,
            rtol=rtol, atol=atol, iterations=iterations)
        Q = Q + prolong(Qc - Qc_old)
    stop = nr0 * rtol + atol
    nr = torch.full_like(nr0, float("inf"))
    it = 0
    while it < n_iter and bool(nr >= stop):
        r, omega = f(level, Q)
        r = r + source
        Q = Q + omega.clamp(0.0, 1.0) * r
        nr = _l2(r)
        it += 1
    if iterations is not None:
        iterations[level] = it
    return Q, nr / (nr0 + _EPS32)


def todays_solve(A, b, prec, *, n_iter=100, n_inner=1, rtol=1e-2,
                 atol=1e-7, multigrid=None):
    """`solve.point_implicit.solve` before the split; returns (x, ratio,
    iterations)."""
    nr0 = torch.sqrt(_dot(b, b))
    n_levels = 0 if multigrid is None else len(multigrid.coarseners)

    def smooth(level, s):
        if level == 0:
            return s
        return multigrid.prolongators[level - 1](
            multigrid.coarseners[level - 1](s))

    stop = nr0 * rtol + atol
    x = torch.zeros_like(b)
    r = b
    nr = torch.full_like(nr0, float("inf"))
    it, n_mgrid = 0, n_levels
    while it < n_iter and bool(nr >= stop):
        for _ in range(n_inner):
            s = prec(r)
            s = smooth(n_mgrid, s)
            alpha, As = _proj_along(A, s, r)
            x = x + s * alpha
            r = r - As * alpha
            s2 = r / (_EPS + r.abs().max())
            alpha, As = _proj_along(A, s2, r)
            x = x + s2 * alpha
            r = r - As * alpha
        nr = torch.sqrt(_dot(r, r))
        n_mgrid = n_levels if n_mgrid == 0 else n_mgrid - 1
        it += 1
    return x, nr / (nr0 + _EPS), it


def todays_step(bt, fluid, P, apply_bcs, *, cfl, active,
                n_hutchinson_samples, n_krylov, relax, freeze_limiter,
                generator):
    """`point_implicit_step` before the split; returns (P1, ratio,
    iterations)."""
    g, Qn = newton_map(bt, fluid, P, apply_bcs, cfl=cfl, active=active,
                       freeze_limiter=freeze_limiter)
    A, b, prec = linearize(g, Qn, n_hutchinson_samples=n_hutchinson_samples,
                           generator=generator)
    dQ, ratio, it = todays_solve(A, b, prec, n_iter=n_krylov, rtol=1e-2)
    Q1 = Qn + relax * dQ
    P1 = apply_bcs(physicality_guard(state2primitive(fluid, Q1)))
    return P1, ratio, it


# -- fixtures -----------------------------------------------------------------

@pytest.fixture
def guarded(monkeypatch):
    """Every piece of a loop runs under the capture guard; the stop
    rule's host read, between the pieces, does not."""
    def call(self):
        with CaptureGuard():
            self.fn()
    monkeypatch.setattr(Piece, "__call__", call)


def _fas_solver(case):
    """`FasEuler` (rk2, max_levels=2) over the gather case by the BC
    recipe of tests/test_fas_euler.py:21-55."""
    fluid = case.fluid
    P_inf = np.asarray(case.P_inf, np.float32)
    far = flow_bc(fluid, P_inf, device="cpu")
    wall = flow_bc(fluid, [float(P_inf[0]), float(P_inf[1]), 0.0],
                   normal_flow=True, device="cpu")

    def make_bcs(d):
        def apply_bcs(P):
            P = d.impose_bc(
                "farfield", lambda b, Pi: apply_flow_bc(far, Pi, b.normals),
                P)
            return d.impose_bc(
                "wall", lambda b, Pi: apply_flow_bc(wall, Pi, b.normals), P)
        return apply_bcs

    stl = merge_points(load_surface(RAE_DAT))
    return FasEuler(case.dom, fluid, make_bcs, max_levels=2, cfl=0.7,
                    smoother="rk2",
                    inside_fn=lambda c: points_inside(stl, c))


def _perturbed(case, seed=0):
    """The case's initial state with a smooth perturbation and noise in
    the velocity (2D) or every channel (3D)."""
    rng = np.random.default_rng(seed)
    P = np.array(case.P0, np.float32)
    x = case.dom.centers
    P[:, 0] *= 1.0 + 0.05 * np.sin(x[:, 0]) * np.cos(x[:, 1])
    P[:, 1] *= 1.0 + 0.02 * np.cos(x[:, 0])
    P[:, 2:] += 5.0 * rng.standard_normal(P[:, 2:].shape)
    return torch.as_tensor(P)


@pytest.fixture(scope="module")
def rae_gather():
    case = build_rae2822(device="cpu", use_blocks=False, **RAE)
    return case, _fas_solver(case)


@pytest.fixture(scope="module")
def blocks():
    return {"nd2": build_rae2822(device="cpu", **RAE),
            "nd3": build_sphere3d(wall_h=0.25, block_size=4, device="cpu")}


# -- the loop itself ------------------------------------------------------------

def test_graphed_loop_stop_rule():
    """`GraphedLoop` runs head, the selected body while ``it < n_iter``
    and the predicate hold (read before each body), then the tail; a
    predicate false after the head runs no body."""
    calls, count = [], torch.zeros(())
    pred = torch.zeros((), dtype=torch.bool)

    def head():
        calls.append("h")
        count.zero_()
        pred.copy_(count < limit[0])

    def body(n):
        calls.append(n)
        count.add_(1.0)
        pred.copy_(count < limit[0])

    lp = GraphedLoop([Piece(head)], [Piece(lambda: body(0)),
                                     Piece(lambda: body(1))], pred, 5,
                     tail=[Piece(lambda: calls.append("t"))],
                     select=lambda it: 1 - it % 2)
    limit = [3.0]
    assert lp() == 3 and lp.iterations == 3
    assert calls == ["h", 1, 0, 1, "t"]
    limit[0] = 100.0
    assert lp() == 5                      # n_iter ends it
    limit[0] = 0.0
    calls.clear()
    assert lp() == 0 and calls == ["h", "t"]


# -- FAS ------------------------------------------------------------------------

def _toy_fas():
    """A relaxation toward a fixed target on 64 unknowns with three
    levels of pairwise averaging: its smoothing stops early on rtol."""
    target = torch.linspace(-1.0, 1.0, 64)[:, None].repeat(1, 2)

    def f(level, Q):
        t = target
        for _ in range(level):
            t = 0.5 * (t[0::2] + t[1::2])
        return 0.4 * (t - Q), torch.ones_like(Q)

    def coarsen(Q):
        return 0.5 * (Q[0::2] + Q[1::2])

    def prolong(Q):
        return Q.repeat_interleave(2, dim=0)

    return f, [coarsen] * 3, [prolong] * 3


def test_fas_split_matches_todays_loop(guarded):
    """`fas` on the toy problem, with a prescribed f: every level stops
    on rtol before n_iter, at the oracle's iteration, bit-equal."""
    f, cs, ps = _toy_fas()
    Q0 = torch.zeros(64, 2)
    pf = 1e-3 * torch.ones(64, 2)
    for kw in (dict(), dict(prescribed_f=pf)):
        iters = {}
        Qr, rr = todays_fas(f, Q0, coarseners=cs, prolongators=ps,
                            n_iter=40, rtol=0.05, iterations=iters, **kw)
        Q, r = fas(f, Q0, coarseners=cs, prolongators=ps, n_iter=40,
                   rtol=0.05, **kw)
        assert torch.equal(Q, Qr) and torch.equal(r, rr)
        assert 0 < min(iters.values()) and max(iters.values()) < 40


@pytest.mark.parametrize("arm", ["cycle", "smooth_only"])
def test_fas_euler_split_matches_todays_loop(rae_gather, guarded, arm):
    """Two calls of `FasEuler.cycle` / `smooth_only` (the default, eager on
    the CPU) against the oracle from a perturbed state: Q and the ratio
    bit-equal, the same iterations on every level."""
    case, fe = rae_gather
    kw = dict(n_iter=3, rtol=0.05)
    cs, ps = ((fe.coarseners, fe.prolongators) if arm == "cycle"
              else ((), ()))
    Q = Qr = fe.init_state(_perturbed(case))
    for _ in range(2):
        iters = {}
        Qr, rr = todays_fas(fe._f, Qr, coarseners=cs, prolongators=ps,
                            iterations=iters, **kw)
        Q, r = getattr(fe, arm)(Q, **kw)
        assert torch.equal(Q, Qr) and torch.equal(r, rr)
        assert fe._graphs.last.iterations == [iters[k]
                                              for k in sorted(iters)]
    assert len(iters) == (2 if arm == "cycle" else 1)
    assert not fe._graphs.loops            # nothing captured on the CPU
    with pytest.raises(ValueError, match="CUDA state"):
        getattr(fe, arm)(Q, graph=True, **kw)


# -- the point-implicit solve and step --------------------------------------------

def _coupled(seed=2, N=64, m=3):
    """The coupled block map of tests/test_solve.py:50-84."""
    rng = np.random.default_rng(seed)
    B = torch.as_tensor(rng.normal(size=(N, m, m)).astype(np.float32) * 0.1
                        + 2.0 * np.eye(m, dtype=np.float32))
    xt = torch.as_tensor(rng.normal(size=(N, m)).astype(np.float32))
    b = torch.einsum("nji,ni->nj", B, xt) + 0.1 * torch.roll(xt, 1, dims=0)

    def f(X):
        return (torch.einsum("nji,ni->nj", B, X)
                + 0.1 * torch.roll(X, 1, dims=0) - b)
    return f


@pytest.mark.parametrize("mg", [False, True])
def test_solve_split_matches_todays_loop(guarded, mg):
    """`solve` on the coupled map, without and with three multigrid
    levels of a random 2D cloud: x and the ratio bit-equal to the
    oracle's, which stops on rtol before n_iter."""
    f = _coupled()
    x0 = torch.zeros(64, 3)
    A, b, prec = linearize(f, x0, n_hutchinson_samples=4)
    mgd = None
    if mg:
        X = np.random.default_rng(6).uniform(size=(64, 2)).astype(
            np.float32)
        mgd = multigrid_levels(X, 3, device="cpu")
    xr, rr, it = todays_solve(A, b, prec, n_iter=40, rtol=1e-4,
                              multigrid=mgd)
    x, r = solve(A, b, prec, n_iter=40, rtol=1e-4, multigrid=mgd)
    assert torch.equal(x, xr) and torch.equal(r, rr)
    assert 0 < it < 40


@pytest.mark.parametrize("nd", ["nd2", "nd3"])
def test_point_implicit_step_split_matches_todays_step(blocks, guarded,
                                                       nd):
    """Two steps of `point_implicit_step` (the default, eager on the CPU;
    the frozen limiter, the freeze mask) against the oracle: at nd = 2
    with a caller's generator (each step draws where the last left it),
    at nd = 3 with the default generator (a generator seeded 0 each
    step). P and the ratio bit-equal, the same iterations."""
    case = blocks[nd]
    bt, fl = case.bt, case.fluid
    active = case.active3.reshape(-1)
    kw = dict(cfl=5.0, active=active, n_hutchinson_samples=1, n_krylov=2,
              relax=0.8, freeze_limiter=True)
    gens = ([torch.Generator().manual_seed(7) for _ in range(2)]
            if nd == "nd2" else [None] * 2)
    P = Pr = _perturbed(case)
    for _ in range(2):
        Pr, rr, it = todays_step(bt, fl, Pr, case.apply_bcs,
                                 generator=gens[0], **kw)
        P, r = point_implicit_step(bt, fl, P, case.apply_bcs,
                                   generator=gens[1], **kw)
        assert torch.equal(P, Pr) and torch.equal(r, rr)
        assert point_implicit_euler.step_graphs(bt).last.iterations == it
    assert torch.isfinite(P).all() and float(r) < 1.0
    assert not point_implicit_euler.step_graphs(bt).loops
    with pytest.raises(ValueError, match="CUDA state"):
        point_implicit_step(bt, fl, P, case.apply_bcs, graph=True, **kw)


# -- what a keeper of captures holds ---------------------------------------------

class _Captured:
    """Stands in for a captured loop (`fas.FasCycle`,
    `point_implicit_euler.PointImplicitStep`): records the pool it was
    captured into and returns its input."""

    def __init__(self, *args, **kw):
        self.pool, self.iterations = None, 0

    def capture(self, pool):
        self.pool = pool

    def __call__(self, X, *args):
        return X.clone(), torch.zeros(())


@pytest.mark.parametrize("keeper", ["fas_euler", "point_implicit_step"])
def test_a_keeper_holds_one_capture_a_loop(rae_gather, blocks, monkeypatch,
                                           keeper):
    """With every call taken as captured (`use_graph` True, a stand-in
    loop and pool), a ramp of rtol (`FasEuler.cycle`) or cfl
    (`point_implicit_step`) keeps one capture, the last: each new value
    captures once into the one pool and drops the capture before it;
    the same value again replays it."""
    pool = ("pool",)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: pool)
    graphs = Graphs()
    if keeper == "fas_euler":
        case, fe = rae_gather
        mod, cls, X = fas_euler, "FasCycle", fe.init_state(case.P0)
        monkeypatch.setattr(fe, "_graphs", graphs)

        def call(x):
            return fe.cycle(X, rtol=x)
    else:
        case = blocks["nd2"]
        mod, cls, X = point_implicit_euler, "PointImplicitStep", case.P0
        monkeypatch.setattr(mod, "step_graphs", lambda bt: graphs)

        def call(x):
            return point_implicit_step(case.bt, case.fluid, X,
                                       case.apply_bcs, cfl=x)
    monkeypatch.setattr(mod, cls, _Captured)
    monkeypatch.setattr(mod, "use_graph", lambda graph, X: True)
    made = []
    for x in (5.0, 6.0, 7.0, 7.0, 5.0):
        call(x)
        if not made or graphs.last is not made[-1]():
            made.append(weakref.ref(graphs.last))
        assert len(graphs.loops) == 1 and graphs.last.pool is pool
        assert [m() is not None for m in made] == [False] * (
            len(made) - 1) + [True]
    assert len(made) == 4
