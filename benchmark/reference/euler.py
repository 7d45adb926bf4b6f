"""The reference Euler march: plain PyTorch on face lists, in any
precision.

The scheme is ImmersedBoundary.jl's documented recipe
(``README.md:196-253``, ``src/ImmersedBoundary.jl:873-1157``,
``src/cfd.jl``): primitives [p, T, u, v(, w)], Green-Gauss cell gradients
over the faces of each dimension (the faces on one side of a cell
averaged), MUSCL with minmod blended by a JST pressure sensor toward the
fourth-order central face value, HLL fluxes with the one-sided wave
speeds, local time steps at an acoustic CFL, Heun's RK2, and eta-blended
ghost cells whose boundary values follow the characteristic flow BC.

It shares no code with the program: faces are summed into cells with
`index_add_` rather than gathered through padded stencils, and every
tensor, table and constant is in the precision ``dtype`` (float64 for the
reference, bfloat16 for the control).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .domain import RefDomain

GAMMA = 1.4
R_GAS = 283.0     # the solver's gas constant (ImmersedBoundary.jl's air)
T_MIN = 10.0


class Fluid:
    """Ideal gas in primitives [p, T, u...]."""

    gamma, R = GAMMA, R_GAS
    cv = R_GAS / (GAMMA - 1.0)

    @classmethod
    def sound(cls, T):
        return torch.sqrt(cls.gamma * cls.R * T.clamp(min=T_MIN))

    @classmethod
    def to_state(cls, P):
        p, T, u = P[:, 0], P[:, 1].clamp(min=T_MIN), P[:, 2:]
        rho = p / (cls.R * T)
        E = rho * (cls.cv * T + (u * u).sum(1) / 2)
        return torch.cat([rho[:, None], E[:, None], rho[:, None] * u], 1)

    @classmethod
    def to_primitive(cls, Q):
        rho, E = Q[:, 0], Q[:, 1]
        u = Q[:, 2:] / rho[:, None]
        p = (cls.gamma - 1.0) * (E - rho * (u * u).sum(1) / 2)
        T = (p / (rho * cls.R)).clamp(min=T_MIN)
        return torch.cat([p[:, None], T[:, None], u], 1)


def guarded_primitive(Q, p_floor=1.0, u_max=3000.0, rho_floor=1e-6,
                      p_ceil=1e9, T_ceil=2e4):
    """`Fluid.to_primitive` with the density floored first and the
    result guarded as `guard` does (T from the unguarded pressure, capped
    at ``T_ceil``): the block marches' update."""
    rho = Q[:, 0].clamp(min=rho_floor)
    u = Q[:, 2:] / rho[:, None]
    p = (Fluid.gamma - 1.0) * (Q[:, 1] - rho * (u * u).sum(1) / 2)
    T = (p / (rho * Fluid.R)).clamp(T_MIN, T_ceil)
    scale = (u_max / torch.sqrt((u * u).sum(1, keepdim=True) + 1e-12)
             ).clamp(max=1.0)
    return torch.cat([p.clamp(p_floor, p_ceil)[:, None], T[:, None],
                      u * scale], 1)


def guard(P, p_floor=1.0, u_max=3000.0, p_ceil=1e9, T_ceil=2e4):
    """Floor the pressure, cap temperature and speed (engages only on
    unphysical states)."""
    u = P[:, 2:]
    scale = (u_max / torch.sqrt((u * u).sum(1, keepdim=True) + 1e-12)
             ).clamp(max=1.0)
    return torch.cat([P[:, :1].clamp(p_floor, p_ceil),
                      P[:, 1:2].clamp(max=T_ceil), u * scale], 1)


def flow_bc(Pi, normals, p_inf, T_inf, u_inf, wall: bool):
    """Boundary primitives from image-point primitives ``Pi`` (the
    characteristic flow BC, ``src/cfd.jl:243-300``); ``wall`` imposes
    zero normal velocity, otherwise the farfield ``u_inf``."""
    u = Pi[:, 2:]
    if wall:
        un = torch.zeros_like(Pi[:, 0])
    else:
        un = (normals * u_inf[None, :]).sum(1)
    p, T = Pi[:, 0], Pi[:, 1]
    sup = (un.abs() / Fluid.sound(T) > 1.0).to(Pi.dtype)
    out = (un >= 0.0).to(Pi.dtype)
    pb = out * (sup * p_inf + (1 - sup) * p) + (1 - out) * (
        sup * p + (1 - sup) * p_inf)
    Tb = torch.where(un > 0.0, torch.full_like(T, T_inf), T)
    if wall:
        ub = u + normals * (un - (u * normals).sum(1))[:, None]
    else:
        ub = torch.where((un >= 0.0)[:, None], u_inf[None, :].expand_as(u),
                         u)
    return torch.cat([pb[:, None], Tb[:, None], ub], 1)


def minmod(a, b):
    return torch.minimum(a.abs(), b.abs()) * (torch.sign(a)
                                              + torch.sign(b)) / 2


class Euler:
    """The march on one `RefDomain` in ``dtype`` on ``device``.

    ``P_inf`` is the freestream [p, T, u...]; ``guard_bcs`` passes the
    blended ghost rows through `guard`, ``sequential`` sets the families
    one after the other (see `bcs`), ``guarded`` takes the stages back
    to primitives through `guarded_primitive` (the block marches);
    ``active`` (bool[N], default: the cells outside the body) are the
    cells a step moves."""

    def __init__(self, dom: RefDomain, P_inf, *, dtype, device, cfl: float,
                 guard_bcs: bool = True, sequential: bool = False,
                 guarded: bool = False, active: Optional[np.ndarray] = None):
        self.dtype, self.device, self.cfl = dtype, device, cfl
        self.nd, self.N = dom.nd, dom.ncells
        self.guard_bcs, self.sequential = guard_bcs, sequential
        self.to_primitive = guarded_primitive if guarded else \
            Fluid.to_primitive

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)

        def i(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.h = f(dom.widths)
        self.o, self.n, self.so, self.sn = [], [], [], []
        self.rw, self.lw = [], []
        for d, fc in enumerate(dom.faces):
            self.o.append(i(fc.owner))
            self.n.append(i(fc.neighbor))
            self.so.append(f(dom.widths[fc.owner, d]))
            self.sn.append(f(dom.widths[fc.neighbor, d]))
            # each side's faces are averaged: 1 / (faces on that side)
            for cells, on, store in ((fc.owner, fc.right, self.rw),
                                     (fc.neighbor, fc.left, self.lw)):
                cnt = np.bincount(cells[on], minlength=self.N)
                w = np.where(on, 1.0 / np.maximum(cnt[cells], 1), 0.0)
                store.append(f(w))
        act = ~dom.inside if active is None else active
        self.active = f(act.astype(np.float64))
        p_inf = float(P_inf[0])
        T_inf = float(P_inf[1])
        u_inf = f(np.asarray(P_inf[2:], np.float64))
        # one table a family: (ghosts, stencil idx, w, normals, eta, wall)
        self.families = [
            (i(fm.ghosts), i(fm.idx), f(fm.w), f(fm.normals),
             f(fm.eta)[:, None], name == "wall")
            for name, fm in dom.families.items()]
        self.bc_args = (p_inf, T_inf, u_inf)

    # -- face and cell operators -----------------------------------------

    def _sum(self, d, uf, w, cells):
        out = torch.zeros((self.N,) + uf.shape[1:], dtype=uf.dtype,
                          device=uf.device)
        ww = w.reshape(w.shape + (1,) * (uf.dim() - 1))
        return out.index_add_(0, cells, uf * ww)

    def gg(self, uf, d, signed=True):
        """Green-Gauss: (high-side mean - low-side mean) / h, or the sum
        of both sides' means with ``signed=False``."""
        r = self._sum(d, uf, self.rw[d], self.o[d])
        l_ = self._sum(d, uf, self.lw[d], self.n[d])
        s = r - l_ if signed else r + l_
        h = self.h[:, d]
        return s / h.reshape(h.shape + (1,) * (s.dim() - 1))

    def at_faces(self, u, d):
        so, sn = self.so[d], self.sn[d]
        if u.dim() > 1:
            so, sn = so[:, None], sn[:, None]
        return (u[self.o[d]] * sn + u[self.n[d]] * so) / (so + sn)

    def sensor(self, p):
        nu = torch.full_like(p, 1e-7)
        for d in range(self.nd):
            df = p[self.n[d]] - p[self.o[d]]
            nu = torch.maximum(nu, (1e-7 + self.gg(df, d).abs())
                               / (1e-7 + self.gg(df.abs(), d, False)))
        return nu

    def hll(self, PL, PR, d):
        def side(P):
            Q = Fluid.to_state(P)
            un = P[:, 2 + d:3 + d]
            F = Q * un
            F[:, 1:2] = F[:, 1:2] + P[:, :1] * un
            F[:, 2 + d:3 + d] = F[:, 2 + d:3 + d] + P[:, :1]
            return Q, F, un
        QL, FL, uL = side(PL)
        QR, FR, uR = side(PR)
        SL = (uL + Fluid.sound(PL[:, 1:2])).clamp(min=0.0)
        SR = (uR - Fluid.sound(PR[:, 1:2])).clamp(max=0.0)
        den = SL - SR
        ok = den > 0
        F = (SL * FL - SR * FR + SR * SL * (QR - QL)) / torch.where(
            ok, den, torch.ones_like(den))
        return torch.where(ok, F, torch.zeros_like(F))

    def rhs(self, P):
        """dQ/dt of the primitives ``P``."""
        nu = self.sensor(P[:, 0])
        R = torch.zeros_like(P)
        for d in range(self.nd):
            o, n = self.o[d], self.n[d]
            dP = self.gg(self.at_faces(P, d), d)
            do, dn = (self.so[d] / 2)[:, None], (self.sn[d] / 2)[:, None]
            uo, un = P[o], P[n]
            g = (un - uo) / (do + dn)
            go, gn = dP[o], dP[n]
            lim = minmod((2 * gn - g) * dn, (2 * go - g) * do)
            D = torch.maximum(nu[o], nu[n]).clamp(min=1e-7)[:, None]
            uf = (uo * dn + un * do) / (do + dn) + (go * do - gn * dn) / 8
            PL = (uo + lim) * D + (1 - D) * uf
            PR = (un - lim) * D + (1 - D) * uf
            R = R - self.gg(self.hll(PL, PR, d), d)
        return R

    def dt(self, P):
        a = Fluid.sound(P[:, 1])
        bound = torch.zeros_like(a)
        for d in range(self.nd):
            bound = bound + self.gg(
                self.at_faces(P[:, 2 + d].abs() + a, d), d, False)
        return self.cfl / bound * self.active

    def _ghost_rows(self, P, fam):
        ghost, idx, w, nrm, eta, wall = fam
        Pi = (P[idx] * w[..., None]).sum(1)
        g = eta * Pi + (1 - eta) * flow_bc(Pi, nrm, *self.bc_args, wall)
        return guard(g) if self.guard_bcs else g

    def bcs(self, P):
        """Ghost rows set from their image points (a new tensor): every
        family from the same state, or family after family with
        ``sequential``."""
        if self.sequential:
            for fam in self.families:
                P = P.index_copy(0, fam[0], self._ghost_rows(P, fam))
            return P
        rows = [self._ghost_rows(P, fam) for fam in self.families]
        for fam, g in zip(self.families, rows):
            P = P.index_copy(0, fam[0], g)
        return P

    def step(self, P):
        """One Heun RK2 step of local time steps: the new primitives."""
        dt = self.dt(P)[:, None]
        Q0 = Fluid.to_state(P)
        R0 = self.rhs(P)
        P1 = self.bcs(self.to_primitive(Q0 + dt * R0))
        R1 = self.rhs(P1)
        return self.bcs(self.to_primitive(Q0 + dt * (R0 + R1) / 2))

    def march(self, P, n: int):
        P = P.to(self.dtype)
        for _ in range(n):
            P = self.step(P)
        return P

