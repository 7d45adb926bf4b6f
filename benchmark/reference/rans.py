"""The reference RANS march: plain PyTorch on face lists, in any
precision.

ImmersedBoundary.jl's RANS recipe on the immersed-boundary Euler scheme
of `euler.Euler` (whose face lists, Green-Gauss sums, sensor, MUSCL/JST
faces and HLL fluxes it reuses as they are), on the state [p, T, u, v,
Rt]:

* Navier-Stokes face fluxes (``src/cfd.jl:664-736``): the Newtonian
  stress with mu(T) + mu_t and the heat flux k(T) dT/dn, from the face
  values of P, the two-point normal gradient and the face values of the
  Green-Gauss cell gradients along the other dimensions;
* mu_t = rho Rt, and the one-equation Wray-Agarwal transport of Rt
  (``src/turbulence.jl:222-241``): upwinded MUSCL advection with the
  flow's JST blend, diffusion with nu + sigma_R Rt, and the source
  C1 Rt S + C2 (grad Rt . grad S) Rt / S, capped at 10 Rt;
* local time steps at the acoustic CFL bound plus 4 nu_eff / h^2 a
  dimension (nu_eff = nu + Rt);
* the wall function (``src/turbulence.jl:27-98``): the law of the wall
  min(ln(y+)/kappa + C, y+) inverted by 20 relaxed fixed-point
  iterations at the image point, van Driest's mu+, and from them the
  wall's eddy viscosity mu+ nu and the slip velocity du/dn y taken off
  the wall BC's tangential velocity (``src/cfd.jl:268-273``);
* ghost rows eta-blended toward the characteristic flow BC, with Rt_inf
  = 3 nu_inf at the farfield and the wall function's nu_t at the wall.

Departures from the published models, which ImmersedBoundary.jl and so
the program share: the simplified Wray-Agarwal form (no f1 switch
between the k-omega and k-epsilon branches, no wall distance) in place
of Wray & Agarwal, AIAA J. 53(8), 2015; a wall function in place of a
wall-resolved boundary layer; the gas constant R = 283, temperatures
clamped at 10 K, the Sutherland law with exponent 2/3, the one-sided HLL
wave speeds; Re set by rescaling mu_ref at the freestream
(``src/cfd.jl:645-654``). The stage updates guard the primitives
(pressure floor, temperature and speed caps) without a density floor,
as the RANS march does, and clamp Rt at 0 after the second stage.

It shares no code with the program and imports nothing of it; the image
distances of the wall's ghosts are worked out from the cell widths, as
`domain.build_domain` places the image points.
"""

from __future__ import annotations

import numpy as np
import torch

from .domain import GHOST_LAYER_RATIO, RefDomain
from .euler import T_MIN, Euler, Fluid, flow_bc, guard, minmod

EPS32 = float(np.finfo(np.float32).eps)
# Sutherland-style viscosity with ImmersedBoundary.jl's 2/3 exponent (its
# mu_ref is set by the Reynolds number), its polynomial heat
# conductivity, and the freestream's Rt over nu
T_REF, S_SUTH = 273.15, 110.4
K_POLY = (0.00646, 6.468e-5)
RT_OVER_NU = 3.0
# Wray-Agarwal
SIGMA_R, C1, KAPPA = 0.72, 0.0829, 0.41
# the wall function
C_LOG, A_PLUS, OMEGA, N_ITER = 4.9, 19.0, 0.5, 20


def mu_scale(T):
    """mu(T) / mu_ref."""
    T = T.clamp(min=T_MIN)
    return (T / T_REF) ** (2.0 / 3.0) * (T_REF + S_SUTH) / (T + S_SUTH)


def conductivity(T):
    return K_POLY[0] + K_POLY[1] * T


def image_distances(dom: RefDomain, ghosts: np.ndarray) -> np.ndarray:
    """The distance of each ghost's image point from the boundary: the
    ghost's circumdiameter times the ghost layer ratio (float32, as the
    tables are built)."""
    diam = np.sqrt((dom.widths[ghosts].astype(np.float64) ** 2).sum(1)
                   ).astype(np.float32)
    return diam * np.float32(GHOST_LAYER_RATIO) + np.float32(EPS32)


def freestream_rt(P_inf, reynolds: float) -> float:
    """Rt_inf = 3 nu_inf, with nu_inf = |u_inf| / Re (a unit length)."""
    P_inf = np.asarray(P_inf, np.float64)
    return RT_OVER_NU * float(np.sqrt((P_inf[2:] ** 2).sum())) / reynolds


def wall_function(y, V, nu):
    """(nu_t, du/dn) of the wall function at distance ``y`` where the
    tangential speed is ``V`` and the kinematic viscosity ``nu``."""
    Rey = (V * y / nu).abs().clamp(min=EPS32)
    yp = torch.sqrt(Rey)
    for _ in range(N_ITER):
        up = torch.minimum(torch.log(yp.clamp(min=1.0)) / KAPPA + C_LOG, yp)
        yp = OMEGA * (Rey / up) + (1.0 - OMEGA) * yp
    up = Rey / yp
    mup = KAPPA * yp * (1.0 - torch.exp(-yp / A_PLUS)) ** 2
    u_tau = V / up
    return mup * nu, u_tau * u_tau / (nu * (1.0 + mup))


class Rans:
    """The RANS march on one `RefDomain` in ``dtype`` on ``device``.

    ``P_inf`` is the freestream [p, T, u...] at Reynolds number
    ``reynolds`` a unit length; ``wall_model`` takes the wall function's
    slip velocity into the wall BC. A state is [N, nd + 3]: the
    primitives and Rt."""

    def __init__(self, dom: RefDomain, P_inf, *, reynolds: float, dtype,
                 device, cfl: float, wall_model: bool = True):
        self.e = Euler(dom, P_inf, dtype=dtype, device=device, cfl=cfl)
        self.nd, self.cfl, self.wall_model = dom.nd, cfl, wall_model
        P_inf = np.asarray(P_inf, np.float64)
        self.Rt_inf = freestream_rt(P_inf, reynolds)
        # mu_ref such that mu(T_inf) = rho_inf nu_inf
        rho_inf = P_inf[0] / (Fluid.R * P_inf[1])
        self.mu_ref = rho_inf * self.Rt_inf / RT_OVER_NU / float(
            mu_scale(torch.tensor(P_inf[1])))
        self.imd = [torch.as_tensor(image_distances(dom, fm.ghosts),
                                    dtype=dtype, device=device)
                    for fm in dom.families.values()]

    def mu(self, T):
        return self.mu_ref * mu_scale(T)

    def state(self, P, Rt):
        """The fused state of primitives ``P`` and eddy viscosity ``Rt``
        in the march's precision."""
        return torch.cat([P, Rt[:, None]], 1).to(self.e.dtype)

    # -- the right-hand side ---------------------------------------------

    def rhs(self, S):
        """(dQ/dt, dRt/dt, the local time step) of the state ``S``."""
        e, nd = self.e, self.nd
        P, Rt = S[:, :2 + nd], S[:, 2 + nd]
        Rt_pos = Rt.clamp(min=0.0)
        T = P[:, 1]
        rho = P[:, 0] / (Fluid.R * T.clamp(min=T_MIN))
        mu_t = rho * Rt_pos
        nu = e.sensor(P[:, 0])
        dP = [e.gg(e.at_faces(P, d), d) for d in range(nd)]
        R = torch.zeros_like(P)
        for d in range(nd):
            o, n = e.o[d], e.n[d]
            do, dn = (e.so[d] / 2)[:, None], (e.sn[d] / 2)[:, None]
            uo, un = P[o], P[n]
            g = (un - uo) / (do + dn)
            go, gn = dP[d][o], dP[d][n]
            lim = minmod((2 * gn - g) * dn, (2 * go - g) * do)
            D = torch.maximum(nu[o], nu[n]).clamp(min=1e-7)[:, None]
            uf = (uo * dn + un * do) / (do + dn) + (go * do - gn * dn) / 8
            PL = (uo + lim) * D + (1 - D) * uf
            PR = (un - lim) * D + (1 - D) * uf
            grads = [g if j == d else e.at_faces(dP[j], d) for j in range(nd)]
            F = e.hll(PL, PR, d) - self.viscous(
                e.at_faces(P, d), grads, d, e.at_faces(mu_t, d))
            R = R - e.gg(F, d)

        # Wray-Agarwal, with the shear rate sqrt(2 S_ij S_ij)
        S2 = torch.zeros_like(T)
        for i in range(nd):
            for j in range(nd):
                S2 = S2 + ((dP[j][:, 2 + i] + dP[i][:, 2 + j]) / 2) ** 2
        S_rate = torch.sqrt(2 * S2)
        dRt = [e.gg(e.at_faces(Rt, d), d) for d in range(nd)]
        gRgS = sum(dRt[d] * e.gg(e.at_faces(S_rate, d), d) for d in range(nd))
        C2 = SIGMA_R + C1 / KAPPA ** 2
        src = torch.minimum(C1 * Rt_pos * S_rate
                            + C2 * gRgS * (Rt_pos / (S_rate + EPS32)),
                            10.0 * Rt_pos)
        nu_lam = self.mu(T) / rho
        nu_eff = nu_lam + SIGMA_R * Rt_pos
        dRt_dt = src
        for d in range(nd):
            o, n = e.o[d], e.n[d]
            do, dn = e.so[d] / 2, e.sn[d] / 2
            Ro, Rn = Rt[o], Rt[n]
            go, gn = dRt[d][o], dRt[d][n]
            g = (Rn - Ro) / (do + dn)
            lim = minmod((2 * gn - g) * dn, (2 * go - g) * do)
            D = torch.maximum(nu[o], nu[n]).clamp(min=1e-7)
            rf = (Ro * dn + Rn * do) / (do + dn) + (go * do - gn * dn) / 8
            RL = (Ro + lim) * D + (1 - D) * rf
            RR = (Rn - lim) * D + (1 - D) * rf
            u = e.at_faces(P[:, 2 + d], d)
            F = torch.where(u >= 0.0, RL, RR) * u - e.at_faces(nu_eff, d) * g
            dRt_dt = dRt_dt - e.gg(F, d)

        # local time step: the acoustic bound and the viscous one
        a = Fluid.sound(T)
        bound = torch.zeros_like(a)
        for d in range(nd):
            h = e.h[:, d]
            bound = bound + e.gg(e.at_faces(P[:, 2 + d].abs() + a, d), d,
                                 False) + 4.0 * (nu_lam + Rt_pos) / (h * h)
        return R, dRt_dt, self.cfl / bound * e.active

    def viscous(self, Pf, grads, d, mu_t):
        """The viscous and heat-conduction flux across faces normal to
        ``d``: face primitives ``Pf``, their gradients ``grads[j]`` along
        each dimension, eddy viscosity ``mu_t``."""
        nd = self.nd
        T = Pf[:, 1]
        mu = self.mu(T) + mu_t

        def vg(i, j):
            return grads[j][:, 2 + i]

        div = sum(vg(i, i) for i in range(nd))
        tau = [mu * (vg(d, j) + vg(j, d) - (2.0 / 3.0 * div if j == d
                                            else 0.0)) for j in range(nd)]
        energy = conductivity(T) * grads[d][:, 1] + sum(
            tau[j] * Pf[:, 2 + j] for j in range(nd))
        return torch.stack([torch.zeros_like(T), energy] + tau, 1)

    # -- ghost cells -----------------------------------------------------

    def _ghost_rows(self, S, fam, imd):
        ghost, idx, w, nrm, eta, wall = fam
        nc = 2 + self.nd
        Si = (S[idx] * w[..., None]).sum(1)
        Pi = Si[:, :nc]
        Pb = flow_bc(Pi, nrm, *self.e.bc_args, wall)
        if wall:
            u = Pi[:, 2:]
            ut = u - (u * nrm).sum(1, keepdim=True) * nrm
            V = torch.sqrt((ut * ut).sum(1) + 1e-12)
            T = Pi[:, 1]
            rho = Pi[:, 0] / (Fluid.R * T.clamp(min=T_MIN))
            nu = self.mu(T) / rho
            Rtb, du_dn = wall_function(imd, V, nu)
            if self.wall_model:
                ub = Pb[:, 2:]
                Vb = torch.sqrt((ub * ub).sum(1)) + EPS32
                Pb = torch.cat([Pb[:, :2], ub * ((Vb - du_dn * imd)
                                                 / Vb)[:, None]], 1)
        else:
            Rtb = torch.full_like(Si[:, 0], self.Rt_inf)
        g = eta * Si + (1 - eta) * torch.cat([Pb, Rtb[:, None]], 1)
        return torch.cat([guard(g[:, :nc]), g[:, nc:].clamp(min=0.0)], 1)

    def bcs(self, S):
        """Ghost rows of every family set from the same state ``S`` (a new
        tensor)."""
        rows = [self._ghost_rows(S, fam, imd)
                for fam, imd in zip(self.e.families, self.imd)]
        for fam, g in zip(self.e.families, rows):
            S = S.index_copy(0, fam[0], g)
        return S

    # -- the march -------------------------------------------------------

    def step(self, S):
        """One Heun RK2 step of local time steps: the new state."""
        nc = 2 + self.nd
        P, Rt = S[:, :nc], S[:, nc:]
        R0, T0, dt = self.rhs(S)
        dt = dt[:, None]
        Q0 = Fluid.to_state(P)
        S1 = torch.cat([guard(Fluid.to_primitive(Q0 + dt * R0)),
                        Rt + dt * T0[:, None]], 1)
        S1 = self.bcs(S1)
        R1, T1, _ = self.rhs(S1)
        S2 = torch.cat([guard(Fluid.to_primitive(Q0 + dt * (R0 + R1) / 2)),
                        (Rt + dt * (T0 + T1)[:, None] / 2).clamp(min=0.0)],
                       1)
        return self.bcs(S2)

    def march(self, S, n: int):
        S = S.to(self.e.dtype)
        for _ in range(n):
            S = self.step(S)
        return S
