"""Compressible Euler/Navier-Stokes residual assembly and pseudo-time march
on the generic gather path (counterpart of `ibx/solve/euler.py`).

This is the solver recipe the reference documents in its README (operator
composition around ``inviscid_fluxes``/``viscous_fluxes``; reference
``README.md:196-253``) packaged as reusable functions: MUSCL
reconstruction with a JST pressure sensor, HLL fluxes, ghost-cell BCs, and a
local-time-step TVD-RK2 pseudo march for steady problems. Every op is a
torch op (gathers, weighted sums over a short axis, elementwise math); no
kernel of `ibx_torch.ops.kernels` lies on this path.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import operators as ops
from ..physics.fluid import (
    Fluid,
    primitive2state,
    speed_of_sound,
    state2primitive,
)
from ..physics.flux import inviscid_fluxes_hll, viscous_fluxes


def euler_rhs(
    part: ops.Partition,
    fluid: Fluid,
    P,
    *,
    high_order: bool = True,
    viscous: bool = False,
    mu_t=0.0,
    fix=None,
):
    """dQ/dt from primitives: MUSCL(JST-blended) + HLL per dimension,
    optional viscous fluxes from orthogonality-corrected face gradients.
    ``mu_t`` is a scalar (a Python float or a 0-dim tensor) or an [N] eddy
    viscosity field.

    ``fix`` (optional [N] in [0, 1]): trailing-edge robustness blend, the
    same semantics as `ibx_torch.ops.block_ops.euler_rhs_grid(fix3=...)`:
    first-order upwinding + Einfeldt HLL speeds where > 0."""
    nu = ops.jst_sensor(part, P[:, 0])
    if fix is not None:
        nu = torch.maximum(nu, fix)
    R = torch.zeros_like(P)
    grad = ops.cell_gradient(part, P) if viscous else None
    for dim in range(part.nd):
        dP = grad[dim] if viscous else ops.cell_gradient(part, P, dim)
        fo = None
        if fix is not None:
            fo = torch.maximum(ops.at_owners(part, fix, dim),
                               ops.at_neighbors(part, fix, dim))
        PL, PR = ops.muscl(part, P, dP, dim, D=nu, high_order=high_order,
                           lim_scale=None if fo is None else 1.0 - fo)
        F = inviscid_fluxes_hll(fluid, PL, PR, dim,
                                fix=None if fo is None else fo[:, None])
        if viscous:
            Pf = ops.at_faces(part, P, dim)
            grad_f = ops.face_gradient(part, P, dim, grad)
            mu_t_f = (
                ops.at_faces(part, mu_t, dim)
                if torch.is_tensor(mu_t) and mu_t.dim() > 0
                else mu_t
            )
            F = F - viscous_fluxes(fluid, Pf, grad_f, dim, mu_t=mu_t_f)
        R = R - ops.green_gauss(part, F, dim)
    return R


def local_timestep(part: ops.Partition, fluid: Fluid, P, cfl: float = 0.8):
    """Per-cell acoustic CFL bound: dt = cfl / sum_d UGG(|u_d| + a)
    (the reference's recipe, ``test/advection.jl:52-59``, extended to the
    Euler wave speed)."""
    a = speed_of_sound(fluid, P[:, 1])
    bound = torch.zeros_like(a)
    for dim in range(part.nd):
        s = P[:, 2 + dim].abs() + a
        bound = bound + ops.unsigned_green_gauss(
            part, ops.at_faces(part, s, dim), dim
        )
    return cfl / bound


def rk2_step(
    part: ops.Partition,
    fluid: Fluid,
    P,
    apply_bcs: Callable,
    *,
    cfl: float = 0.8,
    high_order: bool = True,
    viscous: bool = False,
    mu_t=0.0,
    active=None,
):
    """One TVD-RK2 (Heun) pseudo-time step with local time stepping.

    ``apply_bcs(P) -> P`` refreshes ghost rows; ``active`` (0/1 per cell)
    freezes cells (e.g. inside solid bodies). Returns (P_new, |R| max-norm).
    """
    dt = local_timestep(part, fluid, P, cfl)
    if active is not None:
        dt = dt * active
    dt = dt[:, None]

    def rhs(P):
        return euler_rhs(part, fluid, P, high_order=high_order,
                         viscous=viscous, mu_t=mu_t)

    Q0 = primitive2state(fluid, P)
    R0 = rhs(P)
    P1 = apply_bcs(state2primitive(fluid, Q0 + dt * R0))
    R1 = rhs(P1)
    Q2 = Q0 + dt * (R0 + R1) / 2
    P2 = apply_bcs(state2primitive(fluid, Q2))
    resnorm = (R0[:, 0] * part.own_mask[: R0.shape[0]]).abs().max()
    return P2, resnorm
