"""Inviscid and viscous flux functions (counterpart of
`ibx/physics/flux.py`, reference ``src/cfd.jl:448-736``). ``dim`` may be an
integer (Cartesian face-normal dimension, 0-based) or a float[F, nd] tensor
of face normals."""

from __future__ import annotations

from typing import Sequence, Union

import torch

from .fluid import (Fluid, dynamic_viscosity, heat_conductivity,
                    primitive2state, speed_of_sound)


def _normal_velocity(P, dim):
    if isinstance(dim, int):
        return P[..., 2 + dim]
    return (dim * P[..., 2:]).sum(dim=-1)


def _flux_one_side(fluid: Fluid, P, dim):
    """Q, F = state and directed inviscid flux for one side."""
    Q = primitive2state(fluid, P)
    p = P[..., 0:1]
    u_n = _normal_velocity(P, dim)
    un = u_n[..., None]
    mom = Q[..., 2:] * un
    if isinstance(dim, int):
        mom = torch.cat(
            [mom[..., :dim], mom[..., dim:dim + 1] + p, mom[..., dim + 1:]],
            dim=-1)
    else:
        mom = mom + p * dim
    F = torch.cat([Q[..., 0:1] * un, (Q[..., 1:2] + p) * un, mom], dim=-1)
    return Q, F, u_n


def inviscid_fluxes_hll(fluid: Fluid, PL, PR, dim: Union[int, torch.Tensor],
                        *, fix=None):
    """HLL flux from left/right primitive states with the reference's
    one-sided wave speeds ``SL = max(uL + aL, 0)``, ``SR = min(uR - aR, 0)``;
    faces with SL = SR = 0 get F = 0.

    ``fix`` (optional [..., 1] blend in [0, 1]): where > 0, widens the wave
    speeds toward the two-sided Einfeldt/Davis bounds ``SL = max(uL + aL,
    uR + aR, 0)``, ``SR = min(uL - aL, uR - aR, 0)``, an entropy fix for
    strong expansions. None keeps the reference formula bit-exact."""
    QL, FL, uL = _flux_one_side(fluid, PL, dim)
    QR, FR, uR = _flux_one_side(fluid, PR, dim)
    aL = speed_of_sound(fluid, PL[..., 1])
    aR = speed_of_sound(fluid, PR[..., 1])
    SL = (uL + aL).clamp(min=0.0)[..., None]
    SR = (uR - aR).clamp(max=0.0)[..., None]
    if fix is not None:
        SLe = torch.maximum(SL, (uR + aR)[..., None])
        SRe = torch.minimum(SR, (uL - aL)[..., None])
        SL = SL + fix * (SLe - SL)
        SR = SR + fix * (SRe - SR)
    denom = SL - SR
    safe = denom > 0
    return torch.where(
        safe,
        (SL * FL - SR * FR + SR * SL * (QR - QL))
        / torch.where(safe, denom, torch.ones_like(denom)),
        torch.zeros_like(FL),
    )


def _central_state(fluid: Fluid, P):
    """State with the pressure added to the energy: [rho, E + p, rho u]."""
    Q = primitive2state(fluid, P)
    return torch.cat([Q[:, 0:1], Q[:, 1:2] + P[:, 0:1], Q[:, 2:]], dim=1)


def inviscid_fluxes_dissipative(
    fluid: Fluid, PL, PR, nuL, nuR, dim: Union[int, torch.Tensor]
):
    """Central flux + Rusanov-style sensor-scaled dissipation
    (reference ``src/cfd.jl:516-554``)."""
    UcL = _central_state(fluid, PL)
    UcR = _central_state(fluid, PR)
    P = (PL + PR) / 2
    p = P[:, 0]
    u = _normal_velocity(P, dim)
    a = speed_of_sound(fluid, P[:, 1])
    F = (UcL + UcR) * u[:, None] / 2
    if isinstance(dim, int):
        F = torch.cat([F[:, :2 + dim], F[:, 2 + dim:3 + dim] + p[:, None],
                       F[:, 3 + dim:]], dim=1)
    else:
        F = torch.cat([F[:, :2], F[:, 2:] + p[:, None] * dim], dim=1)
    nu = torch.maximum(torch.as_tensor(nuL, dtype=P.dtype, device=P.device),
                       torch.as_tensor(nuR, dtype=P.dtype, device=P.device))
    if nu.dim() == 1:
        nu = nu[:, None]
    return F + (UcL - UcR) * (nu * (a + u.abs())[:, None] / 2)


# reference-parity alias dispatching on arity
def inviscid_fluxes(fluid, PL, PR, *args):
    if len(args) == 1:
        return inviscid_fluxes_hll(fluid, PL, PR, args[0])
    if len(args) == 3:
        return inviscid_fluxes_dissipative(fluid, PL, PR, *args)
    raise TypeError("inviscid_fluxes takes (PL, PR, dim) or (PL, PR, nuL, nuR, dim)")


def jst_sensor_3pt(Pim1, Pi, Pip1):
    """Classic 3-point JST pressure sensor (reference ``src/cfd.jl:563-573``)."""
    eps = 1e-14
    return ((Pim1 + Pip1 - 2 * Pi).abs() + eps) / (
        (Pim1 - Pi).abs() + (Pip1 - Pi).abs() + eps
    )


def shock_sensor(velocity_gradients):
    """Ducros-style div^2/(div^2+|curl|^2) sensor (reference
    ``src/cfd.jl:589-617``). ``velocity_gradients[i][j]`` = d u_i / d x_j,
    a nested sequence of tensors.
    """
    eps = 1e-14
    nd = len(velocity_gradients)
    divu = torch.zeros_like(velocity_gradients[0][0])
    vort2 = torch.zeros_like(divu)
    for i in range(nd):
        i_n = (i + 1) % nd
        i_nn = (i_n + 1) % nd
        divu = divu + velocity_gradients[i][i]
        vort2 = vort2 + (
            velocity_gradients[i_nn][i_n] - velocity_gradients[i_n][i_nn]
        ) ** 2
    div2 = divu ** 2
    return (div2 + eps) / (div2 + vort2 + eps)


def viscous_fluxes(
    fluid: Fluid,
    P,
    Pgrad: Sequence,
    dim: Union[int, torch.Tensor],
    *,
    mu_t=0.0,
):
    """Newtonian viscous + heat-conduction fluxes (reference
    ``src/cfd.jl:664-736``). ``Pgrad[j]`` is the primitive-variable gradient
    along axis j (same layout as P); ``mu_t`` an optional eddy viscosity.
    Accepts flat [N, C] or grid [..., C] layouts (components on the last
    axis).
    """
    T = P[..., 1]
    mu = dynamic_viscosity(fluid, T) + mu_t
    k = heat_conductivity(fluid, T)
    nd = P.shape[-1] - 2

    def vel_grad(i, j):
        return Pgrad[j][..., 2 + i]

    divu = vel_grad(0, 0)
    for i in range(1, nd):
        divu = divu + vel_grad(i, i)

    def tau(i, j):
        t = vel_grad(i, j) + vel_grad(j, i)
        if i == j:
            t = t - (2.0 / 3.0) * divu
        return t * mu

    F = [torch.zeros_like(T) for _ in range(nd + 2)]
    if isinstance(dim, int):
        F[1] = Pgrad[dim][..., 1] * k
        for j in range(nd):
            F[1] = F[1] + tau(dim, j) * P[..., 2 + j]
            F[2 + j] = tau(dim, j)
    else:
        tau_dim = []
        for i in range(nd):
            s = torch.zeros_like(T)
            for j in range(nd):
                s = s + tau(i, j) * dim[..., j]
            tau_dim.append(s)
        for j in range(nd):
            F[1] = F[1] + Pgrad[j][..., 1] * k * dim[..., j]
            F[1] = F[1] + tau_dim[j] * P[..., 2 + j]
            F[2 + j] = tau_dim[j]
    return torch.stack(F, dim=-1)
