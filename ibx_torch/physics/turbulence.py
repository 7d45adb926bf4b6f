"""RANS/LES closures and wall functions (counterpart of
`ibx/physics/turbulence.py`, reference ``src/turbulence.jl``).

``velocity_gradient`` arguments are nested sequences vg[i][j] = d u_i /
d x_j of cell tensors. The wall function's fixed-point inversion is a
Python loop of ``n_iter`` tensor updates (the JAX package's
``lax.fori_loop``), with the same relaxation and the same float32 clip.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def von_karman(y_plus, *, kappa: float = 0.41, C: float = 4.9):
    """Law of the wall (reference ``src/turbulence.jl:12-17``)."""
    return torch.minimum(
        torch.log(y_plus.clamp(min=1.0)) / kappa + C, y_plus
    )


class WallUnits(NamedTuple):
    y_plus: torch.Tensor
    u_plus: torch.Tensor
    mu_plus: torch.Tensor
    k_plus: torch.Tensor
    dup_dyp: torch.Tensor


def wall_function_units(
    Rey,
    *,
    kappa: float = 0.41,
    C: float = 4.9,
    A: float = 19.0,
    beta: float = 0.075,
    beta_star: float = 0.09,
    D: float = 4.2,
    A_plus: float = 360.0,
    omega_fixed_point: float = 0.5,
    n_iter: int = 20,
):
    """Fixed-point inversion of Rey = y+ u+ (reference
    ``src/turbulence.jl:27-66``): van-Driest mu+, Nakagawa-Nezu k+."""
    Rey = Rey.abs().clamp(min=_EPS32)
    y_plus = torch.sqrt(Rey)
    for _ in range(n_iter):
        u_plus = von_karman(y_plus, kappa=kappa, C=C)
        y_plus = omega_fixed_point * (Rey / u_plus) + (
            1.0 - omega_fixed_point
        ) * y_plus
    u_plus = Rey / y_plus
    mu_plus = kappa * y_plus * (1.0 - torch.exp(-y_plus / A)) ** 2
    dup_dyp = 1.0 / (1.0 + mu_plus)
    k_plus = torch.minimum(
        y_plus ** 2 / (6.0 * beta_star / beta - 2.0),
        D * torch.exp(-y_plus / A_plus),
    )
    return WallUnits(y_plus, u_plus, mu_plus, k_plus, dup_dyp)


class WallState(NamedTuple):
    u_tau: torch.Tensor
    nu_t: torch.Tensor
    k: torch.Tensor
    omega: torch.Tensor
    eps: torch.Tensor
    du_dn: torch.Tensor


def wall_function(y, u, nu, *, beta_star: float = 0.09, **kwargs):
    """Physical-units wall model (reference ``src/turbulence.jl:74-98``)."""
    nt = wall_function_units(u * y / nu, **kwargs)
    u_tau = u / nt.u_plus
    nu_t = nt.mu_plus * nu
    k = nt.k_plus * u_tau ** 2
    omega = k / nu_t
    eps = beta_star * omega * k
    du_dn = nt.dup_dyp * u_tau ** 2 / nu
    return WallState(u_tau, nu_t, k, omega, eps, du_dn)


def shear_rate(velocity_gradient):
    """sqrt(2 Sij Sij) (reference ``src/turbulence.jl:110-124``)."""
    nd = len(velocity_gradient)
    S2 = torch.zeros_like(velocity_gradient[0][0])
    for i in range(nd):
        for j in range(nd):
            S2 = S2 + (
                (velocity_gradient[i][j] + velocity_gradient[j][i]) / 2
            ) ** 2
    return torch.sqrt(2 * S2)


def smagorinsky_nu_sgs(delta, S, *, Cs: float = 0.17):
    """Smagorinsky SGS viscosity (reference ``src/turbulence.jl:134-137``)."""
    return (Cs * delta) ** 2 * S


def standard_k_epsilon(
    k,
    eps,
    S,
    *,
    C_mu: float = 0.09,
    sigma_k: float = 1.0,
    sigma_eps: float = 1.3,
    C1_eps: float = 1.44,
    C2_eps: float = 1.92,
):
    """Standard k-eps source/diffusion closure (reference
    ``src/turbulence.jl:175-194``). Returns dict with nu_k, nu_eps, Sk, Seps,
    nu_t."""
    nu_t = C_mu * k ** 2 / eps
    Pk = nu_t * S ** 2
    Sk = Pk - eps
    Seps = C1_eps * Pk * eps / k - C2_eps * eps ** 2 / k
    return dict(nu_k=nu_t / sigma_k, nu_eps=nu_t / sigma_eps,
                Sk=Sk, Seps=Seps, nu_t=nu_t)


def wray_agarwal(
    R,
    S,
    grad_R,
    grad_S,
    *,
    sigma_R: float = 0.72,
    C1: float = 0.0829,
    kappa: float = 0.41,
):
    """Simplified one-equation Wray-Agarwal closure (reference
    ``src/turbulence.jl:222-241``). grad_R/grad_S: [N, nd] gradients.
    Returns dict with nu_t (= R), nu_R, S (source, capped at 10 R)."""
    C2 = sigma_R + C1 / kappa ** 2
    gRgS = (grad_R * grad_S).sum(dim=-1)
    src = C1 * R * S + C2 * gRgS * (R / (S + _EPS32))
    src = torch.minimum(src, 10.0 * R)
    return dict(nu_t=R, nu_R=R * sigma_R, S=src)


def ducros_sensor(velocity_gradient):
    """Ducros shock sensor (reference ``src/turbulence.jl:253-283``)."""
    nd = len(velocity_gradient)
    div = torch.zeros_like(velocity_gradient[0][0])
    for i in range(nd):
        div = div + velocity_gradient[i][i]
    div2 = div ** 2
    if nd == 2:
        curl2 = (velocity_gradient[1][0] - velocity_gradient[0][1]) ** 2
    elif nd == 3:
        curl2 = (
            (velocity_gradient[2][1] - velocity_gradient[1][2]) ** 2
            + (velocity_gradient[0][2] - velocity_gradient[2][0]) ** 2
            + (velocity_gradient[1][0] - velocity_gradient[0][1]) ** 2
        )
    else:
        raise ValueError("Ducros sensor only implemented for 2D and 3D")
    return (div2 + _EPS32) / (div2 + curl2 + _EPS32)


def wale_nu_sgs(delta, velocity_gradient, *, Cw: float = 0.325):
    """WALE SGS viscosity, 3D (reference ``src/turbulence.jl:292-337``)."""
    nd = len(velocity_gradient)
    if nd != 3:
        raise ValueError("WALE model only implemented for 3D")
    g = velocity_gradient
    g2 = [[None] * nd for _ in range(nd)]
    for i in range(nd):
        for j in range(nd):
            s = torch.zeros_like(g[0][0])
            for k in range(nd):
                s = s + g[i][k] * g[k][j]
            g2[i][j] = s
    S2 = torch.zeros_like(g[0][0])
    Sd2 = torch.zeros_like(g[0][0])
    for i in range(nd):
        for j in range(nd):
            S2 = S2 + ((g[i][j] + g[j][i]) / 2) ** 2
            delta_ij = 1.0 if i == j else 0.0
            Sd2 = Sd2 + (
                (g2[i][j] + g2[j][i]) / 2 - g2[i][j] * (delta_ij / 3)
            ) ** 2
    return Cw * delta ** 2 * Sd2 ** 1.5 / (S2 ** 2.5 + Sd2 ** 1.25 + _EPS32)
