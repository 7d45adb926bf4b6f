"""Integral boundary-layer closures (counterpart of `ibx/physics/ibl.py`,
reference ``src/ibl.jl``): White's-method correlations and the theta- and
m-based closures for the ``mdot = -div(u j) + tau`` coupling. Pure
functions of float32 tensors; `m_closure`'s fixed point is a Python loop
of ``n_iter`` tensor updates."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def white_H(Lam, Re_theta):
    """Shape-parameter correlation (reference ``src/ibl.jl:12-23``)."""
    rth = Re_theta.clamp(1e2, 1e6)
    lam = Lam.clamp(-4.52859e-3, 4.5e-3)
    L = torch.log10(rth)
    H = (
        -4.072 * torch.log(lam + 4.5286e-3)
        / (-0.1331 * L ** 2 + 1.3061 * L + 6.0)
        - 1.085
    )
    return H.clamp(1.0, 2.38)


def white_Cf(Lam, Re_theta):
    """Skin-friction correlation (reference ``src/ibl.jl:25-36``)."""
    rth = Re_theta.clamp(1e2, 1e6)
    L = torch.log10(rth)
    H = white_H(Lam, Re_theta)
    return 0.3 * torch.exp(-1.33 * H) / (L ** (1.74 + 0.31 * H))


class IBLState(NamedTuple):
    theta: torch.Tensor
    Cf: torch.Tensor
    H: torch.Tensor
    delta_star: torch.Tensor
    V: torch.Tensor
    dV_ds: torch.Tensor
    rho: torch.Tensor
    m: torch.Tensor
    j: torch.Tensor
    tau: torch.Tensor


def _edge_quantities(velocity, pressure_gradient, rho):
    u = velocity
    V = torch.sqrt((u ** 2).sum(dim=1)) + _EPS32
    if np.ndim(pressure_gradient) == 0:
        px = torch.zeros_like(V)
    else:
        px = (u * pressure_gradient / V[:, None]).sum(dim=1)
    dV_ds = px / (V * rho)
    return V, dV_ds


def _rho_like(rho, a):
    return torch.as_tensor(rho, dtype=torch.float32,
                           device=a.device).broadcast_to(a.shape)


def theta_closure(theta, velocity, nu, *, pressure_gradient=0.0, rho=1.0):
    """BL parameters from momentum thickness (reference ``src/ibl.jl:62-97``)."""
    rho = _rho_like(rho, theta)
    V, dV_ds = _edge_quantities(velocity, pressure_gradient, rho)
    Lam = dV_ds * theta / V
    Re_theta = theta * V / nu
    Cf = white_Cf(Lam, Re_theta)
    H = white_H(Lam, Re_theta)
    delta_star = H * theta
    return IBLState(
        theta=theta, Cf=Cf, H=H, delta_star=delta_star, V=V, dV_ds=dV_ds,
        rho=rho, m=delta_star * V * rho, j=theta * V * rho,
        tau=Cf * V ** 2 * rho / 2,
    )


def m_closure(m, velocity, nu, *, pressure_gradient=0.0, rho=1.0,
              n_iter: int = 20, omega: float = 0.8):
    """BL parameters from the mass defect, fixed-point in H
    (reference ``src/ibl.jl:123-175``)."""
    rho = _rho_like(rho, m)
    V, dV_ds = _edge_quantities(velocity, pressure_gradient, rho)
    Lam_mult = dV_ds / V ** 2 * rho
    Re_mult = 1.0 / nu / rho

    H0 = torch.full_like(m, 1.5)
    Lam = Lam_mult * m / H0
    Re_theta = Re_mult * m / H0
    Cf = white_Cf(Lam, Re_theta)
    H = white_H(Lam, Re_theta)
    for _ in range(n_iter):
        Lam = Lam_mult * m / H
        Re_theta = Re_mult * m / H
        Cf = white_Cf(Lam, Re_theta) * omega + Cf * (1.0 - omega)
        H = white_H(Lam, Re_theta) * omega + H * (1.0 - omega)
    delta_star = m / rho / V
    theta = delta_star / H
    return IBLState(
        theta=theta, Cf=Cf, H=H, delta_star=delta_star, V=V, dV_ds=dV_ds,
        rho=rho, m=m, j=theta * V * rho, tau=Cf * V ** 2 * rho / 2,
    )
