"""Ideal-gas fluid model and variable transforms.

Counterpart of `ibx/physics/fluid.py` (reference ``src/cfd.jl:14-151``),
with the same deliberately replicated quirks: R defaults to 283.0
(nonstandard) and temperatures clamp at 10 K. Everything is float32;
components live on the last axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Fluid:
    """Ideal-gas constants, held as the float32 values the JAX package
    computes with (Python floats, exact in float32)."""

    R: float
    gamma: float

    @property
    def gR(self) -> float:
        """gamma * R, rounded to float32 once."""
        return float(np.float32(self.R) * np.float32(self.gamma))

    @property
    def gm1(self) -> float:
        """gamma - 1 (exact in float32)."""
        return float(np.float32(self.gamma) - np.float32(1.0))

    @property
    def cv(self) -> float:
        """R / (gamma - 1), rounded to float32 once."""
        return float(np.float32(self.R) / np.float32(self.gm1))


def make_fluid(R: float = 283.0, gamma: float = 1.4) -> Fluid:
    """Fluid with the reference's air defaults (``src/cfd.jl:40-53``)."""
    return Fluid(R=float(np.float32(R)), gamma=float(np.float32(gamma)))


def speed_of_sound(fluid: Fluid, T):
    """a = sqrt(gamma R T), T clamped (reference ``src/cfd.jl:62-64``)."""
    return torch.sqrt(fluid.gR * T.clamp(min=10.0))


def primitive2state(fluid: Fluid, P):
    """[p T u v w] -> [rho E rho*u ...] (reference ``src/cfd.jl:106-123``)."""
    p = P[..., 0]
    T = P[..., 1].clamp(min=10.0)
    u = P[..., 2:]
    kin = (u ** 2).sum(dim=-1) / 2
    rho = p / (fluid.R * T)
    E = rho * (fluid.cv * T + kin)
    return torch.cat([rho[..., None], E[..., None], rho[..., None] * u],
                     dim=-1)


def state2primitive_guarded(fluid: Fluid, Q, p_floor=1.0, u_max=3000.0,
                            rho_floor=1e-6, p_ceil=1e9, T_ceil=2e4):
    """`physicality_guard(state2primitive(...))` in one pass, with the
    density floor (see the JAX package's docstring for why each bound)."""
    rho = Q[..., 0].clamp(min=rho_floor)
    E = Q[..., 1]
    u = Q[..., 2:] / rho[..., None]
    kin = (u ** 2).sum(dim=-1) / 2
    p = fluid.gm1 * (E - rho * kin)
    # T from the unguarded p, exactly like state2primitive -> guard
    T = (p / (rho * fluid.R)).clamp(10.0, T_ceil)
    vmag = torch.sqrt((u ** 2).sum(dim=-1, keepdim=True) + 1e-12)
    scale = (u_max / vmag).clamp(max=1.0)
    return torch.cat(
        [p.clamp(p_floor, p_ceil)[..., None], T[..., None], u * scale],
        dim=-1)


def physicality_guard(P, p_floor=1.0, u_max=3000.0, p_ceil=1e9, T_ceil=2e4):
    """Floor pressure, cap temperature and velocity magnitude; engages only
    on unphysical states."""
    u = P[..., 2:]
    vmag = torch.sqrt((u ** 2).sum(dim=-1, keepdim=True) + 1e-12)
    scale = (u_max / vmag).clamp(max=1.0)
    return torch.cat(
        [P[..., 0:1].clamp(p_floor, p_ceil), P[..., 1:2].clamp(max=T_ceil),
         u * scale], dim=-1)


def pressure_coefficient(fluid: Fluid, p, p_inf: float, M_inf: float):
    """Cp = 2 (p/p_inf - 1) / (gamma M^2) (reference ``src/cfd.jl:420-426``)."""
    return 2.0 * (p / p_inf - 1.0) / (M_inf ** 2 * fluid.gamma)
