"""Ideal-gas fluid model, variable transforms, atmosphere.

Counterpart of `ibx/physics/fluid.py` (reference
``src/cfd.jl:14-151,304-426,619-654,747-802``),
with the same deliberately replicated quirks: R defaults to 283.0
(nonstandard), the Sutherland-style viscosity uses exponent 2/3 (the
classic law uses 3/2), and temperatures clamp at 10 K. Everything is
float32; components live on the last axis.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Fluid:
    """Ideal gas with polynomial heat conductivity and Sutherland-style
    viscosity (reference ``src/cfd.jl:14-53``). The constants are held as
    the float32 values the JAX package computes with (Python floats, exact
    in float32)."""

    R: float
    gamma: float
    k: Tuple[float, ...] = (float(np.float32(0.00646)),
                            float(np.float32(6.468e-5)))
    mu_ref: float = float(np.float32(1.716e-5))
    T_ref: float = float(np.float32(273.15))
    S: float = float(np.float32(110.4))

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


    @property
    def TS(self) -> float:
        """T_ref + S, rounded to float32 once."""
        return float(np.float32(self.T_ref) + np.float32(self.S))


def make_fluid(
    R: float = 283.0,
    gamma: float = 1.4,
    k: Union[float, Sequence[float]] = (0.00646, 6.468e-5),
    mu_ref: float = 1.716e-5,
    T_ref: float = 273.15,
    S: float = 110.4,
) -> Fluid:
    """Fluid with the reference's air defaults (``src/cfd.jl:40-53``)."""
    if np.isscalar(k):
        k = (k,)

    def f32(x):
        return float(np.float32(x))

    return Fluid(R=f32(R), gamma=f32(gamma), k=tuple(f32(x) for x in k),
                 mu_ref=f32(mu_ref), T_ref=f32(T_ref), S=f32(S))


def speed_of_sound(fluid: Fluid, T):
    """a = sqrt(gamma R T), T clamped (reference ``src/cfd.jl:62-64``)."""
    return torch.sqrt(fluid.gR * T.clamp(min=10.0))


def dynamic_viscosity(fluid: Fluid, T):
    """mu(T) with the reference's 2/3 exponent (``src/cfd.jl:71-77``)."""
    T = T.clamp(min=10.0)
    return (
        fluid.mu_ref
        * (T / fluid.T_ref) ** (2.0 / 3.0)
        * fluid.TS
        / (T + fluid.S)
    )


def heat_conductivity(fluid: Fluid, T):
    """Polynomial k(T) (reference ``src/cfd.jl:84-90``)."""
    k = torch.zeros_like(T)
    for i, ki in enumerate(fluid.k):
        k = k + ki * T ** i
    return k


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


def state2primitive(fluid: Fluid, Q):
    """[rho E rho*u ...] -> [p T u ...] (reference ``src/cfd.jl:137-151``)."""
    rho = Q[..., 0]
    E = Q[..., 1]
    u = Q[..., 2:] / rho[..., None]
    kin = (u ** 2).sum(dim=-1) / 2
    p = fluid.gm1 * (E - rho * kin)
    T = (p / (rho * fluid.R)).clamp(min=10.0)
    return torch.cat([p[..., None], T[..., None], u], dim=-1)


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


def reynolds_number(fluid: Fluid, P_inf, L_ref: float):
    """Re from freestream primitives (reference ``src/cfd.jl:626-637``),
    in float32: a 0-dim tensor (on ``P_inf``'s device when it is a
    tensor, on the host otherwise)."""
    P_inf = torch.as_tensor(P_inf, dtype=torch.float32)
    V = torch.sqrt((P_inf[2:] ** 2).sum())
    T = P_inf[1]
    p = P_inf[0]
    rho = p / (fluid.R * T)
    mu = dynamic_viscosity(fluid, T)
    return V * L_ref * rho / mu


def adjust_reynolds(fluid: Fluid, P_inf, L_ref: float, Re: float) -> Fluid:
    """Rescale mu_ref to hit a target Re (reference ``src/cfd.jl:645-654``)."""
    Re_old = reynolds_number(fluid, P_inf, L_ref)
    mu_ref = torch.tensor(fluid.mu_ref, dtype=torch.float32) * Re_old.cpu() / Re
    return dataclasses.replace(fluid, mu_ref=float(mu_ref))


# --- ISA standard atmosphere (host-side scalar; reference src/cfd.jl:304-397)

_ISA_LAYERS = [
    (0.0, 288.15, -6.5, 101325.0),
    (11000.0, 216.65, 0.0, 22632.0),
    (20000.0, 216.65, 1.0, 5474.9),
    (32000.0, 228.65, 2.8, 868.02),
    (47000.0, 270.65, 0.0, 110.91),
    (51000.0, 270.65, -2.8, 66.939),
    (71000.0, 214.65, -2.0, 3.9564),
]


def _isa_atmosphere(altitude_m: float, dT: float = 0.0):
    R = 287.05287
    g0 = 9.80665
    if altitude_m < 0:
        raise ValueError("Altitude cannot be negative")
    layer = _ISA_LAYERS[0]
    for i in range(len(_ISA_LAYERS) - 1):
        if altitude_m >= _ISA_LAYERS[i][0]:
            layer = _ISA_LAYERS[i]
    h_base, T_base, lapse, P_base = layer
    lapse_m = lapse / 1000.0
    dh = altitude_m - h_base
    T = T_base + lapse_m * dh + dT
    if abs(lapse_m) < 1e-10:
        P = P_base * np.exp(-g0 * dh / (R * (T_base + dT)))
    else:
        expn = -g0 / (R * lapse_m)
        Tb = T_base + dT
        P = P_base * ((Tb + lapse_m * dh) / Tb) ** expn
    return float(P), float(T)


def isa_atmosphere(
    altitude_m: float,
    *,
    dT: float = 0.0,
    Mach: float = 0.0,
    V: float = None,
    direction=(1.0,),
):
    """(Fluid, P_inf) for a flight condition (reference ``src/cfd.jl:379-397``);
    P_inf is a float32 numpy vector."""
    p, T = _isa_atmosphere(altitude_m, dT)
    fluid = make_fluid()
    if V is None:
        a = float(np.sqrt(1.4 * 283.0 * max(T, 10.0)))
        V = Mach * a
    d = np.asarray(direction, dtype=np.float64)
    d = d / (np.linalg.norm(d) + np.finfo(np.float32).eps)
    P_inf = np.concatenate([[p, T], V * d]).astype(np.float32)
    return fluid, P_inf


def streamwise_direction(alpha: float, beta: float = None):
    """Flow direction from angles in degrees (reference
    ``src/cfd.jl:407-409,434-436``), a float32 numpy vector."""
    a = np.deg2rad(alpha)
    if beta is None:
        return np.array([np.cos(a), np.sin(a)], dtype=np.float32)
    b = np.deg2rad(beta)
    return np.array(
        [np.cos(a) * np.cos(b), -np.cos(a) * np.sin(b), np.sin(a)],
        dtype=np.float32,
    )


class TimeAverage:
    """Exponential moving average + moving std monitor (host-side stateful;
    reference ``src/cfd.jl:747-802``) over tensors."""

    def __init__(self, tau: float):
        self.tau = tau
        self.mu = None
        self.sigma = None

    def push(self, Q, dt=1.0):
        Q = torch.as_tensor(Q)
        if self.mu is None:
            self.mu = Q
            self.sigma = torch.zeros_like(Q)
            return self.mu
        dt = torch.as_tensor(dt, device=Q.device)
        if dt.dim() == 1 and Q.dim() > 1:
            dt = dt.reshape((1,) * (Q.dim() - 1) + (-1,))
        eta = dt / self.tau
        self.sigma = torch.sqrt(
            self.sigma ** 2 * (1.0 - eta) + (self.mu - Q) ** 2 * eta
        )
        self.mu = self.mu * (1.0 - eta) + Q * eta
        return self.mu
