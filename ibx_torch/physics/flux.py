"""Inviscid HLL flux (counterpart of `ibx/physics/flux.py`, reference
``src/cfd.jl:459-508``), for an integer Cartesian face dimension."""

from __future__ import annotations

import torch

from .fluid import Fluid, primitive2state, speed_of_sound


def _flux_one_side(fluid: Fluid, P, dim: int):
    """Q, F = state and directed inviscid flux for one side."""
    Q = primitive2state(fluid, P)
    p = P[..., 0:1]
    u_n = P[..., 2 + dim]
    un = u_n[..., None]
    mom = Q[..., 2:] * un
    mom = torch.cat(
        [mom[..., :dim], mom[..., dim:dim + 1] + p, mom[..., dim + 1:]],
        dim=-1)
    F = torch.cat([Q[..., 0:1] * un, (Q[..., 1:2] + p) * un, mom], dim=-1)
    return Q, F, u_n


def inviscid_fluxes_hll(fluid: Fluid, PL, PR, dim: int, *, fix=None):
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
