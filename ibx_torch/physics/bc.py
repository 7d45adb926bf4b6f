"""Characteristic-style flow boundary condition (counterpart of
`ibx/physics/bc.py`, reference ``src/cfd.jl:160-300``): per-point
Mach/direction switching between the image values and the freestream, a
``normal_flow`` mode for slip walls with optional transpiration, and the
wall-model velocity correction ``du_dn`` (the RANS wall functions feed it
with the image distances)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fluid import Fluid, speed_of_sound

_EPS32 = float(np.finfo(np.float32).eps)

# `normals @ u_inf` below is a matmul: keep it in full float32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class FlowBC:
    """Flow BC parameters (reference ``src/cfd.jl:160-235``)."""

    fluid: Fluid
    p_inf: float
    T_inf: float
    u_inf: torch.Tensor
    normal_flow: bool

    def __call__(self, P, normals, **kwargs):
        return apply_flow_bc(self, P, normals, **kwargs)


def flow_bc(fluid: Fluid, P_inf, *, normal_flow: bool = False,
            device="cuda") -> FlowBC:
    """Constructor from a primitive vector [p T u v (w)] (reference
    ``src/cfd.jl:229-235``); ``u_inf`` lives on ``device``."""
    P_inf = np.asarray(P_inf, dtype=np.float32)
    return FlowBC(
        fluid=fluid,
        p_inf=float(P_inf[0]),
        T_inf=float(P_inf[1]),
        u_inf=torch.as_tensor(P_inf[2:], device=device),
        normal_flow=normal_flow,
    )


def apply_flow_bc(bc: FlowBC, P, normals, *, image_distances=None,
                  du_dn=None, transpiration=0.0):
    """Impose the BC on image-point primitives (reference
    ``src/cfd.jl:243-300``). P: [G, 2+nd]; normals: [G, nd] unit normals
    into the fluid. Returns boundary primitives [G, 2+nd].

    ``transpiration`` (``normal_flow`` only) is added to the imposed normal
    velocity; ``du_dn`` and ``image_distances`` ([G] each, passed together
    or not at all) scale the boundary velocity down by ``du_dn *
    image_distance`` (the wall-function slip velocity)."""
    if bc.normal_flow:
        un = bc.u_inf[0].expand(P.shape[0])
    else:
        un = normals @ bc.u_inf

    p = P[:, 0]
    T = P[:, 1]
    u = P[:, 2:]
    current_un = (u * normals).sum(dim=1)

    a = speed_of_sound(bc.fluid, T)
    M = un.abs() / a

    sup = (M > 1.0).to(P.dtype)
    sub = 1.0 - sup
    outgoing = (un >= 0.0).to(P.dtype)
    pb = outgoing * (sup * bc.p_inf + sub * p) + (1.0 - outgoing) * (
        sup * p + sub * bc.p_inf
    )
    Tb = torch.where(un > 0.0, torch.full_like(T, bc.T_inf), T)

    if bc.normal_flow:
        dn = un - current_un
        if torch.is_tensor(transpiration) or transpiration != 0.0:
            dn = dn + transpiration
        ub = u + normals * dn[:, None]
    else:
        ub = torch.where((un >= 0.0)[:, None], bc.u_inf[None, :], u)

    if (du_dn is None) != (image_distances is None):
        raise ValueError(
            "du_dn and image_distances must be passed together"
        )
    if du_dn is not None:
        V = torch.sqrt((ub ** 2).sum(dim=1)) + _EPS32
        ub = ub * ((V - du_dn * image_distances) / V)[:, None]
    return torch.cat([pb[:, None], Tb[:, None], ub], dim=1)
