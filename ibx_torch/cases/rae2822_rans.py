"""RAE2822 RANS case (counterpart of `ibx/cases/rae2822_rans.py`, the
README's third workload).

Assembles the reference's RANS ingredients into a marching case:
Wray-Agarwal one-equation R-transport marched with the flow
(``src/turbulence.jl:222-241``), wall functions supplying the eddy
viscosity and the FlowBC ``du_dn`` velocity correction at the wall
(``src/turbulence.jl:27-98``, ``src/cfd.jl:268-273``), and mu_t = rho R
feeding the viscous fluxes. The stepper is `ibx_torch.solve.rans` (shared
with the flat plate); the Reynolds number is set by rescaling mu_ref
(`adjust_reynolds`). Both marches run on torch ops: no kernel lies on
either.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..geometry import (DistanceField, build_mesh, feature_regions,
                        load_surface, merge_points)
from ..geometry.inside import points_inside
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import Fluid, adjust_reynolds, dynamic_viscosity, \
    make_fluid
from ..physics.turbulence import wall_function
from ..solve.rans import build_rans_march
from ..topology.blocked_bc import GhostBC, _collect_families
from ..topology.domain import Domain, require_device
from .rae2822 import RAE_DAT


@dataclasses.dataclass
class Rae2822RansCase:
    dom: Domain
    fluid: Fluid
    P_inf: np.ndarray
    Rt_inf: float
    mach: float
    alpha: float
    reynolds: float
    step: Callable          # (P, Rt) -> (P, Rt, resnorm)
    march: Callable         # (P, Rt, n, graph=None) -> (P, Rt)
    P0: torch.Tensor        # f32[N, 4]
    Rt0: torch.Tensor       # f32[N]
    apply_bcs: Callable     # (P, Rt) -> (P, Rt)
    build_seconds: float    # host build + table upload


def wall_state_fn(fluid: Fluid) -> Callable:
    """``(Pi, nrm, y) -> WallState`` of the wall function from the image
    point's tangential velocity and kinematic viscosity."""
    def wall_state(Pi, nrm, y):
        u = Pi[:, 2:]
        un = (u * nrm).sum(dim=1)
        ut = u - un[:, None] * nrm
        V_t = torch.sqrt((ut ** 2).sum(dim=1) + 1e-12)
        rho = Pi[:, 0] / (fluid.R * Pi[:, 1].clamp(min=10.0))
        nu = dynamic_viscosity(fluid, Pi[:, 1]) / rho
        return wall_function(y, V_t, nu)

    return wall_state


def block_image_distances(dom: Domain, names, device) -> torch.Tensor:
    """The image distances of the block march's `GhostBC` over ``names``,
    in its row order (the order the wall callbacks receive)."""
    fams = _collect_families(dom, names)
    npb = int(dom.mesh.block_size) ** dom.nd
    return GhostBC.from_numpy(fams, names, npb, device).image_distances


def freestream_rt(fluid: Fluid, T_inf: float, p_inf: float) -> float:
    """Rt_inf = 3 nu_inf, the freestream eddy-viscosity seed."""
    rho_inf = p_inf / (283.0 * T_inf)
    nu_inf = float(dynamic_viscosity(
        fluid, torch.tensor(T_inf, dtype=torch.float32))) / rho_inf
    return 3.0 * nu_inf


def build_rae2822_rans(
    *,
    wall_h: float = 2e-3,
    feature_h: float = 1e-3,
    farfield: float = 25.0,
    block_size: int = 16,
    mach: float = 0.73,
    alpha_deg: float = 2.31,
    reynolds: float = 6.5e6,
    cfl: float = 0.5,
    wall_model: bool = True,
    high_order: bool = True,
    use_blocks: bool = True,
    device="cuda",
) -> Rae2822RansCase:
    """Build the RANS airfoil on ``device`` (the card unless asked
    otherwise); same parameters as the JAX package's
    `build_rae2822_rans`."""
    device = require_device("build_rae2822_rans", device)
    t0 = time.perf_counter()
    stl = merge_points(load_surface(RAE_DAT))
    features = DistanceField(feature_regions(stl, radius=0.05))
    msh = build_mesh(
        [-farfield, -farfield], [2 * farfield, 2 * farfield],
        ("wall", stl, wall_h),
        refinement_regions=[(features, feature_h)],
        block_size=block_size,
    )
    dom = Domain(
        msh,
        hypercube_families=[
            ("farfield", [(0, False), (0, True), (1, False), (1, True)]),
        ],
        device=device,
    )
    inside = points_inside(stl, dom.centers)
    active = (~inside).astype(np.float32)

    T_inf = 288.15
    p_inf = 101325.0
    a = float(np.sqrt(1.4 * 283.0 * T_inf))
    V = mach * a
    al = np.deg2rad(alpha_deg)
    P_inf = np.array(
        [p_inf, T_inf, V * np.cos(al), V * np.sin(al)], dtype=np.float32
    )
    fluid = adjust_reynolds(make_fluid(), P_inf, 1.0, reynolds)
    Rt_inf = freestream_rt(fluid, T_inf, p_inf)

    farfield_bc = flow_bc(fluid, P_inf, device=device)
    wall_bc = flow_bc(fluid, [p_inf, T_inf, 0.0], normal_flow=True,
                      device=device)
    wall_state = wall_state_fn(fluid)

    def wall_pb(Pi, nrm, imd, ws):
        if wall_model:
            return apply_flow_bc(wall_bc, Pi, nrm, image_distances=imd,
                                 du_dn=ws.du_dn)
        return apply_flow_bc(wall_bc, Pi, nrm)

    def wall_fn(bdry, Pi, Rti):
        nrm = bdry.normals
        ws = wall_state(Pi, nrm, bdry.image_distances)
        return wall_pb(Pi, nrm, bdry.image_distances, ws), ws.nu_t[:, None]

    def far_fn(bdry, Pi, Rti):
        return (apply_flow_bc(farfield_bc, Pi, bdry.normals),
                torch.full_like(Rti, Rt_inf))

    names = ["farfield", "wall"]
    blocked_bcs = None
    if use_blocks:
        imd = block_image_distances(dom, names, device)

        def far_fn_b(Si, nrm):
            return torch.cat([apply_flow_bc(farfield_bc, Si[:, :4], nrm),
                              torch.full_like(Si[:, 4:5], Rt_inf)], dim=1)

        def wall_fn_b(Si, nrm):
            Pi = Si[:, :4]
            ws = wall_state(Pi, nrm, imd)
            return torch.cat([wall_pb(Pi, nrm, imd, ws), ws.nu_t[:, None]],
                             dim=1)

        blocked_bcs = {"farfield": far_fn_b, "wall": wall_fn_b}

    rm = build_rans_march(
        dom, fluid, cfl=cfl, active=active,
        flat_bcs=[("farfield", far_fn), ("wall", wall_fn)],
        blocked_bcs=blocked_bcs,
        high_order=high_order, use_blocks=use_blocks,
    )

    P0 = np.tile(P_inf, (dom.ncells, 1))
    P0[inside, 2:] = 0.0
    Rt0 = np.full(dom.ncells, Rt_inf, np.float32)
    P0, Rt0 = rm.apply_bcs(torch.as_tensor(P0, device=device),
                           torch.as_tensor(Rt0, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Rae2822RansCase(
        dom=dom, fluid=fluid, P_inf=P_inf, Rt_inf=Rt_inf, mach=mach,
        alpha=alpha_deg, reynolds=reynolds, step=rm.step, march=rm.march,
        P0=P0, Rt0=Rt0, apply_bcs=rm.apply_bcs,
        build_seconds=time.perf_counter() - t0,
    )


def wall_skin_friction(case: Rae2822RansCase, P) -> np.ndarray:
    """Cf from the wall function: tau = rho u_tau^2 with u_tau inverted from
    the offset-sampled tangential velocity (the wall-modelled counterpart of
    the README's laminar recipe ``README.md:330-338``)."""
    surf = case.dom.surfaces["wall"]
    Pw = surf.at_offset(torch.as_tensor(P)).cpu().numpy()
    u = Pw[:, 2:]
    n = surf.normals
    ut = u - (u * n).sum(axis=1)[:, None] * n
    V_t = np.sqrt((ut ** 2).sum(axis=1)) + 1e-12
    rho = Pw[:, 0] / (283.0 * np.maximum(Pw[:, 1], 10.0))
    mu = dynamic_viscosity(case.fluid, torch.as_tensor(Pw[:, 1])).numpy()
    y = surf.offsets * 1.5
    ws = wall_function(*(torch.as_tensor(np.asarray(a, np.float32))
                         for a in (y, V_t, mu / rho)))
    tau = rho * ws.u_tau.numpy() ** 2
    rho_inf = float(case.P_inf[0]) / (283.0 * float(case.P_inf[1]))
    V_inf = float(np.sqrt((case.P_inf[2:] ** 2).sum()))
    return tau / (0.5 * rho_inf * V_inf ** 2)
