"""Turbulent flat-plate RANS validation case (counterpart of
`ibx/cases/flat_plate.py`).

The domain floor is the wall, a hypercube boundary family whose ghosts
carry image distances like STL ghosts (reference
``src/ImmersedBoundary.jl:1029-1076``), so the case runs the same
wall-function + Wray-Agarwal machinery as the RAE2822 RANS case on a
geometry with a published answer, the incompressible turbulent flat-plate
skin-friction correlations

    Cf(Re_x) = 0.0592 Re_x^(-1/5)          (Prandtl power law)
    Cf(Re_x) = 0.370 (log10 Re_x)^(-2.584)  (Schultz-Grunow)

valid for ~5e5 < Re_x < 1e9 on a plate turbulent from the leading edge.
M = 0.2 keeps compressibility corrections under 1%. The reference's
field Cf sits about 24% below Schultz-Grunow under both closures; the port
keeps that.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..geometry import build_mesh
from ..geometry.distance import Line
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import Fluid, adjust_reynolds, dynamic_viscosity, \
    make_fluid
from ..physics.turbulence import wall_function
from ..solve.rans import build_rans_march
from ..topology.domain import Domain, require_device
from .rae2822_rans import (block_image_distances, freestream_rt,
                           wall_state_fn)


@dataclasses.dataclass
class FlatPlateCase:
    dom: Domain
    fluid: Fluid
    P_inf: np.ndarray
    Rt_inf: float
    reynolds: float        # Re over unit plate length
    step: Callable         # (P, Rt) -> (P, Rt, resnorm)
    march: Callable        # (P, Rt, n, graph=None) -> (P, Rt)
    P0: torch.Tensor       # f32[N, 4]
    Rt0: torch.Tensor      # f32[N]
    apply_bcs: Callable    # (P, Rt) -> (P, Rt)
    build_seconds: float   # host build + table upload


def build_flat_plate(
    *,
    wall_h: float = 1.25e-3,
    length: float = 1.25,      # domain length; stations of interest < 1
    height: float = 0.5,
    block_size: int = 16,
    mach: float = 0.2,
    reynolds: float = 5e6,     # based on unit length
    cfl: float = 0.5,
    high_order: bool = True,
    use_blocks: bool = True,
    closure: str = "wray_agarwal",
    device="cuda",
) -> FlatPlateCase:
    """Build the flat plate on ``device`` (the card unless asked
    otherwise); same parameters as the JAX package's `build_flat_plate`.
    ``closure="mixing_length"`` is the JAX package's flagged accurate-Cf
    arm (Prandtl mixing-length eddy viscosity instead of the reference's
    simplified Wray-Agarwal transport)."""
    device = require_device("build_flat_plate", device)
    t0 = time.perf_counter()
    wall = Line(np.array([0.0, 0.0]), np.array([length, 0.0]))
    msh = build_mesh(
        [0.0, 0.0], [length, height],
        refinement_regions=[(wall, wall_h)],
        block_size=block_size,
    )
    dom = Domain(
        msh,
        hypercube_families=[
            ("wall", [(1, False)]),
            ("farfield", [(0, False), (0, True), (1, True)]),
        ],
        device=device,
    )
    active = np.ones(dom.ncells, np.float32)

    T_inf = 288.15
    p_inf = 101325.0
    a = float(np.sqrt(1.4 * 283.0 * T_inf))
    V = mach * a
    P_inf = np.array([p_inf, T_inf, V, 0.0], dtype=np.float32)
    fluid = adjust_reynolds(make_fluid(), P_inf, 1.0, reynolds)
    Rt_inf = freestream_rt(fluid, T_inf, p_inf)

    farfield_bc = flow_bc(fluid, P_inf, device=device)
    wall_bc = flow_bc(fluid, [p_inf, T_inf, 0.0], normal_flow=True,
                      device=device)
    wall_state = wall_state_fn(fluid)

    def wall_fn(bdry, Pi, Rti):
        ws = wall_state(Pi, bdry.normals, bdry.image_distances)
        Pb = apply_flow_bc(wall_bc, Pi, bdry.normals,
                           image_distances=bdry.image_distances,
                           du_dn=ws.du_dn)
        return Pb, ws.nu_t[:, None]

    def far_fn(bdry, Pi, Rti):
        return (apply_flow_bc(farfield_bc, Pi, bdry.normals),
                torch.full_like(Rti, Rt_inf))

    names = ["wall", "farfield"]
    blocked_bcs = None
    if use_blocks:
        imd = block_image_distances(dom, names, device)

        def wall_fn_b(Si, nrm):
            Pi = Si[:, :4]
            ws = wall_state(Pi, nrm, imd)
            Pb = apply_flow_bc(wall_bc, Pi, nrm,
                               image_distances=imd, du_dn=ws.du_dn)
            return torch.cat([Pb, ws.nu_t[:, None]], dim=1)

        def far_fn_b(Si, nrm):
            return torch.cat([apply_flow_bc(farfield_bc, Si[:, :4], nrm),
                              torch.full_like(Si[:, 4:5], Rt_inf)], dim=1)

        blocked_bcs = {"wall": wall_fn_b, "farfield": far_fn_b}

    rm = build_rans_march(
        dom, fluid, cfl=cfl, active=active,
        flat_bcs=[("wall", wall_fn), ("farfield", far_fn)],
        blocked_bcs=blocked_bcs,
        high_order=high_order, use_blocks=use_blocks,
        dense_families=("farfield",),
        closure=closure,
        # wall = the domain floor: wall distance is the y coordinate
        wall_distance=np.asarray(dom.centers)[:, 1].astype(np.float32),
        # outer mixing-length cutoff l_max = 0.09 delta(x) with the
        # standard turbulent flat-plate thickness delta = 0.37 x Re_x^-1/5
        mixing_length_cap=(
            0.09 * 0.37
            * np.maximum(np.asarray(dom.centers)[:, 0], 1e-3)
            * (reynolds * np.maximum(np.asarray(dom.centers)[:, 0], 1e-3))
            ** -0.2
        ).astype(np.float32),
    )

    P0 = np.tile(P_inf, (dom.ncells, 1))
    Rt0 = np.full(dom.ncells, Rt_inf, np.float32)
    P0, Rt0 = rm.apply_bcs(torch.as_tensor(P0, device=device),
                           torch.as_tensor(Rt0, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return FlatPlateCase(
        dom=dom, fluid=fluid, P_inf=P_inf, Rt_inf=Rt_inf,
        reynolds=reynolds, step=rm.step, march=rm.march,
        P0=P0, Rt0=Rt0, apply_bcs=rm.apply_bcs,
        build_seconds=time.perf_counter() - t0,
    )


def skin_friction_profile(case: FlatPlateCase, P):
    """(x, Cf) at every first-row cell above the plate.

    u_tau is inverted through the same law of the wall the BC enforces,
    from the solved first-cell-center tangential velocity (the standard
    wall-function skin-friction estimate)."""
    c = np.asarray(case.dom.centers)
    h = np.asarray(case.dom.widths)
    h_min = h[:, 1].min()
    row = (h[:, 1] < 1.5 * h_min) & (c[:, 1] < h_min)
    x = c[row, 0]
    y = c[row, 1]
    Pw = torch.as_tensor(P).cpu().numpy()[row]
    u_t = np.abs(Pw[:, 2])
    rho = Pw[:, 0] / (283.0 * np.maximum(Pw[:, 1], 10.0))
    nu = dynamic_viscosity(case.fluid, torch.as_tensor(Pw[:, 1])).numpy() \
        / rho
    ws = wall_function(*(torch.as_tensor(np.asarray(a, np.float32))
                         for a in (y, u_t, nu)))
    tau = rho * ws.u_tau.numpy() ** 2
    rho_inf = float(case.P_inf[0]) / (283.0 * float(case.P_inf[1]))
    V_inf = float(case.P_inf[2])
    cf = tau / (0.5 * rho_inf * V_inf ** 2)
    order = np.argsort(x)
    return x[order], cf[order]


def cf_prandtl(re_x):
    return 0.0592 * np.asarray(re_x) ** (-0.2)


def cf_schultz_grunow(re_x):
    return 0.370 * np.log10(np.asarray(re_x)) ** (-2.584)
