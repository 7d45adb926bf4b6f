"""RAE2822 transonic airfoil case on the block march (counterpart of
`ibx/cases/rae2822.py` with ``use_blocks=True``, the flagship workload).

Selig ``.dat`` ingest, feature-refined quadtree over a +/-25-chord box,
ghost-cell immersed wall, 4-sided farfield family. The march keeps the
state as a ``[B, bs, bs, 4]`` block grid between steps and runs
`block_ops.rk2_step_grid` (or `euler_step_grid`) on torch ops: the 2D arm
has no kernel in either package, so none is launched.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..convert import tables_from_numpy
from ..geometry import (DistanceField, build_mesh, feature_regions,
                        load_surface, merge_points)
from ..geometry.inside import points_inside
from ..geometry.octree import get_cells
from ..ops.block_ops import (euler_step_grid, rk2_step_grid, to_blocks,
                             to_flat)
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import (Fluid, make_fluid, physicality_guard,
                             pressure_coefficient)
from ..topology.blocked_bc import GhostBC, _collect_families
from ..topology.blocks import BlockTables, build_block_tables
from ..topology.domain import Domain

RAE_DAT = os.path.join(os.path.dirname(__file__), "data", "rae2822.dat")
FAMILIES = ("farfield", "wall")


@dataclasses.dataclass
class Rae2822Case:
    dom: Domain
    fluid: Fluid
    P_inf: np.ndarray
    mach: float
    alpha: float
    cfl: float
    high_order: bool
    scheme: str
    freeze_gradients: bool
    irs_eps: float
    bt: BlockTables
    bc: GhostBC
    bc_fns: dict
    active3: torch.Tensor            # f32[B, bs, bs] 0/1 freeze mask
    fix3: Optional[torch.Tensor]     # f32[B, bs, bs, 1] robustness blend
    P0: torch.Tensor                 # f32[N, 4] flat initial state
    build_seconds: float             # host build + table upload

    def apply_bcs3(self, P3):
        """Ghost BCs on the block-grid state, in place."""
        return self.bc.apply_grid(P3, self.bc_fns, guard=physicality_guard)

    def apply_bcs(self, P):
        """Ghost BCs on the flat [N, 4] state (a new tensor)."""
        return to_flat(self.bt, self.apply_bcs3(
            to_blocks(self.bt, P.clone())))

    def _grid_step(self, P3):
        if self.scheme == "euler":
            return euler_step_grid(
                self.bt, self.fluid, P3, self.apply_bcs3, cfl=self.cfl,
                high_order=self.high_order, active3=self.active3,
                fix3=self.fix3)
        return rk2_step_grid(
            self.bt, self.fluid, P3, self.apply_bcs3, cfl=self.cfl,
            high_order=self.high_order, active3=self.active3,
            fix3=self.fix3, freeze_gradients=self.freeze_gradients,
            irs_eps=self.irs_eps)

    def _march(self, one, P, n_steps: int):
        P3 = to_blocks(self.bt, P)
        for _ in range(n_steps):
            P3, _ = one(P3)
        return to_flat(self.bt, P3)

    def step(self, P):
        """One pseudo step on the flat state: (P, resnorm)."""
        P3, res = self._grid_step(to_blocks(self.bt, P))
        return to_flat(self.bt, P3), res

    def march(self, P, n_steps: int):
        """``n_steps`` pseudo steps from the flat state; the state stays a
        block grid in between."""
        return self._march(self._grid_step, P, n_steps)

    def march_robust(self, P, n_steps: int):
        """First-order + Einfeldt RK2 march (``fix3 = 1`` everywhere): the
        positivity-safe relaxation for rough start-up states."""
        ones3 = torch.ones_like(self.active3)[..., None]

        def one(P3):
            return rk2_step_grid(
                self.bt, self.fluid, P3, self.apply_bcs3, cfl=self.cfl,
                high_order=self.high_order, active3=self.active3,
                fix3=ones3)

        return self._march(one, P, n_steps)


def build_rae2822(
    *,
    wall_h: float = 1e-2,
    feature_h: float = 5e-3,
    farfield: float = 25.0,
    block_size: int = 8,
    mach: float = 0.73,
    alpha_deg: float = 2.31,
    cfl: float = 0.8,
    n_partitions: int = 1,
    high_order: bool = True,
    use_blocks: bool = True,
    scheme: str = "rk2",
    freeze_gradients: bool = False,
    irs_eps: float = 0.0,
    te_fix_radius: float = 0.0,
    wall_fix_cells: float = 0.0,
    mirror_wall: bool = False,
    fluid_ghost_ratio: float = None,
    reflect_solid_images: bool = False,
    ghost_layer_ratio: float = 1.5,
    cutcell: bool = False,
    device="cuda",
) -> Rae2822Case:
    """Build the airfoil case on ``device`` (the card unless asked
    otherwise); same parameters as the JAX package's `build_rae2822`. Only
    the single-device block path exists in the port (``use_blocks=True``,
    ``n_partitions=1``), and its flagged wall deviations ``cutcell`` and
    ``mirror_wall`` are not ported."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_rae2822: device is CUDA but no CUDA "
                           "device is available (pass device='cpu')")
    if not use_blocks or n_partitions != 1:
        raise ValueError("the port has only the single-device block path "
                         "(use_blocks=True, n_partitions=1)")
    if cutcell or mirror_wall:
        raise NotImplementedError(
            "build_rae2822: cutcell and mirror_wall are not ported to "
            "ibx_torch yet (ROADMAP queue 1 item 4)")
    t0 = time.perf_counter()
    stl = merge_points(load_surface(RAE_DAT))
    features = DistanceField(feature_regions(stl, radius=0.05))

    msh = build_mesh(
        [-farfield, -farfield], [2 * farfield, 2 * farfield],
        ("wall", stl, wall_h),
        refinement_regions=[(features, feature_h)],
        block_size=block_size,
    )
    _centers, _widths, _ = get_cells(msh)
    inside = points_inside(stl, _centers)

    dom = Domain(
        msh,
        hypercube_families=[
            ("farfield", [(0, False), (0, True), (1, False), (1, True)]),
        ],
        fluid_ghost_ratio=fluid_ghost_ratio,
        reflect_solid_images=reflect_solid_images,
        ghost_layer_ratio=ghost_layer_ratio,
    )
    dom.surfaces = {k: s.to(device) for k, s in dom.surfaces.items()}

    # freeze cells strictly inside the airfoil (their free evolution, the
    # reference's behavior, diverges at fine resolution and pollutes
    # image-point stencils through the interior ghost band)
    solved_mask = ~inside

    fluid = make_fluid()
    T_inf = 288.15
    p_inf = 101325.0
    a = float(np.sqrt(1.4 * 283.0 * T_inf))
    V = mach * a
    al = np.deg2rad(alpha_deg)
    P_inf = np.array(
        [p_inf, T_inf, V * np.cos(al), V * np.sin(al)], dtype=np.float32
    )
    farfield_bc = flow_bc(fluid, P_inf, device=device)
    wall_bc = flow_bc(fluid, [p_inf, T_inf, 0.0], normal_flow=True,
                      device=device)
    bc_fns = {
        "farfield": lambda Pi, nrm: apply_flow_bc(farfield_bc, Pi, nrm),
        "wall": lambda Pi, nrm: apply_flow_bc(wall_bc, Pi, nrm),
    }

    bt, bc = tables_from_numpy(build_block_tables(dom),
                               _collect_families(dom, FAMILIES), FAMILIES,
                               device)
    # the quadtree's faces are all dense or structured 2:1; a leftover
    # would be scatter-added atomically on the card, and the march would
    # no longer repeat bit for bit
    assert bt.n_sparse == 0, f"{bt.n_sparse} generic sparse leftover faces"

    def grid(a):
        return to_blocks(bt, torch.as_tensor(a, device=device)[:, None])

    active3 = grid(solved_mask.astype(np.float32))[..., 0]

    # trailing-edge robustness blend: a resolved sharp TE expands to vacuum
    # under the reference's one-sided HLL speeds; within te_fix_radius of
    # the TE the scheme blends to first-order upwind with Einfeldt wave
    # speeds (full fix inside r, tapering to reference numerics at 2 r)
    fix3 = None
    fix_f = np.zeros(dom.ncells, np.float32)
    if te_fix_radius > 0.0:
        te = stl.points[int(np.argmax(stl.points[:, 0]))]
        d_te = np.sqrt(((dom.centers - te[None, :]) ** 2).sum(1))
        fix_f = np.clip((2.0 * te_fix_radius - d_te) / te_fix_radius,
                        0.0, 1.0).astype(np.float32)
    if wall_fix_cells > 0.0:
        # wall-band robustness blend: first-order + Einfeldt within
        # ~wall_fix_cells cell widths of the surface (h-consistent: the
        # band shrinks with refinement)
        band = wall_fix_cells * wall_h
        d_w = np.asarray(DistanceField(stl)(dom.centers), np.float64)
        fw = np.clip((2.0 * band - d_w) / band, 0.0, 1.0)
        fix_f = np.maximum(fix_f, fw.astype(np.float32))
    if fix_f.any():
        fix3 = grid(fix_f)

    P0 = np.tile(P_inf, (dom.ncells, 1))
    P0[~solved_mask, 2:] = 0.0      # stagnant solid interior (frozen)
    case = Rae2822Case(
        dom=dom, fluid=fluid, P_inf=P_inf, mach=mach, alpha=alpha_deg,
        cfl=cfl, high_order=high_order, scheme=scheme,
        freeze_gradients=freeze_gradients, irs_eps=irs_eps, bt=bt, bc=bc,
        bc_fns=bc_fns, active3=active3, fix3=fix3, P0=None,
        build_seconds=0.0)
    case.P0 = case.apply_bcs(torch.as_tensor(P0, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    case.build_seconds = time.perf_counter() - t0
    return case


def wall_cp(case: Rae2822Case, P) -> np.ndarray:
    """Pressure coefficient sampled at the wall surface points."""
    surf = case.dom.surfaces["wall"]
    P = torch.as_tensor(P)
    p_wall = surf(P[:, 0])
    return pressure_coefficient(case.fluid, p_wall, float(case.P_inf[0]),
                                case.mach).cpu().numpy()


def force_coefficients(case: Rae2822Case, P):
    """(Cl, Cd) from the wall-sampled pressure (chord = 1)."""
    surf = case.dom.surfaces["wall"]
    cp = wall_cp(case, P)
    # outward (into-fluid) unit normals scaled by panel areas
    f = -cp[:, None] * surf.normals * surf.areas[:, None]
    F = f.sum(axis=0)
    al = np.deg2rad(case.alpha)
    drag = F[0] * np.cos(al) + F[1] * np.sin(al)
    lift = -F[0] * np.sin(al) + F[1] * np.cos(al)
    return float(lift), float(drag)
