"""RAE2822 transonic airfoil case (counterpart of `ibx/cases/rae2822.py`,
the flagship workload).

Selig ``.dat`` ingest, feature-refined quadtree over a +/-25-chord box,
ghost-cell immersed wall, 4-sided farfield family. Two marches share the
build, as in the JAX package:

* the block march (``use_blocks=True``, the default) keeps the state as a
  ``[B, bs, bs, 4]`` block grid between steps and runs
  `block_ops.rk2_step_grid` (or `euler_step_grid`);
* the generic gather march (``use_blocks=False``) keeps the flat ``[N, 4]``
  state and runs `solve.euler.rk2_step` on ``dom.partitions[0]`` with the
  fused ghost BC of `Domain.fused_boundary`.

Both run on torch ops: the 2D arm has no kernel in either package, so none
is launched.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..convert import cut3_from_numpy, tables_from_numpy
from ..geometry import (DistanceField, build_mesh, feature_regions,
                        load_surface, merge_points)
from ..geometry.cutcell import cut_metrics_2d, fluid_fractions_2d
from ..geometry.inside import points_inside
from ..geometry.octree import get_cells
from ..ops.block_ops import (euler_step_grid, rk2_step_grid, to_blocks,
                             to_flat)
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import (Fluid, make_fluid, physicality_guard,
                             pressure_coefficient)
from ..solve.euler import rk2_step
from ..topology.blocked_bc import GhostBC, _collect_families
from ..topology.blocks import BlockTables, build_block_tables
from ..topology.domain import Domain, require_device
from ..utils.graphs import Graphs, march_loop

RAE_DAT = os.path.join(os.path.dirname(__file__), "data", "rae2822.dat")
FAMILIES = ("farfield", "wall")
# cut-cell floor: cells of smaller fluid fraction stay frozen
_ALPHA_FLOOR = 0.05


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
    bc_fns: dict
    # block march (use_blocks=True, one partition); None on the gather march
    bt: Optional[BlockTables]
    bc: Optional[GhostBC]
    active3: Optional[torch.Tensor]  # f32[B, bs, bs] 0/1 freeze mask
    fix3: Optional[torch.Tensor]     # f32[B, bs, bs, 1] robustness blend
    # gather march: flat-state ghost BC and freeze mask; None on the block
    # march
    flat_bcs: Optional[Callable]
    active: Optional[torch.Tensor]   # f32[N] 0/1 freeze mask
    P0: torch.Tensor                 # f32[N, 4] flat initial state
    build_seconds: float             # host build + table upload
    # block march: the mirrored families and their per-ghost gate (the
    # GhostBC's row order), and the cut-cell wall tables
    mirror: tuple = ()
    mirror_scale: Optional[torch.Tensor] = None
    cut3: Optional[dict] = None
    # the captured steps of `march` and `march_robust`
    _graphs: Graphs = dataclasses.field(default_factory=Graphs, init=False,
                                        repr=False, compare=False)

    @property
    def blocks_on(self) -> bool:
        return self.bt is not None

    def apply_bcs3(self, P3):
        """Ghost BCs on the block-grid state, in place."""
        return self.bc.apply_grid(P3, self.bc_fns, guard=physicality_guard,
                                  mirror=self.mirror,
                                  mirror_scale=self.mirror_scale)

    def apply_bcs(self, P):
        """Ghost BCs on the flat [N, 4] state (a new tensor)."""
        if not self.blocks_on:
            return self.flat_bcs(P)
        return to_flat(self.bt, self.apply_bcs3(
            to_blocks(self.bt, P.clone())))

    def _grid_step(self, P3):
        if self.scheme == "euler":
            return euler_step_grid(
                self.bt, self.fluid, P3, self.apply_bcs3, cfl=self.cfl,
                high_order=self.high_order, active3=self.active3,
                fix3=self.fix3, cut3=self.cut3)
        return rk2_step_grid(
            self.bt, self.fluid, P3, self.apply_bcs3, cfl=self.cfl,
            high_order=self.high_order, active3=self.active3,
            fix3=self.fix3, freeze_gradients=self.freeze_gradients,
            irs_eps=self.irs_eps, cut3=self.cut3)

    def _gather_step(self, P):
        if self.dom.n_partitions != 1:
            raise NotImplementedError(
                "Rae2822Case: the case's own step marches one partition; "
                "the multi-partition march is "
                "ibx_torch.cases.build_rae2822_sharded (one rank a "
                "partition), as in the JAX package, whose case.step fails "
                "there too")
        return rk2_step(self.dom.partitions[0], self.fluid, P,
                        self.flat_bcs, cfl=self.cfl,
                        high_order=self.high_order, active=self.active)

    def step(self, P):
        """One pseudo step on the flat state: (P, resnorm)."""
        if not self.blocks_on:
            return self._gather_step(P)
        P3, res = self._grid_step(to_blocks(self.bt, P))
        return to_flat(self.bt, P3), res

    def march(self, P, n_steps: int, *, graph: Optional[bool] = None):
        """``n_steps`` pseudo steps from the flat state; on the block
        march the state stays a block grid in between. On a CUDA state
        the step runs captured in a CUDA graph and replayed
        (`utils.graphs`, the counterpart of the JAX package's `jit` over
        `fori_loop`) unless ``graph=False``; on the CPU the eager loop
        runs (``graph=True`` raises there)."""
        if not self.blocks_on:
            return march_loop(self._graphs, "gather", self._gather_step, P,
                              n_steps, graph)
        return to_flat(self.bt, march_loop(
            self._graphs, "block", self._grid_step, to_blocks(self.bt, P),
            n_steps, graph))

    def march_robust(self, P, n_steps: int, *,
                     graph: Optional[bool] = None):
        """First-order + Einfeldt RK2 march (``fix3 = 1`` everywhere): the
        positivity-safe relaxation for rough start-up states. Block march
        only, as in the JAX package; ``graph`` as in `march`."""
        if not self.blocks_on:
            raise ValueError("march_robust needs the block march "
                             "(use_blocks=True, n_partitions=1)")
        ones3 = torch.ones_like(self.active3)[..., None]

        def one(P3):
            return rk2_step_grid(
                self.bt, self.fluid, P3, self.apply_bcs3, cfl=self.cfl,
                high_order=self.high_order, active3=self.active3,
                fix3=ones3, cut3=self.cut3)

        return to_flat(self.bt, march_loop(
            self._graphs, "robust", one, to_blocks(self.bt, P), n_steps,
            graph))


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
    otherwise); same parameters as the JAX package's `build_rae2822`.

    ``use_blocks=False`` takes the generic gather march; ``n_partitions >
    1`` builds the domain with its partitions and the family-by-family
    ghost BC (`Domain.impose_bc`) as the JAX package does, but its step
    raises: `build_rae2822_sharded` marches that domain, one rank a
    partition. ``mirror_wall`` reflects the wall ghosts' normal velocity
    on either march (gated off at the thin trailing edge). ``cutcell``
    (the flagged cut-cell wall, block march only) forces
    ``fluid_ghost_ratio=0``, ``reflect_solid_images`` and ``mirror_wall``
    and solves every cell whose fluid fraction exceeds 0.05."""
    device = require_device("build_rae2822", device)
    blocks_on = use_blocks and n_partitions == 1
    # cut-cell wall (flagged deviation; `geometry.cutcell`): the wall
    # enters through aperture-weighted fluxes and an explicit wall pressure
    # flux on the true wall geometry. Every fluid cell is solved (no
    # eta-overwritten fluid ghost rows); in-solid ghosts keep sane values
    # through reflected images and the mirrored normal velocity.
    if cutcell:
        if not blocks_on:
            raise ValueError("cutcell=True requires the block fast path")
        fluid_ghost_ratio = 0.0
        reflect_solid_images = True
        mirror_wall = True
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

    # cut-cell solved set: every cell with fluid fraction above the floor
    # is marched, center-in-solid cut cells included (freezing them would
    # rebuild the staircase wall one row lower)
    cc_alpha = solve_in = None
    if cutcell:
        cc_alpha = fluid_fractions_2d(
            stl, msh.distance_fields["wall"], _centers, _widths, inside)
        solve_in = inside & (cc_alpha > _ALPHA_FLOOR)

    dom = Domain(
        msh,
        n_partitions=n_partitions,
        hypercube_families=[
            ("farfield", [(0, False), (0, True), (1, False), (1, True)]),
        ],
        fluid_ghost_ratio=fluid_ghost_ratio,
        reflect_solid_images=reflect_solid_images,
        ghost_layer_ratio=ghost_layer_ratio,
        solve_inside_cells=solve_in,
        device=device,
    )

    # freeze cells strictly inside the airfoil (their free evolution, the
    # reference's behavior, diverges at fine resolution and pollutes
    # image-point stencils through the interior ghost band); under the
    # cut-cell flag, in-solid cells above the fluid-fraction floor are
    # solved instead
    solved_mask = ~inside if solve_in is None else (~inside | solve_in)

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

    P0 = np.tile(P_inf, (dom.ncells, 1))
    P0[~solved_mask, 2:] = 0.0      # stagnant solid interior (frozen)
    case = Rae2822Case(
        dom=dom, fluid=fluid, P_inf=P_inf, mach=mach, alpha=alpha_deg,
        cfl=cfl, high_order=high_order, scheme=scheme,
        freeze_gradients=freeze_gradients, irs_eps=irs_eps, bc_fns=bc_fns,
        bt=None, bc=None, active3=None, fix3=None, flat_bcs=None,
        active=None, P0=None, build_seconds=0.0)
    if blocks_on:
        _block_tables(case, stl, wall_h, te_fix_radius, wall_fix_cells,
                      solved_mask, device)
        if mirror_wall:
            case.mirror = ("wall",)
            npb = case.bt.block_size ** case.bt.nd
            case.mirror_scale = _mirror_gate(
                dom, stl, case.bc.ghost_b * npb + case.bc.ghost_w,
                case.bc.normals, device)
        if cutcell:
            cm = cut_metrics_2d(
                stl, msh.distance_fields["wall"], dom.centers, dom.widths,
                solved_mask, dom.face_dim, dom.face_owner,
                dom.face_neighbor, alpha=cc_alpha, alpha_floor=_ALPHA_FLOOR)
            case.cut3 = cut3_from_numpy(cm, case.bt, device)
    else:
        case.active = torch.as_tensor(solved_mask.astype(np.float32),
                                      device=device)
        case.flat_bcs = _flat_bcs(dom, stl, bc_fns, mirror_wall, device)
        if n_partitions == 1:
            dom.partitions          # built here, inside build_seconds
    case.P0 = case.apply_bcs(torch.as_tensor(P0, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    case.build_seconds = time.perf_counter() - t0
    return case


def _flat_bcs(dom: Domain, stl, bc_fns: dict, mirror_wall: bool,
              device) -> Callable:
    """The gather march's ghost BC on the flat state, a new tensor a call."""
    if dom.n_partitions != 1:
        # family by family through the partitions' localized boundaries
        def apply_bcs_seq(P):
            for name in FAMILIES:
                P = dom.impose_bc(
                    name, lambda b, Pi, fn=bc_fns[name]: fn(Pi, b.normals),
                    P)
            return P

        return apply_bcs_seq

    # fused BC path: both families through ONE image-interpolation gather
    # and ONE ghost write-back. Families' ghost sets are disjoint (outer box
    # vs wall).
    fb = dom.fused_boundary(list(FAMILIES))
    # mirror_wall (flagged deviation from the reference's eta-blend,
    # src/ImmersedBoundary.jl:1220-1245): reflect the ghost normal velocity
    # (-eta*u_n(image) instead of +eta*u_n(image)). Mirroring is gated off
    # where the solid is thinner than ~2 local cell widths along the inward
    # normal (TE sliver: reflecting BOTH surfaces into the wake destabilizes
    # the startup transient).
    mirror, scale = (), None
    if mirror_wall:
        mirror = ("wall",)
        scale = _mirror_gate(dom, stl, fb.ghost, fb.normals, device)

    def apply_bcs(P):
        return fb(P, bc_fns, guard=physicality_guard, mirror=mirror,
                  mirror_scale=scale)

    return apply_bcs


def _mirror_gate(dom: Domain, stl, ghost_ids, normals_g, device):
    """Per-ghost mirror gate (f32[G], the rows of ``ghost_ids``): 1 where
    the solid is at least ~2 local cell widths deep along the inward
    normal, 0 at the trailing-edge sliver, where reflecting both surfaces
    into the wake destabilizes the startup transient."""
    ghost_ids = torch.as_tensor(ghost_ids).cpu().numpy()
    normals_g = torch.as_tensor(normals_g).cpu().numpy()
    depth = 2.0 * dom.widths[ghost_ids].max(axis=1)
    probe = dom.centers[ghost_ids] - normals_g * depth[:, None]
    return torch.as_tensor(points_inside(stl, probe).astype(np.float32),
                           device=device)


def _block_tables(case: Rae2822Case, stl, wall_h: float,
                  te_fix_radius: float, wall_fix_cells: float,
                  solved_mask: np.ndarray, device) -> None:
    """The block march's tables, freeze mask and robustness blend."""
    dom = case.dom
    bt, bc = tables_from_numpy(build_block_tables(dom),
                               _collect_families(dom, FAMILIES), FAMILIES,
                               device)
    # the quadtree's faces are all dense or structured 2:1; a leftover
    # would be scatter-added atomically on the card, and the march would
    # no longer repeat bit for bit
    assert bt.n_sparse == 0, f"{bt.n_sparse} generic sparse leftover faces"

    def grid(a):
        return to_blocks(bt, torch.as_tensor(a, device=device)[:, None])

    # trailing-edge robustness blend: a resolved sharp TE expands to vacuum
    # under the reference's one-sided HLL speeds; within te_fix_radius of
    # the TE the scheme blends to first-order upwind with Einfeldt wave
    # speeds (full fix inside r, tapering to reference numerics at 2 r)
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
    case.bt, case.bc = bt, bc
    case.active3 = grid(solved_mask.astype(np.float32))[..., 0]
    case.fix3 = grid(fix_f) if fix_f.any() else None


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
