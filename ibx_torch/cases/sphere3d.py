"""3D STL-sphere Euler workload (counterpart of `ibx/cases/sphere3d.py`).

Octree mesh around a triangulated sphere, ghost-cell immersed boundary,
6-sided farfield. With ``use_blocks=True`` (the default) two block marches
share one build: the channel-split march (the JAX package's ``IBX_CS=1``
branch), whose state stays ``[B, C, bs, bs*bs]``, and the cell-major grid
march (``grid=True``, its ``IBX_CS=0`` branch) through
`block_ops.rk2_step_grid`, whose state stays ``[B, bs, bs, bs, C]``. Both
run their kernels on the card. With ``use_blocks=False`` the case takes the
generic gather march: `solve.euler.rk2_step` on ``dom.partitions[0]`` with
the fused ghost BC, on torch ops.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..convert import tables_from_numpy
from ..geometry.inside import points_inside
from ..geometry.octree import build_mesh
from ..geometry.refine import refine_to_length
from ..geometry.stereolitography import Stereolitography, merge_points
from ..ops.block_ops import rk2_step_grid, to_blocks, to_flat
from ..ops.rhs_cs import cs_merge, cs_split, rk2_step_cs
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import Fluid, make_fluid, physicality_guard
from ..solve.euler import rk2_step
from ..topology.blocked_bc import GhostBC, _collect_families
from ..topology.blocks import BlockTables, build_block_tables
from ..topology.domain import Domain, FusedBoundary, require_device
from ..utils.graphs import Graphs, at_boundary, march_loop
from ..utils.monitor import span

FAMILIES = ("farfield", "wall")


def icosphere(radius: float = 0.5, center=(0.0, 0.0, 0.0),
              h: float = 0.35) -> Stereolitography:
    """Icosahedron-subdivision sphere, reprojected to the exact radius."""
    phi = (1 + np.sqrt(5)) / 2
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], dtype=np.float32)
    verts /= np.linalg.norm(verts[0])
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    stl = Stereolitography(
        verts * radius + np.asarray(center, np.float32), faces)
    stl = refine_to_length(stl, h * radius)
    c = np.asarray(center, np.float32)
    r = stl.points - c
    stl.points = c + r * (radius / np.linalg.norm(r, axis=1))[:, None]
    return stl


@dataclasses.dataclass
class Sphere3dCase:
    dom: Domain
    fluid: Fluid
    P_inf: np.ndarray
    mach: float
    cfl: float
    high_order: bool
    bc_fns: dict
    # block marches (use_blocks=True); None on the gather march
    bt: Optional[BlockTables]
    bc: Optional[GhostBC]
    active_cs: Optional[torch.Tensor]  # f32[B, 1, bs, bs*bs] freeze mask
    active3: Optional[torch.Tensor]    # f32[B, bs, bs, bs], the same mask
    # gather march (use_blocks=False); None on the block marches
    fb: Optional[FusedBoundary]
    active: Optional[torch.Tensor]     # f32[N], the same mask
    P0: torch.Tensor          # f32[N, 5] flat initial state (ghosts set)
    build_seconds: float      # host build + table upload
    # the captured steps of `march`, one a march variant
    _graphs: Graphs = dataclasses.field(default_factory=Graphs, init=False,
                                        repr=False, compare=False)

    def apply_bcs(self, P):
        """Ghost BCs on the flat [N, 5] state (a new tensor)."""
        if self.bt is None:
            return self.fb(P, self.bc_fns, guard=physicality_guard)
        return self.from_cs(self.apply_bcs_cs(self.to_cs(P)))

    def apply_bcs_cs(self, Pc):
        """Ghost BCs on the cs state, in place."""
        return self.bc.apply_cs(Pc, self.bc_fns, guard=physicality_guard)

    def apply_bcs3(self, P3):
        """Ghost BCs on the cell-major grid state, in place."""
        return self.bc.apply_grid(P3, self.bc_fns, guard=physicality_guard)

    def step_cs(self, Pc, *, fold: bool = False):
        """One RK2 step on the cs state: (Pc, resnorm)."""
        return rk2_step_cs(self.bt, self.fluid, Pc, self.apply_bcs_cs,
                           cfl=self.cfl, high_order=self.high_order,
                           active_cs=self.active_cs, fold=fold)

    def step_grid(self, P3, *, freeze_gradients: bool = False,
                  fold: bool = False):
        """One RK2 step on the cell-major grid state: (P3, resnorm)."""
        return rk2_step_grid(self.bt, self.fluid, P3, self.apply_bcs3,
                             cfl=self.cfl, high_order=self.high_order,
                             active3=self.active3,
                             freeze_gradients=freeze_gradients, fold=fold)

    def to_cs(self, P):
        return cs_split(self.bt, to_blocks(self.bt, P))

    def from_cs(self, Pc):
        return to_flat(self.bt, cs_merge(self.bt, Pc))

    def _march_fns(self, grid: bool, freeze_gradients: bool, fold: bool):
        """(to state, one step, to flat) of the chosen march."""
        if self.bt is None:
            if grid or freeze_gradients or fold:
                raise ValueError("grid, freeze_gradients and fold need the "
                                 "block marches (use_blocks=True)")
            part = self.dom.partitions[0]
            return ((lambda P: P),
                    (lambda P: rk2_step(
                        part, self.fluid, P, self.apply_bcs, cfl=self.cfl,
                        high_order=self.high_order, active=self.active)),
                    (lambda P: P))
        if grid:
            return ((lambda P: to_blocks(self.bt, P)),
                    (lambda X: self.step_grid(
                        X, freeze_gradients=freeze_gradients, fold=fold)),
                    (lambda X: to_flat(self.bt, X)))
        if freeze_gradients:
            raise ValueError("freeze_gradients needs the grid march "
                             "(grid=True)")
        return (self.to_cs, (lambda X: self.step_cs(X, fold=fold)),
                self.from_cs)

    def step(self, P, *, grid: bool = False, freeze_gradients: bool = False,
             fold: bool = False):
        """One RK2 step on the flat [N, 5] state: (P, resnorm). ``grid``
        takes the cell-major grid march instead of the channel-split one;
        ``fold`` hands pass B its 2:1 gradient corrections to add as it
        loads them; ``freeze_gradients`` (grid march only) reuses stage
        1's gradients in stage 2."""
        to_state, one, to_flat_ = self._march_fns(grid, freeze_gradients,
                                                  fold)
        X, res = one(to_state(P))
        return to_flat_(X), res

    def march(self, P, n_steps: int, *, grid: bool = False,
              freeze_gradients: bool = False, fold: bool = False,
              graph: Optional[bool] = None):
        """``n_steps`` RK2 steps from the flat state (options as in
        `step`); the state keeps its march's layout in between. On a CUDA
        state the step runs captured in a CUDA graph and replayed
        (`utils.graphs`, the counterpart of the JAX package's `jit` over
        `fori_loop`; one graph a march variant) unless ``graph=False``; on
        the CPU the eager loop runs (``graph=True`` raises there)."""
        to_state, one, to_flat_ = self._march_fns(grid, freeze_gradients,
                                                  fold)
        key = (self.bt is None, grid, freeze_gradients, fold)
        X = march_loop(self._graphs, key, one, at_boundary(to_state, P),
                       n_steps, graph)
        return at_boundary(to_flat_, X)


def build_sphere3d(
    *,
    wall_h: float = 0.05,
    farfield: float = 4.0,
    block_size: int = 8,
    mach: float = 0.3,
    cfl: float = 0.7,
    surface_h: float = 0.2,
    high_order: bool = True,
    use_blocks: bool = True,
    verbose: bool = False,
    device="cuda",
) -> Sphere3dCase:
    """Build the sphere case on ``device`` (the card unless asked
    otherwise); same parameters as the JAX package's `build_sphere3d`
    (``verbose`` is taken for that signature and prints nothing: the
    build's stages are host spans, `ibx_torch.utils.monitor`).
    ``use_blocks=False`` takes the generic gather march."""
    device = require_device("build_sphere3d", device)
    t0 = time.perf_counter()
    with span("build.mesh"):
        stl = merge_points(icosphere(h=surface_h))
        msh = build_mesh(
            [-farfield] * 3, [2 * farfield] * 3,
            ("wall", stl, wall_h),
            block_size=block_size,
        )
    with span("build.domain"):
        dom = Domain(
            msh,
            hypercube_families=[(
                "farfield",
                [(0, False), (0, True), (1, False), (1, True),
                 (2, False), (2, True)],
            )],
            device=device,
        )
    with span("build.mesh"):
        inside = points_inside(stl, dom.centers)

    with span("build.blocks"):
        fluid = make_fluid()
        T_inf, p_inf = 288.15, 101325.0
        a = float(np.sqrt(1.4 * 283.0 * T_inf))
        P_inf = np.array([p_inf, T_inf, mach * a, 0.0, 0.0],
                         dtype=np.float32)
        farfield_bc = flow_bc(fluid, P_inf, device=device)
        wall_bc = flow_bc(fluid, [p_inf, T_inf, 0.0], normal_flow=True,
                          device=device)
        bc_fns = {
            "farfield": lambda Pi, nrm: apply_flow_bc(farfield_bc, Pi,
                                                      nrm),
            "wall": lambda Pi, nrm: apply_flow_bc(wall_bc, Pi, nrm),
        }

        active = torch.as_tensor((~inside).astype(np.float32),
                                 device=device)
        case = Sphere3dCase(
            dom=dom, fluid=fluid, P_inf=P_inf, mach=mach, cfl=cfl,
            high_order=high_order, bc_fns=bc_fns, bt=None, bc=None,
            active_cs=None, active3=None, fb=None, active=None, P0=None,
            build_seconds=0.0)
        if use_blocks:
            case.bt, case.bc = tables_from_numpy(
                build_block_tables(dom), _collect_families(dom, FAMILIES),
                FAMILIES, device)
            case.active3 = to_blocks(case.bt, active[:, None])[..., 0]
            case.active_cs = cs_split(case.bt, case.active3[..., None])
            case.P0 = case.apply_bcs(_initial_state(P_inf, inside, device))
        else:
            _use_gather(case, active, inside)
        _sync(device)
    case.build_seconds = time.perf_counter() - t0
    return case


def gather_case(case: Sphere3dCase) -> Sphere3dCase:
    """``case`` on the generic gather march, sharing its `Domain`: what
    `build_sphere3d(..., use_blocks=False)` builds on that Domain (the
    fused ghost BC, the partition tables and the initial state), without
    a second host build. ``build_seconds`` counts the gather tables only.
    A case already on the gather march is returned as it is."""
    if case.bt is None:
        return case
    t0 = time.perf_counter()
    active = to_flat(case.bt, case.active3[..., None])[:, 0]
    g = dataclasses.replace(case, bt=None, bc=None, active_cs=None,
                            active3=None, P0=None)
    _use_gather(g, active, (active == 0).cpu().numpy())
    _sync(active.device)
    g.build_seconds = time.perf_counter() - t0
    return g


def _use_gather(case, active, inside):
    """Put ``case`` on the gather march: the fused ghost BC, the solved
    mask ``active`` (f32[N]), the partition tables (built here) and the
    initial state, with ``inside`` (bool[N]) the solid cells."""
    case.fb = case.dom.fused_boundary(list(FAMILIES))
    case.active = active
    case.dom.partitions
    case.P0 = case.apply_bcs(_initial_state(case.P_inf, inside,
                                            active.device))


def _initial_state(P_inf, inside, device):
    """The freestream, at rest in the solid cells ``inside``."""
    P0 = np.tile(P_inf, (inside.shape[0], 1))
    P0[inside, 2:] = 0.0
    return torch.as_tensor(P0, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
