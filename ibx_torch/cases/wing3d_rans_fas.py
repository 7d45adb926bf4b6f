"""Workload 5: the 3D RANS wing with FAS multigrid over the ranks of a
process group (counterpart of `ibx/cases/wing3d_rans_fas.py`).

It composes the port's pieces as the JAX package does:

  * a straight wing lofted from the committed RAE2822 section
    (`geometry.stereolitography.loft_polyline`) in a cubic farfield box;
  * RANS on the block march (`solve.rans.rans_rhs_grid` /
    `rans_rk2_grid`): Navier-Stokes, Wray-Agarwal transport and the
    wall-function du/dn wall BC;
  * the sharded block march (`parallel.ShardedBlockDomain`): the fine
    level smooths on each rank's chunk of blocks with halo exchanges;
  * a 2-level FAS V-cycle whose coarse level (bs/2) runs replicated on
    every rank: the fine state and residual are all-gathered, restricted
    with the IDW coarsener, relaxed ``n_coarse_iter`` times with the tau
    correction, and the prolonged correction is added to each rank's own
    blocks.

The JAX package compiles the march, the step and the cycle (its coarse
relaxation a ``fori_loop``); here each is one step captured in a CUDA
graph on the card over an ``nccl`` mesh (`utils.graphs`: the coarse
relaxation is a Python loop of ``n_coarse_iter`` iterations inside the
captured cycle) and eager on the CPU and on a staged gloo mesh.
`res_norms` and `res_field` stay eager: single calls, nothing to replay.
No kernel lies on this path in either package (the RHS is viscous and
carries ``mu_t``).
The V-cycle is counterproductive on this case in both packages: the coarse
wall-function level re-injects near-wall error (BASELINE.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..convert import tables_from_numpy
from ..geometry import build_mesh, load_surface, merge_points
from ..geometry.inside import points_inside
from ..geometry.stereolitography import loft_polyline
from ..ops.block_ops import to_blocks, to_flat
from ..ops.stencil import apply_stencil
from ..parallel.block_sharding import ShardedBlockDomain
from ..parallel.sharding import make_device_mesh
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import (adjust_reynolds, make_fluid, physicality_guard,
                             primitive2state, state2primitive_guarded)
from ..solve.multigrid_domain import multigrid
from ..solve.rans import rans_rhs_grid, rans_rk2_grid
from ..topology.blocked_bc import _collect_families
from ..topology.blocks import build_block_tables
from ..topology.domain import Domain, require_device
from ..utils.graphs import graphed_call, march_loop
from .rae2822 import RAE_DAT
from .rae2822_rans import freestream_rt, wall_state_fn


@dataclasses.dataclass
class Wing3dCase:
    dom: Domain
    sbd: ShardedBlockDomain
    fluid: object
    P_inf: np.ndarray
    Rt_inf: float
    march: Callable      # (S_sh, n, graph=None) -> S_sh (sharded RK2)
    fas_cycle: Callable  # (S_sh, graph=None) -> (S_sh, res) (V-cycle)
    step: Callable       # (S_sh, graph=None) -> (S_sh, res) (one step)
    S0_sh: torch.Tensor  # this rank's fused [chunk, bs.., nch+1] state
    collect: Callable    # own grids -> global flat numpy (a collective)
    res_norms: Callable = None  # (S_sh,) -> (l2, max) of dt*R
    res_field: Callable = None  # (S_sh,) -> own dt*R grids


def build_wing3d_rans_fas(
    n_devices: int,
    *,
    wall_h: float = 0.08,
    span: float = 1.0,
    farfield: float = 8.0,
    block_size: int = 8,
    mach: float = 0.4,
    alpha_deg: float = 2.0,
    reynolds: float = 1e6,
    cfl: float = 0.5,
    high_order: bool = True,
    n_coarse_iter: int = 8,
    verbose: bool = False,
    device="cuda",
) -> Wing3dCase:
    """Build the wing on this rank. Every rank of the initialised process
    group (``n_devices`` of them) calls it; ``device`` is the rank's (the
    card unless the caller asks for the CPU). Same parameters as the JAX
    package's `build_wing3d_rans_fas`; ``verbose`` is taken for that
    signature and prints nothing (the build's stages are host spans,
    `ibx_torch.utils.monitor`)."""
    device = require_device("build_wing3d_rans_fas", device)
    mesh = make_device_mesh(n_devices, device=device)

    # ---- geometry: straight wing lofted from the RAE2822 section --------
    section = merge_points(load_surface(RAE_DAT))
    stl = merge_points(loft_polyline(section, 0.0, span, n_sections=2))
    msh = build_mesh(
        [-farfield, -farfield, -farfield + span / 2],
        [2 * farfield] * 3,
        ("wall", stl, wall_h),
        block_size=block_size,
    )
    dom = Domain(
        msh,
        hypercube_families=[(
            "farfield",
            [(0, False), (0, True), (1, False), (1, True),
             (2, False), (2, True)],
        )],
        device=device,
    )
    nch = 5

    # ---- fluid / freestream ---------------------------------------------
    T_inf, p_inf = 288.15, 101325.0
    a = float(np.sqrt(1.4 * 283.0 * T_inf))
    V = mach * a
    al = np.deg2rad(alpha_deg)
    P_inf = np.array(
        [p_inf, T_inf, V * np.cos(al), V * np.sin(al), 0.0], np.float32)
    fluid = adjust_reynolds(make_fluid(), P_inf, 1.0, reynolds)
    Rt_inf = freestream_rt(fluid, T_inf, p_inf)

    farfield_bc = flow_bc(fluid, P_inf, device=device)
    wall_bc = flow_bc(fluid, [p_inf, T_inf, 0.0], normal_flow=True,
                      device=device)
    wall_state = wall_state_fn(fluid)

    def wall_fn(Si, nrm, imd):
        Pi = Si[:, :nch]
        ws = wall_state(Pi, nrm, imd)
        Pb = apply_flow_bc(wall_bc, Pi, nrm,
                           image_distances=imd, du_dn=ws.du_dn)
        return torch.cat([Pb, ws.nu_t[:, None]], dim=1)

    def far_fn(Si, nrm):
        return torch.cat([
            apply_flow_bc(farfield_bc, Si[:, :nch], nrm),
            torch.full_like(Si[:, nch:nch + 1], Rt_inf),
        ], dim=1)

    # family order must match dom._host_boundaries iteration order (the
    # sharded ctx.bc resolves families by that enumeration)
    fns_by_name = {"wall": wall_fn, "farfield": far_fn}
    bc_fns = {name: fns_by_name[name] for name in dom._host_boundaries}

    def guard_s(g):
        return torch.cat([
            physicality_guard(g[:, :nch]),
            g[:, nch:nch + 1].clamp(min=0.0),
        ], dim=1)

    inside = points_inside(stl, dom.centers)
    active = (~inside).astype(np.float32)

    # ---- coarse level (replicated): bs/2 domain + transfers --------------
    hier = multigrid(dom, 1)
    cdom = hier.coarse_domains[0]
    names_c = list(cdom._host_boundaries)
    bt_c, bbc_c = tables_from_numpy(
        build_block_tables(cdom), _collect_families(cdom, names_c), names_c,
        device)
    active_c = to_blocks(bt_c, torch.as_tensor(
        (~points_inside(stl, cdom.centers)).astype(np.float32)[:, None],
        device=device))[..., 0]
    # the GhostBC's own row order: the wall callback reads every row and
    # the blend keeps the wall family's
    imd_c = bbc_c.image_distances

    def wall_fn_c(Si, nrm):
        return wall_fn(Si, nrm, imd_c)

    bc_fns_c = {"wall": wall_fn_c, "farfield": far_fn}

    def apply_bcs_c(S3c):
        return bbc_c.apply_grid(S3c, bc_fns_c, guard=guard_s)

    rep = dict(coarsen=hier.coarseners[0], prolong=hier.prolongators[0])

    # ---- sharded runtime --------------------------------------------------
    sbd = ShardedBlockDomain(dom, mesh)
    active_sh = sbd.distribute(active[:, None], pad_mode="zero")[..., 0]

    def own_rhs(ctx, S_own, mask_own):
        """(R, T, dt) on own blocks from the exchanged local grid, dt zero
        where ``mask_own`` is (pad blocks have no faces: dt = inf)."""
        loc = ctx.exchange(S_own)
        R, T, dt = rans_rhs_grid(ctx.bt, fluid, loc, cfl=cfl,
                                 high_order=high_order)
        dt = torch.where(mask_own > 0, ctx.own(dt), torch.zeros_like(
            ctx.own(dt)))
        return ctx.own(R), ctx.own(T), dt

    def own_update(ctx, S_own, mask_own):
        """dt * [R, T] on own blocks [chunk, bs.., nch+1]."""
        R, T, dt = own_rhs(ctx, S_own, mask_own)
        return torch.cat([R, T[..., None]], dim=-1) * dt[..., None]

    def sharded_smooth(ctx, S_own, active_own):
        def apply_bcs3(own):
            return ctx.own(ctx.bc(ctx.exchange(own), bc_fns, guard=guard_s))

        S2, res = rans_rk2_grid(
            ctx.bt, fluid, S_own, apply_bcs3, cfl=cfl,
            high_order=high_order, active3=active_own,
            rhs_fn=lambda own: own_rhs(ctx, own, active_own))
        return S2, ctx.pmax(res)

    # conserved fused state for the FAS transfers: [Q_flow(nch), Rt]
    def to_Q(S):
        return torch.cat([primitive2state(fluid, S[..., :nch]),
                          S[..., nch:]], dim=-1)

    def to_S(Q):
        return torch.cat([state2primitive_guarded(fluid, Q[..., :nch]),
                          Q[..., nch:].clamp(min=0.0)], dim=-1)

    def coarse_r(S3c):
        """Coarse-level r = dt * R on the replicated bs/2 block grid."""
        R, T, dt = rans_rhs_grid(bt_c, fluid, S3c, cfl=cfl,
                                 high_order=high_order)
        dt = dt * active_c
        return torch.cat([R, T[..., None]], dim=-1) * dt[..., None]

    def fc(Qc):
        S3c = apply_bcs_c(to_blocks(bt_c, to_S(Qc)))
        return to_flat(bt_c, coarse_r(S3c))

    def sharded_fas_cycle(ctx, S_own, active_own):
        """One 2-level FAS V-cycle (reference ``src/solver.jl:39-91``
        with a fixed coarse iteration count): pre-smooth (sharded) ->
        coarse tau-corrected relaxation (replicated) -> prolonged
        correction -> post-smooth (sharded)."""
        S_own, _ = sharded_smooth(ctx, S_own, active_own)

        r_own = own_update(ctx, S_own, active_own)
        S_glob = ctx.all_gather_flat(S_own)          # replicated [N, C]
        r_glob = ctx.all_gather_flat(r_own)

        Qc0 = apply_stencil(ctx.rep["coarsen"], to_Q(S_glob))
        rc0 = apply_stencil(ctx.rep["coarsen"], r_glob)
        source = rc0 - fc(Qc0)                       # tau correction
        Qc = Qc0
        for _ in range(n_coarse_iter):
            Qc = Qc + fc(Qc) + source

        corr = apply_stencil(ctx.rep["prolong"], Qc - Qc0)
        Q_own = to_Q(S_own) + ctx.own_flat(corr) * active_own[..., None]
        S_own = ctx.own(ctx.bc(ctx.exchange(to_S(Q_own)), bc_fns,
                               guard=guard_s))

        return sharded_smooth(ctx, S_own, active_own)

    raw_smooth = sbd.shard_fn(sharded_smooth)
    raw_cycle = sbd.shard_fn(sharded_fas_cycle, replicated=rep)

    def smooth_one(S_sh):
        return raw_smooth(S_sh, active_sh)

    def cycle_one(S_sh):
        return raw_cycle(S_sh, active_sh)

    # captured on a CUDA state over an nccl mesh (one graph for the step
    # and the march, one for the cycle with its coarse loop), eager on the
    # CPU and on a staged mesh; graph=False is eager anywhere
    def march(S_sh, n: int, *, graph: Optional[bool] = None):
        return march_loop(sbd._graphs, "step", smooth_one, S_sh, n, graph,
                          mesh)

    def fas_cycle(S_sh, *, graph: Optional[bool] = None):
        return graphed_call(sbd._graphs, "cycle", cycle_one, S_sh, graph,
                            mesh)

    def step(S_sh, *, graph: Optional[bool] = None):
        return graphed_call(sbd._graphs, "step", smooth_one, S_sh, graph,
                            mesh)

    # SOLVED-cell metric mask: the march freezes only in-solid cells, but
    # the convergence functional also excludes ghost cells: the BC
    # overwrites them each step, so their dt*R never relaxes and would
    # floor every residual curve.
    ghost_m = np.zeros(dom.ncells, bool)
    for hb in dom._host_boundaries.values():
        ghost_m[hb.ghosts] = True
    solved_sh = sbd.distribute(
        (active * (~ghost_m)).astype(np.float32)[:, None],
        pad_mode="zero")[..., 0]

    def sharded_resnorm(ctx, S_own, solved_own):
        """L2 and max of dt*R over solved cells (a raw-RHS max-norm is
        pinned by the smallest near-wall cells)."""
        r = own_update(ctx, S_own, solved_own)
        l2 = ctx.psum((r ** 2).sum())
        mx = ctx.pmax(r.abs().max())
        return torch.sqrt(l2), mx

    raw_rn = sbd.shard_fn(sharded_resnorm)

    def res_norms(S_sh):
        return raw_rn(S_sh, solved_sh)

    raw_rf = sbd.shard_fn(lambda ctx, S_own, solved_own:
                          own_update(ctx, S_own, solved_own))

    def res_field(S_sh):
        return raw_rf(S_sh, solved_sh)[0]

    # ---- initial state -----------------------------------------------------
    S0 = np.concatenate([
        np.tile(P_inf, (dom.ncells, 1)),
        np.full((dom.ncells, 1), Rt_inf, np.float32),
    ], axis=1)
    S0[inside, 2:5] = 0.0
    bc_only = sbd.shard_fn(lambda ctx, S_own: ctx.own(
        ctx.bc(ctx.exchange(S_own), bc_fns, guard=guard_s)))
    S0_sh = bc_only(sbd.distribute(S0))[0]

    return Wing3dCase(
        dom=dom, sbd=sbd, fluid=fluid, P_inf=P_inf, Rt_inf=Rt_inf,
        march=march, fas_cycle=fas_cycle, step=step, S0_sh=S0_sh,
        collect=sbd.collect, res_norms=res_norms, res_field=res_field,
    )
