"""Sharded block march of the RAE2822 Euler case (counterpart of
`ibx/cases/rae2822_block_sharded.py`).

The numerics of the single-device block march (`cases.rae2822` with
``use_blocks=True``), run on every rank of the process group over its
chunk of blocks: block-partitioned state, halo exchange per RK stage and
per BC application, the block RHS on each rank's local grid. That RHS
takes the 2D kernel route where the gate admits the local tables (one
rank); several ranks leave sparse leftover faces at halo blocks, which
keep the torch-op body. The JAX package has no 2D kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.block_ops import euler_rhs_grid
from ..parallel.block_sharding import ShardedBlockDomain
from ..parallel.sharding import make_device_mesh
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import (physicality_guard, primitive2state,
                             state2primitive_guarded)
from ..topology.domain import require_device
from ..utils.graphs import graphed_call, march_loop
from .rae2822 import build_rae2822


def _freeze_mask(case):
    """The case's flat 0/1 freeze mask (cells outside the solid), as its
    own march uses it. The JAX package's sharded builders recompute it
    with `points_inside` on the mesh's refined wall surface (ten times
    the segments of the airfoil's, 1308 against 128 at wall_h=5e-3): the
    same cells on every tested mesh, at ten times the host's work."""
    return (case.active3.reshape(-1) if case.active3 is not None
            else case.active)


def build_rae2822_block_sharded(
    n_devices: int,
    *,
    wall_h: float = 4e-2,
    feature_h: float = 2e-2,
    cfl: float = 0.7,
    high_order: bool = True,
    te_fix_radius: float = 0.0,
    overlap: bool = False,
    case=None,
    device="cuda",
    **kwargs,
):
    """Returns ``(sbd, step, P0_sh, case)`` on this rank: ``step(P_sh) ->
    (P_sh, resnorm)`` on own grids ``[chunk, bs, bs, 4]``, ``P0_sh`` this
    rank's share of the initial state, ``sbd.march(P_sh, n)``. Every rank
    of the initialised process group (``n_devices`` of them) calls it.
    ``step`` and ``march`` run the step captured in a CUDA graph on a
    CUDA state over an ``nccl`` mesh (`utils.graphs`, the graphs held by
    ``sbd``), eagerly on the CPU and on a staged mesh; ``graph=False`` is
    the eager step anywhere.

    ``case`` reuses a prebuilt single-device case (built with the
    keywords that matter to the numerics: the step re-derives its BCs and
    fix field from the case's domain), on this rank's device. ``device``:
    the card unless the caller asks for the CPU. ``cfl`` is
    the march's own, with ``case`` too (as in the JAX package).
    ``device`` is ignored with ``case``."""
    if case is None:
        device = require_device("build_rae2822_block_sharded", device)
        case = build_rae2822(
            wall_h=wall_h, feature_h=feature_h, cfl=cfl, n_partitions=1,
            high_order=high_order, te_fix_radius=te_fix_radius,
            device=device, **kwargs)
    mesh = make_device_mesh(n_devices, device=case.dom.device)
    sbd = ShardedBlockDomain(case.dom, mesh, overlap=overlap,
                             bc_names=["farfield", "wall"])
    dev = mesh.device

    fluid = case.fluid
    farfield_bc = flow_bc(fluid, case.P_inf, device=dev)
    wall_bc = flow_bc(fluid, [float(case.P_inf[0]), 288.15, 0.0],
                      normal_flow=True, device=dev)
    bc_fns = {
        "farfield": lambda Pi, nrm: apply_flow_bc(farfield_bc, Pi, nrm),
        "wall": lambda Pi, nrm: apply_flow_bc(wall_bc, Pi, nrm),
    }

    active_sh = sbd.distribute(_freeze_mask(case)[:, None],
                               pad_mode="zero")[..., 0]

    # static per-cell TE fix blend in LOCAL layout (halo slots included, so
    # chunk-edge faces see it; no per-step exchange: it never changes)
    fix_loc = None
    if te_fix_radius > 0.0:
        stl = case.dom.mesh.distance_fields["wall"].stl
        te = stl.points[int(np.argmax(stl.points[:, 0]))]
        d_te = np.sqrt(((case.dom.centers - te[None, :]) ** 2).sum(1))
        f = np.clip((2.0 * te_fix_radius - d_te) / te_fix_radius,
                    0.0, 1.0).astype(np.float32)
        fix_loc = sbd.distribute_local(f[:, None])

    def sharded_step(ctx, P_own, active_own, *rest):
        fix3 = rest[0] if rest else None
        use_overlap = getattr(ctx, "bt_own", None) is not None

        def bcs(own):
            # this rank's GhostBC on the local [B_loc, bs, bs, 4] grid
            return ctx.own(ctx.bbc(ctx.exchange(own), bc_fns,
                                   guard=physicality_guard))

        def rhs(own, with_dt):
            """Own-rows RHS; with overlap the interior pass is issued
            while the exchange is in flight."""
            if not use_overlap:
                out = euler_rhs_grid(ctx.bt, fluid, ctx.exchange(own),
                                     with_dt=with_dt, cfl=cfl,
                                     high_order=high_order, fix3=fix3)
                if with_dt:
                    return ctx.own(out[0]), ctx.own(out[1])
                return ctx.own(out)
            pending = ctx.exchange_start(own)
            fix_own = None if fix3 is None else ctx.with_dump(
                fix3[: own.shape[0]])
            out_i = euler_rhs_grid(ctx.bt_own, fluid, ctx.with_dump(own),
                                   with_dt=with_dt, cfl=cfl,
                                   high_order=high_order, fix3=fix_own)
            loc = pending.wait()
            fix_sub = None if fix3 is None else ctx.subgrid(fix3)
            out_f = euler_rhs_grid(ctx.bt_sub, fluid, ctx.subgrid(loc),
                                   with_dt=with_dt, cfl=cfl,
                                   high_order=high_order, fix3=fix_sub)
            if with_dt:
                return (ctx.merge(out_i[0], out_f[0]),
                        ctx.merge(out_i[1][..., None],
                                  out_f[1][..., None])[..., 0])
            return ctx.merge(out_i, out_f)

        R0, dt3 = rhs(P_own, True)
        # where(), not multiply: pad blocks have no faces -> dt3 = inf there
        dt = torch.where(active_own > 0, dt3, torch.zeros_like(dt3))[..., None]
        Q0 = primitive2state(fluid, P_own)
        P1 = bcs(state2primitive_guarded(fluid, Q0 + dt * R0))
        R1 = rhs(P1, False)
        P2 = bcs(state2primitive_guarded(fluid, Q0 + dt * (R0 + R1) / 2))
        resnorm = ctx.pmax((R0[..., 0] * active_own).abs().max())
        return P2, resnorm

    raw = sbd.shard_fn(sharded_step)
    extra = () if fix_loc is None else (fix_loc,)

    def one(P_sh):
        return raw(P_sh, active_sh, *extra)

    def step(P_sh, *, graph: Optional[bool] = None):
        return graphed_call(sbd._graphs, "step", one, P_sh, graph,
                            sbd.mesh)

    def march(P_sh, n_steps: int, *, graph: Optional[bool] = None):
        return march_loop(sbd._graphs, "step", one, P_sh, n_steps, graph,
                          sbd.mesh)

    P0_sh = sbd.distribute(case.P0)
    sbd.march = march
    return sbd, step, P0_sh, case
