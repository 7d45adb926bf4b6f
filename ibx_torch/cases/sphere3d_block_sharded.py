"""Sharded block march of the 3D STL-sphere Euler case (counterpart of
`ibx/cases/sphere3d_block_sharded.py`).

The numerics of the single-device 3D block marches (`cases.sphere3d`), run
on every rank of the process group over its chunk of blocks. Where every
rank's local tables admit it (`ShardedBlockDomain.cs_eligible`), the
default is the channel-split march: `rhs_cs.euler_rhs_cs` (kernel passes A
and B, the pre-added gradient variant: the sharded march never folds) on
the exchanged local grid, `kernels.rk2_update` on the own-chunk grids and
the rank's `GhostBC.apply_cs`; on the CPU the same code runs the kernels'
plain versions. ``use_cs=False`` takes the cell-major grid march
(`block_ops.euler_rhs_grid`, whose kernel route runs passes A and B
through the cs shim on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.block_ops import euler_rhs_grid
from ..ops.kernels import rk2_update
from ..ops.rhs_cs import euler_rhs_cs
from ..parallel.block_sharding import ShardedBlockDomain
from ..parallel.sharding import make_device_mesh
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import (physicality_guard, primitive2state,
                             state2primitive_guarded)
from ..topology.domain import require_device
from ..utils.graphs import graphed_call, march_loop
from .rae2822_block_sharded import _freeze_mask
from .sphere3d import build_sphere3d


def build_sphere3d_block_sharded(
    n_devices: int,
    *,
    wall_h: float = 0.1,
    cfl: float = 0.7,
    high_order: bool = True,
    use_cs: bool = None,
    case=None,
    device="cuda",
    **kwargs,
):
    """Returns ``(sbd, step, P0_sh, case)`` on this rank: ``step(P_sh) ->
    (P_sh, resnorm)`` on this rank's own state (``[chunk, 5, bs, bs*bs]``
    on the channel-split march, ``[chunk, bs, bs, bs, 5]`` on the grid
    march), ``sbd.march(P_sh, n)``; ``sbd.distribute`` / ``sbd.collect``
    take the march's layout. Every rank of the initialised process group
    (``n_devices`` of them) calls it. ``step`` and ``march`` run the step
    captured in a CUDA graph on a CUDA state over an ``nccl`` mesh
    (`utils.graphs`, the graphs held by ``sbd``; the kernels' launch
    counts are added on every replay), eagerly on the CPU and on a staged
    mesh; ``graph=False`` is the eager step anywhere.

    ``use_cs``: None (default) takes the channel-split march where
    `ShardedBlockDomain.cs_eligible` holds, the grid march elsewhere; True
    or False forces one (True raises where the tables do not admit it).
    ``case`` reuses a prebuilt single-device block case on this rank's
    device. ``device``: the card unless the caller asks for the CPU. ``cfl`` is
    the march's own, with ``case`` too (as in the JAX package).
    ``device`` is ignored with ``case``."""
    if case is None:
        device = require_device("build_sphere3d_block_sharded", device)
        case = build_sphere3d(wall_h=wall_h, cfl=cfl, high_order=high_order,
                              device=device, **kwargs)
    mesh = make_device_mesh(n_devices, device=case.dom.device)
    sbd = ShardedBlockDomain(case.dom, mesh, bc_names=["farfield", "wall"])
    dev = mesh.device

    fluid = case.fluid
    p_inf, T_inf = float(case.P_inf[0]), float(case.P_inf[1])
    farfield_bc = flow_bc(fluid, case.P_inf, device=dev)
    wall_bc = flow_bc(fluid, [p_inf, T_inf, 0.0], normal_flow=True,
                      device=dev)
    bc_fns = {
        "farfield": lambda Pi, nrm: apply_flow_bc(farfield_bc, Pi, nrm),
        "wall": lambda Pi, nrm: apply_flow_bc(wall_bc, Pi, nrm),
    }

    active = _freeze_mask(case)[:, None]

    eligible = sbd.cs_eligible()
    if use_cs is None:
        use_cs = eligible
    elif use_cs and not eligible:
        raise ValueError("build_sphere3d_block_sharded: the local tables do "
                         "not admit the channel-split kernels (nd = 3, bs "
                         "4, 8 or 16, no generic sparse leftover)")

    if use_cs:
        active_cs = sbd.distribute_cs(active, pad_mode="zero")

        def sharded_step(ctx, Pc_own, act_own):
            def bcs(own):
                return ctx.own(ctx.bbc_cs(ctx.exchange(own), bc_fns,
                                          guard=physicality_guard))

            def rhs(own, with_dt):
                out = euler_rhs_cs(ctx.bt, fluid, ctx.exchange(own),
                                   high_order=high_order, with_dt=with_dt)
                if with_dt:
                    return ctx.own(out[0]), ctx.own(out[1])
                return ctx.own(out)

            R0, dtb = rhs(Pc_own, True)
            P1 = bcs(rk2_update(fluid, Pc_own, R0, None, dtb, act_own, cfl))
            R1 = rhs(P1, False)
            P2 = bcs(rk2_update(fluid, Pc_own, R0, R1, dtb, act_own, cfl))
            resnorm = ctx.pmax((R0[:, 0] * act_own[:, 0]).abs().max())
            return P2, resnorm

        raw = sbd.shard_fn(sharded_step)
        extra = (active_cs,)
        P0_sh = sbd.distribute_cs(case.P0)
        # the cs layout is this march's state layout: distribute / collect
        # round-trip flat <-> cs for every caller
        sbd.distribute = sbd.distribute_cs
        sbd.collect = sbd.collect_cs
    else:
        active_sh = sbd.distribute(active, pad_mode="zero")[..., 0]

        def sharded_step(ctx, P_own, active_own):
            def bcs(own):
                return ctx.own(ctx.bbc(ctx.exchange(own), bc_fns,
                                       guard=physicality_guard))

            R0, dt3, _ = euler_rhs_grid(ctx.bt, fluid, ctx.exchange(P_own),
                                        with_dt=True, cfl=cfl,
                                        high_order=high_order)
            R0 = ctx.own(R0)
            dt3 = ctx.own(dt3)
            dt = torch.where(active_own > 0, dt3,
                             torch.zeros_like(dt3))[..., None]
            Q0 = primitive2state(fluid, P_own)
            P1 = bcs(state2primitive_guarded(fluid, Q0 + dt * R0))
            R1 = ctx.own(euler_rhs_grid(ctx.bt, fluid, ctx.exchange(P1),
                                        high_order=high_order))
            P2 = bcs(state2primitive_guarded(fluid,
                                             Q0 + dt * (R0 + R1) / 2))
            resnorm = ctx.pmax((R0[..., 0] * active_own).abs().max())
            return P2, resnorm

        raw = sbd.shard_fn(sharded_step)
        extra = (active_sh,)
        P0_sh = sbd.distribute(case.P0)

    def one(P_sh):
        return raw(P_sh, *extra)

    def step(P_sh, *, graph: Optional[bool] = None):
        return graphed_call(sbd._graphs, "step", one, P_sh, graph,
                            sbd.mesh)

    def march(P_sh, n_steps: int, *, graph: Optional[bool] = None):
        return march_loop(sbd._graphs, "step", one, P_sh, n_steps, graph,
                          sbd.mesh)

    sbd.march = march
    sbd.use_cs = bool(use_cs)
    return sbd, step, P0_sh, case
