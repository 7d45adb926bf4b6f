"""Sharded gather march of the RAE2822 Euler case (counterpart of
`ibx/cases/rae2822_sharded.py`): the multi-partition march.

The physics of `cases.rae2822` on the generic gather path, run on every
rank of the process group over its partition (with skirt), with a halo
exchange after each BC family and each RK stage. No kernel lies on it, in
either package.
"""

from __future__ import annotations

from typing import Optional

from ..parallel.sharding import (ShardedDomain, make_device_mesh,
                                 sharded_impose_bc)
from ..physics.bc import apply_flow_bc, flow_bc
from ..physics.fluid import primitive2state, state2primitive
from ..solve.euler import euler_rhs, local_timestep
from ..topology.domain import require_device
from ..utils.graphs import graphed_call
from .rae2822 import build_rae2822


def build_rae2822_sharded(
    n_devices: int,
    *,
    wall_h: float = 4e-2,
    feature_h: float = 2e-2,
    cfl: float = 0.7,
    case=None,
    device="cuda",
    **kwargs,
):
    """Returns ``(sdom, step, P0_sh, case)`` on this rank: ``step(P_sh) ->
    (P_sh,)`` on this rank's own rows ``[n_own, 4]``, ``P0_sh`` its share
    of the initial state. Every rank of the initialised process group
    (``n_devices`` of them) calls it; the case is built with
    ``n_partitions=n_devices``. ``case`` reuses a prebuilt case of
    ``n_devices`` partitions (a gather case, for one rank) on this rank's
    device; ``device`` (the card unless the caller asks for the CPU) is
    ignored with it. ``cfl`` is the step's own, with ``case`` too.

    On a CUDA state over an ``nccl`` mesh each ``step`` call replays the
    step captured in a CUDA graph (`utils.graphs`, the graph held by
    ``sdom``); it runs eagerly on the CPU and on a staged mesh, and
    ``step(P_sh, graph=False)`` is the eager step anywhere."""
    if case is None:
        device = require_device("build_rae2822_sharded", device)
        case = build_rae2822(wall_h=wall_h, feature_h=feature_h, cfl=cfl,
                             n_partitions=n_devices, device=device,
                             **kwargs)
    elif case.dom.n_partitions != n_devices:
        raise ValueError(f"build_rae2822_sharded: the case has "
                         f"{case.dom.n_partitions} partitions, not "
                         f"{n_devices}")
    mesh = make_device_mesh(n_devices, device=case.dom.device)
    sdom = ShardedDomain(case.dom, mesh)
    dev = mesh.device

    fluid = case.fluid
    farfield_bc = flow_bc(fluid, case.P_inf, device=dev)
    wall_bc = flow_bc(fluid, [float(case.P_inf[0]), float(case.P_inf[1]),
                              0.0], normal_flow=True, device=dev)

    def sharded_step(ctx, P):
        part = ctx.part

        def apply_bcs(P):
            P = sharded_impose_bc(
                ctx, ctx.boundary("farfield"),
                lambda b, Pi: apply_flow_bc(farfield_bc, Pi, b.normals), P)
            P = ctx.refresh(P)
            P = sharded_impose_bc(
                ctx, ctx.boundary("wall"),
                lambda b, Pi: apply_flow_bc(wall_bc, Pi, b.normals), P)
            return ctx.refresh(P)

        P = apply_bcs(P)
        dt = local_timestep(part, fluid, P, cfl)[:, None]
        Q0 = primitive2state(fluid, P)
        R0 = euler_rhs(part, fluid, P)
        P1 = apply_bcs(state2primitive(fluid, Q0 + dt * R0))
        R1 = euler_rhs(part, fluid, P1)
        P2 = state2primitive(fluid, Q0 + dt * (R0 + R1) / 2)
        return apply_bcs(P2)

    raw = sdom.shard_fn(sharded_step)

    def one(P_sh):
        return raw(P_sh)[0], None

    def step(P_sh, *, graph: Optional[bool] = None):
        return (graphed_call(sdom._graphs, "step", one, P_sh, graph,
                             mesh)[0],)

    P0_sh = sdom.distribute(case.P0)
    return sdom, step, P0_sh, case
