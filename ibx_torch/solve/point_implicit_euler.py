"""Point-implicit pseudo-time stepping for the Euler march (counterpart of
`ibx/solve/point_implicit_euler.py`).

The reference ships this solver as orphaned capability
(``src/point_implicit.jl``, never included by the main module). Here it
runs on the real physics: one backward-Euler pseudo step solves

    (I / dt - dR/dQ) dQ = R(Q_n)

with Hutchinson-estimated block-diagonal preconditioning and the
two-direction minimal-residual descent, all matrix-free via exact
forward-mode JVPs (`torch.func.jvp`) through the flat-state block RHS
`ops.block_ops.euler_rhs_block` and the caller's ghost BC. At nd = 2 that
RHS is torch ops only. At nd = 3 it would reach the CUDA passes A and B,
which have no forward derivative: the step refuses nd = 3.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.block_ops import euler_rhs_block
from ..physics.fluid import (Fluid, physicality_guard, primitive2state,
                             state2primitive)
from ..topology.blocks import BlockTables
from .point_implicit import linearize, solve


def newton_map(bt: BlockTables, fluid: Fluid, P, apply_bcs: Callable, *,
               cfl: float = 10.0, active=None, high_order: bool = True,
               freeze_limiter: bool = False):
    """(g, Qn): the backward-Euler residual ``g(Q) = (Q - Qn) / dt -
    R(Q)`` of one pseudo step from the primitives ``P``, and ``Qn``, the
    conserved state it linearizes at (see `point_implicit_step`)."""
    if bt.nd != 2:
        raise NotImplementedError(
            "point_implicit_step: nd = 3 needs forward-mode derivatives of "
            "the CUDA passes A and B, which ibx_torch does not have yet "
            "(ROADMAP queue 1 item 11)")
    Qn = primitive2state(fluid, torch.as_tensor(P))

    # pseudo-time scale from the explicit bound, relaxed by the implicit CFL
    Pb = apply_bcs(physicality_guard(state2primitive(fluid, Qn)))
    _, dt, frozen_n = euler_rhs_block(bt, fluid, Pb, with_dt=True, cfl=cfl,
                                      high_order=high_order)
    frozen = frozen_n if freeze_limiter else None

    def residual(Q):
        Pq = physicality_guard(state2primitive(fluid, Q))
        Pq = apply_bcs(Pq)
        R = euler_rhs_block(bt, fluid, Pq, high_order=high_order,
                            frozen=frozen)
        if active is not None:
            R = R * active[:, None]
        return R
    if active is not None:
        dt = dt * active + (1.0 - active)  # frozen cells: dt=1, R=0
    inv_dt = (1.0 / dt)[:, None]

    def g(Q):
        return (Q - Qn) * inv_dt - residual(Q)

    return g, Qn


def point_implicit_step(
    bt: BlockTables,
    fluid: Fluid,
    P,
    apply_bcs: Callable,
    *,
    cfl: float = 10.0,
    active=None,
    n_hutchinson_samples: int = 8,
    n_krylov: int = 8,
    relax: float = 1.0,
    high_order: bool = True,
    freeze_limiter: bool = False,
    generator: Optional[torch.Generator] = None,
):
    """One backward-Euler pseudo step with point-implicit preconditioning,
    on a 2D block mesh (``bt.nd == 2``; nd = 3 raises
    `NotImplementedError`).

    ``P`` is the flat [N, 4] primitive state and ``apply_bcs`` the ghost BC
    on it; both must admit forward-mode JVPs (torch ops, in-place writes
    included). ``freeze_limiter=True`` linearizes through the
    frozen-gradient/sensor RHS (minmod arguments and JST sensor held at
    their Q_n values): the limiter's kinks make the exact Jacobian wildly
    indefinite on shocked meshes. The step's right-hand side is unchanged
    (the frozen residual equals the true residual at Q_n), only the
    Jacobian-vector products smooth out. ``generator`` draws the
    Hutchinson probes (a generator seeded 0 on P's device by default).

    Returns (P_new, linear_residual_ratio).
    """
    g, Qn = newton_map(bt, fluid, P, apply_bcs, cfl=cfl, active=active,
                       high_order=high_order, freeze_limiter=freeze_limiter)
    A, b, prec = linearize(g, Qn, n_hutchinson_samples=n_hutchinson_samples,
                           generator=generator)
    dQ, ratio = solve(A, b, prec, n_iter=n_krylov, rtol=1e-2)
    Q1 = Qn + relax * dQ
    P1 = apply_bcs(physicality_guard(state2primitive(fluid, Q1)))
    return P1, ratio
