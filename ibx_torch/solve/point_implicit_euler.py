"""Point-implicit pseudo-time stepping for the Euler march (counterpart of
`ibx/solve/point_implicit_euler.py`).

The reference ships this solver as orphaned capability
(``src/point_implicit.jl``, never included by the main module). Here it
runs on the real physics: one backward-Euler pseudo step solves

    (I / dt - dR/dQ) dQ = R(Q_n)

with Hutchinson-estimated block-diagonal preconditioning and the
two-direction minimal-residual descent, all matrix-free via exact
forward-mode JVPs (`torch.func.jvp`) through the flat-state block RHS
`ops.block_ops.euler_rhs_block` and the caller's ghost BC, at nd = 2 and
3. The differentiated residual takes the RHS's torch-op body
(``kernels=False``), the route the JAX package's RHS takes off the TPU;
the CUDA passes A and B have no forward derivative. The explicit bound at
Q_n, which is not differentiated, keeps the kernel route.

On a CUDA state the step runs captured in CUDA graphs (`PointImplicitStep`,
the counterpart of the JAX package's ``jax.jit`` over the step): a head
(`newton_map`, `linearize` with its Hutchinson probes and the solve's
head), the solve's body replayed while its stop rule holds, and a tail
(``Q1``, ``P1``). One capture is kept for each `BlockTables` (``bt``),
for the step's last arguments, and freed with the tables
(`step_graphs`): a step with others (another ``cfl``, or a new
``apply_bcs``, ``active`` or ``generator`` object) captures anew and drops
it. Pass the same objects from step to step to replay one capture.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.block_ops import euler_rhs_block
from ..physics.fluid import (Fluid, physicality_guard, primitive2state,
                             state2primitive)
from ..topology.blocks import BlockTables
from ..utils.graphs import GraphedLoop, Graphs, Piece, use_graph
from .point_implicit import SolveLoop, _default_generator, linearize


def step_graphs(bt: BlockTables) -> Graphs:
    """The step's captures on ``bt``, made at its first step there. They
    are an attribute of the tables, not an entry of a module-level cache:
    a capture holds the tables it reads, so such a cache would keep them
    alive for ever, while an attribute is freed with them."""
    return vars(bt).setdefault("_point_implicit_graphs", Graphs())


def newton_map(bt: BlockTables, fluid: Fluid, P, apply_bcs: Callable, *,
               cfl: float = 10.0, active=None, high_order: bool = True,
               freeze_limiter: bool = False):
    """(g, Qn): the backward-Euler residual ``g(Q) = (Q - Qn) / dt -
    R(Q)`` of one pseudo step from the primitives ``P``, and ``Qn``, the
    conserved state it linearizes at (see `point_implicit_step`)."""
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
                            frozen=frozen, kernels=False)
        if active is not None:
            R = R * active[:, None]
        return R
    if active is not None:
        dt = dt * active + (1.0 - active)  # frozen cells: dt=1, R=0
    inv_dt = (1.0 / dt)[:, None]

    def g(Q):
        return (Q - Qn) * inv_dt - residual(Q)

    return g, Qn


class PointImplicitStep:
    """`point_implicit_step` over static buffers: the input primitives
    ``P``, the solve's buffers (`point_implicit.SolveLoop`) and the output
    ``P1``. ``step(P)`` returns ``(P1, ratio)`` (new tensors); the pieces
    run eagerly until `capture`. With ``generator=None`` the probes come
    from a generator of the step's own, seeded 0 before every step (a
    fresh generator seeded 0, as the eager step draws them)."""

    def __init__(self, bt, fluid, P, apply_bcs, *, cfl, active,
                 n_hutchinson_samples, n_krylov, relax, high_order,
                 freeze_limiter, generator):
        self.args = (bt, fluid, apply_bcs)
        self.kw = dict(cfl=cfl, active=active, high_order=high_order,
                       freeze_limiter=freeze_limiter)
        self.n_samples, self.relax = n_hutchinson_samples, relax
        self.P = P.detach().clone()
        self.own = generator is None
        self.gen = _default_generator(P) if self.own else generator
        self.solve = SolveLoop(torch.zeros_like(self.P), n_iter=n_krylov,
                               rtol=1e-2)
        self.P1 = torch.zeros_like(self.P)
        self.Qn = None
        self.loop = GraphedLoop(
            [Piece(self._head, [self.gen]), self.solve.head],
            self.solve.bodies, self.solve.pred, n_krylov,
            tail=[Piece(self._tail)], select=self.solve.select)

    def _head(self):
        bt, fluid, apply_bcs = self.args
        g, Qn = newton_map(bt, fluid, self.P, apply_bcs, **self.kw)
        A, b, prec = linearize(g, Qn, n_hutchinson_samples=self.n_samples,
                               generator=self.gen)
        self.Qn, self.solve.A, self.solve.prec = Qn, A, prec
        self.solve.b.copy_(b)

    def _tail(self):
        _, fluid, apply_bcs = self.args
        Q1 = self.Qn + self.relax * self.solve.x
        self.P1.copy_(apply_bcs(physicality_guard(state2primitive(fluid,
                                                                  Q1))))

    def capture(self, pool) -> None:
        self.loop.capture(pool)

    @property
    def iterations(self) -> int:
        return self.loop.iterations

    def __call__(self, P):
        if P.shape != self.P.shape:
            raise ValueError("the state's shape differs from the step's")
        self.P.copy_(P)
        if self.own:
            self.gen.manual_seed(0)
        self.loop()
        return self.P1.clone(), self.solve.ratio.clone()


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
    graph: Optional[bool] = None,
):
    """One backward-Euler pseudo step with point-implicit preconditioning
    on a block mesh (nd = 2 or 3).

    ``P`` is the flat [N, 4] primitive state and ``apply_bcs`` the ghost BC
    on it; both must admit forward-mode JVPs (torch ops, in-place writes
    included). ``freeze_limiter=True`` linearizes through the
    frozen-gradient/sensor RHS (minmod arguments and JST sensor held at
    their Q_n values): the limiter's kinks make the exact Jacobian wildly
    indefinite on shocked meshes. The step's right-hand side is unchanged
    (the frozen residual equals the true residual at Q_n), only the
    Jacobian-vector products smooth out. ``generator`` draws the
    Hutchinson probes (a generator seeded 0 on P's device by default).
    ``graph`` follows `utils.graphs.use_graph`: on a CUDA state the step
    is captured at its first call with these arguments and replayed while
    they stay (`PointImplicitStep`, kept for ``bt`` until a step with
    other arguments replaces it, `step_graphs`).

    Returns (P_new, linear_residual_ratio).
    """
    P = torch.as_tensor(P)
    act = None if active is None else (active.data_ptr(),
                                       tuple(active.shape),
                                       tuple(active.stride()))
    key = (fluid, apply_bcs, act, cfl, n_hutchinson_samples, n_krylov,
           relax, high_order, freeze_limiter, generator, tuple(P.shape),
           P.dtype)

    def make():
        return PointImplicitStep(
            bt, fluid, P, apply_bcs, cfl=cfl, active=active,
            n_hutchinson_samples=n_hutchinson_samples, n_krylov=n_krylov,
            relax=relax, high_order=high_order,
            freeze_limiter=freeze_limiter, generator=generator)
    return step_graphs(bt).loop("point_implicit_step", key, make,
                                use_graph(graph, P))(P)
