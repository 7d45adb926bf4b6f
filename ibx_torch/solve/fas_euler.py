"""FAS multigrid acceleration wired to the compressible Euler march
(counterpart of `ibx/solve/fas_euler.py`).

Composes the domain hierarchy (`ibx_torch.solve.multigrid_domain`), the FAS
cycle (`ibx_torch.solve.fas`) and the gather-path Euler residual
(`ibx_torch.solve.euler`) into a cycle: the fine-level fixed point is the
local-dt explicit update ``Q += dt * R(Q)``, coarse levels relax the
tau-corrected problem on the same physics (reference pattern:
``src/solver.jl`` + ``README.md:392-395``). Every op is a torch op on the
fine domain's device; no kernel of `ibx_torch.ops.kernels` lies on it.

On a CUDA state `FasEuler.cycle` and `smooth_only` run the cycle's pieces
captured in CUDA graphs (`fas.FasCycle`; the counterpart of the JAX
package's ``jax.jit`` over them), one capture an arm, ``n_iter`` and
``rtol``, kept on the solver in one memory pool; ``graph=False`` runs the
same pieces eagerly, the CPU's default.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from ..physics.fluid import (Fluid, physicality_guard,
                             primitive2state, state2primitive)
from ..topology.domain import Domain
from ..utils.graphs import Graphs, use_graph
from ..utils.monitor import span
from .euler import euler_rhs, local_timestep, rk2_step
from .fas import FasCycle
from .multigrid_domain import multigrid


class FasEuler:
    """FAS-accelerated pseudo-time Euler solver over a domain hierarchy.

    ``make_bcs(dom) -> (P -> P)`` builds the ghost-BC application for any
    level's domain; ``inside_fn(centers) -> bool[N]`` (optional) marks cells
    inside solid bodies to freeze, per level.

    ``smoother``: the per-level relaxation map handed to the FAS cycle.

      * ``"euler"`` — the reference recipe's forward-Euler local-dt fixed
        point ``Q += dt*R(Q)``. Linearly unstable on smooth subsonic
        cases, where the JST sensor is quiescent and the face blend
        degenerates to an undissipated central flux (the JAX package's
        `FasEuler` docstring has the measurement). Kept as the
        reference-parity mode for model problems with active dissipation.
      * ``"rk2"`` — the production TVD-RK2 map as the fixed point,
        ``r = RK2(Q) - Q`` (same stationary points: r = 0 iff dt*R = 0);
        stable wherever the production march is.
    """

    def __init__(
        self,
        dom: Domain,
        fluid: Fluid,
        make_bcs: Callable,
        *,
        max_levels: int = 2,
        cfl: float = 0.5,
        high_order: bool = True,
        inside_fn: Optional[Callable] = None,
        smoother: str = "euler",
    ):
        self.fluid = fluid
        self.cfl = cfl
        self.high_order = high_order
        assert smoother in ("euler", "rk2")
        self.smoother = smoother
        # the cycles (`fas.FasCycle`) captured on a CUDA state: one an
        # arm, for its last n_iter and rtol
        self._graphs = Graphs()
        with span("build.levels"):
            hier = multigrid(dom, max_levels)
            self.domains: List[Domain] = [dom] + list(hier.coarse_domains)
            self.coarseners = list(hier.coarseners)
            self.prolongators = list(hier.prolongators)
            self.bcs = [make_bcs(d) for d in self.domains]
            self.active = []
            for d in self.domains:
                if inside_fn is None:
                    self.active.append(None)
                else:
                    self.active.append(torch.as_tensor(
                        (~inside_fn(d.centers)).astype(np.float32),
                        device=d.device))

    def _f(self, level, Q):
        d = self.domains[level]
        part = d.partitions[0]
        P = physicality_guard(state2primitive(self.fluid, Q))
        P = self.bcs[level](P)
        if self.smoother == "rk2":
            P2, _ = rk2_step(part, self.fluid, P, self.bcs[level],
                             cfl=self.cfl, high_order=self.high_order,
                             active=self.active[level])
            Qn = primitive2state(self.fluid, physicality_guard(P2))
            return Qn - Q, torch.ones_like(Q)
        R = euler_rhs(part, self.fluid, P, high_order=self.high_order)
        dt = local_timestep(part, self.fluid, P, self.cfl)
        if self.active[level] is not None:
            dt = dt * self.active[level]
        # fixed point: Q += clamp(omega, 0, 1) * r with r = dt*R, omega = 1
        return R * dt[:, None], torch.ones_like(Q)

    def cycle(self, Q, *, n_iter: int = 20, rtol: float = 0.05,
              graph: Optional[bool] = None):
        """One FAS V-cycle; returns (Q, residual_reduction_ratio).
        ``graph`` follows `utils.graphs.use_graph`."""
        return self._run("cycle", Q, n_iter, rtol, graph)

    def smooth_only(self, Q, *, n_iter: int = 20, rtol: float = 0.05,
                    graph: Optional[bool] = None):
        """Fine-level smoothing with no coarse correction (baseline)."""
        return self._run("smooth", Q, n_iter, rtol, graph)

    def _run(self, arm, Q, n_iter, rtol, graph):
        coarse = arm == "cycle"

        def make():
            return FasCycle(
                self._f, Q,
                coarseners=self.coarseners if coarse else (),
                prolongators=self.prolongators if coarse else (),
                n_iter=n_iter, rtol=rtol)
        return self._graphs.loop(arm, (n_iter, rtol), make,
                                 use_graph(graph, Q))(Q)

    def init_state(self, P0):
        P0 = torch.as_tensor(P0, device=self.domains[0].device)
        return primitive2state(self.fluid, self.bcs[0](P0))

    def primitives(self, Q):
        return self.bcs[0](
            physicality_guard(state2primitive(self.fluid, Q))
        )
