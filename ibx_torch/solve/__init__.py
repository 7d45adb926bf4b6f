"""Solvers on the generic gather path and the block grid: the Euler /
Navier-Stokes residual and its local-time-step RK2 pseudo march (`euler`),
the RANS march with Wray-Agarwal transport and wall functions (`rans`),
and solver acceleration: point-cloud and domain multigrid transfers
(`mgrid`, `multigrid_domain`), the FAS cycle and FAS-Euler (`fas`,
`fas_euler`), and the matrix-free point-implicit solver and its Euler step
(`point_implicit`, `point_implicit_euler`)."""
from .euler import euler_rhs, local_timestep, rk2_step
from .fas import fas
from .fas_euler import FasEuler
from .mgrid import Multigrid, coarsener_and_prolongator, multigrid_levels
from .multigrid_domain import DomainHierarchy, multigrid
from .point_implicit import (
    Linearization,
    PIPreconditioner,
    hutchinson_block_diagonal,
    linearize,
    solve,
)
from .point_implicit_euler import point_implicit_step
from .rans import RansMarch, build_rans_march, rans_rhs_grid, rans_rk2_grid

__all__ = [
    "euler_rhs", "local_timestep", "rk2_step",
    "RansMarch", "build_rans_march", "rans_rhs_grid", "rans_rk2_grid",
    "fas", "FasEuler", "point_implicit_step",
    "Multigrid", "coarsener_and_prolongator", "multigrid_levels",
    "DomainHierarchy", "multigrid",
    "Linearization", "PIPreconditioner", "hutchinson_block_diagonal",
    "linearize", "solve",
]
