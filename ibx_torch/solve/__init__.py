"""Solvers on the generic gather path and the block grid: the Euler /
Navier-Stokes residual and its local-time-step RK2 pseudo march (`euler`)
and the RANS march with Wray-Agarwal transport and wall functions
(`rans`). The solver-acceleration modules of the JAX package's
`ibx.solve` (multigrid, FAS, point-implicit) are not ported yet."""
from .euler import euler_rhs, local_timestep, rk2_step
from .rans import RansMarch, build_rans_march, rans_rhs_grid, rans_rk2_grid

__all__ = [
    "euler_rhs", "local_timestep", "rk2_step",
    "RansMarch", "build_rans_march", "rans_rhs_grid", "rans_rk2_grid",
]
