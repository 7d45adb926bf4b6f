"""Solvers on the generic gather path: the Euler / Navier-Stokes residual
and its local-time-step RK2 pseudo march (`euler`)."""
