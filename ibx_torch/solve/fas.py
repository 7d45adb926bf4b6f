"""Full Approximation Scheme multigrid cycle (device side; counterpart of
`ibx/solve/fas.py`).

Counterpart of reference ``src/solver.jl:39-91``: recursive FAS over a user
function ``f(level, Q) -> (r, omega)`` (residual and relaxation factor), with
tau-corrected coarse-grid recursion and relaxed fixed-point smoothing. The
JAX package's ``lax.while_loop`` is a Python loop here, with the same stop
rule: the loop reads the residual norm on the host once an iteration (its
one host sync) to decide whether to go on.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def _l2(r):
    return torch.sqrt((r.float() ** 2).sum())


def fas(
    f: Callable,
    Q,
    *,
    coarseners: Sequence = (),
    prolongators: Sequence = (),
    prescribed_f=None,
    multigrid_level: int = 0,
    n_iter: int = 50,
    rtol: float = 0.1,
    atol: float = 1e-7,
):
    """One FAS cycle. Returns (Q, residual_reduction_ratio), the ratio a
    0-dim float32 tensor on Q's device.

    Semantics follow the reference exactly, including its convention that the
    last coarsener in the list is never recursed into
    (``src/solver.jl:60-77``: recursion only while more than one remains).
    """
    level = multigrid_level
    fQ, omega = f(level, Q)

    if prescribed_f is not None:
        source = prescribed_f - fQ
    else:
        source = torch.zeros_like(fQ)

    r = fQ + source
    nr0 = _l2(r)

    if len(coarseners) > 1:
        coarsen = coarseners[0]
        prolong = prolongators[0]
        Qc = coarsen(Q)
        Qc_old = Qc
        pfQc = coarsen(r)
        Qc, _ = fas(
            f, Qc,
            coarseners=coarseners[1:], prolongators=prolongators[1:],
            prescribed_f=pfQc, multigrid_level=level + 1,
            n_iter=n_iter, rtol=rtol, atol=atol,
        )
        Q = Q + prolong(Qc - Qc_old)

    # the stop rule of the JAX package's while_loop, in float32 on device
    stop = nr0 * rtol + atol
    nr = torch.full_like(nr0, float("inf"))
    it = 0
    while it < n_iter and bool(nr >= stop):
        r, omega = f(level, Q)
        r = r + source
        Q = Q + omega.clamp(0.0, 1.0) * r
        nr = _l2(r)
        it += 1
    return Q, nr / (nr0 + _EPS32)
