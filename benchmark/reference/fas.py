"""The reference FAS cycle: plain PyTorch, eager, in any precision.

The Full Approximation Scheme of ImmersedBoundary.jl (``src/solver.jl:
39-91``) over the same block tree at half and a quarter of the cells a
block side (``src/ImmersedBoundary.jl:1331-1407``): on each level the
fixed point of the RK2 map, ``r = RK2(Q) - Q``; the coarse level relaxes
the tau-corrected problem from the restricted state, and its change is
prolonged back; every level then smooths ``Q += r`` until the residual's
L2 norm falls below ``rtol`` of the first or ``n_iter`` iterations have
run. Transfers are inverse-distance kNN interpolations between the cell
clouds of consecutive levels. Ghost families are set one after the other
and not guarded, the solver's own convention; the cells inside the body
stay frozen on every level.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .domain import RefDomain, build_domain, idw
from .euler import Euler, Fluid, guard

EPS32 = float(np.finfo(np.float32).eps)


class Transfer:
    """``out[m] = sum_k w[m, k] v[idx[m, k]]``."""

    def __init__(self, idx, w, dtype, device):
        self.idx = torch.as_tensor(idx, device=device)
        self.w = torch.as_tensor(np.asarray(w, np.float64), dtype=dtype,
                                 device=device)

    def __call__(self, v):
        return (v[self.idx] * self.w[..., None]).sum(1)


def levels(dom: RefDomain, stl, families, n_levels: int) -> List[RefDomain]:
    """The fine domain and its coarse levels, halving the cells a block
    side, as many as the cycle recurses into."""
    out = [dom]
    bs = dom.mesh.block_size
    while len(out) < n_levels and bs // 2 >= 1:
        bs //= 2
        out.append(build_domain(dom.mesh.coarsen(bs), stl, families))
    return out


class Fas:
    """One cycle a call on the domains ``doms`` (finest first)."""

    def __init__(self, doms: List[RefDomain], P_inf, *, dtype, device,
                 cfl: float, n_iter: int, rtol: float, atol: float = 1e-7):
        self.n_iter, self.rtol, self.atol = n_iter, rtol, atol
        self.dtype = dtype
        self.march = [Euler(d, P_inf, dtype=dtype, device=device, cfl=cfl,
                            guard_bcs=False, sequential=True) for d in doms]
        self.coarsen, self.prolong = [], []
        for a, b in zip(doms[:-1], doms[1:]):
            self.coarsen.append(Transfer(*idw(a.centers, b.centers), dtype,
                                         device))
            self.prolong.append(Transfer(*idw(b.centers, a.centers), dtype,
                                         device))

    def f(self, lv, Q):
        e = self.march[lv]
        P = e.bcs(guard(Fluid.to_primitive(Q)))
        return Fluid.to_state(guard(e.step(P))) - Q

    def level(self, lv, Q, pf=None):
        fQ = self.f(lv, Q)
        source = torch.zeros_like(fQ) if pf is None else pf - fQ
        r = fQ + source
        nr0 = torch.linalg.vector_norm(r)
        stop = nr0 * self.rtol + self.atol
        if lv + 1 < len(self.march):
            Qc = self.coarsen[lv](Q)
            Qc_new, _, _ = self.level(lv + 1, Qc, self.coarsen[lv](r))
            Q = Q + self.prolong[lv](Qc_new - Qc)
        nr = torch.full_like(nr0, float("inf"))
        it = 0
        while it < self.n_iter and bool(nr >= stop):
            r = self.f(lv, Q) + source
            Q = Q + r
            nr = torch.linalg.vector_norm(r)
            it += 1
        return Q, nr / (nr0 + EPS32), it

    def cycle(self, Q):
        """(Q after one cycle, the fine residual's reduction ratio, the
        fine level's iterations)."""
        return self.level(0, Q.to(self.dtype))
