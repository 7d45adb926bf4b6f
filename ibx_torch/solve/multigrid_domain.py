"""Domain-level multigrid hierarchy (host build; counterpart of
`ibx/solve/multigrid_domain.py`).

Counterpart of reference ``src/ImmersedBoundary.jl:1331-1407``: coarse levels
reuse the same block tree with ``block_size // factor`` cells per block,
rebuilding a full Domain per level with the fine domain's reconstruction
kwargs; coarseners/prolongators are IDW kNN interpolators between the
cell-center clouds of consecutive levels. Every level and table lives on
the fine domain's device (``reconstruction_kwargs`` holds none).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

from ..ops.stencil import Stencil
from ..topology.domain import Domain
from .interp_util import idw_interpolator


class DomainHierarchy(NamedTuple):
    """coarse_domains[i] is level i+1; coarseners[i] maps level i -> i+1,
    prolongators[i] maps level i+1 -> i (level 0 = the fine domain)."""

    coarse_domains: List[Domain]
    coarseners: List[Stencil]
    prolongators: List[Stencil]


def multigrid(dom: Domain, max_levels: int = 0, *, factor: int = 2,
              verbose: bool = False) -> DomainHierarchy:
    msh = dom.mesh
    mdepth = int(math.floor(math.log2(msh.block_size)))
    if max_levels == 0:
        max_levels = mdepth

    coarse_domains: List[Domain] = []
    coarseners: List[Stencil] = []
    prolongators: List[Stencil] = []

    kwargs = dict(dom.reconstruction_kwargs)
    X_old = dom.centers
    bsize = msh.block_size
    for _ in range(max_levels):
        bsize = bsize // factor
        if bsize < 1:
            break
        cdom = Domain(msh.coarsen(bsize), device=dom.device, **kwargs)
        X = cdom.centers
        coarseners.append(idw_interpolator(X_old, X, device=dom.device))
        prolongators.append(idw_interpolator(X, X_old, device=dom.device))
        coarse_domains.append(cdom)
        X_old = X

    return DomainHierarchy(coarse_domains, coarseners, prolongators)
