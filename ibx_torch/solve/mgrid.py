"""Point-cloud geometric multigrid (host build, device apply; counterpart
of `ibx/solve/mgrid.py`).

Counterpart of reference ``src/mgrid.jl``: coarse levels subsample every
``2^(nd*n)``-th point; fine points are clustered to their nearest coarse
point; the coarsener is a volume-weighted cluster average and the prolongator
is piecewise-constant injection — both compiled to padded Stencils. The
host build is the JAX package's numpy, so the tables are the same value for
value; ``device`` (the card unless asked otherwise) is where they go.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
from scipy.spatial import cKDTree

from ..ops.stencil import Stencil, stencil_from_padded
from ..topology.domain import require_device


def coarsener_and_prolongator(
    X: np.ndarray,
    n: int,
    volumes: Optional[np.ndarray] = None,
    *,
    random_permutation: bool = False,
    rng: Optional[np.random.Generator] = None,
    device="cuda",
):
    """Build level-n coarsener/prolongator (reference ``src/mgrid.jl:24-97``).

    X: [N, nd] point cloud (first index = point). Returns (coarsener,
    prolongator) Stencils mapping [N]->[Nc] and [Nc]->[N].
    """
    device = require_device("coarsener_and_prolongator", device)
    X = np.asarray(X, dtype=np.float32)
    N, nd = X.shape
    if volumes is None:
        volumes = np.ones(N, dtype=np.float32)
    Xs = X
    if random_permutation:
        rng = rng or np.random.default_rng(0)
        Xs = X[rng.permutation(N)]
    stride = 2 ** (nd * n)
    Xc = Xs[::stride]
    tree = cKDTree(Xc)
    _, assign = tree.query(X, k=1, workers=-1)
    Nc = Xc.shape[0]

    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=Nc)
    K = max(int(counts.max()), 1)
    starts = np.zeros(Nc + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(N) - starts[assign[order]]

    idx = np.zeros((Nc, K), dtype=np.int32)
    w = np.zeros((Nc, K), dtype=np.float32)
    idx[assign[order], slot] = order
    w[assign[order], slot] = volumes[order]
    wsum = w.sum(axis=1, keepdims=True)
    w = np.divide(w, wsum, out=np.zeros_like(w), where=wsum > 0)
    coarsener = stencil_from_padded(idx, w).to(device)

    pidx = assign.astype(np.int32)[:, None]
    pw = np.ones((N, 1), dtype=np.float32)
    prolongator = stencil_from_padded(pidx, pw).to(device)
    return coarsener, prolongator


class Multigrid(NamedTuple):
    """Multigrid level stack (reference ``src/mgrid.jl:104-144``)."""

    coarseners: List[Stencil]
    prolongators: List[Stencil]


def multigrid_levels(
    X: np.ndarray,
    n_levels: int,
    volumes: Optional[np.ndarray] = None,
    *,
    random_permutation: bool = False,
    device="cuda",
) -> Multigrid:
    cs, ps = [], []
    for n in range(1, n_levels + 1):
        c, p = coarsener_and_prolongator(
            X, n, volumes, random_permutation=random_permutation,
            device=device,
        )
        cs.append(c)
        ps.append(p)
    return Multigrid(cs, ps)
