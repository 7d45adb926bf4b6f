"""kNN interpolators compiled to padded (idx, w) tables (host side).

Counterpart of the reference's ``NNInterpolator`` (``src/nninterp.jl:16-138``):
k = 2^ndims nearest neighbors, with either exact-linear-reproduction weights
(pseudo-inverse trick) or inverse-distance (Shepard) weights, and an optional
stencil-offset ``bias`` so the kNN query happens away from the sample point
(used for wall surface sampling). All math is vectorized numpy. Verbatim copy of `ibx/topology/interp.py`,
except that `interpolator` returns the padded ``(idx, w)`` arrays instead
of a `Stencil`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


_EPS32 = float(np.finfo(np.float32).eps)


def linear_weights(X: np.ndarray, idx: np.ndarray, Xq: np.ndarray,
                   w_cap: float = None) -> np.ndarray:
    """Exact-linear-reproduction weights (reference ``src/nninterp.jl:16-42``).

    X: [N, nd] source cloud; idx: [M, k] stencils; Xq: [M, nd] targets.
    Returns w: [M, k] with sum(w)=1 and sum(w * (X[idx]-Xq)) = 0 whenever the
    stencil spans the space; degrades gracefully via pinv otherwise.

    ``w_cap``: geometrically degenerate stencils (near-collinear points —
    ghost-cell image stencils inside a sharp trailing edge are the
    canonical case) give pinv weights of magnitude >> 1; interpolating
    through them AMPLIFIES the sampled field, and inside the eta-blended
    ghost update that feedback loop runs the trailing-edge region away to
    the physicality caps (root-caused in round 3: the "fine-mesh TE
    breakdown" was exactly this). Stencils with sum|w| > w_cap fall back
    to bounded convex IDW weights; pass ``w_cap=None`` for the raw
    reference behavior.
    """
    dX = X[idx] - Xq[:, None, :]                      # [M, k, nd]
    dist = np.sqrt((dX ** 2).sum(axis=2)) + _EPS32    # [M, k]
    w0 = 1.0 / dist
    ones = np.ones(idx.shape + (1,), dtype=X.dtype)
    A = np.concatenate([dX, ones], axis=2)            # [M, k, nd+1]
    B = A * w0[..., None]
    Bp = np.linalg.pinv(B.astype(np.float64))         # [M, nd+1, k]
    w = Bp[:, -1, :] * w0
    if w_cap is not None:
        bad = np.abs(w).sum(axis=1) > w_cap
        if bad.any():
            w_idw = w0[bad] / w0[bad].sum(axis=1, keepdims=True)
            w[bad] = w_idw
    w = np.where(np.abs(w) > _EPS32, w, 0.0)
    return w.astype(np.float32)


def idw_weights(X: np.ndarray, idx: np.ndarray, Xq: np.ndarray) -> np.ndarray:
    """Inverse-distance (Shepard) weights (reference ``src/nninterp.jl:47-69``)."""
    dX = X[idx] - Xq[:, None, :]
    dist = np.sqrt((dX ** 2).sum(axis=2)) + _EPS32
    w = 1.0 / dist
    w = w / w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(w) > np.sqrt(_EPS32), w, 0.0)
    return w.astype(np.float32)


def interpolator(
    X: np.ndarray,
    Xq: np.ndarray,
    tree: Optional[cKDTree] = None,
    *,
    bias: Optional[np.ndarray] = None,
    linear: bool = True,
    k: int = 0,
    w_cap: float = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build a kNN interpolation table from cloud ``X`` to targets ``Xq``:
    ``idx`` int32[M, k] and ``w`` float32[M, k].

    Mirrors ``Interpolator`` (reference ``src/nninterp.jl:85-138``): the kNN
    query runs at ``Xq + bias`` (stencil offset), but weights are computed
    w.r.t. ``Xq`` itself. ``k`` defaults to 2^ndims.
    """
    X = np.asarray(X, dtype=np.float32)
    Xq = np.asarray(Xq, dtype=np.float32)
    nd = X.shape[1]
    if k == 0:
        k = 2 ** nd
    k = min(k, X.shape[0])
    if tree is None:
        tree = cKDTree(X)
    query_pts = Xq if bias is None else Xq + np.asarray(bias, dtype=np.float32)
    _, idx = tree.query(query_pts, k=k, workers=-1)
    idx = np.atleast_2d(idx)
    if idx.ndim == 1:
        idx = idx[:, None]
    if k == 1:
        idx = idx.reshape(-1, 1)
    w = (linear_weights(X, idx, Xq, w_cap=w_cap) if linear
         else idw_weights(X, idx, Xq))
    return (np.ascontiguousarray(idx, dtype=np.int32),
            np.ascontiguousarray(w, dtype=np.float32))
