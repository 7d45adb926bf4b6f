"""Shared interpolation helper for solver-level grid transfers
(counterpart of `ibx/solve/interp_util.py`)."""

from __future__ import annotations

import numpy as np

from ..ops.stencil import Stencil, stencil_from_padded
from ..topology.domain import require_device
from ..topology.interp import interpolator


def idw_interpolator(X_from: np.ndarray, X_to: np.ndarray, *,
                     device="cuda") -> Stencil:
    """IDW kNN transfer operator between point clouds (k = 2^ndims),
    matching the reference multigrid interpolators
    (``src/ImmersedBoundary.jl:1391-1392`` with ``linear = false``), on
    ``device`` (the card unless asked otherwise)."""
    device = require_device("idw_interpolator", device)
    return stencil_from_padded(
        *interpolator(X_from, X_to, linear=False)).to(device)
