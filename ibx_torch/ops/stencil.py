"""Padded-stencil gather-reduce: the framework's core device operation
(counterpart of `ibx/ops/stencil.py`).

The reference implementation (ImmersedBoundary.jl, ``src/accumulator.jl:12-190``)
accumulates values over *variable-length* stencils by grouping stencils of
equal length into dense matrices and looping over the groups. Here every
stencil table is compiled (on the host, in numpy) into a single fixed-width
``(idx, w)`` pair, padded with zero weights. Applying a stencil is

    out[m, ...] = sum_k w[m, k] * f(v[idx[m, k], ...])

one gather (`take_rows`) and one weighted reduction over a short axis,
both torch ops. Used for: face accumulators (Green-Gauss), kNN interpolators
(boundary image points, surface sampling).

Index tables are compiled as int32 (the JAX package's tables, value for
value) and held as int64 tensors, the index type every torch indexing op
takes; the conversion happens once, when the table is made, never inside a
step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Stencil:
    """Fixed-width weighted gather-reduce table on one device.

    Mirrors the semantics of ``Accumulator`` (reference
    ``src/accumulator.jl:39-65``) with a padded layout.

    Attributes:
      idx: int64[M, K] gather indices into the input's leading axis. Padded
        entries repeat a valid index (or 0) and carry zero weight.
      w:   float32[M, K] weights; zero on padding.
      n_output: M.
      width: K.
    """

    idx: torch.Tensor
    w: torch.Tensor
    n_output: int
    width: int

    def to(self, device) -> "Stencil":
        """The same table on ``device``."""
        return dataclasses.replace(self, idx=self.idx.to(device),
                                   w=self.w.to(device))

    def __call__(self, v, *, delta: bool = False, f: Optional[Callable] = None,
                 op: str = "sum"):
        return apply_stencil(self, v, delta=delta, f=f, op=op)


def stencil_from_lists(indices, weights=None, n_output=None,
                       min_width: int = 1) -> Stencil:
    """Host-side compiler: list-of-lists stencils -> padded Stencil.

    ``indices[m]`` is the (possibly empty) stencil of output row ``m``;
    ``weights[m]`` the matching weights (defaults to all-ones, matching the
    weightless Accumulator of the reference, ``src/accumulator.jl:84-93``).
    Zero-based indices. The result lives on the host; placement is one
    ``.to(device)`` of the containing structure.
    """
    M = len(indices) if n_output is None else n_output
    K = max([min_width] + [len(s) for s in indices])
    idx = np.zeros((M, K), dtype=np.int32)
    w = np.zeros((M, K), dtype=np.float32)
    for m, s in enumerate(indices):
        L = len(s)
        if L == 0:
            continue
        idx[m, :L] = s
        if weights is None:
            w[m, :L] = 1.0
        else:
            w[m, :L] = weights[m]
        # pad with a repeat of the first valid index (harmless gather target)
        idx[m, L:] = s[0]
    return stencil_from_padded(idx, w)


def stencil_from_padded(idx: np.ndarray, w: np.ndarray) -> Stencil:
    """Wrap already-padded host tables (int[M, K], float[M, K]); the
    result lives on the host."""
    idx = np.array(idx, dtype=np.int64)
    w = np.array(w, dtype=np.float32)
    return Stencil(idx=torch.from_numpy(idx), w=torch.from_numpy(w),
                   n_output=idx.shape[0], width=idx.shape[1])


def _take_rows_flat(v, idx):
    """``v[idx]`` along dim 0 as a gather of single elements: the flat view
    of ``v`` indexed by ``idx * row + (0 .. row - 1)``."""
    row = v[0].numel()
    flat = (idx[:, None] * row
            + torch.arange(row, device=idx.device)).reshape(-1)
    return v.reshape(-1).index_select(0, flat).reshape(
        idx.shape + v.shape[1:])


def take_rows(v, idx):
    """Rows ``v[idx]`` of ``v`` [N, ...] for a 1-D int64 ``idx``: the one
    gather every operator of the gather path goes through.

    It is `index_select`, except on a CUDA tensor whose rows are a multiple
    of 16 bytes wide (the 2D state's ``[N, 4]`` float32 rows): torch's CUDA
    `index_select`, advanced indexing and `gather` all send those to a
    vectorised row-copy kernel that runs one thread per 16 bytes of a row
    and one block per row, 0.535 ms for 0.88 M rows of 16 bytes on an H100
    against 0.027 ms for rows of 20 bytes (`scripts/torch_gather_profile.py`).
    Such rows are gathered element by element instead (`_take_rows_flat`),
    which copies the same values."""
    if v.is_cuda and v.dim() > 1 and \
            (v[0].numel() * v.element_size()) % 16 == 0:
        return _take_rows_flat(v, idx)
    return v.index_select(0, idx)


def _expand(w, ndim_extra):
    return w.reshape(w.shape + (1,) * ndim_extra)


def apply_stencil(st: Stencil, v, *, delta: bool = False,
                  f: Optional[Callable] = None, op: str = "sum"):
    """Apply the stencil to ``v`` along its leading axis.

    v: [N, ...] -> out: [M, ...]. ``delta`` subtracts the co-indexed output
    row (reference ``src/accumulator.jl:100``); ``f`` maps gathered values
    before reduction; ``op`` in {"sum", "max", "min"}. The gathered
    ``[M, K, ...]`` block is materialised and reduced with ``sum(dim=1)``,
    as the JAX package does; a row that is all padding gives 0 under "sum"
    and -inf / inf under "max" / "min".
    """
    v = torch.as_tensor(v, device=st.w.device)
    g = take_rows(v, st.idx.reshape(-1)).reshape(st.idx.shape + v.shape[1:])
    if delta:
        g = g - v[:st.n_output, None]
    if f is not None:
        g = f(g)
    w = _expand(st.w, v.dim() - 1)
    if op == "sum":
        return (g * w).sum(dim=1)
    valid = _expand(st.w.abs() > 0, v.dim() - 1)
    gw = g * w
    if op == "max":
        return gw.masked_fill(~valid, float("-inf")).amax(dim=1)
    if op == "min":
        return gw.masked_fill(~valid, float("inf")).amin(dim=1)
    raise ValueError(f"unsupported op: {op}")


def reindex_stencil(st: Stencil, mapping: np.ndarray) -> Stencil:
    """Remap gather indices through ``mapping`` (host-side).

    Counterpart of the reference's ``re_index!`` (``src/nninterp.jl:175-183``)
    used to localize global stencils to a partition's domain numbering.
    """
    idx = np.asarray(mapping)[st.idx.cpu().numpy()].astype(np.int64)
    return dataclasses.replace(
        st, idx=torch.from_numpy(idx).to(st.idx.device))


def stencil_domain(*sts: Stencil):
    """Union of gather indices used by one or more stencils.

    Counterpart of ``NNInterpolator.domain`` (``src/nninterp.jl:147-168``):
    returns the sorted unique index vector and a dense inverse map
    (old index -> position in the domain vector), both numpy.
    """
    allidx = np.concatenate([s.idx.cpu().numpy().reshape(-1) for s in sts])
    dom = np.unique(allidx)
    inv = np.full(int(dom.max()) + 1 if dom.size else 1, -1, dtype=np.int64)
    inv[dom] = np.arange(dom.size)
    return dom, inv
