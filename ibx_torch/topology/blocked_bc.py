"""Ghost-cell boundary conditions on the block state.

`GhostBC.apply_cs` and `GhostBC.apply_grid` have the semantics of the JAX
package's `FusedBoundary.__call__` (`ibx/topology/domain.py`), which
`BlockedBC.cs` and `BlockedBC.__call__` apply on the channel-split
``[B, C, bs, bs*bs]`` and the cell-major ``[B, bs, ..., bs, C]`` state
(nd = 2 or 3):
gather the image-point stencils, apply the per-family BC callbacks, blend
with eta, guard, and write the ghosts back once. The ghost set comes from
`_collect_families`, a verbatim numpy copy of the JAX package's function.
The TPU write-back machinery of `ibx/topology/blocked_bc.py` (16-slot
tiles, phase views, union buffer, dense planes) exists for the TPU's
scatter cost and is not ported: here the write-back is one `index_put_`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _collect_families(dom, names: Sequence[str]) -> dict:
    """Claimed-dedup (last listed family wins, matching the sequential
    ``impose_bc`` semantics of the reference,
    ``src/ImmersedBoundary.jl:1197-1247``) + concat of the named families'
    host-boundary arrays into one canonical ghost set in the domain's
    flat cell-id space."""
    ghost_l, idx_l, w_l, nrm_l, eta_l, fam_l = [], [], [], [], [], []
    imd_l = []
    claimed = {}
    for i, name in enumerate(names):
        hb = dom._host_boundaries[name]
        for g in hb.ghosts:
            claimed[int(g)] = i
    for i, name in enumerate(names):
        hb = dom._host_boundaries[name]
        keep = np.array([claimed[int(g)] == i for g in hb.ghosts],
                        dtype=bool)
        ghost_l.append(hb.ghosts[keep])
        idx_l.append(hb.interp_idx[keep])
        w_l.append(hb.interp_w[keep])
        nrm_l.append(hb.normals[keep])
        eta_l.append((hb.ghost_distances / hb.image_distances)[keep])
        imd_l.append(hb.image_distances[keep])
        fam_l.append(np.full(int(keep.sum()), i, dtype=np.int32))
    ghosts = np.concatenate(ghost_l)
    if np.unique(ghosts).size != ghosts.size:
        raise ValueError("fused families share ghost cells")
    K = max(a.shape[1] for a in idx_l)

    def padk(a, repeat_first):
        if a.shape[1] == K:
            return a
        fill = a[:, :1] if repeat_first else np.zeros_like(a[:, :1])
        return np.concatenate(
            [a] + [fill] * (K - a.shape[1]), axis=1)

    return dict(
        ghosts=ghosts.astype(np.int64),
        idx=np.concatenate([padk(a, True) for a in idx_l]).astype(np.int64),
        w=np.concatenate([padk(a, False) for a in w_l]).astype(np.float32),
        normals=np.concatenate(nrm_l).astype(np.float32),
        eta=np.concatenate(eta_l).astype(np.float32),
        imd=np.concatenate(imd_l).astype(np.float32),
        family=np.concatenate(fam_l),
    )


@dataclasses.dataclass
class GhostBC:
    """Fused multi-family ghost BC. Stencil point k of ghost g is cell
    (``src_b[g, k]``, ``src_w[g, k]``) of the ``[B, C, bs^nd]`` view with
    weight ``w[g, k]``; ghost g itself is (``ghost_b[g]``, ``ghost_w[g]``).
    The ghosts are unique, so the write-back is exact."""

    src_b: torch.Tensor      # int64[G, K]
    src_w: torch.Tensor      # int64[G, K]
    w: torch.Tensor          # f32[G, K]
    ghost_b: torch.Tensor    # int64[G]
    ghost_w: torch.Tensor    # int64[G]
    normals: torch.Tensor    # f32[G, nd]
    eta: torch.Tensor        # f32[G, 1]
    family: torch.Tensor     # int64[G] index into names
    names: Tuple[str, ...]

    @classmethod
    def from_numpy(cls, fams: dict, names: Sequence[str], npb: int,
                   device) -> "GhostBC":
        """From `_collect_families` output (flat cell ids, ``npb`` cells a
        block)."""
        def idx(a):
            return torch.as_tensor(np.array(a, np.int64), device=device)

        def f32(a):
            return torch.as_tensor(np.array(a, np.float32), device=device)

        g = np.asarray(fams["ghosts"], np.int64)
        st = np.asarray(fams["idx"], np.int64)
        return cls(
            src_b=idx(st // npb), src_w=idx(st % npb), w=f32(fams["w"]),
            ghost_b=idx(g // npb), ghost_w=idx(g % npb),
            normals=f32(fams["normals"]), eta=f32(fams["eta"])[:, None],
            family=idx(fams["family"]), names=tuple(names),
        )

    def _ghost_values(self, read, fns: Dict[str, Callable],
                      guard: Optional[Callable]):
        """Blended, guarded ghost rows [G, C]; ``read(b, w)`` gathers the
        cells (b, w) as rows [G, C]."""
        Pi = None
        for k in range(self.w.shape[1]):
            t = read(self.src_b[:, k], self.src_w[:, k]) * self.w[:, k:k + 1]
            Pi = t if Pi is None else Pi + t
        r = None
        for i, name in enumerate(self.names):
            ri = fns[name](Pi, self.normals)
            r = ri if r is None else torch.where(
                (self.family == i)[:, None], ri, r)
        g = self.eta * Pi + (1.0 - self.eta) * r
        return g if guard is None else guard(g)

    def apply_cs(self, Pc, fns: Dict[str, Callable], *,
                 guard: Optional[Callable] = None):
        """Apply all families' BCs to the channel-split state ``Pc``
        ``[B, C, bs, bs*bs]`` IN PLACE and return it. ``fns[name](P_image,
        normals) -> bc values``; ``guard`` post-processes the blended
        ghost rows. Every read happens before the one write."""
        B, C = Pc.shape[:2]
        view = Pc.view(B, C, -1)
        view[self.ghost_b, :, self.ghost_w] = self._ghost_values(
            lambda b, w: view[b, :, w], fns, guard)
        return Pc

    def apply_grid(self, P3, fns: Dict[str, Callable], *,
                   guard: Optional[Callable] = None):
        """`apply_cs` on the cell-major state ``P3`` ``[B, bs, ..., bs, C]``
        (contiguous; 2D or 3D), through its ``[B, bs^nd, C]`` view, IN
        PLACE."""
        view = P3.view(P3.shape[0], -1, P3.shape[-1])
        view[self.ghost_b, self.ghost_w] = self._ghost_values(
            lambda b, w: view[b, w], fns, guard)
        return P3
