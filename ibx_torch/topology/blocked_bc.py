"""Ghost-cell boundary conditions on the block state.

`GhostBC.apply_cs` and `GhostBC.apply_grid` have the semantics of the JAX
package's `FusedBoundary.__call__` (`ibx/topology/domain.py`), which
`BlockedBC.cs` and `BlockedBC.__call__` apply on the channel-split
``[B, C, bs, bs*bs]`` and the cell-major ``[B, bs, ..., bs, C]`` state
(nd = 2 or 3):
gather the image-point stencils, apply the per-family BC callbacks, blend
with eta, guard, and write the ghosts back once. The ghost set comes from
`_collect_families`, a verbatim numpy copy of the JAX package's function;
its rows keep that order, and so do the image distances a wall-function
callback closes over (`GhostBC.image_distances`). The state may carry any
number of channels (RANS hands the fused ``[p T u.. Rt]`` state).
The TPU write-back machinery of `ibx/topology/blocked_bc.py` (16-slot
tiles, phase views, union buffer, dense planes) exists for the TPU's
scatter cost and is not ported: here the write-back is one `index_put_`.
`local_ghost_bc` is the sharded block march's per-rank `GhostBC` (the
counterpart of `build_blocked_bc_stacked` / `local_blocked_bc`): a rank's
own ghosts on its local block grid.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.monitor import device_span
from .domain import blend_families, mirror_families


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
    The ghosts are unique, so the write-back is exact.

    ``image_distances`` (f32[G]) is each ghost's image distance in this
    row order, the rows every callback receives: the RANS wall functions
    close over it. It is not the row order of the JAX package's
    `BlockedBC.image_distances`, which its TPU tiles reorder."""

    src_b: torch.Tensor      # int64[G, K]
    src_w: torch.Tensor      # int64[G, K]
    w: torch.Tensor          # f32[G, K]
    ghost_b: torch.Tensor    # int64[G]
    ghost_w: torch.Tensor    # int64[G]
    normals: torch.Tensor    # f32[G, nd]
    eta: torch.Tensor        # f32[G, 1]
    family: torch.Tensor     # int64[G] index into names
    names: Tuple[str, ...]
    image_distances: torch.Tensor  # f32[G]

    @classmethod
    def from_numpy(cls, fams: dict, names: Sequence[str], npb: int,
                   device, dense_families: Optional[Sequence[str]] = None
                   ) -> "GhostBC":
        """From `_collect_families` output (flat cell ids, ``npb`` cells a
        block). ``dense_families`` is accepted and ignored: in the JAX
        package it picks the families that take the TPU's dense-plane
        write path, which gives the same values as the general one."""
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
            image_distances=f32(fams["imd"]),
        )

    def _ghost_values(self, read, fns: Dict[str, Callable],
                      guard: Optional[Callable], mirror: Sequence[str] = (),
                      mirror_scale=None):
        """Blended, mirrored, guarded ghost rows [G, C]; ``read(b, w)``
        gathers the cells (b, w) as rows [G, C]."""
        Pi = None
        for k in range(self.w.shape[1]):
            t = read(self.src_b[:, k], self.src_w[:, k]) * self.w[:, k:k + 1]
            Pi = t if Pi is None else Pi + t
        g = blend_families(Pi, self.normals, self.eta, self.family,
                           self.names, fns)
        if mirror:
            g = mirror_families(g, Pi, self.normals, self.eta, self.family,
                                self.names, mirror, mirror_scale)
        return g if guard is None else guard(g)

    def apply_cs(self, Pc, fns: Dict[str, Callable], *,
                 guard: Optional[Callable] = None):
        """Apply all families' BCs to the channel-split state ``Pc``
        ``[B, C, bs, bs*bs]`` IN PLACE and return it. ``fns[name](P_image,
        normals) -> bc values``; ``guard`` post-processes the blended
        ghost rows. Every read happens before the one write."""
        B, C = Pc.shape[:2]
        view = Pc.view(B, C, -1)
        with device_span("march.ghost_bc", Pc.device):
            view[self.ghost_b, :, self.ghost_w] = self._ghost_values(
                lambda b, w: view[b, :, w], fns, guard)
        return Pc

    def apply_grid(self, P3, fns: Dict[str, Callable], *,
                   guard: Optional[Callable] = None,
                   mirror: Sequence[str] = (), mirror_scale=None):
        """`apply_cs` on the cell-major state ``P3`` ``[B, bs, ..., bs, C]``
        (contiguous; 2D or 3D), through its ``[B, bs^nd, C]`` view, IN
        PLACE. ``mirror`` (family names) flips those families' ghost
        normal velocity to -eta*u_n(image), gated row by row by
        ``mirror_scale`` (f32[G], this table's row order), as
        `FusedBoundary` does."""
        view = P3.view(P3.shape[0], -1, P3.shape[-1])
        with device_span("march.ghost_bc", P3.device):
            view[self.ghost_b, self.ghost_w] = self._ghost_values(
                lambda b, w: view[b, w], fns, guard, mirror, mirror_scale)
        return P3


def local_ghost_bc(dom, names: Sequence[str], own_of_block, g2l, rank: int,
                   device, dense_families: Optional[Sequence[str]] = None
                   ) -> GhostBC:
    """Rank ``rank``'s `GhostBC` on its local block grid (the sharded
    block march, `ibx_torch.parallel.block_sharding`): the ghosts of
    `_collect_families` whose block ``own_of_block`` gives to this rank,
    with ghosts and image stencils mapped through ``g2l`` (global block ->
    local slot) to local flat cell ids. ``dense_families`` as in
    `GhostBC.from_numpy`."""
    if dom.n_partitions != 1:
        raise ValueError("build from a single-partition Domain")
    msh = dom.mesh
    npb = int(msh.block_size) ** msh.ndim
    fams = _collect_families(dom, names)
    own_of_block = np.asarray(own_of_block)
    g2l = np.asarray(g2l)
    sel = own_of_block[fams["ghosts"] // npb] == rank
    f = {k: v[sel] for k, v in fams.items()}
    gb = f["ghosts"] // npb
    ib = f["idx"] // npb
    assert (g2l[gb] >= 0).all(), "own ghost outside local grid"
    assert (g2l[ib] >= 0).all(), "BC stencil escaped the halo set"
    f["ghosts"] = g2l[gb] * npb + f["ghosts"] % npb
    f["idx"] = g2l[ib] * npb + f["idx"] % npb
    return GhostBC.from_numpy(f, names, npb, device,
                              dense_families=dense_families)
