"""The reference's mesh tables, worked out from the configuration.

One domain of one partition: the cells and their faces a dimension, the
one-sided faces of the outer box, the ghost cells of each boundary family
with their image-point stencils, and the cells inside the body. Every
table is numpy on the host; `euler.Euler` puts what a step reads on the
device in the precision it computes in.

The ghost geometry and image stencils follow the immersed-boundary
recipe of ImmersedBoundary.jl (``src/ImmersedBoundary.jl:406-448``): a
ghost's image point lies ``ghost_layer_ratio`` circumdiameters from its
projection on the boundary along the normal, interpolated linearly from
the nearest cells with weights capped at 1.5; the outer box's ghosts take
the two cells that straddle the image point along their own axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.spatial import cKDTree

from .host.faces import hcube_faces, octree2faces_blocks
from .host.ghosts import (ghosts_and_projections_hcube,
                          ghosts_and_projections_stl)
from .host.inside import points_inside
from .host.interp import interpolator
from .host.octree import Mesh, get_cells

EPS32 = float(np.finfo(np.float32).eps)
GHOST_LAYER_RATIO = 1.5


@dataclasses.dataclass
class Family:
    """One boundary family's ghosts: ``ghosts`` int64[G], unit ``normals``
    [G, nd] into the fluid, ``eta`` [G] (ghost over image distance), and
    the image stencil ``idx`` int64[G, K], ``w`` [G, K]."""

    ghosts: np.ndarray
    normals: np.ndarray
    eta: np.ndarray
    idx: np.ndarray
    w: np.ndarray


@dataclasses.dataclass
class Faces:
    """The faces normal to one dimension. ``owner`` and ``neighbor`` are
    cell ids (a one-sided face of the outer box names its one cell
    twice); ``right`` marks the faces that count on their owner's high
    side, ``left`` those that count on their neighbor's low side."""

    owner: np.ndarray
    neighbor: np.ndarray
    right: np.ndarray
    left: np.ndarray


@dataclasses.dataclass
class RefDomain:
    mesh: Mesh
    centers: np.ndarray          # f32[N, nd]
    widths: np.ndarray           # f32[N, nd]
    faces: List[Faces]           # one a dimension
    families: Dict[str, Family]  # in the order of the boundary list
    inside: np.ndarray           # bool[N], cells inside the body

    @property
    def ncells(self) -> int:
        return self.centers.shape[0]

    @property
    def nd(self) -> int:
        return self.centers.shape[1]


def _image_stencil(centers, widths, tree, ghosts, projs, exclude=None,
                   axis_stencils=False) -> Family:
    """Ghost normals, eta and the image-point stencil of one family."""
    normals = centers[ghosts] - projs
    gd = np.sqrt((normals.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    # max(gd, eps), not gd + eps: the outer box's normals are exact axes
    normals = normals / np.maximum(gd, EPS32)[:, None]
    diam = np.sqrt((widths[ghosts].astype(np.float64) ** 2).sum(1)
                   ).astype(np.float32)
    image_d = diam * GHOST_LAYER_RATIO + EPS32
    images = projs + normals * image_d[:, None]
    eta = (gd / image_d).astype(np.float32)
    if axis_stencils and ghosts.size:
        d_axis = np.abs(normals).argmax(axis=1)
        _, knn = tree.query(images, k=2, workers=-1)
        c0, c1 = centers[knn[:, 0]], centers[knn[:, 1]]
        h_g = widths[ghosts].max(axis=1)
        ar = np.arange(ghosts.size)
        lat_ok = np.ones(ghosts.size, bool)
        for dd in range(centers.shape[1]):
            lat_ok &= np.where(
                dd != d_axis,
                (np.abs(c0[:, dd] - images[:, dd]) < 0.05 * h_g)
                & (np.abs(c1[:, dd] - images[:, dd]) < 0.05 * h_g), True)
        a0, a1 = c0[ar, d_axis], c1[ar, d_axis]
        sep_ok = np.abs(a1 - a0) > 0.5 * h_g
        t = (images[ar, d_axis] - a0) / np.where(sep_ok, a1 - a0, 1.0)
        ok = lat_ok & sep_ok & (t > -0.1) & (t < 1.1)
        idx2 = np.stack([knn[:, 0], knn[:, 1]], axis=1).astype(np.int64)
        w2 = np.stack([1.0 - t, t], axis=1).astype(np.float32)
        if ok.all():
            return Family(ghosts.astype(np.int64), normals, eta, idx2, w2)
        ki, kw = interpolator(centers, images[~ok], tree, linear=True,
                              w_cap=1.5)
        K = max(2, ki.shape[1])
        idx = np.zeros((ghosts.size, K), np.int64)
        w = np.zeros((ghosts.size, K), np.float32)
        idx[ok, :2], w[ok, :2] = idx2[ok], w2[ok]
        idx[~ok, :ki.shape[1]], w[~ok, :ki.shape[1]] = ki, kw
        return Family(ghosts.astype(np.int64), normals, eta, idx, w)
    if exclude is not None and exclude.any():
        # cells inside the body never feed an image point
        src = np.nonzero(~exclude)[0]
        idx, w = interpolator(centers[src], images, linear=True, w_cap=1.5)
        idx = src[np.asarray(idx, np.int64)]
    else:
        idx, w = interpolator(centers, images, tree, linear=True, w_cap=1.5)
    return Family(ghosts.astype(np.int64), normals, eta,
                  np.asarray(idx, np.int64), np.asarray(w, np.float32))


def build_domain(msh: Mesh, stl,
                 hypercube_families: Sequence[Tuple[str, Sequence]]
                 ) -> RefDomain:
    """The tables of ``msh`` with the outer box's families
    ``hypercube_families`` and one family a distance field of the mesh
    (the body ``stl``), in that order."""
    centers, widths, _ = get_cells(msh)
    N = centers.shape[0]
    origins = centers - widths / 2
    fdim, fo, fn = octree2faces_blocks(msh, origins, widths)
    hdim, ho, hn = hcube_faces(msh.origin, msh.widths, origins, widths)
    fdim = np.concatenate([fdim, hdim])
    fo = np.concatenate([fo, ho]).astype(np.int64)
    fn = np.concatenate([fn, hn]).astype(np.int64)
    faces = []
    for d in range(msh.ndim):
        sel = fdim == d
        o, n = fo[sel], fn[sel]
        o_f = np.where(o < 0, n, o)
        n_f = np.where(n < 0, o_f, n)
        faces.append(Faces(o_f, n_f, o >= 0, n >= 0))

    tree = cKDTree(centers)
    families: Dict[str, Family] = {}
    for name, sides in hypercube_families:
        g, p = ghosts_and_projections_hcube(
            list(sides), msh.origin, msh.widths, centers, widths,
            ghost_layer_ratio=GHOST_LAYER_RATIO)
        families[name] = _image_stencil(centers, widths, tree, g, p,
                                        axis_stencils=True)
    inside = points_inside(stl, centers)
    for name, dfield in msh.distance_fields.items():
        g, p = ghosts_and_projections_stl(
            dfield, centers, widths, ghost_layer_ratio=GHOST_LAYER_RATIO)
        excl = np.zeros(N, bool)
        excl[g] = points_inside(dfield.stl, centers[g])
        families[name] = _image_stencil(centers, widths, tree, g, p,
                                        exclude=excl)
    return RefDomain(msh, centers, widths, faces, families, inside)


def box_sides(nd: int) -> List[Tuple[int, bool]]:
    """Every side of the outer box, as (dimension, high side)."""
    return [(d, s) for d in range(nd) for s in (False, True)]


def idw(X_from: np.ndarray, X_to: np.ndarray) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    """Inverse-distance kNN transfer between two cell clouds, k = 2^nd
    (ImmersedBoundary.jl's multigrid interpolators, ``linear = false``)."""
    idx, w = interpolator(X_from, X_to, linear=False)
    return np.asarray(idx, np.int64), np.asarray(w, np.float32)
