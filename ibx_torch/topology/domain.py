"""Domain compiler: octree mesh -> static index tables (counterpart of
`ibx/topology/domain.py`, reference ``src/ImmersedBoundary.jl:483-786``).

The mesh is "compiled" once, on the host in numpy, into gather tables:
cells and faces, the global ghost-cell boundary tables of the named
families, the postprocessing surfaces, the partitions with their skirt
(halo) cell sets and the per-partition ghost boundaries. The host parts are
copies of the JAX package's (`_build_host_boundary`, the STL ghost-band
logic with its ``fluid_ghost_ratio`` / ``reflect_solid_images`` /
``solve_inside_cells`` keywords, `_pairs_to_padded`, the partition build);
what a step reads lives on the domain's device as torch tensors, placed in
one pass at the end of the build. Index tables are int64 there (see
`ibx_torch.ops.stencil`).

The face-accumulation tables of `Domain.partitions` are built at first
access (``build_timings["partitions"]``): the block marches build their own
tables from the same faces (`ibx_torch.topology.blocks`) and never read
them. Each build stage is also a host span of its name
(`ibx_torch.utils.monitor`), a child of the span open around the build.
The executor (`Domain.map`, `Domain.collect`, `Domain.impose_bc`,
`FusedBoundary`) is functional: each returns new tensors, and a ghost
write-back is one `index_copy` over unique rows.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..geometry.inside import points_inside
from ..geometry.octree import Mesh, get_cells
from ..geometry.stereolitography import Stereolitography, centers_and_normals
from ..ops.operators import Partition
from ..ops.stencil import Stencil, stencil_from_padded, take_rows
from ..utils import monitor
from .faces import hcube_faces, octree2faces_blocks
from .ghosts import ghosts_and_projections_hcube, ghosts_and_projections_stl
from .interp import interpolator

_EPS32 = float(np.finfo(np.float32).eps)


def require_device(name: str, device) -> torch.device:
    """``device`` as a `torch.device`; a CUDA device without a card raises
    (entry points run on the card unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: device is CUDA but no CUDA device is "
                           f"available (pass device='cpu')")
    return device


def _i64(a, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.int64), device=device)


def _f32(a, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def _move(obj, device):
    """``obj`` with every tensor and every table that has a ``.to`` moved
    to ``device`` (dataclass fields, one level)."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if hasattr(getattr(obj, f.name), "to")})


@dataclasses.dataclass
class Boundary:
    """Ghost-cell boundary block (reference ``src/ImmersedBoundary.jl:406-448``).

    ghost: int64[G] cell indices (global for a 1-partition domain, local
    otherwise). interp: image-point interpolation stencil in the same index
    space. eta = ghost_distance / image_distance (the ghost blending factor,
    reference ``src/ImmersedBoundary.jl:1220``).
    """

    ghost: torch.Tensor
    projections: torch.Tensor
    normals: torch.Tensor
    image_distances: torch.Tensor
    ghost_distances: torch.Tensor
    eta: torch.Tensor
    interp: Stencil
    valid: torch.Tensor
    n_ghost: int

    def to(self, device) -> "Boundary":
        return _move(self, device)


@dataclasses.dataclass
class Surface:
    """Postprocessing surface (reference ``src/ImmersedBoundary.jl:335-376``).

    Sampling points are STL face centers offset 1.01 circumdiameters along the
    unit normal; ``interpolator`` samples cell fields at the wall (stencil
    biased off-wall), ``offset_interpolator`` at 1.5x the offset (wall-model
    sampling). ``areas`` are normal magnitudes.
    """

    points: np.ndarray
    offsets: np.ndarray
    normals: np.ndarray
    areas: np.ndarray
    interpolator: Stencil
    offset_interpolator: Stencil
    stl: Stereolitography

    def to(self, device) -> "Surface":
        """The same surface with its two tables on ``device``."""
        return _move(self, device)

    def __call__(self, u):
        return self.interpolator(u)

    def at_offset(self, u):
        return self.offset_interpolator(u)


def surface_integral(surf: Surface, u):
    """Area-weighted surface sum (reference ``src/ImmersedBoundary.jl:351-361``)."""
    u = torch.as_tensor(u)
    a = torch.as_tensor(surf.areas, device=u.device)
    return (u * a.reshape(a.shape + (1,) * (u.dim() - 1))).sum(dim=0)


def blend_families(Pi, normals, eta, family, names: Sequence[str],
                   fns: Dict[str, Callable]):
    """Eta-blended ghost rows of several families (reference
    ``src/ImmersedBoundary.jl:1220-1245``): ``fns[name](Pi, normals)`` gives
    family ``name``'s boundary values from the image values ``Pi``, row g
    takes those of family ``family[g]``, and the ghost is ``eta * image +
    (1 - eta) * bc``."""
    r = None
    for i, name in enumerate(names):
        ri = fns[name](Pi, normals)
        sel = (family == i).reshape(family.shape + (1,) * (Pi.dim() - 1))
        r = ri if r is None else torch.where(sel, ri, r)
    return eta * Pi + (1.0 - eta) * r


def _mirror_velocity(g, normals, corr):
    """Ghost rows ``g`` with ``corr * normal`` taken off their velocity."""
    nd = normals.shape[1]
    return torch.cat([
        g[:, :2],
        g[:, 2:2 + nd] - corr[:, None] * normals,
        g[:, 2 + nd:],
    ], dim=1)


def mirror_families(g, Pi, normals, eta, family, names: Sequence[str],
                    mirror: Sequence[str], mirror_scale=None):
    """Blended ghost rows ``g`` with the normal velocity of the ``mirror``
    families' rows reflected: -eta*u_n(image) where the blend gives
    +eta*u_n(image) (a flagged deviation from the reference blend, whose
    wall is porous under near-wall vortical flow). ``mirror_scale``
    (f32[G]) gates the reflection row by row."""
    nd = normals.shape[1]
    mm = None
    for i, name in enumerate(names):
        if name in mirror:
            s = family == i
            mm = s if mm is None else (mm | s)
    un_i = (Pi[:, 2:2 + nd] * normals).sum(dim=1)
    corr = torch.where(mm, 2.0 * eta[:, 0] * un_i, torch.zeros_like(un_i))
    if mirror_scale is not None:
        corr = corr * mirror_scale
    return _mirror_velocity(g, normals, corr)


@dataclasses.dataclass
class FusedBoundary:
    """Several boundary families as one gather and one write-back.

    The eta-blended ghost update (reference ``src/ImmersedBoundary.jl:
    1220-1245``) for all families in a single pass: ``family`` selects which
    BC function's result lands on each ghost row.
    """

    ghost: torch.Tensor     # int64[G], sorted unique global cell ids
    interp: Stencil         # image-point stencil, global index space
    normals: torch.Tensor   # f32[G, nd]
    eta: torch.Tensor       # f32[G, 1]
    family: torch.Tensor    # int64[G] index into names
    names: Tuple[str, ...]

    def to(self, device) -> "FusedBoundary":
        return _move(self, device)

    def __call__(self, P, fns: Dict[str, Callable], *, guard=None,
                 mirror: Sequence[str] = (), mirror_scale=None):
        """``fns[name](P_image, normals) -> bc values``; returns the updated
        state as a new tensor.

        ``guard`` (optional) post-processes the blended ghost rows (e.g.
        `physicality_guard`): linear image stencils can extrapolate with
        negative weights at thin geometry. ``mirror`` (family names) flips
        the ghost normal velocity to -eta*u_n(image); ``mirror_scale``
        (f32[G]) gates it row by row.
        """
        Pi = self.interp(P)
        g = blend_families(Pi, self.normals, self.eta, self.family,
                           self.names, fns)
        if mirror:
            g = mirror_families(g, Pi, self.normals, self.eta, self.family,
                                self.names, mirror, mirror_scale)
        if guard is not None:
            g = guard(g)
        return P.index_copy(0, self.ghost, g)


@dataclasses.dataclass
class HostBoundary:
    """Global boundary tables of one family."""

    ghosts: np.ndarray          # int64[G] global cell ids
    projections: np.ndarray     # f32[G, nd]
    normals: np.ndarray         # f32[G, nd]
    image_distances: np.ndarray
    ghost_distances: np.ndarray
    interp_idx: np.ndarray      # int64[G, k] global cell ids
    interp_w: np.ndarray        # f32[G, k]


def _build_host_boundary(
    centers: np.ndarray,
    widths: np.ndarray,
    tree: cKDTree,
    ghosts: np.ndarray,
    projs: np.ndarray,
    ghost_ratio: float,
    exclude_cells: Optional[np.ndarray] = None,
    reflect_solid: bool = False,
    axis_stencils: bool = False,
) -> HostBoundary:
    """Ghost geometry + image-point stencils
    (reference ``src/ImmersedBoundary.jl:422-448``); see the JAX package's
    `_build_host_boundary` for the reasons behind ``exclude_cells``,
    ``w_cap=1.5`` and the 2-point ``axis_stencils``."""
    gc = centers[ghosts]
    normals = gc - projs
    gd = np.sqrt((normals.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    # divide by max(gd, eps), NOT gd + eps: hypercube ghost normals must
    # come out as EXACT unit axis vectors
    normals = normals / np.maximum(gd, _EPS32)[:, None]
    diam = np.sqrt((widths[ghosts].astype(np.float64) ** 2).sum(1)).astype(np.float32)
    image_d = diam * ghost_ratio + _EPS32
    if reflect_solid and exclude_cells is not None:
        ins_g = exclude_cells[ghosts]
        normals = np.where(ins_g[:, None], -normals, normals)
    images = projs + normals * image_d[:, None]
    if axis_stencils and ghosts.size:
        # hypercube-family image stencils: the two straddling cells of the
        # ghost's own column (exact linear interpolation)
        d_axis = np.abs(normals).argmax(axis=1)
        _, knn = tree.query(images, k=2, workers=-1)
        c0 = centers[knn[:, 0]]
        c1 = centers[knn[:, 1]]
        h_g = widths[ghosts].max(axis=1)
        ar = np.arange(ghosts.size)
        lat_ok = np.ones(ghosts.size, bool)
        for dd in range(centers.shape[1]):
            ld = dd != d_axis
            lat_ok &= np.where(
                ld,
                (np.abs(c0[:, dd] - images[:, dd]) < 0.05 * h_g)
                & (np.abs(c1[:, dd] - images[:, dd]) < 0.05 * h_g),
                True,
            )
        a0 = c0[ar, d_axis]
        a1 = c1[ar, d_axis]
        sep_ok = np.abs(a1 - a0) > 0.5 * h_g
        t = (images[ar, d_axis] - a0) / np.where(sep_ok, a1 - a0, 1.0)
        ok = lat_ok & sep_ok & (t > -0.1) & (t < 1.1)
        idx2 = np.stack([knn[:, 0], knn[:, 1]], axis=1).astype(np.int64)
        w2 = np.stack([1.0 - t, t], axis=1).astype(np.float32)
        if ok.all():
            return HostBoundary(
                ghosts=ghosts.astype(np.int64),
                projections=projs.astype(np.float32),
                normals=normals.astype(np.float32),
                image_distances=image_d,
                ghost_distances=gd,
                interp_idx=idx2,
                interp_w=w2,
            )
        # mixed: kNN-fit the non-conforming ghosts, keep the axis pairs
        ki, kw = interpolator(centers, images[~ok], tree, linear=True,
                              w_cap=1.5)
        K = max(2, ki.shape[1])
        idx_f = np.zeros((ghosts.size, K), np.int64)
        w_f = np.zeros((ghosts.size, K), np.float32)
        idx_f[ok, :2] = idx2[ok]
        idx_f[ok, 2:] = idx2[ok, :1]
        w_f[ok, :2] = w2[ok]
        ki = ki.astype(np.int64)
        idx_f[~ok, :ki.shape[1]] = ki
        idx_f[~ok, ki.shape[1]:] = ki[:, :1]
        w_f[~ok, :ki.shape[1]] = kw
        return HostBoundary(
            ghosts=ghosts.astype(np.int64),
            projections=projs.astype(np.float32),
            normals=normals.astype(np.float32),
            image_distances=image_d,
            ghost_distances=gd,
            interp_idx=idx_f,
            interp_w=w_f,
        )
    if exclude_cells is not None and exclude_cells.any():
        src = np.nonzero(~exclude_cells)[0]
        idx, w = interpolator(centers[src], images, linear=True, w_cap=1.5)
        idx = src[idx.astype(np.int64)].astype(idx.dtype)
    else:
        idx, w = interpolator(centers, images, tree, linear=True, w_cap=1.5)
    return HostBoundary(
        ghosts=ghosts.astype(np.int64),
        projections=projs.astype(np.float32),
        normals=normals.astype(np.float32),
        image_distances=image_d,
        ghost_distances=gd,
        interp_idx=np.asarray(idx, dtype=np.int64),
        interp_w=np.asarray(w, dtype=np.float32),
    )


def _pairs_to_padded(cells, items, weights, n_cells, min_width=1):
    """Scatter (cell, item, weight) pairs into padded [C, K] tables."""
    order = np.argsort(cells, kind="stable")
    cells_s = cells[order]
    items_s = items[order]
    w_s = weights[order]
    counts = np.bincount(cells_s, minlength=n_cells)
    K = max(int(counts.max()) if counts.size else 0, min_width)
    starts = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(cells_s.size) - starts[cells_s]
    idx = np.zeros((n_cells, K), dtype=np.int32)
    w = np.zeros((n_cells, K), dtype=np.float32)
    idx[cells_s, slot] = items_s
    w[cells_s, slot] = w_s
    # pad columns with the row's first entry (harmless gather)
    has = counts > 0
    for kcol in range(1, K):
        need = counts <= kcol
        fix = has & need
        idx[fix, kcol] = idx[fix, 0]
    return idx, w


def _as_tuple(res):
    return tuple(res) if isinstance(res, (tuple, list)) else (res,)


class DomainExecutionMixin:
    """Functional counterparts of the reference's partition executor."""

    def _local_args(self, p: int, arrays):
        return [take_rows(a, self._part_domain_dev[p]) for a in arrays]

    def _on_device(self, arrays):
        """The arrays as tensors on the domain's device (float64 input
        becomes float32, the package's working precision)."""
        out = [torch.as_tensor(a, device=self.device) for a in arrays]
        return [a.float() if a.dtype == torch.float64 else a for a in out]

    def map(self, f, *arrays):
        """Run ``f(part, *local_arrays) -> updated locals`` over partitions
        and write owned rows back (reference
        ``src/ImmersedBoundary.jl:820-864``, made functional).
        Returns the updated global arrays (tuple, or single array)."""
        arrays = self._on_device(arrays)
        if self.n_partitions == 1:
            res = f(self.partitions[0], *arrays)
            if not isinstance(res, (tuple, list)):
                return res
            return tuple(res) if len(res) > 1 else res[0]
        outs = list(arrays)
        for p, part in enumerate(self.partitions):
            res = _as_tuple(f(part, *self._local_args(p, arrays)))
            own = self._part_own_dev[p]
            for i, r in enumerate(res):
                outs[i] = outs[i].index_copy(0, own, r[:own.shape[0]])
        return outs[0] if len(outs) == 1 else tuple(outs)

    def collect(self, f, *arrays):
        """Run ``f(part, *local_arrays) -> value`` over partitions and return
        the list of per-partition values (the reference executor's return
        collection)."""
        arrays = self._on_device(arrays)
        return [f(part, *self._local_args(p, arrays))
                for p, part in enumerate(self.partitions)]


class Domain(DomainExecutionMixin):
    """Compiled domain (reference ``src/ImmersedBoundary.jl:536-786``).

    Parameters mirror the JAX package's `Domain`; ``n_partitions`` (default
    1) is the number of devices to shard over, and ``max_partition_size`` is
    accepted for API parity and converted to a partition count. ``device``
    (the card unless asked otherwise) is where the partitions, boundaries
    and surface stencils are placed.
    """

    def __init__(
        self,
        msh: Mesh,
        *,
        n_partitions: int = 1,
        max_partition_size: Optional[int] = None,
        partition_skirt_depth: int = 2,
        ghost_layer_ratio: float = 1.5,
        hypercube_families: Sequence[Tuple[str, Sequence[Tuple[int, bool]]]] = (),
        fluid_ghost_ratio: Optional[float] = None,
        reflect_solid_images: bool = False,
        solve_inside_cells: Optional[np.ndarray] = None,
        device="cuda",
    ):
        # ``solve_inside_cells`` (bool[N], cut-cell wall support): in-solid
        # cells the scheme SOLVES (fluid fraction above the cut-cell
        # floor). They are dropped from STL ghost bands (the BC must not
        # overwrite solved cells) and stay eligible as image-stencil
        # sources. Not persisted into reconstruction_kwargs: coarse
        # multigrid rebuilds use the plain ghost bands.
        self.device = require_device("Domain", device)
        self.mesh = msh
        self.nd = msh.ndim
        self._t_stage = time.time_ns()
        # stage name -> elapsed seconds (the reference prints stage banners
        # + wall clock, src/ImmersedBoundary.jl:544-767)
        self.build_timings: Dict[str, float] = {}
        centers, widths, _ = get_cells(msh)
        N = centers.shape[0]
        self.ncells = N
        self.centers = centers
        self.widths = widths
        self.reconstruction_kwargs = dict(
            n_partitions=n_partitions,
            max_partition_size=max_partition_size,
            partition_skirt_depth=partition_skirt_depth,
            ghost_layer_ratio=ghost_layer_ratio,
            hypercube_families=list(hypercube_families),
            fluid_ghost_ratio=fluid_ghost_ratio,
            reflect_solid_images=reflect_solid_images,
        )
        self._stage("cells")

        if max_partition_size is not None:
            n_partitions = max(1, -(-N // max_partition_size))
        P = n_partitions

        origins = centers - widths / 2
        fdim, fo, fn = octree2faces_blocks(msh, origins, widths)
        hdim, ho, hn = hcube_faces(msh.origin, msh.widths, origins, widths)
        fdim = np.concatenate([fdim, hdim])
        fo = np.concatenate([fo, ho])
        fn = np.concatenate([fn, hn])
        self.face_dim, self.face_owner, self.face_neighbor = fdim, fo, fn
        self._stage("faces")

        # ---- global boundaries & surfaces ------------------------------
        tree = cKDTree(centers)
        diams = np.sqrt((widths.astype(np.float64) ** 2).sum(1)).astype(np.float32)
        self._host_boundaries: Dict[str, HostBoundary] = {}
        self.surfaces: Dict[str, Surface] = {}
        for bname, bfaces in hypercube_families:
            ghosts, projs = ghosts_and_projections_hcube(
                list(bfaces), msh.origin, msh.widths, centers, widths,
                ghost_layer_ratio=ghost_layer_ratio,
            )
            self._host_boundaries[bname] = _build_host_boundary(
                centers, widths, tree, ghosts, projs, ghost_layer_ratio,
                axis_stencils=True,
            )
            self._stage(f"boundary[{bname}]")

        for bname, dfield in msh.distance_fields.items():
            ghosts, projs = ghosts_and_projections_stl(
                dfield, centers, widths, ghost_layer_ratio=ghost_layer_ratio
            )
            self._stage(f"ghosts[{bname}]")
            # ban in-solid cells from image stencils (no BC feedback loop
            # through unsolved values at thin geometry)
            inside = None
            if dfield.stl.simplices.shape[0] and ghosts.size:
                inside = np.zeros(N, bool)
                inside[ghosts] = points_inside(dfield.stl, centers[ghosts])
            if solve_inside_cells is not None and ghosts.size:
                keep = ~solve_inside_cells[ghosts]
                ghosts, projs = ghosts[keep], projs[keep]
                if inside is not None:
                    inside = inside & ~solve_inside_cells
                self._stage(f"ghost-solved[{bname}]")
            if fluid_ghost_ratio is not None and inside is not None:
                # flagged deviation from the reference's unsigned ghost
                # band (src/ImmersedBoundary.jl:194-230): with the flag,
                # fluid-side cells further than fluid_ghost_ratio *
                # circumdiam from the wall are SOLVED, and the wall enters
                # through the in-solid ghost rows (classic sharp-interface
                # IB); see the JAX package's `Domain.__init__`
                gd = np.sqrt(((centers[ghosts] - projs).astype(np.float64)
                              ** 2).sum(1))
                keep = inside[ghosts] | (
                    gd <= fluid_ghost_ratio * diams[ghosts])
                ghosts, projs = ghosts[keep], projs[keep]
                self._stage(f"ghost-band[{bname}]")
            self._host_boundaries[bname] = _build_host_boundary(
                centers, widths, tree, ghosts, projs, ghost_layer_ratio,
                exclude_cells=inside, reflect_solid=reflect_solid_images,
            )
            # postprocessing surface (reference src/ImmersedBoundary.jl:743-763)
            stl = dfield.stl
            fcenters, fnormals = centers_and_normals(stl)
            _, idx = tree.query(fcenters, k=1, workers=-1)
            h = diams[idx] * 1.01
            A = np.sqrt((fnormals.astype(np.float64) ** 2).sum(1)).astype(np.float32) + _EPS32
            unit_n = fnormals / A[:, None]
            bias = unit_n * h[:, None]
            self.surfaces[bname] = Surface(
                points=fcenters,
                offsets=h,
                normals=unit_n,
                areas=A,
                interpolator=stencil_from_padded(*interpolator(
                    centers, fcenters, tree, bias=bias, linear=True)),
                offset_interpolator=stencil_from_padded(*interpolator(
                    centers, fcenters + bias * ghost_layer_ratio, tree,
                    linear=True)),
                stl=stl,
            )
        self._stage("boundaries")

        # ---- partition cell sets ------------------------------------------
        n_own = -(-N // P)
        self.n_partitions = P
        self.n_own = n_own
        self._partitions: Optional[List[Partition]] = None
        self.part_own: List[np.ndarray] = []       # real owned global ids
        self.part_domain: List[np.ndarray] = []    # domain global ids (padded)
        self.part_own_mask: List[np.ndarray] = []
        self._part_g2l: List[np.ndarray] = []

        interior = (fo >= 0) & (fn >= 0)
        eo, en = fo[interior].astype(np.int64), fn[interior].astype(np.int64)

        for p in range(P):
            lo, hi = p * n_own, min((p + 1) * n_own, N)
            own = np.arange(lo, hi, dtype=np.int64)

            mask = np.zeros(N, dtype=bool)
            mask[own] = True
            for _ in range(partition_skirt_depth):
                add_o = en[mask[eo]]
                add_n = eo[mask[en]]
                mask[add_o] = True
                mask[add_n] = True
            # fold BC stencil cells of owned ghosts into the skirt
            for hb in self._host_boundaries.values():
                sel = (hb.ghosts >= lo) & (hb.ghosts < hi)
                if sel.any():
                    mask[hb.interp_idx[sel].reshape(-1)] = True

            mask[own] = False
            skirt = np.nonzero(mask)[0]
            pad = n_own - own.size
            domain = np.concatenate([
                own,
                np.zeros(pad, dtype=np.int64),   # padding slots gather cell 0
                skirt,
            ])

            g2l = np.full(N, -1, dtype=np.int64)
            g2l[skirt] = np.arange(skirt.size) + n_own
            g2l[own] = np.arange(own.size)        # own wins over any overlap

            own_mask = np.zeros(domain.size, dtype=np.float32)
            own_mask[: own.size] = 1.0

            self.part_own.append(own)
            self.part_domain.append(domain)
            self.part_own_mask.append(own_mask)
            self._part_g2l.append(g2l)

        self._stage("partition_sets")

        # ---- localized boundaries --------------------------------------
        # boundaries[name][p]: per-partition blocks (empty blocks possible)
        self.boundaries: Dict[str, List[Boundary]] = {}
        self._ghost_global: Dict[str, List[np.ndarray]] = {}
        for bname, hb in self._host_boundaries.items():
            blocks = []
            ghost_globals = []
            for p in range(P):
                lo, hi = p * n_own, min((p + 1) * n_own, N)
                sel = (hb.ghosts >= lo) & (hb.ghosts < hi)
                blocks.append(self._localize_boundary(hb, sel, p))
                ghost_globals.append(hb.ghosts[sel])
            self.boundaries[bname] = blocks
            self._ghost_global[bname] = ghost_globals

        self._stage("localize_boundaries")

        # ---- single device placement pass --------------------------------
        dev = self.device
        self.boundaries = {k: [b.to(dev) for b in v]
                           for k, v in self.boundaries.items()}
        self.surfaces = {k: s.to(dev) for k, s in self.surfaces.items()}
        # the executor's index vectors, converted once
        self._ghost_global_dev = {k: [_i64(g, dev) for g in v]
                                  for k, v in self._ghost_global.items()}
        self._part_domain_dev = [_i64(d, dev) for d in self.part_domain]
        self._part_own_dev = [_i64(o, dev) for o in self.part_own]
        self._stage("device_put")

    def _stage(self, name: str) -> None:
        """Record the build stage ``name``, which ends now and began where
        the last one ended: its seconds in ``build_timings`` and a host
        span."""
        now = time.time_ns()
        self.build_timings[name] = (now - self._t_stage) / 1e9
        monitor.add_span(name, self._t_stage, now)
        self._t_stage = now

    # -- table compilers --------------------------------------------------

    @property
    def partitions(self) -> List[Partition]:
        """The per-partition operator tables on the domain's device, built
        at first access (``build_timings["partitions"]`` holds the
        seconds, the upload included)."""
        if self._partitions is None:
            self._t_stage = time.time_ns()
            self._partitions = [
                self._build_partition_tables(
                    p, self.part_domain[p], self._part_g2l[p],
                    self.part_own_mask[p], self.centers, self.widths,
                ).to(self.device)
                for p in range(self.n_partitions)]
            self._stage("partitions")
        return self._partitions

    def partition(self, p: int) -> Partition:
        """Partition ``p``'s tables on the domain's device; builds that
        one alone unless `partitions` already holds them (a rank of the
        sharded runtime needs no other)."""
        if self._partitions is not None:
            return self._partitions[p]
        return self._build_partition_tables(
            p, self.part_domain[p], self._part_g2l[p], self.part_own_mask[p],
            self.centers, self.widths).to(self.device)

    def _build_partition_tables(self, p, domain, g2l, own_mask,
                                centers, widths) -> Partition:
        nd = self.nd
        n_dom = domain.size
        in_dom = np.zeros(self.ncells + 1, dtype=bool)
        in_dom[domain] = True

        fdim, fo, fn = self.face_dim, self.face_owner, self.face_neighbor
        # sentinel trick: in_dom has N+1 entries and in_dom[-1] == in_dom[N]
        # == False, so the -1 "outside" marker tests False directly
        touches = in_dom[fo] | in_dom[fn]

        face_owner, face_neighbor, acc_left, acc_right = [], [], [], []
        for d in range(nd):
            sel = touches & (fdim == d)
            o_g = fo[sel].astype(np.int64)
            n_g = fn[sel].astype(np.int64)
            o_l = np.where(o_g >= 0, g2l[o_g], -1)
            n_l = np.where(n_g >= 0, g2l[n_g], -1)
            # one-sided handling (reference src/ImmersedBoundary.jl:648-667)
            add_right = o_l >= 0
            add_left = n_l >= 0
            o_f = np.where(o_l < 0, n_l, o_l)
            n_f = np.where(n_l < 0, o_f, n_l)

            F = o_f.size
            face_owner.append(_i64(o_f.astype(np.int32)))
            face_neighbor.append(_i64(n_f.astype(np.int32)))

            face_ids = np.arange(F, dtype=np.int64)
            for side_cells, add, store in (
                (n_f, add_left, acc_left),
                (o_f, add_right, acc_right),
            ):
                cc = side_cells[add]
                ff = face_ids[add]
                counts = np.bincount(cc, minlength=n_dom).astype(np.float64)
                w = 1.0 / counts[cc]
                idx_t, w_t = _pairs_to_padded(
                    cc, ff.astype(np.int32), w.astype(np.float32), n_dom
                )
                store.append(stencil_from_padded(idx_t, w_t))

        return Partition(
            centers=_f32(centers[domain]),
            spacing=_f32(widths[domain]),
            face_owner=tuple(face_owner),
            face_neighbor=tuple(face_neighbor),
            acc_left=tuple(acc_left),
            acc_right=tuple(acc_right),
            own_mask=_f32(own_mask),
            n_own=int(self.n_own),
            n_dom=int(n_dom),
            nd=nd,
        )

    def _localize_boundary(self, hb: HostBoundary, sel: np.ndarray,
                           p: int) -> Boundary:
        g2l = self._part_g2l[p]
        ghosts_l = g2l[hb.ghosts[sel]]
        idx_l = g2l[hb.interp_idx[sel]]
        assert (ghosts_l >= 0).all() and (idx_l >= 0).all(), \
            "boundary stencil escaped partition domain"
        G = int(sel.sum())
        gd = hb.ghost_distances[sel]
        idist = hb.image_distances[sel]
        return Boundary(
            ghost=_i64(ghosts_l.astype(np.int32)),
            projections=_f32(hb.projections[sel]),
            normals=_f32(hb.normals[sel]),
            image_distances=_f32(idist),
            ghost_distances=_f32(gd),
            eta=_f32((gd / idist).astype(np.float32)),
            interp=stencil_from_padded(idx_l, hb.interp_w[sel]),
            valid=torch.ones(G, dtype=torch.float32),
            n_ghost=G,
        )

    # -- boundary imposition ------------------------------------------------

    def impose_bc(self, name: str, fn, *arrays, mirror_velocity=False,
                  **kwargs):
        """Functional ghost-cell BC application (reference
        ``src/ImmersedBoundary.jl:1197-1247``).

        ``fn(bdry, *image_values, **kwargs)`` maps image-point values to
        boundary values; ghosts blend ``eta * image + (1 - eta) * bc``.
        ``mirror_velocity`` flips the first array's ghost normal velocity
        to -eta*u_n(image) (flagged deviation; see FusedBoundary); a tensor
        aligned with this family's ghosts gates it row by row.
        Returns the updated global arrays, as new tensors.
        """
        arrays = self._on_device(arrays)
        outs = list(arrays)
        for p, bdry in enumerate(self.boundaries[name]):
            if bdry.n_ghost == 0:
                continue
            if self.n_partitions == 1:
                dargs = arrays
            else:
                dargs = self._local_args(p, arrays)
            iargs = [bdry.interp(a) for a in dargs]
            res = _as_tuple(fn(bdry, *iargs, **kwargs))
            ghost_global = self._ghost_global_dev[name][p]
            for i, (ia, ba) in enumerate(zip(iargs, res)):
                eta = bdry.eta.reshape(bdry.eta.shape + (1,) * (ia.dim() - 1))
                gvals = eta * ia + (1.0 - eta) * ba
                if mirror_velocity is not False and i == 0:
                    nd = bdry.normals.shape[1]
                    un_i = (ia[:, 2:2 + nd] * bdry.normals).sum(dim=1)
                    corr = 2.0 * bdry.eta * un_i
                    if mirror_velocity is not True:
                        # tensor gate aligned with this family's ghosts
                        corr = corr * mirror_velocity
                    gvals = _mirror_velocity(gvals, bdry.normals, corr)
                outs[i] = outs[i].index_copy(0, ghost_global, gvals)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def fused_boundary(self, names: Sequence[str]) -> FusedBoundary:
        """Fuse several boundary families into ONE image-interpolation gather
        and ONE ghost write-back (see ``FusedBoundary.__call__``), on the
        domain's device. Ghost sets must be disjoint (they are for distinct
        families by construction). Single-partition domains only.
        """
        if self.n_partitions != 1:
            raise ValueError("fused_boundary requires n_partitions == 1")
        names = list(names)
        ghost_list, idx_list, w_list = [], [], []
        normal_list, eta_list, fam_list = [], [], []
        for i, name in enumerate(names):
            hb = self._host_boundaries[name]
            ghost_list.append(hb.ghosts)
            idx_list.append(hb.interp_idx)
            w_list.append(hb.interp_w)
            normal_list.append(hb.normals)
            eta_list.append(hb.ghost_distances / hb.image_distances)
            fam_list.append(np.full(hb.ghosts.size, i, dtype=np.int32))
        ghosts = np.concatenate(ghost_list)
        if np.unique(ghosts).size != ghosts.size:
            raise ValueError("fused families share ghost cells")
        order = np.argsort(ghosts)
        K = max(a.shape[1] for a in idx_list)

        def padk(a, fill):
            if a.shape[1] == K:
                return a
            pad = np.repeat(a[:, :1] if fill else np.zeros_like(a[:, :1]),
                            K - a.shape[1], axis=1)
            return np.concatenate([a, pad], axis=1)

        idx = np.concatenate([padk(a, True) for a in idx_list])[order]
        w = np.concatenate([padk(a, False) for a in w_list])[order]
        return FusedBoundary(
            ghost=_i64(ghosts[order].astype(np.int32)),
            interp=stencil_from_padded(idx.astype(np.int32),
                                       w.astype(np.float32)),
            normals=_f32(np.concatenate(normal_list)[order]),
            eta=_f32(np.concatenate(eta_list)[order])[:, None],
            family=_i64(np.concatenate(fam_list)[order]),
            names=tuple(names),
        ).to(self.device)

    def volume_integral(self, A):
        """Cell-volume-weighted integral (reference
        ``src/ImmersedBoundary.jl:1415-1431``)."""
        A, = self._on_device([A])
        vol = torch.as_tensor(np.prod(self.widths, axis=1), device=A.device)
        return (A * vol.reshape(vol.shape + (1,) * (A.dim() - 1))).sum(dim=0)

    def __len__(self):
        return self.ncells
