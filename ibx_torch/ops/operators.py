"""Finite-volume grid operators on the generic gather path (counterpart of
`ibx/ops/operators.py`, reference ``src/ImmersedBoundary.jl:873-1157``).

All operators are pure functions of a :class:`Partition`'s static index
tables and a state tensor whose leading axis is the cell index. Face values
live on per-dimension face arrays; cell accumulation uses padded face
stencils (hanging faces are averaged with 1/n weights, reference
``src/ImmersedBoundary.jl:501-506``). Every expression keeps the operand
order of the JAX package's, so that the two agree to the last few ulps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .stencil import Stencil, apply_stencil, take_rows


@dataclasses.dataclass
class Partition:
    """Static per-partition tables (reference ``src/ImmersedBoundary.jl:383-399``).

    centers/spacing: float32[n_dom, nd], owned cells first (n_own rows,
    possibly right-padded), then skirt (halo) cells.
    face_owner/face_neighbor: per-dim int64[F_d] cell indices (one-sided
    boundary faces have owner == neighbor).
    acc_left/acc_right: per-dim face->cell accumulation stencils.
    own_mask: float32[n_dom], 1 on real owned cells (0 on padding and skirt),
    the weight for global reductions.
    """

    centers: torch.Tensor
    spacing: torch.Tensor
    face_owner: Tuple[torch.Tensor, ...]
    face_neighbor: Tuple[torch.Tensor, ...]
    acc_left: Tuple[Stencil, ...]
    acc_right: Tuple[Stencil, ...]
    own_mask: torch.Tensor
    n_own: int
    n_dom: int
    nd: int

    def to(self, device) -> "Partition":
        """The same tables on ``device``."""
        def move(x):
            if isinstance(x, tuple):
                return tuple(move(y) for y in x)
            return x.to(device)

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if f.name not in ("n_own", "n_dom", "nd")})


def _bcast(x, like):
    """Append trailing singleton dims so x broadcasts against `like`."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def at_owners(part: Partition, u, dim: int):
    """Values at face owners (reference ``src/ImmersedBoundary.jl:879``)."""
    return take_rows(u, part.face_owner[dim])


def at_neighbors(part: Partition, u, dim: int):
    """Values at face neighbors (reference ``src/ImmersedBoundary.jl:889``)."""
    return take_rows(u, part.face_neighbor[dim])


def _spacing_at(part: Partition, idx, dim: int):
    return part.spacing[:, dim].index_select(0, idx)


def at_faces(part: Partition, u, dim: int):
    """Spacing-weighted interpolation of cell values to faces
    (reference ``src/ImmersedBoundary.jl:899-910``)."""
    so = _spacing_at(part, part.face_owner[dim], dim)
    sn = _spacing_at(part, part.face_neighbor[dim], dim)
    uo = at_owners(part, u, dim)
    un = at_neighbors(part, u, dim)
    return (uo * _bcast(sn, uo) + un * _bcast(so, uo)) / _bcast(so + sn, uo)


def green_gauss(part: Partition, uf, dim: int):
    """(sum over right faces - sum over left faces) / spacing
    (reference ``src/ImmersedBoundary.jl:918-926``)."""
    s = apply_stencil(part.acc_right[dim], uf) - apply_stencil(part.acc_left[dim], uf)
    return s / _bcast(part.spacing[:, dim], s)


def unsigned_green_gauss(part: Partition, uf, dim: int):
    """(right + left face sums) / spacing (reference
    ``src/ImmersedBoundary.jl:934-942``)."""
    s = apply_stencil(part.acc_right[dim], uf) + apply_stencil(part.acc_left[dim], uf)
    return s / _bcast(part.spacing[:, dim], s)


def divergent(part: Partition, uf: Tuple):
    """Green-Gauss divergence of per-dim face fields
    (reference ``src/ImmersedBoundary.jl:950-956``)."""
    out = green_gauss(part, uf[0], 0)
    for d in range(1, part.nd):
        out = out + green_gauss(part, uf[d], d)
    return out


def cell_gradient(part: Partition, u, dim: Optional[int] = None):
    """Green-Gauss cell-center gradient (reference
    ``src/ImmersedBoundary.jl:965-987``); all dims as tuple when
    ``dim is None``."""
    if dim is None:
        return tuple(cell_gradient(part, u, d) for d in range(part.nd))
    return green_gauss(part, at_faces(part, u, dim), dim)


def face_distance(part: Partition, dim: int):
    """Owner-to-neighbor center distance (reference
    ``src/ImmersedBoundary.jl:995-1002``)."""
    so = _spacing_at(part, part.face_owner[dim], dim)
    sn = _spacing_at(part, part.face_neighbor[dim], dim)
    return (so + sn) / 2


def owner_distance(part: Partition, dim: int):
    """Face-to-owner-center distance (reference ``src/ImmersedBoundary.jl:1010-1016``)."""
    return _spacing_at(part, part.face_owner[dim], dim) / 2


def neighbor_distance(part: Partition, dim: int):
    """Face-to-neighbor-center distance (reference ``src/ImmersedBoundary.jl:1024-1030``)."""
    return _spacing_at(part, part.face_neighbor[dim], dim) / 2


def face_gradient(part: Partition, u, dim: int, grad: Optional[Tuple] = None):
    """Face-normal gradient from cell values (reference
    ``src/ImmersedBoundary.jl:1039-1043``); with cell gradients supplied,
    returns the full face-gradient tuple with the normal component replaced by
    the two-point difference (reference ``src/ImmersedBoundary.jl:1051-1069``).
    A one-sided face (owner == neighbor) has a zero two-point difference.
    """
    if grad is None:
        diff = at_neighbors(part, u, dim) - at_owners(part, u, dim)
        return diff / _bcast(face_distance(part, dim), diff)
    out = []
    for i in range(part.nd):
        if i == dim:
            out.append(face_gradient(part, u, dim))
        else:
            out.append(at_faces(part, grad[i], dim))
    return tuple(out)


def jst_sensor(part: Partition, p, dim: Optional[int] = None):
    """JST-type shock sensor at cells (reference
    ``src/ImmersedBoundary.jl:1077-1097``)."""
    if dim is None:
        nu = torch.full_like(p, 1e-7)
        for d in range(part.nd):
            nu = torch.maximum(nu, jst_sensor(part, p, d))
        return nu
    face_diff = at_neighbors(part, p, dim) - at_owners(part, p, dim)
    return (
        1e-7 + green_gauss(part, face_diff, dim).abs()
    ) / (
        1e-7 + unsigned_green_gauss(part, face_diff.abs(), dim)
    )


def abs_select(x):
    """``|x|`` as the select ``x >= 0 ? x : -x``: the same values as
    `torch.abs`, and the forward derivative ``+t`` at ``x = 0`` that
    `jnp.abs` has (`torch.abs` gives 0 there). The limiter and the block
    path's JST sensor take it, so that a JVP through the block RHS (the
    point-implicit solver's) matches the JAX package's where a difference
    is exactly 0: across the frozen in-solid cells, which hold one
    pressure, and in symmetric states. It costs two more launches than
    `torch.abs`."""
    return torch.where(x >= 0, x, -x)


def minmod(u1, u2):
    """Minmod limiter (reference ``src/ImmersedBoundary.jl:1099``)."""
    return torch.minimum(abs_select(u1), abs_select(u2)) * (
        torch.sign(u1) + torch.sign(u2)
    ) / 2


def muscl(
    part: Partition,
    u,
    du,
    dim: int,
    *,
    D=None,
    high_order: bool = False,
    lim_scale=None,
):
    """MUSCL face reconstruction with minmod limiting and optional sensor
    blending toward a central (or 4th-order Pade) scheme.

    Reference ``src/ImmersedBoundary.jl:1113-1157``. ``du`` is the
    central-scheme cell gradient along ``dim``; ``D`` an optional shock sensor
    at cells (1 -> limited MUSCL, 0 -> central).
    Returns (uL, uR) at faces.
    """
    down = owner_distance(part, dim)
    dneigh = neighbor_distance(part, dim)
    uown = at_owners(part, u, dim)
    uneigh = at_neighbors(part, u, dim)

    dwn = _bcast(down, uown)
    dnb = _bcast(dneigh, uown)

    grad_f = (uneigh - uown) / (dwn + dnb)
    duo = at_owners(part, du, dim)
    dun = at_neighbors(part, du, dim)
    slope_o = (2 * duo - grad_f) * dwn
    slope_n = (2 * dun - grad_f) * dnb

    lim = minmod(slope_n, slope_o)
    if lim_scale is not None:
        lim = lim * _bcast(lim_scale, lim)
    uL = uown + lim
    uR = uneigh - lim

    if D is not None:
        Df = torch.maximum(at_owners(part, D, dim),
                           at_neighbors(part, D, dim)).clamp(min=1e-7)
        Df = _bcast(Df, uL) if Df.dim() < uL.dim() else Df
        uf = (uown * dnb + uneigh * dwn) / (dwn + dnb)
        if high_order:
            uf = uf + (duo * dwn - dun * dnb) / 8
        uL = uL * Df + (1.0 - Df) * uf
        uR = uR * Df + (1.0 - Df) * uf

    return uL, uR


# reference-parity aliases
JST_sensor = jst_sensor
MUSCL = muscl
