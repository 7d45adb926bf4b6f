"""Dense block-structured operators on the cell-major block grid
``[B, bs, ..., bs, C]`` (counterpart of `ibx/ops/block_ops.py`, nd = 2
and 3): layout reshapes, the generic sparse leftover, `face_accumulate`
(in both of the JAX package's formulations, concat by default and padded
under ``IBX_PADDED_FACES``) with the structured 2:1 interface
corrections, and `cell_gradient_grid` on it, the block Euler RHS
`euler_rhs_grid` with the ``fix3`` robustness blend, the ``cut3``
cut-cell wall, the ``viscous`` fluxes with an ``mu_t3`` field and, at
nd = 3 and 2, its kernel routes (`ops/rhs_cs.py`), implicit residual
smoothing, and the grid marches `rk2_step_grid` / `euler_step_grid` with
their flat wrappers. The face functions and the 2:1 interface faces are
`ops/scheme.py`'s. The JAX package has no kernel at nd = 2; the port's
2D route gives its torch-op body's values bit for bit on the CPU."""

from __future__ import annotations

import os
from typing import Callable, Sequence

import torch

from ..physics.fluid import (Fluid, primitive2state, speed_of_sound,
                             state2primitive_guarded)
from ..topology.blocks import BlockTables
from ..utils.monitor import count, device_span
from . import rhs_cs, scheme
from .operators import abs_select

# the face-array formulation of `face_accumulate`, read once at import as
# the JAX package reads it (`ibx/ops/block_ops.py:38`): concat by default,
# padded when IBX_PADDED_FACES is set and not "0"
_PADDED_FACES = os.environ.get("IBX_PADDED_FACES", "0") != "0"


def to_blocks(bt: BlockTables, u_flat):
    """[N, ...] flat cell order -> [B, bs, ..., bs, ...] block grid."""
    return u_flat.reshape(
        (bt.n_blocks,) + (bt.block_size,) * bt.nd + tuple(u_flat.shape[1:]))


def to_flat(bt: BlockTables, u3):
    """[B, bs, ..., bs, ...] -> [N, ...]."""
    return u3.reshape((bt.n_cells,) + tuple(u3.shape[1 + bt.nd:]))


# ---------------------------------------------------------------------------
# face accumulation on the cell-major grid
# ---------------------------------------------------------------------------

def _axis(bt: BlockTables, d: int) -> int:
    """Array axis of spatial dim d in the [B, x_{nd-1}, ..., x_0, C]
    layout ([B, y, x, C] in 2D, [B, z, y, x, C] in 3D)."""
    return 1 + (bt.nd - 1 - d)


def _h_bcast(bt: BlockTables, d: int, n_trailing: int = 1):
    return bt.h[:, d].reshape((bt.n_blocks,) + (1,) * (bt.nd + n_trailing))


def _edge(bt: BlockTables, u3, d: int, s: int):
    """Edge plane of every block: [B, lat.., C] (a view; the lateral
    dims keep their array order, highest dim first)."""
    return u3.select(_axis(bt, d), bt.block_size - 1 if s else 0)


def _grid_edge_fetch(bt: BlockTables, parts, d: int):
    """``fetch(s, blocks)`` for `scheme.interface_corrections` over
    cell-major parts: the channel concatenation of the parts' side-s edge
    planes of the given blocks."""
    def fetch(s, blocks):
        es = [_edge(bt, p, d, s).index_select(0, blocks) for p in parts]
        return es[0] if len(es) == 1 else torch.cat(es, dim=-1)

    return fetch



def _sparse_accum(bt: BlockTables, d: int, parts, face_fn: Callable,
                  n_out: int, signed_mask: Sequence[float], o, n, wr, wl):
    """Sparse face accumulation: gather the (owner, neighbor) rows of the
    channel-part grids ``parts``, evaluate ``face_fn`` (over tuples of
    parts), scatter-add with per-face weights (wr to the owner, wl to the
    neighbor with the signed flip) and divide by the cell spacing:
    [n_cells, n_out]. The scatter is `index_add_`, atomic on the card: a
    cell with several leftover faces sums them in an order that varies
    from run to run."""
    flats = [p.reshape(bt.n_cells, -1) for p in parts]
    fn = scheme.cat_fn(face_fn, [f.shape[-1] for f in flats])

    def gather(idx):
        rows = [f.index_select(0, idx) for f in flats]
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=-1)

    sp = bt.spacing_flat[:, d]
    vals = fn(gather(o), gather(n), sp[o][:, None], sp[n][:, None])
    pm = bt.signs(signed_mask)
    out = torch.zeros((bt.n_cells, n_out), dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, o, wr[:, None] * vals)
    out.index_add_(0, n, wl[:, None] * vals * pm)
    return out / sp[:, None]


def _generic_sparse(bt: BlockTables, d: int, parts, face_fn: Callable,
                    n_out: int, signed_mask: Sequence[float]):
    """Leftover faces: batched gather + scatter-add (exotic topologies)."""
    return _sparse_accum(bt, d, parts, face_fn, n_out, signed_mask,
                         bt.sp_owner[d], bt.sp_neighbor[d],
                         bt.sp_wr[d], bt.sp_wl[d])


def _halos(bt: BlockTables, p, d: int):
    """(first, last, halo_l, halo_r) planes of the part ``p`` along dim
    ``d``: its own edge planes and the halo columns beside them (the dense
    neighbor's edge plane; the own edge mirrored on one-sided boundary
    sides; junk on 2:1 sides, whose faces are masked)."""
    ax, bs = _axis(bt, d), bt.block_size
    first = p.narrow(ax, 0, 1)
    last = p.narrow(ax, bs - 1, 1)
    bmask = (bt.n_blocks,) + (1,) * (p.dim() - 1)
    halo_l = torch.where(bt.bnd[d][0].reshape(bmask) > 0, first,
                         last.index_select(0, bt.nbr[d][0]))
    halo_r = torch.where(bt.bnd[d][1].reshape(bmask) > 0, last,
                         first.index_select(0, bt.nbr[d][1]))
    return first, last, halo_l, halo_r


def face_accumulate(bt: BlockTables, d: int, W3, face_fn: Callable,
                    n_out: int, signed_mask: Sequence[float]):
    """Green-Gauss-style accumulation of per-face quantities into cells
    along dim ``d``.

    ``face_fn(W_owner, W_neighbor, h_owner, h_neighbor) -> [..., n_out]``;
    ``W3`` is one [B, bs, ..., bs, K] grid or a tuple of channel-part grids
    (``face_fn`` then receives tuples). Channels flagged in ``signed_mask``
    accumulate (right - left)/h, the others (right + left)/h. Each face is
    evaluated once, in one of the JAX package's two formulations, equal
    face by face (the same inputs, the same function, the same
    divergence):

    * concat (the default): interior faces on slice windows, block-edge
      faces on the halo planes, one face array concatenated from the
      three;
    * padded (``_PADDED_FACES``, from IBX_PADDED_FACES): each part padded
      once with its halo columns, the faces of its two unit-shifted
      (bs+1)-windows.

    Edge faces of 2:1 sides are masked to zero; the 2:1 rows of
    `scheme.interface_corrections` are added in place at the edge slots,
    and the generic sparse leftover, where the mesh has one, is added
    last."""
    tup = isinstance(W3, (tuple, list))
    parts = tuple(W3) if tup else (W3,)
    fn = face_fn if tup else (
        lambda Wo, Wn, ho, hn: face_fn(Wo[0], Wn[0], ho, hn))
    ax = _axis(bt, d)
    bs = bt.block_size
    h = _h_bcast(bt, d, 1)
    halos = [_halos(bt, p, d) for p in parts]

    def edge_masks(F):
        shape = (bt.n_blocks,) + (1,) * (F.dim() - 1)
        return (bt.edge_valid[d][0].reshape(shape),
                bt.edge_valid[d][1].reshape(shape))

    if _PADDED_FACES:
        padded = [torch.cat([hl, p, hr], dim=ax)
                  for p, (_, _, hl, hr) in zip(parts, halos)]
        Fall = fn(tuple(q.narrow(ax, 0, bs + 1) for q in padded),
                  tuple(q.narrow(ax, 1, bs + 1) for q in padded), h, h)
        mask_l, mask_r = edge_masks(Fall)
        inner = mask_l.new_ones(mask_l.shape[:ax] + (bs - 1,)
                                + mask_l.shape[ax + 1:])
        Fall = Fall * torch.cat([mask_l, inner, mask_r], dim=ax)
    else:
        # interior faces (i-1, i), i = 1..bs-1
        F_int = fn(tuple(p.narrow(ax, 0, bs - 1) for p in parts),
                   tuple(p.narrow(ax, 1, bs - 1) for p in parts), h, h)
        mask_l, mask_r = edge_masks(F_int)
        lo_face = fn(tuple(x[2] for x in halos), tuple(x[0] for x in halos),
                     h, h) * mask_l
        hi_face = fn(tuple(x[1] for x in halos), tuple(x[3] for x in halos),
                     h, h) * mask_r
        Fall = torch.cat([lo_face, F_int, hi_face], dim=ax)

    sgn = bt.signs(signed_mask)
    out = (Fall.narrow(ax, 1, bs) + sgn * Fall.narrow(ax, 0, bs)) / h

    face_cat = scheme.cat_fn(fn, [p.shape[-1] for p in parts])
    with device_span("march.two_to_one", out.device):
        cols = scheme.interface_corrections(bt, d, face_cat, signed_mask,
                                     _grid_edge_fetch(bt, parts, d))
        for s in (0, 1):
            if cols[s] is not None:
                blocks, vals = cols[s]
                _edge(bt, out, d, s).index_add_(0, blocks, vals)
    if bt.sp_owner[d].shape[0]:
        out = out + _generic_sparse(bt, d, parts, fn, n_out,
                                    signed_mask).reshape(out.shape)
    return out


def cell_gradient_grid(bt: BlockTables, u3, d: int):
    """Green-Gauss cell gradient of ``u3`` [B, bs.., K] along dim ``d``,
    the dense counterpart of `ibx_torch.ops.operators.cell_gradient`."""
    K = u3.shape[-1]

    def face_fn(Wo, Wn, ho, hn):
        return (Wo * hn + Wn * ho) / (ho + hn)

    return face_accumulate(bt, d, u3, face_fn, K, [1.0] * K)


# ---------------------------------------------------------------------------
# Euler RHS on the cell-major grid
# ---------------------------------------------------------------------------


def euler_rhs_grid(bt: BlockTables, fluid: Fluid, P3, *,
                   high_order: bool = True, with_dt: bool = False,
                   cfl: float = 0.8, frozen=None, fix3=None,
                   viscous: bool = False, mu_t3=None, cut3=None,
                   kernels: bool = True, fold: bool = False):
    """Euler dQ/dt on the block-grid state ``[B, bs, ..., bs, C]`` (MUSCL
    + JST blend + HLL). Returns R3; with ``with_dt`` also dt3 [B, bs, ...,
    bs] and the frozen (du3_list, nu3) grids, which ``frozen`` takes back
    to skip pass A (frozen-limiter RK stages).

    ``fix3`` (optional [B, bs.., 1] in [0, 1]): the local robustness blend
    of `scheme.face_b` (first order + Einfeldt wave speeds where > 0, the
    reference numerics where 0 or None).

    ``kernels`` (the counterpart of ``IBX_PALLAS_RHS``): every
    `rhs_cs.pallas_eligible` call goes to a kernel route,
    `rhs_cs.euler_rhs_grid_pallas` at nd = 3 and `rhs_cs.euler_rhs_grid_2d`
    at nd = 2 (on the CPU the kernels' plain versions run); False forces
    the torch-op body, which also serves the ineligible calls
    (``frozen``, ``fix3``, a sparse leftover the 2D route's partial rows
    do not carry). ``fold`` reaches the 3D route's plain-RHS call (the 2D
    route always folds its 2:1 corrections into the kernels). While
    `monitor.tracing()` is on, each call counts its route:
    ``rhs.route.kernels_2d``, ``rhs.route.kernels_3d`` or
    ``rhs.route.ops``.

    ``viscous=True`` subtracts Newtonian viscous + heat-conduction face
    fluxes (reference ``src/cfd.jl:664-736``) using the pass-A cell
    gradients with the orthogonality-corrected normal component, the dense
    counterpart of `ibx_torch.solve.euler.euler_rhs(viscous=True)`;
    ``mu_t3`` ([B, bs.., 1]) is an optional eddy-viscosity field. Both take
    the torch-op body.

    ``cut3`` (the flagged cut-cell wall, `geometry.cutcell.cut_metrics_2d`
    as tensors: per-dim ``owner`` / ``neighbor`` / ``wr`` / ``wl`` cut-face
    tables, ``wall_cells``, ``wall_coef``, ``xw_rel``, ``inv_alpha3`` [B,
    bs.., 1] and ``alpha3`` [B, bs..]) removes the solid-covered fraction
    of each cut face's flux, adds the wall-pressure force on the true wall
    vector, divides by the fluid fraction and scales dt by it (the
    cut-cell CFL); it takes the torch-op body.
    """
    if kernels and rhs_cs.pallas_eligible(bt, viscous=viscous,
                                          frozen=frozen, fix3=fix3,
                                          mu_t3=mu_t3, cut3=cut3):
        count(f"rhs.route.kernels_{bt.nd}d")
        if bt.nd == 2:
            return rhs_cs.euler_rhs_grid_2d(bt, fluid, P3,
                                            high_order=high_order,
                                            with_dt=with_dt, cfl=cfl)
        return rhs_cs.euler_rhs_grid_pallas(bt, fluid, P3,
                                            high_order=high_order,
                                            with_dt=with_dt, cfl=cfl,
                                            fold=fold)
    count("rhs.route.ops")
    with device_span("march.rhs", P3.device):
        return _euler_rhs_ops(bt, fluid, P3, high_order, with_dt, cfl,
                              frozen, fix3, viscous, mu_t3, cut3)


def _euler_rhs_ops(bt: BlockTables, fluid: Fluid, P3, high_order: bool,
                   with_dt: bool, cfl: float, frozen, fix3, viscous: bool,
                   mu_t3, cut3):
    """The torch-op body of `euler_rhs_grid`."""
    nd = bt.nd
    ncomp = P3.shape[-1]
    grid_shape = P3.shape[:-1]
    S3 = P3[..., 2:2 + nd].abs() + speed_of_sound(fluid, P3[..., 1])[..., None]

    # the wave-speed channel (sf) is only needed when computing dt
    nA = ncomp + (3 if with_dt else 2)  # [Pf(ncomp), fd, |fd| (, sf)]
    signedA = [1.0] * (ncomp + 1) + [0.0] * (2 if with_dt else 1)
    du_grids = []
    nu3 = torch.full(grid_shape + (1,), 1e-7, dtype=P3.dtype,
                     device=P3.device)
    dt_bound = torch.zeros(grid_shape, dtype=P3.dtype, device=P3.device) \
        if with_dt else None
    if frozen is not None:
        du_grids, nu3 = list(frozen[0]), frozen[1]
    for d in range(nd if frozen is None else 0):
        partsA = (P3, S3[..., d:d + 1]) if with_dt else (P3,)
        outA = face_accumulate(bt, d, partsA, scheme.face_a(with_dt), nA,
                               signedA)
        du_grids.append(outA[..., :ncomp])
        G3 = outA[..., ncomp]
        U3 = outA[..., ncomp + 1]
        nu3 = torch.maximum(
            nu3, ((1e-7 + abs_select(G3)) / (1e-7 + U3))[..., None])
        if with_dt:
            dt_bound = dt_bound + outA[..., ncomp + 2]

    has_fix = fix3 is not None
    has_mut = viscous and mu_t3 is not None
    R3 = torch.zeros_like(P3)
    signedB = [1.0] * ncomp
    for d in range(nd):
        Vparts = (P3, du_grids[d], nu3) + ((fix3,) if has_fix else ())
        if viscous:
            Vparts += tuple(du_grids[i] for i in range(nd) if i != d)
            if has_mut:
                Vparts += (mu_t3,)
        fB = scheme.face_b(fluid, high_order, d, has_fix, viscous,
                           has_mut)
        R3 = R3 + face_accumulate(bt, d, Vparts, fB, ncomp, signedB)
        if cut3 is not None and cut3["owner"][d].shape[0]:
            # remove the solid-covered fraction (1 - aperture) of the cut
            # faces' dense fluxes: the face function returns -F, so the
            # signed sparse accumulation (+w on the owner, -w on the
            # neighbour) cancels that fraction of the accumulated -gg(F);
            # one-sided cut faces on the box carry the weight on one side
            rem = _sparse_accum(bt, d, Vparts, fB, ncomp, signedB,
                                cut3["owner"][d], cut3["neighbor"][d],
                                cut3["wr"][d], cut3["wl"][d])
            R3 = R3 - rem.reshape(grid_shape + (ncomp,))
    if cut3 is not None:
        R3 = _cut_wall(bt, P3, du_grids, R3, cut3)
    if with_dt:
        dt3 = cfl / dt_bound
        if cut3 is not None:
            dt3 = dt3 * cut3["alpha3"]     # cut-cell CFL: V -> alpha V
        return R3, dt3, (du_grids, nu3)
    return R3


def _cut_wall(bt: BlockTables, P3, du_grids, R3, cut3):
    """The cut cells' wall-pressure momentum flux on the true wall vector
    (p_w from the cell pressure plus the pass-A gradient to the wall
    point), then R / alpha."""
    wc = cut3["wall_cells"]
    nd, ncomp = bt.nd, P3.shape[-1]
    if wc.shape[0]:
        # column gathers: the cells' pressure and its gradients
        p_w = P3[..., 0].reshape(bt.n_cells).index_select(0, wc)
        for d in range(nd):
            dp = du_grids[d][..., 0].reshape(bt.n_cells).index_select(0, wc)
            p_w = p_w + dp * cut3["xw_rel"][:, d]
        Rmom = -p_w[:, None] * cut3["wall_coef"]        # [M, nd]
        zeros = Rmom.new_zeros
        Rrow = torch.cat([zeros((wc.shape[0], 2)), Rmom,
                          zeros((wc.shape[0], ncomp - 2 - nd))], dim=1)
        # the wall cells are unique: the add is exact
        R3 = (R3.reshape(bt.n_cells, ncomp).index_add(0, wc, Rrow)
              .reshape(R3.shape))
    return R3 * cut3["inv_alpha3"]


def euler_rhs_block(bt: BlockTables, fluid: Fluid, P, *,
                    high_order: bool = True, with_dt: bool = False,
                    cfl: float = 0.8, frozen=None, fix=None,
                    kernels: bool = True):
    """Flat-state wrapper of `euler_rhs_grid` ([N, C] in / [N, C] out);
    ``frozen`` uses the flat (du_list, nu [N]) convention, ``fix`` is the
    flat [N] robustness blend and ``kernels`` is `euler_rhs_grid`'s (False
    forces the torch-op body, through which `torch.func.jvp` can pass)."""
    if frozen is not None:
        du_flat, nu = frozen
        frozen = ([to_blocks(bt, du) for du in du_flat],
                  to_blocks(bt, nu[:, None]))
    fix3 = None if fix is None else to_blocks(bt, fix[:, None])
    out = euler_rhs_grid(bt, fluid, to_blocks(bt, P), high_order=high_order,
                         with_dt=with_dt, cfl=cfl, frozen=frozen, fix3=fix3,
                         kernels=kernels)
    if not with_dt:
        return to_flat(bt, out)
    R3, dt3, (du_grids, nu3) = out
    return (to_flat(bt, R3), dt3.reshape(bt.n_cells),
            ([to_flat(bt, du3) for du3 in du_grids],
             nu3.reshape(bt.n_cells)))


# ---------------------------------------------------------------------------
# grid marches
# ---------------------------------------------------------------------------

def smooth_residual_grid(bt: BlockTables, R3, *, eps: float = 0.6,
                         n_sweeps: int = 2, active3=None):
    """Implicit residual smoothing (Jameson): Jacobi sweeps toward
    (I - eps nabla^2) Rs = R, raising the stable CFL by ~sqrt(1 + 4 eps).

    The steady state is untouched (R = 0 is a fixed point of the smoother),
    so the smoothing stencil may be approximate: block sides without a
    same-size dense neighbor (2:1 interfaces) mirror the own edge plane.
    ``active3`` masks cells whose residuals are meaningless (frozen
    solid-interior cells) out of the smoothing stencil; they keep their
    input residual."""
    nd, bs = bt.nd, bt.block_size
    if active3 is not None:
        R_in = R3
        R3 = R3 * active3[..., None]

    def bmask(v):
        return v.reshape((bt.n_blocks,) + (1,) * (R3.dim() - 1))

    def neighbor_sum(Rs):
        acc = None
        for d in range(nd):
            ax = _axis(bt, d)
            first = Rs.narrow(ax, 0, 1)
            last = Rs.narrow(ax, bs - 1, 1)
            halo_l = torch.where(bmask(bt.edge_valid[d][0]) > 0,
                                 last.index_select(0, bt.nbr[d][0]), first)
            halo_l = torch.where(bmask(bt.bnd[d][0]) > 0, first, halo_l)
            halo_r = torch.where(bmask(bt.edge_valid[d][1]) > 0,
                                 first.index_select(0, bt.nbr[d][1]), last)
            halo_r = torch.where(bmask(bt.bnd[d][1]) > 0, last, halo_r)
            up = torch.cat([halo_l, Rs, halo_r], dim=ax)
            s = up.narrow(ax, 0, bs) + up.narrow(ax, 2, bs)
            acc = s if acc is None else acc + s
        return acc

    Rs = R3
    denom = 1.0 + eps * 2 * nd
    for _ in range(n_sweeps):
        Rs = (R3 + eps * neighbor_sum(Rs)) / denom
    if active3 is not None:
        Rs = torch.where(active3[..., None] > 0, Rs, R_in)
    return Rs


def rk2_step_grid(bt: BlockTables, fluid: Fluid, P3, apply_bcs3: Callable,
                  *, cfl: float = 0.8, high_order: bool = True,
                  active3=None, freeze_gradients: bool = False,
                  irs_eps: float = 0.0, fix3=None, cut3=None,
                  fold: bool = False):
    """Local-dt TVD-RK2 pseudo step on the cell-major state (reference
    semantics ``src/ImmersedBoundary.jl:873-1157``); ``apply_bcs3`` maps
    grid -> grid. ``active3`` (f32[B, bs, ..., bs], 0/1) freezes cells;
    ``freeze_gradients`` reuses the stage-1 gradients and sensor in stage 2
    (which then runs the torch-op body); ``fold`` as in `euler_rhs_grid`
    (it reaches stage 2 only, as in the JAX package). ``irs_eps > 0``
    smooths both residuals (`smooth_residual_grid`; raise ``cfl`` by
    ~sqrt(1 + 4 eps)); ``fix3`` as in `euler_rhs_grid`. Returns (P2,
    resnorm)."""
    R0, dt3, frozen = euler_rhs_grid(bt, fluid, P3, high_order=high_order,
                                     with_dt=True, cfl=cfl, fix3=fix3,
                                     cut3=cut3)
    if irs_eps > 0.0:
        R0 = smooth_residual_grid(bt, R0, eps=irs_eps, active3=active3)
    with device_span("march.update", P3.device):
        if active3 is not None:
            dt3 = dt3 * active3
        dt = dt3[..., None]
        Q0 = primitive2state(fluid, P3)
        P1 = state2primitive_guarded(fluid, Q0 + dt * R0)
    P1 = apply_bcs3(P1)
    R1 = euler_rhs_grid(bt, fluid, P1, high_order=high_order,
                        frozen=frozen if freeze_gradients else None,
                        fix3=fix3, cut3=cut3, fold=fold)
    if irs_eps > 0.0:
        R1 = smooth_residual_grid(bt, R1, eps=irs_eps, active3=active3)
    with device_span("march.update", P3.device):
        P2 = state2primitive_guarded(fluid, Q0 + dt * (R0 + R1) / 2)
    return apply_bcs3(P2), R0[..., 0].abs().max()


def euler_step_grid(bt: BlockTables, fluid: Fluid, P3, apply_bcs3: Callable,
                    *, cfl: float = 0.4, high_order: bool = True,
                    active3=None, fix3=None, cut3=None):
    """Single-stage explicit pseudo step with local time stepping (the
    reference's own march recipe, ``test/advection.jl:85-93``)."""
    R, dt3, _ = euler_rhs_grid(bt, fluid, P3, high_order=high_order,
                               with_dt=True, cfl=cfl, fix3=fix3, cut3=cut3)
    with device_span("march.update", P3.device):
        if active3 is not None:
            dt3 = dt3 * active3
        Q = primitive2state(fluid, P3) + dt3[..., None] * R
        P1 = state2primitive_guarded(fluid, Q)
    return apply_bcs3(P1), R[..., 0].abs().max()


def _flat_bcs(bt: BlockTables, apply_bcs: Callable) -> Callable:
    def apply_bcs3(P3):
        return to_blocks(bt, apply_bcs(to_flat(bt, P3)))
    return apply_bcs3


def _active3(bt: BlockTables, active):
    return None if active is None else to_blocks(bt, active[:, None])[..., 0]


def rk2_step_block(bt: BlockTables, fluid: Fluid, P, apply_bcs: Callable, *,
                   cfl: float = 0.8, high_order: bool = True, active=None,
                   freeze_gradients: bool = False, fold: bool = False):
    """Flat-state wrapper of `rk2_step_grid` (P [N, C], BCs on the flat
    state)."""
    P2, resnorm = rk2_step_grid(
        bt, fluid, to_blocks(bt, P), _flat_bcs(bt, apply_bcs),
        cfl=cfl, high_order=high_order, active3=_active3(bt, active),
        freeze_gradients=freeze_gradients, fold=fold)
    return to_flat(bt, P2), resnorm


def euler_step_block(bt: BlockTables, fluid: Fluid, P, apply_bcs: Callable,
                     *, cfl: float = 0.4, high_order: bool = True,
                     active=None):
    """Flat-state wrapper of `euler_step_grid`."""
    P1, resnorm = euler_step_grid(
        bt, fluid, to_blocks(bt, P), _flat_bcs(bt, apply_bcs),
        cfl=cfl, high_order=high_order, active3=_active3(bt, active))
    return to_flat(bt, P1), resnorm
