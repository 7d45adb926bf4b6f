"""Dense block-structured operators on the cell-major block grid
``[B, bs, bs, bs, C]`` (counterpart of `ibx/ops/block_ops.py` at nd = 3):
layout reshapes, the minmod limiter, the structured 2:1 interface
corrections, `face_accumulate` (its default concat formulation), the block
Euler RHS `euler_rhs_grid` with its kernel route, and the grid marches
`rk2_step_grid` / `euler_step_grid` with their flat wrappers.

Not ported yet (ROADMAP queue 1 item 4): the ``IBX_PADDED_FACES``
formulation, implicit residual smoothing, the ``fix3`` / ``viscous`` /
``mu_t3`` / ``cut3`` options, the generic sparse leftover and nd = 2."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..physics.fluid import (Fluid, primitive2state, speed_of_sound,
                             state2primitive_guarded)
from ..physics.flux import inviscid_fluxes_hll
from ..topology.blocks import BlockTables

_NOT_PORTED = ("not ported to ibx_torch yet (ROADMAP queue 1 item 4)")


def to_blocks(bt: BlockTables, u_flat):
    """[N, ...] flat cell order -> [B, bs, bs, bs, ...] block grid."""
    return u_flat.reshape(
        (bt.n_blocks,) + (bt.block_size,) * bt.nd + tuple(u_flat.shape[1:]))


def to_flat(bt: BlockTables, u3):
    """[B, bs, bs, bs, ...] -> [N, ...]."""
    return u3.reshape((bt.n_cells,) + tuple(u3.shape[1 + bt.nd:]))


def minmod(u1, u2):
    """Minmod limiter (reference ``src/ImmersedBoundary.jl:1099``)."""
    return torch.minimum(u1.abs(), u2.abs()) * (
        torch.sign(u1) + torch.sign(u2)) / 2


def _expand_coarse(col, off, bs: int):
    """Coarse edge plane col [V, bs, bs, C] (hi-major) -> the values seen
    by the fine-side plane cells: quadrant ``off = off_hi * 2 + off_lo``,
    upsampled 2x per perpendicular dim."""
    h = bs // 2
    outs = []
    for qh in (0, 1):
        for ql in (0, 1):
            quad = col[:, qh * h:qh * h + h, ql * h:ql * h + h]
            outs.append(quad.repeat_interleave(2, dim=1)
                        .repeat_interleave(2, dim=2))
    sel = off[:, None, None, None]
    out = outs[0]
    for k in (1, 2, 3):
        out = torch.where(sel == k, outs[k], out)
    return out


def _coarse_side_neighbors(planes):
    """Four fine-block edge planes (hi-major quadrant order, each
    [V, bs, bs, C]) -> the four per-coarse-cell sub-face value sets."""
    top = torch.cat([planes[0], planes[1]], dim=2)
    bot = torch.cat([planes[2], planes[3]], dim=2)
    p2 = torch.cat([top, bot], dim=1)                  # [V, 2bs, 2bs, C]
    return [p2[:, dy::2, dx::2] for dy in (0, 1) for dx in (0, 1)]


def interface_corrections(
    bt: BlockTables, d: int, face_fn: Callable, signed_mask: Sequence[float],
    fetch: Callable,
) -> List[Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Structured 2:1 interface contributions along dim ``d``
    (`ibx.ops.block_ops.interface_corrections` with ``edge_fetch``).

    ``fetch(s, blocks) -> [V, bs, bs, K]`` gives the channel-last side-s
    edge planes of the given blocks; ``face_fn(W_owner, W_neighbor,
    h_owner, h_neighbor) -> [..., n_out]`` evaluates faces with the owner
    on the minus side. Channels flagged in ``signed_mask`` accumulate
    Green-Gauss style (+ on a cell's plus side, - on its minus side).

    Returns, per side s, None or ``(blocks [V], vals [V, bs, bs, n_out])``:
    the interface blocks (fine-side rows first, then coarse-side rows; the
    two sets are disjoint) and their edge-plane corrections, already divided
    by the accumulating cell's spacing. The JAX package places these rows
    into a zero grid; the port adds them in place (`rhs_cs._cols_add_cs`),
    which adds the same values to the same slots."""
    bs, nd = bt.block_size, bt.nd
    n_fine = 2 ** (nd - 1)
    signed = torch.as_tensor(signed_mask, dtype=torch.float32,
                             device=bt.h.device)

    def hshape(blocks):
        return bt.h[blocks, d].reshape((blocks.shape[0],) + (1,) * nd)

    # Every interface face of both sides goes through ONE face_fn call: the
    # evaluation is elementwise, so each face gets the value a per-piece
    # call would give, and the glue launches a tenth of the ops.
    Wo, Wn, ho, hn, sides = [], [], [], [], []
    for s in (0, 1):
        fsb, csb = bt.fs_block[d][s], bt.cs_block[d][s]
        Vf, Vc = fsb.shape[0], csb.shape[0]
        if Vf + Vc == 0:
            continue
        blocks = torch.cat([fsb, csb])
        own = fetch(s, blocks)
        other = fetch(1 - s, torch.cat([bt.fs_coarse[d][s],
                                        bt.cs_fine[d][s].t().reshape(-1)]))
        h_own = hshape(blocks)
        # fine side: the facing quadrant of the coarse neighbor's plane;
        # coarse side: the four fine sub-face sets of each coarse cell
        theirs = [_expand_coarse(other[:Vf], bt.fs_off[d][s], bs)]
        theirs += _coarse_side_neighbors(
            other[Vf:].unflatten(0, (n_fine, Vc)).unbind(0))
        mine = torch.cat([own[:Vf]] + [own[Vf:]] * n_fine)
        theirs = torch.cat(theirs)
        hm = torch.cat([h_own[:Vf]] + [h_own[Vf:]] * n_fine)
        ht = torch.cat([2.0 * h_own[:Vf]] + [h_own[Vf:] / 2.0] * n_fine)
        # the owner of a face is its minus-side cell
        pair = (mine, theirs, hm, ht) if s == 1 else (theirs, mine, ht, hm)
        for acc, x in zip((Wo, Wn, ho, hn), pair):
            acc.append(x)
        sides.append((s, blocks, Vf, Vc, h_own))

    cols = [None, None]
    if not sides:
        return cols
    vals = face_fn(torch.cat(Wo), torch.cat(Wn), torch.cat(ho),
                   torch.cat(hn))
    off = 0
    for s, blocks, Vf, Vc, h_own in sides:
        sgn = torch.where(signed > 0, 1.0 if s == 1 else -1.0, 1.0)
        fine = vals[off:off + Vf]
        sub = vals[off + Vf:off + Vf + n_fine * Vc].unflatten(
            0, (n_fine, Vc))
        off += Vf + n_fine * Vc
        tot = sub[0]
        for q in range(1, n_fine):
            tot = tot + sub[q]
        cols[s] = (blocks, torch.cat([fine * sgn / h_own[:Vf],
                                      tot * (sgn / n_fine) / h_own[Vf:]]))
    return cols


# ---------------------------------------------------------------------------
# face accumulation on the cell-major grid
# ---------------------------------------------------------------------------

def _axis(bt: BlockTables, d: int) -> int:
    """Array axis of spatial dim d in the [B, z, y, x, C] layout."""
    return 1 + (bt.nd - 1 - d)


def _h_bcast(bt: BlockTables, d: int, n_trailing: int = 1):
    return bt.h[:, d].reshape((bt.n_blocks,) + (1,) * (bt.nd + n_trailing))


def _edge(bt: BlockTables, u3, d: int, s: int):
    """Edge plane of every block: [B, lat_hi, lat_lo, C] (a view)."""
    return u3.select(_axis(bt, d), bt.block_size - 1 if s else 0)


def _grid_edge_fetch(bt: BlockTables, parts, d: int):
    """``fetch(s, blocks)`` for `interface_corrections` over cell-major
    parts: the channel concatenation of the parts' side-s edge planes of
    the given blocks."""
    def fetch(s, blocks):
        es = [_edge(bt, p, d, s).index_select(0, blocks) for p in parts]
        return es[0] if len(es) == 1 else torch.cat(es, dim=-1)

    return fetch


def cat_fn(face_fn: Callable, widths: Sequence[int]) -> Callable:
    """A face function over channel-concatenated operands from one over
    tuples of channel parts of the given widths."""
    offs = np.cumsum([0] + list(widths))

    def split(W):
        return tuple(W[..., offs[i]:offs[i + 1]] for i in range(len(widths)))

    def fn(Wo, Wn, ho, hn):
        return face_fn(split(Wo), split(Wn), ho, hn)

    return fn


def face_accumulate(bt: BlockTables, d: int, W3, face_fn: Callable,
                    n_out: int, signed_mask: Sequence[float]):
    """Green-Gauss-style accumulation of per-face quantities into cells
    along dim ``d`` (the JAX package's default concat formulation).

    ``face_fn(W_owner, W_neighbor, h_owner, h_neighbor) -> [..., n_out]``;
    ``W3`` is one [B, bs, bs, bs, K] grid or a tuple of channel-part grids
    (``face_fn`` then receives tuples). Channels flagged in ``signed_mask``
    accumulate (right - left)/h, the others (right + left)/h. Each face is
    evaluated once: interior faces on slice windows, block-edge faces on
    the halo planes (dense neighbor's edge, own edge mirrored on one-sided
    sides, masked to zero on 2:1 sides), and the 2:1 rows of
    `interface_corrections` are added in place at the edge slots."""
    tup = isinstance(W3, (tuple, list))
    parts = tuple(W3) if tup else (W3,)
    fn = face_fn if tup else (
        lambda Wo, Wn, ho, hn: face_fn(Wo[0], Wn[0], ho, hn))
    ax = _axis(bt, d)
    bs = bt.block_size
    h = _h_bcast(bt, d, 1)

    # interior faces (i-1, i), i = 1..bs-1
    lo_sl = tuple(p.narrow(ax, 0, bs - 1) for p in parts)
    hi_sl = tuple(p.narrow(ax, 1, bs - 1) for p in parts)
    F_int = fn(lo_sl, hi_sl, h, h)

    def bmask(v, like):
        return v.reshape((bt.n_blocks,) + (1,) * (like.dim() - 1))

    firsts, lasts, halos_l, halos_r = [], [], [], []
    for p in parts:
        first = p.narrow(ax, 0, 1)
        last = p.narrow(ax, bs - 1, 1)
        halos_l.append(torch.where(bmask(bt.bnd[d][0], p) > 0, first,
                                   last.index_select(0, bt.nbr[d][0])))
        halos_r.append(torch.where(bmask(bt.bnd[d][1], p) > 0, last,
                                   first.index_select(0, bt.nbr[d][1])))
        firsts.append(first)
        lasts.append(last)
    n_trail = F_int.dim() - 1 - bt.nd
    mask_l = bt.edge_valid[d][0].reshape(
        (bt.n_blocks,) + (1,) * (bt.nd + n_trail))
    mask_r = bt.edge_valid[d][1].reshape(mask_l.shape)
    lo_face = fn(tuple(halos_l), tuple(firsts), h, h) * mask_l
    hi_face = fn(tuple(lasts), tuple(halos_r), h, h) * mask_r

    Fall = torch.cat([lo_face, F_int, hi_face], dim=ax)
    sgn = torch.where(torch.as_tensor(signed_mask, dtype=F_int.dtype,
                                      device=F_int.device) > 0, -1.0, 1.0)
    out = (Fall.narrow(ax, 1, bs) + sgn * Fall.narrow(ax, 0, bs)) / h

    face_cat = cat_fn(fn, [p.shape[-1] for p in parts])
    cols = interface_corrections(bt, d, face_cat, signed_mask,
                                 _grid_edge_fetch(bt, parts, d))
    for s in (0, 1):
        if cols[s] is not None:
            blocks, vals = cols[s]
            _edge(bt, out, d, s).index_add_(0, blocks, vals)
    return out


# ---------------------------------------------------------------------------
# Euler RHS on the cell-major grid
# ---------------------------------------------------------------------------

def face_a(with_dt: bool) -> Callable:
    """Pass A's face function over parts (P [, S_d]): the face value of P,
    the signed and absolute pressure differences (sensor) and, with
    ``with_dt``, the face wave speed."""
    def fn(Wo, Wn, ho, hn):
        Po, Pn = Wo[0], Wn[0]
        Pf = (Po * hn + Pn * ho) / (ho + hn)
        fd = Pn[..., 0:1] - Po[..., 0:1]
        out = [Pf, fd, fd.abs()]
        if with_dt:
            So, Sn = Wo[1], Wn[1]
            out.append((So * hn + Sn * ho) / (ho + hn))
        return torch.cat(out, dim=-1)

    return fn


def face_b(fluid: Fluid, high_order: bool, d: int) -> Callable:
    """Pass B's face function over parts (P, du_d, nu): -HLL flux of the
    MUSCL-reconstructed face with the JST blend."""
    def fn(Wo, Wn, ho, hn):
        Po, Pn = Wo[0], Wn[0]
        duo, dun = Wo[1], Wn[1]
        Do, Dn = Wo[2], Wn[2]
        down, dneigh = ho / 2, hn / 2
        grad_f = (Pn - Po) / (down + dneigh)
        slope_o = (2 * duo - grad_f) * down
        slope_n = (2 * dun - grad_f) * dneigh
        lim = minmod(slope_n, slope_o)
        PL = Po + lim
        PR = Pn - lim
        D = torch.maximum(Do, Dn).clamp(min=1e-7)
        uf = (Po * dneigh + Pn * down) / (down + dneigh)
        if high_order:
            uf = uf + (duo * down - dun * dneigh) / 8
        PL = PL * D + (1.0 - D) * uf
        PR = PR * D + (1.0 - D) * uf
        return -inviscid_fluxes_hll(fluid, PL, PR, d)

    return fn


def euler_rhs_grid(bt: BlockTables, fluid: Fluid, P3, *,
                   high_order: bool = True, with_dt: bool = False,
                   cfl: float = 0.8, frozen=None, fix3=None,
                   viscous: bool = False, mu_t3=None, cut3=None,
                   kernels: bool = True, fold: bool = False):
    """Euler dQ/dt on the block-grid state ``[B, bs, bs, bs, C]`` (MUSCL +
    JST blend + HLL). Returns R3; with ``with_dt`` also dt3 [B, bs, bs, bs]
    and the frozen (du3_list, nu3) grids, which ``frozen`` takes back to
    skip pass A (frozen-limiter RK stages).

    ``kernels`` (the counterpart of ``IBX_PALLAS_RHS``): every
    `rhs_cs.pallas_eligible` call goes to the kernel route
    `rhs_cs.euler_rhs_grid_pallas` (on the CPU the kernels' plain versions
    run); False forces the torch-op body, which also serves the ineligible
    calls (``frozen``). ``fold`` reaches the kernel route's plain-RHS call.
    ``fix3``, ``viscous``, ``mu_t3`` and ``cut3`` raise NotImplementedError.
    """
    if fix3 is not None or viscous or mu_t3 is not None or cut3 is not None:
        raise NotImplementedError(
            "euler_rhs_grid: fix3, viscous, mu_t3 and cut3 are " + _NOT_PORTED)
    from .rhs_cs import euler_rhs_grid_pallas, pallas_eligible
    if kernels and pallas_eligible(bt, frozen=frozen):
        return euler_rhs_grid_pallas(bt, fluid, P3, high_order=high_order,
                                     with_dt=with_dt, cfl=cfl, fold=fold)
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
        outA = face_accumulate(bt, d, partsA, face_a(with_dt), nA, signedA)
        du_grids.append(outA[..., :ncomp])
        G3 = outA[..., ncomp]
        U3 = outA[..., ncomp + 1]
        nu3 = torch.maximum(nu3, ((1e-7 + G3.abs()) / (1e-7 + U3))[..., None])
        if with_dt:
            dt_bound = dt_bound + outA[..., ncomp + 2]

    R3 = torch.zeros_like(P3)
    for d in range(nd):
        R3 = R3 + face_accumulate(bt, d, (P3, du_grids[d], nu3),
                                  face_b(fluid, high_order, d), ncomp,
                                  [1.0] * ncomp)
    if with_dt:
        return R3, cfl / dt_bound, (du_grids, nu3)
    return R3


def euler_rhs_block(bt: BlockTables, fluid: Fluid, P, *,
                    high_order: bool = True, with_dt: bool = False,
                    cfl: float = 0.8, frozen=None):
    """Flat-state wrapper of `euler_rhs_grid` ([N, C] in / [N, C] out);
    ``frozen`` uses the flat (du_list, nu [N]) convention."""
    if frozen is not None:
        du_flat, nu = frozen
        frozen = ([to_blocks(bt, du) for du in du_flat],
                  to_blocks(bt, nu[:, None]))
    out = euler_rhs_grid(bt, fluid, to_blocks(bt, P), high_order=high_order,
                         with_dt=with_dt, cfl=cfl, frozen=frozen)
    if not with_dt:
        return to_flat(bt, out)
    R3, dt3, (du_grids, nu3) = out
    return (to_flat(bt, R3), dt3.reshape(bt.n_cells),
            ([to_flat(bt, du3) for du3 in du_grids],
             nu3.reshape(bt.n_cells)))


# ---------------------------------------------------------------------------
# grid marches
# ---------------------------------------------------------------------------

def rk2_step_grid(bt: BlockTables, fluid: Fluid, P3, apply_bcs3: Callable,
                  *, cfl: float = 0.8, high_order: bool = True,
                  active3=None, freeze_gradients: bool = False,
                  irs_eps: float = 0.0, fix3=None, cut3=None,
                  fold: bool = False):
    """Local-dt TVD-RK2 pseudo step on the cell-major state (reference
    semantics ``src/ImmersedBoundary.jl:873-1157``); ``apply_bcs3`` maps
    grid -> grid. ``active3`` (f32[B, bs, bs, bs], 0/1) freezes cells;
    ``freeze_gradients`` reuses the stage-1 gradients and sensor in stage 2
    (which then runs the torch-op body); ``fold`` as in `euler_rhs_grid`
    (it reaches stage 2 only, as in the JAX package). ``irs_eps > 0``
    raises NotImplementedError. Returns (P2, resnorm)."""
    if irs_eps > 0.0:
        raise NotImplementedError("rk2_step_grid: implicit residual "
                                  "smoothing (irs_eps) is " + _NOT_PORTED)
    R0, dt3, frozen = euler_rhs_grid(bt, fluid, P3, high_order=high_order,
                                     with_dt=True, cfl=cfl, fix3=fix3,
                                     cut3=cut3)
    if active3 is not None:
        dt3 = dt3 * active3
    dt = dt3[..., None]
    Q0 = primitive2state(fluid, P3)
    P1 = apply_bcs3(state2primitive_guarded(fluid, Q0 + dt * R0))
    R1 = euler_rhs_grid(bt, fluid, P1, high_order=high_order,
                        frozen=frozen if freeze_gradients else None,
                        fix3=fix3, cut3=cut3, fold=fold)
    P2 = apply_bcs3(state2primitive_guarded(fluid, Q0 + dt * (R0 + R1) / 2))
    return P2, R0[..., 0].abs().max()


def euler_step_grid(bt: BlockTables, fluid: Fluid, P3, apply_bcs3: Callable,
                    *, cfl: float = 0.4, high_order: bool = True,
                    active3=None, fix3=None, cut3=None):
    """Single-stage explicit pseudo step with local time stepping (the
    reference's own march recipe, ``test/advection.jl:85-93``)."""
    R, dt3, _ = euler_rhs_grid(bt, fluid, P3, high_order=high_order,
                               with_dt=True, cfl=cfl, fix3=fix3, cut3=cut3)
    if active3 is not None:
        dt3 = dt3 * active3
    Q = primitive2state(fluid, P3) + dt3[..., None] * R
    return apply_bcs3(state2primitive_guarded(fluid, Q)), R[..., 0].abs().max()


def rk2_step_block(bt: BlockTables, fluid: Fluid, P, apply_bcs: Callable, *,
                   cfl: float = 0.8, high_order: bool = True, active=None,
                   freeze_gradients: bool = False, fold: bool = False):
    """Flat-state wrapper of `rk2_step_grid` (P [N, C], BCs on the flat
    state)."""
    active3 = None if active is None else to_blocks(bt, active[:, None])[
        ..., 0]
    P2, resnorm = rk2_step_grid(
        bt, fluid, to_blocks(bt, P),
        lambda P3: to_blocks(bt, apply_bcs(to_flat(bt, P3))),
        cfl=cfl, high_order=high_order, active3=active3,
        freeze_gradients=freeze_gradients, fold=fold)
    return to_flat(bt, P2), resnorm
