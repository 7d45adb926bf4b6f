"""The scheme's face arithmetic in torch ops: the face functions of RHS
passes A (`face_a`) and B (`face_b`), `cat_fn` over channel-concatenated
operands, and the structured 2:1 interface faces
(`interface_corrections`), shared by the torch-op body of
`block_ops.euler_rhs_grid`, the 3D kernel route's glue (`rhs_cs`) and the
kernels' plain versions (`kernels`). It is the torch counterpart of
``csrc/faces_2d.cuh``, which the 2D kernels share: an interface face is
evaluated by the same functions as a dense face, so that it rounds like
one. It imports no other module of `ops` but `operators`."""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..physics.fluid import Fluid
from ..physics.flux import inviscid_fluxes_hll, viscous_fluxes
from .operators import abs_select, minmod

if TYPE_CHECKING:
    from ..topology.blocks import BlockTables


def _expand_half(col, off, bs: int):
    """col [V, bs, C], off [V] in {0,1} -> entry j = col[off*bs/2 + j//2]."""
    low = col[:, : bs // 2].repeat_interleave(2, dim=1)
    high = col[:, bs // 2:].repeat_interleave(2, dim=1)
    return torch.where((off == 1)[:, None, None], high, low)


def _expand_coarse(col, off, bs: int, nd: int):
    """Coarse edge plane -> the values seen by the fine-side plane cells.

    2D: col [V, bs, C], off in {0, 1} (which half). 3D: col [V, bs, bs, C]
    (hi-major), quadrant ``off = off_hi * 2 + off_lo``, upsampled 2x per
    perpendicular dim."""
    if nd == 2:
        return _expand_half(col, off, bs)
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


def _coarse_side_neighbors(planes, nd: int):
    """Fine-block edge planes -> the 2^(nd-1) per-coarse-cell sub-face
    value sets. 2D: planes = [f_low, f_high], each [V, bs, C]. 3D: four
    planes in hi-major quadrant order, each [V, bs, bs, C]."""
    if nd == 2:
        fine = torch.cat(list(planes), dim=1)            # [V, 2bs, C]
        return [fine[:, 0::2], fine[:, 1::2]]
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

    ``fetch(s, blocks) -> [V, lat.., K]`` gives the channel-last side-s
    edge planes of the given blocks; ``face_fn(W_owner, W_neighbor,
    h_owner, h_neighbor) -> [..., n_out]`` evaluates faces with the owner
    on the minus side. Channels flagged in ``signed_mask`` accumulate
    Green-Gauss style (+ on a cell's plus side, - on its minus side).

    Returns, per side s, None or ``(blocks [V], vals [V, lat.., n_out])``:
    the interface blocks (fine-side rows first, then coarse-side rows; the
    two sets are disjoint) and their edge-plane corrections, already divided
    by the accumulating cell's spacing. The JAX package places these rows
    into a zero grid; the port adds them in place (`rhs_cs._cols_add_cs`),
    which adds the same values to the same slots."""
    bs, nd = bt.block_size, bt.nd
    n_fine = 2 ** (nd - 1)

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
        # coarse side: the 2^(nd-1) fine sub-face sets of each coarse cell
        theirs = [_expand_coarse(other[:Vf], bt.fs_off[d][s], bs, nd)]
        theirs += _coarse_side_neighbors(
            other[Vf:].unflatten(0, (n_fine, Vc)).unbind(0), nd)
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
        # the owner's side flips the signed channels
        sgn = 1.0 if s == 1 else bt.signs(signed_mask)
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


def cat_fn(face_fn: Callable, widths: Sequence[int]) -> Callable:
    """A face function over channel-concatenated operands from one over
    tuples of channel parts of the given widths."""
    offs = np.cumsum([0] + list(widths))

    def split(W):
        return tuple(W[..., offs[i]:offs[i + 1]] for i in range(len(widths)))

    def fn(Wo, Wn, ho, hn):
        return face_fn(split(Wo), split(Wn), ho, hn)

    return fn


def face_a(with_dt: bool) -> Callable:
    """Pass A's face function over parts (P [, S_d]): the face value of P,
    the signed and absolute pressure differences (sensor) and, with
    ``with_dt``, the face wave speed."""
    def fn(Wo, Wn, ho, hn):
        Po, Pn = Wo[0], Wn[0]
        Pf = (Po * hn + Pn * ho) / (ho + hn)
        fd = Pn[..., 0:1] - Po[..., 0:1]
        out = [Pf, fd, abs_select(fd)]
        if with_dt:
            So, Sn = Wo[1], Wn[1]
            out.append((So * hn + Sn * ho) / (ho + hn))
        return torch.cat(out, dim=-1)

    return fn


def face_b(fluid: Fluid, high_order: bool, d: int,
           has_fix: bool = False, viscous: bool = False,
           has_mut: bool = False) -> Callable:
    """Pass B's face function over parts (P, du_d, nu [, fix] [, du_i for
    i != d [, mu_t]]): -HLL flux of the MUSCL-reconstructed face with the
    JST blend. With ``has_fix`` a face takes the larger ``fix`` of its two
    cells: it scales the limited slopes toward first order, forces the
    blend to limited upwinding and widens the HLL wave speeds to the
    Einfeldt bounds. With ``viscous`` the Newtonian viscous and
    heat-conduction flux is subtracted: P, the lateral gradients and
    ``mu_t`` are interpolated to the face, the normal gradient is the
    two-point difference (the orthogonality-corrected form,
    ``src/ImmersedBoundary.jl:1051-1069``)."""
    def fn(Wo, Wn, ho, hn):
        Po, Pn = Wo[0], Wn[0]
        duo, dun = Wo[1], Wn[1]
        Do, Dn = Wo[2], Wn[2]
        k = 3
        fo = None
        if has_fix:
            fo = torch.maximum(Wo[k], Wn[k])
            k += 1
        down, dneigh = ho / 2, hn / 2
        grad_f = (Pn - Po) / (down + dneigh)
        slope_o = (2 * duo - grad_f) * down
        slope_n = (2 * dun - grad_f) * dneigh
        lim = minmod(slope_n, slope_o)
        if has_fix:
            lim = lim * (1.0 - fo)
        PL = Po + lim
        PR = Pn - lim
        D = torch.maximum(Do, Dn).clamp(min=1e-7)
        if has_fix:
            D = torch.maximum(D, fo)
        uf = (Po * dneigh + Pn * down) / (down + dneigh)
        if high_order:
            uf = uf + (duo * down - dun * dneigh) / 8
        PL = PL * D + (1.0 - D) * uf
        PR = PR * D + (1.0 - D) * uf
        F = inviscid_fluxes_hll(fluid, PL, PR, d, fix=fo)
        if viscous:
            def at_f(a_o, a_n):
                return (a_o * dneigh + a_n * down) / (down + dneigh)

            Pf = at_f(Po, Pn)
            gf = []
            kk = k
            for i in range(Po.shape[-1] - 2):
                if i == d:
                    gf.append(grad_f)
                else:
                    gf.append(at_f(Wo[kk], Wn[kk]))
                    kk += 1
            mu_t_f = at_f(Wo[kk], Wn[kk])[..., 0] if has_mut else 0.0
            F = F - viscous_fluxes(fluid, Pf, gf, d, mu_t=mu_t_f)
        return -F      # accumulate R += -divergence(F) directly

    return fn
