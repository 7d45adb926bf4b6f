"""Block-grid helpers the channel-split glue needs (subset of
`ibx/ops/block_ops.py`): layout reshapes, the minmod limiter and the
structured 2:1 interface corrections, for nd = 3."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..topology.blocks import BlockTables


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
