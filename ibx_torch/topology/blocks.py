"""Block-structured tables: the host compiler and the device tables.

`build_block_tables_raw` is a verbatim numpy copy of the JAX package's
host compiler (`ibx/topology/blocks.py`); it returns that package's
`BlockTables` fields as a dict of numpy arrays, at nd = 2 or 3.
`BlockTables` holds what the block marches need as tensors on one device,
plus, at nd = 3, the per-block tables the CUDA kernels read (`meta`,
`nbr_table`, `fold_rows`).

Face classification (see the JAX module): intra-block and equal-size
inter-block faces are dense shifts; outer-boundary one-sided faces are
self-neighbor sides; 2:1 refinement interfaces are structured
block-column corrections; anything else is a generic sparse leftover
(`sp_owner` / `sp_neighbor` / `sp_wr` / `sp_wl`), which
`block_ops.face_accumulate` gathers and scatter-adds and the CUDA kernel
route leaves to it (`rhs_cs.pallas_eligible`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class BlockTables:
    """Static block tables on one device.

    nbr[d][s]: int64[B] dense neighbor block (self on boundary sides, 0
      where invalid); bnd[d][s]: f32[B] 1 on one-sided boundary sides;
      edge_valid[d][s]: f32[B]; h: f32[B, nd] cell size per block.
    Structured 2:1 interfaces per dim d and side s: fs_block / fs_coarse /
      fs_off (fine side: fine block, coarse neighbor, quadrant), cs_block /
      cs_fine (coarse side: coarse block, its 2^(nd-1) fine neighbors).
    Generic sparse leftover per dim d: sp_owner / sp_neighbor int64[F_d]
      flat cell ids, sp_wr / sp_wl f32[F_d] the face's weight on its owner
      and on its neighbor; spacing_flat f32[N, nd] per-cell widths (the
      sparse accumulations divide by them: the leftover faces and the
      cut-cell wall's cut faces); n_sparse the leftover faces' count over
      all dims.
    Kernel tables (nd = 3 only, None at nd = 2, which no kernel takes):
      meta f32[B, 16] = h_d (3), edge_valid[d][s] (6), bnd[d][s] (6), pad;
      nbr_table int32[B, 8] = nbr[d][s] (x0 x1 y0 y1 z0 z1), pad;
      fold_rows int32[B, 6]: at 2d + s, the row of block b in the (d,
      s)-ordered concatenation of the interface rows cat(fs_block[d][s],
      cs_block[d][s]), or -1 (the pass-B fold's row index,
      `kernels.euler_pass_b`).
    """

    nbr: Tuple
    bnd: Tuple
    edge_valid: Tuple
    h: torch.Tensor
    fs_block: Tuple
    fs_coarse: Tuple
    fs_off: Tuple
    cs_block: Tuple
    cs_fine: Tuple
    sp_owner: Tuple
    sp_neighbor: Tuple
    sp_wr: Tuple
    sp_wl: Tuple
    spacing_flat: torch.Tensor
    meta: Optional[torch.Tensor]
    nbr_table: Optional[torch.Tensor]
    fold_rows: Optional[torch.Tensor]
    n_blocks: int
    block_size: int
    nd: int
    n_cells: int
    n_sparse: int
    # sign vectors of the accumulations, one per mask (`signs`)
    _signs: Dict[Tuple[float, ...], torch.Tensor] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    def signs(self, signed_mask) -> torch.Tensor:
        """f32 [len(signed_mask)] on this table's device: -1 on the
        channels ``signed_mask`` flags, 1 elsewhere. Each mask is uploaded
        once, at its first use, so that a step copies nothing from the host
        (a CUDA graph cannot capture that copy)."""
        key = tuple(float(v) for v in signed_mask)
        out = self._signs.get(key)
        if out is None:
            out = torch.tensor([-1.0 if v > 0 else 1.0 for v in key],
                               dtype=torch.float32, device=self.h.device)
            self._signs[key] = out
        return out

    @classmethod
    def from_numpy(cls, f: Dict[str, object], device) -> "BlockTables":
        """Device tables from `build_block_tables_raw` output (or the JAX
        package's `BlockTables` fields as numpy arrays)."""
        nd, bs, B = int(f["nd"]), int(f["block_size"]), int(f["n_blocks"])
        if nd not in (2, 3) or bs < 2 or bs & (bs - 1):
            raise ValueError(f"block tables need nd=2 or 3 and a "
                             f"power-of-two block size (nd={nd}, bs={bs})")

        def idx(a):
            return torch.as_tensor(np.array(a, np.int64), device=device)

        def f32(a):
            return torch.as_tensor(np.array(a, np.float32), device=device)

        def per_side(key, conv):
            return tuple(tuple(conv(f[key][d][s]) for s in range(2))
                         for d in range(nd))

        def per_dim(key, conv):
            return tuple(conv(f[key][d]) for d in range(nd))

        h = np.asarray(f["h"], np.float32)
        n_sparse = sum(int(np.asarray(o).shape[0]) for o in f["sp_owner"])
        meta = nbr_table = fold_rows = None
        if nd == 3:
            meta = np.zeros((B, 16), np.float32)
            meta[:, 0:3] = h
            nbr_table = np.zeros((B, 8), np.int32)
            fold_rows = np.full((B, 6), -1, np.int32)
            n_rows = 0
            for d in range(nd):
                for s in range(2):
                    meta[:, 3 + 2 * d + s] = f["edge_valid"][d][s]
                    meta[:, 9 + 2 * d + s] = f["bnd"][d][s]
                    nbr_table[:, 2 * d + s] = f["nbr"][d][s]
                    ifc = np.concatenate([np.asarray(f["fs_block"][d][s]),
                                          np.asarray(f["cs_block"][d][s])])
                    fold_rows[ifc.astype(np.int64), 2 * d + s] = \
                        n_rows + np.arange(ifc.shape[0], dtype=np.int32)
                    n_rows += ifc.shape[0]
            meta = f32(meta)
            nbr_table = torch.as_tensor(nbr_table, device=device)
            fold_rows = torch.as_tensor(fold_rows, device=device)
        return cls(
            nbr=per_side("nbr", idx),
            bnd=per_side("bnd", f32),
            edge_valid=per_side("edge_valid", f32),
            h=f32(h),
            fs_block=per_side("fs_block", idx),
            fs_coarse=per_side("fs_coarse", idx),
            fs_off=per_side("fs_off", idx),
            cs_block=per_side("cs_block", idx),
            cs_fine=per_side("cs_fine", idx),
            sp_owner=per_dim("sp_owner", idx),
            sp_neighbor=per_dim("sp_neighbor", idx),
            sp_wr=per_dim("sp_wr", f32),
            sp_wl=per_dim("sp_wl", f32),
            spacing_flat=f32(f["spacing_flat"]),
            meta=meta, nbr_table=nbr_table, fold_rows=fold_rows,
            n_blocks=B, block_size=bs, nd=nd, n_cells=int(f["n_cells"]),
            n_sparse=n_sparse,
        )


def build_block_tables(dom) -> Dict[str, object]:
    """Numpy block tables of a host `Domain`."""
    msh = dom.mesh
    return build_block_tables_raw(
        nd=msh.ndim,
        bs=int(msh.block_size),
        B=msh.n_blocks,
        fdim=dom.face_dim,
        fo=dom.face_owner,
        fn=dom.face_neighbor,
        widths=dom.widths,
        centers=dom.centers,
        block_origins=msh.block_origins,
        block_widths=msh.block_widths,
    )


def _colid(bs: int, nd: int, d: int, s: int, b: int, j) -> np.ndarray:
    """Global cell ids of block b's edge plane on side s of dim d.

    ``j`` is the flat perpendicular index: ascending over the single
    perpendicular dim in 2D; highest-dim-major over the two perpendicular
    dims in 3D (matching the array order left by `_edge` in block_ops:
    [B, z, y, x, C] minus the d axis).
    """
    j = np.asarray(j)
    edge = bs - 1 if s else 0
    perp = [dd for dd in range(nd) if dd != d]
    within = edge * bs ** d
    coords = [j % bs, j // bs] if nd == 3 else [j]
    for c, dd in zip(coords, perp):
        within = within + c * bs ** dd
    return b * bs ** nd + within


def _fine_of_coarse_j(bs: int, nd: int, q: int, j) -> np.ndarray:
    """Coarse plane index faced by fine plane cell ``j`` of quadrant ``q``.

    q packs the fine block's position on the coarse face: off_lo in 2D;
    off_hi * 2 + off_lo in 3D.
    """
    j = np.asarray(j)
    h = bs // 2
    if nd == 2:
        return q * h + j // 2
    c_lo, c_hi = j % bs, j // bs
    q_lo, q_hi = q % 2, q // 2
    return (q_hi * h + c_hi // 2) * bs + (q_lo * h + c_lo // 2)



def build_block_tables_raw(
    *,
    nd: int,
    bs: int,
    B: int,
    fdim: np.ndarray,
    fo: np.ndarray,
    fn: np.ndarray,
    widths: np.ndarray,
    centers: np.ndarray,
    block_origins: np.ndarray,
    block_widths: np.ndarray,
) -> Dict[str, object]:
    """Host compiler from raw face/cell arrays: the JAX package's
    `BlockTables` fields as a dict of numpy arrays (verbatim numpy).

    Index space: cells 0..B*bs^nd-1 in block-major order; faces may
    reference -1 for the outside. Used globally (`build_block_tables`) and
    per device on localized sub-domains (`ibx.parallel.block_sharding`).
    """
    npb = bs ** nd
    N = B * npb

    fo = np.asarray(fo).astype(np.int64)
    fn = np.asarray(fn).astype(np.int64)

    bo = np.where(fo >= 0, fo // npb, -1)
    bn = np.where(fn >= 0, fn // npb, -1)

    interior = (fo >= 0) & (fn >= 0)
    intra = interior & (bo == bn)

    # regular inter-block face: both sides exist, equal widths, aligned
    eq_size = interior.copy()
    align = interior.copy()
    wo = widths[np.maximum(fo, 0)]
    wn = widths[np.maximum(fn, 0)]
    co = centers[np.maximum(fo, 0)]
    cn = centers[np.maximum(fn, 0)]
    eq_size &= np.all(np.isclose(wo, wn, rtol=1e-4), axis=1)
    for d in range(nd):
        on_d = fdim == d
        tol = 0.01 * wo[:, d]
        for dp in range(nd):
            delta = np.abs(cn[:, dp] - co[:, dp])
            if dp == d:
                align &= ~on_d | (np.abs(delta - wo[:, d]) < tol)
            else:
                align &= ~on_d | (delta < tol)
    regular = interior & eq_size & align

    nbr = [[np.zeros(B, np.int64) for _ in range(2)] for _ in range(nd)]
    bnd = [[np.zeros(B, np.float32) for _ in range(2)] for _ in range(nd)]
    edge_valid = [[np.zeros(B, np.float32) for _ in range(2)] for _ in range(nd)]
    # per-side coverage: cov_o = the face's contribution to its owner
    # (minus-side cell) is handled; cov_n = to its neighbor. A face may be
    # covered on one side by a structured interface and on the other by
    # another (each 2:1 face appears in one fine-side AND one coarse-side
    # table).
    cov_o = intra | (fo < 0)
    cov_n = intra | (fn < 0)

    inter = interior & ~intra
    n_side = bs ** (nd - 1)
    one_sided = ~interior

    fs_block = [[[] for _ in range(2)] for _ in range(nd)]
    fs_coarse = [[[] for _ in range(2)] for _ in range(nd)]
    fs_off = [[[] for _ in range(2)] for _ in range(nd)]
    cs_block = [[[] for _ in range(2)] for _ in range(nd)]
    cs_fine = [[[] for _ in range(2)] for _ in range(nd)]

    structured_2to1 = nd in (2, 3) and bs % 2 == 0
    n_fine = 2 ** (nd - 1)      # fine blocks per coarse 2:1 side

    for d in range(nd):
        # group faces by (block, side): side 1 = block is the minus cell
        sel_i = np.nonzero(inter & (fdim == d))[0]
        sel_b = np.nonzero(one_sided & (fdim == d))[0]

        # --- boundary one-sided sides (self halo) -------------------------
        # owner exists, neighbor == -1 -> owner block's plus side
        for rows, blocks, side in (
            (sel_b[fn[sel_b] < 0], bo[sel_b[fn[sel_b] < 0]], 1),
            (sel_b[fo[sel_b] < 0], bn[sel_b[fo[sel_b] < 0]], 0),
        ):
            if rows.size == 0:
                continue
            cnt = np.bincount(blocks, minlength=B)
            full = np.nonzero(cnt == n_side)[0]
            isfull = np.zeros(B, bool)
            isfull[full] = True
            take = isfull[blocks]
            for b in full:
                nbr[d][side][b] = b
                bnd[d][side][b] = 1.0
                edge_valid[d][side][b] = 1.0
            if side == 1:
                cov_o[rows[take]] = True
            else:
                cov_n[rows[take]] = True

        # --- same-size dense sides ----------------------------------------
        key_o = bo[sel_i]
        key_n = bn[sel_i]
        reg = regular[sel_i]
        marked = [np.zeros(B, bool), np.zeros(B, bool)]
        for keys, other, side in ((key_o, key_n, 1), (key_n, key_o, 0)):
            order = np.argsort(keys, kind="stable")
            ks = keys[order]
            start = np.searchsorted(ks, np.arange(B), side="left")
            end = np.searchsorted(ks, np.arange(B), side="right")
            cand = np.nonzero(end - start == n_side)[0]
            for b in cand:
                rows = order[start[b]:end[b]]
                if not reg[rows].all():
                    continue
                nb = other[rows]
                if (nb != nb[0]).any():
                    continue
                marked[side][b] = True
                nbr[d][side][b] = nb[0]
        # symmetric check, then mark faces
        dense_rows = marked[1][key_o] & marked[0][key_n]
        cov_o[sel_i[dense_rows]] = True
        cov_n[sel_i[dense_rows]] = True
        ok1 = np.zeros(B, bool)
        ok1[key_o[dense_rows]] = True
        ok0 = np.zeros(B, bool)
        ok0[key_n[dense_rows]] = True
        for side, ok in ((1, ok1), (0, ok0)):
            good = marked[side] & ok
            edge_valid[d][side][good] = 1.0
            nbr[d][side][~good & marked[side]] = 0

        # --- structured 2:1 interfaces (2D + 3D) ---------------------------
        if structured_2to1:
            # fine side: cell is half the size of the other
            for side in (0, 1):
                cov_side = cov_o if side == 1 else cov_n
                rem = sel_i[~cov_side[sel_i]]
                # side s of block b: b's cells are the (s? minus : plus)...
                # side==1: b is the owner(minus-coordinate) block
                mine = fo[rem] if side == 1 else fn[rem]
                theirs = fn[rem] if side == 1 else fo[rem]
                bm = mine // npb
                btheirs = theirs // npb
                w_m = widths[mine, d]
                w_t = widths[theirs, d]

                # fine side: my cells are half-size; single face per cell
                is_fine = np.isclose(w_t, 2 * w_m, rtol=1e-3)
                order = np.argsort(bm, kind="stable")
                ks = bm[order]
                start = np.searchsorted(ks, np.arange(B), side="left")
                end = np.searchsorted(ks, np.arange(B), side="right")
                j = np.arange(n_side)
                for b in np.nonzero(end - start == n_side)[0]:
                    rows = order[start[b]:end[b]]
                    rr = rem[rows]
                    if not is_fine[rows].all():
                        continue
                    cb = btheirs[rows]
                    if (cb != cb[0]).any():
                        continue
                    cbk = int(cb[0])
                    my_ids = _colid(bs, nd, d, side, b, j)
                    got = dict(zip(mine[rows], theirs[rows]))
                    if set(got.keys()) != set(my_ids.tolist()):
                        continue
                    for off in range(n_fine):
                        exp = _colid(bs, nd, d, 1 - side, cbk,
                                     _fine_of_coarse_j(bs, nd, off, j))
                        if all(got[m] == e for m, e in zip(my_ids, exp)):
                            fs_block[d][side].append(b)
                            fs_coarse[d][side].append(cbk)
                            fs_off[d][side].append(off)
                            cov_side[rr] = True
                            break

            for side in (0, 1):
                cov_side = cov_o if side == 1 else cov_n
                rem = sel_i[~cov_side[sel_i]]
                # coarse side: my cells are double-size; 2^(nd-1) faces/cell
                mine = fo[rem] if side == 1 else fn[rem]
                theirs = fn[rem] if side == 1 else fo[rem]
                bm = mine // npb
                btheirs = theirs // npb
                w_m = widths[mine, d]
                w_t = widths[theirs, d]
                is_coarse = np.isclose(w_m, 2 * w_t, rtol=1e-3)
                order = np.argsort(bm, kind="stable")
                ks = bm[order]
                start = np.searchsorted(ks, np.arange(B), side="left")
                end = np.searchsorted(ks, np.arange(B), side="right")
                perp = [dd for dd in range(nd) if dd != d]
                jn = np.arange(n_fine * n_side)
                jc = jn // n_fine               # coarse plane cell per face
                dk = jn % n_fine                # fine sub-face within it
                for b in np.nonzero(end - start == n_fine * n_side)[0]:
                    rows = order[start[b]:end[b]]
                    rr = rem[rows]
                    if not is_coarse[rows].all():
                        continue
                    fbs = np.unique(btheirs[rows])
                    if fbs.size != n_fine:
                        continue
                    # order fine blocks by perpendicular origin, high-major
                    fq = sorted(
                        fbs.tolist(),
                        key=lambda fb: tuple(
                            block_origins[fb, dp] for dp in perp[::-1]
                        ),
                    )
                    my_ids = _colid(bs, nd, d, side, b, jc)
                    h = bs // 2
                    if nd == 2:
                        q_of = (jc >= h).astype(np.int64)
                        jf = (2 * jc) % bs + dk
                    else:
                        c_lo, c_hi = jc % bs, jc // bs
                        q_of = 2 * (c_hi >= h) + (c_lo >= h)
                        jf = (((2 * c_hi) % bs) + dk // 2) * bs \
                            + ((2 * c_lo) % bs) + dk % 2
                    fb_of = np.asarray(fq)[q_of]
                    exp = np.array([
                        _colid(bs, nd, d, 1 - side, fb_of[k], jf[k])
                        for k in range(jn.size)
                    ])
                    pairs = set(zip(mine[rows].tolist(),
                                    theirs[rows].tolist()))
                    if pairs == set(zip(my_ids.tolist(), exp.tolist())):
                        cs_block[d][side].append(b)
                        cs_fine[d][side].append(tuple(fq))
                        cov_side[rr] = True

    # ---- generic sparse leftovers -----------------------------------------
    sp_owner, sp_neighbor, sp_wr, sp_wl = [], [], [], []
    for d in range(nd):
        sel = np.nonzero((fdim == d) & (~cov_o | ~cov_n))[0]
        o_g = fo[sel]
        n_g = fn[sel]
        add_right = ~cov_o[sel] & (o_g >= 0)
        add_left = ~cov_n[sel] & (n_g >= 0)
        o_f = np.where(o_g < 0, n_g, o_g)
        n_f = np.where(n_g < 0, o_f, n_g)
        w_r = np.zeros(sel.size, np.float32)
        w_l = np.zeros(sel.size, np.float32)
        cnt_r = np.bincount(o_f[add_right], minlength=N)
        cnt_l = np.bincount(n_f[add_left], minlength=N)
        w_r[add_right] = 1.0 / cnt_r[o_f[add_right]]
        w_l[add_left] = 1.0 / cnt_l[n_f[add_left]]
        sp_owner.append(o_f.astype(np.int32))
        sp_neighbor.append(n_f.astype(np.int32))
        sp_wr.append(w_r)
        sp_wl.append(w_l)

    h = (np.asarray(block_widths) / bs).astype(np.float32)

    def i32(x):
        return np.asarray(x, dtype=np.int32)

    def inverse(blocks_list):
        # inv[b] = position of block b in the table, or V (dummy row)
        arr = np.asarray(blocks_list, dtype=np.int64)
        inv = np.full(B, arr.size, dtype=np.int32)
        inv[arr] = np.arange(arr.size, dtype=np.int32)
        return inv

    def merged_inverse(fs_list, cs_list):
        # one placement table over the disjoint fine/coarse block sets:
        # fs rows first, cs rows after, dummy zero row last
        fs = np.asarray(fs_list, dtype=np.int64)
        cs = np.asarray(cs_list, dtype=np.int64)
        inv = np.full(B, fs.size + cs.size, dtype=np.int32)
        inv[fs] = np.arange(fs.size, dtype=np.int32)
        inv[cs] = fs.size + np.arange(cs.size, dtype=np.int32)
        return inv

    return dict(
        nbr=tuple(tuple(i32(nbr[d][s]) for s in range(2)) for d in range(nd)),
        bnd=tuple(tuple(bnd[d][s] for s in range(2)) for d in range(nd)),
        edge_valid=tuple(
            tuple(edge_valid[d][s] for s in range(2)) for d in range(nd)
        ),
        h=h,
        fs_block=tuple(
            tuple(i32(fs_block[d][s]) for s in range(2)) for d in range(nd)
        ),
        fs_coarse=tuple(
            tuple(i32(fs_coarse[d][s]) for s in range(2)) for d in range(nd)
        ),
        fs_off=tuple(
            tuple(i32(fs_off[d][s]) for s in range(2)) for d in range(nd)
        ),
        fs_inv=tuple(
            tuple(inverse(fs_block[d][s]) for s in range(2))
            for d in range(nd)
        ),
        cs_block=tuple(
            tuple(i32(cs_block[d][s]) for s in range(2)) for d in range(nd)
        ),
        cs_fine=tuple(
            tuple(
                i32(cs_fine[d][s]).reshape(-1, n_fine)
                if len(cs_fine[d][s]) else np.zeros((0, n_fine), np.int32)
                for s in range(2)
            )
            for d in range(nd)
        ),
        cs_inv=tuple(
            tuple(inverse(cs_block[d][s]) for s in range(2))
            for d in range(nd)
        ),
        ifc_inv=tuple(
            tuple(merged_inverse(fs_block[d][s], cs_block[d][s])
                  for s in range(2))
            for d in range(nd)
        ),
        sp_owner=tuple(sp_owner),
        sp_neighbor=tuple(sp_neighbor),
        sp_wr=tuple(sp_wr),
        sp_wl=tuple(sp_wl),
        spacing_flat=widths.astype(np.float32),
        n_blocks=B,
        block_size=bs,
        nd=nd,
        n_cells=N,
    )
