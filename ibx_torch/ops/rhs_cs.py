"""Channel-split Euler RHS and TVD-RK2 step: the counterpart of
`ibx/ops/pallas_rhs.py` (`cs_split`, `cs_merge`, `pallas_eligible`,
`euler_rhs_cs` with its pre-add and fold paths, the cell-major shim
`euler_rhs_grid_pallas`, `rk2_step_cs`).

The state stays ``[B, C, bs, bs*bs]`` across the march. Per RHS
evaluation: kernel pass A (`kernels.euler_pass_a`), the structured 2:1
interface corrections of its outputs (tensor-op glue over the few
interface blocks), the sensor assembly, kernel pass B
(`kernels.euler_pass_b`) and the 2:1 corrections of R. The gradient
corrections are either added to ``du`` before pass B (the default) or
handed to pass B's fold variant, which adds them as it loads (``fold``,
the counterpart of ``IBX_CS_FOLD=1``). The RK2 stages are kernel
`rk2_update` followed by the ghost BC.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..physics.fluid import Fluid, speed_of_sound
from ..topology.blocks import BlockTables
from . import block_ops as bo
from .kernels import (STENCIL_BLOCK_SIZES, euler_pass_a, euler_pass_b,
                      rk2_update)


def cs_split(bt: BlockTables, X3):
    """[B, bs, bs, bs, C] cell-major -> [B, C, bs, bs*bs] channel-split."""
    B, bs = bt.n_blocks, bt.block_size
    C = X3.shape[-1]
    return X3.permute(0, 4, 1, 2, 3).reshape(B, C, bs, bs * bs).contiguous()


def cs_merge(bt: BlockTables, Xc):
    """[B, C, bs, bs*bs] -> [B, bs, bs, bs, C] cell-major."""
    B, bs = bt.n_blocks, bt.block_size
    C = Xc.shape[1]
    return Xc.reshape(B, C, bs, bs, bs).permute(0, 2, 3, 4, 1).contiguous()


def _edge_plane(X5, d: int, e: int):
    """Plane ``e`` of dim ``d`` of a [V, C, z, y, x] grid (a view)."""
    if d == 2:
        return X5[:, :, e]
    if d == 1:
        return X5[:, :, :, e]
    return X5[..., e]


def _cs_edge_fetch(bt: BlockTables, arrays_cs, d: int,
                   extra_fn: Optional[Callable] = None,
                   channel_slice: Optional[Sequence] = None,
                   plane_fix: Optional[Sequence] = None):
    """``fetch(s, blocks)`` for `block_ops.interface_corrections` over
    channel-split operands: the side-s edge planes of the given blocks,
    channel-last [V, bs, bs, Ktot] (only the planes are gathered).
    ``channel_slice[i]``: optional (c0, c1) channel range of part i.
    ``plane_fix[i]``: optional (idx [B, 2], vals [V + 1, bs, bs, Ci]); the
    row ``vals[idx[b, s]]`` is added to part i's side-s plane of block b
    (the fold keeps ``du`` uncorrected, so the glue reads corrected planes
    this way; the last row of ``vals`` is zero)."""
    bs = bt.block_size

    def fetch(s, blocks):
        e = bs - 1 if s else 0
        outs = []
        for i, Xc in enumerate(arrays_cs):
            X5 = Xc.view(Xc.shape[0], Xc.shape[1], bs, bs, bs)
            if channel_slice is not None and channel_slice[i] is not None:
                c0, c1 = channel_slice[i]
                X5 = X5[:, c0:c1]
            plane = _edge_plane(X5, d, e)[blocks].permute(0, 2, 3, 1)
            if plane_fix is not None and plane_fix[i] is not None:
                idx, vals = plane_fix[i]
                plane = plane + vals[idx[blocks, s]]
            outs.append(plane)
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return out if extra_fn is None else extra_fn(out)

    return fetch


def _has_ifc(bt: BlockTables, d: int) -> bool:
    return bool(bt.fs_block[d][0].shape[0] or bt.fs_block[d][1].shape[0]
                or bt.cs_block[d][0].shape[0] or bt.cs_block[d][1].shape[0])


def _cols_add_cs(bt: BlockTables, Xc, cols, d: int, ch0: int, ch1: int,
                 src0: int = 0):
    """Add channels [src0, src0 + ch1 - ch0) of the per-side interface
    corrections ``cols`` (from `block_ops.interface_corrections`) into
    channels [ch0, ch1) of ``Xc``'s side-s edge planes, in place."""
    bs = bt.block_size
    X5 = Xc.view(Xc.shape[0], Xc.shape[1], bs, bs, bs)[:, ch0:ch1]
    for s in (0, 1):
        if cols[s] is None:
            continue
        blocks, vals = cols[s]
        add = vals[..., src0:src0 + (ch1 - ch0)].permute(0, 3, 1, 2)
        _edge_plane(X5, d, bs - 1 if s else 0).index_add_(0, blocks, add)


def _cs_cells(Xc, c0: int, c1: int, idx):
    """Rows [F, c1 - c0] of channels [c0, c1) of the channel-split ``Xc``
    at flat cell ids ``idx`` (block-major, w = z*bs^2 + y*bs + x)."""
    npb = Xc.shape[2] * Xc.shape[3]
    return Xc[:, c0:c1].reshape(Xc.shape[0], c1 - c0, npb)[
        idx // npb, :, idx % npb]


def _cs_cells_add(Xc, c0: int, vals, idx) -> None:
    """Add ``vals`` [F, k] into channels [c0, c0 + k) of ``Xc`` at flat
    cell ids ``idx``, in place (`index_add_`: repeated cells sum)."""
    C, npb = Xc.shape[1], Xc.shape[2] * Xc.shape[3]
    ch = torch.arange(c0, c0 + vals.shape[1], device=idx.device)
    flat = ((idx // npb)[:, None] * C + ch) * npb + (idx % npb)[:, None]
    Xc.view(-1).index_add_(0, flat.reshape(-1), vals.reshape(-1))


def _leftover_add(bt: BlockTables, d: int, rows: Callable,
                  face_fn: Callable, signed_mask: Sequence[float],
                  targets: Sequence) -> None:
    """Generic sparse leftover faces of dim ``d``, added in place: the
    counterpart of `block_ops._sparse_accum` on channel-split operands.
    ``rows(idx)`` gives the operands' rows at flat cell ids; face value
    column range ``(k0, k1)`` goes to channels ``c0..`` of ``Xc`` for each
    ``(Xc, c0, k0, k1)`` in ``targets``. The kernels mask these faces out
    (their block sides are neither dense nor structured 2:1)."""
    o, n = bt.sp_owner[d], bt.sp_neighbor[d]
    sp = bt.spacing_flat[:, d]
    so, sn = sp[o][:, None], sp[n][:, None]
    vals = face_fn(rows(o), rows(n), so, sn)
    pm = bt.signs(signed_mask)
    to_o = bt.sp_wr[d][:, None] * vals / so
    to_n = bt.sp_wl[d][:, None] * vals * pm / sn
    for Xc, c0, k0, k1 in targets:
        _cs_cells_add(Xc, c0, to_o[:, k0:k1], o)
        _cs_cells_add(Xc, c0, to_n[:, k0:k1], n)


def pallas_eligible(bt: BlockTables, *, viscous: bool = False, fix3=None,
                    cut3=None, frozen=None, mu_t3=None) -> bool:
    """Static gate of the kernel route (`ibx/ops/pallas_rhs.py`
    `pallas_eligible`): the 3D Euler configuration without frozen
    gradients or extra physics, at a block size the pass-A and pass-B
    kernels take (`kernels.STENCIL_BLOCK_SIZES`: 4, 8 and 16). The JAX gate
    asks for 8 or 16, the TPU kernels' tilings; the CUDA kernels run one
    CUDA block of bs^2 threads per mesh block, so they also take 4 (16
    threads, the parity fixture's size) but not 2 (4 threads) or 32 (1024
    threads and four times the shared-memory tile). A mesh with generic
    sparse leftover faces stays on the torch-op body, which accumulates
    them; so does nd = 2, for which no kernel exists in either package."""
    return (bt.nd == 3 and bt.block_size in STENCIL_BLOCK_SIZES
            and not viscous and fix3 is None and cut3 is None
            and frozen is None and mu_t3 is None and bt.n_sparse == 0)


def gradients_cs(bt: BlockTables, fluid: Fluid, Pc, *, with_dt: bool,
                 fold: bool = False):
    """Pass A with its 2:1 corrections and the sensor: returns ``(du_cs,
    aux, nu_cs, cols6)``. Without ``fold`` the gradient corrections are
    added to ``du_cs`` and ``cols6`` is None; with ``fold`` ``du_cs`` stays
    uncorrected and ``cols6 = (bt.fold_rows, vals)`` holds them for
    `kernels.euler_pass_b` (None when the mesh has no 2:1 interface)."""
    nd, bs, B = bt.nd, bt.block_size, bt.n_blocks
    ncomp = Pc.shape[1]
    du_cs, aux = euler_pass_a(fluid, Pc, bt.meta, bt.nbr_table,
                              with_dt=with_dt)
    fold_cols = []     # channel-last du corrections, (d, s) order
    face_A = bo.cat_fn(bo.face_a(with_dt), [ncomp, 1] if with_dt else [ncomp])

    signedA = [1.0] * (ncomp + 1) + [0.0] * (2 if with_dt else 1)
    for d in range(nd):
        if not _has_ifc(bt, d):
            continue
        if with_dt:
            def extraA(pp, d=d):
                Sd = pp[..., 2 + d].abs() + speed_of_sound(fluid, pp[..., 1])
                return torch.cat([pp, Sd[..., None]], dim=-1)
        else:
            extraA = None
        cols = bo.interface_corrections(
            bt, d, face_A, signedA, _cs_edge_fetch(bt, [Pc], d, extraA))
        # cols channels: [du(5), G, U (, sf)] -> kernel-A outputs
        if fold:
            fold_cols += [c[1][..., 0:5] for c in cols if c is not None]
        else:
            _cols_add_cs(bt, du_cs, cols, d, d * 5, (d + 1) * 5, 0)
        _cols_add_cs(bt, aux, cols, d, d, d + 1, 5)
        _cols_add_cs(bt, aux, cols, d, nd + d, nd + d + 1, 6)
        if with_dt:
            _cols_add_cs(bt, aux, cols, d, 2 * nd + d, 2 * nd + d + 1, 7)

    for d in range(nd):
        if not bt.sp_owner[d].shape[0]:
            continue
        if with_dt:
            def rowsA(idx, d=d):
                pp = _cs_cells(Pc, 0, ncomp, idx)
                Sd = pp[:, 2 + d].abs() + speed_of_sound(fluid, pp[:, 1])
                return torch.cat([pp, Sd[:, None]], dim=-1)
        else:
            def rowsA(idx):
                return _cs_cells(Pc, 0, ncomp, idx)
        tg = [(du_cs, d * 5, 0, 5), (aux, d, 5, 6), (aux, nd + d, 6, 7)]
        if with_dt:
            tg.append((aux, 2 * nd + d, 7, 8))
        _leftover_add(bt, d, rowsA, face_A, signedA, tg)

    nu_cs = torch.full((B, 1, bs, bs * bs), 1e-7, dtype=Pc.dtype,
                       device=Pc.device)
    for d in range(nd):
        nu_cs = torch.maximum(
            nu_cs, (1e-7 + aux[:, d:d + 1].abs())
            / (1e-7 + aux[:, nd + d:nd + d + 1]))
    cols6 = None
    if fold_cols:
        # the rows come in the order `BlockTables.fold_rows` numbers them
        cl = torch.cat(fold_cols)
        cols6 = (bt.fold_rows,
                 cl.permute(0, 3, 1, 2).reshape(cl.shape[0], 5, bs * bs)
                 .contiguous())
    return du_cs, aux, nu_cs, cols6


def euler_rhs_cs(bt: BlockTables, fluid: Fluid, Pc, *,
                 high_order: bool = True, with_dt: bool = False,
                 with_frozen: bool = False, fold: bool = False):
    """Channel-split RHS ``Rc [B, 5, bs, bs*bs]``; with ``with_dt`` also the
    per-cell wave-speed bound ``dtb [B, 1, bs, bs*bs]`` (not yet
    cfl-scaled); with ``with_frozen`` also the corrected ``(du_cs,
    nu_cs)``, last. ``fold`` hands the 2:1 gradient corrections to pass B's
    fold kernel instead of adding them to ``du_cs``; ``with_frozen`` turns
    it off, since it hands ``du_cs`` out. The kernels cover the dense and
    the structured 2:1 faces only: tables with generic sparse leftover
    faces are masked out of the kernels' results and added by torch ops
    (`_leftover_add`) after each pass, with the gradient corrections
    pre-added (no fold). The JAX package's route has no such faces
    (`pallas_eligible` keeps them off it); the sharded block march's
    local grids have them at halo blocks
    (`ibx_torch.parallel.block_sharding`)."""
    nd, bs = bt.nd, bt.block_size
    ncomp = Pc.shape[1]
    fold = fold and not with_frozen and not bt.n_sparse
    du_cs, aux, nu_cs, cols6 = gradients_cs(bt, fluid, Pc, with_dt=with_dt,
                                            fold=fold)
    Rc = euler_pass_b(fluid, Pc, du_cs, nu_cs, bt.meta, bt.nbr_table,
                      high_order=high_order, cols6=cols6)

    du_fix = None
    if cols6 is not None:
        # the glue reads corrected du planes: row idx[b, s] of the
        # channel-last corrections (a zero row where block b has none)
        vals = cols6[1].view(-1, 5, bs, bs).permute(0, 2, 3, 1)
        vals = torch.cat([vals, vals.new_zeros((1, bs, bs, 5))])
        rows = bt.fold_rows.long()
        idx = torch.where(rows >= 0, rows, vals.shape[0] - 1)

    # 2:1 interface corrections for pass B
    for d in range(nd):
        if not _has_ifc(bt, d):
            continue
        if cols6 is not None:
            du_fix = [None, (idx[:, 2 * d:2 * d + 2], vals), None]
        fetchB = _cs_edge_fetch(
            bt, [Pc, du_cs, nu_cs], d,
            channel_slice=[None, (d * 5, (d + 1) * 5), None],
            plane_fix=du_fix)
        face_B = bo.cat_fn(bo.face_b(fluid, high_order, d), [ncomp, 5, 1])
        cols = bo.interface_corrections(bt, d, face_B, [1.0] * ncomp, fetchB)
        _cols_add_cs(bt, Rc, cols, d, 0, ncomp)
    for d in range(nd):
        if not bt.sp_owner[d].shape[0]:
            continue

        def rowsB(idx, d=d):
            return torch.cat([_cs_cells(Pc, 0, ncomp, idx),
                              _cs_cells(du_cs, d * 5, (d + 1) * 5, idx),
                              _cs_cells(nu_cs, 0, 1, idx)], dim=-1)

        face_B = bo.cat_fn(bo.face_b(fluid, high_order, d), [ncomp, 5, 1])
        _leftover_add(bt, d, rowsB, face_B, [1.0] * ncomp,
                      [(Rc, 0, 0, ncomp)])

    out = [Rc]
    if with_dt:
        out.append(aux[:, 2 * nd:2 * nd + 1] + aux[:, 2 * nd + 1:2 * nd + 2]
                   + aux[:, 2 * nd + 2:2 * nd + 3])
    if with_frozen:
        out.append((du_cs, nu_cs))
    return out[0] if len(out) == 1 else tuple(out)


def euler_rhs_grid_pallas(bt: BlockTables, fluid: Fluid, P3, *,
                          high_order: bool = True, with_dt: bool = False,
                          cfl: float = 0.8, fold: bool = False):
    """Kernel route of `block_ops.euler_rhs_grid` on the cell-major state
    ``[B, bs, bs, bs, C]``: the same (R3 [, dt3, (du3_list, nu3)])
    structure, through `euler_rhs_cs` between a `cs_split` and a
    `cs_merge`. A ``with_dt`` call hands out the frozen gradients, so it
    runs without the fold; ``fold`` reaches the plain-RHS call."""
    bs, B = bt.block_size, bt.n_blocks
    out = euler_rhs_cs(bt, fluid, cs_split(bt, P3), high_order=high_order,
                       with_dt=with_dt, with_frozen=with_dt, fold=fold)
    if not with_dt:
        return cs_merge(bt, out)
    Rc, dtb, (du_cs, nu_cs) = out
    dt3 = (cfl / dtb[:, 0]).reshape(B, bs, bs, bs)
    du3 = [cs_merge(bt, du_cs[:, d * 5:(d + 1) * 5]) for d in range(3)]
    return cs_merge(bt, Rc), dt3, (du3, cs_merge(bt, nu_cs))


def rk2_step_cs(bt: BlockTables, fluid: Fluid, Pc, apply_bcs_cs: Callable,
                *, cfl: float = 0.8, high_order: bool = True,
                active_cs=None, fold: bool = False):
    """Local-dt TVD-RK2 pseudo step on the channel-split state (reference
    semantics ``src/ImmersedBoundary.jl:873-1157``). ``apply_bcs_cs`` maps
    a cs grid to a cs grid; ``active_cs``: f32[B, 1, bs, bs*bs] 0/1 freeze
    mask; ``fold`` as in `euler_rhs_cs`, for both stages. Returns (P2,
    resnorm)."""
    R0, dtb = euler_rhs_cs(bt, fluid, Pc, high_order=high_order,
                           with_dt=True, fold=fold)
    P1 = apply_bcs_cs(rk2_update(fluid, Pc, R0, None, dtb, active_cs, cfl))
    R1 = euler_rhs_cs(bt, fluid, P1, high_order=high_order, fold=fold)
    P2 = apply_bcs_cs(rk2_update(fluid, Pc, R0, R1, dtb, active_cs, cfl))
    resnorm = R0[:, 0].abs().max()
    return P2, resnorm
