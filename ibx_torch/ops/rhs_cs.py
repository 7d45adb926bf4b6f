"""Channel-split Euler RHS and TVD-RK2 step: the counterpart of
`ibx/ops/pallas_rhs.py` (`cs_split`, `cs_merge`, `euler_rhs_cs` on its
default pre-add path, `rk2_step_cs`).

The state stays ``[B, C, bs, bs*bs]`` across the march. Per RHS
evaluation: kernel pass A (`kernels.euler_pass_a`), the structured 2:1
interface corrections of its outputs (tensor-op glue over the few
interface blocks), the sensor assembly, kernel pass B
(`kernels.euler_pass_b`) and the 2:1 corrections of R. The RK2 stages are
kernel `rk2_update` followed by the ghost BC.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..physics.fluid import Fluid, speed_of_sound
from ..physics.flux import inviscid_fluxes_hll
from ..topology.blocks import BlockTables
from . import block_ops as bo
from .kernels import euler_pass_a, euler_pass_b, rk2_update


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
                   channel_slice: Optional[Sequence] = None):
    """``fetch(s, blocks)`` for `block_ops.interface_corrections` over
    channel-split operands: the side-s edge planes of the given blocks,
    channel-last [V, bs, bs, Ktot] (only the planes are gathered).
    ``channel_slice[i]``: optional (c0, c1) channel range of part i."""
    bs = bt.block_size

    def fetch(s, blocks):
        e = bs - 1 if s else 0
        outs = []
        for i, Xc in enumerate(arrays_cs):
            X5 = Xc.view(Xc.shape[0], Xc.shape[1], bs, bs, bs)
            if channel_slice is not None and channel_slice[i] is not None:
                c0, c1 = channel_slice[i]
                X5 = X5[:, c0:c1]
            outs.append(_edge_plane(X5, d, e)[blocks].permute(0, 2, 3, 1))
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


def euler_rhs_cs(bt: BlockTables, fluid: Fluid, Pc, *,
                 high_order: bool = True, with_dt: bool = False):
    """Channel-split RHS ``Rc [B, 5, bs, bs*bs]``; with ``with_dt`` also the
    per-cell wave-speed bound ``dtb [B, 1, bs, bs*bs]`` (not yet
    cfl-scaled)."""
    nd, bs, B = bt.nd, bt.block_size, bt.n_blocks
    ncomp = Pc.shape[1]
    du_cs, aux = euler_pass_a(fluid, Pc, bt.meta, bt.nbr_table,
                              with_dt=with_dt)

    # 2:1 interface corrections for pass A
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

        def face_A(Wo, Wn, ho, hn):
            Po, Pn = Wo[..., :ncomp], Wn[..., :ncomp]
            Pf = (Po * hn + Pn * ho) / (ho + hn)
            fd = Pn[..., 0:1] - Po[..., 0:1]
            out = [Pf, fd, fd.abs()]
            if with_dt:
                So, Sn = Wo[..., ncomp:], Wn[..., ncomp:]
                out.append((So * hn + Sn * ho) / (ho + hn))
            return torch.cat(out, dim=-1)

        cols = bo.interface_corrections(
            bt, d, face_A, signedA, _cs_edge_fetch(bt, [Pc], d, extraA))
        # cols channels: [du(5), G, U (, sf)] -> kernel-A outputs
        _cols_add_cs(bt, du_cs, cols, d, d * 5, (d + 1) * 5, 0)
        _cols_add_cs(bt, aux, cols, d, d, d + 1, 5)
        _cols_add_cs(bt, aux, cols, d, nd + d, nd + d + 1, 6)
        if with_dt:
            _cols_add_cs(bt, aux, cols, d, 2 * nd + d, 2 * nd + d + 1, 7)

    nu_cs = torch.full((B, 1, bs, bs * bs), 1e-7, dtype=Pc.dtype,
                       device=Pc.device)
    for d in range(nd):
        nu_cs = torch.maximum(
            nu_cs, (1e-7 + aux[:, d:d + 1].abs())
            / (1e-7 + aux[:, nd + d:nd + d + 1]))

    Rc = euler_pass_b(fluid, Pc, du_cs, nu_cs, bt.meta, bt.nbr_table,
                      high_order=high_order)

    # 2:1 interface corrections for pass B
    for d in range(nd):
        if not _has_ifc(bt, d):
            continue

        def face_B(Wo, Wn, ho, hn, d=d):
            Po, Pn = Wo[..., 0:5], Wn[..., 0:5]
            duo, dun = Wo[..., 5:10], Wn[..., 5:10]
            Do, Dn = Wo[..., 10:11], Wn[..., 10:11]
            down, dneigh = ho / 2, hn / 2
            grad_f = (Pn - Po) / (down + dneigh)
            slope_o = (2 * duo - grad_f) * down
            slope_n = (2 * dun - grad_f) * dneigh
            lim = bo.minmod(slope_n, slope_o)
            PL = Po + lim
            PR = Pn - lim
            D = torch.maximum(Do, Dn).clamp(min=1e-7)
            uf = (Po * dneigh + Pn * down) / (down + dneigh)
            if high_order:
                uf = uf + (duo * down - dun * dneigh) / 8
            PL = PL * D + (1.0 - D) * uf
            PR = PR * D + (1.0 - D) * uf
            return -inviscid_fluxes_hll(fluid, PL, PR, d)

        fetchB = _cs_edge_fetch(
            bt, [Pc, du_cs, nu_cs], d,
            channel_slice=[None, (d * 5, (d + 1) * 5), None])
        cols = bo.interface_corrections(bt, d, face_B, [1.0] * ncomp, fetchB)
        _cols_add_cs(bt, Rc, cols, d, 0, ncomp)

    if with_dt:
        return Rc, aux[:, 2 * nd:2 * nd + 1] + aux[:, 2 * nd + 1:2 * nd + 2] \
            + aux[:, 2 * nd + 2:2 * nd + 3]
    return Rc


def rk2_step_cs(bt: BlockTables, fluid: Fluid, Pc, apply_bcs_cs: Callable,
                *, cfl: float = 0.8, high_order: bool = True,
                active_cs=None):
    """Local-dt TVD-RK2 pseudo step on the channel-split state (reference
    semantics ``src/ImmersedBoundary.jl:873-1157``). ``apply_bcs_cs`` maps
    a cs grid to a cs grid; ``active_cs``: f32[B, 1, bs, bs*bs] 0/1 freeze
    mask. Returns (P2, resnorm)."""
    R0, dtb = euler_rhs_cs(bt, fluid, Pc, high_order=high_order,
                           with_dt=True)
    P1 = apply_bcs_cs(rk2_update(fluid, Pc, R0, None, dtb, active_cs, cfl))
    R1 = euler_rhs_cs(bt, fluid, P1, high_order=high_order)
    P2 = apply_bcs_cs(rk2_update(fluid, Pc, R0, R1, dtb, active_cs, cfl))
    resnorm = R0[:, 0].abs().max()
    return P2, resnorm
