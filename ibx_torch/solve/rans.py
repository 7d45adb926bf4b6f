"""Reusable RANS (Navier-Stokes + Wray-Agarwal) pseudo-time stepper
(counterpart of `ibx/solve/rans.py`).

Assembles the reference's RANS ingredients (viscous fluxes
``src/cfd.jl:664-736``, Wray-Agarwal transport ``src/turbulence.jl:222-241``,
wall functions ``src/turbulence.jl:27-98``) into a TVD-RK2 local-dt march,
on either the generic gather operators or the dense block path. Shared by
the RAE2822 RANS case and the flat plate.

Every op is a torch op: `euler_rhs_grid` takes its torch-op body under
``viscous`` (no kernel of `ibx_torch.ops.kernels` lies on either march, as
no Pallas kernel does in the JAX package). The marches are plain Python
loops over the step; the block march keeps the fused ``[B, bs.., nch+1]``
state (``[p T u.. Rt]``) between steps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from ..ops import operators as ops
from ..ops.block_ops import (cell_gradient_grid, euler_rhs_grid,
                             face_accumulate, to_blocks, to_flat)
from ..physics.fluid import (
    dynamic_viscosity,
    physicality_guard,
    primitive2state,
    speed_of_sound,
    state2primitive,
)
from ..physics.turbulence import shear_rate, wray_agarwal
from ..solve.euler import euler_rhs
from ..utils.graphs import Graphs, march_loop


@dataclasses.dataclass
class RansMarch:
    step: Callable       # (P, Rt) -> (P, Rt, resnorm)
    march: Callable      # (P, Rt, n, graph=None) -> (P, Rt)
    apply_bcs: Callable  # (P, Rt) -> (P, Rt)


def _dt_bound(bt, bound, nu_dt):
    """``bound`` plus the viscous bound 4 nu / h^2 of every dim."""
    for d in range(bt.nd):
        hcol = bt.h[:, d].reshape((bt.n_blocks,) + (1,) * bt.nd)
        bound = bound + 4.0 * nu_dt / (hcol * hcol)
    return bound


def rans_rhs_grid(bt, fluid, S3, *, cfl: float, high_order: bool = True,
                  closure: str = "wray_agarwal", d_wall3=None,
                  l_cap3=None):
    """RANS right-hand side on the block-grid state.

    ``S3`` is the fused [B, bs.., nch+1] state ([p T u.. Rt]), on any
    `BlockTables`. Returns ``(R_flow [.., nch], T3 [..] dRt/dt, dt3 [..])``.

    ``closure``: ``"wray_agarwal"`` (default, the reference's simplified
    one-equation model) or ``"mixing_length"``, the JAX package's flagged
    deviation: Prandtl mixing-length eddy viscosity ``nu_t = (kappa
    d_wall)^2 S`` with ``l = min(kappa d, l_cap)``; it needs ``d_wall3``
    (wall distance [B, bs..]), takes ``l_cap3`` (same shape) and freezes
    the Rt channel (T3 = 0). See the JAX package's docstring for the
    measurements behind the flag.
    """
    nd = bt.nd
    nch = 2 + nd
    P3 = S3[..., :nch]
    Rt3 = S3[..., nch:nch + 1]
    Rt_pos = Rt3.clamp(min=0.0)
    rho3 = P3[..., 0:1] / (fluid.R * P3[..., 1:2].clamp(min=10.0))

    if closure == "mixing_length":
        assert d_wall3 is not None, "mixing_length needs wall distances"
        # S from pre-pass velocity gradients: mu_t must exist before the
        # viscous fluxes are assembled
        vg0 = [[cell_gradient_grid(bt, P3[..., 2 + i:3 + i], j)[..., 0]
                for j in range(nd)] for i in range(nd)]
        S0 = shear_rate(vg0)
        l_mix = 0.41 * d_wall3
        if l_cap3 is not None:
            l_mix = torch.minimum(l_mix, l_cap3)
        nu_t3 = l_mix ** 2 * S0
        mu_t3 = rho3 * nu_t3[..., None]
        R_flow, dta, _ = euler_rhs_grid(
            bt, fluid, P3, with_dt=True, cfl=cfl,
            high_order=high_order, viscous=True, mu_t3=mu_t3)
        nu_lam3 = dynamic_viscosity(fluid, P3[..., 1]) / rho3[..., 0]
        bound = _dt_bound(bt, cfl / dta, nu_lam3 + nu_t3)
        return R_flow, torch.zeros_like(S0), cfl / bound

    mu_t3 = rho3 * Rt_pos
    R_flow, dta, (du_grids, nu3) = euler_rhs_grid(
        bt, fluid, P3, with_dt=True, cfl=cfl,
        high_order=high_order, viscous=True, mu_t3=mu_t3)
    vg = [[du_grids[j][..., 2 + i] for j in range(nd)]
          for i in range(nd)]
    S = shear_rate(vg)
    dRt = [cell_gradient_grid(bt, Rt3, d) for d in range(nd)]
    gS = [cell_gradient_grid(bt, S[..., None], d) for d in range(nd)]
    wa = wray_agarwal(Rt_pos[..., 0], S, torch.cat(dRt, dim=-1),
                      torch.cat(gS, dim=-1))
    nu_lam3 = dynamic_viscosity(fluid, P3[..., 1]) / rho3[..., 0]
    nu_eff3 = nu_lam3 + wa["nu_R"]

    def face_T(Wo, Wn, ho, hn):
        """Upwinded MUSCL advection of Rt (JST-blended) minus its
        diffusion, at one face."""
        Rto, Rtn = Wo[..., 0:1], Wn[..., 0:1]
        go, gn = Wo[..., 1:2], Wn[..., 1:2]
        Do, Dn = Wo[..., 2:3], Wn[..., 2:3]
        uo, un_ = Wo[..., 3:4], Wn[..., 3:4]
        no, nn = Wo[..., 4:5], Wn[..., 4:5]
        down, dneigh = ho / 2, hn / 2
        grad_f = (Rtn - Rto) / (down + dneigh)
        slope_o = (2 * go - grad_f) * down
        slope_n = (2 * gn - grad_f) * dneigh
        lim = ops.minmod(slope_n, slope_o)
        RtL = Rto + lim
        RtR = Rtn - lim
        D = torch.maximum(Do, Dn).clamp(min=1e-7)
        uf_c = (Rto * dneigh + Rtn * down) / (down + dneigh)
        if high_order:
            uf_c = uf_c + (go * down - gn * dneigh) / 8
        RtL = RtL * D + (1.0 - D) * uf_c
        RtR = RtR * D + (1.0 - D) * uf_c
        uf = (uo * dneigh + un_ * down) / (down + dneigh)
        F_adv = torch.where(uf >= 0.0, RtL, RtR) * uf
        nu_f = (no * dneigh + nn * down) / (down + dneigh)
        return F_adv - nu_f * grad_f

    T3 = wa["S"]
    for d in range(nd):
        W = torch.cat([Rt3, dRt[d], nu3, P3[..., 2 + d:3 + d],
                       nu_eff3[..., None]], dim=-1)
        T3 = T3 - face_accumulate(bt, d, W, face_T, 1, [1.0])[..., 0]

    # local dt: acoustic bound from the fused pass + viscous bound
    bound = _dt_bound(bt, cfl / dta, nu_lam3 + Rt_pos[..., 0])
    return R_flow, T3, cfl / bound


def rans_rk2_grid(bt, fluid, S3, apply_bcs3, *, cfl: float,
                  high_order: bool = True, active3=None,
                  rhs_fn=None):
    """One grid-native RANS TVD-RK2 pseudo step on the fused state.

    ``rhs_fn(S3) -> (R_flow, T3, dt3)`` defaults to `rans_rhs_grid` on
    ``bt``; the sharded path passes its halo-exchanging wrapper.
    ``apply_bcs3`` maps a fused grid to a fused grid (it may write in
    place: it only ever gets a new tensor). Returns (S2, resnorm)."""
    nch = 2 + bt.nd
    if rhs_fn is None:
        def rhs_fn(S):
            return rans_rhs_grid(bt, fluid, S, cfl=cfl,
                                 high_order=high_order)
    P3 = S3[..., :nch]
    Rt3 = S3[..., nch:nch + 1]
    R0, T0, dt = rhs_fn(S3)
    if active3 is not None:
        dt = dt * active3
    Q0 = primitive2state(fluid, P3)
    P1 = physicality_guard(
        state2primitive(fluid, Q0 + dt[..., None] * R0))
    Rt1 = Rt3 + dt[..., None] * T0[..., None]
    S1 = apply_bcs3(torch.cat([P1, Rt1], dim=-1))
    R1, T1, _ = rhs_fn(S1)
    P2 = physicality_guard(state2primitive(
        fluid, Q0 + dt[..., None] * (R0 + R1) / 2))
    Rt2 = Rt3 + dt[..., None] * (T0 + T1)[..., None] / 2
    S2 = apply_bcs3(torch.cat([P2, Rt2.clamp(min=0.0)], dim=-1))
    resnorm = (R0[..., 0] * (active3 if active3 is not None
                             else 1.0)).abs().max()
    return S2, resnorm


def build_rans_march(
    dom,
    fluid,
    *,
    cfl: float,
    active,                      # f32[N] 1=fluid, 0=in-solid
    flat_bcs: Sequence,          # [(family, fn(bdry, Pi, Rti)->(Pb, Rtcol))]
    blocked_bcs: Optional[Dict[str, Callable]] = None,  # name -> fn(Si, nrm)
    high_order: bool = True,
    use_blocks: bool = True,
    dense_families: Optional[Sequence[str]] = None,
    closure: str = "wray_agarwal",
    wall_distance=None,          # f32[N], required for closure="mixing_length"
    mixing_length_cap=None,      # f32[N] optional outer cutoff l_max
) -> RansMarch:
    """The RANS march of ``dom`` (one partition) on its device.

    ``flat_bcs`` is the gather march's BC, family by family through
    `Domain.impose_bc` over (P, Rt); it is also the returned ``apply_bcs``
    on both marches, as in the JAX package. ``use_blocks`` takes the block
    march, whose ghost BC is one `GhostBC` over the fused state with
    ``blocked_bcs`` as its callbacks (``dense_families`` is accepted and
    ignored, see `GhostBC.from_numpy`). ``march(P, Rt, n, graph=None)``
    runs the step captured in a CUDA graph on a CUDA state unless
    ``graph=False``, and the eager loop on the CPU (`utils.graphs`)."""
    nd = dom.nd
    nch = 2 + nd
    dev = dom.device

    def dev_f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    active = dev_f32(active)
    d_wall = l_cap = None
    if closure == "mixing_length":
        assert wall_distance is not None, "mixing_length needs wall_distance"
        d_wall = dev_f32(wall_distance)
        if mixing_length_cap is not None:
            l_cap = dev_f32(mixing_length_cap)

    graphs = Graphs()

    def apply_bcs(P, Rt):
        Rt2 = Rt[:, None]
        for fam, fn in flat_bcs:
            P, Rt2 = dom.impose_bc(fam, fn, P, Rt2)
        return P, Rt2[:, 0]

    if use_blocks:
        from ..convert import tables_from_numpy
        from ..topology.blocked_bc import _collect_families
        from ..topology.blocks import build_block_tables

        names = [fam for fam, _ in flat_bcs]
        bt, gbc = tables_from_numpy(
            build_block_tables(dom), _collect_families(dom, names), names,
            dev, dense_families=dense_families)

        def grid(a):
            return None if a is None else to_blocks(bt, a[:, None])[..., 0]

        active3, d_wall3, l_cap3 = grid(active), grid(d_wall), grid(l_cap)

        def guard_b(g):
            return torch.cat([physicality_guard(g[:, :nch]),
                              g[:, nch:nch + 1].clamp(min=0.0)], dim=1)

        def apply_bcs3(S3):
            return gbc.apply_grid(S3, blocked_bcs, guard=guard_b)

        def rhs3(S):
            return rans_rhs_grid(bt, fluid, S, cfl=cfl,
                                 high_order=high_order, closure=closure,
                                 d_wall3=d_wall3, l_cap3=l_cap3)

        def one_step3(S3):
            return rans_rk2_grid(bt, fluid, S3, apply_bcs3, cfl=cfl,
                                 high_order=high_order, active3=active3,
                                 rhs_fn=rhs3)

        def fused(P, Rt):
            return to_blocks(bt, torch.cat([P, Rt[:, None]], dim=1))

        def split(S3):
            Sf = to_flat(bt, S3)
            return Sf[:, :nch].contiguous(), Sf[:, nch].contiguous()

        def step(P, Rt):             # flat-state wrapper over the grid step
            S2, res = one_step3(fused(P, Rt))
            return split(S2) + (res,)

        def march(P, Rt, n, graph=None):
            # grid-native: the state stays [B, bs.., nch+1] through the loop
            return split(march_loop(graphs, "block", one_step3,
                                    fused(P, Rt), n, graph))

        return RansMarch(step=step, march=march, apply_bcs=apply_bcs)

    part = dom.partitions[0]

    def mixing_nu_t(P):
        """Prandtl mixing-length eddy viscosity (the flagged arm)."""
        grad0 = ops.cell_gradient(part, P)
        vg0 = [[grad0[j][:, 2 + i] for j in range(nd)] for i in range(nd)]
        l0 = 0.41 * d_wall
        if l_cap is not None:
            l0 = torch.minimum(l0, l_cap)
        return l0, shear_rate(vg0)

    def rans_rhs(P, Rt):
        """(dQ/dt, dRt/dt): NS + turbulence closure."""
        Rt_pos = Rt.clamp(min=0.0)
        rho = P[:, 0] / (fluid.R * P[:, 1].clamp(min=10.0))
        if closure == "mixing_length":
            l0, S0 = mixing_nu_t(P)
            mu_t = rho * l0 ** 2 * S0
            R_flow = euler_rhs(part, fluid, P, high_order=high_order,
                               viscous=True, mu_t=mu_t)
            return R_flow, torch.zeros_like(Rt)
        mu_t = rho * Rt_pos
        R_flow = euler_rhs(part, fluid, P, high_order=high_order,
                           viscous=True, mu_t=mu_t)

        grad = ops.cell_gradient(part, P)
        vg = [[grad[j][:, 2 + i] for j in range(nd)] for i in range(nd)]
        S = shear_rate(vg)
        dRt = ops.cell_gradient(part, Rt)
        gS = ops.cell_gradient(part, S)
        wa = wray_agarwal(
            Rt_pos, S, torch.stack(dRt, dim=1), torch.stack(gS, dim=1))
        nu_lam = dynamic_viscosity(fluid, P[:, 1]) / rho
        nu_eff = nu_lam + wa["nu_R"]

        nujst = ops.jst_sensor(part, P[:, 0])
        dRt_dt = wa["S"]
        for d in range(nd):
            RtL, RtR = ops.muscl(part, Rt, dRt[d], d, D=nujst,
                                 high_order=high_order)
            uf = ops.at_faces(part, P[:, 2 + d], d)
            F = torch.where(uf >= 0.0, RtL, RtR) * uf
            dRt_dt = dRt_dt - ops.green_gauss(part, F, d)
            nu_f = ops.at_faces(part, nu_eff, d)
            dRt_dt = dRt_dt + ops.green_gauss(
                part, nu_f * ops.face_gradient(part, Rt, d), d)
        return R_flow, dRt_dt

    def local_dt(P, Rt):
        a_loc = speed_of_sound(fluid, P[:, 1])
        rho = P[:, 0] / (fluid.R * P[:, 1].clamp(min=10.0))
        if closure == "mixing_length":
            l0, S0 = mixing_nu_t(P)
            nu_turb = l0 ** 2 * S0
        else:
            nu_turb = Rt.clamp(min=0.0)
        nu_eff = dynamic_viscosity(fluid, P[:, 1]) / rho + nu_turb
        bound = torch.zeros(P.shape[0], dtype=P.dtype, device=P.device)
        for d in range(nd):
            s = P[:, 2 + d].abs() + a_loc
            bound = bound + ops.unsigned_green_gauss(
                part, ops.at_faces(part, s, d), d)
            h = part.spacing[:, d]
            bound = bound + 4.0 * nu_eff / (h * h)
        return cfl / bound

    def step(P, Rt):
        dt = local_dt(P, Rt) * active
        R0, T0 = rans_rhs(P, Rt)
        Q0 = primitive2state(fluid, P)
        P1 = physicality_guard(state2primitive(fluid, Q0 + dt[:, None] * R0))
        Rt1 = Rt + dt * T0
        P1, Rt1 = apply_bcs(P1, Rt1)
        R1, T1 = rans_rhs(P1, Rt1)
        P2 = physicality_guard(state2primitive(
            fluid, Q0 + dt[:, None] * (R0 + R1) / 2))
        Rt2 = Rt + dt * (T0 + T1) / 2
        P2, Rt2 = apply_bcs(P2, Rt2.clamp(min=0.0))
        resnorm = (R0[:, 0] * active).abs().max()
        return P2, Rt2, resnorm

    def one(X):
        P2, Rt2, res = step(*X)
        return (P2, Rt2), res

    def march(P, Rt, n, graph=None):
        return march_loop(graphs, "gather", one, (P, Rt), n, graph)

    return RansMarch(step=step, march=march, apply_bcs=apply_bcs)
