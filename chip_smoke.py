#!/usr/bin/env python3
"""Smoke run of the ibx_torch port on one NVIDIA GPU (an H100 is the
target).

    python3 chip_smoke.py

Every `case.march` on the card runs the step captured in a CUDA graph and
replayed (`ibx_torch.utils.graphs`, the default on a CUDA state; the
counterpart of the JAX package's `jit` over `fori_loop`); phase 30 holds
each captured march against its eager loop (``graph=False``). Phases, in
order; any failure ends the run with a non-zero exit:
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: compile the CUDA kernels of ibx_torch/csrc with nvcc;
  3. kernel parity: each kernel (pass A with and without dt, pass B in
     both variants, without and with the 2:1 fold, both `high_order`)
     against its plain PyTorch version on the same CUDA tensors, on the
     bs=4 sphere (a smooth perturbation of the flow), the bs=8 sphere
     (wall_h=0.125) and the full bs=16 sphere tables, each with 2:1
     interfaces on every side of every dim; and the folded `euler_rhs_cs`
     against the pre-added one on the same state;
  4. whole-step parity: one RK2 step of the bs=4 sphere on the card
     (kernels) against the same step on the CPU (plain versions): the
     channel-split step, the grid step with the fold, and the grid step
     with frozen gradients (its stage 2 on the torch-op body);
  5. main path: `build_sphere3d(wall_h=0.03, cfl=0.5, block_size=16)` on
     the card (5,308,416 cells), 2 warm-up steps (the first call
     captures the step), then 100 steps of `case.march` (channel-split)
     timed with CUDA events; each of its three kernels must have been
     launched twice a step, the fold never (the counts of a captured step
     are added on every replay);
  6. grid path: from the same case, 2 warm-up steps, then 20 steps of
     `case.march(..., grid=True, fold=True)`; a step must launch pass A
     twice, pass B once in each variant and the update kernel never;
  7. per-kernel times at the main path's shapes (CUDA events over 20
     launches) beside the plain version's time and the kernel's bound,
     each kernel's registers, spills and shared memory (ptxas's build log
     and the launch's dynamic size), and a breakdown of one step of each
     march;
  8. 2D step parity: `build_rae2822(wall_h=8e-2, feature_h=4e-2, cfl=0.7)`
     on the card and on the CPU, one step from a perturbed state (plain,
     with `te_fix_radius=0.3`, with `irs_eps=0.5`); the same torch ops run
     on both devices, and no kernel may be launched;
  9. 2D main path at full width: `build_rae2822(wall_h=5e-4,
     feature_h=2.5e-4, cfl=0.7, block_size=16)` on the card (881,152
     cells), restarted from the converged state of
     tests/data/rae2822_cp_flagship.npz, 2 warm-up steps, then two windows
     of 500 steps of `case.march` timed with CUDA events and the host
     clock; all four kernel counters must stay 0 (the 2D arm has no kernel
     in either package), Cl must lie in the committed band and the
     windows' mean wall Cp must reproduce the oracle's phase mean;
 10. 2D breakdown: the parts of one step (CUDA events and the host's
     enqueue time over 20 calls each) and the card's busy share of a
     5-step window from `torch.profiler`;
 11. gather step parity: `build_rae2822(wall_h=8e-2, feature_h=4e-2,
     cfl=0.7, use_blocks=False)` on the card and on the CPU, one
     `case.step` of the generic gather march (`solve.euler.rk2_step` on
     `dom.partitions[0]` with the fused ghost BC) from a perturbed state;
 12. gather vs block on the card, same fixture: `euler_rhs` against
     `euler_rhs_block`, `local_timestep` against the block dt, 5 steps of
     both marches, and the viscous pair with an `mu_t` field;
 13. the gather march at full width: `build_rae2822(wall_h=5e-4,
     feature_h=2.5e-4, cfl=0.7, block_size=16, use_blocks=False)` (881,152
     cells) restarted from the oracle's state, 2 warm-up steps, then 150
     steps timed with CUDA events and the host clock; Cl in the committed
     band, the four kernel counters 0, peak memory, and the card's busy
     time a step from `torch.profiler`, printed beside the block march's
     numbers of phases 9 and 10;
 14. 3D gather: one `build_sphere3d(wall_h=0.25, block_size=4,
     use_blocks=False)` step card vs CPU, and 3 steps of it against the
     grid march of the block case;
 15. four partitions: `dom.map` of `euler_rhs` over `Domain(n_partitions=4)`
     on the card equals the one-partition result;
 16. the 3D gather march at full width (right after phase 26): the
     gather case of `build_sphere3d(wall_h=0.03, cfl=0.5, block_size=16,
     use_blocks=False)` (5,308,416 cells) made on phase 5's domain (its
     fused ghost BC and partition tables), 2 warm-up steps, then 10 steps
     timed, the counters 0, and the card's busy time a step, printed
     beside the block marches of phases 5 and 6;
 17. RANS step parity: `build_rae2822_rans(wall_h=8e-2, feature_h=4e-2,
     block_size=8)` on the card and on the CPU, one `case.step` from a
     perturbed (P, Rt) on the block march and on the gather march;
 18. RANS block vs gather on the card at wall_h=4e-2 (67,072 cells): the
     initial states and 5 steps of each march;
 19. the reference's physical checks, there marched on the CPU: the RANS
     airfoil at wall_h=2e-2 (87,040 cells), 310 steps (the reference's
     400; finite, eddy viscosity developed, stagnation and suction Cp,
     mid-chord Cf) with the residual of step 302 below that of step 1; the
     flat plate at wall_h=1e-2, 300 steps, Cf within 0.2-5x Prandtl; the
     low-y+ plate (wall_h=4e-3), 400 steps (the reference's 800), no
     pressure collapse;
 20. RANS at the cases' default sizes: `build_rae2822_rans()` (242,176
     cells) and `build_flat_plate()` (105,984 cells), each on the block and
     the gather march, 2 warm-up steps then 50 steps timed with CUDA
     events and the host clock, the card's busy time a step from
     `torch.profiler`, build s and peak memory, Cl/Cd and mid-chord Cf for
     the airfoil, and the four kernel counters 0 (no kernel lies on RANS);
 21. solver parity, card vs CPU, at wall_h=8e-2: on the gather case, a
     `FasEuler(max_levels=2)` a smoother ("euler" at cfl 0.5, "rk2" at
     0.7) built by the BC recipe of tests/test_fas_euler.py: each transfer
     stencil applied, `_f` at every level and one `cycle(n_iter=2)`; on
     the block case, `_block_inv` of seeded blocks, the point-implicit map
     ``g`` and its JVP, and `solve` with the CPU's preconditioner;
 22. the FAS verdict of scripts/fas_verdict2d.py, counted in calls:
     `build_rae2822(wall_h=2e-2, feature_h=1e-2, cfl=0.7, mach=0.4)`,
     `FasEuler(max_levels=3, smoother="rk2", cfl=0.7)`, 20 calls of
     `smooth_only` and 20 of `cycle` (the script's 30; n_iter=25,
     rtol=1e-6) from the same
     freestream state, the functional L2 of dt*R over the solved cells
     after each call; fas3 must reach 0.3x its peak, in at most 1/1.5 of
     smoothing's calls where smoothing reaches it too, and end under a
     third of smoothing's final ratio (tests/test_fas_verdict.py's
     margins), with the card's seconds a call;
 23. the slice at full width (881,152 cells): FAS-Euler on the gather
     march at M 0.4 (the 3-level hierarchy with each level's cells and
     build s; 5 cycles against 5 smoothing calls of n_iter=10:
     tests/test_fas_euler.py's residual and physical-range checks; ms a
     call, peak memory, the card's busy time for one cycle); then 2
     `point_implicit_step`s (cfl 5, relax 0.8, the freeze mask, the
     frozen limiter: the exact one's Jacobian leaves float32 beside the
     wall there, its non-finite rows are printed) on the block march from
     the oracle's state, each with a linear ratio under 1
     and a finite state, the solved-cell residual under 3x its start
     (tests/test_point_implicit_euler.py), ms a step; the four kernel
     counters stay 0 over phases 21-23;
 24. the multi-device runtime on four ranks (after phase 23): four gloo
     ranks spawned on the one card (NCCL refuses two ranks on one device),
     each with its own process: `build_rae2822_block_sharded(4)` at
     wall_h=4e-2, 5 steps against the single-device block march on the
     card, plain and with `overlap=True` (2e-5 per channel, resnorm 1e-3,
     no kernel launched); `build_rae2822_sharded(4)` 3 steps against its
     step on one partition (1e-5); `build_sphere3d_block_sharded(4)`
     (wall_h=0.1, bs=8) on the channel-split march, 1 step (1e-4) and 5
     steps (1e-3) against the single-device march, each rank launching
     passes A and B and the update twice a step and the fold never, passes
     A and B against their plain versions on each rank's local grid; each
     rank prints its local grid, halo and offsets and times its exchange;
     then the four-rank part of phase 27;
 25. the flagship on one rank (in phase 10's place, NCCL, this process):
     `build_rae2822_block_sharded(1, case=<phase 9's case>, overlap=True)`
     from the oracle's state, 2 warm-up and 100 timed steps, Cl in the
     band, no kernel launched, ms a step, peak memory and the card's busy
     time beside phases 9 and 10;
 26. the production sphere on one rank (after phase 7, NCCL, this
     process): `build_sphere3d_block_sharded(1, case=<phase 5's case>)`,
     2 warm-up and 20 timed steps launching 2/2/2 kernels a step and no
     fold, ms a step, busy time (beside the single-device march's) and
     peak memory, and 5 steps within 1e-6 of the single-device
     channel-split march;
 27. the 3D RANS wing with FAS (workload 5) at tests/test_wing3d_fas.py's
     size (4096 cells): `build_wing3d_rans_fas(1)` on the card against
     the same on the CPU (one rank each, this process), 2 steps and one
     FAS cycle (flow 1e-4 per channel, Rt 1e-3 of max |Rt|), then the JAX
     test's physical check on the card (twice 20 steps and a cycle:
     finite, p, T and Rt in range); inside phase 24's four gloo ranks,
     `build_wing3d_rans_fas(4)` on the card against the one rank, 10
     steps under 2e-5 and one cycle under 5e-5 (the JAX test's bounds);
 28. the wing at its defaults (466,432 cells) on one NCCL rank (this
     process) from the converged state of tests/data/wing3d_oracle.npz:
     its wall Cp and Cl against the oracle's (1e-4), 100 steps with Cl in
     the oracle's tail band (mean +- 3 sigma + 1e-4 of the last quarter
     of its history) and res_norms L2 within 0.5-2x the oracle's last,
     one FAS cycle finite and physical; ms a step and a cycle, the card's
     busy time, build s and peak memory;
 29. the block march's walls: `build_rae2822(mirror_wall=True)` and
     `build_rae2822(cutcell=True)` at wall_h=8e-2, one step card vs CPU
     (1e-4); the 881,152-cell flagship with `cutcell=True`, 50 steps from
     the freestream: finite, ms a step, the card's busy time, build s;
     the four kernel counters stay 0 over phases 27-29;
 30. the compiled march against the eager loop, on the full-width cases
     of the phases above (the sphere after phase 26: channel-split, grid
     with and without the fold, grid with frozen gradients; its gather
     march in phase 16; the flagship's block march and `march_robust`
     after phase 10, its gather march after phase 13; both RANS cases on
     both marches in phase 20, before their first march): 5 captured
     steps against 5 eager ones, bit-equal (or within eager's own spread,
     at most 1e-6, where eager differs from eager); launches a step by the
     counters and by the kernels' names in a `torch.profiler` trace of one
     replay, equal to eager's (3D channel-split 2/2/2, grid with the fold
     pass A 2, pass B 1, fold 1; every 2D and RANS march 0); ms a step
     and the card's busy ms a step each way; peak memory each way and the
     memory the captured step keeps;
 31. the point-implicit step at nd = 3 (after phase 16): the bs=8 sphere
     (wall_h=0.125), ``g`` at Q_n and its JVP with the frozen limiter card
     vs CPU (1e-4), then one step on the card (cfl 5, relax 0.8, the
     freeze mask): finite, linear ratio under 1, its seconds; the
     explicit bound at Q_n launches pass A and pass B once, the
     differentiated residual no kernel;
 32. the padded formulation of `face_accumulate` against concat
     (`block_ops._PADDED_FACES`), eager: bit-equal over 3 steps and the
     card's busy ms a step of each, traced in turns, on the flagship's
     block march (after phase 30 there) and on the sphere's grid march
     with the fold and with frozen gradients (after phase 30 there);
then one JSON line of per-kernel numbers (with each kernel's launches a
step on the sharded channel-split march), the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.

It exits non-zero without printing a result when no CUDA device is
available or when the ibx_torch package is not beside it.
"""

from __future__ import annotations

import contextlib
import gc
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks from NVIDIA's data sheet (full 700 W power limit): HBM
# bytes/s and float32 FLOP/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

# Tolerances on the per-channel-scaled max error (max |kernel - plain| over
# max |plain|, per output channel). The kernels and their plain versions
# evaluate the same expressions in float32, but nvcc contracts a*b + c into
# one FMA (one rounding instead of two) and the plain version runs each op
# as its own rounded kernel: rk2_update has no cancellation beyond a few
# ulp (1e-6); the pass-A sensor sums and dt bound are sums of face averages
# (1e-5); du and R are differences of face values divided by h, which
# magnify a last-ulp face difference (1e-4, the repo's kernel-vs-XLA
# tolerance in tests/test_pallas_rhs.py).
TOL = {"rk2_update": 1e-6, "aux": 1e-5, "du": 1e-4, "R": 1e-4}
STEP_TOL = 1e-4          # whole step, card vs CPU, per channel
RES_TOL = 1e-4           # resnorm, relative
# 2D flagship march from the committed converged state: Cl band of
# tests/test_rae2822_regression.py (the 32k-step window study), and the
# mean |dCp| of two 500-step windows' mean against the oracle's 8-phase
# mean: measured 4.2e-3 on the H100 (one 500-step window carries about
# 8.5e-3 of cycle noise by the committed window study); the limit is twice
# the measurement
CL_BAND = (0.90, 0.93)
DCP_TOL = 8.5e-3
RAE_FLAGSHIP = dict(wall_h=5e-4, feature_h=2.5e-4, cfl=0.7, block_size=16)
RAE_CELLS = 881_152
RAE_ORACLE = "tests/data/rae2822_cp_flagship.npz"
RAE_WINDOW = 500
GATHER_STEPS = 150
# gather vs block (the limits of tests/test_block_ops.py and
# tests/test_viscous.py): R per channel over the channel's max + 1e-3
GVB_RHS_TOL = 2e-4
GVB_DT_RTOL = 1e-4
GVB_STEPS_TOL = 1e-3
# one gather step, card vs CPU: the same torch ops on both devices
GATHER_STEP_TOL = 1e-5
# RANS (phases 17-20): the parity fixture of tests/test_torch_rans.py, the
# block-vs-gather fixture and the physical-check sizes of tests/test_rans.py
# and tests/test_flat_plate.py, and the cases' default sizes
RANS_SMALL = dict(wall_h=8e-2, feature_h=4e-2, block_size=8)
RANS_RT_TOL = 1e-3       # Rt after one step, of max |Rt|
RANS_GVB = dict(wall_h=4e-2, feature_h=2e-2)
RANS_GVB_STEPS = 5
RANS_REF = dict(wall_h=2e-2, feature_h=1e-2, reynolds=6.5e6, cfl=0.5)
RANS_REF_CELLS = 87_040
PLATE_REF = dict(wall_h=1e-2, length=1.25, height=0.5, reynolds=6e5)
PLATE_LOWYP = dict(wall_h=4e-3, reynolds=6e5, length=1.25, height=0.5,
                   mach=0.2, cfl=0.5)
RANS_REF_STEPS = 310     # the reference's 400, past the residual's step 302
PLATE_LOWYP_STEPS = 400  # the reference's 800
# solver acceleration (phases 21-23): card vs CPU on the wall_h=8e-2
# fixtures; the FAS verdict case of scripts/fas_verdict2d.py; the flagship
SOLVE_SMALL = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7)
FAS_SMOOTHERS = {"euler": 0.5, "rk2": 0.7}   # smoother -> cfl
TRANSFER_TOL = 1e-6      # a transfer applied, card vs CPU, relative
FAS_F_TOL = 1e-5         # FasEuler._f, card vs CPU, per channel
FAS_CYCLE_TOL = 1e-3     # one cycle(n_iter=2): state per channel, ratio
PI_TOL = 1e-4            # _block_inv, solve and the JVP of g, per channel
PI_CFL = 5.0             # tests/test_point_implicit_euler.py's settings
PI_RELAX = 0.8
VERDICT_CASE = dict(wall_h=2e-2, feature_h=1e-2, cfl=0.7, mach=0.4,
                    alpha_deg=2.31, use_blocks=False)
VERDICT_CALLS = 20           # scripts/fas_verdict2d.py's 30
VERDICT_ITERS = 25
FAS_FULL_CALLS = 5
FAS_FULL_ITERS = 10
PI_STEPS = 2
PI3D_STEPS = 5           # phase 31's state: steps from the freestream
# the multi-device runtime (phases 24-26)
SHARD_RANKS = 4
SHARD_RAE = dict(wall_h=4e-2, feature_h=2e-2, cfl=0.7)   # 21,760 cells
SHARD_STEPS = 5
SHARD_BLOCK_TOL = 2e-5   # 5 sharded block steps vs one device, per channel
SHARD_RES_RTOL = 1e-3
SHARD_GATHER_STEPS = 3
SHARD_GATHER_TOL = 1e-5
SHARD_SPHERE_WALL_H = 0.1    # bs=8, 348,160 cells
SHARD_SPHERE_TOL = {1: 1e-4, 5: 1e-3}
SHARD_FULL_STEPS = 100       # phase 25, the flagship on one rank
SHARD_SPHERE_STEPS = 20      # phase 26, the production sphere on one rank
SHARD_ONE_RANK_TOL = 1e-6    # one rank vs one device, 5 steps
RANS_CELLS = 242_176
PLATE_CELLS = 105_984
RANS_STEPS = 50
# the 3D RANS wing with FAS, workload 5 (phases 27-28): the size of
# tests/test_wing3d_fas.py:15 (4096 cells) and the case's defaults
# (466,432 cells) from the converged state of tests/data/wing3d_oracle.npz
WING_SMALL = dict(wall_h=0.25, span=0.5, farfield=2.0, block_size=8,
                  n_coarse_iter=4)
WING_SMALL_CELLS = 4096
WING_STEPS = 2               # card vs CPU: 2 steps and a cycle
WING_RANKS_STEPS = 10        # four ranks vs one: tests/test_wing3d_fas.py
WING_MARCH_TOL = 2e-5        # :31
WING_CYCLE_TOL = 5e-5        # :44
WING_ORACLE = "tests/data/wing3d_oracle.npz"
WING_CELLS = 466_432
WING_FULL_STEPS = 100
WING_CP_TOL = 1e-4           # wall Cp and Cl of the oracle's state
WING_CL_TOL = 1e-4
# the block march's mirror and cut-cell walls (phase 29)
WALLS_SMALL = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7)   # 16,768 cells
CUT_FULL_STEPS = 50

# the compiled march (phases 30-32): captured against eager, the padded
# face formulation against concat
GRAPH_STEPS = 5          # graphed vs eager steps, bit-equal
GRAPH_TIMED = 20         # steps timed each way
GRAPH_TOL = 1e-6         # where eager differs from eager (atomic sums)
PADDED_STEPS = 3         # eager steps a formulation, traced
GRAPH_ROWS = []          # one row a march of phase 30
PADDED_ROWS = []         # one row a march of phase 32

# float32 operations a cell, counted from the kernels' expressions
# (an add, mul, div, min/max, abs or sqrt each counts one)
# per dim: pass A 80 (+26 for the dt bound); pass B one face of 281 a cell
# and the block's far edge face, 281/bs (MUSCL and blend 37 a channel, HLL
# sides 44, flux 50: each face counted once, the work and not one way of
# doing it), plus 25 to mask and accumulate
# (the fold adds one add a corrected gradient load, a few thousand a block)
FLOPS_PER_CELL = {"rk2_update": 62, "euler_pass_a_dt": 3 * 106,
                  "euler_pass_a": 3 * 80}


def pass_b_flops(bs):
    return 3 * (281 + 281 / bs + 25)


def log(*a):
    print(*a, flush=True)


def chan_err(ref, out):
    """Max |out - ref| per channel (axis 1) over max |ref| of that channel
    (all-zero channels are held to their absolute error)."""
    red = tuple(i for i in range(ref.dim()) if i != 1)
    err = (out.double() - ref.double()).abs().amax(dim=red)
    scale = ref.double().abs().amax(dim=red)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return float((err / scale).max())


def max_abs(ref, out):
    return float((out.double() - ref.double()).abs().max())


def check(name, value, tol):
    ok = value < tol
    log(f"  {name}: {value:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {value:.3e} >= {tol:g}")


def perturbed(case, seed=3):
    """Flat state: the case's initial state with the smooth perturbation
    of tests/test_pallas_rhs.py (and a random w component)."""
    rng = np.random.default_rng(seed)
    P = case.P0.detach().cpu().numpy().copy()
    x = case.dom.centers
    P[:, 0] *= 1 + 0.05 * np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    P[:, 1] *= 1 + 0.03 * np.cos(1.5 * x[:, 2])
    P[:, 2] += 30 * np.sin(x[:, 1] + x[:, 2])
    P[:, 3] += 25 * np.cos(x[:, 0]) * np.sin(x[:, 2])
    P[:, 4] += 20 * rng.standard_normal(P.shape[0])
    return torch.as_tensor(P.astype(np.float32), device=case.P0.device)


def kernel_inputs(case, Pc):
    """The main path's operands for each kernel, derived from ``Pc``; the
    fold's (``du_f``, ``nu_f``, ``cols6``) are those of the grid march's
    plain-RHS call."""
    from ibx_torch.ops import kernels as K
    from ibx_torch.ops.rhs_cs import euler_rhs_cs, gradients_cs

    bt, fl = case.bt, case.fluid
    du, aux = K.euler_pass_a(fl, Pc, bt.meta, bt.nbr_table, with_dt=True)
    nu = torch.full_like(aux[:, :1], 1e-7)
    for d in range(3):
        nu = torch.maximum(nu, (1e-7 + aux[:, d:d + 1].abs())
                           / (1e-7 + aux[:, 3 + d:4 + d]))
    R0, dtb = euler_rhs_cs(bt, fl, Pc, with_dt=True)
    R1 = euler_rhs_cs(bt, fl, case.apply_bcs_cs(
        K.rk2_update(fl, Pc, R0, None, dtb, case.active_cs, case.cfl)))
    du_f, _, nu_f, cols6 = gradients_cs(bt, fl, Pc, with_dt=False,
                                        fold=True)
    assert cols6 is not None
    return dict(du=du, nu=nu, R0=R0, R1=R1, dtb=dtb, du_f=du_f, nu_f=nu_f,
                cols6=cols6)


def kernel_parity(case, Pc, label):
    """Each kernel vs its plain version on the same CUDA tensors; returns
    the max abs error of each kernel's reported variant."""
    from ibx_torch.ops import kernels as K
    from ibx_torch.ops.rhs_cs import euler_rhs_cs

    bt, fl = case.bt, case.fluid
    x = kernel_inputs(case, Pc)
    errs = {}
    log(f"[parity] {label}: {bt.n_blocks} blocks, bs={bt.block_size}")
    for with_dt in (True, False):
        du, aux = K.euler_pass_a(fl, Pc, bt.meta, bt.nbr_table,
                                 with_dt=with_dt)
        du_r, aux_r = K.euler_pass_a_ref(fl, Pc, bt.meta, bt.nbr_table,
                                         with_dt=with_dt)
        check(f"euler_pass_a du (with_dt={with_dt})", chan_err(du_r, du),
              TOL["du"])
        check(f"euler_pass_a aux (with_dt={with_dt})", chan_err(aux_r, aux),
              TOL["aux"])
        if with_dt:
            errs["euler_pass_a"] = max(max_abs(du_r, du), max_abs(aux_r, aux))
    # pass B under a sensor of 10^U(-7, 0) (as tests/test_torch_kernels.py):
    # the flow's own sensor is 1 on most faces, and the JST blend then
    # hides the high-order face value that `high_order` switches
    rng = np.random.default_rng(7)
    nu = torch.as_tensor((10.0 ** rng.uniform(-7, 0, tuple(x["nu"].shape)))
                         .astype(np.float32), device=Pc.device)
    for ho in (True, False):
        R = K.euler_pass_b(fl, Pc, x["du"], nu, bt.meta, bt.nbr_table,
                           high_order=ho)
        R_r = K.euler_pass_b_ref(fl, Pc, x["du"], nu, bt.meta,
                                 bt.nbr_table, high_order=ho)
        check(f"euler_pass_b R (high_order={ho})", chan_err(R_r, R), TOL["R"])
        Rf = K.euler_pass_b(fl, Pc, x["du_f"], nu, bt.meta,
                            bt.nbr_table, high_order=ho, cols6=x["cols6"])
        Rf_r = K.euler_pass_b_ref(fl, Pc, x["du_f"], nu, bt.meta,
                                  bt.nbr_table, high_order=ho,
                                  cols6=x["cols6"])
        check(f"euler_pass_b_fold R (high_order={ho}, "
              f"{x['cols6'][1].shape[0]} correction rows)",
              chan_err(Rf_r, Rf), TOL["R"])
        if ho:
            errs["euler_pass_b"] = max_abs(R_r, R)
            errs["euler_pass_b_fold"] = max_abs(Rf_r, Rf)
    for with_dt in (True, False):
        R_fold = euler_rhs_cs(bt, fl, Pc, with_dt=with_dt, fold=True)
        R_pre = euler_rhs_cs(bt, fl, Pc, with_dt=with_dt)
        if with_dt:
            R_fold, R_pre = R_fold[0], R_pre[0]
        check(f"euler_rhs_cs fold vs pre-add (with_dt={with_dt})",
              chan_err(R_pre, R_fold), TOL["R"])
    for stage2 in (False, True):
        R1 = x["R1"] if stage2 else None
        out = K.rk2_update(fl, Pc, x["R0"], R1, x["dtb"], case.active_cs,
                           case.cfl)
        ref = K.rk2_update_ref(fl, Pc, x["R0"], R1, x["dtb"], case.active_cs,
                               case.cfl)
        check(f"rk2_update (stage {2 if stage2 else 1})", chan_err(ref, out),
              TOL["rk2_update"])
        if stage2:
            errs["rk2_update"] = max_abs(ref, out)
    return errs


def time_both(fn, reps=20):
    """(ms by CUDA events, ms the host took to enqueue) per call of ``fn``
    over ``reps`` calls after one warm-up call. Where the two agree the
    host is the limit; where the enqueue is the shorter, the card is."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    host = time.perf_counter() - t0
    e1.synchronize()
    return e0.elapsed_time(e1) / reps, host / reps * 1e3


def time_ms(fn, reps=20):
    """Mean ms of ``fn`` over ``reps`` calls, CUDA events, after one
    warm-up call."""
    return time_both(fn, reps)[0]


def bound(n_cells, channels, flops_per_cell, n_blocks, extra_bytes=0):
    """Least time for the work: each input and output byte moved once (the
    per-block tables and ``extra_bytes`` of other operands included) at the
    HBM rate, or the float32 operations at the peak rate, whichever is
    larger."""
    nbytes = 4 * channels * n_cells + (16 * 4 + 8 * 4) * n_blocks \
        + extra_bytes
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops_per_cell * n_cells / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_resources():
    """Per kernel instantiation (name<template args>): registers, spill
    store and load bytes and static shared memory, from ptxas's lines in
    the build log."""
    from ibx_torch.ops import kernels as K

    res, name = {}, None
    for line in K.build_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"((?:euler_pass_[ab]|rk2_update)_kernel)"
                          r"(?:I((?:L[ib]\d+E)+)E)?", m.group(1))
            args = re.findall(r"L([ib])(\d+)E", k.group(2) or "")
            name = k.group(1) + ("<" + ", ".join(
                v if t == "i" else ("true" if v == "1" else "false")
                for t, v in args) + ">" if args else "")
            res[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            res[name]["spill"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            res[name]["static_smem"] = int(s.group(1)) if s else 0
    return res


def perturbed2d(case, seed=5):
    """Flat 2D state: the case's initial state with the perturbation of
    tests/test_block_ops.py plus independent noise in u and v (a transposed
    edge line would pass a smooth field)."""
    rng = np.random.default_rng(seed)
    P = case.P0.detach().cpu().numpy().copy()
    x, y = case.dom.centers[:, 0], case.dom.centers[:, 1]
    P[:, 0] *= 1.0 + 0.05 * np.sin(x) * np.cos(y)
    P[:, 1] *= 1.0 + 0.02 * np.cos(x)
    P[:, 2] += 20.0 * np.sin(y) + 5.0 * rng.standard_normal(P.shape[0])
    P[:, 3] += 10.0 * np.cos(x) + 5.0 * rng.standard_normal(P.shape[0])
    return torch.as_tensor(P.astype(np.float32), device=case.P0.device)


def profile_busy(fn, n_steps, tag, ms_step):
    """The card's busy time a step: device time of every CUDA kernel and
    copy that ``fn`` (``n_steps`` steps) launches under `torch.profiler`.
    Returns (device activities a step, busy ms a step, traced wall ms a
    step); ``ms_step`` is the untraced step the share is stated against."""
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    log(f"[{tag}] torch.profiler over {n_steps} steps (tracing on): "
        f"{len(ev)} device activities ({len(ev) / n_steps:.0f} a step), "
        f"device busy {busy_ms / n_steps:.3f} ms a step of "
        f"{wall_ms / n_steps:.3f} ms wall a step "
        f"({busy_ms / wall_ms:.1%} busy); against the untraced step of "
        f"{ms_step:.3f} ms the card is busy {busy_ms / n_steps / ms_step:.1%}")
    assert ev and busy_ms > 0, "torch.profiler recorded no device time"
    return len(ev) / n_steps, busy_ms / n_steps, wall_ms / n_steps


def rae2822_phases(root, dev, smi):
    """Phases 8-10: the 2D arm. It launches no kernel, so it adds no row
    to the kernels line; its counters are asserted to stay 0."""
    from ibx_torch.cases import (build_rae2822, force_coefficients,
                                 wall_cp)
    from ibx_torch.ops import kernels as K
    from ibx_torch.ops.block_ops import (euler_rhs_grid, to_blocks)
    from ibx_torch.physics.fluid import (primitive2state,
                                         state2primitive_guarded)

    zero = dict.fromkeys(K.launches, 0)

    # 8. 2D step parity, card vs CPU
    small = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7)
    for label, kw in (("reference numerics", {}),
                      ("te_fix_radius=0.3", dict(te_fix_radius=0.3)),
                      ("irs_eps=0.5", dict(irs_eps=0.5))):
        cg = build_rae2822(device=dev, **small, **kw)
        cc = build_rae2822(device="cpu", **small, **kw)
        P = perturbed2d(cg)
        K.reset_launches()
        Pg, rg = cg.step(P)
        Pc, rc = cc.step(P.cpu())
        log(f"[step2d] RAE2822 wall_h=8e-2 ({cg.dom.ncells} cells), one "
            f"step ({label}), card vs CPU")
        check("state (per channel)", chan_err(Pc, Pg.cpu()), STEP_TOL)
        check("resnorm (relative)",
              abs(float(rg) - float(rc)) / abs(float(rc)), RES_TOL)
        assert dict(K.launches) == zero, K.launches
    del cg, cc

    # 9. 2D main path at full width
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    case = build_rae2822(**RAE_FLAGSHIP)
    bt, fl = case.bt, case.fluid
    n_cells = case.dom.ncells
    n_ifc = sum(int(bt.fs_block[d][s].shape[0] + bt.cs_block[d][s].shape[0])
                for d in range(2) for s in range(2))
    log(f"[main2d] build_rae2822({RAE_FLAGSHIP}): {n_cells} cells, "
        f"{bt.n_blocks} blocks, "
        f"{int(case.bc.ghost_b.shape[0])} ghosts (stencil width "
        f"{case.bc.w.shape[1]}), {n_ifc} 2:1 interface rows, "
        f"{bt.n_sparse} sparse leftover faces, "
        f"{case.dom.surfaces['wall'].points.shape[0]} wall points; build "
        f"{case.build_seconds:.1f} s; Domain stages "
        + ", ".join(f"{k} {v:.1f}" for k, v in
                    case.dom.build_timings.items()))
    assert n_cells == RAE_CELLS, n_cells
    assert bt.n_sparse == 0 and case.P0.device.type == "cuda"
    assert bt.meta is None and bt.nbr_table is None
    ref = np.load(root / RAE_ORACLE)
    P = case.apply_bcs(torch.as_tensor(ref["P"], device=dev))
    P = case.march(P, 2)
    torch.cuda.synchronize()
    window, cps, ms_w, host_w = RAE_WINDOW, [], [], []
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    K.reset_launches()
    for _ in range(2):
        t0 = time.perf_counter()
        e0.record()
        P = case.march(P, window)
        e1.record()
        e1.synchronize()
        host_w.append((time.perf_counter() - t0) / window * 1e3)
        ms_w.append(e0.elapsed_time(e1) / window)
        cps.append(wall_cp(case, P))
    launches2d = dict(K.launches)
    ms_step = sum(ms_w) / 2
    _, res = case.step(P)
    finite = bool(torch.isfinite(P).all())
    cl, cd = force_coefficients(case, P)
    dcp = float(np.abs(np.stack(cps).mean(axis=0)
                       - ref["cp_phases"].mean(axis=0)).mean())
    peak = torch.cuda.max_memory_allocated()
    log(f"[main2d] 2 x {window} steps: {ms_step:.3f} ms/step (CUDA events; "
        f"windows {ms_w[0]:.3f}, {ms_w[1]:.3f}; host clock "
        f"{host_w[0]:.3f}, {host_w[1]:.3f}), "
        f"{n_cells / (ms_step / 1e3):.4e} cell-updates/s, resnorm "
        f"{float(res):.6e}, finite {finite}, peak memory "
        f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
        f"what the earlier phases hold)")
    log(f"[main2d] Cl {cl:.5f}, Cd {cd:.5f}; mean |dCp| of the two "
        f"windows' mean vs the oracle's {ref['cp_phases'].shape[0]}-phase "
        f"mean {dcp:.3e} (tol {DCP_TOL:g}); launches {launches2d}")
    assert finite, "non-finite 2D state after the march"
    assert launches2d == zero, launches2d
    assert CL_BAND[0] < cl < CL_BAND[1], cl
    assert dcp < DCP_TOL, dcp

    # 10. 2D breakdown
    P3 = to_blocks(bt, P)
    R0, dt3, _ = euler_rhs_grid(bt, fl, P3, with_dt=True, cfl=case.cfl)
    dt = (dt3 * case.active3)[..., None]
    Q0 = primitive2state(fl, P3)
    parts = {
        "euler_rhs_grid with dt":
            lambda: euler_rhs_grid(bt, fl, P3, with_dt=True, cfl=case.cfl),
        "euler_rhs_grid without dt": lambda: euler_rhs_grid(bt, fl, P3),
        "ghost BC (GhostBC.apply_grid, on a clone)":
            lambda: case.apply_bcs3(P3.clone()),
        "state clone (subtract from the BC line)": lambda: P3.clone(),
        "guarded update, stage 1 (primitive2state, Q0 + dt R0, back)":
            lambda: state2primitive_guarded(
                fl, primitive2state(fl, P3) + dt * R0),
        "guarded update, stage 2 (Q0 + dt (R0 + R1) / 2, back)":
            lambda: state2primitive_guarded(fl, Q0 + dt * (R0 + R0) / 2),
    }
    log(f"[breakdown2d] 2D step = {ms_step:.3f} ms; parts, 20 calls each, "
        f"ms by CUDA events / ms the host took to enqueue them:")
    for label, fn in parts.items():
        ev, host = time_both(fn)
        log(f"  {label}: {ev:.4f} / {host:.4f} ms")
    acts, busy_ms, wall_ms = profile_busy(lambda: case.march(P, 5), 5,
                                          "breakdown2d", ms_step)
    log(f"[2d] card: {smi}")

    # 30 and 32 on the flagship's block march
    t0 = time.perf_counter()
    graph_phase("flagship block", lambda X, n, graph: case.march(
        X, n, graph=graph), P, {}, case=case)
    graph_phase("flagship block, march_robust",
                lambda X, n, graph: case.march_robust(X, n, graph=graph),
                P, {}, case=case)
    padded_phase("flagship block", lambda X, n, graph: case.march(
        X, n, graph=graph), P)
    log(f"[graph] phases 30 and 32 on the flagship's block march took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharded_flagship(root, case, smi, dict(ms_step=ms_step, busy_ms=busy_ms))
    log(f"[shard25] phase 25 took {time.perf_counter() - t0:.1f} s")
    return dict(ms_step=ms_step, host_ms=sum(host_w) / 2, busy_ms=busy_ms,
                activities=acts, peak=peak - base,
                build_seconds=case.build_seconds, cl=cl, cd=cd,
                cells_s=n_cells / (ms_step / 1e3))


def scaled_err(ref, out):
    """Max |out - ref| per channel (axis 1) over that channel's max |ref|
    + 1e-3 (the scaling of tests/test_block_ops.py)."""
    err = (out.double() - ref.double()).abs().amax(dim=0)
    return float((err / (ref.double().abs().amax(dim=0) + 1e-3)).max())


def gather_phases(root, dev, smi, blk):
    """Phases 11-15: the generic gather path. It launches no kernel (its
    ops are torch ops in the port as they are XLA ops in the JAX package),
    so it adds no row to the kernels line; the counters are asserted to
    stay 0. ``blk`` holds the block march's numbers of phases 9 and 10."""
    from ibx_torch.cases import (build_rae2822, build_sphere3d,
                                 force_coefficients)
    from ibx_torch.ops import kernels as K
    from ibx_torch.ops import block_ops as bo
    from ibx_torch.solve.euler import euler_rhs, local_timestep
    from ibx_torch.topology.domain import Domain

    zero = dict.fromkeys(K.launches, 0)
    small = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7)

    # 11. gather step, card vs CPU
    gg = build_rae2822(device=dev, use_blocks=False, **small)
    g_cpu = build_rae2822(device="cpu", use_blocks=False, **small)
    P = perturbed2d(gg)
    K.reset_launches()
    Pg, rg = gg.step(P)
    Pc, rc = g_cpu.step(P.cpu())
    log(f"[gather-step] RAE2822 wall_h=8e-2 ({gg.dom.ncells} cells), "
        f"use_blocks=False, one step, card vs CPU")
    check("state (per channel)", chan_err(Pc, Pg.cpu()), GATHER_STEP_TOL)
    check("resnorm (relative)",
          abs(float(rg) - float(rc)) / abs(float(rc)), RES_TOL)
    assert dict(K.launches) == zero, K.launches
    del g_cpu

    # 12. gather vs block on the card
    bk = build_rae2822(device=dev, **small)
    part, fl = gg.dom.partitions[0], gg.fluid
    log("[gather-vs-block] same fixture, on the card")
    check("euler_rhs vs euler_rhs_block (per channel, scaled)",
          scaled_err(euler_rhs(part, fl, P),
                     bo.euler_rhs_block(bk.bt, fl, P)), GVB_RHS_TOL)
    dt_g = local_timestep(part, fl, P, 0.7)
    _, dt_b, _ = bo.euler_rhs_block(bk.bt, fl, P, with_dt=True, cfl=0.7)
    check("local_timestep vs block dt (relative)",
          float(((dt_b - dt_g).abs() / dt_g.abs()).max()), GVB_DT_RTOL)
    Pa = Pb = gg.P0
    for _ in range(5):
        Pa, _ = gg.step(Pa)
        Pb, _ = bk.step(Pb)
    check("5 steps, gather vs block (per channel)", chan_err(Pa, Pb),
          GVB_STEPS_TOL)
    x = torch.as_tensor(gg.dom.centers[:, 0], device=dev)
    mu_t = 1e-4 * (1.0 + torch.sin(5 * x).abs())
    R_g = euler_rhs(part, fl, P, viscous=True, mu_t=mu_t)
    R_b = bo.to_flat(bk.bt, bo.euler_rhs_grid(
        bk.bt, fl, bo.to_blocks(bk.bt, P), viscous=True,
        mu_t3=bo.to_blocks(bk.bt, mu_t[:, None])))
    check("viscous euler_rhs with an mu_t field vs euler_rhs_grid",
          scaled_err(R_g, R_b), GVB_RHS_TOL)
    assert float((R_g - euler_rhs(part, fl, P)).abs().max()) > 0
    assert dict(K.launches) == zero, K.launches
    del gg, bk

    # 13. the gather march at full width
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    case = build_rae2822(use_blocks=False, **RAE_FLAGSHIP)
    part = case.dom.partitions[0]
    n_cells = case.dom.ncells
    fb_k = case.dom._host_boundaries["wall"].interp_idx.shape[1]
    faces = [int(part.face_owner[d].shape[0]) for d in range(2)]

    def nbytes(obj):
        if torch.is_tensor(obj):
            return obj.numel() * obj.element_size()
        if isinstance(obj, (tuple, list)):
            return sum(nbytes(o) for o in obj)
        return sum(nbytes(v) for v in vars(obj).values()) \
            if hasattr(obj, "__dict__") else 0

    log(f"[gather] build_rae2822(use_blocks=False, {RAE_FLAGSHIP}): "
        f"{n_cells} cells, faces a dim {faces}, accumulator width "
        f"{part.acc_left[0].width}, wall image stencil width {fb_k}, "
        f"partition tables {nbytes(part) / 2**20:.1f} MiB; build "
        f"{case.build_seconds:.1f} s; Domain stages "
        + ", ".join(f"{k} {v:.1f}" for k, v in
                    case.dom.build_timings.items()))
    assert n_cells == RAE_CELLS and case.bt is None
    assert case.P0.device.type == dev.type == "cuda"
    ref = np.load(root / RAE_ORACLE)
    P = case.apply_bcs(torch.as_tensor(ref["P"], device=dev))
    P = case.march(P, 2)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    K.reset_launches()
    t0 = time.perf_counter()
    e0.record()
    P = case.march(P, GATHER_STEPS)
    e1.record()
    e1.synchronize()
    host_ms = (time.perf_counter() - t0) / GATHER_STEPS * 1e3
    launches = dict(K.launches)
    ms_step = e0.elapsed_time(e1) / GATHER_STEPS
    _, res = case.step(P)
    finite = bool(torch.isfinite(P).all())
    cl, cd = force_coefficients(case, P)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[gather] {GATHER_STEPS} steps: {ms_step:.3f} ms/step (CUDA events; "
        f"host clock {host_ms:.3f}), {n_cells / (ms_step / 1e3):.4e} "
        f"cell-updates/s, resnorm {float(res):.6e}, finite {finite}, peak "
        f"memory {peak / 2**30:.3f} GiB above what the earlier phases hold; "
        f"Cl {cl:.5f}, Cd {cd:.5f}; launches {launches}")
    assert finite, "non-finite state after the gather march"
    assert launches == zero, launches
    assert CL_BAND[0] < cl < CL_BAND[1], cl
    acts, busy_ms, _ = profile_busy(lambda: case.march(P, 5), 5, "gather",
                                    ms_step)
    log(f"[gather] beside the block march of this run (use_blocks=True, "
        f"phases 9 and 10): ms/step {ms_step:.3f} vs {blk['ms_step']:.3f} "
        f"(host clock {host_ms:.3f} vs {blk['host_ms']:.3f}), device busy "
        f"{busy_ms:.3f} vs {blk['busy_ms']:.3f} ms a step, device "
        f"activities a step {acts:.0f} vs {blk['activities']:.0f}, peak "
        f"{peak / 2**30:.3f} vs {blk['peak'] / 2**30:.3f} GiB, build "
        f"{case.build_seconds:.1f} vs {blk['build_seconds']:.1f} s, Cl "
        f"{cl:.5f} vs {blk['cl']:.5f}, Cd {cd:.5f} vs {blk['cd']:.5f}; "
        f"card: {smi}")
    graph_phase("flagship gather", lambda X, n, graph: case.march(
        X, n, graph=graph), P, {}, case=case)
    del case, part, P

    # 14. 3D gather
    sg = build_sphere3d(wall_h=0.25, block_size=4, use_blocks=False,
                        device=dev)
    sc = build_sphere3d(wall_h=0.25, block_size=4, use_blocks=False,
                        device="cpu")
    sb = build_sphere3d(wall_h=0.25, block_size=4, device=dev)
    P = perturbed(sg)
    K.reset_launches()
    Pg, rg = sg.step(P)
    assert dict(K.launches) == zero, K.launches
    Pc, rc = sc.step(P.cpu())
    log(f"[gather3d] bs=4 sphere ({sg.dom.ncells} cells), use_blocks=False, "
        f"accumulator width {sg.dom.partitions[0].acc_left[0].width}: one "
        f"step card vs CPU, then 3 steps against the grid march")
    check("state (per channel)", chan_err(Pc, Pg.cpu()), GATHER_STEP_TOL)
    check("resnorm (relative)",
          abs(float(rg) - float(rc)) / abs(float(rc)), RES_TOL)
    check("3 steps, gather vs grid march (per channel)",
          chan_err(sb.march(sb.P0, 3, grid=True), sg.march(sb.P0, 3)),
          GVB_STEPS_TOL)
    del sc, sb

    # 15. four partitions on the card
    hf = [("farfield", [(0, False), (0, True), (1, False), (1, True),
                        (2, False), (2, True)])]
    d4 = Domain(sg.dom.mesh, n_partitions=4, hypercube_families=hf,
                device=dev)
    fl = sg.fluid
    r1 = sg.dom.map(lambda part, Q: euler_rhs(part, fl, Q), P)
    r4 = d4.map(lambda part, Q: euler_rhs(part, fl, Q), P)
    n_dom = [p.n_dom for p in d4.partitions]
    log(f"[partitions] Domain(n_partitions=4) on the bs=4 sphere: n_own "
        f"{d4.n_own}, n_dom {n_dom}; dom.map of euler_rhs vs one partition")
    assert r4.device.type == dev.type and min(n_dom) > d4.n_own
    check("mapped euler_rhs, 4 partitions vs 1 (per channel, scaled)",
          scaled_err(r1, r4), 1e-5)


def gather3d_full(smi, blk3d, case3d):
    """Phase 16: the production sphere on the gather march, on the domain
    of phase 5's block case ``case3d`` (`cases.sphere3d.gather_case`: what
    `build_sphere3d(..., use_blocks=False)` builds, on the same `Domain`);
    ``blk3d`` holds the ms a step of its block marches (phases 5 and 6)."""
    from ibx_torch.cases.sphere3d import gather_case
    from ibx_torch.ops import kernels as K

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    case = gather_case(case3d)
    dom = case.dom
    part = dom.partitions[0]
    assert case.dom.ncells == 5_308_416 and case.P0.device.type == "cuda"
    assert case.bt is None and dom is case3d.dom
    log(f"[gather3d-full] gather_case(build_sphere3d(wall_h=0.03, cfl=0.5, "
        f"block_size=16)), i.e. use_blocks=False on phase 5's domain: "
        f"{case.dom.ncells} cells, faces a dim "
        f"{[int(f.shape[0]) for f in part.face_owner]}, accumulator width "
        f"{part.acc_left[0].width}; fused BC, partition tables and initial "
        f"state {case.build_seconds:.1f} s (phase 5's host build "
        f"{case3d.build_seconds:.1f} s)")
    steps = 10
    P = case.march(case.P0, 2)
    torch.cuda.synchronize()
    K.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    P = case.march(P, steps)
    e1.record()
    e1.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    ms_step = e0.elapsed_time(e1) / steps
    finite = bool(torch.isfinite(P).all())
    log(f"[gather3d-full] {steps} steps: {ms_step:.3f} ms/step (CUDA "
        f"events; host clock {host_ms:.3f}), "
        f"{case.dom.ncells / (ms_step / 1e3):.4e} cell-updates/s, finite "
        f"{finite}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ("
        f"{held / 2**30:.2f} GiB of it held before the phase, phase 5's "
        f"block case among it), launches {dict(K.launches)}; card: {smi}")
    assert finite and not any(K.launches.values())
    _, busy_ms, _ = profile_busy(lambda: case.march(P, 2), 2,
                                 "gather3d-full", ms_step)
    log(f"[gather3d-full] beside the block marches of this run: ms/step "
        f"{ms_step:.3f} (device busy {busy_ms:.3f}) vs channel-split "
        f"{blk3d['cs_ms_step']:.3f} and grid {blk3d['grid_ms_step']:.3f}")
    graph_phase("sphere gather", lambda X, n, graph: case.march(
        X, n, graph=graph), case.P0, {}, case=case)
    del case, part, P
    dom._partitions = None          # the gather tables' memory back


def rans_state(case, seed=0):
    """(P, Rt) on the case's device: the initial state with a smooth
    perturbation, noise in u and v, and an eddy viscosity of 1 to 20 times
    the freestream seed (the state of tests/test_torch_rans.py)."""
    rng = np.random.default_rng(seed)
    P = case.P0.detach().cpu().numpy().copy()
    x, y = case.dom.centers[:, 0], case.dom.centers[:, 1]
    P[:, 0] *= 1.0 + 0.05 * np.sin(x) * np.cos(y)
    P[:, 1] *= 1.0 + 0.02 * np.cos(x)
    P[:, 2] += 20.0 * np.sin(y) + 5.0 * rng.standard_normal(P.shape[0])
    P[:, 3] += 10.0 * np.cos(x) + 5.0 * rng.standard_normal(P.shape[0])
    Rt = case.Rt_inf * (1.0 + 19.0 * rng.uniform(size=P.shape[0]))
    dev = case.P0.device
    return (torch.as_tensor(P.astype(np.float32), device=dev),
            torch.as_tensor(Rt.astype(np.float32), device=dev))


def rel_max(ref, out):
    """Max |out - ref| over max |ref|."""
    return max_abs(ref, out) / float(ref.double().abs().max())


def rans_phases(dev, smi):
    """Phases 17-20: RANS on both marches. No kernel lies on either (the
    viscous RHS takes the torch-op body, as it takes plain XLA in the JAX
    package), so they add no row to the kernels line; the four counters
    are asserted to stay 0."""
    from ibx_torch.cases import (build_flat_plate, build_rae2822_rans,
                                 cf_prandtl, force_coefficients,
                                 skin_friction_profile, wall_cp,
                                 wall_skin_friction)
    from ibx_torch.ops import kernels as K

    zero = dict.fromkeys(K.launches, 0)

    # 17. one RANS step, card vs CPU, on each march
    for ub, tol in ((True, STEP_TOL), (False, GATHER_STEP_TOL)):
        cg = build_rae2822_rans(use_blocks=ub, device=dev, **RANS_SMALL)
        cc = build_rae2822_rans(use_blocks=ub, device="cpu", **RANS_SMALL)
        P, Rt = rans_state(cg)
        K.reset_launches()
        Pg, Rg, rg = cg.step(P, Rt)
        assert dict(K.launches) == zero, K.launches
        Pc, Rc, rc = cc.step(P.cpu(), Rt.cpu())
        log(f"[rans-step] RANS RAE2822 {RANS_SMALL} ({cg.dom.ncells} "
            f"cells), use_blocks={ub}, one step, card vs CPU")
        check("state (per channel)", chan_err(Pc, Pg.cpu()), tol)
        check("Rt (of max |Rt|)", rel_max(Rc, Rg.cpu()), RANS_RT_TOL)
        check("resnorm (relative)",
              abs(float(rg) - float(rc)) / abs(float(rc)), RES_TOL)
    del cg, cc

    # 18. block vs gather on the card (tests/test_rans.py's fixture)
    cb = build_rae2822_rans(device=dev, **RANS_GVB)
    cg = build_rae2822_rans(use_blocks=False, device=dev, **RANS_GVB)
    log(f"[rans-gvb] RANS RAE2822 {RANS_GVB} ({cb.dom.ncells} cells), "
        f"block vs gather march on the card, {RANS_GVB_STEPS} steps")
    check("P0 (per channel)", chan_err(cg.P0, cb.P0), 2e-5)
    Pb, Rb, Pg, Rg = cb.P0, cb.Rt0, cg.P0, cg.Rt0
    K.reset_launches()
    for _ in range(RANS_GVB_STEPS):
        Pb, Rb, _ = cb.step(Pb, Rb)
        Pg, Rg, _ = cg.step(Pg, Rg)
    assert dict(K.launches) == zero, K.launches
    check("P (per channel)", chan_err(Pg, Pb), 2e-4)
    check("Rt (of max |Rt|)", rel_max(Rg, Rb), 2e-3)
    del cb, cg

    # 19. the reference's physical checks (tests/test_rans.py and
    # tests/test_flat_plate.py, marched there on the CPU)
    t0 = time.perf_counter()
    case = build_rae2822_rans(device=dev, **RANS_REF)
    P, Rt, r0 = case.step(case.P0, case.Rt0)
    P, Rt = case.march(P, Rt, 300)
    P, Rt, r1 = case.step(P, Rt)
    P, Rt = case.march(P, Rt, RANS_REF_STEPS - 302)
    finite = bool(torch.isfinite(P).all() and torch.isfinite(Rt).all())
    cp = wall_cp(case, P)
    cf = wall_skin_friction(case, P)
    xw = case.dom.surfaces["wall"].points[:, 0]
    cf_mid = float(cf[(xw > 0.2) & (xw < 0.8)].mean())
    log(f"[rans-ref] build_rae2822_rans({RANS_REF}) ({case.dom.ncells} "
        f"cells): resnorm {float(r0):.6e} at step 1, {float(r1):.6e} at "
        f"step 302; after {RANS_REF_STEPS} steps finite {finite}, Rt max "
        f"{float(Rt.max()) / case.Rt_inf:.2f} Rt_inf, Rt min "
        f"{float(Rt.min()):.3e}, wall Cp {cp.min():.4f} to {cp.max():.4f}, "
        f"mid-chord mean Cf {cf_mid:.5e} "
        f"({time.perf_counter() - t0:.1f} s with the build)")
    assert case.dom.ncells == RANS_REF_CELLS, case.dom.ncells
    assert finite and float(r1) < float(r0)
    assert float(Rt.max()) > 10 * case.Rt_inf and float(Rt.min()) >= 0.0
    assert cp.max() > 0.6 and cp.min() < -0.4
    assert np.isfinite(cf).all() and 1e-4 < cf_mid < 5e-2
    ms = [timed_march(lambda X, n, graph: case.march(*X, n, graph=graph),
                      (P, Rt), 10, g)[0] for g in (True, False)]
    log(f"[rans-ref] the airfoil's march {ms[0]:.3f} ms a step graphed, "
        f"{ms[1]:.3f} eager (CUDA events over 10 steps)")
    del case
    t0 = time.perf_counter()
    plate = build_flat_plate(device=dev, **PLATE_REF)
    P, Rt = plate.march(plate.P0, plate.Rt0, 300)
    x, cf = skin_friction_profile(plate, P)
    sel = (x > 0.3) & (x < 1.0)
    ratio = cf[sel] / cf_prandtl(plate.reynolds * x[sel])
    log(f"[rans-ref] build_flat_plate({PLATE_REF}) ({plate.dom.ncells} "
        f"cells), 300 steps: Cf / Prandtl {ratio.min():.3f} to "
        f"{ratio.max():.3f} at {int(sel.sum())} stations "
        f"({time.perf_counter() - t0:.1f} s with the build)")
    assert bool(torch.isfinite(P).all() and torch.isfinite(Rt).all())
    assert sel.sum() > 10 and (ratio > 0.2).all() and (ratio < 5.0).all()
    t0 = time.perf_counter()
    plate = build_flat_plate(device=dev, **PLATE_LOWYP)
    P, Rt = plate.march(plate.P0, plate.Rt0, PLATE_LOWYP_STEPS)
    finite = bool(torch.isfinite(P).all() and torch.isfinite(Rt).all())
    log(f"[rans-ref] build_flat_plate({PLATE_LOWYP}) ({plate.dom.ncells} "
        f"cells), {PLATE_LOWYP_STEPS} steps: finite {finite}, min p "
        f"{float(P[:, 0].min()):.1f}, max |u| "
        f"{float(P[:, 2:].abs().max()):.2f} "
        f"({time.perf_counter() - t0:.1f} s with the build)")
    assert finite and float(P[:, 0].min()) > 5e4
    assert float(P[:, 2:].abs().max()) < 200
    del plate, P, Rt

    # 20. both cases at their default sizes on both marches
    out = {}
    for label, build, cells in (
            ("RAE2822 RANS", build_rae2822_rans, RANS_CELLS),
            ("flat plate", build_flat_plate, PLATE_CELLS)):
        for ub in (True, False):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            case = build(use_blocks=ub)
            tag = f"{label}, {'block' if ub else 'gather'} march"
            assert case.dom.ncells == cells and case.P0.device.type == "cuda"
            graph_phase(tag, lambda X, n, graph: case.march(
                *X, n, graph=graph), (case.P0, case.Rt0), {})
            torch.cuda.reset_peak_memory_stats()
            P, Rt = case.march(case.P0, case.Rt0, 2)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            K.reset_launches()
            t0 = time.perf_counter()
            e0.record()
            P, Rt = case.march(P, Rt, RANS_STEPS)
            e1.record()
            e1.synchronize()
            host_ms = (time.perf_counter() - t0) / RANS_STEPS * 1e3
            ms_step = e0.elapsed_time(e1) / RANS_STEPS
            launches = dict(K.launches)
            _, _, res = case.step(P, Rt)
            finite = bool(torch.isfinite(P).all() and torch.isfinite(Rt).all())
            peak = torch.cuda.max_memory_allocated() - base
            log(f"[rans-full] {tag}: {case.dom.ncells} cells, build "
                f"{case.build_seconds:.1f} s; {RANS_STEPS} steps "
                f"{ms_step:.3f} ms/step (CUDA events; host clock "
                f"{host_ms:.3f}), {case.dom.ncells / (ms_step / 1e3):.4e} "
                f"cell-updates/s, resnorm {float(res):.6e}, finite {finite}, "
                f"Rt max {float(Rt.max()) / case.Rt_inf:.2f} Rt_inf, peak "
                f"memory {peak / 2**30:.3f} GiB above what was held; "
                f"launches {launches}")
            assert finite, f"non-finite state: {tag}"
            assert launches == zero, launches
            # 2 traced steps: tracing makes a block step 20 times slower
            acts, busy_ms, _ = profile_busy(
                lambda: case.march(P, Rt, 2), 2, "rans-full", ms_step)
            row = dict(ms_step=ms_step, host_ms=host_ms, busy_ms=busy_ms,
                       activities=acts, build_s=case.build_seconds,
                       peak_gib=peak / 2**30)
            if label == "RAE2822 RANS":
                cl, cd = force_coefficients(case, P)
                cf = wall_skin_friction(case, P)
                xw = case.dom.surfaces["wall"].points[:, 0]
                row.update(cl=cl, cd=cd, cf_mid=float(
                    cf[(xw > 0.2) & (xw < 0.8)].mean()))
                log(f"[rans-full] {tag}: Cl {cl:.5f}, Cd {cd:.5f}, "
                    f"mid-chord mean Cf {row['cf_mid']:.5e} after "
                    f"{RANS_STEPS + 2} steps from the freestream")
            out[tag] = row
            del case, P, Rt
    log(f"[rans-full] card: {smi}; " + json.dumps(
        {k: {kk: round(vv, 6) for kk, vv in v.items()}
         for k, v in out.items()}))
    return out


def fas_solver(case, max_levels, smoother, cfl):
    """`FasEuler` over ``case.dom`` by the recipe of
    tests/test_fas_euler.py:21-55: the farfield and wall families one after
    the other through `Domain.impose_bc`, the cells inside the airfoil
    frozen on every level."""
    from ibx_torch.cases.rae2822 import RAE_DAT
    from ibx_torch.geometry import load_surface, merge_points
    from ibx_torch.geometry.inside import points_inside
    from ibx_torch.physics import apply_flow_bc, flow_bc
    from ibx_torch.solve import FasEuler

    stl = merge_points(load_surface(RAE_DAT))
    dev = case.P0.device
    P_inf = np.asarray(case.P_inf, np.float32)
    far = flow_bc(case.fluid, P_inf, device=dev)
    wall = flow_bc(case.fluid, [float(P_inf[0]), float(P_inf[1]), 0.0],
                   normal_flow=True, device=dev)

    def make_bcs(d):
        def apply_bcs(P):
            P = d.impose_bc(
                "farfield", lambda b, Pi: apply_flow_bc(far, Pi, b.normals),
                P)
            return d.impose_bc(
                "wall", lambda b, Pi: apply_flow_bc(wall, Pi, b.normals), P)
        return apply_bcs

    return FasEuler(case.dom, case.fluid, make_bcs, max_levels=max_levels,
                    cfl=cfl, smoother=smoother,
                    inside_fn=lambda c: points_inside(stl, c))


def l2(r):
    return float(torch.sqrt((r.float() ** 2).sum()))


def seeded_blocks(n, k=4, seed=3):
    """Diagonally dominant [n, k, k] blocks over five decades of scale, as
    the Newton blocks of the point-implicit step are."""
    rng = np.random.default_rng(seed)
    D = rng.normal(size=(n, k, k)).astype(np.float32)
    D += (4.0 + 10.0 * rng.uniform(size=(n, 1, 1))) * np.eye(
        k, dtype=np.float32)
    return D * (10.0 ** rng.uniform(-2, 3, size=(n, 1, 1))).astype(
        np.float32)


def calls_to(curve, frac):
    """Calls from the start until the functional first falls to ``frac``
    of its peak (after the peak), or None (the JAX package's
    tests/test_fas_verdict.py::_t_to, counted in calls)."""
    pk = int(np.argmax(curve))
    hit = [i for i in range(pk, len(curve)) if curve[i] <= frac * curve[pk]]
    return hit[0] if hit else None


def solver_phases(root, dev, smi):
    """Phases 21-23: solver acceleration (multigrid transfers, FAS and
    FAS-Euler, the point-implicit solver). No kernel lies on it (FAS-Euler
    runs on the gather path, the point-implicit step on the nd = 2 block
    path, as in the JAX package), so it adds no row to the kernels line;
    the four counters are asserted to stay 0."""
    from ibx_torch.cases import build_rae2822
    from ibx_torch.ops import kernels as K
    from ibx_torch.ops.block_ops import euler_rhs_block
    from ibx_torch.physics.fluid import physicality_guard, state2primitive
    from ibx_torch.solve import (Linearization, PIPreconditioner, linearize,
                                 point_implicit_step, solve)
    from ibx_torch.solve.euler import euler_rhs, local_timestep
    from ibx_torch.solve.point_implicit import _block_inv
    from ibx_torch.solve.point_implicit_euler import newton_map

    zero = dict.fromkeys(K.launches, 0)
    K.reset_launches()

    # 21. solver parity, card vs CPU, on the wall_h=8e-2 fixtures
    gg = build_rae2822(device=dev, use_blocks=False, **SOLVE_SMALL)
    gcpu = build_rae2822(device="cpu", use_blocks=False, **SOLVE_SMALL)
    P = perturbed2d(gg)
    log(f"[solve-parity] RAE2822 {SOLVE_SMALL} ({gg.dom.ncells} cells), "
        f"gather case: FasEuler(max_levels=2), card vs CPU")
    for smoother, cfl in FAS_SMOOTHERS.items():
        t0 = time.perf_counter()
        fg = fas_solver(gg, 2, smoother, cfl)
        fc = fas_solver(gcpu, 2, smoother, cfl)
        log(f"  {smoother} smoother (cfl {cfl}): levels "
            f"{[d.ncells for d in fg.domains]} cells, two hierarchies "
            f"built in {time.perf_counter() - t0:.1f} s")
        if smoother == "euler":
            rng = np.random.default_rng(11)
            for i, (c, p) in enumerate(zip(fg.coarseners, fg.prolongators)):
                for name, st, stc in (("coarsener", c, fc.coarseners[i]),
                                      ("prolongator", p,
                                       fc.prolongators[i])):
                    n_in = int(stc.idx.max()) + 1
                    u = torch.as_tensor(rng.normal(size=(n_in, 4)).astype(
                        np.float32))
                    check(f"{name} {i} applied ({st.n_output} x "
                          f"{st.width}, relative)",
                          rel_max(stc(u), st(u.to(dev)).cpu()), TRANSFER_TOL)
        Qc = fc.init_state(P.cpu())
        Qg = fg.init_state(P)
        check("init_state (per channel)", chan_err(Qc, Qg.cpu()), FAS_F_TOL)
        Ql = Qc
        for lvl in range(len(fc.domains)):
            rc, _ = fc._f(lvl, Ql)
            rg, _ = fg._f(lvl, Ql.to(dev))
            check(f"_f level {lvl} (per channel)", chan_err(rc, rg.cpu()),
                  FAS_F_TOL)
            if lvl < len(fc.coarseners):
                Ql = fc.coarseners[lvl](Ql)
        Q2c, r2c = fc.cycle(Qc, n_iter=2)
        Q2g, r2g = fg.cycle(Qc.to(dev), n_iter=2)
        check("cycle(n_iter=2) state (per channel)",
              chan_err(Q2c, Q2g.cpu()), FAS_CYCLE_TOL)
        check("cycle(n_iter=2) ratio (relative)",
              abs(float(r2g) - float(r2c)) / abs(float(r2c)), FAS_CYCLE_TOL)
    del gg, gcpu, fg, fc

    bg = build_rae2822(device=dev, **SOLVE_SMALL)
    bcpu = build_rae2822(device="cpu", **SOLVE_SMALL)
    P = perturbed2d(bg)
    log(f"[solve-parity] the same mesh, block case: the point-implicit "
        f"solver (cfl {PI_CFL}, the freeze mask), card vs CPU")
    D = torch.as_tensor(seeded_blocks(bg.dom.ncells))
    check("_block_inv (per row of the blocks)",
          chan_err(_block_inv(D), _block_inv(D.to(dev)).cpu()), PI_TOL)
    gfn, Qn = newton_map(bg.bt, bg.fluid, P, bg.apply_bcs, cfl=PI_CFL,
                         active=bg.active3.reshape(-1))
    cfn, Qnc = newton_map(bcpu.bt, bcpu.fluid, P.cpu(), bcpu.apply_bcs,
                          cfl=PI_CFL, active=bcpu.active3.reshape(-1))
    rng = np.random.default_rng(9)
    scale = Qnc.abs().amax(dim=0).numpy()
    v = torch.as_tensor((rng.normal(size=tuple(Qnc.shape)) * 1e-3
                         * scale).astype(np.float32))
    Ac, bc_, prec_c = linearize(cfn, Qnc, n_hutchinson_samples=2)
    Ag = Linearization(gfn, Qn, gfn(Qn))
    check("g at Q_n (per channel)", chan_err(Ac.fx, Ag.fx.cpu()), PI_TOL)
    check("JVP of g (per channel)", chan_err(Ac(v), Ag(v.to(dev)).cpu()),
          PI_TOL)
    prec_g = PIPreconditioner(prec_c.inverse_diagonal.to(dev))
    xc, rc = solve(Ac, bc_, prec_c, n_iter=8, rtol=1e-2)
    xg, rg = solve(Ag, -Ag.fx, prec_g, n_iter=8, rtol=1e-2)
    check("solve x, 8 iterations (per channel)", chan_err(xc, xg.cpu()),
          PI_TOL)
    check("solve ratio (relative)",
          abs(float(rg) - float(rc)) / abs(float(rc)), PI_TOL)
    assert dict(K.launches) == zero, K.launches
    del bg, bcpu, gfn, cfn, Ac, Ag, Qn, Qnc

    # 22. the FAS verdict (scripts/fas_verdict2d.py), counted in calls
    t0 = time.perf_counter()
    case = build_rae2822(**VERDICT_CASE)
    t_case = time.perf_counter() - t0
    t0 = time.perf_counter()
    fe = fas_solver(case, 3, "rk2", 0.7)
    t_fe = time.perf_counter() - t0
    dom = fe.domains[0]
    part, fl = dom.partitions[0], fe.fluid
    ghost = np.zeros(dom.ncells, bool)
    for hb in dom._host_boundaries.values():
        ghost[hb.ghosts] = True
    solved = torch.as_tensor((~ghost).astype(np.float32),
                             device=dev) * fe.active[0]

    def res_l2(Q):
        """L2 of dt*R over the solved cells at cfl 0.7, the verdict's
        functional (scripts/fas_verdict2d.py:97-130)."""
        P = fe.bcs[0](physicality_guard(state2primitive(fl, Q)))
        R = euler_rhs(part, fl, P, high_order=fe.high_order)
        dt = local_timestep(part, fl, P, 0.7) * solved
        return l2(R * dt[:, None])

    log(f"[verdict] build_rae2822({VERDICT_CASE}): {dom.ncells} cells, "
        f"build {t_case:.1f} s; FasEuler(max_levels=3, smoother='rk2', "
        f"cfl=0.7) levels {[d.ncells for d in fe.domains]} cells, built in "
        f"{t_fe:.1f} s; {int(ghost.sum())} ghost cells left out of the "
        f"functional")
    Q0 = fe.init_state(case.P0)
    curves, secs = {}, {}
    for arm, fn in (("smooth", fe.smooth_only), ("fas3", fe.cycle)):
        Q, curve, t_arm = Q0, [res_l2(Q0)], 0.0
        for _ in range(VERDICT_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Q, _ = fn(Q, n_iter=VERDICT_ITERS, rtol=1e-6)
            torch.cuda.synchronize()
            t_arm += time.perf_counter() - t0
            curve.append(res_l2(Q))
        curves[arm], secs[arm] = np.asarray(curve), t_arm / VERDICT_CALLS
        pk = int(np.argmax(curve))
        log(f"[verdict] {arm}: {VERDICT_CALLS} calls of n_iter="
            f"{VERDICT_ITERS}, {secs[arm]:.3f} s a call on the card; peak "
            f"{curve[pk]:.6e} after call {pk}, 0.3x peak at call "
            f"{calls_to(curve, 0.3)}, final {curve[-1] / curve[pk]:.4f} of "
            f"peak; functional after each call: "
            + " ".join(f"{r:.5e}" for r in curve))
    assert dict(K.launches) == zero, K.launches
    n_fas, n_sm = calls_to(curves["fas3"], 0.3), calls_to(curves["smooth"],
                                                          0.3)

    def final(c):
        return c[-1] / c.max()

    log(f"[verdict] calls to 0.3x peak: fas3 {n_fas}, smoothing {n_sm}; "
        f"final/peak: fas3 {final(curves['fas3']):.4f}, smoothing "
        f"{final(curves['smooth']):.4f}; card: {smi}")
    assert all(np.isfinite(c).all() for c in curves.values())
    assert n_fas is not None, "fas3 never reached 0.3x its peak"
    if n_sm is not None:
        assert n_fas <= n_sm / 1.5, (n_fas, n_sm)
    assert final(curves["fas3"]) < final(curves["smooth"]) / 3.0
    del case, fe, part, Q, Q0

    # 23. the slice at full width: FAS-Euler on the gather march (M 0.4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    case = build_rae2822(use_blocks=False, mach=0.4, **RAE_FLAGSHIP)
    t0 = time.perf_counter()
    fe = fas_solver(case, 3, "rk2", 0.7)
    t_fe = time.perf_counter() - t0
    assert fe.domains[0].ncells == RAE_CELLS
    Q0 = fe.init_state(case.P0)
    kw = dict(n_iter=FAS_FULL_ITERS, rtol=1e-6)
    fe.cycle(Q0, n_iter=1)          # first partition tables at first use
    torch.cuda.synchronize()
    log(f"[fas-full] build_rae2822(use_blocks=False, mach=0.4, "
        f"{RAE_FLAGSHIP}): {case.dom.ncells} cells, build "
        f"{case.build_seconds:.1f} s; FasEuler(max_levels=3, 'rk2', cfl "
        f"0.7) built in {t_fe:.1f} s; levels (cells, Domain build s with "
        f"its partition tables): " + ", ".join(
            f"{d.ncells} {sum(d.build_timings.values()):.1f}"
            for d in fe.domains))
    ms = {}
    Qc = Qs = Q0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for arm in ("fas", "smooth"):
        fn = fe.cycle if arm == "fas" else fe.smooth_only
        Q = Q0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        for _ in range(FAS_FULL_CALLS):
            Q, _ = fn(Q, **kw)
        e1.record()
        e1.synchronize()
        ms[arm] = (e0.elapsed_time(e1) / FAS_FULL_CALLS,
                   (time.perf_counter() - t0) / FAS_FULL_CALLS * 1e3)
        if arm == "fas":
            Qc = Q
        else:
            Qs = Q
    nc, ns = l2(fe._f(0, Qc)[0]), l2(fe._f(0, Qs)[0])
    Pc = fe.primitives(Qc)
    act = fe.active[0] > 0
    finite = bool(torch.isfinite(Qc).all() and torch.isfinite(Qs).all())
    peak = torch.cuda.max_memory_allocated() - base
    p_act, T_act = Pc[act, 0], Pc[act, 1]
    log(f"[fas-full] {FAS_FULL_CALLS} calls of n_iter={FAS_FULL_ITERS}: "
        f"cycle {ms['fas'][0]:.1f} ms (host clock {ms['fas'][1]:.1f}), "
        f"smoothing {ms['smooth'][0]:.1f} ms (host {ms['smooth'][1]:.1f}) a "
        f"call; fine residual |r| after: cycles {nc:.6e}, smoothing "
        f"{ns:.6e}; finite {finite}; active cells p {float(p_act.min()):.1f}"
        f" to {float(p_act.max()):.1f}, T min {float(T_act.min()):.2f}; "
        f"peak memory {peak / 2**30:.3f} GiB above what was held")
    assert finite and nc < 2.0 * ns, (nc, ns)
    assert float(p_act.min()) > 1e3 and float(p_act.max()) < 1e6
    assert float(T_act.min()) > 50
    acts, busy_ms, _ = profile_busy(lambda: fe.cycle(Qc, **kw), 1,
                                    "fas-full", ms["fas"][0])

    # the host sync of the stop rule (one read of the residual norm an
    # iteration): a smoothing call against the same iterations, norms
    # included, with no read, in turns
    def no_read(Q):
        r0, _ = fe._f(0, Q)
        source = torch.zeros_like(r0)
        nr = None
        for _ in range(FAS_FULL_ITERS):
            r, om = fe._f(0, Q)
            r = r + source
            Q = Q + om.clamp(0.0, 1.0) * r
            nr = torch.sqrt((r.float() ** 2).sum())
        return Q, nr

    t_sync = {"read": [], "no read": []}
    for label in ("read", "no read", "no read", "read") * 3:
        fn = (lambda Q: fe.smooth_only(Q, **kw)) if label == "read" \
            else no_read
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(Qs)
        torch.cuda.synchronize()
        t_sync[label].append((time.perf_counter() - t0) * 1e3)
    d_ms = (np.median(t_sync["read"]) - np.median(t_sync["no read"])) \
        / FAS_FULL_ITERS
    log(f"[fas-full] stop rule's host read: a smoothing call of "
        f"{FAS_FULL_ITERS} iterations, host clock, synchronized, ms with "
        f"the read an iteration " + ", ".join(
            f"{t:.1f}" for t in t_sync["read"]) + "; without " + ", ".join(
            f"{t:.1f}" for t in t_sync["no read"])
        + f": medians differ by {d_ms:.3f} ms an iteration")
    assert dict(K.launches) == zero, K.launches
    del case, fe, Q, Q0, Qc, Qs, Pc

    # 23. the point-implicit step on the block march, from the oracle
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    case = build_rae2822(**RAE_FLAGSHIP)
    bt, fl = case.bt, case.fluid
    active = case.active3.reshape(-1)
    ref = np.load(root / RAE_ORACLE)
    P = case.apply_bcs(torch.as_tensor(ref["P"], device=dev))

    def resnorm(P):
        R = euler_rhs_block(bt, fl, case.apply_bcs(P))
        return l2(R * active[:, None])

    r0 = resnorm(P)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # the exact limiter's linearization at this state, for the record: the
    # frozen in-solid cells hold one pressure, so the JST sensor's |G| and
    # its denominator sit at 0 there, and the derivative of |G| at 0 (+1,
    # as `jnp.abs`'s) over 1e-7 gives Jacobian blocks beside the wall
    # whose squares overflow float32 in `_block_inv`'s scale
    g, Qn = newton_map(bt, fl, P, case.apply_bcs, cfl=PI_CFL, active=active)
    Dinv = linearize(g, Qn, n_hutchinson_samples=8,
                     generator=gen)[2].inverse_diagonal
    n_bad = int((~torch.isfinite(Dinv.reshape(Dinv.shape[0], -1))).any(
        dim=1).sum())
    del g, Qn, Dinv
    gen.manual_seed(0)
    ratios, ms_steps = [], []
    for _ in range(PI_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P, ratio = point_implicit_step(bt, fl, P, case.apply_bcs, cfl=PI_CFL,
                                       active=active, relax=PI_RELAX,
                                       freeze_limiter=True, generator=gen)
        ratios.append(float(ratio))
        ms_steps.append((time.perf_counter() - t0) * 1e3)
        assert bool(torch.isfinite(P).all()), "non-finite point-implicit step"
    r1 = resnorm(P)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[pi-full] the exact limiter's block inverse diagonal at the "
        f"oracle's state: {n_bad} of {active.shape[0]} rows not finite")
    log(f"[pi-full] point_implicit_step(cfl={PI_CFL}, relax={PI_RELAX}, "
        f"freeze_limiter=True, 8 Hutchinson samples, 8 Krylov iterations) "
        f"on the block march of "
        f"build_rae2822({RAE_FLAGSHIP}) ({case.dom.ncells} cells) from "
        f"{RAE_ORACLE}: linear ratios "
        + ", ".join(f"{r:.4f}" for r in ratios)
        + f"; solved-cell |R| {r0:.6e} -> {r1:.6e} ({r1 / r0:.4f}x); "
        + "ms a step (host clock, synchronized) "
        + ", ".join(f"{m:.1f}" for m in ms_steps)
        + f"; peak memory {peak / 2**30:.3f} GiB above what was held; "
        f"card: {smi}")
    assert all(r < 1.0 for r in ratios), ratios
    assert np.isfinite(r1) and r1 < 3.0 * r0, (r0, r1)
    assert dict(K.launches) == zero, K.launches
    return dict(ms_cycle=ms["fas"][0], ms_smooth=ms["smooth"][0],
                busy_cycle=busy_ms, activities_cycle=acts, sync_ms=d_ms,
                verdict_s_call=secs, ms_pi_step=ms_steps)


def interface_sides(bt):
    """Interface rows per (d, s) side: the 2:1 fold's row index counts."""
    return [int(n) for n in (bt.fold_rows >= 0).sum(dim=0).tolist()]


def sphere_phases(dev):
    """Phases 3-7: the 3D sphere marches and their four kernels; returns
    the rows of the kernels line, the two marches' ms a step and the
    main-path case (phase 26 marches it before it is freed)."""
    from ibx_torch.cases import build_sphere3d
    from ibx_torch.ops import kernels as K

    # 3. kernel parity, bs=4 and bs=8 spheres
    case4 = build_sphere3d(wall_h=0.25, block_size=4, device=dev)
    P4 = perturbed(case4)
    case8 = build_sphere3d(wall_h=0.125, block_size=8, device=dev)
    for c, label in ((case4, "bs=4 sphere, wall_h=0.25"),
                     (case8, "bs=8 sphere, wall_h=0.125")):
        sides = interface_sides(c.bt)
        log(f"[parity] {label}: {c.dom.ncells} cells, 2:1 interface rows "
            f"per (d, s) side {sides}")
        assert min(sides) > 0, sides
        kernel_parity(c, c.to_cs(perturbed(c)), label)
    del case8

    # main-path case (its numbers are printed in phase 5)
    K.reset_launches()
    case = build_sphere3d(wall_h=0.03, cfl=0.5, block_size=16)
    assert case.P0.device.type == "cuda"
    bt = case.bt
    errs16 = kernel_parity(case, case.to_cs(perturbed(case)),
                           "bs=16 sphere (main-path tables)")

    # 4. whole-step parity, card vs CPU
    case4_cpu = build_sphere3d(wall_h=0.25, block_size=4, device="cpu")
    for label, kw in (("channel-split", {}),
                      ("grid, fold", dict(grid=True, fold=True)),
                      ("grid, frozen gradients",
                       dict(grid=True, freeze_gradients=True))):
        Pg, rg = case4.step(P4, **kw)
        Pcpu, rc = case4_cpu.step(P4.cpu(), **kw)
        log(f"[step] bs=4 sphere, one RK2 step ({label}), card vs CPU")
        check("state (per channel)", chan_err(Pcpu, Pg.cpu()), STEP_TOL)
        check("resnorm (relative)",
              abs(float(rg) - float(rc)) / abs(float(rc)), RES_TOL)

    # 5. main path
    n_cells, n_blocks = case.dom.ncells, bt.n_blocks
    n_ghosts = int(case.bc.ghost_b.shape[0])
    log(f"[main] build_sphere3d(wall_h=0.03, cfl=0.5, block_size=16): "
        f"{n_cells} cells, {n_blocks} blocks, {n_ghosts} ghosts; host build "
        f"{case.build_seconds:.1f} s")
    assert n_cells == 5_308_416, n_cells
    steps = 100
    P = case.march(case.P0, 2)
    torch.cuda.synchronize()
    K.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    P = case.march(P, steps)
    e1.record()
    e1.synchronize()
    host_s = time.perf_counter() - t0
    main_launches = dict(K.launches)
    ms_step = e0.elapsed_time(e1) / steps
    _, res = case.step(P)
    finite = bool(torch.isfinite(P).all())
    log(f"[main] {steps} steps: {ms_step:.3f} ms/step (CUDA events; host "
        f"clock {host_s / steps * 1e3:.3f}), "
        f"{n_cells * steps / (ms_step * steps / 1e3):.4e} cell-updates/s, "
        f"resnorm {float(res):.6e}, finite {finite}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[main] launches: {main_launches}")
    assert finite, "non-finite state after the march"
    want = dict(rk2_update=2, euler_pass_a=2, euler_pass_b=2,
                euler_pass_b_fold=0)
    assert main_launches == {k: n * steps for k, n in want.items()}, \
        main_launches

    # 6. grid path (the cell-major march with the fold), same case
    g_steps = 20
    Pg = case.march(P, 2, grid=True, fold=True)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    e0.record()
    Pg = case.march(Pg, g_steps, grid=True, fold=True)
    e1.record()
    e1.synchronize()
    g_host_s = time.perf_counter() - t0
    grid_launches = dict(K.launches)
    g_ms_step = e0.elapsed_time(e1) / g_steps
    g_finite = bool(torch.isfinite(Pg).all())
    log(f"[grid] {g_steps} steps of case.march(grid=True, fold=True): "
        f"{g_ms_step:.3f} ms/step (CUDA events; host clock "
        f"{g_host_s / g_steps * 1e3:.3f}), "
        f"{n_cells / (g_ms_step / 1e3):.4e} cell-updates/s, "
        f"finite {g_finite}")
    log(f"[grid] launches: {grid_launches}")
    assert g_finite, "non-finite state after the grid march"
    want = dict(rk2_update=0, euler_pass_a=2, euler_pass_b=1,
                euler_pass_b_fold=1)
    assert grid_launches == {k: n * g_steps for k, n in want.items()}, \
        grid_launches
    launches = dict(main_launches,
                    euler_pass_b_fold=grid_launches["euler_pass_b_fold"])

    # 7. per-kernel times at the main path's shapes
    fl, Pc = case.fluid, case.to_cs(P)
    x = kernel_inputs(case, Pc)
    variants = {
        "rk2_update": (
            "stage 2",
            lambda: K.rk2_update(fl, Pc, x["R0"], x["R1"], x["dtb"],
                                 case.active_cs, case.cfl),
            lambda: K.rk2_update_ref(fl, Pc, x["R0"], x["R1"], x["dtb"],
                                     case.active_cs, case.cfl),
            22, FLOPS_PER_CELL["rk2_update"]),
        "euler_pass_a": (
            "with_dt",
            lambda: K.euler_pass_a(fl, Pc, bt.meta, bt.nbr_table,
                                   with_dt=True),
            lambda: K.euler_pass_a_ref(fl, Pc, bt.meta, bt.nbr_table,
                                       with_dt=True),
            29, FLOPS_PER_CELL["euler_pass_a_dt"]),
        "euler_pass_b": (
            "high_order",
            lambda: K.euler_pass_b(fl, Pc, x["du"], x["nu"], bt.meta,
                                   bt.nbr_table, high_order=True),
            lambda: K.euler_pass_b_ref(fl, Pc, x["du"], x["nu"], bt.meta,
                                       bt.nbr_table, high_order=True),
            26, pass_b_flops(bt.block_size)),
        "euler_pass_b_fold": (
            "high_order",
            lambda: K.euler_pass_b(fl, Pc, x["du_f"], x["nu_f"], bt.meta,
                                   bt.nbr_table, high_order=True,
                                   cols6=x["cols6"]),
            lambda: K.euler_pass_b_ref(fl, Pc, x["du_f"], x["nu_f"], bt.meta,
                                       bt.nbr_table, high_order=True,
                                       cols6=x["cols6"]),
            26, pass_b_flops(bt.block_size)),
    }
    # the fold also reads its compact correction rows and row index
    extra = {"euler_pass_b_fold": 4 * (x["cols6"][0].numel()
                                       + x["cols6"][1].numel())}
    others = {
        "rk2_update stage 1": (
            lambda: K.rk2_update(fl, Pc, x["R0"], None, x["dtb"],
                                 case.active_cs, case.cfl),
            17, FLOPS_PER_CELL["rk2_update"]),
        "euler_pass_a no dt": (
            lambda: K.euler_pass_a(fl, Pc, bt.meta, bt.nbr_table,
                                   with_dt=False),
            26, FLOPS_PER_CELL["euler_pass_a"]),
    }
    source = {"rk2_update": "ibx_torch/csrc/rk2_update.cu",
              "euler_pass_a": "ibx_torch/csrc/euler_pass_a.cu",
              "euler_pass_b": "ibx_torch/csrc/euler_pass_b.cu",
              "euler_pass_b_fold": "ibx_torch/csrc/euler_pass_b.cu"}
    # the fold is the same pallas_call traced with have_cols=True
    replaces = {"rk2_update": "ibx/ops/pallas_rhs.py:908",
                "euler_pass_a": "ibx/ops/pallas_rhs.py:420",
                "euler_pass_b": "ibx/ops/pallas_rhs.py:470",
                "euler_pass_b_fold": "ibx/ops/pallas_rhs.py:470"}
    res = kernel_resources()
    lib = K.build()
    lbs = bt.block_size.bit_length() - 1
    dyn = {"euler_pass_a": lib.ibx_euler_pass_a_smem(lbs, 1),
           "euler_pass_b": lib.ibx_euler_pass_b_smem(lbs, 0),
           "euler_pass_b_fold": lib.ibx_euler_pass_b_smem(lbs, 1),
           "rk2_update": 0}
    inst = {"euler_pass_a": f"euler_pass_a_kernel<{bt.block_size}, true>",
            "euler_pass_b": f"euler_pass_b_kernel<{bt.block_size}, false>",
            "euler_pass_b_fold":
                f"euler_pass_b_kernel<{bt.block_size}, true>",
            "rk2_update": "rk2_update_kernel"}
    log("[ptxas] registers, spill stores/loads (bytes) and static shared "
        "memory of every kernel instantiation (build log):")
    for k, v in sorted(res.items()):
        log(f"  {k}: {v.get('registers')} registers, spills "
            f"{v.get('spill')}, {v.get('static_smem')} bytes static smem")
    rows = []
    log(f"[kernels] {n_cells} cells, CUDA events over 20 launches; bounds at "
        f"{PEAK_BYTES_S / 1e12:g} TB/s and {PEAK_F32_FLOP_S / 1e12:g} "
        f"TFLOP/s f32")
    for name, (var, fk, fr, ch, fpc) in variants.items():
        ms = time_ms(fk)
        plain = time_ms(fr, reps=5)
        b_ms, b_by = bound(n_cells, ch, fpc, n_blocks, extra.get(name, 0))
        r = res.get(inst[name], {})
        log(f"  {name} ({var}): {ms:.4f} ms, plain {plain:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {ch} channels + "
            f"{extra.get(name, 0)} bytes), "
            f"{b_ms / ms:.1%} of bound, library none, "
            f"launches on its path {launches[name]}; {inst[name]}: "
            f"{r.get('registers')} registers, {r.get('static_smem')} + "
            f"{dyn[name]} bytes smem (static + dynamic)")
        rows.append(dict(name=name, route="cuda", source=source[name],
                         replaces=replaces[name],
                         launches=launches[name],
                         max_abs_err=errs16[name], ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         variant=var, registers=r.get("registers"),
                         smem_bytes=r.get("static_smem", 0) + dyn[name]))
    for label, (fk, ch, fpc) in others.items():
        ms = time_ms(fk)
        b_ms, b_by = bound(n_cells, ch, fpc, n_blocks)
        log(f"  {label}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{b_ms / ms:.1%} of bound")

    # where one step's time goes (the parts, timed one by one)
    from ibx_torch.ops.block_ops import euler_rhs_grid
    from ibx_torch.ops.rhs_cs import cs_merge, cs_split, euler_rhs_cs
    P3 = cs_merge(bt, Pc)
    du_cs = x["du"]
    parts = {
        "euler_rhs_cs with dt (pass A + glue + pass B)":
            lambda: euler_rhs_cs(bt, fl, Pc, with_dt=True),
        "euler_rhs_cs without dt":
            lambda: euler_rhs_cs(bt, fl, Pc),
        "euler_rhs_cs without dt, fold":
            lambda: euler_rhs_cs(bt, fl, Pc, fold=True),
        "ghost BC (GhostBC.apply_cs)":
            lambda: case.apply_bcs_cs(Pc.clone()),
        "state clone (subtract from the BC lines)":
            lambda: Pc.clone(),
    }
    log(f"[breakdown] channel-split step = {ms_step:.3f} ms; parts, 20 "
        f"calls each:")
    for label, fn in parts.items():
        log(f"  {label}: {time_ms(fn):.4f} ms")
    parts = {
        "euler_rhs_grid with dt (shim: split, euler_rhs_cs, 5 merges)":
            lambda: euler_rhs_grid(bt, fl, P3, with_dt=True, cfl=case.cfl),
        "euler_rhs_grid without dt, fold (split, euler_rhs_cs, merge)":
            lambda: euler_rhs_grid(bt, fl, P3, fold=True),
        "cs_split of the state (5 channels)": lambda: cs_split(bt, P3),
        "cs_merge of R (5 channels)": lambda: cs_merge(bt, Pc),
        "cs_merge of du and nu (3 x 5 + 1 channels)":
            lambda: ([cs_merge(bt, du_cs[:, 5 * d:5 * d + 5])
                      for d in range(3)], cs_merge(bt, x["nu"])),
        "ghost BC (GhostBC.apply_grid)":
            lambda: case.apply_bcs3(P3.clone()),
    }
    log(f"[breakdown] grid step = {g_ms_step:.3f} ms; parts, 20 calls "
        f"each:")
    for label, fn in parts.items():
        log(f"  {label}: {time_ms(fn):.4f} ms")
    return rows, dict(cs_ms_step=ms_step, grid_ms_step=g_ms_step), case


@contextlib.contextmanager
def one_rank_group(backend):
    """A process group of one rank (this process) over a ``file://`` store
    in a temporary directory, destroyed on exit."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, init_method="file://" + str(Path(tmp) / "store"),
            world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()
            # a group held in a reference cycle lives until the collector
            # runs; torn down at interpreter exit it aborts the process
            gc.collect()


def gather_step_one(case, P):
    """The sharded gather march's step (`build_rae2822_sharded`) on the
    one partition of ``case`` (a one-partition gather case): each BC
    family in turn by `Domain.impose_bc`, RK2 on `euler_rhs` with the
    local time step, no freeze mask, BCs after each stage."""
    from ibx_torch.physics.bc import apply_flow_bc, flow_bc
    from ibx_torch.physics.fluid import primitive2state, state2primitive
    from ibx_torch.solve.euler import euler_rhs, local_timestep

    dom, fl, dev = case.dom, case.fluid, P.device
    fns = {"farfield": flow_bc(fl, case.P_inf, device=dev),
           "wall": flow_bc(fl, [float(case.P_inf[0]),
                                float(case.P_inf[1]), 0.0],
                           normal_flow=True, device=dev)}

    def bcs(P):
        for name in ("farfield", "wall"):
            P = dom.impose_bc(
                name, lambda b, Pi, bc=fns[name]: apply_flow_bc(
                    bc, Pi, b.normals), P)
        return P

    part = dom.partitions[0]
    P = bcs(P)
    dt = local_timestep(part, fl, P, case.cfl)[:, None]
    Q0 = primitive2state(fl, P)
    R0 = euler_rhs(part, fl, P)
    P1 = bcs(state2primitive(fl, Q0 + dt * R0))
    R1 = euler_rhs(part, fl, P1)
    return bcs(state2primitive(fl, Q0 + dt * (R0 + R1) / 2))


def _sharded_rank(device, smi, wing_dir):
    """Phase 24 on one of four ranks (spawned; gloo with CUDA tensors, all
    on the one card): the sharded marches against the single-device ones
    on the card, the kernels' launches and the kernels against their plain
    versions on this rank's local grid; then the wing's four-rank part of
    phase 27 against the one-rank run in ``wing_dir``."""
    import torch.distributed as dist

    from ibx_torch.cases import (build_rae2822, build_rae2822_block_sharded,
                                 build_rae2822_sharded, build_sphere3d,
                                 build_sphere3d_block_sharded)
    from ibx_torch.ops import kernels as K

    rank = dist.get_rank()
    dev = torch.device(device)
    zero = dict.fromkeys(K.launches, 0)

    def rlog(*a):
        log(f"[ranks {rank}]", *a)

    def rcheck(name, value, tol):
        ok = value < tol
        rlog(f"{name}: {value:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rank {rank}: {name}: {value:.3e}")

    # the block march (2D, no kernel), plain and with the overlap split
    case = build_rae2822(device=dev, **SHARD_RAE)
    P, res = case.P0, None
    for _ in range(SHARD_STEPS):
        P, res = case.step(P)
    ref, res_ref = P.cpu(), float(res)
    K.reset_launches()
    for overlap in (False, True):
        sbd, step, P, _ = build_rae2822_block_sharded(
            SHARD_RANKS, case=case, cfl=case.cfl, overlap=overlap)
        assert sbd.mesh.staged == (dev.type == "cuda")
        assert sbd.overlap == overlap
        if not overlap:
            rlog(f"RAE2822 {SHARD_RAE}: {case.dom.ncells} cells, "
                 f"{sbd.B} blocks, chunk {sbd.chunk}, B_loc {sbd.B_loc}, "
                 f"{len(sbd.halo[rank])} halo blocks, offsets {sbd.offs}")
        for _ in range(SHARD_STEPS):
            P, res = step(P)
        out = torch.as_tensor(sbd.collect(P))
        rcheck(f"block march, overlap={overlap}, {SHARD_STEPS} steps vs "
               f"one device (per channel)", chan_err(ref, out),
               SHARD_BLOCK_TOL)
        rcheck("resnorm (relative)", abs(float(res) - res_ref) / res_ref,
               SHARD_RES_RTOL)
    assert dict(K.launches) == zero, K.launches

    # the gather march (no kernel), from the sharded case's initial state,
    # against its scheme on one partition (family-by-family BCs, no freeze
    # mask: the JAX package's sharded step)
    sdom, gstep, P, _ = build_rae2822_sharded(SHARD_RANKS, device=dev,
                                              **SHARD_RAE)
    one = build_rae2822(use_blocks=False, device=dev, **SHARD_RAE)
    Pg = torch.as_tensor(sdom.collect(P), device=dev)
    rlog(f"gather march: n_own {sdom.n_own}, skirt {sdom.n_skirt} rows, "
         f"offsets {list(sdom.offsets)}")
    for _ in range(SHARD_GATHER_STEPS):
        (P,) = gstep(P)
        Pg = gather_step_one(one, Pg)
    rcheck(f"gather march, {SHARD_GATHER_STEPS} steps vs one device (per "
           f"channel)", chan_err(Pg.cpu(), torch.as_tensor(sdom.collect(P))),
           SHARD_GATHER_TOL)
    assert dict(K.launches) == zero, K.launches
    del case, one

    # the 3D sphere on the channel-split march: passes A and B and the
    # update on this rank's local grid and own chunk
    sph = build_sphere3d(wall_h=SHARD_SPHERE_WALL_H, device=dev)
    ref = {1: sph.step(sph.P0)[0].cpu(),
           5: sph.march(sph.P0, 5, graph=False).cpu()}
    sbd, step, P, _ = build_sphere3d_block_sharded(SHARD_RANKS, case=sph,
                                                   cfl=sph.cfl)
    bt = sbd.bt
    rlog(f"sphere wall_h={SHARD_SPHERE_WALL_H}: {sph.dom.ncells} cells, "
         f"{sbd.B} blocks of {sbd.bs}^3, chunk {sbd.chunk}, B_loc "
         f"{sbd.B_loc}, {len(sbd.halo[rank])} halo blocks, offsets "
         f"{sbd.offs}, {bt.n_sparse} leftover faces on the local grid, "
         f"channel-split {sbd.use_cs}")
    assert sbd.use_cs
    K.reset_launches()
    outs = {}
    for i in range(5):
        P, res = step(P)
        if i in (0, 4):
            outs[i + 1] = torch.as_tensor(sbd.collect(P))
    launches = dict(K.launches)
    want = dict(rk2_update=2, euler_pass_a=2, euler_pass_b=2,
                euler_pass_b_fold=0)
    if dev.type == "cuda":
        assert launches == {k: 5 * n for k, n in want.items()}, launches
    else:
        assert launches == zero, launches
    rlog(f"sphere launches over 5 steps {launches}")
    for n, tol in SHARD_SPHERE_TOL.items():
        rcheck(f"sphere channel-split, {n} step(s) vs one device (per "
               f"channel)", chan_err(ref[n], outs[n]), tol)
    loc = sbd.exchange(P)
    fl = sph.fluid
    du, aux = K.euler_pass_a(fl, loc, bt.meta, bt.nbr_table, with_dt=True)
    du_r, aux_r = K.euler_pass_a_ref(fl, loc, bt.meta, bt.nbr_table,
                                     with_dt=True)
    rcheck("euler_pass_a du on the local grid", chan_err(du_r, du),
           TOL["du"])
    rcheck("euler_pass_a aux on the local grid", chan_err(aux_r, aux),
           TOL["aux"])
    nu = torch.full_like(aux[:, :1], 1e-7)
    for d in range(3):
        nu = torch.maximum(nu, (1e-7 + aux[:, d:d + 1].abs())
                           / (1e-7 + aux[:, 3 + d:4 + d]))
    R = K.euler_pass_b(fl, loc, du, nu, bt.meta, bt.nbr_table,
                       high_order=True)
    R_r = K.euler_pass_b_ref(fl, loc, du, nu, bt.meta, bt.nbr_table,
                             high_order=True)
    rcheck("euler_pass_b R on the local grid", chan_err(R_r, R), TOL["R"])
    # the exchange alone: staged through host tensors under gloo
    nbytes = sum(sbd.S[o] for o in sbd.offs) * P[0].numel() * 4
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        sbd.exchange(P)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rlog(f"exchange of {nbytes} bytes received a rank: "
         f"{(time.perf_counter() - t0) / 10 * 1e3:.3f} ms a call (host "
         f"clock, 10 calls; gloo, staged through host tensors "
         f"{sbd.mesh.staged}); card: {smi}")
    del sph, sbd, step, P, loc
    _wing_ranks(dev, rlog, rcheck, wing_dir)


def _wing_ranks(dev, rlog, rcheck, wing_dir):
    """Phase 27 on one of the four ranks: the wing at the JAX test's size
    on the rank's chunk, 10 steps and one FAS cycle against the one-rank
    run of this card (the JAX test's bounds); no kernel launched."""
    from ibx_torch.cases import build_wing3d_rans_fas
    from ibx_torch.ops import kernels as K

    wc = build_wing3d_rans_fas(SHARD_RANKS, device=dev, **WING_SMALL)
    one = np.load(Path(wing_dir) / "wing1.npz")
    K.reset_launches()
    march = torch.as_tensor(wc.collect(wc.march(wc.S0_sh,
                                                WING_RANKS_STEPS)))
    cycle = torch.as_tensor(wc.collect(wc.fas_cycle(wc.S0_sh)[0]))
    rcheck(f"wing, {WING_RANKS_STEPS} steps, four ranks vs one (per "
           f"channel)", chan_err(torch.as_tensor(one["march"]), march),
           WING_MARCH_TOL)
    rcheck("wing, one FAS cycle, four ranks vs one (per channel)",
           chan_err(torch.as_tensor(one["cycle"]), cycle), WING_CYCLE_TOL)
    assert dict(K.launches) == dict.fromkeys(K.launches, 0), K.launches


def wing_physical(Sn):
    """tests/test_wing3d_fas.py:47-57: finite, p in (1e3, 1e6), T > 50 K,
    Rt >= 0 on every cell of the flat fused state ``Sn``."""
    assert np.isfinite(Sn).all(), "non-finite wing state"
    assert Sn[:, 0].min() > 1e3 and Sn[:, 0].max() < 1e6
    assert (Sn[:, 1] > 50.0).all() and (Sn[:, 5] >= 0.0).all()


def sharded_ranks(smi, wing_dir):
    """Phase 24 (and phase 27's four ranks): four gloo ranks on the one
    card (NCCL refuses two ranks on one device), asked for explicitly."""
    from ibx_torch.parallel import spawn

    t0 = time.perf_counter()
    spawn(_sharded_rank, SHARD_RANKS, backend="gloo", device="cuda",
          args=("cuda", smi, str(wing_dir)), threads=2)
    log(f"[ranks] phase 24 ({SHARD_RANKS} gloo ranks on one card) took "
        f"{time.perf_counter() - t0:.1f} s")


def wing_err(ref, out):
    """(flow channels per channel over their scale, Rt over max |Rt|) of
    two fused wing states [N, 6]."""
    ref, out = torch.as_tensor(ref), torch.as_tensor(out)
    return chan_err(ref[:, :5], out[:, :5]), rel_max(ref[:, 5], out[:, 5])


def wing_channels(label, ref, out):
    """Print the per-channel max |out - ref| of two fused wing states
    [N, 6], each over that channel's max |ref| (the scale the checks
    use), beside the scales and the largest |V| of ``ref``."""
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = np.abs(ref).max(0)
    err = np.abs(out - ref).max(0)
    v = float(np.sqrt((ref[:, 2:5] ** 2).sum(1)).max())
    names = ("p", "T", "u", "v", "w", "Rt")
    log(f"  [{label}] per channel, max abs error / max |ref|: "
        + ", ".join(f"{n} {e:.3e}/{c:.4e} = {e / c:.3e}"
                    for n, e, c in zip(names, err, scale))
        + f"; max |V| {v:.4e}")


def ulp_jitter(S, seed=0):
    """``S`` with every nonzero entry moved one ulp up or down at random."""
    rng = np.random.default_rng(seed)
    sign = torch.as_tensor(rng.choice([-1.0, 1.0], S.numel())
                           .astype(np.float32)).view_as(S).to(S.device)
    return torch.where(S != 0, torch.nextafter(S, S + sign * torch.inf), S)


def wing_small(smi, wing_dir):
    """Phase 27 in this process: the wing at the JAX test's size on one
    rank, card against CPU (2 steps and one FAS cycle, the RANS
    tolerances); the one-rank run the four ranks of phase 24 are held
    to (10 steps, one cycle) goes to ``wing_dir``; then the JAX test's
    physical check on the card (twice 20 steps and a cycle)."""
    from ibx_torch.cases import build_wing3d_rans_fas
    from ibx_torch.ops import kernels as K

    t0 = time.perf_counter()
    with one_rank_group("gloo"):
        cpu = build_wing3d_rans_fas(1, device="cpu", **WING_SMALL)
        gpu = build_wing3d_rans_fas(1, device="cuda", **WING_SMALL)
        assert gpu.dom.ncells == WING_SMALL_CELLS, gpu.dom.ncells
        log(f"[wing-small] build_wing3d_rans_fas(1, {WING_SMALL}): "
            f"{gpu.dom.ncells} cells, card vs CPU")
        K.reset_launches()
        for label, run in (
                (f"{WING_STEPS} steps", lambda c: c.march(c.S0_sh,
                                                         WING_STEPS)),
                ("one FAS cycle", lambda c: c.fas_cycle(c.S0_sh)[0])):
            ref, out = cpu.collect(run(cpu)), gpu.collect(run(gpu))
            wing_channels(f"{label}, card vs CPU", ref, out)
            e_flow, e_rt = wing_err(ref, out)
            check(f"{label}, flow (per channel)", e_flow, STEP_TOL)
            check(f"{label}, Rt (of max |Rt|)", e_rt, RANS_RT_TOL)
        # what sets the cycle's card-vs-CPU error (ref, out: the cycle's):
        # the card against itself (the 2:1 faces' index_add_ is atomic
        # there), and the CPU's own cycle from S0 moved by one ulp at
        # random in every entry
        cyc = gpu.collect(gpu.fas_cycle(gpu.S0_sh)[0])
        wing_channels("one FAS cycle, card vs card", out, cyc)
        wing_channels("one FAS cycle, CPU vs CPU from S0 +- 1 ulp", ref,
                      cpu.collect(cpu.fas_cycle(ulp_jitter(cpu.S0_sh))[0]))
        one = dict(march=gpu.collect(gpu.march(gpu.S0_sh,
                                               WING_RANKS_STEPS)),
                   cycle=gpu.collect(gpu.fas_cycle(gpu.S0_sh)[0]))
        np.savez(Path(wing_dir) / "wing1.npz", **one)
        S = gpu.S0_sh
        for _ in range(2):
            S = gpu.march(S, 20)
            S, _ = gpu.fas_cycle(S)
        Sn = gpu.collect(S)
        log(f"[wing-small] after 2 x (20 steps + a cycle): finite "
            f"{bool(np.isfinite(Sn).all())}, p {Sn[:, 0].min():.1f} to "
            f"{Sn[:, 0].max():.1f}, T min {Sn[:, 1].min():.2f}, Rt min "
            f"{Sn[:, 5].min():.3e}")
        wing_physical(Sn)
        assert dict(K.launches) == dict.fromkeys(K.launches, 0), K.launches
    log(f"[wing-small] phase 27, one rank, took "
        f"{time.perf_counter() - t0:.1f} s; card: {smi}")


def wing_forces(wc, S):
    """(Cl, Cd, wall Cp) of the flat fused state ``S`` from the
    wall-sampled pressure (chord 1, span from the case): the port's copy
    of scripts/wing3d_converge.py:wing_forces."""
    from ibx_torch.physics.fluid import pressure_coefficient

    surf = wc.dom.surfaces["wall"]
    p_wall = surf(torch.as_tensor(S)[:, 0])
    P_inf = wc.P_inf
    mach = float(np.hypot(P_inf[2], P_inf[3])
                 / np.sqrt(1.4 * 283.0 * P_inf[1]))
    cp = pressure_coefficient(wc.fluid, p_wall, float(P_inf[0]),
                              mach).cpu().numpy()
    f = -cp[:, None] * surf.normals * surf.areas[:, None]
    F = f.sum(axis=0)
    al = np.arctan2(float(P_inf[3]), float(P_inf[2]))
    area = float(np.abs(surf.normals * surf.areas[:, None]).sum(0)[1]) / 2
    drag = (F[0] * np.cos(al) + F[1] * np.sin(al)) / max(area, 1e-9)
    lift = (-F[0] * np.sin(al) + F[1] * np.cos(al)) / max(area, 1e-9)
    return float(lift), float(drag), cp


def wing_full(root, smi):
    """Phase 28: the wing at its defaults (466,432 cells) on one NCCL rank
    (this process), from the converged state of the committed oracle: its
    wall Cp and Cl, 100 steps inside the oracle's Cl tail band with the
    residual near the oracle's, one FAS cycle finite and physical; ms a
    step and a cycle, the card's busy time, build s, peak memory; no
    kernel launched."""
    from ibx_torch.cases import build_wing3d_rans_fas
    from ibx_torch.ops import kernels as K

    ref = np.load(root / WING_ORACLE)
    hist = ref["hist"]
    tail = hist[3 * len(hist) // 4:, 2]
    band = 3 * tail.std() + 1e-4
    l2_ref = float(hist[-1, 1])
    zero = dict.fromkeys(K.launches, 0)
    t_phase = time.perf_counter()
    with one_rank_group("nccl"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wc = build_wing3d_rans_fas(1, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        assert wc.dom.ncells == WING_CELLS == ref["S"].shape[0]
        S0 = torch.as_tensor(ref["S"], device="cuda")
        cl0, cd0, cp0 = wing_forces(wc, S0)
        log(f"[wing-full] build_wing3d_rans_fas(1) at its defaults: "
            f"{wc.dom.ncells} cells, {wc.sbd.B} blocks of "
            f"{wc.sbd.bs}^3, build {build_s:.1f} s; from {WING_ORACLE}: "
            f"Cl {cl0:.6f} (oracle {float(ref['cl']):.6f}), Cd {cd0:.6f}")
        check("wall Cp of the oracle's state vs its cp (absolute)",
              float(np.abs(cp0 - ref["cp"]).max()), WING_CP_TOL)
        check("Cl of the oracle's state vs its cl (absolute)",
              abs(cl0 - float(ref["cl"])), WING_CL_TOL)
        S = wc.sbd.distribute(S0)
        del S0
        t0 = time.perf_counter()
        S = wc.march(S, 2)
        torch.cuda.synchronize()
        log(f"[wing-full] {time.perf_counter() - t_phase:.1f} s into the "
            f"phase; 2 warm-up steps {time.perf_counter() - t0:.1f} s")
        K.reset_launches()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        S = wc.march(S, WING_FULL_STEPS)
        e1.record()
        e1.synchronize()
        host_ms = (time.perf_counter() - t0) / WING_FULL_STEPS * 1e3
        ms_step = e0.elapsed_time(e1) / WING_FULL_STEPS
        Sn = wc.collect(S)
        cl, cd, _ = wing_forces(wc, torch.as_tensor(Sn, device="cuda"))
        l2, mx = (float(v) for v in wc.res_norms(S))
        log(f"[wing-full] {WING_FULL_STEPS} steps: {ms_step:.3f} ms/step "
            f"(CUDA events; host clock {host_ms:.3f}), "
            f"{wc.dom.ncells * 1e3 / ms_step:.4e} cell-updates/s; Cl "
            f"{cl:.6f} (oracle tail {tail.mean():.6f} +- {band:.6f}), Cd "
            f"{cd:.6f}; res_norms L2 {l2:.4e} (oracle's last "
            f"{l2_ref:.4e}), max {mx:.4e}")
        assert np.isfinite(Sn).all(), "non-finite wing state"
        assert abs(cl - tail.mean()) < band, (cl, tail.mean(), band)
        assert 0.5 * l2_ref < l2 < 2.0 * l2_ref, (l2, l2_ref)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        S, res = wc.fas_cycle(S)
        e1.record()
        e1.synchronize()
        host_cycle = (time.perf_counter() - t0) * 1e3
        ms_cycle = e0.elapsed_time(e1)
        Sn = wc.collect(S)
        launches = dict(K.launches)
        peak = torch.cuda.max_memory_allocated()
        log(f"[wing-full] one FAS cycle (n_coarse_iter 8): {ms_cycle:.1f} "
            f"ms (CUDA events; host clock {host_cycle:.1f}), residual "
            f"{float(res):.4e}; finite {bool(np.isfinite(Sn).all())}, p "
            f"{Sn[:, 0].min():.1f} to {Sn[:, 0].max():.1f}, T min "
            f"{Sn[:, 1].min():.2f}, Rt min {Sn[:, 5].min():.3e}; peak "
            f"memory {peak / 2**30:.3f} GiB over its build and march "
            f"({base / 2**30:.3f} GiB held before them); launches "
            f"{launches}")
        wing_physical(Sn)
        assert launches == zero, launches
        acts, busy_ms, _ = profile_busy(lambda: wc.march(S, 1), 1,
                                        "wing-full", ms_step)
        del wc, S
    out = dict(ms_step=ms_step, host_ms=host_ms, busy_ms=busy_ms,
               activities=acts, ms_cycle=ms_cycle, build_s=build_s,
               peak_gib=peak / 2**30, cl=cl)
    log(f"[wing-full] phase 28 took {time.perf_counter() - t_phase:.1f} s; "
        f"card: {smi}; " + json.dumps({k: round(v, 6) for k, v in
                                       out.items()}))
    return out


def block_walls(root, dev, smi):
    """Phase 29: the block march's mirrored and cut-cell walls: one step
    card vs CPU of each at 16,768 cells, then the 881,152-cell flagship
    with ``cutcell=True`` 50 steps from the freestream (finite, ms a step,
    the card's busy time, build s); no kernel launched."""
    from ibx_torch.cases import build_rae2822
    from ibx_torch.ops import kernels as K

    zero = dict.fromkeys(K.launches, 0)
    t_phase = time.perf_counter()
    K.reset_launches()
    for opt in ("mirror_wall", "cutcell"):
        kw = dict(WALLS_SMALL, **{opt: True})
        card = build_rae2822(device=dev, **kw)
        cpu = build_rae2822(device="cpu", **kw)
        log(f"[walls] build_rae2822({kw}) ({card.dom.ncells} cells), block "
            f"march, one step card vs CPU")
        P = perturbed2d(cpu, seed=9)
        ref, res_ref = cpu.step(P)
        out, res = card.step(P.to(dev))
        check("state (per channel)", chan_err(ref, out.cpu()), STEP_TOL)
        check("resnorm (relative)",
              abs(float(res) - float(res_ref)) / float(res_ref), RES_TOL)
    del card, cpu
    assert dict(K.launches) == zero, K.launches
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    case = build_rae2822(device=dev, cutcell=True, **RAE_FLAGSHIP)
    assert case.dom.ncells == RAE_CELLS, case.dom.ncells
    P = case.march(case.P0, 2)
    torch.cuda.synchronize()
    K.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    P = case.march(P, CUT_FULL_STEPS)
    e1.record()
    e1.synchronize()
    host_ms = (time.perf_counter() - t0) / CUT_FULL_STEPS * 1e3
    ms_step = e0.elapsed_time(e1) / CUT_FULL_STEPS
    launches = dict(K.launches)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(P).all())
    log(f"[walls] build_rae2822({RAE_FLAGSHIP}, cutcell=True): "
        f"{case.dom.ncells} cells, {int(case.cut3['wall_cells'].shape[0])} "
        f"wall cells, cut faces a dim "
        f"{[int(o.shape[0]) for o in case.cut3['owner']]}, build "
        f"{case.build_seconds:.1f} s; {CUT_FULL_STEPS} steps from the "
        f"freestream: {ms_step:.3f} ms/step (CUDA events; host clock "
        f"{host_ms:.3f}), finite {finite}, peak memory "
        f"{(peak - base) / 2**30:.3f} GiB above what was held; launches "
        f"{launches}")
    assert finite, "non-finite cut-cell flagship state"
    assert launches == zero, launches
    _, busy_ms, _ = profile_busy(lambda: case.march(P, 5), 5, "walls",
                                 ms_step)
    log(f"[walls] phase 29 took {time.perf_counter() - t_phase:.1f} s; "
        f"card: {smi}")
    return dict(ms_step=ms_step, host_ms=host_ms, busy_ms=busy_ms,
                build_s=case.build_seconds)


def sharded_flagship(root, case, smi, blk):
    """Phase 25: the 881,152-cell flagship through the sharded block march
    on one rank (NCCL, this process), beside the single-device block
    march's numbers of phases 9 and 10 (``blk``)."""
    from ibx_torch.cases import build_rae2822_block_sharded
    from ibx_torch.cases import force_coefficients
    from ibx_torch.ops import kernels as K

    zero = dict.fromkeys(K.launches, 0)
    with one_rank_group("nccl"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sbd, step, _, _ = build_rae2822_block_sharded(
            1, case=case, cfl=case.cfl, overlap=True)
        build_s = time.perf_counter() - t0
        assert not sbd.overlap and sbd.mesh.backend == "nccl"
        ref = np.load(root / RAE_ORACLE)
        P = sbd.distribute(case.apply_bcs(
            torch.as_tensor(ref["P"], device=case.P0.device)))
        P = sbd.march(P, 2)
        torch.cuda.synchronize()
        K.reset_launches()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        P = sbd.march(P, SHARD_FULL_STEPS)
        e1.record()
        e1.synchronize()
        host_ms = (time.perf_counter() - t0) / SHARD_FULL_STEPS * 1e3
        ms_step = e0.elapsed_time(e1) / SHARD_FULL_STEPS
        launches = dict(K.launches)
        peak = torch.cuda.max_memory_allocated()
        Pf = torch.as_tensor(sbd.collect(P), device=case.P0.device)
        finite = bool(torch.isfinite(Pf).all())
        cl, cd = force_coefficients(case, Pf)
        log(f"[shard25] build_rae2822_block_sharded(1, overlap=True) on the "
            f"{case.dom.ncells}-cell flagship: tables {build_s:.1f} s, "
            f"B_loc {sbd.B_loc} (chunk {sbd.chunk} + dump), overlap "
            f"{sbd.overlap} at one rank; {SHARD_FULL_STEPS} steps from the "
            f"oracle: {ms_step:.3f} ms/step (CUDA events; host clock "
            f"{host_ms:.3f}), Cl {cl:.5f}, Cd {cd:.5f}, finite {finite}, "
            f"peak memory {peak / 2**30:.3f} GiB over its build and march "
            f"({base / 2**30:.3f} GiB held before them), launches "
            f"{launches}")
        assert finite, "non-finite state on the one-rank sharded march"
        assert launches == zero, launches
        assert CL_BAND[0] < cl < CL_BAND[1], cl
        _, busy_ms, _ = profile_busy(lambda: sbd.march(P, 5), 5, "shard25",
                                     ms_step)
    log(f"[shard25] one rank vs one device (phases 9-10 of this run): "
        f"{ms_step:.3f} vs {blk['ms_step']:.3f} ms/step, device busy "
        f"{busy_ms:.3f} vs {blk['busy_ms']:.3f} ms a step; card: {smi}")


def sharded_sphere_full(case, smi, cs_ms_step):
    """Phase 26: the 5,308,416-cell sphere through the sharded
    channel-split march on one rank (NCCL, this process); returns its
    kernel launches a step."""
    from ibx_torch.cases import build_sphere3d_block_sharded
    from ibx_torch.ops import kernels as K

    _, busy_one, _ = profile_busy(lambda: case.march(case.P0, 3), 3,
                                  "shard26-one-device", cs_ms_step)
    with one_rank_group("nccl"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sbd, step, P0, _ = build_sphere3d_block_sharded(1, case=case,
                                                        cfl=case.cfl)
        build_s = time.perf_counter() - t0
        assert sbd.use_cs and sbd.B_loc == sbd.B + 1
        P = sbd.march(P0, 2)
        torch.cuda.synchronize()
        K.reset_launches()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        P = sbd.march(P, SHARD_SPHERE_STEPS)
        e1.record()
        e1.synchronize()
        host_ms = (time.perf_counter() - t0) / SHARD_SPHERE_STEPS * 1e3
        ms_step = e0.elapsed_time(e1) / SHARD_SPHERE_STEPS
        launches = dict(K.launches)
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(P).all())
        log(f"[shard26] build_sphere3d_block_sharded(1) on the "
            f"{case.dom.ncells}-cell sphere: tables {build_s:.1f} s, B_loc "
            f"{sbd.B_loc}; {SHARD_SPHERE_STEPS} steps: {ms_step:.3f} "
            f"ms/step (CUDA events; host clock {host_ms:.3f}), finite "
            f"{finite}, peak memory {peak / 2**30:.2f} GiB over its build "
            f"and march ({base / 2**30:.2f} GiB held before them), "
            f"launches {launches}")
        assert finite
        want = dict(rk2_update=2, euler_pass_a=2, euler_pass_b=2,
                    euler_pass_b_fold=0)
        assert launches == {k: n * SHARD_SPHERE_STEPS
                            for k, n in want.items()}, launches
        _, busy_ms, _ = profile_busy(lambda: sbd.march(P, 3), 3, "shard26",
                                     ms_step)
        out = torch.as_tensor(sbd.collect(sbd.march(P0, 5)))
        ref = case.march(case.P0, 5).cpu()
        log("[shard26] 5 steps on one rank vs the single-device "
            "channel-split march")
        check("state (per channel)", chan_err(ref, out), SHARD_ONE_RANK_TOL)
    log(f"[shard26] one rank vs one device (phase 5 of this run): "
        f"{ms_step:.3f} vs {cs_ms_step:.3f} ms/step, device busy "
        f"{busy_ms:.3f} vs {busy_one:.3f} ms a step; card: {smi}")
    return {k: launches[k] // SHARD_SPHERE_STEPS for k in launches}


def kernel_name_counts(events):
    """Launches of each kernel counter's kernel among the device events of
    a `torch.profiler` trace, by the kernel's name (demangled or not)."""
    from ibx_torch.ops import kernels as K

    counts = dict.fromkeys(K.launches, 0)
    for e in events:
        n = e.name
        if "rk2_update_kernel" in n:
            counts["rk2_update"] += 1
        elif "euler_pass_a_kernel" in n:
            counts["euler_pass_a"] += 1
        elif "euler_pass_b_kernel" in n:
            m = re.search(r"euler_pass_b_kernel<\s*\d+\s*,\s*([^>]+)>", n) \
                or re.search(r"euler_pass_b_kernelILi\d+ELb(\d)E", n)
            fold = m is not None and m.group(1).strip() in ("true", "1")
            counts["euler_pass_b_fold" if fold else "euler_pass_b"] += 1
    return counts


def device_trace(fn, n_steps):
    """One `torch.profiler` trace of ``fn`` (``n_steps`` steps): (device
    busy ms a step, device activities a step, launches a step of each
    kernel by name)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    assert ev and busy > 0, "torch.profiler recorded no device time"
    named = {k: v / n_steps for k, v in kernel_name_counts(ev).items()}
    return busy / n_steps, len(ev) / n_steps, named


def state_err(ref, out):
    """`chan_err` over a state: a tensor [N, C] or [N], or a tuple of
    them (the RANS marches' (P, Rt))."""
    if isinstance(ref, tuple):
        return max(state_err(a, b) for a, b in zip(ref, out))
    if ref.dim() == 1:
        ref, out = ref[:, None], out[:, None]
    return chan_err(ref, out)


def state_equal(a, b):
    if isinstance(a, tuple):
        return all(state_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def timed_march(march, X, n, graph):
    """(ms a step by CUDA events, ms a step by the host clock) of ``n``
    steps of ``march``."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    march(X, n, graph=graph)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n, (time.perf_counter() - t0) / n * 1e3


def graph_phase(tag, march, X, want=None, case=None, timed=GRAPH_TIMED):
    """Phase 30 for one march, ``march(X, n, graph=...)`` from the state
    ``X``: GRAPH_STEPS captured steps against as many eager ones
    (bit-equal, or within eager's own spread where that is not 0 and at
    most GRAPH_TOL), launches a step by the counters and by the kernels'
    names in a `torch.profiler` trace (the graph's equal to eager's, and
    to ``want`` where given), ms a step and busy ms a step each way, peak
    memory each way and the memory the captured step keeps. With ``case``
    the march captures into a fresh `Graphs` of the case's (its own
    graphs come back after), so that the capture and its pool are this
    phase's; without it, call this before the march's first graphed
    call. Appends its row to GRAPH_ROWS."""
    if case is not None:
        from ibx_torch.utils.graphs import Graphs

        keep, case._graphs = case._graphs, Graphs()
        try:
            return graph_phase(tag, march, X, want, None, timed)
        finally:
            case._graphs = keep
    from ibx_torch.ops import kernels as K

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    eager = march(X, GRAPH_STEPS, graph=False)
    eager_counts = {k: v / GRAPH_STEPS for k, v in K.launches.items()}
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base
    spread = state_err(eager, march(X, GRAPH_STEPS, graph=False))
    # the first graphed call captures (after one eager warm-up step)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    march(X, 1, graph=True)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph_peak = torch.cuda.max_memory_allocated() - base
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - reserved0
    K.reset_launches()
    out = march(X, GRAPH_STEPS, graph=True)
    graph_counts = {k: v / GRAPH_STEPS for k, v in K.launches.items()}
    equal = state_equal(eager, out)
    err = 0.0 if equal else state_err(eager, out)
    # one step each way under the profiler: the kernels by name
    busy_e, acts_e, named_e = device_trace(
        lambda: march(X, 1, graph=False), 1)
    busy_g, acts_g, named_g = device_trace(
        lambda: march(X, 1, graph=True), 1)
    ms_e, host_e = timed_march(march, X, timed, False)
    ms_g, host_g = timed_march(march, X, timed, True)
    row = dict(march=tag, steps=GRAPH_STEPS, bit_equal=equal, err=err,
               eager_spread=spread, launches_a_step=graph_counts,
               ms_graph=ms_g, ms_eager=ms_e, host_ms_graph=host_g,
               host_ms_eager=host_e, busy_ms_graph=busy_g,
               busy_ms_eager=busy_e, activities_graph=acts_g,
               activities_eager=acts_e, capture_s=capture_s,
               peak_gib_eager=eager_peak / 2**30,
               peak_gib_graph=graph_peak / 2**30,
               graph_pool_gib=held / 2**30)
    log(f"[graph] {tag}: {GRAPH_STEPS} steps graphed vs eager: "
        f"{'bit-equal' if equal else f'max per-channel error {err:.3e}'} "
        f"(eager vs eager {spread:.3e}); launches a step by counter "
        f"{graph_counts} (eager {eager_counts}), by kernel name in one "
        f"replay {named_g} (eager step {named_e}); ms a step {ms_g:.3f} "
        f"graphed vs {ms_e:.3f} eager (CUDA events over {timed}; host "
        f"clock {host_g:.3f} vs {host_e:.3f}); device busy {busy_g:.3f} "
        f"vs {busy_e:.3f} ms a step in {acts_g:.0f} vs {acts_e:.0f} "
        f"activities; warm-up, capture and one replay {capture_s:.2f} s; "
        f"peak memory {graph_peak / 2**30:.3f} GiB over them vs "
        f"{eager_peak / 2**30:.3f} over the eager march (above what was "
        f"held), kept by the captured step (its pool and state) "
        f"{held / 2**30:.3f} GiB; "
        f"{time.perf_counter() - t_phase:.1f} s")
    GRAPH_ROWS.append(row)
    if not equal:
        assert 0.0 < spread <= GRAPH_TOL and err <= spread, (tag, err,
                                                             spread)
    assert graph_counts == eager_counts == named_g == named_e, (
        tag, graph_counts, eager_counts, named_g, named_e)
    if want is not None:
        assert graph_counts == {k: float(want.get(k, 0))
                                for k in K.launches}, (tag, graph_counts)
    return row


def sphere_graph_phases(case, smi):
    """Phases 30 and 32 on phase 5's sphere (5,308,416 cells): the
    channel-split march and the grid march with and without the fold and
    with frozen gradients, graphed against eager; then the padded
    formulation of `face_accumulate` against concat on the grid march
    (where the kernel route leaves it off the path) and on the grid march
    with frozen gradients (whose stage 2 is the torch-op body)."""
    t0 = time.perf_counter()
    P = case.P0
    for tag, kw, want in (
            ("sphere channel-split", {}, dict(
                rk2_update=2, euler_pass_a=2, euler_pass_b=2)),
            ("sphere grid, fold", dict(grid=True, fold=True), dict(
                euler_pass_a=2, euler_pass_b=1, euler_pass_b_fold=1)),
            ("sphere grid", dict(grid=True), dict(
                euler_pass_a=2, euler_pass_b=2)),
            ("sphere grid, frozen gradients",
             dict(grid=True, freeze_gradients=True), dict(
                 euler_pass_a=1, euler_pass_b=1))):
        graph_phase(tag, lambda X, n, graph, kw=kw: case.march(
            X, n, graph=graph, **kw), P, want, case=case)
    log(f"[graph] phase 30 on the 3D block marches took "
        f"{time.perf_counter() - t0:.1f} s; card: {smi}")
    t0 = time.perf_counter()
    for tag, kw in (("sphere grid, fold", dict(grid=True, fold=True)),
                    ("sphere grid, frozen gradients",
                     dict(grid=True, freeze_gradients=True))):
        padded_phase(tag, lambda X, n, graph, kw=kw: case.march(
            X, n, graph=graph, **kw), P)
    log(f"[padded] phase 32 on the sphere took "
        f"{time.perf_counter() - t0:.1f} s; card: {smi}")


def padded_phase(tag, march, X, n=PADDED_STEPS):
    """Phase 32 for one march: ``n`` eager steps under the padded
    formulation of `face_accumulate` against the concat one (bit-equal),
    and the device's busy ms a step of each, traced in turns (concat,
    padded, padded, concat)."""
    from ibx_torch.ops import block_ops as bo

    outs, busy = {}, {False: [], True: []}
    try:
        for padded in (False, True, True, False):
            bo._PADDED_FACES = padded
            if padded not in outs:
                outs[padded] = march(X, n, graph=False)
            busy[padded].append(device_trace(
                lambda: march(X, n, graph=False), n)[0])
    finally:
        bo._PADDED_FACES = False
    equal = state_equal(outs[False], outs[True])
    bc, bp = (sum(busy[k]) / 2 for k in (False, True))
    log(f"[padded] {tag}: {n} eager steps padded vs concat "
        f"{'bit-equal' if equal else 'DIFFER'}; device busy ms a step "
        f"concat {busy[False][0]:.3f}, {busy[False][1]:.3f}; padded "
        f"{busy[True][0]:.3f}, {busy[True][1]:.3f} (padded/concat "
        f"{bp / bc:.4f})")
    PADDED_ROWS.append(dict(march=tag, bit_equal=equal,
                            busy_ms_concat=busy[False],
                            busy_ms_padded=busy[True]))
    assert equal, f"{tag}: the padded formulation changed the march"


def pi3d_phase(dev, smi):
    """Phase 31: the point-implicit step at nd = 3 on the bs=8 sphere
    (wall_h=0.125, 147,456 cells) from the flow of PI3D_STEPS steps from
    the freestream: ``g`` at Q_n and its JVP card vs CPU (PI_TOL), then
    one frozen-limiter step on the card (cfl 5, relax 0.8, the freeze
    mask): finite, linear ratio under 1, its seconds; the explicit bound
    at Q_n launches pass A and pass B once (the kernel route), the
    differentiated residual none. Not from the perturbed state of phase
    3: its pressure is uniform along z, where the JST sensor's 0/0 and
    the limiter's ties sit at their kinks and an ulp moves g and its JVP
    by O(1e-1) on either device (scripts/torch_pi3d_conditioning.py)."""
    from ibx_torch.cases import build_sphere3d
    from ibx_torch.ops import kernels as K
    from ibx_torch.solve import Linearization, point_implicit_step
    from ibx_torch.solve.point_implicit_euler import newton_map

    t_phase = time.perf_counter()
    cg = build_sphere3d(wall_h=0.125, block_size=8, device=dev)
    cc = build_sphere3d(wall_h=0.125, block_size=8, device="cpu")
    P = cg.march(cg.P0, PI3D_STEPS)
    kw = dict(cfl=PI_CFL, freeze_limiter=True)
    K.reset_launches()
    gfn, Qn = newton_map(cg.bt, cg.fluid, P, cg.apply_bcs,
                         active=cg.active3.reshape(-1), **kw)
    assert dict(K.launches) == dict(rk2_update=0, euler_pass_a=1,
                                    euler_pass_b=1, euler_pass_b_fold=0), \
        K.launches
    cfn, Qnc = newton_map(cc.bt, cc.fluid, P.cpu(), cc.apply_bcs,
                          active=cc.active3.reshape(-1), **kw)
    rng = np.random.default_rng(9)
    scale = Qnc.abs().amax(dim=0).numpy()
    v = torch.as_tensor((rng.normal(size=tuple(Qnc.shape)) * 1e-3
                         * scale).astype(np.float32))
    Ac = Linearization(cfn, Qnc, cfn(Qnc))
    K.reset_launches()
    Ag = Linearization(gfn, Qn, gfn(Qn))
    Jg = Ag(v.to(dev))
    assert not any(K.launches.values()), K.launches
    log(f"[pi3d] build_sphere3d(wall_h=0.125, block_size=8) "
        f"({cg.dom.ncells} cells): the point-implicit map with the frozen "
        f"limiter, card vs CPU")
    check("g at Q_n (per channel)", chan_err(Ac.fx, Ag.fx.cpu()), PI_TOL)
    check("JVP of g (per channel)", chan_err(Ac(v), Jg.cpu()), PI_TOL)
    del cc, cfn, Ac, gfn, Ag
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P1, ratio = point_implicit_step(
        cg.bt, cg.fluid, P, cg.apply_bcs, cfl=PI_CFL, relax=PI_RELAX,
        active=cg.active3.reshape(-1), freeze_limiter=True, generator=gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    finite = bool(torch.isfinite(P1).all())
    log(f"[pi3d] point_implicit_step(cfl={PI_CFL}, relax={PI_RELAX}, "
        f"freeze_limiter=True, 8 Hutchinson samples, 8 Krylov iterations):"
        f" linear ratio {float(ratio):.4f}, finite {finite}, {secs:.3f} s "
        f"(host clock, synchronized), launches {dict(K.launches)}; phase "
        f"31 took {time.perf_counter() - t_phase:.1f} s; card: {smi}")
    assert finite and float(ratio) < 1.0, float(ratio)
    return dict(ratio=float(ratio), seconds=secs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "ibx_torch" / "csrc").is_dir():
        print(f"chip_smoke: no ibx_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from ibx_torch.ops import kernels as K

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(f"[device] {kind}; count {torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    K.build(verbose=True)
    log(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")

    rows, blk3d, case3d = sphere_phases(dev)
    t0 = time.perf_counter()
    shard = sharded_sphere_full(case3d, smi, blk3d["cs_ms_step"])
    for r in rows:
        r["sharded_launches_per_step"] = shard[r["name"]]
    log(f"[shard26] phase 26 took {time.perf_counter() - t0:.1f} s")
    sphere_graph_phases(case3d, smi)
    t0 = time.perf_counter()
    gather3d_full(smi, blk3d, case3d)
    log(f"[gather3d-full] phase 16 took {time.perf_counter() - t0:.1f} s")
    # the sphere's tensors are no longer needed: free them before the 2D
    # phases, so that their peak memory is their own
    del case3d
    gc.collect()
    torch.cuda.empty_cache()
    pi3d_phase(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    blk = rae2822_phases(root, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    gather_phases(root, dev, smi, blk)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rans_phases(dev, smi)
    log(f"[rans] phases 17-20 took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    solver_phases(root, dev, smi)
    log(f"[solve] phases 21-23 took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as wing_dir:
        wing_small(smi, wing_dir)
        sharded_ranks(smi, wing_dir)
    t0 = time.perf_counter()
    wing_full(root, smi)
    gc.collect()
    torch.cuda.empty_cache()
    block_walls(root, dev, smi)
    log(f"[new] phases 27-29 (with phase 27's four ranks inside phase 24) "
        f"after phase 24 took {time.perf_counter() - t0:.1f} s")

    log("[graph] phase 30, one row a march: " + json.dumps(GRAPH_ROWS))
    log("[padded] phase 32, one row a march: " + json.dumps(PADDED_ROWS))
    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
