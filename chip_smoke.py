#!/usr/bin/env python3
"""Smoke run of the ibx_torch port on one NVIDIA GPU (an H100 is the
target).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:
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
     the card (5,308,416 cells), 2 warm-up steps, then 100 steps of
     `case.march` (channel-split) timed with CUDA events; each of its three
     kernels must have been launched twice a step, the fold never;
  6. grid path: from the same case, 2 warm-up steps, then 20 steps of
     `case.march(..., grid=True, fold=True)`; a step must launch pass A
     twice, pass B once in each variant and the update kernel never;
  7. per-kernel times at the main path's shapes (CUDA events over 20
     launches) beside the plain version's time and the kernel's bound,
     each kernel's registers, spills and shared memory (ptxas's build log
     and the launch's dynamic size), and a breakdown of one step of each
     march;
then one JSON line of per-kernel numbers, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.

It exits non-zero without printing a result when no CUDA device is
available or when the ibx_torch package is not beside it.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
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


def time_ms(fn, reps=20):
    """Mean ms of ``fn`` over ``reps`` calls, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


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


def interface_sides(bt):
    """Interface rows per (d, s) side: the 2:1 fold's row index counts."""
    return [int(n) for n in (bt.fold_rows >= 0).sum(dim=0).tolist()]


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
    from ibx_torch.cases import build_sphere3d
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

    log(f"[done] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
