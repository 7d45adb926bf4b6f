#!/usr/bin/env python3
"""Where the device time of the port's generic gather march goes.

    python3 scripts/torch_gather_profile.py [--small]

Builds `ibx_torch.cases.build_rae2822(use_blocks=False)` on the card at the
flagship size (881,152 cells; ``--small`` takes wall_h=8e-2 for a quick
look), marches 2 warm-up steps, traces 3 steps with `torch.profiler` and
prints the device kernels by total time. Then it times, with CUDA events
over 20 calls each, the pieces a step is made of at that size: a face
gather (`index_select` of the ``[N, 4]`` state by ``face_owner``), the
accumulator in its two formulations (the gathered ``[N, K, 4]`` block
reduced with ``sum(dim=1)``, as `ibx_torch.ops.stencil.apply_stencil` does
it, against a loop over k of gather * weight), an elementwise op on a face
array, and the ghost write-back (`index_copy`). Needs a CUDA device; prints
the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def time_ms(fn, reps=20):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gather_profile: no CUDA device available",
              file=sys.stderr)
        return 2
    from ibx_torch.cases import build_rae2822
    from ibx_torch.ops import operators as ops
    from ibx_torch.ops.stencil import apply_stencil, take_rows
    from ibx_torch.solve.euler import euler_rhs, local_timestep

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kw = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7) \
        if sys.argv[1:] == ["--small"] else \
        dict(wall_h=5e-4, feature_h=2.5e-4, cfl=0.7, block_size=16)
    case = build_rae2822(use_blocks=False, **kw)
    part, fl = case.dom.partitions[0], case.fluid
    print(f"card: {smi}; {case.dom.ncells} cells, faces a dim "
          f"{[int(f.shape[0]) for f in part.face_owner]}, build "
          f"{case.build_seconds:.1f} s", flush=True)
    P = case.march(case.P0, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P = case.march(P, 20)
    torch.cuda.synchronize()
    print(f"untraced: {(time.perf_counter() - t0) / 20 * 1e3:.3f} ms a step "
          f"(host clock over 20 steps)")

    n = 3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        case.march(P, n)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.device_time_total / 1e3)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:          # older layouts report device time on the CPU rows
        rows = [(e.key, e.count, e.device_time_total / 1e3)
                for e in prof.key_averages() if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    print(f"device kernels over {n} traced steps, ms a step (calls a "
          f"step), by total time; sum {total / n:.3f} ms a step:")
    for key, count, ms in rows[:25]:
        print(f"  {ms / n:8.3f} ms ({count / n:6.1f})  {key[:110]}")

    d = 0
    st = part.acc_right[d]
    uf = ops.at_faces(part, P, d)
    s1 = torch.rand(part.face_owner[d].shape[0], device=P.device)

    def acc_loop():
        out = None
        for k in range(st.width):
            t = uf.index_select(0, st.idx[:, k]) * st.w[:, k:k + 1]
            out = t if out is None else out + t
        return out

    idx_t, w_t = st.idx.t().contiguous(), st.w.t().contiguous()

    def acc_loop_t():
        out = None
        for k in range(st.width):
            t = uf.index_select(0, idx_t[k]) * w_t[k][:, None]
            out = t if out is None else out + t
        return out

    g = uf.index_select(0, st.idx.reshape(-1)).reshape(
        st.idx.shape + uf.shape[1:])
    gw = g * st.w[:, :, None]
    pieces = {
        "face gather: P.index_select(0, face_owner) [F, 4]":
            lambda: ops.at_owners(part, P, d),
        "scalar face gather: p.index_select(0, face_owner) [F]":
            lambda: ops.at_owners(part, P[:, 0], d),
        "same gather by advanced indexing P[face_owner]":
            lambda: P[part.face_owner[d]],
        "accumulator, apply_stencil (gather [N, K, 4], * w, sum(dim=1))":
            lambda: apply_stencil(st, uf),
        "  its gather alone (index_select + reshape)":
            lambda: uf.index_select(0, st.idx.reshape(-1)),
        "  its multiply alone ([N, K, 4] * [N, K, 1])":
            lambda: g * st.w[:, :, None],
        "  its reduction alone (sum(dim=1) of [N, K, 4])":
            lambda: gw.sum(dim=1),
        "accumulator, loop over k (strided index columns)": acc_loop,
        "accumulator, loop over k (contiguous index rows)": acc_loop_t,
        "accumulator on a scalar face field, apply_stencil":
            lambda: apply_stencil(st, s1),
        "elementwise add of two [F, 4] arrays": lambda: uf + uf,
        "green_gauss of a [F, 4] face field":
            lambda: ops.green_gauss(part, uf, d),
        "cell_gradient of P along one dim":
            lambda: ops.cell_gradient(part, P, d),
        "jst_sensor (all dims)": lambda: ops.jst_sensor(part, P[:, 0]),
        "euler_rhs": lambda: euler_rhs(part, fl, P),
        "local_timestep": lambda: local_timestep(part, fl, P, case.cfl),
        "ghost BC (FusedBoundary, interp + blend + index_copy)":
            lambda: case.apply_bcs(P),
        "index_copy of the ghost rows alone":
            lambda: P.index_copy(0, case.dom._ghost_global_dev["wall"][0],
                                 P[case.dom._ghost_global_dev["wall"][0]]),
    }
    # one row gather of F rows out of N, by row width, in the formulations
    # torch offers for it (all exact copies of the same rows)
    own = part.face_owner[d]
    own_strided = torch.stack([own, own], dim=1)[:, 0]
    print("row gather v[face_owner] of [N, C] float32 by formulation, ms "
          "(CUDA events over 20 calls): index_select / index_select with a "
          "strided index / advanced indexing / torch.gather with the index "
          "expanded over the row / ibx_torch.ops.stencil.take_rows")
    for C in (1, 2, 4, 5, 8, 15, 16):
        v = torch.rand((P.shape[0], C), device=P.device)
        ex = own[:, None].expand(-1, C)
        ref = v.index_select(0, own)
        assert torch.equal(ref, torch.gather(v, 0, ex))
        assert torch.equal(ref, v.index_select(0, own_strided))
        assert torch.equal(ref, take_rows(v, own))
        print(f"  C={C:2d}: {time_ms(lambda: v.index_select(0, own)):.4f} / "
              f"{time_ms(lambda: v.index_select(0, own_strided)):.4f} / "
              f"{time_ms(lambda: v[own]):.4f} / "
              f"{time_ms(lambda: torch.gather(v, 0, ex)):.4f} / "
              f"{time_ms(lambda: take_rows(v, own)):.4f}")
    err = float((acc_loop() - apply_stencil(st, uf)).abs().max())
    print(f"loop over k vs sum(dim=1): max abs difference {err:.3e}")
    print("pieces, CUDA events over 20 calls each:")
    for label, fn in pieces.items():
        print(f"  {time_ms(fn):8.4f} ms  {label}")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
