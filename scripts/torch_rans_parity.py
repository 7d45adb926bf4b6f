#!/usr/bin/env python3
"""Print the errors behind the RANS parity tests, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_rans_parity.py

Runs the comparisons of tests/test_torch_rans.py, test_torch_rans_gather.py,
test_torch_flat_plate.py and test_torch_flat_plate_gather.py on the same
fixtures and seeded states (the RANS airfoil at wall_h=8e-2, feature_h=4e-2,
block_size=8, 16,768 cells; the flat plate at wall_h=2e-2, 9,216 cells),
and prints each measured error beside the tests' tolerance. The JAX side
runs jitted, as in the tests, and also op by op (`jax.disable_jit`) for
the airfoil's steps. Takes about 5 minutes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)

    from ibx.cases.flat_plate import build_flat_plate as jx_plate
    from ibx.cases.rae2822 import wall_cp as jx_wall_cp
    from ibx.cases.rae2822_rans import build_rae2822_rans as jx_rans
    from ibx.cases.rae2822_rans import wall_skin_friction as jx_wall_cf
    from ibx.ops import block_ops as jbo
    from ibx.solve import rans as jrans
    from ibx.topology.blocked_bc import _collect_families as jx_families
    from ibx.topology.blocks import build_block_tables as jx_block_tables

    from ibx_torch.cases import (build_flat_plate, build_rae2822_rans,
                                 skin_friction_profile, wall_cp,
                                 wall_skin_friction)
    from ibx_torch.convert import state_from_numpy, tables_from_numpy
    from ibx_torch.ops import block_ops as bo
    from ibx_torch.solve.rans import rans_rhs_grid

    from test_torch_flat_plate import KW, plate_state
    from test_torch_rans import (NAMES, SMALL, chan_err, ibx_fields,
                                 perturbed_state, rel_max)
    from test_torch_rans_gather import closure_var

    def show(label, value, tol):
        print(f"  {label}: {value:.3e} (test tolerance {tol:g})", flush=True)

    def steps(jx, pt, P, Rt, label, op_by_op=False):
        Pj, Rj, rj = jx.step(jnp.asarray(P), jnp.asarray(Rt))
        Pp, Rp, rp = pt.step(*state_from_numpy(P, Rt, device="cpu"))
        print(f"{label}: one step, JAX jitted", flush=True)
        show("P (per channel)", chan_err(Pj, Pp.numpy()), 1e-4)
        show("Rt (of max |Rt|)", rel_max(Rj, Rp.numpy()), 1e-3)
        show("resnorm (relative)", abs(float(rp) / float(rj) - 1), 1e-4)
        if op_by_op:
            with jax.disable_jit():
                Po, Ro, _ = jx.step(jnp.asarray(P), jnp.asarray(Rt))
            print(f"{label}: one step, JAX op by op", flush=True)
            show("P (per channel)", chan_err(Po, Pp.numpy()), 1e-4)
            show("Rt (of max |Rt|)", rel_max(Ro, Rp.numpy()), 1e-3)
            show("JAX jitted vs op by op, P (per channel)",
                 chan_err(Po, Pj), 1e-4)
        return Pp

    # the airfoil, block march
    jx = jx_rans(**SMALL)
    pt = build_rae2822_rans(device="cpu", **SMALL)
    print(f"RANS airfoil {SMALL}: {pt.dom.ncells} cells", flush=True)
    show("P0 (per channel)", chan_err(jx.P0, pt.P0.numpy()), 2e-5)
    show("Rt0 (of max)", rel_max(jx.Rt0, pt.Rt0.numpy()), 2e-5)
    jbt = jx_block_tables(jx.dom)
    tb, _ = tables_from_numpy(ibx_fields(jbt), jx_families(jx.dom, NAMES),
                              NAMES, "cpu")
    P, Rt = perturbed_state(jx)
    S = np.concatenate([P, Rt[:, None]], axis=1)
    R_j, T_j, dt_j = jax.jit(
        lambda bt, S3: jrans.rans_rhs_grid(bt, jx.fluid, S3, cfl=0.5))(
            jbt, jbo.to_blocks(jbt, jnp.asarray(S)))
    R_t, T_t, dt_t = rans_rhs_grid(tb, pt.fluid,
                                   bo.to_blocks(tb, torch.as_tensor(S)),
                                   cfl=0.5)
    print("rans_rhs_grid", flush=True)
    show("R_flow (per channel, scaled + 1e-3)",
         chan_err(R_j, R_t.numpy(), floor=1e-3), 2e-4)
    show("T3 (of max |T3|)", rel_max(T_j, T_t.numpy()), 2e-4)
    show("dt (relative)", float(np.abs(dt_t.numpy() / np.asarray(dt_j)
                                       - 1).max()), 1e-4)
    steps(jx, pt, P, Rt, "RANS airfoil, block march", op_by_op=True)
    print("wall_skin_friction / wall_cp on the perturbed state", flush=True)
    cf_j = jx_wall_cf(jx, jnp.asarray(P))
    cf_t = wall_skin_friction(pt, torch.as_tensor(P))
    show("Cf (relative)", float(np.abs(cf_t / cf_j - 1).max()), 1e-5)
    show("Cp (absolute)", float(np.abs(
        wall_cp(pt, torch.as_tensor(P))
        - np.asarray(jx_wall_cp(jx, jnp.asarray(P)))).max()), 1e-5)

    # the airfoil, gather march
    jx = jx_rans(use_blocks=False, **SMALL)
    pg = build_rae2822_rans(use_blocks=False, device="cpu", **SMALL)
    P, Rt = perturbed_state(jx, seed=1)
    R_j, T_j = jax.jit(closure_var(jx.step, "rans_rhs"))(P, Rt)
    dt_j = jax.jit(closure_var(jx.step, "local_dt"))(P, Rt)
    Pt, Rtt = state_from_numpy(P, Rt, device="cpu")
    R_t, T_t = closure_var(pg.step, "rans_rhs")(Pt, Rtt)
    dt_t = closure_var(pg.step, "local_dt")(Pt, Rtt)
    print("gather rans_rhs / local_dt", flush=True)
    show("R_flow (per channel, scaled + 1e-3)",
         chan_err(R_j, R_t.numpy(), floor=1e-3), 2e-4)
    show("dRt/dt (of max)", rel_max(T_j, T_t.numpy()), 2e-4)
    show("dt (relative)", float(np.abs(dt_t.numpy() / np.asarray(dt_j)
                                       - 1).max()), 1e-4)
    P, Rt = perturbed_state(jx, seed=2)
    steps(jx, pg, P, Rt, "RANS airfoil, gather march", op_by_op=True)
    Pb, Rb, Pg, Rg = pt.P0, pt.Rt0, pg.P0, pg.Rt0
    for _ in range(5):
        Pb, Rb, _ = pt.step(Pb, Rb)
        Pg, Rg, _ = pg.step(Pg, Rg)
    print("the port's block march vs its gather march, 5 steps", flush=True)
    show("P (per channel)", chan_err(Pg.numpy(), Pb.numpy()), 2e-4)
    show("Rt (of max |Rt|)", rel_max(Rg.numpy(), Rb.numpy()), 2e-3)

    # the flat plate, both closures, both marches
    for closure in ("wray_agarwal", "mixing_length"):
        for ub in (True, False):
            jx = jx_plate(use_blocks=ub, closure=closure, **KW)
            pt = build_flat_plate(use_blocks=ub, closure=closure,
                                  device="cpu", **KW)
            label = (f"flat plate {KW}, {closure}, "
                     f"{'block' if ub else 'gather'} march")
            print(f"{label}: {pt.dom.ncells} cells", flush=True)
            show("P0 (per channel)", chan_err(jx.P0, pt.P0.numpy()), 2e-5)
            show("Rt0 (of max)", rel_max(jx.Rt0, pt.Rt0.numpy()), 2e-5)
            P, Rt = plate_state(jx)
            Pp = steps(jx, pt, P, Rt, label)
            if ub and closure == "wray_agarwal":
                from ibx.cases.flat_plate import skin_friction_profile as jp
                _, cf_j = jp(jx, jnp.asarray(Pp.numpy()))
                _, cf_t = skin_friction_profile(pt, Pp)
                show("skin_friction_profile Cf (relative)",
                     float(np.abs(cf_t / cf_j - 1).max()), 1e-5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
