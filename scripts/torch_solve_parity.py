#!/usr/bin/env python3
"""Print the errors behind the point-implicit JVP parity test, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_solve_parity.py

On the fixture of tests/test_torch_point_implicit.py (RAE2822 at
wall_h=8e-2, feature_h=4e-2, the block march, 16,768 cells; the JAX
package's block tables and ghost families, the same perturbed state and
seeded tangent), the JVP of the point-implicit map ``g`` (plain and frozen
limiter) against `jax.jvp` three ways: the JAX side op by op, as the test
runs it; the JAX side jitted; and op by op with the port's `abs_select`
swapped for `torch.abs`, whose derivative at 0 is 0 where `jnp.abs`'s is
+1. Each line is the max error per channel over the channel's max, the
test's measure (tolerance 2e-4). Then the JAX package's committed FAS
verdict curves (`tests/data/fas_verdict2d_0.02.npz`, one point a call)
counted in calls, as `chip_smoke.py` phase 22 counts the port's: the call
of the peak, the first call at 0.3x peak, and the functional over its
peak at call 30. Takes about 3 minutes.
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

    import ibx_torch.ops.block_ops as bo
    import ibx_torch.ops.operators as ops
    import ibx_torch.ops.scheme as sc
    from ibx_torch.convert import state_from_numpy
    from ibx_torch.physics.fluid import make_fluid
    from ibx_torch.solve import Linearization
    from ibx_torch.solve.point_implicit_euler import newton_map
    from test_torch_block_ops_2d import perturbed
    from test_torch_kernels import chan_err
    from test_torch_point_implicit import (CFL, _jax_newton_map, _t,
                                           rae_case)

    jx, jact, tb, apply_bcs, tact = rae_case()
    P = perturbed(jx)

    def port_jvp(v, freeze_limiter):
        g, Qn = newton_map(tb, make_fluid(),
                           *state_from_numpy(P, device="cpu"), apply_bcs,
                           cfl=CFL, active=tact,
                           freeze_limiter=freeze_limiter)
        return Linearization(g, Qn, g(Qn))(_t(v)).numpy()

    for freeze_limiter in (False, True):
        jg, jQn = _jax_newton_map(jx, P, jact, freeze_limiter)
        rng = np.random.default_rng(9)
        scale = np.abs(np.asarray(jQn)).max(axis=0)
        v = (rng.normal(size=P.shape) * 1e-3 * scale).astype(np.float32)
        op_by_op = np.asarray(jax.jvp(jg, (jQn,), (jnp.asarray(v),))[1])
        jitted = np.asarray(jax.jit(
            lambda v: jax.jvp(jg, (jQn,), (v,))[1])(jnp.asarray(v)))
        out = port_jvp(v, freeze_limiter)
        tag = f"freeze_limiter={freeze_limiter}"
        print(f"{tag}: port vs JAX op by op {chan_err(op_by_op, out):.3e}; "
              f"port vs JAX jitted {chan_err(jitted, out):.3e}; JAX jitted "
              f"vs op by op {chan_err(op_by_op, jitted):.3e}", flush=True)
        saved = (ops.abs_select, bo.abs_select, sc.abs_select, ops.minmod,
                 sc.minmod)

        def minmod_abs(u1, u2):
            return torch.minimum(u1.abs(), u2.abs()) * (
                torch.sign(u1) + torch.sign(u2)) / 2

        ops.abs_select = bo.abs_select = sc.abs_select = torch.abs
        ops.minmod = sc.minmod = minmod_abs
        try:
            out_abs = port_jvp(v, freeze_limiter)
        finally:
            (ops.abs_select, bo.abs_select, sc.abs_select, ops.minmod,
             sc.minmod) = saved
        print(f"{tag}: with torch.abs, port vs JAX op by op "
              f"{chan_err(op_by_op, out_abs):.3e}", flush=True)

    curves = np.load(ROOT / "tests" / "data" / "fas_verdict2d_0.02.npz")
    for arm in curves.files:
        r = curves[arm][:, 1]
        pk = int(np.argmax(r))
        hit = np.nonzero(r[pk:] <= 0.3 * r[pk])[0]
        print(f"committed verdict curve {arm}: peak at call {pk}, 0.3x "
              f"peak at call {pk + hit[0] if hit.size else None}, call 30 "
              f"at {r[30] / r[pk]:.4f} of peak", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
