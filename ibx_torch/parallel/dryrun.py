"""Multi-rank dry run on the CPU: the counterpart of the JAX package's
``dryrun_multichip`` (`__graft_entry__.py`), legs 1, 2, 3, 3b and 4.

`dryrun_multichip(n)` spawns ``n`` gloo ranks on the CPU (`spawn`); each
leg takes one step at the JAX package's tiny sizes and asserts a finite
state on every rank:
  1. the sharded block march of RAE2822 (wall_h=8e-2, feature_h=4e-2);
  2. the sharded gather march of RAE2822 (the same sizes);
  3. the sharded 3D sphere (wall_h=0.2, surface_h=0.3) on its grid march
     (what the JAX package's leg takes off the TPU);
  3b. the same case on the channel-split march (the kernels' plain
     versions on the CPU).
  4. the 3D RANS wing with FAS (wall_h=0.25, span=0.5, farfield=2.0,
     bs=8, 2 coarse iterations): 2 sharded RK2 steps, then one V-cycle.

    python3 -m ibx_torch.parallel.dryrun 4
"""

from __future__ import annotations

import sys

import numpy as np

from .launch import spawn


def _legs(n_devices: int) -> None:
    from ..cases import (build_rae2822_block_sharded, build_rae2822_sharded,
                         build_sphere3d_block_sharded, build_wing3d_rans_fas)

    sbd, bstep, P0b, _ = build_rae2822_block_sharded(
        n_devices, wall_h=8e-2, feature_h=4e-2, device="cpu")
    P1b, _ = bstep(P0b)
    assert np.isfinite(sbd.collect(P1b)).all(), \
        "sharded block step non-finite"

    sdom, step, P0, _ = build_rae2822_sharded(
        n_devices, wall_h=8e-2, feature_h=4e-2, device="cpu")
    (P1,) = step(P0)
    assert np.isfinite(sdom.collect(P1)).all(), \
        "sharded step produced non-finite state"

    sbd3, step3, P0c, case3 = build_sphere3d_block_sharded(
        n_devices, wall_h=0.2, surface_h=0.3, use_cs=False, device="cpu")
    P1c, _ = step3(P0c)
    assert np.isfinite(sbd3.collect(P1c)).all(), \
        "3D sharded block step non-finite"

    sbd3c, step3c, P0d, _ = build_sphere3d_block_sharded(
        n_devices, use_cs=True, case=case3)
    P1d, _ = step3c(P0d)
    assert np.isfinite(sbd3c.collect(P1d)).all(), \
        "3D cs sharded step non-finite"

    wc = build_wing3d_rans_fas(
        n_devices, wall_h=0.25, span=0.5, farfield=2.0, block_size=8,
        n_coarse_iter=2, device="cpu")
    S1, _ = wc.fas_cycle(wc.march(wc.S0_sh, 2))
    assert np.isfinite(wc.collect(S1)).all(), \
        "wing3d RANS+FAS cycle non-finite"


def dryrun_multichip(n_devices: int) -> None:
    """Legs 1, 2, 3, 3b and 4 on ``n_devices`` gloo ranks on the CPU; raises
    if any rank fails."""
    spawn(_legs, n_devices, backend="gloo", device="cpu",
          args=(n_devices,))


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
    print("dryrun_multichip: ok")
