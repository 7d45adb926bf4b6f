"""The rank function of the sharded wing's parity tests
(`test_torch_wing3d_fas.py`); the single-rank wing tests build their case
in the package's `ibx_torch.parallel.one_rank_group`.

Every spawned rank imports the module its function lives in; this one
imports torch and `ibx_torch` only (see `test_torch_sharded_ranks.py`).
The JAX side of each comparison stays in the test files."""

import numpy as np
import torch.distributed as dist

from ibx_torch.cases import build_wing3d_rans_fas

# the sizes of tests/test_wing3d_fas.py:15 (4096 cells, 8 blocks of 8^3)
WING = dict(wall_h=0.25, span=0.5, farfield=2.0, block_size=8,
            n_coarse_iter=4)
N_MARCH = 10


def wing_outputs(wc) -> dict:
    """What both the one-rank and the four-rank runs report: the initial
    state, ``march(S0, N_MARCH)``, one FAS cycle from ``S0`` and its
    residual, and ``res_norms(S0)`` (collectives: every rank calls)."""
    out = {"S0": wc.collect(wc.S0_sh),
           "march": wc.collect(wc.march(wc.S0_sh, N_MARCH))}
    S, res = wc.fas_cycle(wc.S0_sh)
    out["cycle"] = wc.collect(S)
    out["cycle_res"] = np.asarray(float(res))
    l2, mx = wc.res_norms(wc.S0_sh)
    out["l2"], out["mx"] = np.asarray(float(l2)), np.asarray(float(mx))
    return out


def wing_rank(out_dir):
    """One rank of the four-rank wing: rank 0 writes `wing_outputs`."""
    wc = build_wing3d_rans_fas(dist.get_world_size(), device="cpu", **WING)
    out = wing_outputs(wc)
    if dist.get_rank() == 0:
        np.savez(f"{out_dir}/out.npz", **out)

