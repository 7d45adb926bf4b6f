"""Port parity: the channel-split RHS with its 2:1 glue
(`ibx_torch.ops.rhs_cs.euler_rhs_cs`, kernels on their plain versions)
against the JAX package's `euler_rhs_cs` (Pallas in interpret mode) on the
bs=4 sphere octree, which has 2:1 interfaces in every dim."""

import numpy as np
import pytest
import torch

from ibx.ops import pallas_rhs as pr
from ibx.physics import make_fluid as jx_make_fluid

from ibx_torch.ops.rhs_cs import euler_rhs_cs
from ibx_torch.physics.fluid import make_fluid

from test_pallas_rhs import _perturbed, sphere  # noqa: F401
from test_torch_kernels import chan_err, port_tables, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(sphere):  # noqa: F811
    dom, bt = sphere
    assert all(int(bt.fs_block[d][s].shape[0]) and
               int(bt.cs_block[d][s].shape[0])
               for d in range(3) for s in range(2))
    tb, _ = port_tables(dom, bt)
    Pc = np.asarray(pr.cs_split(bt, _perturbed(dom, bt)))
    return bt, tb, Pc


@pytest.mark.parametrize("with_dt,high_order",
                         [(True, True), (False, True), (False, False)])
def test_euler_rhs_cs_matches_ibx(setup, with_dt, high_order):
    """R per-channel-scaled < 2e-4 (as test_block_ops.py); dtb rtol
    1e-5."""
    bt, tb, Pc = setup
    ref = pr.euler_rhs_cs(bt, jx_make_fluid(), Pc, high_order=high_order,
                          with_dt=with_dt)
    out = euler_rhs_cs(tb, make_fluid(), t(Pc), high_order=high_order,
                       with_dt=with_dt)
    R_ref, R = (ref[0], out[0]) if with_dt else (ref, out)
    assert chan_err(R_ref, R, floor=1e-3) < 2e-4, chan_err(R_ref, R, 1, 1e-3)
    if with_dt:
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-5)
