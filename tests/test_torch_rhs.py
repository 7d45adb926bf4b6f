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


@pytest.mark.parametrize("with_dt", [True, False])
def test_euler_rhs_cs_fold_matches_ibx(setup, with_dt, monkeypatch):
    """The fold path: R to 2e-4 per channel against the JAX package's
    `euler_rhs_cs` with IBX_CS_FOLD=1; the folded port R equals the
    pre-added port R to 1e-6 per channel (both add the same float32
    correction once, so they agree bitwise)."""
    bt, tb, Pc = setup
    monkeypatch.setenv("IBX_CS_FOLD", "1")
    ref = pr.euler_rhs_cs(bt, jx_make_fluid(), Pc, with_dt=with_dt)
    out = euler_rhs_cs(tb, make_fluid(), t(Pc), with_dt=with_dt, fold=True)
    pre = euler_rhs_cs(tb, make_fluid(), t(Pc), with_dt=with_dt)
    if with_dt:
        assert ref[2] is None
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-5)
        ref, out, pre = ref[0], out[0], pre[0]
    assert chan_err(ref, out, floor=1e-3) < 2e-4, chan_err(ref, out, 1, 1e-3)
    assert chan_err(pre, out) < 1e-6, chan_err(pre, out)


def test_euler_rhs_cs_with_frozen_matches_ibx(setup, monkeypatch):
    """`with_frozen` hands out the corrected (du_cs, nu_cs), to 1e-4 per
    channel, and turns the fold off, as in the JAX package."""
    bt, tb, Pc = setup
    monkeypatch.setenv("IBX_CS_FOLD", "1")
    R_ref, dtb_ref, (du_ref, nu_ref) = pr.euler_rhs_cs(
        bt, jx_make_fluid(), Pc, with_dt=True, with_frozen=True)
    R, dtb, (du, nu) = euler_rhs_cs(tb, make_fluid(), t(Pc), with_dt=True,
                                    with_frozen=True, fold=True)
    assert chan_err(R_ref, R, floor=1e-3) < 2e-4, chan_err(R_ref, R, 1, 1e-3)
    np.testing.assert_allclose(dtb.numpy(), np.asarray(dtb_ref), rtol=1e-5)
    assert chan_err(du_ref, du) < 1e-4, chan_err(du_ref, du)
    assert chan_err(nu_ref, nu) < 1e-4, chan_err(nu_ref, nu)
