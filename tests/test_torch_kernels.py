"""Port parity: the plain versions of the three CUDA kernels
(`ibx_torch.ops.kernels`, which the wrappers take for CPU tensors) against
the JAX package's Pallas kernels in interpret mode, on the bs=4 sphere
octree (2:1 interfaces in every dim, one-sided boundary sides).

Both packages get the same numpy inputs: the JAX package's block tables
go through `ibx_torch.convert.tables_from_numpy`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from ibx.ops import pallas_rhs as pr
from ibx.physics import make_fluid as jx_make_fluid
from ibx.topology.blocked_bc import _collect_families

from ibx_torch.convert import tables_from_numpy
from ibx_torch.ops import kernels as K
from ibx_torch.ops.rhs_cs import pallas_eligible
from ibx_torch.physics.fluid import make_fluid

from test_pallas_rhs import _perturbed, sphere  # noqa: F401

torch.set_num_threads(2)
FAMILIES = ("farfield", "wall")


def ibx_fields(bt):
    """The JAX package's BlockTables fields as numpy arrays."""
    return {f.name: jax.tree_util.tree_map(np.asarray, getattr(bt, f.name))
            for f in dataclasses.fields(bt)}


def port_tables(dom, bt):
    return tables_from_numpy(ibx_fields(bt), _collect_families(dom, FAMILIES),
                             FAMILIES, "cpu")


def chan_err(ref, out, axis=1, floor=0.0):
    """Max abs error per channel over that channel's max |ref| (+ floor);
    an all-zero channel is held to its absolute error."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    red = tuple(i for i in range(ref.ndim) if i != axis)
    scale = np.abs(ref).max(axis=red) + floor
    scale = np.where(scale > 0, scale, 1.0)
    return float((np.abs(out - ref).max(axis=red) / scale).max())


def t(x):
    return torch.as_tensor(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def setup(sphere):  # noqa: F811
    dom, bt = sphere
    tb, _ = port_tables(dom, bt)
    Pc = np.asarray(pr.cs_split(bt, _perturbed(dom, bt)))
    return bt, tb, Pc


@pytest.mark.parametrize("stage2", [False, True])
@pytest.mark.parametrize("with_active", [False, True])
def test_rk2_update_ref_matches_pallas(setup, stage2, with_active):
    """Fused RK2 stage, both stages, with and without the freeze mask
    (rel 1e-6 per channel)."""
    bt, tb, Pc = setup
    rng = np.random.default_rng(5)
    B, _, bs, bs2 = Pc.shape
    qscale = np.array([1.2, 2.5e5, 120.0, 120.0, 120.0],
                      np.float32)[None, :, None, None]
    R0 = (rng.standard_normal(Pc.shape) * qscale * 400).astype(np.float32)
    R1 = (rng.standard_normal(Pc.shape) * qscale * 400).astype(np.float32)
    dtb = rng.uniform(5e3, 2e4, (B, 1, bs, bs2)).astype(np.float32)
    act = (rng.uniform(size=(B, 1, bs, bs2)) > 0.2).astype(np.float32)
    R1 = R1 if stage2 else None
    act = act if with_active else None
    ref = pr.run_update(None, jx_make_fluid(), Pc, R0, R1, dtb, act, 0.5)
    out = K.rk2_update(make_fluid(), t(Pc), t(R0),
                       None if R1 is None else t(R1), t(dtb),
                       None if act is None else t(act), 0.5)
    assert chan_err(ref, out) < 1e-6, chan_err(ref, out)


@pytest.mark.parametrize("with_dt", [True, False])
def test_euler_pass_a_ref_matches_pallas(setup, with_dt):
    """Pass A: du to 1e-4, aux (G, U, sf) to 1e-5 per channel."""
    bt, tb, Pc = setup
    du_ref, aux_ref = pr.run_kernel_a(bt, jx_make_fluid(), Pc,
                                      with_dt=with_dt)
    du, aux = K.euler_pass_a(make_fluid(), t(Pc), tb.meta, tb.nbr_table,
                             with_dt=with_dt)
    assert aux.shape == aux_ref.shape
    assert chan_err(du_ref, du) < 1e-4, chan_err(du_ref, du)
    assert chan_err(aux_ref, aux) < 1e-5, chan_err(aux_ref, aux)


@pytest.mark.parametrize("high_order", [True, False])
def test_euler_pass_b_ref_matches_pallas(setup, high_order):
    """Pass B (MUSCL + JST blend + HLL divergence): R to 1e-4 per
    channel."""
    bt, tb, Pc = setup
    du, _ = pr.run_kernel_a(bt, jx_make_fluid(), Pc, with_dt=False)
    du = np.asarray(du)
    rng = np.random.default_rng(7)
    nu = 10.0 ** rng.uniform(-7, 0, (Pc.shape[0], 1) + Pc.shape[2:])
    nu = nu.astype(np.float32)
    ref = pr.run_kernel_b(bt, jx_make_fluid(), Pc, du, nu,
                          high_order=high_order)
    out = K.euler_pass_b(make_fluid(), t(Pc), t(du), t(nu), tb.meta,
                         tb.nbr_table, high_order=high_order)
    assert chan_err(ref, out) < 1e-4, chan_err(ref, out)


@pytest.mark.parametrize("high_order", [True, False])
def test_euler_pass_b_fold_ref_matches_pallas(setup, high_order):
    """The `have_cols` fold of pass B: placed random 2:1 gradient
    corrections on every block and side, so that own edges, edges read by
    interior neighbors, mirrored bnd cells and neighbor blocks' used edges
    all carry one. The port takes them as compact rows (one per block and
    side); R to 1e-4 per channel, the unfolded pass B's tolerance."""
    bt, tb, Pc = setup
    B, _, bs, bs2 = Pc.shape
    du, _ = pr.run_kernel_a(bt, jx_make_fluid(), Pc, with_dt=False)
    du = np.asarray(du)
    rng = np.random.default_rng(9)
    nu = (10.0 ** rng.uniform(-7, 0, (B, 1, bs, bs2))).astype(np.float32)
    scale = np.abs(du).reshape(B, 3, 5, -1).max(axis=(0, 3))   # [d, c]
    cols6 = []
    for d in range(3):
        shp = (B, 5, 1, bs2) if d == 2 else (B, 5, bs, bs)
        for _ in range(2):
            c = rng.standard_normal(shp) * 0.1 * scale[d][None, :, None, None]
            cols6.append(c.astype(np.float32))
    ref = pr.run_kernel_b(bt, jx_make_fluid(), Pc, du, nu,
                          high_order=high_order, cols6=cols6)
    rows = (np.arange(B)[:, None] + B * np.arange(6)[None, :]).astype(np.int32)
    vals = np.concatenate([c.reshape(B, 5, bs2) for c in cols6])
    out = K.euler_pass_b(make_fluid(), t(Pc), t(du), t(nu), tb.meta,
                         tb.nbr_table, high_order=high_order,
                         cols6=(torch.as_tensor(rows), t(vals)))
    assert chan_err(ref, out) < 1e-4, chan_err(ref, out)
    plain = K.euler_pass_b(make_fluid(), t(Pc), t(du), t(nu), tb.meta,
                           tb.nbr_table, high_order=high_order)
    assert chan_err(ref, plain) > 1e-3     # the corrections matter


def test_fold_rows_match_placement_and_skip_dense_faces(sphere):  # noqa: F811
    """`BlockTables.fold_rows` numbers each (d, s) interface row as the JAX
    package places it (`ifc_inv`), and no block has a correction on an
    edge that a same-size dense neighbor reads: the neighbor-gathered
    operands of the TPU fold are zero on the sphere's dense faces."""
    dom, bt = sphere
    tb, _ = port_tables(dom, bt)
    rows = tb.fold_rows.numpy()
    off = 0
    for d in range(3):
        for s in range(2):
            V = int(bt.fs_block[d][s].shape[0] + bt.cs_block[d][s].shape[0])
            inv = np.asarray(bt.ifc_inv[d][s])
            np.testing.assert_array_equal(
                rows[:, 2 * d + s], np.where(inv < V, inv + off, -1))
            off += V
            dense = ((np.asarray(bt.edge_valid[d][s]) > 0)
                     & (np.asarray(bt.bnd[d][s]) == 0))
            nb = np.asarray(bt.nbr[d][s])[dense]
            assert dense.sum() > 0 and (rows[nb, 2 * d + 1 - s] == -1).all()
    assert off == (rows >= 0).sum() > 0


@pytest.mark.parametrize("bs", [2, 4, 8, 16, 32])
def test_pallas_eligible_block_sizes(setup, bs):
    """The kernel route's gate admits the block sizes the pass-A and pass-B
    kernels take (4, 8, 16; the JAX gate's 8 and 16 among them), and the
    wrappers hold to the same sizes on every device: a one-block state
    with mirrored sides runs at an admitted size and raises ValueError at
    another."""
    _, tb, _ = setup
    admitted = bs in (4, 8, 16)
    assert pallas_eligible(dataclasses.replace(tb, block_size=bs)) is admitted
    assert pallas_eligible(dataclasses.replace(tb, block_size=bs),
                           frozen=object()) is False
    rng = np.random.default_rng(bs)
    P = np.empty((1, 5, bs, bs * bs), np.float32)
    P[:, 0] = rng.uniform(9e4, 1.1e5, P[:, 0].shape)
    P[:, 1] = rng.uniform(280.0, 300.0, P[:, 1].shape)
    P[:, 2:] = rng.uniform(-50.0, 50.0, P[:, 2:].shape)
    meta = np.zeros((1, 16), np.float32)
    meta[0, 0:3] = 0.1
    meta[0, 3:15] = 1.0                 # edges valid, every side mirrored
    nbr = torch.zeros((1, 8), dtype=torch.int32)
    nu = np.full((1, 1, bs, bs * bs), 1e-3, np.float32)

    def run():
        du, _ = K.euler_pass_a(make_fluid(), t(P), t(meta), nbr,
                               with_dt=True)
        return K.euler_pass_b(make_fluid(), t(P), du, t(nu), t(meta), nbr,
                              high_order=True)

    if admitted:
        assert bool(torch.isfinite(run()).all())
    else:
        with pytest.raises(ValueError, match="block sizes"):
            run()
