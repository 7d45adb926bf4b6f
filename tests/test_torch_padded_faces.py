"""The padded formulation of `face_accumulate` (``IBX_PADDED_FACES``,
`ibx_torch.ops.block_ops._PADDED_FACES`) in the port: bit-equal to the
default concat formulation, alone and through the torch-op body of
`euler_rhs_grid`, and within 2e-4 per channel (scaled by the channel's
max + 1e-3, as tests/test_block_ops.py:70-72) of the JAX package's padded
formulation. At nd = 2 on RAE2822 at wall_h=8e-2 (16,768 cells) and at
nd = 3 on the bs=4 sphere at wall_h=0.25 (18,432 cells); each fixture
builds the JAX case once and hands its tables to the port."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.cases import build_rae2822 as jx_build_rae2822
from ibx.cases import build_sphere3d as jx_build_sphere3d
from ibx.ops import block_ops as jbo
from ibx.physics import make_fluid as jx_make_fluid

from ibx_torch.ops import block_ops as bo
from ibx_torch.ops.scheme import face_a
from ibx_torch.physics.fluid import make_fluid

from test_torch_block_ops_2d import _face_fns, perturbed, port_case
from test_torch_kernels import chan_err, t
from test_torch_sphere3d import _perturbed_flat

torch.set_num_threads(2)
SIGNED = [1.0, 1.0, 1.0, 0.0, 0.0]


@pytest.fixture(scope="module", params=[2, 3])
def mesh(request):
    """(nd, JAX tables, port tables, perturbed flat state)."""
    if request.param == 2:
        jx = jx_build_rae2822(wall_h=8e-2, feature_h=4e-2, cfl=0.7)
        P = perturbed(jx)
    else:
        jx = jx_build_sphere3d(wall_h=0.25, block_size=4)
        P = _perturbed_flat(jx)
    tb = port_case(jx)[0]
    assert tb.nd == request.param and tb.n_sparse == 0
    return request.param, jx.grid["bt"], tb, P


def _both(monkeypatch, fn):
    """``fn()`` under the concat and the padded formulation."""
    monkeypatch.setattr(bo, "_PADDED_FACES", False)
    concat = fn()
    monkeypatch.setattr(bo, "_PADDED_FACES", True)
    return concat, fn()


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_default_is_concat():
    """The default formulation is concat, as in the JAX package."""
    assert bo._PADDED_FACES is False and jbo._PADDED_FACES is False


def test_face_accumulate_padded_bit_equal(mesh, monkeypatch):
    """Every dim, random 3-channel cells with a signed/unsigned channel
    mix, and the two-part call of pass A with dt: bit-equal."""
    nd, _, tb, P = mesh
    rng = np.random.default_rng(21)
    W3 = bo.to_blocks(tb, t(rng.standard_normal((tb.n_cells, 3))))
    fn = _face_fns(lambda xs: torch.cat(xs, dim=-1), torch.abs)
    P3 = bo.to_blocks(tb, t(P))
    S3 = P3[..., 2:3].abs() + 300.0
    signedA = [1.0] * (P3.shape[-1] + 1) + [0.0] * 2
    for d in range(nd):
        concat, padded = _both(monkeypatch, lambda: (
            bo.face_accumulate(tb, d, W3, fn, 5, SIGNED),
            bo.face_accumulate(tb, d, (P3, S3), face_a(True),
                               P3.shape[-1] + 3, signedA)))
        assert _equal(concat, padded), d


@pytest.mark.parametrize("variant", ["with_dt", "frozen_viscous"])
def test_euler_rhs_grid_padded_bit_equal(mesh, monkeypatch, variant):
    """The torch-op body of `euler_rhs_grid` (R, dt and the frozen
    gradients with dt; then a frozen-gradient viscous call): bit-equal."""
    nd, _, tb, P = mesh
    fl, P3 = make_fluid(), bo.to_blocks(tb, t(P))
    if variant == "with_dt":
        concat, padded = _both(monkeypatch, lambda: bo.euler_rhs_grid(
            tb, fl, P3, with_dt=True, cfl=0.7, kernels=False))
    else:
        fr = bo.euler_rhs_grid(tb, fl, P3, with_dt=True, cfl=0.7,
                               kernels=False)[2]
        concat, padded = _both(monkeypatch, lambda: bo.euler_rhs_grid(
            tb, fl, P3 * 1.001, frozen=fr, viscous=True))
    assert _equal(concat, padded)


@pytest.mark.parametrize("op", ["face_accumulate", "euler_rhs_grid"])
def test_padded_matches_ibx_padded(mesh, monkeypatch, op):
    """The port's padded form against the JAX package's (its module flag
    set): 2e-4 per channel, scaled by the channel's max + 1e-3; dt rtol
    1e-4 (the JAX side op by op)."""
    nd, bt, tb, P = mesh
    monkeypatch.setattr(jbo, "_PADDED_FACES", True)
    monkeypatch.setattr(bo, "_PADDED_FACES", True)
    if op == "face_accumulate":
        rng = np.random.default_rng(22)
        W = rng.standard_normal((tb.n_cells, 3)).astype(np.float32)
        jfn = _face_fns(lambda xs: jnp.concatenate(xs, axis=-1), jnp.abs)
        pfn = _face_fns(lambda xs: torch.cat(xs, dim=-1), torch.abs)
        for d in range(nd):
            W3j = jbo.to_blocks(bt, jnp.asarray(W))
            ref = jbo.face_accumulate(bt, d, W3j, jfn, 5, SIGNED)
            out = bo.face_accumulate(tb, d, bo.to_blocks(tb, t(W)), pfn, 5,
                                     SIGNED)
            assert chan_err(ref, out, axis=-1, floor=1e-3) < 2e-4, d
        return
    R_ref, dt_ref, _ = jbo.euler_rhs_grid(
        bt, jx_make_fluid(), jbo.to_blocks(bt, jnp.asarray(P)),
        with_dt=True, cfl=0.7)
    R, dt, _ = bo.euler_rhs_grid(tb, make_fluid(), bo.to_blocks(tb, t(P)),
                                 with_dt=True, cfl=0.7, kernels=False)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dt_ref), rtol=1e-4)
    assert chan_err(R_ref, R, axis=-1, floor=1e-3) < 2e-4, \
        chan_err(R_ref, R, -1, 1e-3)

