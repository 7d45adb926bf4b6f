"""Port parity of the point-implicit step at nd = 3
(`ibx_torch.solve.point_implicit_euler`) against the JAX package's, on the
bs=4 sphere at wall_h=0.25 (18,432 cells, 2:1 interfaces in every dim).

Both packages see one mesh: the JAX package's case is built once, and its
block tables and ghost families reach the port through
`convert.tables_from_numpy`. The port's differentiated residual takes the
torch-op body of the block RHS (``kernels=False``), the route the JAX
package's RHS takes off the TPU; its explicit bound at Q_n keeps the
kernel route (the plain versions, on the CPU). The JAX side runs op by op,
as `tests/test_torch_point_implicit.py` does at nd = 2. One port step on
the same fixture is `tests/test_torch_point_implicit_3d_step.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ibx.cases import build_sphere3d as jx_build_sphere3d
from ibx.ops import block_ops as jbo

from ibx_torch.convert import state_from_numpy
from ibx_torch.ops import block_ops as bo
from ibx_torch.ops import kernels as K
from ibx_torch.ops.block_ops import to_blocks, to_flat
from ibx_torch.physics.fluid import make_fluid
from ibx_torch.solve import Linearization
from ibx_torch.solve.point_implicit_euler import newton_map

from test_torch_block_ops_2d import port_case
from test_torch_kernels import chan_err
from test_torch_point_implicit import CFL, _jax_newton_map, _t
from test_torch_sphere3d import _perturbed_flat

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sphere():
    """(JAX case with a flat blocked-BC, its freeze mask, the port's
    tables, flat ghost BC and freeze mask, the perturbed state)."""
    jx = jx_build_sphere3d(wall_h=0.25, block_size=4)
    assert jx.dom.ncells == 18432
    bt, bc3 = jx.grid["bt"], jx.grid["apply_bcs3"]
    # the JAX package's blocked BC on the flat state: the counterpart of
    # the port's GhostBC
    jx.apply_bcs = lambda P: jbo.to_flat(bt, bc3(jbo.to_blocks(bt, P)))
    tb, apply_bcs3, _ = port_case(jx)
    assert tb.nd == 3

    def apply_bcs(P):
        return to_flat(tb, apply_bcs3(to_blocks(tb, P.clone())))

    active = np.asarray(jx.grid["active3"]).reshape(-1)
    return (jx, jnp.asarray(active), tb, apply_bcs, _t(active),
            _perturbed_flat(jx))


@pytest.mark.parametrize("freeze_limiter", [False, True])
def test_newton_map_and_jvp_match_jax_3d(sphere, freeze_limiter):
    """``g`` at Q_n and its JVP at a perturbed state against the JAX
    package's, op by op: 2e-4 per channel; Q_n 1e-6. No kernel launches
    on the CPU, where the explicit bound takes the plain versions."""
    jx, jact, tb, apply_bcs, tact, P = sphere
    jg, jQn = _jax_newton_map(jx, P, jact, freeze_limiter)
    rng = np.random.default_rng(9)
    scale = np.abs(np.asarray(jQn)).max(axis=0)
    v = (rng.normal(size=P.shape) * 1e-3 * scale).astype(np.float32)
    ref_g, ref_jvp = jax.jvp(jg, (jQn,), (jnp.asarray(v),))
    K.reset_launches()
    g, Qn = newton_map(tb, make_fluid(), *state_from_numpy(P, device="cpu"),
                       apply_bcs, cfl=CFL, active=tact,
                       freeze_limiter=freeze_limiter)
    out = Linearization(g, Qn, g(Qn))(_t(v))
    assert not any(K.launches.values())
    assert chan_err(np.asarray(jQn), Qn.numpy()) < 1e-6
    assert chan_err(np.asarray(ref_g), g(Qn).numpy()) < 2e-4, \
        chan_err(np.asarray(ref_g), g(Qn).numpy())
    assert chan_err(np.asarray(ref_jvp), out.numpy()) < 2e-4, \
        chan_err(np.asarray(ref_jvp), out.numpy())


def test_euler_rhs_block_torch_op_body_matches_kernel_route(sphere):
    """`euler_rhs_block(kernels=False)` against the default route (the
    kernels' plain versions on the CPU): R 2e-4 per channel, dt rtol
    1e-5, du and nu 1e-4 per channel."""
    _, _, tb, _, _, P = sphere
    fl, Pt = make_fluid(), _t(P)
    R, dt, (du, nu) = bo.euler_rhs_block(tb, fl, Pt, with_dt=True, cfl=CFL)
    Rb, dtb, (dub, nub) = bo.euler_rhs_block(tb, fl, Pt, with_dt=True,
                                             cfl=CFL, kernels=False)
    assert chan_err(R.numpy(), Rb.numpy(), floor=1e-3) < 2e-4
    np.testing.assert_allclose(dtb.numpy(), dt.numpy(), rtol=1e-5)
    for d in range(3):
        assert chan_err(du[d].numpy(), dub[d].numpy()) < 1e-4, d
    assert chan_err(nu.numpy()[:, None], nub.numpy()[:, None]) < 1e-4
    assert not torch.equal(R, Rb)      # two routes, not one
