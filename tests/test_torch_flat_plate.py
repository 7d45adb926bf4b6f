"""Port parity for the turbulent flat plate on the block march:
`ibx_torch.cases.build_flat_plate` (device="cpu") against the JAX
package's at wall_h=2e-2, reynolds=6e5 (9,216 cells; the parity fixture of
tests/test_flat_plate.py), one `case.step` under both closures from a
seeded perturbed state, and `skin_friction_profile` on one state.

The JAX side runs its jitted step (op by op, a block step spends minutes
in per-primitive compiles). Measured (`scripts/torch_rans_parity.py`,
CPU): the initial state P0 exact, Rt0 2.0e-7; one step P 1.5e-5 per
channel and Rt 2.4e-6 of max|Rt| under Wray-Agarwal, P 3.6e-5 and Rt
1.5e-5 under the mixing length, resnorm 6.7e-6; the Cf profile 4.8e-7.
Under the mixing length the Rt channel stays frozen off the ghost rows,
as in the JAX package. The whole domain is compared: the corner
difference of tests/test_flat_plate.py is between the two marches, not
between the two packages."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.cases.flat_plate import build_flat_plate as jx_build
from ibx.cases.flat_plate import skin_friction_profile as jx_profile

from ibx_torch.cases import build_flat_plate, skin_friction_profile
from ibx_torch.convert import state_from_numpy
from ibx_torch.ops import kernels as K

from test_torch_rans import chan_err, rel_max

torch.set_num_threads(2)
KW = dict(wall_h=2e-2, length=1.25, height=0.5, reynolds=6e5)


def plate_state(case, seed=0):
    """(P, Rt) as numpy: the initial state with a boundary-layer-like
    velocity deficit, noise in u and v, a pressure perturbation, and an
    eddy viscosity of 1 to 20 times the freestream seed."""
    rng = np.random.default_rng(seed)
    P = np.array(case.P0, np.float32)
    x, y = case.dom.centers[:, 0], case.dom.centers[:, 1]
    P[:, 0] *= 1.0 + 0.01 * np.sin(4 * x) * np.cos(3 * y)
    P[:, 2] *= 1.0 - np.exp(-y / 0.05)
    P[:, 2] += 2.0 * rng.standard_normal(P.shape[0])
    P[:, 3] += 1.0 * rng.standard_normal(P.shape[0])
    Rt = case.Rt_inf * (1.0 + 19.0 * rng.uniform(size=P.shape[0]))
    return P.astype(np.float32), Rt.astype(np.float32)


def step_against_ibx(closure, use_blocks):
    """One step of each package's case from the same perturbed state."""
    jx = jx_build(use_blocks=use_blocks, closure=closure, **KW)
    pt = build_flat_plate(use_blocks=use_blocks, closure=closure,
                          device="cpu", **KW)
    assert pt.dom.ncells == jx.dom.ncells == 9216
    assert chan_err(jx.P0, pt.P0.numpy()) < 2e-5
    assert rel_max(jx.Rt0, pt.Rt0.numpy()) < 2e-5
    P, Rt = plate_state(jx)
    Pj, Rj, rj = jx.step(jnp.asarray(P), jnp.asarray(Rt))
    K.reset_launches()
    Pp, Rp, rp = pt.step(*state_from_numpy(P, Rt, device="cpu"))
    assert not any(K.launches.values())
    assert np.isfinite(Pp.numpy()).all()
    assert chan_err(Pj, Pp.numpy()) < 1e-4
    assert rel_max(Rj, Rp.numpy()) < 1e-3
    assert abs(float(rp) - float(rj)) <= 1e-4 * abs(float(rj))
    if closure == "mixing_length":
        # the Rt channel is frozen: only the ghost BC writes it
        ghost = np.zeros(P.shape[0], bool)
        for hb in pt.dom._host_boundaries.values():
            ghost[hb.ghosts] = True
        assert np.array_equal(Rp.numpy()[~ghost], Rt[~ghost])
    return jx, pt, Pp


def test_signature_matches_ibx():
    """Same parameters, names and defaults as the JAX builder, plus
    ``device="cuda"``."""
    ref = inspect.signature(jx_build).parameters
    out = inspect.signature(build_flat_plate).parameters
    assert list(out)[:-1] == list(ref) and list(out)[-1] == "device"
    assert out["device"].default == "cuda"
    for name, p in ref.items():
        assert out[name].default == p.default, name


@pytest.mark.parametrize("closure", ["wray_agarwal", "mixing_length"])
def test_block_step_matches(closure):
    """One block-march step under each closure: P < 1e-4 per channel, Rt
    < 1e-3 of max|Rt|, resnorm rtol 1e-4; and, on the Wray-Agarwal step's
    output, `skin_friction_profile` against the JAX function, rtol 1e-5."""
    jx, pt, Pp = step_against_ibx(closure, use_blocks=True)
    if closure == "wray_agarwal":
        x_j, cf_j = jx_profile(jx, jnp.asarray(Pp.numpy()))
        x_t, cf_t = skin_friction_profile(pt, Pp)
        np.testing.assert_array_equal(x_t, x_j)
        assert cf_t.dtype == np.float32 and x_t.size > 50
        np.testing.assert_allclose(cf_t, cf_j, rtol=1e-5)
