"""The mirrored-ghost wall (``build_rae2822(mirror_wall=True)``, a flagged
deviation of both packages) on the port's block march: `GhostBC`'s
``mirror`` / ``mirror_scale`` against the gather march's `FusedBoundary`
(the tolerance of tests/test_mirror.py:49), the flip itself, and the
block march against the JAX package's, at tests/test_mirror.py's mesh
(wall_h=4e-2, 21,760 cells)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.cases import build_rae2822 as jx_build_rae2822

from ibx_torch.cases import build_rae2822
from ibx_torch.ops import kernels as K

from test_torch_kernels import chan_err

torch.set_num_threads(2)
KW = dict(wall_h=4e-2, feature_h=2e-2, block_size=8)


@pytest.fixture(scope="module")
def cases():
    """The JAX mirrored case; the port's mirrored block and gather cases
    and its plain block case."""
    return dict(
        jx=jx_build_rae2822(mirror_wall=True, **KW),
        block=build_rae2822(mirror_wall=True, device="cpu", **KW),
        gather=build_rae2822(mirror_wall=True, use_blocks=False,
                             device="cpu", **KW),
        plain=build_rae2822(device="cpu", **KW),
    )


def _perturbed(case, seed):
    rng = np.random.default_rng(seed)
    P = case.P0.numpy().copy()
    P[:, 2:] += rng.normal(0.0, 30.0, P[:, 2:].shape).astype(np.float32)
    return P


def test_blocked_matches_fused(cases):
    """The block march's `GhostBC` with the mirror against the gather
    march's `FusedBoundary` on the same state: rtol 2e-5, atol 2e-3 (as
    tests/test_mirror.py:49)."""
    P = torch.as_tensor(_perturbed(cases["block"], 1))
    out = cases["block"].apply_bcs(P).numpy()
    ref = cases["gather"].apply_bcs(P).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-3)


def test_mirror_flips_ghost_normal_velocity(cases):
    """On the block march, a wall ghost's normal velocity is the plain
    blend's negated where the solid is thick and the plain blend's at the
    gated trailing-edge sliver; the other channels do not move (the
    check of tests/test_mirror.py:22 on the port)."""
    base, mir = cases["plain"], cases["block"]
    P = torch.as_tensor(_perturbed(base, 0))
    Pb = base.apply_bcs(P).numpy()
    Pm = mir.apply_bcs(P).numpy()
    hb = base.dom._host_boundaries["wall"]
    g, n = hb.ghosts, hb.normals
    un_b = (Pb[g, 2:] * n).sum(1)
    un_m = (Pm[g, 2:] * n).sum(1)
    tol = 0.15 + 1e-3 * np.abs(un_b)
    flipped = np.abs(un_m + un_b) < tol
    kept = np.abs(un_m - un_b) < tol
    assert (flipped | kept).all()
    assert flipped.mean() > 0.5
    assert 0 < float(mir.mirror_scale.sum()) < mir.mirror_scale.numel()
    np.testing.assert_allclose(Pm[g, :2], Pb[g, :2], rtol=1e-6)


def test_block_march_matches_jax(cases):
    """Against the JAX package's mirrored block march: the initial state
    and `apply_bcs` within 2e-5 per channel (measured 0), one step from a
    perturbed state within 1e-4 with its resnorm at rtol 1e-4 (measured
    8.7e-7), 5 steps within 1e-3 (measured 3.4e-4: the JAX march is
    jitted); no kernel launched."""
    jx, pt = cases["jx"], cases["block"]
    assert pt.blocks_on and pt.mirror == ("wall",)
    assert chan_err(np.asarray(jx.P0), pt.P0.numpy()) < 2e-5
    P = _perturbed(pt, 2)
    ref = np.asarray(jx.apply_bcs(jnp.asarray(P)))
    assert chan_err(ref, pt.apply_bcs(torch.as_tensor(P)).numpy()) < 2e-5
    K.reset_launches()
    ref, res_ref = jx.step(jnp.asarray(P))
    out, res = pt.step(torch.as_tensor(P))
    assert chan_err(ref, out.numpy()) < 1e-4, chan_err(ref, out.numpy())
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))
    ref = np.asarray(jx.march(jx.P0, 5))
    out = pt.march(torch.as_tensor(np.asarray(jx.P0)), 5).numpy()
    assert np.isfinite(out).all()
    assert chan_err(ref, out) < 1e-3, chan_err(ref, out)
    assert not any(K.launches.values())
