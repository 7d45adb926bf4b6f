"""Port parity for the turbulent flat plate on the generic gather march
(`build_flat_plate(use_blocks=False)`) under both closures against the JAX
package (wall_h=2e-2, 9,216 cells); the port's block march against its
gather march away from the two bottom corners (tests/test_flat_plate.py::
test_flat_plate_block_generic_parity and its mixing-length twin); the
correlations; and the three committed flat-plate oracles
(tests/data/flat_plate_cf{,_lowyp,_ml}.npz) read through the port's
functions at the reference's bands.

Measured (`scripts/torch_rans_parity.py`, CPU): one gather step P 1.5e-5
per channel and Rt 3.0e-6 of its max under Wray-Agarwal, P 3.6e-5 and Rt
1.5e-5 under the mixing length."""

import os

import numpy as np
import pytest
import torch

from ibx.cases.flat_plate import cf_prandtl as jx_cf_prandtl
from ibx.cases.flat_plate import cf_schultz_grunow as jx_cf_sg

from ibx_torch.cases import (build_flat_plate, cf_prandtl,
                             cf_schultz_grunow)

from test_torch_flat_plate import KW, step_against_ibx

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.mark.parametrize("closure", ["wray_agarwal", "mixing_length"])
def test_gather_step_matches(closure):
    """One gather-march step under each closure: P < 1e-4 per channel, Rt
    < 1e-3 of max|Rt|, resnorm rtol 1e-4."""
    step_against_ibx(closure, use_blocks=False)


@pytest.mark.parametrize("closure", ["wray_agarwal", "mixing_length"])
def test_block_matches_gather_off_corners(closure):
    """The port's block and gather steps from the initial state, away from
    the two bottom corners, at the reference's bounds: P rtol 2e-4 / atol
    2e-2, Rt rtol 2e-4 / atol 1e-8 (the gather march re-interpolates each
    family after the one before it wrote, the block march blends both from
    one gather; the difference stays in the corner stencils)."""
    cb = build_flat_plate(use_blocks=True, closure=closure, device="cpu",
                          **KW)
    cg = build_flat_plate(use_blocks=False, closure=closure, device="cpu",
                          **KW)
    P1, Rt1, _ = cb.step(cb.P0, cb.Rt0)
    P2, Rt2, _ = cg.step(cg.P0, cg.Rt0)
    c = cb.dom.centers
    corner = np.minimum(np.hypot(c[:, 0], c[:, 1]),
                        np.hypot(c[:, 0] - KW["length"], c[:, 1]))
    m = corner > 4 * KW["wall_h"]
    np.testing.assert_allclose(P1.numpy()[m], P2.numpy()[m], rtol=2e-4,
                               atol=2e-2)
    np.testing.assert_allclose(Rt1.numpy()[m], Rt2.numpy()[m], rtol=2e-4,
                               atol=1e-8)


def test_correlations():
    """`cf_prandtl` / `cf_schultz_grunow` equal the JAX package's, and the
    reference's spot values and mutual band hold."""
    rex = np.logspace(5.0, 9.0, 41)
    np.testing.assert_array_equal(cf_prandtl(rex), jx_cf_prandtl(rex))
    np.testing.assert_array_equal(cf_schultz_grunow(rex), jx_cf_sg(rex))
    assert abs(cf_prandtl(1e6) - 0.0592e-1 * 10 ** -0.2) < 1e-5
    assert 0.003 < cf_schultz_grunow(1e6) < 0.005
    r = cf_prandtl(rex[17:]) / cf_schultz_grunow(rex[17:])
    assert (r > 0.6).all() and (r < 1.4).all()


# (file, band on the mean of Cf / Schultz-Grunow - 1, max |rel|, max
# std/mean of the ratio): the reference's bands (tests/test_flat_plate.py)
ORACLES = {
    "flat_plate_cf.npz": ((-0.34, -0.14), 0.45, 0.15),
    "flat_plate_cf_lowyp.npz": ((-0.45, -0.05), None, 0.25),
    "flat_plate_cf_ml.npz": ((-0.40, -0.10), 0.45, 0.15),
}


@pytest.mark.parametrize("name", sorted(ORACLES))
def test_committed_oracles(name):
    """The committed TPU-converged Cf profiles, read through the port's
    `cf_schultz_grunow`: the Cf deficit of the reference's closures (24%
    low under Wray-Agarwal) at the reference's bands."""
    (lo, hi), max_rel, max_cv = ORACLES[name]
    d = np.load(os.path.join(DATA, name))
    x, cf, re = d["x"], d["cf"], float(d["reynolds"])
    sel = (x > 0.3) & (x < 1.0)
    corr = cf_schultz_grunow(re * x[sel])
    rel = cf[sel] / corr - 1.0
    assert lo < rel.mean() < hi, rel.mean()
    if max_rel is not None:
        assert np.abs(rel).max() < max_rel
    r = cf[sel] / corr
    assert r.std() / abs(r.mean()) < max_cv
