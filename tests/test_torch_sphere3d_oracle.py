"""The windward potential-flow anchor of the port's 3D marches: the port
restarted from the JAX package's converged sphere (tests/data/sphere3d_cp.npz,
663,552 cells at wall_h=0.05, bs=8, M 0.2, 30k TPU steps) and marched 200
steps, on the channel-split block march and on the gather march. Its wall
Cp must hold the checks tests/test_sphere3d_oracle.py makes of the oracle
(`test_sphere3d_windward_cp_matches_potential_flow`: the stagnation Cp and
pole, the binned windward cones against Cp = 1 - 9/4 sin^2(theta), their
axisymmetry and monotone acceleration) and stay within the drift bands of
`test_sphere3d_cp_drift_from_converged` (mean |dCp| 2e-2, max 8e-2), whose
JAX march was restarted the same way.

Marked `slow` (200 steps at 663,552 cells). The test runs on the card when
one is present and on the CPU otherwise (the kernels' plain versions);
it imports no JAX, so on the card it runs without this directory's
conftest: ``python3 -c "import sys; sys.path.insert(0, 'tests'); import
test_torch_sphere3d_oracle as t; t.test_windward_anchor_after_restart(
'block')"``."""

import json
import os

import numpy as np
import pytest
import torch

from ibx_torch.cases import build_sphere3d
from ibx_torch.cases.sphere3d import gather_case
from ibx_torch.physics.fluid import pressure_coefficient

PATH = os.path.join(os.path.dirname(__file__), "data", "sphere3d_cp.npz")
STEPS = 200


def windward_checks(cp, points):
    """The assertions of tests/test_sphere3d_oracle.py:47 on ``cp`` at the
    wall ``points``."""
    pts = np.asarray(points, np.float64)
    r = np.linalg.norm(pts, axis=1)
    mu = np.clip(-pts[:, 0] / r, -1.0, 1.0)
    phi = np.degrees(np.arccos(mu))       # from the stagnation (-x) pole
    anchor = 1.0 - 2.25 * (1.0 - mu ** 2)
    assert 0.85 < cp.max() < 1.06, cp.max()
    assert phi[np.argmax(cp)] < 15.0, phi[np.argmax(cp)]
    for lo, band in ((0, 0.15), (15, 0.12), (30, 0.25)):
        m = (phi >= lo) & (phi < lo + 15)
        dev = (cp[m] - anchor[m]).mean()
        assert abs(dev) < band, (lo, dev)
        assert cp[m].std() < 0.15, (lo, cp[m].std())
    means = [cp[(phi >= lo) & (phi < lo + 15)].mean()
             for lo in (0, 15, 30, 45, 60)]
    assert all(a > b for a, b in zip(means, means[1:])), means


@pytest.mark.slow
@pytest.mark.parametrize("march", ["block", "gather"])
def test_windward_anchor_after_restart(march):
    """200 steps of the port from the oracle's converged state: finite,
    the windward anchor held, the wall Cp within the drift bands of the
    oracle's."""
    d = np.load(PATH)
    meta = json.loads(str(d["meta"]))
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    case = build_sphere3d(
        wall_h=meta["wall_h"], block_size=meta["block_size"],
        mach=meta["mach"], cfl=meta["cfl"], surface_h=meta["surface_h"],
        farfield=meta["farfield"], device=dev)
    assert case.dom.ncells == meta["cells"]
    if march == "gather":
        case = gather_case(case)
    P = case.apply_bcs(torch.as_tensor(d["P"], device=case.P0.device))
    P = case.march(P, STEPS)
    assert bool(torch.isfinite(P).all())
    surf = case.dom.surfaces["wall"]
    np.testing.assert_allclose(surf.points, d["points"], atol=1e-6)
    cp = pressure_coefficient(case.fluid, surf(P[:, 0]),
                              float(case.P_inf[0]), case.mach)
    cp = cp.cpu().numpy().astype(np.float64)
    windward_checks(cp, d["points"])
    dev_cp = np.abs(cp - np.asarray(d["cp"], np.float64))
    print(f"{march} march on {dev}, {STEPS} steps: Cp max {cp.max():.4f}, "
          f"|dCp| against the oracle mean {dev_cp.mean():.4e}, max "
          f"{dev_cp.max():.4e}")
    assert dev_cp.mean() < 2e-2, dev_cp.mean()
    assert dev_cp.max() < 8e-2, dev_cp.max()
