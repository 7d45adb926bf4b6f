"""Port parity of the wing's FAS V-cycle and of its four-rank march
(`ibx_torch.cases.build_wing3d_rans_fas`) at the JAX package's test size
(`tests/test_wing3d_fas.py:15`, 4096 cells): one cycle on one rank (in
this process) and on four gloo ranks (spawned) against the JAX package's
jitted 1-device cycle, ``res_norms``, and the four ranks against the one
rank at the JAX test's own bounds."""

import numpy as np
import pytest
import torch

from ibx.cases.wing3d_rans_fas import (
    build_wing3d_rans_fas as jx_build_wing)

from ibx_torch.cases import build_wing3d_rans_fas
from ibx_torch.parallel import one_rank_group, spawn

from test_torch_wing3d_ranks import WING, wing_outputs, wing_rank

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    """The JAX wing on one device: one FAS cycle from ``S0`` and
    ``res_norms(S0)``."""
    case = jx_build_wing(1, **WING)
    S, res = case.fas_cycle(case.S0_sh)
    l2, mx = case.res_norms(case.S0_sh)
    return dict(cycle=case.collect(S), cycle_res=float(res), l2=float(l2),
                mx=float(mx))


@pytest.fixture(scope="module")
def one():
    """The port's wing on one gloo rank of this process."""
    with one_rank_group("gloo"):
        return wing_outputs(build_wing3d_rans_fas(1, device="cpu", **WING))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The port's wing on four spawned gloo ranks."""
    d = tmp_path_factory.mktemp("wing_four")
    spawn(wing_rank, 4, backend="gloo", device="cpu", args=(str(d),),
          threads=1)
    return dict(np.load(d / "out.npz"))


def _err(ref, out):
    """Max abs error per channel over that channel's max |ref|."""
    return (np.abs(out - ref) / (np.abs(ref).max(axis=0) + 1e-12)).max(0)


@pytest.mark.parametrize("ranks", ["one", "four"])
def test_cycle_matches_jax(jx, one, four, ranks):
    """One 2-level V-cycle (pre-smooth, 4 tau-corrected coarse
    relaxations, prolonged correction, post-smooth) against the JAX
    package's jitted cycle: every channel within 1e-3 of its scale
    (measured 2.4e-5 on one rank and on four); the cycle's residual
    within rtol 1e-4."""
    out = {"one": one, "four": four}[ranks]
    assert np.isfinite(out["cycle"]).all()
    err = _err(jx["cycle"], out["cycle"])
    assert err.max() < 1e-3, err
    assert abs(float(out["cycle_res"]) - jx["cycle_res"]) \
        <= 1e-4 * abs(jx["cycle_res"])


@pytest.mark.parametrize("ranks", ["one", "four"])
def test_res_norms_match_jax(jx, one, four, ranks):
    """L2 and max of dt*R over the solved cells at ``S0``: rtol 1e-4
    against the JAX package's (measured 1.2e-6 and 0 on one rank)."""
    out = {"one": one, "four": four}[ranks]
    for key in ("l2", "mx"):
        assert abs(float(out[key]) - jx[key]) <= 1e-4 * abs(jx[key]), key


def test_four_ranks_match_one_rank(one, four):
    """The decomposition changes nothing beyond rounding: four ranks
    against one, 10 march steps under 2e-5 and one cycle under 5e-5 per
    channel, the JAX test's own bounds (tests/test_wing3d_fas.py:31, 44)."""
    assert np.array_equal(four["S0"], one["S0"])
    for key, tol in (("march", 2e-5), ("cycle", 5e-5)):
        assert np.isfinite(four[key]).all()
        err = _err(one[key], four[key])
        assert err.max() < tol, (key, err)
