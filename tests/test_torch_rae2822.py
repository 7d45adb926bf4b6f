"""Port parity for the 2D slice as a whole: `ibx_torch.cases.build_rae2822`
(device="cpu") against the JAX package's case at wall_h=8e-2 (the fixture
of tests/test_block_ops.py): marches of a few steps in each configuration
`build_rae2822` has keywords for, one step with its resnorm, the wall Cp and
the force coefficients, the gather branch (``use_blocks=False``, also with
``mirror_wall``), the two-partition build, and the options the port
refuses."""

import inspect
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.cases import build_rae2822 as jx_build_rae2822
from ibx.cases import force_coefficients as jx_force_coefficients
from ibx.cases import wall_cp as jx_wall_cp

from ibx_torch.cases import build_rae2822, force_coefficients, wall_cp
from ibx_torch.ops import kernels as K

from test_torch_block_ops_2d import perturbed
from test_torch_kernels import chan_err, t

torch.set_num_threads(2)
SMALL = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7)
DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def cases():
    jx = jx_build_rae2822(**SMALL)
    pt = build_rae2822(device="cpu", **SMALL)
    return jx, pt


def test_signature_matches_ibx():
    """Same parameters, names and defaults as the JAX `build_rae2822`, plus
    ``device="cuda"``."""
    ref = inspect.signature(jx_build_rae2822).parameters
    out = inspect.signature(build_rae2822).parameters
    assert list(out)[:-1] == list(ref) and list(out)[-1] == "device"
    assert out["device"].default == "cuda"
    for name, p in ref.items():
        assert out[name].default == p.default, name
        assert out[name].kind == p.kind, name


def test_march5_matches_case_march(cases):
    """5 steps of `case.march` from the JAX case's initial state against
    its `march`: < 1e-3 per channel (as tests/test_block_ops.py), with no
    kernel launch counted."""
    jx, pt = cases
    K.reset_launches()
    ref = np.asarray(jx.march(jx.P0, 5))
    out = pt.march(t(np.asarray(jx.P0)), 5).numpy()
    assert np.isfinite(out).all()
    assert chan_err(ref, out) < 1e-3, chan_err(ref, out)
    assert not any(K.launches.values())


def test_step_matches_case_step(cases):
    """One `case.step` from a perturbed state: state < 1e-4 per channel,
    resnorm rtol 1e-4; the input state is left as it was."""
    jx, pt = cases
    P = perturbed(jx, seed=3)
    ref, res_ref = jx.step(jnp.asarray(P))
    Pt = t(P)
    out, res = pt.step(Pt)
    assert chan_err(ref, out.numpy()) < 1e-4, chan_err(ref, out.numpy())
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))
    assert np.array_equal(Pt.numpy(), P)


def test_march_robust_matches(cases):
    """2 steps of the first-order + Einfeldt march: < 1e-3 per channel."""
    jx, pt = cases
    ref = np.asarray(jx.march_robust(jx.P0, 2))
    out = pt.march_robust(t(np.asarray(jx.P0)), 2).numpy()
    assert chan_err(ref, out) < 1e-3, chan_err(ref, out)
    plain = pt.march(t(np.asarray(jx.P0)), 2).numpy()
    assert chan_err(plain, out) > 1e-6        # the blend did something


@pytest.mark.parametrize("variant", ["euler", "te_fix", "wall_fix",
                                     "irs_freeze"])
def test_march2_variants_match(variant):
    """2 steps of `case.march` under the other keywords of `build_rae2822`
    (``scheme="euler"``; ``te_fix_radius=0.3``; ``wall_fix_cells=2``;
    ``irs_eps=0.5`` with ``freeze_gradients``) against the JAX case built
    the same way: < 1e-3 per channel."""
    kw = {"euler": dict(scheme="euler", cfl=0.4),
          "te_fix": dict(te_fix_radius=0.3),
          "wall_fix": dict(wall_fix_cells=2.0),
          "irs_freeze": dict(irs_eps=0.5, freeze_gradients=True)}[variant]
    kw = dict(SMALL, **kw)
    jx = jx_build_rae2822(**kw)
    pt = build_rae2822(device="cpu", **kw)
    if variant.endswith("fix"):
        fix = pt.fix3.numpy()
        assert np.array_equal(np.asarray(jx.grid["fix3"]), fix)
        assert 0 < (fix > 0).mean() < 0.5
    else:
        assert pt.fix3 is None
    ref = np.asarray(jx.march(jx.P0, 2))
    out = pt.march(t(np.asarray(jx.P0)), 2).numpy()
    assert np.isfinite(out).all()
    assert chan_err(ref, out) < 1e-3, chan_err(ref, out)


def test_wall_cp_and_forces_match(cases):
    """`wall_cp` and `force_coefficients` on the same marched state: 1e-5
    (absolute on Cp, Cl and Cd, all O(1)); numpy and tensor inputs agree."""
    jx, pt = cases
    P = np.asarray(jx.march(jx.P0, 5))
    cp_ref = jx_wall_cp(jx, P)
    cp = wall_cp(pt, P)
    assert cp.shape == cp_ref.shape and cp.dtype == np.float32
    assert np.abs(cp - cp_ref).max() < 1e-5
    assert np.array_equal(cp, wall_cp(pt, t(P)))
    cl_ref, cd_ref = jx_force_coefficients(jx, P)
    cl, cd = force_coefficients(pt, t(P))
    assert abs(cl - cl_ref) < 1e-5 and abs(cd - cd_ref) < 1e-5
    surf = pt.dom.surfaces["wall"]
    off_ref = np.asarray(jx.dom.surfaces["wall"].at_offset(P[:, 0]))
    assert np.allclose(surf.at_offset(P[:, 0]).numpy(), off_ref, rtol=1e-6)


def test_surface_integral_matches(cases):
    """Area-weighted surface sum of a 2-column field: rtol 1e-5."""
    from ibx.topology.domain import surface_integral as jx_integral
    from ibx_torch.topology.domain import surface_integral

    jx, pt = cases
    rng = np.random.default_rng(6)
    js, ps = jx.dom.surfaces["wall"], pt.dom.surfaces["wall"]
    u = rng.standard_normal((ps.points.shape[0], 2)).astype(np.float32)
    ref = np.asarray(jx_integral(js, u))
    out = surface_integral(ps, u).numpy()
    assert np.allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_apply_bcs_is_functional(cases):
    """`apply_bcs` on the flat state returns a new tensor that equals the
    in-place grid BC, against the JAX case's to 2e-5 per channel."""
    jx, pt = cases
    P = perturbed(jx, seed=4)
    Pt = t(P)
    out = pt.apply_bcs(Pt)
    assert np.array_equal(Pt.numpy(), P)
    ref = np.asarray(jx.apply_bcs(jnp.asarray(P)))
    assert chan_err(ref, out.numpy()) < 2e-5
    assert (out.numpy() != P).any(axis=1).sum() == pt.bc.ghost_b.shape[0]


@pytest.mark.parametrize("kw,exc", [
    (dict(cutcell=True, use_blocks=False), ValueError),
    (dict(cutcell=True, n_partitions=2), ValueError),
], ids=["cutcell_gather", "cutcell_partitions"])
def test_unported_options_raise(kw, exc):
    """Every option of the JAX `build_rae2822` is ported; the combinations
    the JAX package refuses raise here too (``cutcell`` off the block
    march)."""
    with pytest.raises(exc, match="block fast path"):
        build_rae2822(device="cpu", **SMALL, **kw)
    with pytest.raises(exc, match="block fast path"):
        jx_build_rae2822(**SMALL, **kw)


@pytest.fixture(scope="module")
def gather_cases():
    jx = jx_build_rae2822(use_blocks=False, **SMALL)
    pt = build_rae2822(use_blocks=False, device="cpu", **SMALL)
    return jx, pt


def test_gather_case_matches(gather_cases):
    """``use_blocks=False``: initial state and `apply_bcs` 2e-5 per
    channel, one `case.step` from a perturbed state 1e-4 with its resnorm
    (the JAX step is jitted), 5 steps of `case.march` 1e-3; `wall_cp` and
    `force_coefficients` work on the branch; the block-only entry points
    say so."""
    jx, pt = gather_cases
    assert pt.bt is None and pt.bc is None and not pt.blocks_on
    assert jx.grid is None and jx.march_robust is None
    assert chan_err(np.asarray(jx.P0), pt.P0.numpy()) < 2e-5
    P = perturbed(jx, seed=7)
    Pt = t(P)
    out = pt.apply_bcs(Pt)
    assert np.array_equal(Pt.numpy(), P)
    assert chan_err(np.asarray(jx.apply_bcs(jnp.asarray(P))),
                    out.numpy()) < 2e-5
    ref, res_ref = jx.step(jnp.asarray(P))
    K.reset_launches()
    out, res = pt.step(Pt)
    assert chan_err(ref, out.numpy()) < 1e-4, chan_err(ref, out.numpy())
    assert abs(float(res) - float(res_ref)) <= 1e-4 * abs(float(res_ref))
    ref = np.asarray(jx.march(jx.P0, 5))
    out = pt.march(t(np.asarray(jx.P0)), 5)
    assert chan_err(ref, out.numpy()) < 1e-3
    assert not any(K.launches.values())
    assert np.abs(wall_cp(pt, out) - jx_wall_cp(jx, ref)).max() < 1e-3
    cl, cd = force_coefficients(pt, out)
    assert np.isfinite([cl, cd]).all()
    with pytest.raises(ValueError, match="block march"):
        pt.march_robust(pt.P0, 1)


def test_gather_mirror_wall_matches():
    """``mirror_wall=True`` on the gather branch (the mirrored ghost normal
    velocity through `FusedBoundary`, gated by the host's thin-solid
    probe): `apply_bcs` 2e-5 and 3 steps 1e-3 per channel; the mirror moves
    the wall ghosts."""
    kw = dict(SMALL, use_blocks=False, mirror_wall=True)
    jx = jx_build_rae2822(**kw)
    pt = build_rae2822(device="cpu", **kw)
    P = perturbed(jx, seed=8)
    ref = np.asarray(jx.apply_bcs(jnp.asarray(P)))
    out = pt.apply_bcs(t(P)).numpy()
    assert chan_err(ref, out) < 2e-5, chan_err(ref, out)
    plain = build_rae2822(device="cpu", **dict(kw, mirror_wall=False))
    assert np.abs(out - plain.apply_bcs(t(P)).numpy()).max() > 1e-2
    ref = np.asarray(jx.march(jx.P0, 3))
    out = pt.march(t(np.asarray(jx.P0)), 3).numpy()
    assert chan_err(ref, out) < 1e-3, chan_err(ref, out)


def test_two_partition_build_matches():
    """``n_partitions=2`` builds the domain, its partitions and the
    family-by-family ghost BC as the JAX package does: tables bit-equal,
    `apply_bcs` and `P0` 2e-5 per channel. The case's own step refuses,
    naming the multi-partition march (`build_rae2822_sharded`), as the
    JAX package's own step fails there."""
    from test_torch_stencil import assert_tables_equal

    jx = jx_build_rae2822(n_partitions=2, **SMALL)
    pt = build_rae2822(n_partitions=2, device="cpu", **SMALL)
    assert pt.dom.n_partitions == 2 and not pt.blocks_on
    for p in range(2):
        assert_tables_equal(jx.dom.partitions[p], pt.dom.partitions[p])
        assert np.array_equal(jx.dom.part_domain[p], pt.dom.part_domain[p])
        for name in ("farfield", "wall"):
            assert_tables_equal(jx.dom.boundaries[name][p],
                                pt.dom.boundaries[name][p])
    assert chan_err(np.asarray(jx.P0), pt.P0.numpy()) < 2e-5
    P = perturbed(jx, seed=9)
    ref = np.asarray(jx.apply_bcs(jnp.asarray(P)))
    assert chan_err(ref, pt.apply_bcs(t(P)).numpy()) < 2e-5
    with pytest.raises(NotImplementedError, match="build_rae2822_sharded"):
        pt.step(pt.P0)


def test_build_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_rae2822(**SMALL)


@pytest.mark.slow
def test_rae2822_cp_drift_from_converged_fine():
    """Restart from the committed converged fine state (60,544 cells,
    steady), march the oracle's 8 phases of 500 steps and hold the
    cycle-mean wall Cp to the oracle's: mean |dCp| < 1e-3, max < 5e-3 (the
    bands of tests/test_rae2822_regression.py for the steady levels)."""
    ref = np.load(os.path.join(DATA, "rae2822_cp_fine.npz"))
    meta = json.loads(str(ref["meta"]))
    case = build_rae2822(wall_h=meta["wall_h"], feature_h=meta["feature_h"],
                         cfl=meta.get("cfl", 0.7),
                         block_size=meta.get("block_size", 8), device="cpu")
    stride = int(meta.get("phase_stride", 500))
    P = case.apply_bcs(t(ref["P"]))
    cps = []
    for _ in range(ref["cp_phases"].shape[0]):
        P = case.march(P, stride)
        cps.append(wall_cp(case, P))
    d = np.abs(np.stack(cps).mean(axis=0) - ref["cp_phases"].mean(axis=0))
    assert d.mean() < 1e-3, d.mean()
    assert d.max() < 5e-3, d.max()
