"""Port parity of the multigrid transfers (`ibx_torch.solve.mgrid`,
`ibx_torch.solve.multigrid_domain`, `ibx_torch.solve.interp_util`) against
the JAX package's: the host-built tables bit-equal (the port holds its
indices as int64), the transfers applied to the same seeded numpy field
within 1e-6 relative, on the 256 random points of tests/test_solve.py (with
and without ``random_permutation``) and on its diffusion mesh (3 coarse
levels, block 8 -> 4 -> 2 -> 1). Plus the reference's own checks of both,
on the port."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.geometry import build_mesh as jx_build_mesh
from ibx.geometry import polyline as jx_polyline
from ibx.solve import coarsener_and_prolongator as jx_cp
from ibx.solve import multigrid as jx_multigrid
from ibx.solve import multigrid_levels as jx_levels
from ibx.topology import Domain as JxDomain

from ibx_torch.geometry import build_mesh, polyline
from ibx_torch.solve import (coarsener_and_prolongator, multigrid,
                             multigrid_levels)
from ibx_torch.topology.domain import Domain

from test_torch_stencil import assert_stencil_equal

torch.set_num_threads(2)
OUTER = [("outer", [(0, False), (0, True), (1, True)])]


def _points():
    rng = np.random.default_rng(0)
    return rng.uniform(size=(256, 2)).astype(np.float32)


def _field(n, seed=1, cols=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, cols)).astype(np.float32)


def _rel(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _hold(jx_st, st, n_in):
    """Tables bit-equal, the applied transfer within 1e-6 relative."""
    assert_stencil_equal(jx_st, st)
    u = _field(n_in)
    assert _rel(jx_st(jnp.asarray(u)), st(torch.as_tensor(u))) < 1e-6


def diffusion_mesh(bm, pl):
    """The diffusion mesh of tests/test_solve.py:72-84 by either package's
    mesher."""
    lower = pl(np.array([[0.0, 0.0], [1.0, 0.0]]), closed=False)
    return bm([0.0, 0.0], [1.0, 1.0], ("lower", lower, 5e-2), block_size=8)


@pytest.fixture(scope="module")
def diff_doms():
    jd = JxDomain(diffusion_mesh(jx_build_mesh, jx_polyline),
                  hypercube_families=OUTER)
    td = Domain(diffusion_mesh(build_mesh, polyline),
                hypercube_families=OUTER, device="cpu")
    return jd, td


@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("n", [1, 2])
def test_coarsener_and_prolongator_match_ibx(n, perm):
    X = _points()
    jc, jp = jx_cp(X, n, random_permutation=perm)
    c, p = coarsener_and_prolongator(X, n, random_permutation=perm,
                                     device="cpu")
    assert c.idx.device.type == "cpu"
    _hold(jc, c, X.shape[0])
    _hold(jp, p, c.n_output)


@pytest.mark.parametrize("perm", [False, True])
def test_multigrid_levels_match_ibx(perm):
    X = _points()
    vol = np.linspace(0.5, 1.5, X.shape[0]).astype(np.float32)
    jmg = jx_levels(X, 3, vol, random_permutation=perm)
    mg = multigrid_levels(X, 3, vol, random_permutation=perm, device="cpu")
    assert len(mg.coarseners) == len(mg.prolongators) == 3
    for jc, jp, c, p in zip(jmg.coarseners, jmg.prolongators,
                            mg.coarseners, mg.prolongators):
        _hold(jc, c, X.shape[0])
        _hold(jp, p, c.n_output)


def test_domain_hierarchy_matches_ibx(diff_doms):
    jd, td = diff_doms
    jh = jx_multigrid(jd)
    h = multigrid(td)
    assert len(h.coarse_domains) == len(jh.coarse_domains) == 3
    assert h.coarse_domains[0].ncells == td.ncells // 4
    n_in = td.ncells
    for i, (jcd, cd) in enumerate(zip(jh.coarse_domains, h.coarse_domains)):
        assert cd.device == td.device
        assert cd.ncells == jcd.ncells
        np.testing.assert_array_equal(cd.centers, jcd.centers)
        assert cd.partitions[0].centers.device == td.device
        _hold(jh.coarseners[i], h.coarseners[i], n_in)
        _hold(jh.prolongators[i], h.prolongators[i], cd.ncells)
        assert h.coarseners[i].idx.device == td.device
        n_in = cd.ncells


def test_mgrid_transfer_partition_of_unity():
    """tests/test_solve.py::test_mgrid_transfer_partition_of_unity on the
    port."""
    X = _points()
    c, p = coarsener_and_prolongator(X, 1, device="cpu")
    const = torch.ones(256)
    np.testing.assert_allclose(c(const).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(p(c(const)).numpy(), 1.0, atol=1e-6)
    mg = multigrid_levels(X, 2, device="cpu")
    assert len(mg.coarseners) == 2


def test_domain_multigrid_hierarchy(diff_doms):
    """tests/test_solve.py::test_domain_multigrid_hierarchy on the port."""
    _, dom = diff_doms
    hier = multigrid(dom)
    assert len(hier.coarse_domains) == 3  # block 8 -> 4 -> 2 -> 1
    assert hier.coarse_domains[0].ncells == dom.ncells // 4
    const = torch.ones(dom.ncells)
    c0 = hier.coarseners[0](const).numpy()
    np.testing.assert_allclose(c0, 1.0, atol=1e-3)
    back = hier.prolongators[0](hier.coarseners[0](const)).numpy()
    np.testing.assert_allclose(back, 1.0, atol=1e-3)


def test_transfers_default_to_the_card(monkeypatch):
    """The transfers are built on the card unless asked otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        coarsener_and_prolongator(_points(), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        multigrid_levels(_points(), 1)
