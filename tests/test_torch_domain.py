"""Port parity of the device side of `ibx_torch.topology.domain.Domain`
against `ibx.topology.domain.Domain` on the bs=4 advection mesh of
tests/test_domain.py, as one partition and as four: partition, boundary and
fused tables bit-equal; `impose_bc` and `FusedBoundary` (with and without
the mirrored normal velocity) 1e-6; `map` / `collect` partition invariance
1e-5 (as tests/test_domain.py); `volume_integral`, surfaces, `__len__`.
Each package builds its own mesh and domain from the same geometry."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.geometry import Line, Mesh as JxMesh, build_mesh, polyline
from ibx.ops import operators as jo
from ibx.topology import Domain as JxDomain

from ibx_torch import geometry as tg
from ibx_torch.ops import operators as to
from ibx_torch.topology.domain import Domain

from test_torch_operators import adv_mesh
from test_torch_stencil import (assert_stencil_equal, assert_tables_equal,
                                port_boundary, port_fused, rel_err)

torch.set_num_threads(2)
HF = [("outlet", [(0, True), (1, True)])]
NAMES = ("outlet", "lower", "upper")


@pytest.fixture(scope="module")
def doms():
    """n_partitions -> (JAX domain, port domain)."""
    jm = adv_mesh()
    tm = adv_mesh(tg.build_mesh, tg.polyline, tg.Line)
    return {P: (JxDomain(jm, n_partitions=P, hypercube_families=HF),
                Domain(tm, n_partitions=P, hypercube_families=HF,
                       device="cpu"))
            for P in (1, 4)}


@pytest.fixture(scope="module")
def fdoms():
    """One-partition domains whose "top" (the y = 1 side, 2-point stencils)
    and "lower" (the y = 0 wall, 4-point stencils) families share no ghost,
    as fusing asks."""
    hf = [("top", [(1, True)])]
    return (JxDomain(adv_mesh(), hypercube_families=hf),
            Domain(adv_mesh(tg.build_mesh, tg.polyline, tg.Line),
                   hypercube_families=hf, device="cpu"))


def _state(dom, seed=0):
    rng = np.random.default_rng(seed)
    x, y = dom.centers[:, 0], dom.centers[:, 1]
    P = np.stack([1e5 * (1 + 0.05 * np.sin(3 * x) * np.cos(2 * y)),
                  288.0 * (1 + 0.02 * np.cos(x)),
                  30.0 * np.sin(2 * y) + 5.0 * rng.standard_normal(x.size),
                  10.0 * np.cos(x) + 5.0 * rng.standard_normal(x.size)],
                 axis=1)
    return P.astype(np.float32)


@pytest.mark.parametrize("P", [1, 4])
def test_partition_tables_bit_equal(doms, P):
    """Own / skirt / padded cell sets and every table of every partition;
    the port builds the tables at first access."""
    jd, td = doms[P]
    assert td.n_partitions == jd.n_partitions == P and td.n_own == jd.n_own
    for name in ("part_own", "part_domain", "part_own_mask", "_part_g2l"):
        for a, b in zip(getattr(jd, name), getattr(td, name)):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    fresh = Domain(td.mesh, n_partitions=P, hypercube_families=HF,
                   device="cpu")
    assert fresh._partitions is None
    assert "partitions" not in fresh.build_timings
    parts = fresh.partitions
    assert fresh.build_timings["partitions"] > 0 and fresh.partitions is parts
    assert len(parts) == P
    for p in range(P):
        assert_tables_equal(jd.partitions[p], parts[p], f"part[{p}]")
    if P == 4:
        assert parts[3].n_dom > parts[3].n_own          # a skirt
        assert (jd.part_own[3].size < jd.n_own) == \
            (float(parts[3].own_mask.sum()) < jd.n_own)  # padding rows


@pytest.mark.parametrize("P", [1, 4])
def test_boundary_tables_bit_equal(doms, P):
    jd, td = doms[P]
    assert set(td.boundaries) == set(jd.boundaries) == set(NAMES)
    n = 0
    for name in NAMES:
        for p in range(P):
            jb, tb = jd.boundaries[name][p], td.boundaries[name][p]
            assert_tables_equal(jb, tb, f"{name}[{p}]")
            assert np.array_equal(jd._ghost_global[name][p],
                                  td._ghost_global[name][p])
            assert_tables_equal(jb, port_boundary(jb), "convert")
            n += tb.n_ghost
    assert n > 0


def test_fused_boundary_tables_bit_equal(doms, fdoms):
    jd, td = fdoms
    for names in (["top", "lower"], ["lower", "top"], ["top"]):
        jf, tf = jd.fused_boundary(names), td.fused_boundary(names)
        assert_tables_equal(jf, tf, "fused")
        assert_tables_equal(jf, port_fused(jf), "convert")
        assert (np.diff(tf.ghost.numpy()) > 0).all()
    assert tf.interp.width == 2 and jd.fused_boundary(
        ["top", "lower"]).interp.width == 4       # the narrow family padded
    with pytest.raises(ValueError, match="n_partitions"):
        doms[4][1].fused_boundary(["lower"])
    with pytest.raises(ValueError, match="share"):
        td.fused_boundary(["lower", "lower"])


@pytest.mark.parametrize("mirror", [False, True, "scaled"])
def test_fused_boundary_call_matches(fdoms, mirror):
    """Blend of two families with a guard, then the mirrored normal
    velocity of one of them, whole and gated row by row: 1e-6; cells that
    are no ghost keep their values, and the input is untouched."""
    from ibx.physics.fluid import physicality_guard as jguard
    from ibx_torch.physics.fluid import physicality_guard as tguard

    jd, td = fdoms
    names = ["lower", "top"]
    jf, tf = jd.fused_boundary(names), td.fused_boundary(names)
    P = _state(jd)
    rng = np.random.default_rng(1)
    scale = (rng.uniform(size=tf.ghost.shape[0]) > 0.4).astype(np.float32)
    fj = {"lower": lambda Pi, n: Pi * 0.5 + 1.0,
          "top": lambda Pi, n: jnp.concatenate(
              [Pi[:, :2], Pi[:, 2:] - n * (Pi[:, 2:] * n).sum(
                  axis=1, keepdims=True)], axis=1)}
    ft = {"lower": lambda Pi, n: Pi * 0.5 + 1.0,
          "top": lambda Pi, n: torch.cat(
              [Pi[:, :2], Pi[:, 2:] - n * (Pi[:, 2:] * n).sum(
                  dim=1, keepdim=True)], dim=1)}
    kj, kt = {}, {}
    if mirror:
        kj = kt = dict(mirror=("top",))
    if mirror == "scaled":
        kj = dict(kj, mirror_scale=jnp.asarray(scale))
        kt = dict(kt, mirror_scale=torch.tensor(scale))
    ref = np.asarray(jf(jnp.asarray(P), fj, guard=jguard, **kj))
    Pt = torch.tensor(P)
    out = tf(Pt, ft, guard=tguard, **kt).numpy()
    assert np.array_equal(Pt.numpy(), P)
    for c in range(4):
        assert rel_err(ref[:, c], out[:, c]) < 1e-6, c
    keep = np.ones(P.shape[0], bool)
    keep[tf.ghost.numpy()] = False
    assert np.array_equal(out[keep], P[keep])
    if mirror:
        plain = tf(Pt, ft, guard=tguard).numpy()
        assert np.abs(out - plain).max() > 1e-3


@pytest.mark.parametrize("P,mirror", [(1, False), (1, True), (1, "gate"),
                                      (4, False), (4, True)])
def test_impose_bc_matches(doms, P, mirror):
    """`impose_bc` family by family on a 4-channel state (a callback that
    reads the boundary's normals and a keyword), then on two arrays at
    once: 1e-6 against the JAX domain with the same partition count (an
    array gate is aligned with one partition's ghosts, so P = 1 only)."""
    jd, td = doms[P]
    S = _state(jd, 2)
    u = S[:, 2].copy()
    fn_j = lambda b, Pi, k=1.0: Pi * 0.25 + k * b.normals[:, :1]   # noqa
    fn_t = lambda b, Pi, k=1.0: Pi * 0.25 + k * b.normals[:, :1]   # noqa
    ref, out = jnp.asarray(S), torch.tensor(S)
    for name in NAMES:
        mj = mt = mirror
        if mirror == "gate":
            g = (np.arange(jd.boundaries[name][0].n_ghost) % 2).astype(
                np.float32)
            mj, mt = jnp.asarray(g), torch.tensor(g)
        ref = jd.impose_bc(name, fn_j, ref, mirror_velocity=mj, k=2.0)
        out = td.impose_bc(name, fn_t, out, mirror_velocity=mt, k=2.0)
    for c in range(4):
        assert rel_err(np.asarray(ref)[:, c], out.numpy()[:, c]) < 1e-6, c
    assert np.array_equal(S, _state(jd, 2))
    r2 = jd.impose_bc("upper", lambda b, a, c: (jnp.ones_like(a), c * 0.5),
                      jnp.asarray(u), jnp.asarray(S))
    o2 = td.impose_bc("upper", lambda b, a, c: (torch.ones_like(a), c * 0.5),
                      u, S)                      # numpy in
    assert isinstance(o2, tuple) and len(o2) == 2
    for a, b in zip(r2, o2):
        assert rel_err(a, b.numpy()) < 1e-6


def test_impose_bc_dirichlet(doms):
    """tests/test_domain.py::test_impose_bc_dirichlet on the port."""
    _, td = doms[1]
    u = td.impose_bc("upper", lambda b, ui: torch.ones_like(ui),
                     torch.zeros(td.ncells))
    bdry = td.boundaries["upper"][0]
    ghosts = bdry.ghost.numpy()
    assert ghosts.size > 0
    np.testing.assert_allclose(u.numpy()[ghosts], 1.0 - bdry.eta.numpy(),
                               atol=1e-5)
    assert float(u.sum()) > 0


def _residual(ops, zeros_like):
    def residual(part, u):
        D = ops.jst_sensor(part, u)
        r = zeros_like(u)
        for dim in range(part.nd):
            du = ops.cell_gradient(part, u, dim)
            uL, uR = ops.muscl(part, u, du, dim, D=D, high_order=True)
            flux = (uL + uR) / 2 + (uL - uR) / 2
            r = r - ops.green_gauss(part, flux, dim)
        return u + 0.01 * r
    return residual


def test_map_partition_invariance(doms):
    """tests/test_domain.py::test_partition_invariance on the port: the
    mapped residual does not depend on the partition count (1e-5), and
    equals the JAX domain's (1e-6)."""
    u0 = _state(doms[1][0])[:, 2] / 30.0
    res_t = _residual(to, torch.zeros_like)
    r1 = doms[1][1].map(res_t, torch.tensor(u0)).numpy()
    r4 = doms[4][1].map(res_t, u0).numpy()
    np.testing.assert_allclose(r1, r4, atol=1e-5)
    ref = np.asarray(doms[4][0].map(_residual(jo, jnp.zeros_like),
                                    jnp.asarray(u0)))
    assert rel_err(ref, r4) < 1e-6


@pytest.mark.parametrize("P", [1, 4])
def test_map_tuple_and_collect(doms, P):
    """`map` with two arrays in and out, and `collect`'s per-partition
    values, against the JAX domain."""
    jd, td = doms[P]
    S = _state(jd, 3)
    a, b = S[:, 0] / 1e5, S[:, 2:]
    rj = jd.map(lambda part, x, y: (x * 2.0, y + x[:, None]),
                jnp.asarray(a), jnp.asarray(b))
    rt = td.map(lambda part, x, y: (x * 2.0, y + x[:, None]),
                torch.tensor(a), torch.tensor(b))
    assert isinstance(rt, tuple) and len(rt) == 2
    for x, y in zip(rj, rt):
        assert rel_err(x, y.numpy()) < 1e-6
    one = td.map(lambda part, x: [x + 1.0], torch.tensor(a))
    assert torch.is_tensor(one)
    cj = jd.collect(lambda part, x: (x * part.own_mask).sum(), jnp.asarray(a))
    ct = td.collect(lambda part, x: (x * part.own_mask).sum(),
                    torch.tensor(a))
    assert len(ct) == P
    np.testing.assert_allclose([float(v) for v in ct],
                               [float(v) for v in cj], rtol=1e-5)
    np.testing.assert_allclose(sum(float(v) for v in ct), a.sum(), rtol=1e-4)


def test_volume_integral_len_and_surface(doms):
    jd, td = doms[1]
    assert len(td) == td.ncells == len(jd)
    np.testing.assert_allclose(float(td.volume_integral(
        torch.ones(td.ncells))), 1.0, rtol=1e-5)
    cg = td.volume_integral(td.centers).numpy()
    np.testing.assert_allclose(cg, [0.5, 0.5], atol=1e-4)
    assert rel_err(np.asarray(jd.volume_integral(jnp.asarray(jd.centers))),
                   cg) < 1e-6
    for name in ("lower", "upper"):
        js, ts_ = jd.surfaces[name], td.surfaces[name]
        assert_stencil_equal(js.interpolator, ts_.interpolator)
        assert_stencil_equal(js.offset_interpolator, ts_.offset_interpolator)
    xs = td.surfaces["lower"](td.centers[:, 0]).numpy()
    np.testing.assert_allclose(xs, td.surfaces["lower"].points[:, 0],
                               atol=0.05)


def test_face_counts_uniform_and_max_partition_size():
    """tests/test_domain.py::test_face_counts_uniform on the port, and
    ``max_partition_size`` converted to a partition count as in the JAX
    package."""
    kw = dict(origin=np.zeros(2, np.float32), widths=np.ones(2, np.float32),
              block_size=4, block_origins=np.zeros((1, 2), np.float32),
              block_widths=np.ones((1, 2), np.float32), distance_fields={})
    dom = Domain(tg.Mesh(**kw), device="cpu")
    assert dom.face_dim.size == 24 + 16
    part = dom.partitions[0]
    for d in range(2):
        assert part.face_owner[d].shape[0] == 12 + 8
    td = Domain(tg.Mesh(**kw), max_partition_size=5, device="cpu")
    jd = JxDomain(JxMesh(**kw), max_partition_size=5)
    assert td.n_partitions == jd.n_partitions == 4
    assert td.reconstruction_kwargs == jd.reconstruction_kwargs
    for p in range(4):
        assert_tables_equal(jd.partitions[p], td.partitions[p])
