"""Port parity of the finite-volume operators (`ibx_torch.ops.operators`)
against `ibx.ops.operators`, function by function, on the bs=4 advection
mesh of tests/test_domain.py (2:1 jumps, one-sided hypercube faces) as one
partition and as partition 2 of 4 (padding rows and a skirt), and on the
bs=4 sphere octree (nd = 3, K = 4 accumulators).

Both packages get the same tables (the JAX package's, through
`ibx_torch.convert.partition_from_numpy`) and the same numpy fields from a
seed. The JAX functions run un-jitted, op by op, as the port's do; each
result is held to 1e-6 of the reference's largest magnitude."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.geometry import Line, build_mesh, polyline
from ibx.ops import operators as jo
from ibx.topology import Domain as JxDomain

from ibx_torch.ops import operators as to
from ibx_torch.ops import scheme

from test_torch_stencil import assert_tables_equal, port_partition, rel_err

torch.set_num_threads(2)
TOL = 1e-6


def adv_mesh(build=build_mesh, polyline=polyline, Line=Line, h=4e-2):
    """The advection geometry of tests/test_domain.py:10-21."""
    lower = polyline(np.array([[0.0, 0.0], [1.0, 0.0]]), closed=False)
    upper = polyline(np.array([[0.0, 0.0], [0.0, 1.0]]), closed=False)
    return build(
        [0.0, 0.0], [1.0, 1.0],
        ("lower", lower, h),
        ("upper", upper, h),
        refinement_regions=[(Line([0.0, 0.0], [1.0, 1.0]), 2 * h)],
        block_size=4,
    )


@pytest.fixture(scope="module")
def parts():
    """name -> (JAX partition, port partition, local cell centers)."""
    msh = adv_mesh()
    hf = [("outlet", [(0, True), (1, True)])]
    dom1 = JxDomain(msh, hypercube_families=hf)
    dom4 = JxDomain(msh, n_partitions=4, hypercube_families=hf)
    from ibx.cases import build_sphere3d
    sph = build_sphere3d(wall_h=0.25, block_size=4, use_blocks=False)
    out = {}
    for name, part in (("one", dom1.partitions[0]),
                       ("part2of4", dom4.partitions[2]),
                       ("sphere", sph.dom.partitions[0])):
        out[name] = (part, port_partition(part), np.asarray(part.centers))
    assert out["part2of4"][0].n_dom > out["part2of4"][0].n_own
    assert out["sphere"][0].acc_left[0].width == 4
    return out


def _fields(centers, seed):
    """A scalar and a 3-channel field on the partition's cells, and a face
    field per dim: smooth parts plus noise."""
    rng = np.random.default_rng(seed)
    n = centers.shape[0]
    x, y = centers[:, 0], centers[:, 1]
    u = (np.sin(3.0 * x) * np.cos(2.0 * y)
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    U = np.stack([u, 2.0 + x * y, rng.standard_normal(n)],
                 axis=1).astype(np.float32)
    return u, U, rng


def test_partition_tables_cross_bit_equal(parts):
    for name, (jp, tp, _) in parts.items():
        assert_tables_equal(jp, tp, name)
        moved = tp.to("cpu")
        assert moved is not tp and moved.nd == tp.nd
        assert torch.equal(moved.acc_left[0].idx, tp.acc_left[0].idx)


CELL_OPS = {
    "at_owners": lambda o, p, v, d: o.at_owners(p, v, d),
    "at_neighbors": lambda o, p, v, d: o.at_neighbors(p, v, d),
    "at_faces": lambda o, p, v, d: o.at_faces(p, v, d),
    "cell_gradient": lambda o, p, v, d: o.cell_gradient(p, v, d),
    "face_gradient": lambda o, p, v, d: o.face_gradient(p, v, d),
}


@pytest.mark.parametrize("which", ["one", "part2of4", "sphere"])
@pytest.mark.parametrize("name", sorted(CELL_OPS))
def test_cell_to_face_ops(parts, which, name):
    """Cell-input operators, every dim, on a scalar and a 3-channel field."""
    jp, tp, c = parts[which]
    u, U, _ = _fields(c, 1)
    for v in (u, U):
        for d in range(jp.nd):
            ref = CELL_OPS[name](jo, jp, jnp.asarray(v), d)
            out = CELL_OPS[name](to, tp, torch.tensor(v), d)
            assert rel_err(ref, out.numpy()) < TOL, (name, d)


@pytest.mark.parametrize("which", ["one", "part2of4", "sphere"])
@pytest.mark.parametrize("name", ["green_gauss", "unsigned_green_gauss"])
def test_face_to_cell_ops(parts, which, name):
    jp, tp, c = parts[which]
    rng = np.random.default_rng(2)
    for d in range(jp.nd):
        F = int(jp.face_owner[d].shape[0])
        for shape in ((F,), (F, 3)):
            uf = rng.standard_normal(shape).astype(np.float32)
            ref = getattr(jo, name)(jp, jnp.asarray(uf), d)
            out = getattr(to, name)(tp, torch.tensor(uf), d)
            assert rel_err(ref, out.numpy()) < TOL, (name, d)


@pytest.mark.parametrize("which", ["one", "part2of4", "sphere"])
def test_divergent_and_gradient_tuple(parts, which):
    jp, tp, c = parts[which]
    u, U, rng = _fields(c, 3)
    uf = [rng.standard_normal((int(jp.face_owner[d].shape[0]), 2))
          .astype(np.float32) for d in range(jp.nd)]
    ref = jo.divergent(jp, tuple(jnp.asarray(a) for a in uf))
    out = to.divergent(tp, tuple(torch.tensor(a) for a in uf))
    assert rel_err(ref, out.numpy()) < TOL
    gj = jo.cell_gradient(jp, jnp.asarray(U))
    gt = to.cell_gradient(tp, torch.tensor(U))
    assert len(gj) == len(gt) == jp.nd
    for a, b in zip(gj, gt):
        assert rel_err(a, b.numpy()) < TOL
    # the full face-gradient tuple (normal component two-point)
    for d in range(jp.nd):
        fj = jo.face_gradient(jp, jnp.asarray(U), d, gj)
        ft = to.face_gradient(tp, torch.tensor(U), d, gt)
        assert len(fj) == len(ft) == jp.nd
        for a, b in zip(fj, ft):
            assert rel_err(a, b.numpy()) < TOL


@pytest.mark.parametrize("which", ["one", "part2of4", "sphere"])
@pytest.mark.parametrize("name", ["face_distance", "owner_distance",
                                  "neighbor_distance"])
def test_distances(parts, which, name):
    """Pure table functions: bit-equal."""
    jp, tp, _ = parts[which]
    for d in range(jp.nd):
        ref = np.asarray(getattr(jo, name)(jp, d))
        assert np.array_equal(ref, getattr(to, name)(tp, d).numpy())


@pytest.mark.parametrize("which", ["one", "part2of4", "sphere"])
def test_jst_sensor(parts, which):
    """Per dim and the max over dims, on a smooth field and on a step; the
    aliases name the same functions."""
    jp, tp, c = parts[which]
    u, _, _ = _fields(c, 4)
    step = (c[:, 0] > 0.5).astype(np.float32)
    for v in (u, step):
        for d in list(range(jp.nd)) + [None]:
            ref = jo.jst_sensor(jp, jnp.asarray(v), d)
            out = to.jst_sensor(tp, torch.tensor(v), d)
            assert rel_err(ref, out.numpy()) < TOL, d
    assert to.JST_sensor is to.jst_sensor and to.MUSCL is to.muscl


def test_minmod_is_one_definition():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((200, 3)).astype(np.float32)
    b = rng.standard_normal((200, 3)).astype(np.float32)
    a[::7] = 0.0
    ref = np.asarray(jo.minmod(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(ref, to.minmod(torch.tensor(a),
                                         torch.tensor(b)).numpy())
    assert scheme.minmod is to.minmod


MUSCL_KW = {
    "plain": dict(),
    "sensor": dict(D=True),
    "sensor_high_order": dict(D=True, high_order=True),
    "lim_scale": dict(D=True, high_order=True, lim_scale=True),
}


@pytest.mark.parametrize("which", ["one", "part2of4", "sphere"])
@pytest.mark.parametrize("variant", sorted(MUSCL_KW))
def test_muscl(parts, which, variant):
    jp, tp, c = parts[which]
    u, U, rng = _fields(c, 6)
    D = (10.0 ** rng.uniform(-7, 0, u.shape)).astype(np.float32)
    for v in (u, U):
        for d in range(jp.nd):
            F = int(jp.face_owner[d].shape[0])
            ls = rng.uniform(0, 1, F).astype(np.float32)
            kw = dict(MUSCL_KW[variant])
            kj, kt = dict(kw), dict(kw)
            if kw.get("D"):
                kj["D"], kt["D"] = jnp.asarray(D), torch.tensor(D)
            if kw.get("lim_scale"):
                kj["lim_scale"], kt["lim_scale"] = (jnp.asarray(ls),
                                                    torch.tensor(ls))
            du_j = jo.cell_gradient(jp, jnp.asarray(v), d)
            du_t = to.cell_gradient(tp, torch.tensor(v), d)
            Lj, Rj = jo.muscl(jp, jnp.asarray(v), du_j, d, **kj)
            Lt, Rt = to.muscl(tp, torch.tensor(v), du_t, d, **kt)
            assert rel_err(Lj, Lt.numpy()) < TOL, (variant, d)
            assert rel_err(Rj, Rt.numpy()) < TOL, (variant, d)
