"""Port parity of the gather path's multi-device runtime
(`ibx_torch.parallel.sharding`) against `ibx.parallel` on the bs=4
advection mesh of tests/test_sharding.py, and of the sharded RAE2822
gather march (`build_rae2822_sharded`) against the JAX package's.

The host tables (ring offsets, per-offset send tables, skirt table) are
compared bit for bit at P = 4 and 8 in this process, with no process
group. The rest runs on 4 gloo ranks on the CPU (`spawn`, once for the
module): rank 0 writes what it collected to a ``.npz`` the tests read,
and every rank writes the calls its halo exchange made."""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from ibx.cases.rae2822_sharded import (
    build_rae2822_sharded as jx_build_rae2822_sharded)
from ibx.geometry import Line, build_mesh, polyline
from ibx.ops import operators as jo
from ibx.parallel import ShardedDomain as JxShardedDomain
from ibx.parallel import make_device_mesh as jx_mesh
from ibx.parallel import sharded_impose_bc as jx_impose_bc
from ibx.topology import Domain as JxDomain

from ibx_torch.parallel import (DeviceMesh, ShardedDomain, make_device_mesh,
                                spawn)
from ibx_torch.topology.domain import Domain

from test_torch_sharded_ranks import (HF, P_RANKS, RAE_SMALL, adv_fields,
                                      adv_mesh, bc_step_fn, residual_fn,
                                      sharding_rank)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What the 4 gloo ranks wrote."""
    d = tmp_path_factory.mktemp("sharding")
    spawn(sharding_rank, P_RANKS, backend="gloo", device="cpu",
          args=(str(d),), threads=1)
    out = dict(np.load(d / "out.npz"))
    calls = [json.loads((d / f"calls{r}.json").read_text())
             for r in range(P_RANKS)]
    return out, calls


@pytest.fixture(scope="module")
def jx_doms():
    msh = adv_mesh(build_mesh, polyline, Line)
    return {P: JxDomain(msh, n_partitions=P, hypercube_families=HF)
            for P in (1, 4, 8)}


@pytest.mark.parametrize("P", [4, 8])
def test_halo_tables_bit_equal(jx_doms, P):
    """Offsets, per-offset send tables and the skirt table equal the JAX
    package's for every rank, built in one process with no process group;
    each rank's device rows are its row (the skirt table trimmed to its
    skirt)."""
    jsd = JxShardedDomain(jx_doms[P], jx_mesh(P))
    dom = Domain(adv_mesh(), n_partitions=P, hypercube_families=HF,
                 device="cpu")
    cpu = torch.device("cpu")
    for p in range(P):
        sd = ShardedDomain(dom, DeviceMesh(p, P, cpu))
        assert sd.offsets == jsd._offsets and 0 not in sd.offsets
        assert len(sd.send_idx_pp) == len(jsd.tables["send_idx_pp"])
        for a, b in zip(jsd.tables["send_idx_pp"], sd.send_idx_pp):
            assert b.dtype == np.int32 and np.array_equal(np.asarray(a), b)
        ref = np.asarray(jsd.tables["skirt_src"])
        assert sd.skirt_src.dtype == np.int32
        assert np.array_equal(ref, sd.skirt_src)
        assert np.array_equal(ref[p, :sd.n_skirt], sd._skirt_src.numpy())
        assert not ref[p, sd.n_skirt:].any()
        for i, s in enumerate(sd._send_idx):
            assert np.array_equal(sd.send_idx_pp[i][p], s.numpy())


def test_sharded_residual_matches(ranks, jx_doms):
    """The residual on 4 ranks: atol 1e-5 against the single-partition
    truth and against `ibx.parallel.ShardedDomain` at P = 4 (as
    tests/test_sharding.py; measured 0 against the truth and 7.6e-6
    against the JAX package's sharded run, which is that far from the
    truth itself)."""
    out, _ = ranks
    dom1, dom4 = jx_doms[1], jx_doms[4]
    u0, _, _ = adv_fields(dom1)
    r1 = np.asarray(residual_fn(jo, jnp.zeros_like)(dom1.partitions[0],
                                                  jnp.asarray(u0)))
    jsd = JxShardedDomain(dom4, jx_mesh(4))
    res = residual_fn(jo, jnp.zeros_like)
    (r4,) = jax.jit(jsd.shard_fn(lambda ctx, u: res(ctx.part, u)))(
        jsd.distribute(u0))
    np.testing.assert_allclose(out["residual"], r1, atol=1e-5)
    np.testing.assert_allclose(out["residual"], jsd.collect(r4), atol=1e-5)


def test_sharded_bc_and_march_matches(ranks, jx_doms):
    """Three BC families with a refresh after each, then u + 0.01 R, 3
    steps on 4 ranks: atol 2e-5 against the single partition's
    `impose_bc` march and against the JAX package's sharded one
    (measured 0 and 1.8e-6)."""
    out, _ = ranks
    dom1, dom4 = jx_doms[1], jx_doms[4]
    _, u1, _ = adv_fields(dom1)
    res1 = residual_fn(jo, jnp.zeros_like)
    u_ref = jnp.asarray(u1)
    for _ in range(3):
        u_ref = dom1.impose_bc("upper", lambda b, i: jnp.ones_like(i), u_ref)
        u_ref = dom1.impose_bc("lower", lambda b, i: jnp.zeros_like(i), u_ref)
        u_ref = dom1.impose_bc("outlet", lambda b, i: i, u_ref)
        u_ref = u_ref + 0.01 * res1(dom1.partitions[0], u_ref)
    jsd = JxShardedDomain(dom4, jx_mesh(4))
    run = jax.jit(jsd.shard_fn(bc_step_fn(jo, jx_impose_bc, jnp.ones_like,
                                        jnp.zeros_like)))
    u = jsd.distribute(u1)
    for _ in range(3):
        (u,) = run(u)
    np.testing.assert_allclose(out["bc3"], np.asarray(u_ref), atol=2e-5)
    np.testing.assert_allclose(out["bc3"], jsd.collect(u), atol=2e-5)


def test_collective_reductions(ranks):
    """The psum of the own cells' volumes is the box's area on every rank
    and cell (rtol 1e-5; measured 0)."""
    out, _ = ranks
    np.testing.assert_allclose(out["volume"], 1.0, rtol=1e-5)


def test_halo_exchange_is_neighbor_p2p(ranks):
    """One halo refresh is one `batch_isend_irecv` of an isend and an
    irecv per active ring offset on every rank, and no all-gather (the
    counterpart of tests/test_sharding.py's jaxpr check); the rows a rank
    receives stay within twice its skirt plus the offsets."""
    _, calls = ranks
    for c in calls:
        assert c["all_gather"] == 0
        assert c["batch_isend_irecv"] == [2 * len(c["offsets"])]
        assert c["offsets"] and 0 not in c["offsets"]
    dom = Domain(adv_mesh(), n_partitions=P_RANKS, hypercube_families=HF,
                 device="cpu")
    sd = ShardedDomain(dom, DeviceMesh(0, P_RANKS, torch.device("cpu")))
    recv_rows = sum(s.shape[1] for s in sd.send_idx_pp)
    assert recv_rows <= 2 * (sd.n_dom - sd.n_own) + len(sd.offsets)


def test_rae2822_sharded_matches(ranks):
    """`build_rae2822_sharded(4)` (wall_h=4e-2: 21,760 cells), 3 steps on
    4 ranks against the JAX package's on its 4-device mesh: per-channel
    scaled error under 1e-5 (measured 3.1e-6)."""
    out, _ = ranks
    sdom, step, P, _ = jx_build_rae2822_sharded(4, **RAE_SMALL)
    for _ in range(3):
        (P,) = step(P)
    ref = sdom.collect(P)
    got = out["rae2822_sharded"]
    assert np.isfinite(got).all()
    err = (np.abs(got - ref) / np.abs(ref).max(axis=0)).max()
    assert err < 1e-5, err


def test_make_device_mesh_needs_a_group():
    """No process group: `make_device_mesh` raises, it never falls back
    to one device; a hand-built mesh serves host tables and refuses
    collectives."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_device_mesh(4)
    mesh = DeviceMesh(0, 2, torch.device("cpu"))
    with pytest.raises(RuntimeError, match="process group"):
        mesh.all_reduce(torch.ones(1), "max")
