"""Port parity of the padded gather-reduce (`ibx_torch.ops.stencil`)
against `ibx.ops.stencil` on the small tables of tests/test_stencil.py and
on kNN interpolation stencils: compiled tables bit-equal, applied values
1e-6 relative (both gather the ``[M, K, ...]`` block and reduce it with
``sum(axis=1)``).

Also the helpers the other gather-path tests use to hand the JAX package's
tables to the port as numpy arrays (`ibx_torch.convert`)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.ops import stencil as js
from ibx.topology.interp import interpolator as jx_interpolator

from ibx_torch.convert import (boundary_from_numpy, fused_boundary_from_numpy,
                               partition_from_numpy, stencil_from_numpy)
from ibx_torch.ops import stencil as ts
from ibx_torch.topology.interp import interpolator

torch.set_num_threads(2)


# -- the JAX package's tables as numpy (what `ibx_torch.convert` takes) -----

def st_np(st):
    return np.asarray(st.idx), np.asarray(st.w)


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, js.Stencil):
            v = st_np(v)
        elif isinstance(v, tuple) and v and isinstance(v[0], js.Stencil):
            v = [st_np(s) for s in v]
        elif isinstance(v, tuple) and v and not isinstance(v[0], str):
            v = [np.asarray(a) for a in v]
        elif not isinstance(v, (int, tuple)):
            v = np.asarray(v)
        out[f.name] = v
    return out


def port_partition(part):
    return partition_from_numpy(_fields(part), "cpu")


def port_boundary(bdry):
    return boundary_from_numpy(_fields(bdry), "cpu")


def port_fused(fb):
    return fused_boundary_from_numpy(_fields(fb), "cpu")


def assert_stencil_equal(ref, out, path=""):
    """Port table == JAX table, value for value (the port holds int64)."""
    idx, w = st_np(ref)
    assert out.idx.dtype == torch.int64 and out.w.dtype == torch.float32
    assert np.array_equal(out.idx.numpy(), idx), path
    assert np.array_equal(out.w.numpy(), w), path
    assert (out.n_output, out.width) == (ref.n_output, ref.width), path


def assert_tables_equal(ref, out, path=""):
    """Every field of a JAX pytree dataclass against the port's object."""
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(out, f.name)
        p = f"{path}.{f.name}"
        if isinstance(a, js.Stencil):
            assert_stencil_equal(a, b, p)
        elif isinstance(a, tuple) and a and isinstance(a[0], js.Stencil):
            assert len(a) == len(b), p
            for i, (x, y) in enumerate(zip(a, b)):
                assert_stencil_equal(x, y, f"{p}[{i}]")
        elif isinstance(a, tuple) and a and not isinstance(a[0], str):
            assert len(a) == len(b), p
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), y.numpy()), p
        elif isinstance(a, (int, tuple)):
            assert a == b, p
        else:
            a = np.asarray(a)
            assert a.shape == tuple(b.shape), p
            assert np.array_equal(a, b.numpy()), p


def rel_err(ref, out):
    """Max |out - ref| over max |ref| (1 where ref is all zero)."""
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    scale = np.abs(ref).max() if ref.size else 1.0
    return float(np.abs(out - ref).max() / (scale if scale > 0 else 1.0)) \
        if ref.size else 0.0


# -- tests -------------------------------------------------------------------

LISTS = {
    "accumulator": ([[0, 1], [1, 2, 3]], [[-1.0, 2.0], [3.0, 4.0, 5.0]]),
    "variable_and_empty": ([[2], [], [0, 1, 2, 3]],
                           [[2.0], [], [1.0, 1.0, 1.0, 1.0]]),
    "weightless": ([[0, 1], [2]], None),
    "swap": ([[1], [0]], [[1.0], [1.0]]),
}


@pytest.mark.parametrize("name", sorted(LISTS))
def test_from_lists_tables_equal(name):
    """`stencil_from_lists` compiles the same padded tables (bit-equal),
    also with ``n_output`` and ``min_width``."""
    indices, weights = LISTS[name]
    assert_stencil_equal(js.stencil_from_lists(indices, weights),
                         ts.stencil_from_lists(indices, weights))
    kw = dict(n_output=len(indices) + 2, min_width=5)
    assert_stencil_equal(js.stencil_from_lists(indices, weights, **kw),
                         ts.stencil_from_lists(indices, weights, **kw))


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("shape", [(), (3,), (2, 3)])
def test_apply_matches_ibx(op, shape):
    """Random padded table (some rows all padding) on a 1-, 2- and 3-D
    input, each ``op``, with and without ``delta`` and ``f``: 1e-6; rows of
    padding give 0 under sum and -inf / inf under max / min in both."""
    rng = np.random.default_rng(0)
    N, M, K = 50, 40, 5
    idx = rng.integers(0, N, (M, K))
    w = rng.normal(size=(M, K)).astype(np.float32)
    w[rng.uniform(size=(M, K)) < 0.3] = 0.0
    w[3] = 0.0
    v = rng.normal(size=(N,) + shape).astype(np.float32)
    ref_st = js.stencil_from_padded(idx, w)
    out_st = ts.stencil_from_padded(idx, w)
    assert_stencil_equal(ref_st, out_st)
    for delta in (False, True):
        for f_j, f_t in ((None, None), (jnp.abs, torch.abs)):
            ref = np.asarray(js.apply_stencil(ref_st, jnp.asarray(v),
                                              delta=delta, f=f_j, op=op))
            out = out_st(torch.tensor(v), delta=delta, f=f_t, op=op).numpy()
            fin = np.isfinite(ref)
            assert np.array_equal(fin, np.isfinite(out))
            assert np.array_equal(ref[~fin], out[~fin])
            assert rel_err(ref[fin], out[fin]) < 1e-6
    if op != "sum":
        assert np.isinf(out[3]).all()
    with pytest.raises(ValueError):
        out_st(torch.tensor(v), op="prod")


def test_reindex_and_domain_match():
    acc_j = js.stencil_from_lists([[4, 7], [7, 9]],
                                  [[0.5, 0.5], [0.25, 0.75]])
    acc_t = ts.stencil_from_lists([[4, 7], [7, 9]],
                                  [[0.5, 0.5], [0.25, 0.75]])
    dom_j, inv_j = js.stencil_domain(acc_j)
    dom_t, inv_t = ts.stencil_domain(acc_t)
    assert np.array_equal(dom_j, dom_t) and np.array_equal(inv_j, inv_t)
    local = ts.reindex_stencil(acc_t, inv_t)
    assert_stencil_equal(js.reindex_stencil(acc_j, inv_j), local)
    v = np.zeros(10, np.float32)
    v[[4, 7, 9]] = [1.0, 2.0, 3.0]
    assert np.array_equal(acc_t(v).numpy(), local(v[dom_t]).numpy())
    # two stencils' union
    dom2, _ = ts.stencil_domain(acc_t, ts.stencil_from_lists([[1, 4]]))
    assert np.array_equal(dom2, [1, 4, 7, 9])


@pytest.mark.parametrize("nd,linear", [(2, True), (3, True), (2, False)])
def test_interpolation_stencils_match(nd, linear):
    """kNN interpolation tables of both packages are bit-equal, go through
    `stencil_from_numpy` unchanged, and sample a field to 1e-6; the linear
    ones reproduce an affine field (5e-4, as tests/test_stencil.py)."""
    rng = np.random.default_rng(nd)
    X = rng.uniform(size=(600, nd)).astype(np.float32)
    Xq = rng.uniform(0.25, 0.75, size=(40, nd)).astype(np.float32)
    ref_st = jx_interpolator(X, Xq, linear=linear)
    out_st = ts.stencil_from_padded(*interpolator(X, Xq, linear=linear))
    assert_stencil_equal(ref_st, out_st)
    assert_stencil_equal(ref_st, stencil_from_numpy(st_np(ref_st), "cpu"))
    assert_stencil_equal(ref_st, stencil_from_numpy(
        dict(idx=np.asarray(ref_st.idx), w=np.asarray(ref_st.w)), "cpu"))
    coef = np.arange(1, nd + 1, dtype=np.float32)
    f = 2.0 + X @ coef
    u = np.stack([f, rng.normal(size=600).astype(np.float32)], axis=1)
    ref = np.asarray(ref_st(jnp.asarray(u)))
    out = out_st(u).numpy()          # numpy in, tensor out
    assert rel_err(ref, out) < 1e-6
    if linear:
        assert np.abs(out[:, 0] - (2.0 + Xq @ coef)).max() < 5e-4


def test_to_keeps_the_table():
    st = ts.stencil_from_lists([[0, 1], [1]], [[1.0, 2.0], [3.0]])
    moved = st.to("cpu")
    assert moved is not st and moved.idx.device.type == "cpu"
    assert torch.equal(moved.idx, st.idx) and torch.equal(moved.w, st.w)
    assert (moved.n_output, moved.width) == (2, 2)


@pytest.mark.parametrize("shape", [(), (1,), (4,), (5,), (2, 4), (16,)])
def test_take_rows_formulations_agree(shape):
    """`take_rows` is `index_select`; the element-by-element formulation it
    takes on the card for rows a multiple of 16 bytes wide copies the same
    values, for every row shape."""
    rng = np.random.default_rng(3)
    v = torch.tensor(rng.normal(size=(37,) + shape).astype(np.float32))
    idx = torch.tensor(rng.integers(0, 37, 101))
    ref = v.numpy()[idx.numpy()]
    assert np.array_equal(ts.take_rows(v, idx).numpy(), ref)
    if shape:
        assert np.array_equal(ts._take_rows_flat(v, idx).numpy(), ref)
