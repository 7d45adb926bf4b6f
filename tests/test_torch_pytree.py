"""`ibx_torch.utils.pytree_dataclass` (counterpart of
`ibx.utils.pytree_dataclass`): a frozen dataclass whose array fields are
leaves of ``torch.utils._pytree`` and whose ``meta_fields`` ride in the
tree spec."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import jax

from ibx.utils import pytree_dataclass as jx_pytree_dataclass

from ibx_torch.utils import pytree_dataclass


@pytree_dataclass(meta_fields=("n_output", "name"))
class Table:
    idx: torch.Tensor
    w: torch.Tensor
    n_output: int
    name: str


def _table():
    return Table(idx=torch.arange(6).view(3, 2), w=torch.ones(3, 2),
                 n_output=3, name="coarsen")


def test_flatten_unflatten_round_trip():
    """Leaves are the array fields in field order; the meta fields stay in
    the spec, and unflattening gives an equal frozen dataclass."""
    t = _table()
    leaves, spec = pytree.tree_flatten(t)
    assert len(leaves) == 2
    assert leaves[0] is t.idx and leaves[1] is t.w
    back = pytree.tree_unflatten(leaves, spec)
    assert type(back) is Table
    assert (back.n_output, back.name) == (3, "coarsen")
    assert back.idx is t.idx and back.w is t.w
    with pytest.raises(dataclasses.FrozenInstanceError):
        back.n_output = 4


def test_tree_map_keeps_meta_and_spec():
    """`tree_map` reaches the tensors only; tables that differ in a meta
    field have different specs, as under the JAX package's registration."""
    t = _table()
    t2 = pytree.tree_map(lambda x: x * 2, t)
    assert torch.equal(t2.w, 2 * t.w) and torch.equal(t2.idx, 2 * t.idx)
    assert (t2.n_output, t2.name) == (t.n_output, t.name)
    other = dataclasses.replace(t, n_output=4)
    assert pytree.tree_flatten(other)[1] != pytree.tree_flatten(t)[1]
    assert pytree.tree_flatten(t2)[1] == pytree.tree_flatten(t)[1]


def test_same_leaves_and_meta_as_jax():
    """The same class under both decorators: the same leaves in the same
    order, the same meta values, a round trip in each package."""
    @jx_pytree_dataclass(meta_fields=("n_output", "name"))
    class JxTable:
        idx: np.ndarray
        w: np.ndarray
        n_output: int
        name: str

    t = _table()
    jt = JxTable(idx=t.idx.numpy(), w=t.w.numpy(), n_output=3,
                 name="coarsen")
    jl, jspec = jax.tree_util.tree_flatten(jt)
    pl, pspec = pytree.tree_flatten(t)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert np.array_equal(np.asarray(a), b.numpy())
    back = jax.tree_util.tree_unflatten(jspec, jl)
    assert (back.n_output, back.name) == (t.n_output, t.name)
