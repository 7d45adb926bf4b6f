"""Small pytree-dataclass helper (counterpart of `ibx/utils/pytree.py`).

Host-side "compiler" objects (meshes, builders) are plain Python; a
device-side container can be a frozen dataclass registered as a pytree of
``torch.utils._pytree``, so that `tree_map` (a ``.to(device)``, a cast,
a `torch.func` transform) reaches its tensors. Static (shape-determining)
fields go in ``meta_fields``: they ride in the tree spec, untouched.
"""

from __future__ import annotations

import dataclasses

import torch.utils._pytree as pytree


def pytree_dataclass(cls=None, *, meta_fields=()):
    """Decorator: frozen dataclass registered as a torch pytree.

    ``meta_fields`` are static auxiliary data (part of the tree spec);
    every other field is a leaf."""

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        names = [f.name for f in dataclasses.fields(c)]
        data = tuple(n for n in names if n not in meta_fields)
        meta = tuple(n for n in names if n in meta_fields)

        def flatten(obj):
            return ([getattr(obj, n) for n in data],
                    tuple(getattr(obj, n) for n in meta))

        def unflatten(values, context):
            return c(**dict(zip(data, values)), **dict(zip(meta, context)))

        pytree.register_pytree_node(
            c, flatten, unflatten,
            serialized_type_name=f"{c.__module__}.{c.__qualname__}")
        return c

    return wrap(cls) if cls is not None else wrap
