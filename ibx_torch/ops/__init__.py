"""Device operators: the padded gather-reduce `stencil` and the
finite-volume `operators` of the generic gather path, the dense block
operators (`block_ops`), the CUDA kernels (`kernels`) and the channel-split
RHS and RK2 step around them (`rhs_cs`)."""

from .stencil import (
    Stencil,
    apply_stencil,
    reindex_stencil,
    stencil_domain,
    stencil_from_lists,
    stencil_from_padded,
)

__all__ = [
    "Stencil",
    "apply_stencil",
    "reindex_stencil",
    "stencil_domain",
    "stencil_from_lists",
    "stencil_from_padded",
]
