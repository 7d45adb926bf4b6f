"""ibx_torch: the PyTorch + CUDA port of ibx (immersed-boundary flow
solver) for one NVIDIA H100.

The JAX package `ibx` is the reference; this package never imports it (or
JAX). Host preprocessing is the package's own numpy copy; the device side
is PyTorch, and the three Pallas TPU kernels of `ibx/ops/pallas_rhs.py`
are hand-written CUDA kernels under `csrc/` (see `ibx_torch.ops.kernels`).
Two cases are ported: the 3D STL sphere (`cases.build_sphere3d`, its block
marches through the kernels) and the 2D RAE2822 airfoil
(`cases.build_rae2822`, on torch ops: neither package has a kernel at
nd = 2). Each also marches on the generic gather path
(``use_blocks=False``): `ops.stencil`, `ops.operators`, the partitions and
ghost-BC executor of `topology.domain.Domain`, and `solve.euler`, the
framework's public operator API, all torch ops. Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
