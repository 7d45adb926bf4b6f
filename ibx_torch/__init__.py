"""ibx_torch: the PyTorch + CUDA port of ibx (immersed-boundary flow
solver) for one NVIDIA H100.

The JAX package `ibx` is the reference; this package never imports it (or
JAX). Host preprocessing is the package's own numpy copy; the device side
is PyTorch, and the three Pallas TPU kernels of `ibx/ops/pallas_rhs.py`
are hand-written CUDA kernels under `csrc/` (see `ibx_torch.ops.kernels`).
Every module of the JAX package has its counterpart: the cases (the 2D
RAE2822 airfoil, whose block march runs the port's own 2D kernels, passes
A and B and the 2:1 interface faces, the 3D STL sphere whose block
marches run the ported kernels, RANS, the sharded cases and the RANS+FAS
wing, each where the JAX package has it on the dense block path and on
the generic gather path), the operator API (`ops.stencil`,
`ops.operators`, `topology.domain.Domain`, `solve.euler`), solver
acceleration (`solve`), the multi-device runtime on `torch.distributed`
(`parallel`), `io` and `utils`. The marches run captured in CUDA graphs on
the card (`utils.graphs`); ``benchmark/run.py`` at the repo's root
measures them. Entry points run on the card unless the caller passes
``device="cpu"``.

The ops layer imports one way: the scheme's face arithmetic
(`ops.scheme`) lies beneath the kernels (`ops.kernels`), the kernel
routes (`ops.rhs_cs`) and the torch-op body (`ops.block_ops`), in that
order.
"""
