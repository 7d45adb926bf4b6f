"""ibx_torch: the PyTorch + CUDA port of ibx (immersed-boundary flow
solver) for one NVIDIA H100.

The JAX package `ibx` is the reference; this package never imports it (or
JAX). Host preprocessing is the package's own numpy copy; the device side
is PyTorch, and the three Pallas TPU kernels of `ibx/ops/pallas_rhs.py`
are hand-written CUDA kernels under `csrc/` (see `ibx_torch.ops.kernels`).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
