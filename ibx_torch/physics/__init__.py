"""Gas model, HLL flux and flow BC in PyTorch (float32)."""
