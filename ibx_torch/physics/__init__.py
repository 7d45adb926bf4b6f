"""Gas model, inviscid and viscous fluxes and flow BC in PyTorch (float32)."""
