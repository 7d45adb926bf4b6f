"""Checkpoint and restore of solver state (`checkpoint`). The VTK writers
of the JAX package's `ibx.io` are not ported yet (ROADMAP queue 1 item
10)."""
from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
