"""Checkpoint/restore for long-running marches (host side; counterpart of
`ibx/io/checkpoint.py`, the same file format).

The reference has no checkpointing (``Serialization`` is declared but unused,
reference ``Project.toml:13``); long marches can only be restarted from
scratch. Here solver state (any flat dict of tensors, arrays and scalars)
round-trips through compressed ``.npz`` files with atomic replace, so a
pseudo-time march or URANS run can resume mid-flight. Tensors are written
as numpy arrays (copied to the host), so a file written by either package
loads in the other; `load_checkpoint` returns numpy arrays.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict

import numpy as np
import torch


def _host(v):
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, state: Dict, *, step: int = 0,
                    meta: Dict = None) -> None:
    """Atomically write ``state`` (dict of tensors/arrays/scalars) to
    ``path``."""
    arrays = {k: _host(v) for k, v in state.items()}
    arrays["__step__"] = np.asarray(step, dtype=np.int64)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str):
    """Returns (state dict of numpy arrays, step, meta dict)."""
    with np.load(path) as data:
        state = {k: data[k] for k in data.files
                 if not k.startswith("__")}
        step = int(data["__step__"])
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    return state, step, meta
