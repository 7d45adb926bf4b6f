"""Package rules of the port: no JAX or `ibx` import anywhere in
`ibx_torch` or `chip_smoke.py`; entry points default to the card and
refuse to run without one; CPU tensors never count as kernel launches."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from ibx_torch.cases import build_rae2822, build_sphere3d
from ibx_torch.ops import kernels as K
from ibx_torch.physics.fluid import make_fluid

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "ibx")


def _port_files():
    files = sorted((ROOT / "ibx_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_no_jax_or_ibx_imports():
    bad = []
    for f in _port_files():
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                if n.split(".")[0] in BANNED:
                    bad.append(f"{f.relative_to(ROOT)}:{node.lineno} {n}")
    assert len(_port_files()) > 20
    assert not bad, bad


def test_scan_covers_the_2d_modules():
    """The import scan reaches the modules of the 2D arm, and none of them
    names a file under the JAX package."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    want = {"ibx_torch/cases/rae2822.py", "ibx_torch/cases/__init__.py",
            "ibx_torch/geometry/stereolitography.py",
            "ibx_torch/geometry/__init__.py",
            "ibx_torch/topology/domain.py", "ibx_torch/topology/blocks.py",
            "ibx_torch/ops/block_ops.py", "ibx_torch/physics/flux.py",
            "ibx_torch/convert.py", "chip_smoke.py"}
    assert want <= names, want - names
    for f in _port_files():
        tree = ast.parse(f.read_text(), filename=str(f))
        paths = [n.value for n in ast.walk(tree)
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)
                 and "\n" not in n.value and " " not in n.value
                 and ":" not in n.value      # file:line labels are no paths
                 and n.value.startswith("ibx/")]
        assert not paths, (f, paths)
    from ibx_torch.cases.rae2822 import RAE_DAT
    assert (ROOT / "ibx_torch") in Path(RAE_DAT).resolve().parents


def test_build_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sphere3d(wall_h=0.25, block_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_rae2822(wall_h=8e-2, feature_h=4e-2)


def test_cpu_tensors_launch_nothing():
    K.reset_launches()
    rng = np.random.default_rng(0)
    B, bs = 3, 4
    g5 = (B, 5, bs, bs * bs)
    P = torch.tensor(np.abs(rng.normal(300.0, 10.0, g5)).astype(np.float32))
    R = torch.tensor(rng.normal(size=g5).astype(np.float32))
    one = torch.ones((B, 1, bs, bs * bs))
    meta = torch.zeros((B, 16))
    meta[:, :3] = 0.1
    meta[:, 3:15] = 1.0                   # every side a one-sided boundary
    nbr = torch.arange(B, dtype=torch.int32)[:, None].repeat(1, 8)
    fl = make_fluid()
    K.rk2_update(fl, P, R, R, one * 1e4, one, 0.5)
    du, _ = K.euler_pass_a(fl, P, meta, nbr, with_dt=True)
    K.euler_pass_b(fl, P, du, one * 0.5, meta, nbr, high_order=True)
    rows = torch.arange(B * 6, dtype=torch.int32).view(B, 6)
    vals = torch.ones((B * 6, 5, bs * bs))
    K.euler_pass_b(fl, P, du, one * 0.5, meta, nbr, high_order=True,
                   cols6=(rows, vals))
    assert K.launches == {"rk2_update": 0, "euler_pass_a": 0,
                          "euler_pass_b": 0, "euler_pass_b_fold": 0}
