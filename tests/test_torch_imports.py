"""Package rules of the port: no JAX or `ibx` import anywhere in
`ibx_torch` or `chip_smoke.py`; the ops layer's imports point one way;
every name a subpackage of `ibx` exports is exported by the port's, or is
listed as not ported yet with its ROADMAP item; entry points default to
the card and refuse to run without one; CPU tensors never count as kernel
launches."""

import importlib

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from ibx_torch.cases import (build_flat_plate, build_rae2822,
                             build_rae2822_rans, build_sphere3d)
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
    """The import scan reaches the modules of the 2D arm and of the gather
    path, and none of them names a file under the JAX package."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    want = {"ibx_torch/cases/rae2822.py", "ibx_torch/cases/__init__.py",
            "ibx_torch/geometry/stereolitography.py",
            "ibx_torch/geometry/__init__.py",
            "ibx_torch/topology/domain.py", "ibx_torch/topology/blocks.py",
            "ibx_torch/ops/block_ops.py", "ibx_torch/physics/flux.py",
            "ibx_torch/ops/stencil.py", "ibx_torch/ops/operators.py",
            "ibx_torch/solve/euler.py", "ibx_torch/solve/__init__.py",
            "ibx_torch/convert.py", "chip_smoke.py"}
    # the RANS slice
    want |= {"ibx_torch/physics/turbulence.py", "ibx_torch/physics/ibl.py",
             "ibx_torch/physics/__init__.py", "ibx_torch/solve/rans.py",
             "ibx_torch/cases/rae2822_rans.py",
             "ibx_torch/cases/flat_plate.py",
             "ibx_torch/topology/__init__.py"}
    # solver acceleration, checkpoints and the monitor
    want |= {f"ibx_torch/solve/{m}.py" for m in (
        "interp_util", "mgrid", "multigrid_domain", "fas", "fas_euler",
        "point_implicit", "point_implicit_euler")}
    want |= {"ibx_torch/io/__init__.py", "ibx_torch/io/checkpoint.py",
             "ibx_torch/utils/__init__.py", "ibx_torch/utils/monitor.py"}
    # the multi-device runtime
    want |= {f"ibx_torch/parallel/{m}.py" for m in (
        "__init__", "sharding", "block_sharding", "launch", "dryrun")}
    want |= {f"ibx_torch/cases/{m}.py" for m in (
        "rae2822_sharded", "rae2822_block_sharded",
        "sphere3d_block_sharded")}
    # the wing, the cut-cell wall, VTK export and the pytree containers
    want |= {"ibx_torch/cases/wing3d_rans_fas.py",
             "ibx_torch/geometry/cutcell.py", "ibx_torch/io/vtk.py",
             "ibx_torch/utils/pytree.py"}
    # the scheme's torch-op face arithmetic
    want |= {"ibx_torch/ops/scheme.py"}
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


def _port_imports(path):
    """``(module, in_function)`` for each `ibx_torch` module the file
    imports, at every depth: a ``from`` import of a submodule names the
    submodule, of anything else the module it comes from."""
    pkg = path.relative_to(ROOT).parts[:-1]
    out = []

    def visit(node, in_function):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            in_function = True
        if isinstance(node, ast.Import):
            out.extend((a.name, in_function) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg[:len(pkg) - node.level + 1]
                base = ".".join(parts + ((base,) if base else ()))
            for a in node.names:
                sub = f"{base}.{a.name}"
                f = ROOT / sub.replace(".", "/")
                is_mod = f.with_suffix(".py").exists() or f.is_dir()
                out.append((sub if is_mod else base, in_function))
        for child in ast.iter_child_nodes(node):
            visit(child, in_function)

    visit(ast.parse(path.read_text(), filename=str(path)), False)
    return [(m, inner) for m, inner in out
            if m.split(".")[0] == "ibx_torch"]


def _within(module, prefixes):
    """Whether ``module`` is, or lies inside, an `ibx_torch` module that
    ``prefixes`` names ("" names the package)."""
    tops = ["ibx_torch." + p if p else "ibx_torch" for p in prefixes]
    return any(module == t or module.startswith(t + ".") for t in tops)


# the one-way ops layer: physics, geometry, ops.stencil, ops.operators <-
# ops.scheme <- ops.kernels <- utils <- topology <- ops.rhs_cs <-
# ops.block_ops <- convert <- solve, parallel <- cases ("X <- Y": Y may
# import X). A case: the files, the modules they must not import, the
# exceptions, and whether only imports inside a function count.
LAYERS = {
    "kernels_import_no_rhs": (("ops/kernels.py",),
                              ("ops.block_ops", "ops.rhs_cs"), (), False),
    "scheme_imports_no_kernel_or_rhs": (
        ("ops/scheme.py",), ("ops.kernels", "ops.rhs_cs", "ops.block_ops"),
        (), False),
    "rhs_cs_imports_no_block_ops": (("ops/rhs_cs.py",), ("ops.block_ops",),
                                    (), False),
    "utils_import_only_the_kernels_of_ops": (
        ("utils/*.py",), ("ops", "solve", "parallel", "cases"),
        ("ops.kernels",), False),
    "topology_imports_no_capture_or_solver": (
        ("topology/*.py",), ("utils.graphs", "solve", "parallel", "cases"),
        (), False),
    "no_port_import_inside_a_function": (
        ("ops/*.py", "utils/*.py", "topology/*.py"), ("",), (), True),
}


@pytest.mark.parametrize("rule", list(LAYERS))
def test_ops_layer_imports_point_one_way(rule):
    """Each rule of the layering, over every import of its files, those
    inside functions included (a function-level import hides a cycle, it
    does not remove it)."""
    globs, banned, allowed, inner_only = LAYERS[rule]
    files = sorted({f for g in globs for f in (ROOT / "ibx_torch").glob(g)})
    assert files, globs
    bad = [f"{f.relative_to(ROOT)}: {m}" for f in files
           for m, in_function in _port_imports(f)
           if (in_function or not inner_only) and _within(m, banned)
           and not _within(m, allowed)]
    assert not bad, bad


# names of `ibx.<pkg>.__all__` the port does not have yet, each with the
# ROADMAP item that ports it
NOT_PORTED = {}


@pytest.mark.parametrize("pkg", ["physics", "topology", "solve", "cases",
                                 "ops", "geometry", "io", "utils",
                                 "parallel"])
def test_subpackage_exports_match_ibx(pkg):
    """Every name of ``ibx.<pkg>.__all__`` exists in ``ibx_torch.<pkg>``
    (and in its ``__all__``), or is on the not-ported list; a listed name
    must really be missing, so the list shrinks as items land."""
    ref = importlib.import_module(f"ibx.{pkg}")
    port = importlib.import_module(f"ibx_torch.{pkg}")
    todo = NOT_PORTED.get(pkg, {})
    for name in ref.__all__:
        if name in todo:
            assert not hasattr(port, name), f"{name} is ported: unlist it"
            assert "ROADMAP queue" in todo[name]
            continue
        assert hasattr(port, name), f"ibx_torch.{pkg} lacks {name}"
        assert name in port.__all__, name
    assert set(todo) <= set(ref.__all__)


def test_build_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sphere3d(wall_h=0.25, block_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_rae2822(wall_h=8e-2, feature_h=4e-2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_sphere3d(wall_h=0.25, block_size=4, use_blocks=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_rae2822(wall_h=8e-2, feature_h=4e-2, use_blocks=False)
    for kw in ({}, dict(use_blocks=False)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_rae2822_rans(wall_h=8e-2, feature_h=4e-2, **kw)
        with pytest.raises(RuntimeError, match="CUDA"):
            build_flat_plate(wall_h=2e-2, **kw)


def test_sharded_builders_without_device_need_cuda(monkeypatch):
    """The sharded builders (the wing's too) run on the card unless asked
    otherwise: without one they raise before they look for a process
    group."""
    from ibx_torch.cases import (build_rae2822_block_sharded,
                                 build_rae2822_sharded,
                                 build_sphere3d_block_sharded,
                                 build_wing3d_rans_fas)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (build_rae2822_sharded, build_rae2822_block_sharded,
                  build_sphere3d_block_sharded, build_wing3d_rans_fas):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(4)


def test_domain_without_device_needs_cuda(monkeypatch):
    """`Domain` is an entry point of the operator API: it places its tables
    on the card unless asked otherwise, and says so when there is none."""
    from ibx_torch.geometry import Mesh
    from ibx_torch.topology.domain import Domain

    msh = Mesh(origin=np.zeros(2, np.float32), widths=np.ones(2, np.float32),
               block_size=4, block_origins=np.zeros((1, 2), np.float32),
               block_widths=np.ones((1, 2), np.float32), distance_fields={})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Domain(msh)
    dom = Domain(msh, device="cpu")
    assert dom.device.type == "cpu" and len(dom) == 16


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
    P3 = P[:, :4].reshape(B, bs, bs, bs, 4)[:, 0].contiguous()
    rows2 = torch.arange(B * 4, dtype=torch.int32).view(B, 4)
    du_x, du_y, nu, _ = K.euler_pass_a_2d(fl, P3, meta, nbr, rows2,
                                          torch.ones((B * 4, bs, 7)),
                                          with_dt=True, cfl=0.5)
    K.euler_pass_b_2d(fl, P3, du_x, du_y, nu, meta, nbr, rows2,
                      torch.ones((B * 4, bs, 4)), high_order=True)
    h = torch.full((B, 2), 0.1)
    ifc = torch.tensor([[0, 0, 1, 0, 1, 0], [1, 0, 0, 1, 0, 2]],
                       dtype=torch.int32)
    K.interface_a_2d(fl, P3, h, ifc, with_dt=True)
    K.interface_b_2d(fl, P3, du_x, du_y, nu, h, ifc, high_order=True)
    assert K.launches == {"rk2_update": 0, "euler_pass_a": 0,
                          "euler_pass_b": 0, "euler_pass_b_fold": 0,
                          "euler_pass_a_2d": 0, "euler_pass_b_2d": 0,
                          "interface_a_2d": 0, "interface_b_2d": 0}
