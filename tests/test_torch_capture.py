"""The compiled march (`ibx_torch.utils.graphs`) on the CPU, where no CUDA
graph exists: every march that the cases capture on the card
(`Rae2822Case.march` and `march_robust` on both marches, with the
mirrored and cut-cell walls, the trailing-edge blend, residual smoothing
and the single-stage scheme, the three marches of `Sphere3dCase.march`
with their options, `build_rans_march`'s on both marches for the RANS
airfoil and the flat plate under both closures) refuses ``graph=True`` on
a CPU state, runs the eager loop by default, and passes the capture
guard.

The guard is a `TorchDispatchMode` that fails on the operations a CUDA
graph cannot capture: a tensor made from host data (``aten.lift_fresh``,
an upload inside the step), a host read of a tensor
(``aten._local_scalar_dense``) and the data-dependent shapes of
``aten.nonzero``, ``aten.masked_select`` and ``aten.unique*``. One step of
each march runs under it after one eager step, as `GraphedStep` warms a
step up before it captures it (lazily made tables, such as the sign
vectors of `BlockTables.signs`, are made in that step). The fixtures are
the port tests' small cases: RAE2822 at wall_h=8e-2 (16,768 cells), the
bs=4 sphere at wall_h=0.25 (18,432 cells), the RANS airfoil at
wall_h=8e-2, bs=8 and the plate at wall_h=2e-2 (9,216 cells)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ibx_torch.cases import (build_flat_plate, build_rae2822,
                             build_rae2822_rans, build_sphere3d)
from ibx_torch.cases.sphere3d import gather_case
from ibx_torch.utils.graphs import Graphs, march_loop, use_graph

torch.set_num_threads(2)

RAE = dict(wall_h=8e-2, feature_h=4e-2, cfl=0.7)
RANS = dict(wall_h=8e-2, feature_h=4e-2, block_size=8)
PLATE = dict(wall_h=2e-2, length=1.25, height=0.5, reynolds=6e5)


class CaptureGuard(TorchDispatchMode):
    """Fails on every operation a CUDA graph cannot capture."""

    BANNED = ("lift_fresh", "_local_scalar_dense", "nonzero",
              "masked_select")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.BANNED or name.lstrip("_").startswith("unique"):
            raise AssertionError(f"{func} cannot be captured in a CUDA "
                                 f"graph")
        return func(*args, **(kwargs or {}))


_BUILDS = {
    "rae": lambda: build_rae2822(device="cpu", **RAE),
    "rae_gather": lambda: build_rae2822(device="cpu", use_blocks=False,
                                        **RAE),
}
for _opt, _kw in (("mirror", dict(mirror_wall=True)),
                  ("cutcell", dict(cutcell=True)),
                  ("te_fix", dict(te_fix_radius=0.3)),
                  ("irs", dict(irs_eps=0.5)),
                  ("euler", dict(scheme="euler"))):
    _BUILDS[f"rae_{_opt}"] = lambda kw=_kw: build_rae2822(
        device="cpu", **RAE, **kw)
_BUILDS |= {
    "sphere": lambda: build_sphere3d(wall_h=0.25, block_size=4,
                                     device="cpu"),
    "sphere_gather": lambda: gather_case(_case("sphere")),
    "rans": lambda: build_rae2822_rans(device="cpu", **RANS),
    "rans_gather": lambda: build_rae2822_rans(device="cpu",
                                              use_blocks=False, **RANS),
}
for _blocks in (True, False):
    for _closure in ("wray_agarwal", "mixing_length"):
        _BUILDS[("plate", _blocks, _closure)] = (
            lambda b=_blocks, c=_closure: build_flat_plate(
                use_blocks=b, closure=c, device="cpu", **PLATE))
_CASES = {}


def _case(key):
    if key not in _CASES:
        _CASES[key] = _BUILDS[key]()
    return _CASES[key]


def _euler(key, method="march", **kw):
    """(state, march(state, n, graph=...)) of an Euler case."""
    c = _case(key)
    return c.P0, lambda X, n, **g: getattr(c, method)(X, n, **kw, **g)


def _rans(key):
    c = _case(key)
    return (c.P0, c.Rt0), lambda X, n, **g: c.march(*X, n, **g)


MARCHES = {
    "rae_block": lambda: _euler("rae"),
    "rae_block_robust": lambda: _euler("rae", "march_robust"),
    "rae_gather": lambda: _euler("rae_gather"),
    "rae_block_mirror": lambda: _euler("rae_mirror"),
    "rae_block_cutcell": lambda: _euler("rae_cutcell"),
    "rae_block_te_fix": lambda: _euler("rae_te_fix"),
    "rae_block_irs": lambda: _euler("rae_irs"),
    "rae_block_euler_scheme": lambda: _euler("rae_euler"),
    "sphere_cs": lambda: _euler("sphere"),
    "sphere_cs_fold": lambda: _euler("sphere", fold=True),
    "sphere_grid": lambda: _euler("sphere", grid=True),
    "sphere_grid_fold": lambda: _euler("sphere", grid=True, fold=True),
    "sphere_grid_frozen": lambda: _euler("sphere", grid=True,
                                         freeze_gradients=True),
    "sphere_grid_fold_frozen": lambda: _euler(
        "sphere", grid=True, fold=True, freeze_gradients=True),
    "sphere_gather": lambda: _euler("sphere_gather"),
    "rans_block": lambda: _rans("rans"),
    "rans_gather": lambda: _rans("rans_gather"),
}
for (_b, _c) in [(b, c) for b in (True, False)
                 for c in ("wray_agarwal", "mixing_length")]:
    MARCHES[f"plate_{'block' if _b else 'gather'}_{_c}"] = (
        lambda b=_b, c=_c: _rans(("plate", b, c)))


def _equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_guard_sees_host_data_and_host_reads():
    """The guard fails on an upload of host data and on a host read, the
    two traps a step can hide on the CPU, and lets a step's ordinary
    operations through."""
    x = torch.ones(4)
    with CaptureGuard():
        y = (x * 2 + 1).amax()
        with pytest.raises(AssertionError, match="lift_fresh"):
            torch.as_tensor([1.0, -1.0])
        with pytest.raises(AssertionError, match="_local_scalar_dense"):
            float(y)
        with pytest.raises(AssertionError, match="nonzero"):
            torch.nonzero(x)


@pytest.mark.parametrize("name", list(MARCHES))
def test_march_passes_capture_guard(name):
    """One eager step (the warm-up), then one step of the default march
    under the guard: nothing the card could not capture, and on the CPU
    the default is the eager loop, bit-equal."""
    X, march = MARCHES[name]()
    ref = march(X, 1, graph=False)
    with CaptureGuard():
        out = march(X, 1)
    assert _equal(ref, out)
    flat = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(flat).all()


@pytest.mark.parametrize("name", list(MARCHES))
def test_graph_true_on_cpu_raises(name):
    """``graph=True`` on a CPU state raises: it never runs eager quietly."""
    X, march = MARCHES[name]()
    with pytest.raises(ValueError, match="CUDA state"):
        march(X, 1, graph=True)


def test_march_loop_choices():
    """`use_graph`: None follows the device, False is eager anywhere, True
    needs the card; `march_loop` runs no step for n = 0 and the eager
    loop on the CPU."""
    X = torch.zeros(3)
    assert use_graph(None, X) is False and use_graph(False, X) is False
    with pytest.raises(ValueError):
        use_graph(True, X)
    calls = []

    def step(x):
        calls.append(1)
        return x + 1.0, x.amax()

    g = Graphs()
    assert torch.equal(march_loop(g, "k", step, X, 0), X) and not calls
    np.testing.assert_array_equal(march_loop(g, "k", step, X, 3).numpy(),
                                  3.0)
    assert len(calls) == 3 and not g.steps
