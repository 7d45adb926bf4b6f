"""The RANS block march (`ibx_torch.cases.build_rae2822_rans`, device
"cpu") against the benchmark's plain reference (`benchmark/reference/
rans.py`, loaded from its files, in float64) on the RANS airfoil at
wall_h=8e-2, feature_h=4e-2, block_size=8 (16,768 cells), from the seeded
start of the cell ``rae2822-rans.march``: the freestream with relative
noise 1e-3 on p, T, u and Rt.

One 10-step chunk lies within the cell's limits on the flow and on Rt,
and the reference in bfloat16 in the program's place does not. One RHS
evaluation is held tighter, a channel at a time."""

import importlib
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from ibx_torch.cases import build_rae2822_rans
from ibx_torch.convert import tables_from_numpy
from ibx_torch.ops.block_ops import to_blocks, to_flat
from ibx_torch.solve.rans import rans_rhs_grid
from ibx_torch.topology.blocked_bc import _collect_families
from ibx_torch.topology.blocks import build_block_tables

torch.set_num_threads(2)
BENCH = pathlib.Path(__file__).resolve().parents[1] / "benchmark"
SMALL = dict(wall_h=8e-2, feature_h=4e-2, block_size=8)
CELL = "rae2822-rans.march"
CHUNK = 10
SEED = 2 ** 31 + 20
# one RHS evaluation from the same float32 state: the reference itself
# run in float32 lies 4e-5 to 5e-5 of a channel's largest value from its
# float64 run there (rounding in the HLL and sensor differences of the
# noisy state), the program as far; nothing is marched, so nothing
# amplifies it
RHS_TOL = 3e-4


def _load(name: str, path: pathlib.Path, package: bool = False):
    """A module of the benchmark from its file, under a private name."""
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=[str(path.parent)]
        if package else None)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """(harness, the reference's rans / tables / rae2822 modules, the
    cell's configuration, traffic and limits, a cache folder)."""
    harness = _load("_bench_harness_rans", BENCH / "harness.py")
    _load("_bench_reference", BENCH / "reference" / "__init__.py",
          package=True)
    mods = [importlib.import_module("_bench_reference." + m)
            for m in ("rans", "tables", "cases.rae2822")]
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    wl = next(w for w in spec["workloads"] if w["name"] == CELL)
    cfg = json.loads((BENCH.parent / next(
        c["file"] for c in spec["configs"]
        if c["name"] == wl["config"])).read_text())
    cfg["build"].update(SMALL)
    traffic = json.loads((BENCH / "traffic" / (wl["traffic"] + ".json"))
                         .read_text())
    limits = json.loads((BENCH / "limits" / (CELL + ".json")).read_text())
    return harness, mods, cfg, traffic, limits, tmp_path_factory.mktemp(
        "reference")


@pytest.fixture(scope="module")
def setup(bench):
    """The program's case, the reference's domain and freestream, and the
    seeded start (P, Rt)."""
    harness, (rans, tables, rc), cfg, traffic, _, cache = bench
    case = build_rae2822_rans(device="cpu", **cfg["build"])
    flow = dict(cfg, **cfg["build"])
    dom = tables.domains(flow, rc, 1, str(cache))[0]
    assert dom.ncells == case.dom.ncells == 16768
    P_inf = rc.freestream(flow)
    amp = float(traffic["amplitude"])
    P = harness.start_state(P_inf, dom.ncells, SEED, amp,
                            torch.device("cpu"))
    g = torch.Generator().manual_seed(SEED + 1)
    Rt_inf = rans.freestream_rt(P_inf, cfg["build"]["reynolds"])
    assert Rt_inf == pytest.approx(case.Rt_inf, rel=1e-6)
    Rt = Rt_inf * (1.0 + amp * torch.randn(dom.ncells, generator=g))
    return case, dom, P_inf, P, Rt


def _reference(bench, setup, dtype):
    rans, cfg = bench[1][0], bench[2]
    _, dom, P_inf, _, _ = setup
    return rans.Rans(dom, P_inf, reynolds=cfg["build"]["reynolds"],
                     dtype=dtype, device="cpu", cfl=cfg["build"]["cfl"])


@pytest.fixture(scope="module")
def chunk(bench, setup):
    """(start, the program's chunk, the float64 reference's), fused."""
    case, _, _, P, Rt = setup
    ref = _reference(bench, setup, torch.float64)
    S0 = ref.state(P, Rt)
    P1, Rt1 = case.march(P, Rt, CHUNK)
    return S0, torch.cat([P1, Rt1[:, None]], 1), ref.march(S0, CHUNK)


def _gaps(harness, S0, S, R):
    """(flow gap, Rt gap) as the cell reads them."""
    return (harness.change_gap(S0[:, :-1], S[:, :-1], R[:, :-1]),
            harness.change_gap(S0[:, -1:], S[:, -1:], R[:, -1:]))


def test_a_chunk_lies_within_the_cells_limits(bench, chunk):
    harness, limits = bench[0], bench[4]
    flow, rt = _gaps(harness, *chunk)
    assert flow <= limits["start_gap"], flow
    assert rt <= limits["start_rt_gap"], rt
    # the chunk moved the state: a state left unchanged reads 1
    assert (chunk[1] - chunk[0]).abs().amax() > 0


def test_the_bfloat16_control_fails_the_limits(bench, setup, chunk):
    harness, limits = bench[0], bench[4]
    S0, _, R = chunk
    ctl = _reference(bench, setup, torch.bfloat16)
    flow, rt = _gaps(harness, S0, ctl.march(ctl.state(setup[3], setup[4]),
                                            CHUNK), R)
    assert flow > limits["start_gap"] or rt > limits["start_rt_gap"], (
        flow, rt)


@pytest.fixture(scope="module")
def rhs(bench, setup):
    """The program's (R_flow, dRt/dt, dt) and the float64 reference's,
    flat, of the seeded start."""
    case, _, _, P, Rt = setup
    names = ["farfield", "wall"]
    bt, _ = tables_from_numpy(build_block_tables(case.dom),
                              _collect_families(case.dom, names), names,
                              torch.device("cpu"))
    R3, T3, dt3 = rans_rhs_grid(bt, case.fluid,
                                to_blocks(bt, torch.cat([P, Rt[:, None]], 1)),
                                cfl=bench[2]["build"]["cfl"])
    prog = torch.cat([to_flat(bt, R3), to_flat(bt, T3[..., None]),
                      to_flat(bt, dt3[..., None])], 1)
    R, T, dt = _reference(bench, setup, torch.float64).rhs(
        torch.cat([P, Rt[:, None]], 1).double())
    # the cells a step moves (dt is 0 inside the body in both)
    act = torch.as_tensor(~setup[1].inside)
    return prog[act].double(), torch.cat([R, T[:, None], dt[:, None]],
                                         1)[act]


@pytest.mark.parametrize("channel", ["rho", "E", "rho_u", "rho_v", "Rt",
                                     "dt"])
def test_one_rhs_matches_the_reference(rhs, channel):
    prog, ref = rhs
    k = ["rho", "E", "rho_u", "rho_v", "Rt", "dt"].index(channel)
    scale = float(ref[:, k].abs().max())
    err = float((prog[:, k] - ref[:, k]).abs().max()) / scale
    assert np.isfinite(err) and err <= RHS_TOL, err
