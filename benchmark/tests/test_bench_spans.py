"""The readers of the program's own records (`spans.py` and the span
metrics in `metrics/`) on synthetic records whose answers are worked out
by hand, each finding nothing in a run without records, and the traced
stretch on the program at a small size on the CPU."""

import pytest

import harness
import spans

US = 1000      # ns


def _span(i, name, a, b, parent=None):
    return {"id": i, "parent": parent, "name": name, "t0_ns": a * US,
            "t1_ns": b * US}


def _march():
    """Two steps of 100 us: a RHS (55 us, 10 of them 2:1), a ghost BC
    (10) and an update (20) each, the state's copies before and after."""
    dev, i = [_span(1, "march.boundary", -20, -5)], 2
    for t in (0, 110):
        step = _span(i, "march.step", t, t + 100)
        rhs = _span(i + 1, "march.rhs", t + 5, t + 60, i)
        dev += [step, rhs,
                _span(i + 2, "march.two_to_one", t + 20, t + 30, i + 1),
                _span(i + 3, "march.ghost_bc", t + 60, t + 70, i),
                _span(i + 4, "march.update", t + 70, t + 90, i)]
        i += 5
    dev.append(_span(i, "march.boundary", 215, 230))
    return {"host": [], "device": dev, "counters": {"graph.replays": 2},
            "calibration": {"cuda:0": {"offset_ns": 0,
                                       "uncertainty_ns": 3000}}}


def _fas():
    """Two calls of a two-level cycle 100 us apart: each L0 head (10 us),
    L1 head (5), two L1 bodies (5 each) after host reads, the L0 tail (4)
    and one L0 body (15) after a read."""
    dev, host, i = [], [], 1
    for t in (0, 100):
        for name, a, b in (("fas.L0.head", 0, 10), ("fas.L1.head", 10, 15),
                           ("fas.L1.body", 20, 25), ("fas.L1.body", 30, 35),
                           ("fas.L0.tail", 36, 40), ("fas.L0.body", 45, 60)):
            dev.append(_span(i, name, t + a, t + b))
            i += 1
        for a, b in ((14, 19), (24, 29), (41, 44)):
            host.append(_span(i, "fas.stop_read", t + a, t + b))
            i += 1
    return {"host": host, "device": dev, "counters": {"fas.stop_reads": 6},
            "calibration": {}}


def _build(levels):
    s = 1e6   # us in a second
    host = [_span(1, "build.mesh", 0, 1 * s),
            _span(2, "build.domain", 1 * s, 3 * s),
            _span(3, "cells", 1 * s, 1.5 * s, 2),
            _span(4, "build.blocks", 3 * s, 6 * s)]
    if levels:
        host.append(_span(5, "build.levels", 6 * s, 6.5 * s))
    return {"host": host, "device": [], "counters": {}, "calibration": {}}


def read(name, rec):
    return harness.module("metrics", name).read({"spans": rec})


MARCH = {"rhs_ms_per_step": 0.045, "two_to_one_ms_per_step": 0.010,
         "ghost_bc_ms_per_step": 0.010, "update_ms_per_step": 0.020,
         "card_idle_pct": 8.0}
FAS = {"smooth_ms_per_call": 0.025, "transfer_ms_per_call": 0.019,
       "stop_read_idle_ms_per_call": 0.015, "call_idle_pct": 45.0}
BUILD = {"build_mesh_s": 1.0, "build_domain_s": 2.0, "build_blocks_s": 3.0}


@pytest.mark.parametrize("name", sorted(MARCH))
def test_march_readers(name):
    assert read(name, _march()) == pytest.approx(MARCH[name])


@pytest.mark.parametrize("name", sorted(FAS))
def test_fas_readers(name):
    assert read(name, _fas()) == pytest.approx(FAS[name])


@pytest.mark.parametrize("name", sorted(BUILD))
def test_build_readers(name):
    assert read(name, _build(False)) == pytest.approx(BUILD[name])
    want = BUILD[name] + (0.5 if name == "build_blocks_s" else 0.0)
    assert read(name, _build(True)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(MARCH) + sorted(FAS) + sorted(BUILD))
def test_readers_find_nothing_without_records(name):
    """A run of a program without spans hands no records: None, no
    raise; nor do the other kind of cell's records count."""
    m = harness.module("metrics", name)
    assert m.read({}) is None
    assert m.read({"spans": {"host": [], "device": [], "counters": {},
                             "calibration": {}}}) is None
    other = _fas() if name in MARCH else _march()
    if name not in BUILD:
        assert m.read({"spans": other}) is None


def test_split_adds_up_to_the_step():
    """The four march parts cover the synthetic step but for its 15 us
    outside every child span: the self time and the children, once."""
    rec = _march()
    parts = sum(read(n, rec) for n in MARCH if n != "card_idle_pct")
    step = spans.per_unit_ms(rec, spans.named(rec["device"], spans.STEP),
                             spans.STEP)
    assert step == pytest.approx(0.100) and parts == pytest.approx(0.085)


def test_stretch_records_the_program_on_the_cpu():
    """One unit to capture, the records cleared, ``n`` units recorded: a
    small eager march on the CPU gives n steps' spans."""
    import torch
    from ibx_torch.cases import build_rae2822
    case = build_rae2822(wall_h=8e-2, feature_h=4e-2, cfl=0.7,
                         device="cpu")
    calls = []

    def unit(k):
        calls.append(k)
        case.march(case.P0, k)

    rec = spans.stretch(unit, 2, torch.device("cpu"))
    assert calls == [1, 2]
    assert spans.units(rec, spans.STEP) == 2
    for name in ("rhs_ms_per_step", "two_to_one_ms_per_step",
                 "ghost_bc_ms_per_step", "update_ms_per_step",
                 "card_idle_pct"):
        assert read(name, rec) is not None
    assert read("smooth_ms_per_call", rec) is None


@pytest.mark.parametrize("workload", ["rae2822-flagship.march",
                                      "rae2822-flagship.fas"])
def test_trace_spans_reads_a_small_cell_on_the_cpu(small_root, capsys,
                                                   workload):
    """`trace_spans.py` on a small cell: every span reader of the cell's
    runner and the build reads something, and the program's builders are
    left as they were."""
    import json

    import torch
    import ibx_torch.cases as cases
    import ibx_torch.solve as solve
    import trace_spans
    plain = cases.build_rae2822, solve.FasEuler
    code = trace_spans.main(["--workload", workload, "--seed",
                             str(2 ** 31 + 7), "--seconds", "0.01",
                             "--cost-units", "1"],
                            root=small_root, device=torch.device("cpu"))
    assert code == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    runner = "march" if workload.endswith(".march") else "fas_cycle"
    for name in trace_spans.SPAN_METRICS[runner] + trace_spans.BUILD_METRICS:
        assert out["spans"][name] is not None, name
    assert (cases.build_rae2822, solve.FasEuler) == plain
