"""The program's spans and counters (`ibx_torch.utils.monitor`): off by
default and then inert, host spans nested by parent id with self times,
device spans on the CPU's host stamps, the counters of the captured loops
against an eager FAS cycle, the build's spans against
``case.build_seconds``, the clock shared with a `torch.profiler` trace,
the Chrome-trace output, a full ring, and the graphs kept apart while
recording. The card's half (stamps in a captured graph, the calibration)
is `chip_smoke.py`'s trace phase."""

import importlib.util
import json
import pathlib

import pytest
import torch

from ibx_torch.ops import kernels
from ibx_torch.solve.fas import FasCycle
from ibx_torch.utils import graphs, monitor

CPU = torch.device("cpu")


def _self_ns(spans):
    """Each span's self time by id, as the benchmark's readers reckon it
    (``benchmark/spans.py``, loaded from its file)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmark" \
        / "spans.py"
    spec = importlib.util.spec_from_file_location("_bench_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {s["id"]: mod.self_ns(s, spans) for s in spans}


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_keeps_graph_keys(monkeypatch):
    with monitor.tracing():
        with monitor.span("kept"):
            pass
    before = monitor.records()
    assert monitor.span("a") is monitor.device_span("b", CPU)
    with monitor.span("a"), monitor.device_span("b", CPU):
        monitor.count("c")
    assert monitor.records() == before
    assert not monitor.recording()

    # a replay off counts the captured launches and nothing else
    launches = dict(kernels.launches)
    graphs._replayed({"rk2_update": 2, "euler_pass_a": 1})
    assert kernels.launches["rk2_update"] == launches["rk2_update"] + 2
    assert kernels.launches["euler_pass_a"] == launches["euler_pass_a"] + 1
    assert "graph.replays" not in monitor.records()["counters"]
    kernels.launches.update(launches)

    # the steps and loops captured off keep their keys; recording captures
    # its own, beside them
    made = []

    class FakeStep:
        def __init__(self, step, X, pool=None):
            made.append(step)
            self.graph = self

        def pool(self):
            return "pool"

    class FakeLoop:
        def capture(self, pool):
            made.append(pool)

    monkeypatch.setattr(graphs, "GraphedStep", FakeStep)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    g = graphs.Graphs()
    plain = g.get("block", "step", None)
    g.loop("cycle", (10, 1e-6), FakeLoop, True)
    assert set(g.steps) == {"block"} and set(g.loops) == {"cycle"}
    with monitor.tracing():
        traced = g.get("block", "step", None)
        g.loop("cycle", (10, 1e-6), FakeLoop, True)
    assert traced is not plain and g.steps["block"] is plain
    assert set(g.steps) == {"block", ("traced", "block")}
    assert set(g.loops) == {"cycle", ("traced", "cycle")}
    assert g.get("block", "step", None) is plain


def test_spans_nest_with_parent_ids_and_self_time():
    with monitor.tracing():
        with monitor.span("outer"):
            with monitor.span("a"):
                with monitor.span("a.inner"):
                    pass
            with monitor.span("b"):
                pass
        monitor.add_span("late", 1, 2)
    rec = monitor.records()
    sp = {s["name"]: s for s in rec["host"]}
    assert sp["outer"]["parent"] is None
    assert sp["a"]["parent"] == sp["b"]["parent"] == sp["outer"]["id"]
    assert sp["a.inner"]["parent"] == sp["a"]["id"]
    assert sp["late"]["parent"] is None
    for s in rec["host"]:
        assert s["t0_ns"] <= s["t1_ns"]
    own = _self_ns(rec["host"])

    def dur(s):
        return s["t1_ns"] - s["t0_ns"]

    assert own[sp["outer"]["id"]] == dur(sp["outer"]) - dur(sp["a"]) \
        - dur(sp["b"])
    assert own[sp["a"]["id"]] == dur(sp["a"]) - dur(sp["a.inner"])
    assert own[sp["b"]["id"]] == dur(sp["b"])


def test_device_span_on_the_cpu():
    with monitor.tracing():
        with monitor.device_span("d.outer", CPU):
            x = torch.ones(1000) * 2
            with monitor.device_span("d.inner", x):
                x.sum()
        monitor.count("n", 3)
        monitor.count("n")
    rec = monitor.records()
    dev = {s["name"]: s for s in rec["device"]}
    assert set(dev) == {"d.outer", "d.inner"}
    assert dev["d.inner"]["parent"] == dev["d.outer"]["id"]
    assert dev["d.outer"]["t0_ns"] <= dev["d.inner"]["t0_ns"] \
        <= dev["d.inner"]["t1_ns"] <= dev["d.outer"]["t1_ns"]
    assert dev["d.outer"]["device"] == "cpu"
    assert rec["counters"] == {"n": 4} and rec["calibration"] == {}


def test_a_full_ring_counts_dropped_stamps(monkeypatch):
    monkeypatch.setattr(monitor, "RING_SLOTS", 4)
    with monitor.tracing():
        for _ in range(5):
            with monitor.device_span("x", CPU):
                pass
    rec = monitor.records()
    assert len(rec["device"]) == 2
    assert rec["counters"]["trace.dropped"] == 6
    monitor.clear()
    assert monitor.records()["device"] == []


def _toy_cycle(n_iter, rtol):
    """A two-level FAS cycle on a contraction toward 1 (each iteration
    halves the error) over plain callables."""
    def f(level, Q):
        return 0.5 * (1.0 - Q), torch.ones_like(Q)

    Q = torch.zeros(64)
    return FasCycle(f, Q, coarseners=[lambda q: q[::2], lambda q: q[::4]],
                    prolongators=[lambda q: q.repeat_interleave(2),
                                  lambda q: q.repeat_interleave(4)],
                    n_iter=n_iter, rtol=rtol), Q


@pytest.mark.parametrize("n_iter", [3, 50])
def test_counters_match_an_eager_fas_cycle(n_iter):
    cyc, Q = _toy_cycle(n_iter, 1e-3)
    with monitor.tracing():
        cyc(Q)
    rec = monitor.records()
    its = cyc.iterations
    assert len(its) == 2
    c = rec["counters"]
    for k, it in enumerate(its):
        assert c[f"fas.bodies.L{k}"] == it
    # the host reads the predicate before each body and once more where
    # the rule, not n_iter, ends the loop
    reads = sum(it + (it < n_iter) for it in its)
    assert c["fas.stop_reads"] == reads
    host = _by_name(rec["host"])
    assert len(host["fas.stop_read"]) == reads
    dev = _by_name(rec["device"])
    for k, it in enumerate(its):
        assert len(dev[f"fas.L{k}.head"]) == 1
        assert len(dev[f"fas.L{k}.body"]) == it
    assert len(dev["fas.L0.tail"]) == 1 and "fas.L1.tail" not in dev
    assert "graph.replays" not in c     # eager: nothing replayed


@pytest.mark.parametrize("use_blocks", [True, False])
def test_build_spans_sum_to_build_seconds(use_blocks):
    from ibx_torch.cases import build_rae2822
    with monitor.tracing():
        case = build_rae2822(wall_h=8e-2, feature_h=4e-2, cfl=0.7,
                             use_blocks=use_blocks, device="cpu")
    host = _by_name(monitor.records()["host"])
    total = sum(s["t1_ns"] - s["t0_ns"] for k in
                ("build.mesh", "build.domain", "build.blocks")
                for s in host[k]) / 1e9
    assert total == pytest.approx(case.build_seconds, rel=0.05)
    # the domain's stages are the children of build.domain, and its
    # build_timings their durations
    dom = host["build.domain"][0]
    stages = {k: v[0] for k, v in host.items()
              if v[0]["parent"] == dom["id"]}
    assert set(case.dom.build_timings) - {"partitions"} <= set(stages)
    for name, sec in case.dom.build_timings.items():
        s = host[name][0]
        assert (s["t1_ns"] - s["t0_ns"]) / 1e9 == pytest.approx(sec)


def test_march_spans_on_an_eager_step():
    from ibx_torch.cases import build_sphere3d
    case = build_sphere3d(wall_h=0.25, block_size=8, device="cpu")
    with monitor.tracing():
        case.march(case.P0, 1)
    rec = monitor.records()
    dev = _by_name(rec["device"])
    assert len(dev["march.step"]) == 1 and len(dev["march.rhs"]) == 2
    assert len(dev["march.update"]) == 2 and len(dev["march.ghost_bc"]) == 2
    # passes A and B each have their 2:1 glue inside the RHS
    assert len(dev["march.two_to_one"]) == 4
    step = dev["march.step"][0]
    rhs_ids = {s["id"] for s in dev["march.rhs"]}
    assert {s["parent"] for s in dev["march.two_to_one"]} == rhs_ids
    assert {s["parent"] for s in dev["march.rhs"] + dev["march.update"]
            + dev["march.ghost_bc"]} == {step["id"]}
    own = _self_ns(rec["device"])
    parts = sum(own[s["id"]] for s in dev["march.rhs"]) + sum(
        s["t1_ns"] - s["t0_ns"] for k in
        ("march.two_to_one", "march.ghost_bc", "march.update")
        for s in dev[k])
    assert 0.5 * (step["t1_ns"] - step["t0_ns"]) < parts \
        <= step["t1_ns"] - step["t0_ns"]
    # the state's conversions at the march's two ends
    assert len(dev["march.boundary"]) == 2
    assert len(_by_name(rec["host"])["march.boundary"]) == 2


def test_rans_spans_on_an_eager_step():
    """The RANS block march: its build's three spans, and a step's
    closure, wall function and stage updates, one of each a stage."""
    from ibx_torch.cases import build_rae2822_rans
    with monitor.tracing():
        case = build_rae2822_rans(wall_h=8e-2, feature_h=4e-2, block_size=8,
                                  device="cpu")
    host = _by_name(monitor.records()["host"])
    total = sum(s["t1_ns"] - s["t0_ns"] for k in
                ("build.mesh", "build.domain", "build.blocks")
                for s in host[k]) / 1e9
    assert total == pytest.approx(case.build_seconds, rel=0.05)
    with monitor.tracing():
        case.march(case.P0, case.Rt0, 1)
    dev = _by_name(monitor.records()["device"])
    step = dev["march.step"]
    assert len(step) == 1
    for name in ("march.rhs", "march.turbulence", "march.ghost_bc",
                 "march.wall_function", "march.update"):
        assert len(dev[name]) == 2, name
    ids = {k: {s["id"] for s in dev[k]} for k in dev}
    assert {s["parent"] for s in dev["march.wall_function"]} == \
        ids["march.ghost_bc"]
    assert {s["parent"] for s in dev["march.turbulence"]
            + dev["march.rhs"] + dev["march.update"]} == ids["march.step"]
    # the closure's cell gradients and transport faces carry their 2:1
    # glue inside it
    assert {s["parent"] for s in dev["march.two_to_one"]} == \
        ids["march.rhs"] | ids["march.turbulence"]


def test_halo_span_on_a_one_rank_sharded_step():
    """`sharded_step` exchanges before each RHS and each ghost BC, at one
    rank too: four ``march.halo`` spans a step."""
    from ibx_torch.cases import build_rae2822_block_sharded
    from ibx_torch.parallel import one_rank_group
    with one_rank_group("gloo"):
        sbd, _, P, _ = build_rae2822_block_sharded(
            1, wall_h=8e-2, feature_h=4e-2, cfl=0.5, device="cpu")
        with monitor.tracing():
            sbd.march(P, 1)
        dev = _by_name(monitor.records()["device"])
    assert len(dev["march.step"]) == 1 and len(dev["march.halo"]) == 4
    step = dev["march.step"][0]
    for s in dev["march.halo"]:
        assert s["parent"] == step["id"]
        assert step["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= step["t1_ns"]


def test_spans_share_the_profilers_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(200, 200)
    with monitor.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with monitor.span("probe"):
                x @ x
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    trace = json.load(open(path))
    base = int(trace["baseTimeNanoseconds"])
    ev = trace["traceEvents"]
    mm = [e for e in ev if e.get("name") == "aten::mm"]
    assert len(mm) == 1
    probe = [s for s in monitor.records()["host"] if s["name"] == "probe"][0]
    a = base + float(mm[0]["ts"]) * 1e3
    b = a + float(mm[0]["dur"]) * 1e3
    assert probe["t0_ns"] - 1e3 <= a <= b <= probe["t1_ns"] + 1e3
    # the span entered the profiler's own trace too
    assert any(e.get("name") == "probe" and e.get("cat") == "user_annotation"
               for e in ev)


def test_write_and_profile_trace_give_one_chrome_trace(tmp_path):
    # outside `tracing()` the profiler's trace is left as it is
    plain = tmp_path / "plain"
    with monitor.profile_trace(str(plain)):
        with monitor.span("outer"):
            (torch.ones(64) * 2).sum()
    ev = json.loads((plain / "trace.json").read_text())["traceEvents"]
    assert not any(e.get("cat") == "ibx_span" for e in ev)

    logdir = tmp_path / "trace"
    with monitor.tracing(), monitor.profile_trace(str(logdir)):
        with monitor.span("outer"):
            with monitor.device_span("inner", CPU):
                (torch.ones(64) * 2).sum()
        monitor.count("calls")
    trace = json.loads((logdir / "trace.json").read_text())
    ev = trace["traceEvents"]
    mine = {e["name"] for e in ev if e.get("cat") == "ibx_span"}
    assert mine == {"outer", "inner"}
    assert any(e.get("name", "").startswith("aten::") for e in ev)
    assert any(e.get("ph") == "C" and e["args"] == {"calls": 1} for e in ev)
    names = {e["args"]["name"] for e in ev
             if e.get("ph") == "M" and e.get("pid") in (1 << 30,
                                                        (1 << 30) + 1)}
    assert names == {"ibx_torch spans (host)", "ibx_torch spans (cpu)"}

    path = tmp_path / "spans.json"
    monitor.write(str(path))
    out = json.loads(path.read_text())
    base = out["baseTimeNanoseconds"]
    rec = monitor.records()
    outer = [e for e in out["traceEvents"] if e.get("name") == "outer"][0]
    host = [s for s in rec["host"] if s["name"] == "outer"][0]
    assert base + outer["ts"] * 1e3 == pytest.approx(host["t0_ns"], abs=1)
    assert outer["dur"] * 1e3 == pytest.approx(
        host["t1_ns"] - host["t0_ns"], abs=1)
