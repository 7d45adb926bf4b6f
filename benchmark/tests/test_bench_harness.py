"""The harness on the CPU: every cell's set-up, window and comparison at
a small size, a cell, a configuration and a metric found by name from
data alone, and a run without a card that stops."""

import json
import math
import os
import re
import shutil
import time

import pytest

import harness
import run
from small_checkout import ROOT, run_cell

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    SPEC = json.load(_f)
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_small_on_cpu(small_root, capsys, workload):
    code, line = run_cell(small_root, workload, capsys=capsys)
    assert code == 0
    assert line["correct"] is True and line["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(SPEC, "end_to_end",
                                                  workload)}
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_traced_run_reads_its_metrics(small_root, capsys):
    code, line = run_cell(small_root, "rae2822-flagship.fas", trace=1,
                          capsys=capsys)
    assert code == 0 and line["correct"] is True
    # on the CPU only the host's numbers exist: no device metric is read
    assert set(line["metrics"]) == {"host_build_s"}
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_a_config_and_a_metric_are_found_from_data(small_root,
                                                         capsys):
    """A new configuration, traffic mix, cell, limits and per-layer
    metric are added as files and entries only; ``run.py`` finds them."""
    bdir = os.path.join(small_root, "benchmark")
    with open(os.path.join(bdir, "configs", "rae2822-flagship.json")) as f:
        cfg = json.load(f)
    cfg["build"]["mach"] = 0.5
    with open(os.path.join(bdir, "configs", "rae2822-m05.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bdir, "traffic", "march.json")) as f:
        tr = json.load(f)
    tr["chunk_steps"] = 3
    with open(os.path.join(bdir, "traffic", "march3.json"), "w") as f:
        json.dump(tr, f)
    shutil.copy(os.path.join(bdir, "limits", "rae2822-flagship.march.json"),
                os.path.join(bdir, "limits", "rae2822-m05.march3.json"))
    with open(os.path.join(bdir, "metrics", "cells_per_build_s.py"),
              "w") as f:
        f.write("def read(ctx):\n"
                "    return ctx['cfg']['cells'] / ctx['host_build_s']\n")
    sp = json.load(open(os.path.join(small_root, "BENCHMARK.json")))
    sp["configs"].append(dict(sp["configs"][0], name="rae2822-m05",
                              file="benchmark/configs/rae2822-m05.json"))
    sp["workloads"].append(dict(sp["workloads"][0], name="rae2822-m05.march3",
                                config="rae2822-m05", traffic="march3"))
    sp["per_layer"].append({"name": "cells_per_build_s", "unit": "1/s",
                            "better": "higher", "source": "program_span",
                            "layer": "host build", "moves": "setup_s",
                            "workloads": ["rae2822-m05.march3"]})
    json.dump(sp, open(os.path.join(small_root, "BENCHMARK.json"), "w"))
    code, line = run_cell(small_root, "rae2822-m05.march3", trace=1,
                          capsys=capsys)
    assert code == 0 and line["correct"] is True
    assert line["metrics"]["cells_per_build_s"]["value"] > 0


def test_no_card_stops_without_a_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"])
    assert code == 3
    assert capsys.readouterr().out == ""


def test_too_few_cards_stop_without_a_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    code = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"])
    assert code == 3
    assert capsys.readouterr().out == ""


def test_an_unknown_cell_stops(capsys):
    assert run.main(["--workload", "no-such.cell", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_a_checkout_without_the_program_stops(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the program is missing: the run fails and prints no result."""
    import subprocess
    import sys
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_the_same_seed_gives_the_same_start():
    import torch
    big = 2 ** 31 + 977
    a = harness.start_state([101325.0, 288.15, 250.0, 10.0], 1000, big,
                            1e-3, torch.device("cpu"))
    b = harness.start_state([101325.0, 288.15, 250.0, 10.0], 1000, big,
                            1e-3, torch.device("cpu"))
    c = harness.start_state([101325.0, 288.15, 250.0, 10.0], 1000, big + 1,
                            1e-3, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float((a[:, 0] / 101325.0 - 1).abs().max()) < 1e-2


def test_change_gap():
    import torch
    x0 = torch.zeros(4, 2)
    ref = torch.tensor([[1.0, 2.0], [0.5, -2.0], [0.0, 1.0], [0.2, 0.0]])
    assert harness.change_gap(x0, ref, ref) == 0.0
    assert harness.change_gap(x0, x0, ref) == 1.0
    out = ref.clone()
    out[1, 1] = float("nan")
    assert harness.change_gap(x0, out, ref) == math.inf


def _trace():
    """A small trace as the card gives it: the stretch 0..100 us between
    two synchronisations, two graph replays of two kernels each, and a
    host read (a device-to-host copy) outside the graphs."""
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": -5, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 1, "dur": 2, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 40, "dur": 2, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "euler_pass_b_kernel<16, false>",
         "ts": 10, "dur": 10, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 5,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "euler_pass_b_kernel<16, false>",
         "ts": 50, "dur": 10, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60, "dur": 5,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 64, "dur": 22, "args": {"correlation": 11}},
        {"ph": "X", "cat": "gpu_memcpy",
         "name": "Memcpy DtoH (Device -> Pageable)", "ts": 80, "dur": 4,
         "args": {"correlation": 11}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 90, "dur": 10},
    ]
    return harness.Trace(ev)


def test_trace_reading():
    tr = _trace()
    assert tr.window_us == 100
    assert tr.busy_us() == 34
    assert tr.idle_gaps() == [(0, 10), (25, 50), (65, 80), (84, 100)]
    assert len(tr.graph_launches()) == 2 and len(tr.in_graphs()) == 4
    ctx = {"trace": tr, "steps": 2}
    assert harness.module("metrics", "launches_per_step").read(ctx) == 2
    assert harness.module("metrics", "busy_ms_per_step").read(
        ctx) == pytest.approx(0.015)
    calls = {"trace": tr, "calls": 2}
    assert harness.module("metrics", "busy_ms_per_call").read(
        calls) == pytest.approx(0.017)
    assert harness.module("metrics", "reads_per_call").read(calls) == 0.5
    assert tr.top_ops()[0] == ["euler_pass_b_kernel<16, false>", 2e-05]
    assert tr.top_gaps()[0] == ["cudaMemcpyAsync", pytest.approx(3.1e-05)]
    assert tr.host_at(30) == "after cudaGraphLaunch"
    share = harness.roofline_pct(tr, "euler_pass_b_kernel",
                                 lambda name, i: 5e-6)
    assert share == pytest.approx(50.0)


def _units(slow, n_slow, fast):
    calls = [0]

    def unit():
        calls[0] += 1
        time.sleep(slow if calls[0] <= n_slow else fast)
    return unit, calls


def test_settle_ends_after_the_step():
    unit, calls = _units(0.02, 15, 0.01)
    got = harness.settle(unit, "cpu", least_s=0.0, most_s=5.0, drop=0.04,
                         after_s=0.05)
    assert got["step_at"] is not None and got["seconds"] < 1.0
    assert 17 <= calls[0] == got["units"] <= 30


def test_settle_without_a_step_ends_at_its_cap():
    unit, calls = _units(0.01, 0, 0.01)
    got = harness.settle(unit, "cpu", least_s=0.0, most_s=0.3, drop=0.04,
                         after_s=0.05)
    assert got["step_at"] is None and 0.3 <= got["seconds"] < 0.5


def test_a_trace_without_its_stretch_is_refused():
    with pytest.raises(RuntimeError):
        harness.Trace([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0,
                        "dur": 1}])


def test_readers_find_nothing_outside_their_cells():
    ctx = {"trace": None, "host_build_s": 1.0}
    for m in SPEC["per_layer"]:
        v = harness.module("metrics", m["name"]).read(ctx)
        assert v is None or m["name"] == "host_build_s"


def test_spec_keeps_to_its_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and \
        1 <= SPEC["run_seconds"] <= 51
    n = 24
    assert (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith(SPEC["paths"][0] + "/")
    cfgs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(
            harness.HERE, "traffic", w["traffic"] + ".json"))
        limits = harness.data(harness.HERE, "limits", w["name"])
        assert all(v > 0 for v in limits.values())
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert callable(harness.module("metrics", m["name"]).read)
    for e in (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
              + SPEC["per_layer"]):
        assert NAME.match(e["name"]) and e["name"] not in names
        names.add(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\t" not in e[k]
    for w in SPEC["workloads"]:
        reports = harness.metrics_of(SPEC, "end_to_end", w["name"])
        assert len(reports) >= 2
        moved = {m["name"] for m in reports}
        assert any(m["moves"] in moved for m in
                   harness.metrics_of(SPEC, "per_layer", w["name"]))


def test_the_reference_reads_the_published_airfoil():
    """The reference's copy of the Selig coordinates is the program's."""
    with open(os.path.join(ROOT, "ibx_torch", "cases", "data",
                           "rae2822.dat"), "rb") as f:
        program = f.read()
    with open(os.path.join(ROOT, "benchmark", "reference", "data",
                           "rae2822.dat"), "rb") as f:
        assert f.read() == program
