"""The port's bench (`ibx_torch.bench`, the counterpart of the repo's
``bench.py``) on the CPU at a small size: the RAE2822 at wall_h=8e-2
(53,248 cells at bs=16), 3 steps, no 3D leg, read from ``bench.py``'s own
environment (monkeypatched). Its JSON line has ``bench.py``'s keys,
metric name and unit fields (``sharded_1dev`` included; the port adds
``busy`` and ``card``) and the same cell count as the reference's line at
the same settings, which runs once in a subprocess on the CPU;
``IBX_BENCH_SHARDED=1`` works, a non-finite state exits 1, no card exits
non-zero without running, and the module imports neither JAX nor the JAX
package."""

import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ibx_torch import bench

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(IBX_BENCH_WALL_H="8e-2", IBX_BENCH_STEPS="3", IBX_BENCH_3D="0")
# what the port's unit string adds to bench.py's fields
ADDED = {"busy", "card"}


def _fields(unit):
    return re.findall(r"([A-Za-z_0-9]+)=", unit)


def _port_line(monkeypatch, capsys, **env):
    for k, v in dict(ENV, **env).items():
        monkeypatch.setenv(k, v)
    rc = bench.main(device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return rc, json.loads(out[0])


@pytest.fixture(scope="module")
def reference():
    """``bench.py``'s line at the same settings (JAX on the CPU)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", **ENV)
    env.pop("IBX_BENCH_SHARDED", None)
    env.pop("IBX_BENCH_CASE", None)
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_line_matches_bench_py(reference, monkeypatch, capsys):
    """Same keys, metric, unit fields and cell count as ``bench.py``;
    ``vs_baseline`` is the value over 125e6 in both."""
    rc, line = _port_line(monkeypatch, capsys)
    assert rc == 0
    assert list(line) == list(reference)
    assert line["metric"] == reference["metric"] == \
        "rae2822_euler_cell_updates_per_sec_per_chip"
    ref_f, port_f = _fields(reference["unit"]), _fields(line["unit"])
    assert "sharded_1dev" in ref_f
    assert [f for f in port_f if f not in ADDED] == ref_f
    assert "err:" not in line["unit"]
    cells = re.compile(r"\(cells=(\d+), steps=(\d+),")
    assert cells.search(line["unit"]).groups() == \
        cells.search(reference["unit"]).groups() == ("53248", "3")
    assert line["unit"].startswith("cell-updates/s/chip (")
    assert "busy=not measured" in line["unit"] and "card=cpu" in line["unit"]
    for ln in (line, reference):
        assert math.isfinite(ln["value"]) and ln["value"] > 0
        assert math.isclose(ln["vs_baseline"], ln["value"] / 125e6,
                            rel_tol=1e-12)


def test_sharded_run(monkeypatch, capsys):
    """``IBX_BENCH_SHARDED=1``: the case through the one-rank sharded
    runtime (a gloo group here), tagged as ``bench.py`` tags it."""
    rc, line = _port_line(monkeypatch, capsys, IBX_BENCH_SHARDED="1")
    assert rc == 0
    assert line["metric"] == "rae2822_euler_cell_updates_per_sec_per_chip"
    assert ", sharded=1-device-mesh" in line["unit"]
    assert "sharded_1dev" not in line["unit"]
    assert math.isfinite(line["value"]) and line["value"] > 0


def test_non_finite_state_exits_1(monkeypatch, capsys):
    """A non-finite state prints ``bench.py``'s error line and exits 1."""
    build = bench.build_case

    def poisoned(*a, **kw):
        case = build(*a, **kw)
        case.P0 = torch.full_like(case.P0, float("nan"))
        return case

    monkeypatch.setattr(bench, "build_case", poisoned)
    rc, line = _port_line(monkeypatch, capsys)
    assert rc == 1
    assert line == {"metric": "error", "value": 0,
                    "unit": "non-finite state", "vs_baseline": 0}


def test_no_card_exits_nonzero(monkeypatch, capsys):
    """Without a card the default (the card) prints an error line and
    exits 2; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "run", lambda *a, **kw: pytest.fail("ran"))
    assert bench.main() == 2
    line = json.loads(capsys.readouterr().out.strip())
    assert line["metric"] == "error" and line["unit"] == "no CUDA device"


def test_imports_no_jax():
    """Importing the bench loads neither JAX nor the JAX package."""
    code = ("import sys, ibx_torch.bench; bad = sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ibx')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
