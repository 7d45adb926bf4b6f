"""The port's checkpoints (`ibx_torch.io.checkpoint`) and march monitor
(`ibx_torch.utils.monitor`): a checkpoint of torch tensors round-trips,
files written by either package load in the other with the same arrays,
step and meta; and tests/test_monitor.py's two tests on the port."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibx.io.checkpoint import load_checkpoint as jx_load
from ibx.io.checkpoint import save_checkpoint as jx_save

from ibx_torch.io import load_checkpoint, save_checkpoint
from ibx_torch.utils import ResidualMonitor, profile_trace

torch.set_num_threads(2)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"P": rng.normal(size=(64, 4)).astype(np.float32),
            "Rt": rng.uniform(size=64).astype(np.float32),
            "ids": np.arange(10, dtype=np.int64),
            "t": 0.25}


def _same(state, loaded):
    assert set(loaded) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(loaded[k], np.asarray(v))


def test_checkpoint_roundtrip_tensors(tmp_path):
    """Tensors (one with a grad, one a view) go to the host as numpy
    arrays and come back equal; the replace is atomic (no temporary file
    stays behind), and a second save overwrites the first."""
    ref = _state()
    P = torch.as_tensor(ref["P"]).requires_grad_()
    state = {"P": P, "Rt": torch.as_tensor(ref["Rt"]),
             "ids": torch.as_tensor(ref["ids"]), "t": ref["t"]}
    path = str(tmp_path / "sub" / "ck.npz")
    save_checkpoint(path, {"P": torch.zeros(1)}, step=1)
    save_checkpoint(path, state, step=42, meta={"case": "rae2822"})
    loaded, step, meta = load_checkpoint(path)
    _same(ref, loaded)
    assert loaded["P"].dtype == np.float32 and loaded["ids"].dtype == np.int64
    assert step == 42 and meta == {"case": "rae2822"}
    assert os.listdir(tmp_path / "sub") == ["ck.npz"]


@pytest.mark.parametrize("writer", ["ibx", "ibx_torch"])
def test_checkpoint_files_cross_load(tmp_path, writer):
    """A file written by one package loads in the other."""
    ref = _state(1)
    path = str(tmp_path / "ck.npz")
    meta = {"cfl": 0.7, "levels": [1, 2]}
    if writer == "ibx":
        jx_save(path, {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                       for k, v in ref.items()}, step=7, meta=meta)
        loaded, step, got = load_checkpoint(path)
    else:
        save_checkpoint(path, {k: torch.as_tensor(v)
                               if isinstance(v, np.ndarray) else v
                               for k, v in ref.items()}, step=7, meta=meta)
        loaded, step, got = jx_load(path)
    _same(ref, loaded)
    assert step == 7 and json.dumps(got) == json.dumps(meta)


def test_residual_monitor():
    """tests/test_monitor.py::test_residual_monitor on the port."""
    mon = ResidualMonitor(label="t")
    for r in [1.0, 0.5, 0.2, 0.1, 0.05, 2e-5]:
        mon.push(r, cl=0.5)
    assert mon.r0 == 1.0
    assert abs(mon.drop() - 2e-5) < 1e-12
    assert mon.converged(rtol=1e-4)
    assert not mon.converged(rtol=1e-6)
    assert 0.0 < mon.rate() < 1.0
    s = mon.summary()
    assert s["iterations"] == 6 and s["residual_last"] == 2e-5


def test_profile_trace_noop():
    """tests/test_monitor.py::test_profile_trace_noop on the port."""
    with profile_trace(None):
        x = np.ones(4).sum()
    assert x == 4.0


def test_profile_trace_writes_trace(tmp_path):
    """With a logdir the block is traced by `torch.profiler` (the CPU here)
    and the trace is written there."""
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)):
        (torch.ones(64) * 2).sum()
    trace = json.loads((logdir / "trace.json").read_text())
    assert trace["traceEvents"]
