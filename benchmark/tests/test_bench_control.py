"""The comparison that decides ``correct`` fails what it must: the
control (the reference in bfloat16 in the program's place) and a run
whose timed path is broken underneath, at a small size; on the card the
control at the same small size."""

import pytest
import torch

import harness
from small_checkout import run_cell

CELLS = ["rae2822-flagship.march", "sphere3d-5m.march",
         "rae2822-flagship.fas"]


def _run(small_root, workload, device):
    sp = harness.spec(small_root)
    wl, cfg, tr = harness.cell(sp, workload, small_root)
    bdir = harness.bench_dir(sp, small_root)
    run = harness.module("runners", tr["runner"], bdir).Run(
        cfg, tr, 2 ** 31 + 4242, device)
    run.setup()
    run.window(0.01)
    return run, harness.data(bdir, "limits", workload)


def _control_fails(run, limits):
    rd = run.readings(control=True)
    prog = {k: v for k, v in rd.items() if not k.startswith("control.")}
    ctl = {k[len("control."):]: v for k, v in rd.items()
           if k.startswith("control.")}
    assert all(v <= limits[k] for k, v in prog.items()), prog
    assert any(v > limits[k] for k, v in ctl.items()), ctl
    # the upper readings lie well above the lower ones
    assert min(ctl.values()) > 3 * max(v for k, v in prog.items()
                                       if k != "ratio_gap")


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(small_root, workload):
    _control_fails(*_run(small_root, workload, torch.device("cpu")))


@pytest.mark.card
def test_the_control_fails_on_the_card(small_root, card):
    _control_fails(*_run(small_root, "rae2822-flagship.march", card))


def _unchanged(x_in, x_out):
    return x_in.clone()


def _half_left_out(x_in, x_out):
    out = x_out.clone()
    out[::2] = x_in[::2]
    return out


def _one_answer_altered(x_in, x_out):
    out = x_out.clone()
    i = int((x_out - x_in).abs().amax(1).argmax())
    out[i] = out[i] * 1.5
    return out


FAULTS = {"unchanged": _unchanged, "half_left_out": _half_left_out,
          "one_answer_altered": _one_answer_altered}


def _break(monkeypatch, workload, fault):
    """Break the timed entry of ``workload`` underneath the harness."""
    f = FAULTS[fault]
    if workload.endswith(".fas"):
        from ibx_torch.solve import FasEuler
        cycle = FasEuler.cycle

        def broken(self, Q, **kw):
            out, ratio = cycle(self, Q, **kw)
            return f(Q, out), ratio
        monkeypatch.setattr(FasEuler, "cycle", broken)
        return
    from ibx_torch.cases.rae2822 import Rae2822Case
    from ibx_torch.cases.sphere3d import Sphere3dCase
    for cls in (Rae2822Case, Sphere3dCase):
        march = cls.march

        def broken(self, P, n, _march=march, **kw):
            return f(P, _march(self, P, n, **kw))
        monkeypatch.setattr(cls, "march", broken)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(small_root, capsys,
                                            monkeypatch, workload, fault):
    _break(monkeypatch, workload, fault)
    code, line = run_cell(small_root, workload, capsys=capsys)
    assert code == 0
    assert line["correct"] is False and line["failed"] >= 1


def _break_late(monkeypatch, workload):
    """From the window's second call of the timed entry on, return its
    input: set-up makes the first call and the small checkout's settle
    one more, so the window's first is the third."""
    calls = [0]

    def late(x_in, x_out):
        calls[0] += 1
        return x_out if calls[0] <= 3 else x_in.clone()
    monkeypatch.setitem(FAULTS, "_late", late)
    _break(monkeypatch, workload, "_late")
    return calls


@pytest.mark.parametrize("workload", CELLS)
def test_a_state_left_unchanged_late_in_the_window_is_not_correct(
        small_root, capsys, monkeypatch, workload):
    """The last chunk or call alone left unchanged fails the end check."""
    calls = _break_late(monkeypatch, workload)
    code, line = run_cell(small_root, workload, seconds=1.0, capsys=capsys)
    assert code == 0 and line["attempted"] >= 2, line
    start, end = line["checks"]["start_gap"], line["checks"]["end_gap"]
    assert start["value"] <= start["limit"] and end["value"] > end["limit"]
    assert line["correct"] is False and calls[0] >= 4
