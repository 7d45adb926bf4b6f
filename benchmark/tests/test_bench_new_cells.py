"""The RANS cell and the flagship's four-rank cell, as the control test
holds the others (`test_bench_control.py`): at a small size on the CPU
(four gloo ranks for the sharded cell) the control fails, and a run whose
timed path is broken underneath is not correct. The faults are those of
`test_bench_control.FAULTS`, put into the RANS case's ``march`` (the flow
and Rt as one state) and into rank 0's shard of the sharded ``march``."""

import pytest
import torch

from small_checkout import run_cell
from test_bench_control import FAULTS, _control_fails, _run

CELLS = ["rae2822-rans.march", "rae2822-flagship.march-4chip"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(small_root, workload):
    run, limits = _run(small_root, workload, torch.device("cpu"))
    try:
        _control_fails(run, limits)
    finally:
        if hasattr(run, "release") and getattr(run, "rank", None):
            run.release()


def _rows(f):
    """``f`` over a state's cells as rows [N, C], whatever its layout."""
    def g(x_in, x_out):
        C = x_out.shape[-1]
        return f(x_in.reshape(-1, C), x_out.reshape(-1, C)).reshape(
            x_out.shape)
    return g


def _break(monkeypatch, workload, fault):
    """Break the timed entry of ``workload`` underneath the harness."""
    import ibx_torch.cases as cases
    f = _rows(FAULTS[fault])
    if workload == "rae2822-rans.march":
        build = cases.build_rae2822_rans

        def broken_build(**kw):
            case = build(**kw)
            march = case.march

            def broken(P, Rt, n, **k):
                P1, Rt1 = march(P, Rt, n, **k)
                out = f(torch.cat([P, Rt[:, None]], 1),
                        torch.cat([P1, Rt1[:, None]], 1))
                return out[:, :-1].contiguous(), out[:, -1].contiguous()
            case.march = broken
            return case
        monkeypatch.setattr(cases, "build_rae2822_rans", broken_build)
        return
    build = cases.build_rae2822_block_sharded

    def broken_sharded(*a, **kw):
        sbd, step, P0, case = build(*a, **kw)
        march = sbd.march

        def broken(P, n, **k):
            return f(P, march(P, n, **k))
        sbd.march = broken
        return sbd, step, P0, case
    monkeypatch.setattr(cases, "build_rae2822_block_sharded", broken_sharded)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(small_root, capsys,
                                            monkeypatch, workload, fault):
    _break(monkeypatch, workload, fault)
    code, line = run_cell(small_root, workload, capsys=capsys)
    assert code == 0
    assert line["correct"] is False and line["failed"] >= 1
