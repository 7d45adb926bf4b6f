"""The kernels' operations and bytes, counted from shapes, at the
sphere's shapes (1296 blocks of 16^3, 5,308,416 cells) against the
byte and operation bounds of the port's kernel table at 3.35 TB/s and
67 TFLOP/s."""

import pytest

import harness

BLOCKS, BS = 1296, 16
CELLS = BLOCKS * BS ** 3


def ms(work):
    ops, nbytes = work
    pk = harness.peaks()
    return (nbytes / pk["hbm_bytes_per_s"] * 1e3,
            ops / pk["float32_flop_per_s"] * 1e3)


@pytest.mark.parametrize("with_dt,bytes_ms", [(True, 0.1839),
                                              (False, 0.1648)])
def test_pass_a(with_dt, bytes_ms):
    rl = harness.module("roofline", "euler_pass_a")
    b, o = ms(rl.work(BLOCKS, BS, with_dt=with_dt))
    assert b == pytest.approx(bytes_ms, rel=1e-3) and o < b


def test_pass_b():
    rl = harness.module("roofline", "euler_pass_b")
    b, o = ms(rl.work(BLOCKS, BS))
    assert b == pytest.approx(0.1648, rel=1e-3)
    assert o == pytest.approx(0.077, rel=1e-2)


@pytest.mark.parametrize("stage,bytes_ms", [(1, 0.1078), (2, 0.1395)])
def test_rk2_update(stage, bytes_ms):
    rl = harness.module("roofline", "rk2_update")
    b, o = ms(rl.work(CELLS, stage))
    assert b == pytest.approx(bytes_ms, rel=1e-3) and o < b
