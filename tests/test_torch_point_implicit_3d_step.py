"""One point-implicit step of the port at nd = 3, on the fixture of
`tests/test_torch_point_implicit_3d.py` (the bs=4 sphere at wall_h=0.25,
the JAX package's tables), in a file of its own so that the two files run
on two workers."""

import pytest
import torch

from ibx_torch.convert import state_from_numpy
from ibx_torch.physics.fluid import make_fluid
from ibx_torch.solve import point_implicit_step

from test_torch_point_implicit import CFL
from test_torch_point_implicit_3d import sphere  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("freeze_limiter", [False, True])
def test_point_implicit_step_on_sphere(sphere, freeze_limiter):  # noqa: F811
    """One port step on the sphere from the perturbed state (cfl 5, relax
    0.8, the freeze mask): finite, the linear solve making progress."""
    _, _, tb, apply_bcs, tact, P = sphere
    Pt, = state_from_numpy(P, device="cpu")
    P1, ratio = point_implicit_step(tb, make_fluid(), Pt, apply_bcs,
                                    cfl=CFL, active=tact, relax=0.8,
                                    freeze_limiter=freeze_limiter)
    assert P1.shape == Pt.shape and torch.isfinite(P1).all()
    assert float(ratio) < 1.0
