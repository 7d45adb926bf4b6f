"""March observability: residual history, convergence detection, profiling
(counterpart of `ibx/utils/monitor.py`).

The reference's only run-time observability is verbose stage banners and the
``TimeAverage`` EMA tracker (``src/cfd.jl:747-802``); solvers return residual
ratios (``src/solver.jl:90``). This gives march loops a proper monitor:
history recording, relative-drop convergence tests, rate estimates, and an
optional `torch.profiler` trace context.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch


class ResidualMonitor:
    """Records (iteration, wall_clock, residual [, extras]) samples.

    >>> mon = ResidualMonitor(print_every=100)
    >>> for i in range(n):
    ...     P, res = step(P)
    ...     mon.push(float(res), cl=cl)
    ...     if mon.converged(rtol=1e-4): break
    """

    def __init__(self, *, print_every: int = 0, label: str = "march"):
        self.label = label
        self.print_every = print_every
        self.iters: List[int] = []
        self.times: List[float] = []
        self.residuals: List[float] = []
        self.extras: List[dict] = []
        self._t0 = time.time()
        self._n = 0

    def push(self, residual: float, **extras) -> None:
        self._n += 1
        self.iters.append(self._n)
        self.times.append(time.time() - self._t0)
        self.residuals.append(float(residual))
        self.extras.append(extras)
        if self.print_every and self._n % self.print_every == 0:
            xs = " ".join(f"{k}={v:.5g}" for k, v in extras.items())
            print(f"[{self.label}] it={self._n} t={self.times[-1]:.1f}s "
                  f"res={residual:.4e} {xs}", flush=True)

    @property
    def r0(self) -> Optional[float]:
        return self.residuals[0] if self.residuals else None

    def drop(self) -> float:
        """Residual reduction ratio vs the first sample."""
        if not self.residuals:
            return 1.0
        return self.residuals[-1] / (self.r0 + 1e-300)

    def converged(self, *, rtol: float = 1e-4, atol: float = 0.0) -> bool:
        if not self.residuals:
            return False
        return self.residuals[-1] <= rtol * self.r0 + atol

    def rate(self, window: int = 20) -> float:
        """Geometric per-iteration residual reduction over the last window."""
        if len(self.residuals) < 2:
            return 1.0
        w = min(window, len(self.residuals) - 1)
        a, b = self.residuals[-1 - w], self.residuals[-1]
        if a <= 0:
            return 1.0
        return (b / a) ** (1.0 / w)

    def summary(self) -> dict:
        return dict(
            label=self.label,
            iterations=self._n,
            wall_clock=self.times[-1] if self.times else 0.0,
            residual_first=self.r0,
            residual_last=self.residuals[-1] if self.residuals else None,
            drop=self.drop(),
            rate=self.rate(),
        )


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """`torch.profiler` trace of the block, written as a Chrome trace
    (``trace.json``) into ``logdir``, when a logdir is given; a no-op
    otherwise. The CPU is traced always, the CUDA device where one is
    available."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
