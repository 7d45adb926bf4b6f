"""Full Approximation Scheme multigrid cycle (device side; counterpart of
`ibx/solve/fas.py`).

Counterpart of reference ``src/solver.jl:39-91``: recursive FAS over a user
function ``f(level, Q) -> (r, omega)`` (residual and relaxation factor), with
tau-corrected coarse-grid recursion and relaxed fixed-point smoothing.

The JAX package's ``lax.while_loop`` is a `utils.graphs.GraphedLoop` a
level over static buffers (`FasCycle`): a head (``f``, the source, ``r``,
``nr0``, the stop threshold, and the coarsened state and residual the
coarse level starts from), the coarse level's loop, a tail (the
prolonged correction) and a body (one smoothing iteration), replayed
while the stop rule holds; the host reads the rule's predicate once an
iteration. `fas` runs the pieces eagerly; `FasEuler` keeps its cycles
and captures each piece in a CUDA graph on a CUDA state.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ..utils.graphs import GraphedLoop, Piece

_EPS32 = float(np.finfo(np.float32).eps)


def _l2(r):
    return torch.sqrt((r.float() ** 2).sum())


class _Level:
    """One level of the cycle: its iterate ``Q`` and scalars, its pieces
    and its loop (the coarse level's loop inside its head)."""

    def __init__(self, f, level, dev, coarseners, prolongators, prescribed,
                 n_iter, rtol, atol, out: List["_Level"]):
        self.f, self.level = f, level
        self.rtol, self.atol = rtol, atol
        self.prescribed = prescribed
        # state-shaped buffers, made at the first run (the coarse shapes
        # are the transfers'): Q, pf (the prescribed f), source, Qc_old
        self.buf = {}
        scalar = dict(dtype=torch.float32, device=dev)
        self.nr0 = torch.zeros((), **scalar)
        self.stop = torch.zeros((), **scalar)
        self.ratio = torch.zeros((), **scalar)
        self.pred = torch.zeros((), dtype=torch.bool, device=dev)
        out.append(self)
        # the pieces' device spans and the loop's counters are named
        # fas.L<level>.*
        name = f"fas.L{level}"
        head = [Piece(self._head, name=name + ".head", device=dev)]
        self.child = None
        # the reference's convention: the last coarsener in the list is
        # never recursed into (``src/solver.jl:60-77``)
        if len(coarseners) > 1:
            self.coarsen, self.prolong = coarseners[0], prolongators[0]
            self.child = _Level(f, level + 1, dev, coarseners[1:],
                                prolongators[1:], True, n_iter, rtol, atol,
                                out)
            head += [self.child.loop,
                     Piece(self._tail, name=name + ".tail", device=dev)]
        self.loop = GraphedLoop(
            head, [Piece(self._body, name=name + ".body", device=dev)],
            self.pred, n_iter, name=name)

    def put(self, name, value):
        b = self.buf.get(name)
        if b is None:
            self.buf[name] = value.clone()
        else:
            b.copy_(value)

    def _head(self):
        Q = self.buf["Q"]
        fQ, _ = self.f(self.level, Q)
        if self.prescribed:
            source = self.buf["pf"] - fQ
        else:
            source = torch.zeros_like(fQ)
        r = fQ + source
        nr0 = _l2(r)
        if self.child is not None:
            Qc = self.coarsen(Q)
            self.child.put("Q", Qc)
            self.put("Qc_old", Qc)
            self.child.put("pf", self.coarsen(r))
        self.put("source", source)
        stop = nr0 * self.rtol + self.atol
        nr = torch.full_like(nr0, float("inf"))
        self.nr0.copy_(nr0)
        self.stop.copy_(stop)
        self._carry(nr)

    def _tail(self):
        Q = self.buf["Q"]
        self.put("Q", Q + self.prolong(self.child.buf["Q"]
                                       - self.buf["Qc_old"]))

    def _body(self):
        Q = self.buf["Q"]
        r, omega = self.f(self.level, Q)
        r = r + self.buf["source"]
        Q = Q + omega.clamp(0.0, 1.0) * r
        self.put("Q", Q)
        self._carry(_l2(r))

    def _carry(self, nr):
        # the stop rule's predicate and the reduction ratio, in float32 on
        # the device as the JAX package's while_loop computes them
        self.pred.copy_(nr >= self.stop)
        self.ratio.copy_(nr / (self.nr0 + _EPS32))


class FasCycle:
    """`fas` over static buffers: ``cycle(Q, prescribed_f)`` runs one
    cycle from ``Q`` and returns ``(Q, ratio)`` (new tensors); the pieces
    run eagerly until `capture`. ``iterations`` lists each level's
    smoothing iterations of the last run (finest first)."""

    def __init__(self, f: Callable, Q, *, coarseners: Sequence = (),
                 prolongators: Sequence = (), prescribed_f=None,
                 multigrid_level: int = 0, n_iter: int = 50,
                 rtol: float = 0.1, atol: float = 1e-7):
        self.levels: List[_Level] = []
        self.top = _Level(f, multigrid_level, Q.device, list(coarseners),
                          list(prolongators), prescribed_f is not None,
                          n_iter, rtol, atol, self.levels)
        # the inputs' static buffers, filled here so that `capture` can
        # run the pieces before the first call
        self.top.put("Q", Q)
        if prescribed_f is not None:
            self.top.put("pf", prescribed_f)

    def capture(self, pool) -> None:
        self.top.loop.capture(pool)

    @property
    def iterations(self) -> List[int]:
        return [lv.loop.iterations for lv in self.levels]

    def __call__(self, Q, prescribed_f=None):
        top = self.top
        if Q.shape != top.buf["Q"].shape:
            raise ValueError("the state's shape differs from the cycle's")
        top.put("Q", Q)
        if top.prescribed:
            top.put("pf", prescribed_f)
        top.loop()
        return top.buf["Q"].clone(), top.ratio.clone()


def fas(
    f: Callable,
    Q,
    *,
    coarseners: Sequence = (),
    prolongators: Sequence = (),
    prescribed_f=None,
    multigrid_level: int = 0,
    n_iter: int = 50,
    rtol: float = 0.1,
    atol: float = 1e-7,
):
    """One FAS cycle. Returns (Q, residual_reduction_ratio), the ratio a
    0-dim float32 tensor on Q's device.

    Semantics follow the reference exactly, including its convention that the
    last coarsener in the list is never recursed into
    (``src/solver.jl:60-77``: recursion only while more than one remains).
    Runs eagerly; `FasEuler` keeps its cycles captured on the card.
    """
    cycle = FasCycle(f, Q, coarseners=coarseners, prolongators=prolongators,
                     prescribed_f=prescribed_f,
                     multigrid_level=multigrid_level, n_iter=n_iter,
                     rtol=rtol, atol=atol)
    return cycle(Q, prescribed_f)
