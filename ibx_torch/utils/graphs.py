"""The compiled march: one pseudo step captured in a CUDA graph and
replayed, the port's counterpart of the JAX package's `jax.jit` over
`lax.fori_loop`.

`GraphedStep` takes a step ``X -> (X', res)`` on a fixed-shape CUDA state
``X`` (a tensor or a tuple of tensors). It keeps a static state buffer,
warms the step up once on a side stream (which also builds and loads the
kernel library and makes every lazily built table before capture),
captures one step into a `torch.cuda.CUDAGraph` ending with the copy of
``X'`` back into the static buffer, and replays the graph. The kernel
wrappers count launches in Python, which runs once, at capture: the
counts of the captured step are recorded and added on every replay, so
`ibx_torch.ops.kernels.launches` reads as it would after the eager loop.

`Graphs` holds one captured step per march variant of a case, all in one
memory pool (one step's intermediates, not one a variant), and
`march_loop` is every case's ``march``: captured on a CUDA state unless
``graph=False``, the eager loop on the CPU. Nothing falls back: a step
that cannot be captured raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from ..ops import kernels


def _as_tuple(X) -> Tuple[torch.Tensor, ...]:
    return tuple(X) if isinstance(X, (tuple, list)) else (X,)


def use_graph(graph: Optional[bool], X) -> bool:
    """Whether a march of the state ``X`` runs captured: ``graph=None``
    decides by the state's device (the card: yes; the CPU: no), False is
    the eager loop on any device, True needs a CUDA state."""
    on_card = _as_tuple(X)[0].device.type == "cuda"
    if graph is None:
        return on_card
    if graph and not on_card:
        raise ValueError("graph=True needs a CUDA state: a CUDA graph "
                         "captures card work only")
    return bool(graph)


class GraphedStep:
    """One step ``X -> (X', res)`` captured in a CUDA graph over a static
    copy of ``X`` (see the module docstring). ``pool`` is a memory pool
    shared with other captured steps that replay on the same stream."""

    def __init__(self, step: Callable, X, *, pool=None):
        # the graph reads the tensors the step closes over by address:
        # holding the step holds them
        self.step = step
        self._tuple = isinstance(X, (tuple, list))
        self.static = tuple(x.detach().clone() for x in _as_tuple(X))
        dev = self.static[0].device
        arg = self._arg(self.static)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(arg)
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(kernels.launches)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            out, self.res = step(arg)
            for s, o in zip(self.static, _as_tuple(out)):
                s.copy_(o)
        self.launches = {k: kernels.launches[k] - n
                         for k, n in before.items()}
        kernels.launches.update(before)   # capture launched nothing

    def _arg(self, xs):
        return xs if self._tuple else xs[0]

    def run(self, X, n: int):
        """``n`` replays from ``X``: the state after ``n`` steps (new
        tensors; the static buffer is the next call's)."""
        xs = _as_tuple(X)
        if len(xs) != len(self.static) or any(
                x.shape != s.shape or x.dtype != s.dtype
                for x, s in zip(xs, self.static)):
            raise ValueError("the state's shapes differ from the captured "
                             "step's")
        for s, x in zip(self.static, xs):
            s.copy_(x)
        for _ in range(n):
            self.graph.replay()
            for k, v in self.launches.items():
                kernels.launches[k] += v
        return self._arg(tuple(s.clone() for s in self.static))


class Graphs:
    """A case's captured steps, one a march variant, in one memory pool."""

    def __init__(self):
        self.steps: Dict[Hashable, GraphedStep] = {}
        self._pool = None

    def get(self, key: Hashable, step: Callable, X) -> GraphedStep:
        """The captured step of variant ``key`` (captured from ``X`` at
        its first use)."""
        g = self.steps.get(key)
        if g is None:
            g = GraphedStep(step, X, pool=self._pool)
            self._pool = g.graph.pool()
            self.steps[key] = g
        return g


def march_loop(graphs: Graphs, key: Hashable, step: Callable, X, n: int,
               graph: Optional[bool] = None):
    """``n`` steps of ``step`` (``X -> (X', res)``) from ``X``: replays of
    the captured step where `use_graph` says so, else the eager loop."""
    if use_graph(graph, X) and n > 0:
        return graphs.get(key, step, X).run(X, n)
    for _ in range(n):
        X, _ = step(X)
    return X
