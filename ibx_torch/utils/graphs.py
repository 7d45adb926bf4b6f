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

`Graphs` holds one captured step per march variant of a case and one
captured loop a slot (a loop captured for other arguments replaces the
slot's last), all in one memory pool (one step's intermediates, not one a
variant), and `march_loop` is every case's ``march``: captured on a CUDA
state unless ``graph=False``, the eager loop on the CPU. `graphed_call` is
a step called one at a time (a sharded case's ``step``, the wing's FAS
cycle): one replay a call, returning the step's ``res`` too.

A sharded march passes its `DeviceMesh`: over ``nccl`` its collectives
and its halo exchange are captured with the step (the exchange runs on
the process group's stream, a branch of the graph that the interior pass
overlaps); a staged mesh (``gloo`` with CUDA tensors) moves every
exchange through host tensors, which no graph can hold, so it runs eager
as the CPU does, and ``graph=True`` there raises. Nothing falls back: a
step that cannot be captured raises.

`GraphedLoop` is a loop whose stop rule reads the device (the FAS cycle,
the point-implicit solve: the JAX package's ``lax.while_loop`` under
``jax.jit``): a head, a body replayed while a device predicate holds and
a tail, each a `Piece` (a function of no argument over static buffers)
captured in its own graph, all in one pool. The host reads the predicate
once before each body, as the eager loop does; the body count is the
data's. A tensor that one piece hands to the next lives in a static
buffer or was made by an earlier piece of the same run, so a graph may
reuse the memory of another's intermediates whatever the body count.

Under `monitor.tracing` the captures carry the program's spans: a captured
step's first and last nodes stamp ``march.step``, a named piece's stamp its
name, and the copies in and out of the static buffers are
``march.boundary`` spans on the host and the device. A capture bakes its
stamps in, so `Graphs` keeps the graphs captured while recording under
keys of their own, in the same pool: with recording off the graphs
captured are those of a program without spans, node for node. Each replay
counts ``graph.replays``; a named loop counts its stop-rule reads
(``<family>.stop_reads``, each read a ``<family>.stop_read`` host span) and
its bodies (``<family>.bodies.<level>``).
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from ..ops import kernels
from . import monitor


def _as_tuple(X) -> Tuple[torch.Tensor, ...]:
    return tuple(X) if isinstance(X, (tuple, list)) else (X,)


def _clone(r):
    if r is None:
        return None
    if isinstance(r, (tuple, list)):
        return tuple(_clone(x) for x in r)
    return r.clone()


def _replayed(launches: Dict[str, int]) -> None:
    """Count one replay: the captured kernel launches into
    `kernels.launches` (as the eager run would have counted them) and one
    ``graph.replays``."""
    for k, v in launches.items():
        kernels.launches[k] += v
    monitor.count("graph.replays")


def at_boundary(fn: Callable, X):
    """``fn(X)``, a march's conversion of its state at the edge of the
    captured steps, inside the ``march.boundary`` spans."""
    with monitor.span("march.boundary"), \
            monitor.device_span("march.boundary", _as_tuple(X)[0]):
        return fn(X)


def use_graph(graph: Optional[bool], X, mesh=None) -> bool:
    """Whether a march of the state ``X`` runs captured: ``graph=None``
    decides by the state's device (the card: yes; the CPU: no), False is
    the eager loop on any device, True needs a CUDA state. ``mesh`` (a
    sharded march's `DeviceMesh`): on a staged mesh None is the eager
    loop and True raises."""
    if mesh is not None and mesh.staged:
        if graph:
            raise ValueError(
                "graph=True on a staged mesh (gloo with CUDA tensors): its "
                "exchanges go through host tensors, which a CUDA graph "
                "cannot capture (use nccl, one rank a card)")
        return False
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
            with monitor.device_span("march.step", dev):
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
        at_boundary(self._copy_in, xs)
        for _ in range(n):
            self.graph.replay()
            _replayed(self.launches)
        return at_boundary(self._copy_out, self.static)

    def _copy_in(self, xs) -> None:
        for s, x in zip(self.static, xs):
            s.copy_(x)

    def _copy_out(self, xs):
        return self._arg(tuple(s.clone() for s in xs))

    def call(self, X):
        """One replay from ``X``: ``(X', res)`` as the step returns them
        (new tensors)."""
        return self.run(X, 1), _clone(self.res)


class Piece:
    """A function of no argument that reads and writes tensors which
    outlive it: called as it is until `capture`, then one replay a call.
    A piece with a ``name`` runs inside a device span of that name on
    ``device`` (in a capture: its first and last nodes)."""

    def __init__(self, fn: Callable[[], None], generators: Sequence = (),
                 name: Optional[str] = None, device=None):
        self.fn = fn
        # the `torch.Generator`s other than the default that ``fn`` draws
        # from: a replay draws where the generator stands and advances it
        self.generators = tuple(generators)
        self.name, self.device = name, device
        self.graph = None
        self.launches: Dict[str, int] = {}

    def _run(self) -> None:
        if self.name is None:
            self.fn()
            return
        with monitor.device_span(self.name, self.device):
            self.fn()

    def capture(self, pool) -> None:
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = dict(kernels.launches)
        with torch.cuda.graph(graph, pool=pool):
            self._run()
        self.launches = {k: kernels.launches[k] - n
                         for k, n in before.items()}
        kernels.launches.update(before)   # capture launched nothing
        self.graph = graph

    def __call__(self) -> None:
        if self.graph is None:
            self._run()
            return
        self.graph.replay()
        _replayed(self.launches)


class GraphedLoop:
    """``head``, then ``bodies[select(it)]`` while ``it < n_iter`` and the
    0-dim bool ``pred`` (written by the head and by every body) holds,
    then ``tail``: the stop rule of the JAX package's ``while_loop``, its
    predicate read on the host once before each body. ``head`` and
    ``tail`` hold `Piece`s and nested loops (a FAS level's coarse
    recursion), run in order. ``iterations`` is the last run's body
    count. A loop named ``<family>.<level>`` (``fas.L0``) records each
    predicate read as a ``<family>.stop_read`` span and counts the reads
    (``<family>.stop_reads``) and its bodies
    (``<family>.bodies.<level>``)."""

    def __init__(self, head: Sequence, bodies: Sequence[Piece],
                 pred: torch.Tensor, n_iter: int, tail: Sequence = (),
                 select: Optional[Callable[[int], int]] = None,
                 name: Optional[str] = None):
        self.head, self.bodies, self.tail = tuple(head), tuple(bodies), \
            tuple(tail)
        self.pred, self.n_iter = pred, n_iter
        self.select = select or (lambda it: 0)
        self.iterations = 0
        self.name = name
        if name is not None:
            family, _, level = name.partition(".")
            self._read = family + ".stop_read"
            self._bodies = f"{family}.bodies.{level}"

    def _holds(self) -> bool:
        """The stop rule's predicate, read on the host."""
        if self.name is None:
            return bool(self.pred)
        with monitor.span(self._read):
            holds = bool(self.pred)
        monitor.count(self._read + "s")
        return holds

    def __call__(self) -> int:
        for item in self.head:
            item()
        it = 0
        while it < self.n_iter and self._holds():
            self.bodies[self.select(it)]()
            it += 1
        self.iterations = it
        if self.name is not None:
            monitor.count(self._bodies, it)
        for item in self.tail:
            item()
        return it

    def pieces(self):
        """Every piece in the order of a run that takes each body once."""
        for group in (self.head, self.bodies, self.tail):
            for item in group:
                if isinstance(item, GraphedLoop):
                    yield from item.pieces()
                else:
                    yield item

    def capture(self, pool) -> None:
        """Run every piece once on a side stream (lazily made tables and
        buffers are made there, outside the pool), then capture each, in
        the same order, into ``pool``. The pieces' generators are left
        where they stood."""
        dev = self.pred.device
        pieces = list(self.pieces())
        generators = [g for p in pieces for g in p.generators]
        states = [g.get_state() for g in generators]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for p in pieces:
                p.fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        for p in pieces:
            p.capture(pool)
        for g, s in zip(generators, states):
            g.set_state(s)


class Graphs:
    """A case's captured steps, one a march variant, and its captured
    loops, in one memory pool."""

    def __init__(self):
        self.steps: Dict[Hashable, GraphedStep] = {}
        # one captured loop a slot: (its key, the loop)
        self.loops: Dict[Hashable, Tuple[Hashable, object]] = {}
        self.last = None
        self._pool = None

    def get(self, key: Hashable, step: Callable, X) -> GraphedStep:
        """The captured step of variant ``key`` (captured from ``X`` at
        its first use; while recording, a traced capture of its own)."""
        if monitor.recording():
            key = ("traced", key)
        g = self.steps.get(key)
        if g is None:
            g = GraphedStep(step, X, pool=self._pool)
            self._pool = g.graph.pool()
            self.steps[key] = g
        return g

    def loop(self, slot: Hashable, key: Hashable, make: Callable,
             captured: bool):
        """The loop of ``slot`` for the arguments ``key``, an object with
        ``capture(pool)`` that ``make()`` builds: where ``captured``,
        built and captured at the first use of ``key`` and kept until a
        call of the slot with another key captures its own (into the same
        pool, whose free memory it reuses) and drops it; else built anew,
        to run eagerly. ``last`` is the loop returned last (its
        ``iterations`` are the last run's). While recording the slot is
        a traced one of its own."""
        if monitor.recording():
            slot = ("traced", slot)
        held = self.loops.get(slot) if captured else None
        if held is not None and held[0] == key:
            lp = held[1]
        else:
            lp = make()
            if captured:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                lp.capture(self._pool)
                self.loops[slot] = (key, lp)
        self.last = lp
        if held is not None and held[1] is not lp:
            del held
            gc.collect()   # the dropped loop's pieces hold it in cycles
        return lp


def march_loop(graphs: Graphs, key: Hashable, step: Callable, X, n: int,
               graph: Optional[bool] = None, mesh=None):
    """``n`` steps of ``step`` (``X -> (X', res)``) from ``X``: replays of
    the captured step where `use_graph` says so, else the eager loop."""
    if use_graph(graph, X, mesh) and n > 0:
        return graphs.get(key, step, X).run(X, n)
    for _ in range(n):
        with monitor.device_span("march.step", _as_tuple(X)[0]):
            X, _ = step(X)
    return X


def graphed_call(graphs: Graphs, key: Hashable, step: Callable, X,
                 graph: Optional[bool] = None, mesh=None):
    """One step ``X -> (X', res)``: one replay of the captured step where
    `use_graph` says so, else the step itself."""
    if use_graph(graph, X, mesh):
        return graphs.get(key, step, X).call(X)
    return step(X)
