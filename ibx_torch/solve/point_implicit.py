"""Matrix-free point-implicit solver (device side; counterpart of
`ibx/solve/point_implicit.py`).

Counterpart of reference ``src/point_implicit.jl``: Hutchinson +/-1-probe
estimation of the block-diagonal Jacobian, a linearization with
Jacobian-vector products, a block-diagonal pseudo-inverse preconditioner, and
a two-direction minimal-residual descent with optional coarse-to-fine
multigrid cycling. JVPs are exact (`torch.func.jvp`, forward mode) instead
of finite differences. Probes come from an explicit `torch.Generator` (the
JAX package's PRNG keys).

The solve's ``lax.while_loop`` is a `utils.graphs.GraphedLoop` over static
buffers (`SolveLoop`): a head (``nr0``, the stop threshold, ``x`` and
``r``) and one body a multigrid level (one outer iteration with its
``n_inner`` inner ones; the host picks the level, which cycles
coarsest-first as the JAX package's ``lax.switch`` does), replayed while
the stop rule holds; the host reads its predicate once an iteration.
`solve` runs the pieces eagerly; `point_implicit_step` captures them in
CUDA graphs on a CUDA state.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.graphs import GraphedLoop, Piece

_EPS = 1.19e-7


def _jvp(f, x, v):
    return torch.func.jvp(f, (x,), (v,))[1]


def _default_generator(X) -> torch.Generator:
    """A generator seeded 0 on X's device (``PRNGKey(0)`` in the JAX
    package)."""
    g = torch.Generator(device=X.device)
    g.manual_seed(0)
    return g


def _rademacher(shape, X, generator):
    """+/-1 probes in X's dtype on X's device."""
    z = torch.randint(0, 2, shape, generator=generator, device=X.device,
                      dtype=X.dtype)
    return z * 2 - 1


def hutchinson_block_diagonal(
    f: Callable, X, n_samples: int = 30, *,
    generator: Optional[torch.Generator] = None,
):
    """Estimate per-row diagonal Jacobian blocks.

    X: [N, m] -> D: [N, m, m] with D[n, j, i] ~ d f(X)[n, j] / d X[n, i]
    (reference ``src/point_implicit.jl:18-91``). Uses exact JVPs with
    Rademacher probes restricted to one variable column at a time.
    For vector input [N] returns the diagonal [N].
    """
    X = torch.as_tensor(X)
    if generator is None:
        generator = _default_generator(X)

    if X.dim() == 1:
        s = torch.zeros_like(f(X))
        for _ in range(n_samples):
            z = _rademacher(X.shape, X, generator)
            s = s + z * _jvp(f, X, z)
        return s / n_samples

    N, m = X.shape
    cols = []
    for i in range(m):
        s = torch.zeros((N, m), dtype=X.dtype, device=X.device)
        for _ in range(n_samples):
            z = _rademacher((N,), X, generator)
            v = torch.zeros_like(X)
            v[:, i] = z
            s = s + z[:, None] * _jvp(f, X, v)
        cols.append(s / n_samples)
    return torch.stack(cols, dim=2)  # [N, m_out, m_in]


class Linearization(NamedTuple):
    """f linearized at x (reference ``src/point_implicit.jl:98-114``);
    JVPs are exact."""

    f: Callable
    x: torch.Tensor
    fx: torch.Tensor

    def __call__(self, v):
        return _jvp(self.f, self.x, v)


class PIPreconditioner(NamedTuple):
    """Block-diagonal pseudo-inverse preconditioner
    (reference ``src/point_implicit.jl:121-161``)."""

    inverse_diagonal: torch.Tensor

    def __call__(self, v):
        D = self.inverse_diagonal
        if D.dim() == 1:
            return v * D
        # out[n, j] = sum_i v[n, i] * D[n, j, i]
        return torch.einsum("ni,nji->nj", v, D)


def linearize(
    f: Callable,
    x,
    *,
    n_hutchinson_samples: int = 30,
    pre_evaluated_fx=None,
    generator: Optional[torch.Generator] = None,
):
    """(A, b, preconditioner) for the Newton system A dx = b = -f(x)
    (reference ``src/point_implicit.jl:184-207``)."""
    x = torch.as_tensor(x)
    fx = f(x) if pre_evaluated_fx is None else torch.as_tensor(
        pre_evaluated_fx, device=x.device)
    D = hutchinson_block_diagonal(f, x, n_hutchinson_samples,
                                  generator=generator)
    if D.dim() == 1:
        Dinv = 1.0 / (_EPS + D)
    else:
        Dinv = _block_inv(D)
    return Linearization(f, x, fx), -fx, PIPreconditioner(Dinv)


def _block_inv(D, rel_reg: float = 1e-5):
    """Regularized inverse of small [N, k, k] blocks by vectorized
    Gauss-Jordan elimination, as the JAX package computes it: the Newton
    blocks here are diagonally dominant (I/dt - diag(J)), so unpivoted
    elimination with a diagonal Tikhonov term is stable; a pivoting or
    SVD-based inverse would give other numbers."""
    k = D.shape[-1]
    scale = torch.sqrt((D * D).sum(dim=(-2, -1)) / (k * k)) + _EPS
    lam = (rel_reg * scale)[:, None]
    eye = torch.eye(k, dtype=D.dtype, device=D.device)
    A = D + lam[..., None] * eye
    M = torch.cat([A, eye.expand(A.shape)], dim=-1)
    for i in range(k):
        piv = M[:, i, i:i + 1]
        row = M[:, i, :] / (piv + _EPS)
        M = M - M[:, :, i:i + 1] * row[:, None, :]
        M[:, i, :] = row
    return M[:, :, k:]


def _dot(a, b):
    return (a * b).sum()


def _proj_along(A: Linearization, v, b):
    """alpha = argmin |b - alpha A v|; returns (alpha, A v)
    (reference ``src/point_implicit.jl:220-233``)."""
    Av = A(v)
    return _dot(Av, b) / (_dot(Av, Av) + _EPS), Av


class SolveLoop:
    """`solve` over static buffers: ``b`` (the right-hand side), the
    iterate ``x``, the residual ``r`` and the stop rule's scalars. The
    caller sets ``A`` and ``prec`` and fills ``b`` (or a piece of its own
    does, before ``head``); ``head``, ``bodies`` (one a multigrid level,
    ``select(it)`` the one of iteration ``it``) and ``pred`` make the
    loop, which ``loop`` runs alone."""

    def __init__(self, b, *, n_iter: int = 100, n_inner: int = 1,
                 rtol: float = 1e-2, atol: float = 1e-7, multigrid=None):
        self.n_inner, self.rtol, self.atol = n_inner, rtol, atol
        self.multigrid = multigrid
        self.n_levels = 0 if multigrid is None else len(
            multigrid.coarseners)
        self.A: Optional[Linearization] = None
        self.prec: Optional[PIPreconditioner] = None
        self.b = b.detach().clone()
        self.x = torch.zeros_like(self.b)
        self.r = torch.zeros_like(self.b)
        scalar = dict(dtype=b.dtype, device=b.device)
        self.nr0 = torch.zeros((), **scalar)
        self.stop = torch.zeros((), **scalar)
        self.ratio = torch.zeros((), **scalar)
        self.pred = torch.zeros((), dtype=torch.bool, device=b.device)
        self.head = Piece(self._head)
        self.bodies = [Piece(lambda n=n: self._body(n))
                       for n in range(self.n_levels + 1)]
        self.loop = GraphedLoop([self.head], self.bodies, self.pred, n_iter,
                                select=self.select)

    def select(self, it: int) -> int:
        """The body of iteration ``it``: the multigrid level, from the
        coarsest down to 0 (none), then again."""
        return self.n_levels - it % (self.n_levels + 1)

    def _smooth(self, level, s):
        # level == 0 -> identity; level n -> coarsen_n |> prolong_n
        if level == 0:
            return s
        return self.multigrid.prolongators[level - 1](
            self.multigrid.coarseners[level - 1](s))

    def _head(self):
        b = self.b
        nr0 = torch.sqrt(_dot(b, b))
        self.nr0.copy_(nr0)
        self.stop.copy_(nr0 * self.rtol + self.atol)
        self.x.zero_()
        self.r.copy_(b)
        self._carry(torch.full_like(nr0, float("inf")))

    def _body(self, n_mgrid):
        A, prec, x, r = self.A, self.prec, self.x, self.r
        for _ in range(self.n_inner):
            s = prec(r)
            s = self._smooth(n_mgrid, s)
            alpha, As = _proj_along(A, s, r)
            x = x + s * alpha
            r = r - As * alpha
            s2 = r / (_EPS + r.abs().max())
            alpha, As = _proj_along(A, s2, r)
            x = x + s2 * alpha
            r = r - As * alpha
        self.x.copy_(x)
        self.r.copy_(r)
        self._carry(torch.sqrt(_dot(r, r)))

    def _carry(self, nr):
        self.pred.copy_(nr >= self.stop)
        self.ratio.copy_(nr / (self.nr0 + _EPS))


def solve(
    A: Linearization,
    b,
    prec: PIPreconditioner,
    *,
    n_iter: int = 100,
    n_inner: int = 1,
    rtol: float = 1e-2,
    atol: float = 1e-7,
    multigrid=None,
):
    """Two-direction minimal-residual descent with block-diagonal
    preconditioning and optional coarsest-to-finest multigrid cycling
    (reference ``src/point_implicit.jl:250-329``).

    Returns (x, |r| / |r0|), the ratio a 0-dim tensor on b's device.
    Runs eagerly; `point_implicit_step` keeps its solve captured on the
    card.
    """
    b = torch.as_tensor(b)
    sl = SolveLoop(b, n_iter=n_iter, n_inner=n_inner, rtol=rtol, atol=atol,
                   multigrid=multigrid)
    sl.A, sl.prec = A, prec
    sl.loop()
    return sl.x.clone(), sl.ratio.clone()
