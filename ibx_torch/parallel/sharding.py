"""Multi-device execution on the generic gather path (counterpart of
`ibx/parallel/sharding.py`).

The JAX package runs one program over a 1-D device mesh with
``shard_map``; here each partition is one rank of a `torch.distributed`
process group, and every rank runs the same Python over its own tensors
(SPMD). A residual evaluation on rank p:

  1. slices the cells its ring-offset-``o`` neighbour needs out of its
     owned block (static per-offset ``send_idx_pp`` tables),
  2. moves every send buffer with one ``batch_isend_irecv`` (one isend and
     one irecv per active ring offset: traffic is bounded by the skirt
     size, not by an all-gather of everything),
  3. gathers its skirt rows out of the received buffers (static
     ``skirt_src`` table) and concatenates them after its owned rows,
  4. runs the user function on the domain-shaped local block,
  5. keeps the owned rows (the first ``n_own``).

The host tables (offsets, send tables, skirt table) are the JAX package's
numpy, verbatim, computed for every rank; each rank puts only its own rows
on its device. Padding across ranks (the JAX package's stacked tables) is
a ``shard_map`` artifact and is not carried: rank p's partition and
boundaries are ``dom.partition(p)`` and ``dom.boundaries[name][p]``.
Global reductions (CFL minima, norms, integrals) are ``all_reduce`` calls
on device tensors.

`DeviceMesh` is the mesh: rank, world size, device, backend and group of
the initialised default process group. The backend is the caller's
choice: ``nccl`` for CUDA tensors, ``gloo`` for CPU tensors, and ``gloo``
with CUDA tensors (several ranks on one card, which NCCL refuses) stages
every exchange and reduction through host tensors. Nothing falls back:
a missing process group, or a backend that cannot take the device,
raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.operators import Partition
from ..ops.stencil import take_rows
from ..topology.domain import Boundary, Domain, require_device
from ..utils.graphs import Graphs


class _Pending:
    """Receive buffers of a started exchange; `wait` returns them on the
    mesh's device once every transfer has landed."""

    def __init__(self, works, recv, keep, device, staged: bool):
        self._works, self._recv, self._keep = works, recv, keep
        self._device, self._staged = device, staged

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._keep = None
        if self._staged:
            return [r.to(self._device) for r in self._recv]
        return self._recv


@dataclasses.dataclass
class DeviceMesh:
    """A 1-D mesh of ``world_size`` ranks; this process is ``rank``.

    ``backend`` and ``group`` are those of the process group the
    collectives run on; a mesh built by hand with ``backend=None`` serves
    the host tables only (a test builds every rank's tables in one
    process this way) and raises on any collective."""

    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None
    group: Optional[object] = None

    @property
    def staged(self) -> bool:
        """Collectives go through host tensors (gloo with CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _require_group(self) -> None:
        if self.backend is None:
            raise RuntimeError("DeviceMesh: this mesh has no process group "
                               "(built for host tables only)")

    def all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` reduced over the ranks by ``op`` ("min", "max" or
        "sum"), as a new tensor on the mesh's device; no host read unless
        the mesh is staged."""
        if self.world_size == 1:
            return x
        self._require_group()
        t = x.detach().cpu().clone() if self.staged else x.detach().clone()
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()),
                        group=self.group)
        return t.to(self.device) if self.staged else t

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (equal shapes), in rank order."""
        if self.world_size == 1:
            return [x]
        self._require_group()
        src = x.detach().contiguous()
        if self.staged:
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(out, src, group=self.group)
        return [o.to(self.device) for o in out] if self.staged else out

    def exchange_start(self, sends: Sequence[Tuple[torch.Tensor, int, int]]
                       ) -> _Pending:
        """Start one batched point-to-point exchange: for each ``(buf,
        dst, src)`` send ``buf`` to rank ``dst`` and receive a buffer of
        the same shape from rank ``src`` (one isend and one irecv an
        entry, tagged by its position)."""
        if not sends:
            return _Pending([], [], None, self.device, False)
        self._require_group()
        ops, recv, keep = [], [], []
        for i, (buf, dst, src) in enumerate(sends):
            buf = buf.contiguous()
            if self.staged:
                buf = buf.cpu()
            r = torch.empty_like(buf)
            keep.append(buf)
            recv.append(r)
            ops.append(dist.P2POp(dist.isend, buf, dst, self.group, i))
            ops.append(dist.P2POp(dist.irecv, r, src, self.group, i))
        works = dist.batch_isend_irecv(ops)
        return _Pending(works, recv, keep, self.device, self.staged)


def make_device_mesh(n_devices: Optional[int] = None, *,
                     device=None) -> DeviceMesh:
    """The 1-D mesh of the initialised default process group.

    ``n_devices`` (if given) must equal the group's world size. ``device``
    defaults to CUDA under ``nccl`` and to the CPU under ``gloo``; a CUDA
    device without an index takes ``LOCAL_RANK`` (or the rank) modulo the
    visible cards. ``nccl`` refuses CPU tensors here; ``gloo`` with a CUDA
    device is the staged mesh. Raises when no process group exists."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_device_mesh: no torch.distributed process group is "
            "initialised (launch with ibx_torch.parallel.spawn or torchrun "
            "and call init_process_group first)")
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = str(dist.get_backend())
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_device_mesh: asked for {n_devices} devices, "
                         f"the process group has {world} ranks")
    if device is None:
        device = "cuda" if backend == "nccl" else "cpu"
    device = require_device("make_device_mesh", device)
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
        if backend == "nccl":
            torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("make_device_mesh: the nccl backend takes CUDA "
                         "tensors only (use gloo for the CPU)")
    return DeviceMesh(rank=rank, world_size=world, device=device,
                      backend=backend, group=dist.group.WORLD)


class _Ctx:
    """What a sharded function sees of its rank (see ``shard_fn``)."""


class ShardedDomain:
    """One rank's share of a multi-partition `Domain`: partition
    ``mesh.rank`` with its halo tables on ``mesh.device``.

    Host attributes hold every rank's tables as the JAX package computes
    them (``offsets``, ``send_idx_pp`` as one [P, S_o] array an offset,
    ``skirt_src`` [P, max skirt] zero-padded); the device holds this
    rank's rows."""

    def __init__(self, dom: Domain, mesh: DeviceMesh):
        P = dom.n_partitions
        if mesh.world_size != P:
            raise ValueError(f"mesh has {mesh.world_size} ranks, domain has "
                             f"{P} partitions")
        self.dom, self.mesh = dom, mesh
        # the captured steps of the marches built on this domain
        self._graphs = Graphs()
        self.n_partitions = P
        self.n_own = dom.n_own
        self.ncells = dom.ncells
        self.nd = dom.nd
        self.n_dom = max(d.size for d in dom.part_domain)

        # ---- halo tables (verbatim numpy of the JAX package) --------------
        pair_rows: Dict[tuple, np.ndarray] = {}
        for p in range(P):
            skirt = np.asarray(dom.part_domain[p][self.n_own:])
            qs = skirt // self.n_own
            for q in np.unique(qs):
                sel = skirt[qs == q] - int(q) * self.n_own
                pair_rows[(int(q), p)] = np.unique(sel)

        offsets = sorted({(p - q) % P for (q, p) in pair_rows})
        # A skirt row is by construction owned by a DIFFERENT partition, so
        # offset 0 can never carry traffic; its appearance would mean the
        # skirt tables are broken.
        assert 0 not in offsets, "skirt table maps a row to its own partition"
        send_idx_pp: List[np.ndarray] = []
        base: List[int] = []
        pos_maps: List[List[dict]] = []
        slot0 = 0
        for o in offsets:
            rows = [pair_rows.get((q, (q + o) % P), np.empty(0, np.int64))
                    for q in range(P)]
            S_o = max(1, max(r.size for r in rows))
            idx_o = np.zeros((P, S_o), dtype=np.int32)
            pos_o = []
            for q, r in enumerate(rows):
                idx_o[q, : r.size] = r
                pos_o.append({int(l): i for i, l in enumerate(r)})
            send_idx_pp.append(idx_o)
            pos_maps.append(pos_o)
            base.append(slot0)
            slot0 += S_o
        self.offsets = tuple(offsets)
        self.send_idx_pp = send_idx_pp

        skirt_src = np.zeros((P, self.n_dom - self.n_own), dtype=np.int32)
        off_slot = {o: i for i, o in enumerate(offsets)}
        for p in range(P):
            skirt = dom.part_domain[p][self.n_own:]
            for j, g in enumerate(skirt):
                q = int(g) // self.n_own
                l = int(g) - q * self.n_own
                i = off_slot[(p - q) % P]
                skirt_src[p, j] = base[i] + pos_maps[i][q][l]
        self.skirt_src = skirt_src

        # ---- this rank's rows on its device -------------------------------
        p, dev = mesh.rank, mesh.device
        self.n_skirt = dom.part_domain[p].size - self.n_own
        self._send_idx = [torch.as_tensor(s[p].astype(np.int64), device=dev)
                          for s in send_idx_pp]
        self._skirt_src = torch.as_tensor(
            skirt_src[p, :self.n_skirt].astype(np.int64), device=dev)
        self.part: Partition = dom.partition(p).to(dev)
        self._boundaries = {name: blocks[p].to(dev)
                            for name, blocks in dom.boundaries.items()}

    # ---- state layout -----------------------------------------------------

    def distribute(self, a) -> torch.Tensor:
        """Global [N, ...] -> this rank's own rows [n_own, ...] on its
        device (the last rank's pad rows zero). float64 input becomes
        float32."""
        a = torch.as_tensor(a, device=self.mesh.device)
        if a.dtype == torch.float64:
            a = a.float()
        lo = self.mesh.rank * self.n_own
        own = a[lo: lo + self.n_own]
        pad = self.n_own - own.shape[0]
        if pad:
            own = torch.cat([own, own.new_zeros((pad,) + own.shape[1:])])
        return own.contiguous()

    def collect(self, a_own: torch.Tensor) -> np.ndarray:
        """Every rank's own rows -> global numpy [N, ...] (a collective:
        every rank calls it and gets the whole)."""
        g = torch.cat(self.mesh.all_gather(a_own), dim=0)
        return g[: self.ncells].cpu().numpy()

    # ---- halo exchange ----------------------------------------------------

    def refresh(self, u_own: torch.Tensor) -> torch.Tensor:
        """Halo exchange: owned block [n_own, ...] -> domain block
        [n_dom, ...] of this rank. Receiver p hears offset o's buffer from
        rank (p - o) mod P; the received buffers are concatenated and
        re-indexed into skirt order by ``skirt_src``."""
        P, p = self.n_partitions, self.mesh.rank
        sends = [(take_rows(u_own, idx), (p + o) % P, (p - o) % P)
                 for o, idx in zip(self.offsets, self._send_idx)]
        bufs = self.mesh.exchange_start(sends).wait()
        if not bufs:
            return u_own[: self.n_own]
        allbuf = bufs[0] if len(bufs) == 1 else torch.cat(bufs, dim=0)
        return torch.cat([u_own[: self.n_own],
                          take_rows(allbuf, self._skirt_src)], dim=0)

    # ---- execution --------------------------------------------------------

    def shard_fn(self, f):
        """Wrap ``f(ctx, *domain_arrays) -> domain arrays`` into a function
        of this rank's own rows.

        ``ctx`` has ``part`` (this rank's `Partition`), ``boundary(name)``,
        ``refresh(a)`` (re-exchange halos mid-function, e.g. between BC
        families), ``own_mask`` and the collectives ``pmin``, ``pmax``,
        ``psum``. The returned function takes and returns own-row tensors
        ``[n_own, ...]``, always as a tuple."""
        ctx = _Ctx()
        ctx.part = self.part
        ctx.boundary = lambda name: self._boundaries[name]
        ctx.refresh = self.refresh
        ctx.own_mask = self.part.own_mask
        mesh = self.mesh
        ctx.pmin = lambda x: mesh.all_reduce(x, "min")
        ctx.pmax = lambda x: mesh.all_reduce(x, "max")
        ctx.psum = lambda x: mesh.all_reduce(x, "sum")

        def call(*u_own):
            res = f(ctx, *[self.refresh(u) for u in u_own])
            if not isinstance(res, (tuple, list)):
                res = (res,)
            return tuple(r[: self.n_own] for r in res)

        return call


def sharded_impose_bc(ctx, bdry: Boundary, fn, *dargs, **kwargs):
    """Ghost-cell BC on domain-local arrays inside a sharded function: the
    counterpart of `Domain.impose_bc` (eta blend, one unique-row
    write-back with `index_copy`). A rank without ghosts of this family
    returns its arrays unchanged."""
    if bdry.n_ghost == 0:
        return dargs[0] if len(dargs) == 1 else tuple(dargs)
    iargs = [bdry.interp(a) for a in dargs]
    res = fn(bdry, *iargs, **kwargs)
    if not isinstance(res, (tuple, list)):
        res = (res,)
    outs = []
    for a, ia, ba in zip(dargs, iargs, res):
        eta = bdry.eta.reshape(bdry.eta.shape + (1,) * (ia.dim() - 1))
        gv = eta * ia + (1.0 - eta) * ba
        outs.append(a.index_copy(0, bdry.ghost, gv))
    return outs[0] if len(outs) == 1 else tuple(outs)
