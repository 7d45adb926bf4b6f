"""Sharded block march: spatial decomposition by octree block (counterpart
of `ibx/parallel/block_sharding.py`).

Design (the JAX package's, on `torch.distributed` ranks):
  * blocks are assigned to ranks in contiguous block-major chunks (the
    cell ordering is an octree space-filling order, so chunks are spatially
    coherent);
  * each rank's halo = the blocks of the cell-level 2-ring closure of its
    own chunk plus the blocks holding BC image stencils of its own ghosts
    (whole blocks, so the rank's `BlockTables` see complete face sets for
    every own block and the dense/2:1 classification matches the global
    one);
  * halo exchange = one batched isend/irecv over the distinct partition
    offsets (receiver p hears offset o from rank p + o): traffic is only
    what each neighbour pair needs;
  * each rank runs the block RHS on its local grid ``[chunk own | halo
    slots | 1 dump]`` and keeps its own rows; halo-block results are
    garbage (their far neighbours are absent) and are discarded;
  * ghost BCs run per rank on own-block ghosts in the local flat index
    space (stencils live in own + halo by construction).

Padding invariants (the JAX package's local layout, kept so that a rank's
`build_block_tables_raw` inputs and outputs equal that package's row for
it): pad own slots replicate block 0 and carry ``active = 0``; pad halo
slots receive real (unreferenced) data; the dump block (last slot) is
``own[:1]``. The host tables are computed for every rank with the JAX
package's numpy; each rank builds and uploads only its own block tables.
Stacking across ranks is a ``shard_map`` artifact and is not carried.

``overlap=True`` (with more than one rank) also builds the interior /
frontier split: the interior pass runs on own blocks only and needs no
halo, so the step starts the exchange, issues the interior pass, waits,
and runs the frontier pass on a compact subgrid of the halo-adjacent
blocks (the torch form of what XLA's latency-hiding scheduler does with
the JAX package's split).
"""

from __future__ import annotations

import inspect
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.kernels import STENCIL_BLOCK_SIZES
from ..topology.blocked_bc import local_ghost_bc
from ..topology.blocks import BlockTables, build_block_tables_raw
from ..topology.domain import Domain
from ..utils.graphs import Graphs
from ..utils.monitor import device_span
from .sharding import DeviceMesh, _Ctx


def _expand2(m: np.ndarray, eo: np.ndarray, en: np.ndarray) -> np.ndarray:
    """The cell mask grown twice across the interior faces (eo, en)."""
    m = m.copy()
    for _ in range(2):
        add_n = en[m[eo]]
        add_o = eo[m[en]]
        m[add_n] = True
        m[add_o] = True
    return m


def _subset_inputs(dom: Domain, glob_blocks: np.ndarray, B_sub: int) -> dict:
    """`build_block_tables_raw` inputs over an arbitrary global-block
    subset mapped to rows 0..n-1 (pad rows inert: no faces, unit-size
    cells; the rows after the subset hold no block)."""
    msh = dom.mesh
    bs, nd = int(msh.block_size), msh.ndim
    npb, B = bs ** nd, msh.n_blocks
    fo = dom.face_owner.astype(np.int64)
    fn = dom.face_neighbor.astype(np.int64)
    n_real = glob_blocks.size
    g2s = np.full(B, -1, np.int64)
    g2s[glob_blocks] = np.arange(n_real)
    fob = np.where(fo >= 0, g2s[np.maximum(fo // npb, 0)], -2)
    fnb = np.where(fn >= 0, g2s[np.maximum(fn // npb, 0)], -2)
    keep = ((fo < 0) | (fob >= 0)) & ((fn < 0) | (fnb >= 0)) \
        & ~((fo < 0) & (fn < 0))
    lfo = np.where(fo[keep] >= 0, fob[keep] * npb + fo[keep] % npb, -1)
    lfn = np.where(fn[keep] >= 0, fnb[keep] * npb + fn[keep] % npb, -1)
    w_loc = np.ones((B_sub * npb, nd), np.float32)
    c_loc = np.zeros((B_sub * npb, nd), np.float32)
    src_c = (glob_blocks[:, None] * npb
             + np.arange(npb)[None, :]).reshape(-1)
    dst_c = np.arange(n_real * npb)
    w_loc[dst_c] = dom.widths[src_c]
    c_loc[dst_c] = dom.centers[src_c]
    borig = np.zeros((B_sub, nd), np.float64)
    bwid = np.full((B_sub, nd), float(bs), np.float64)
    borig[:n_real] = msh.block_origins[glob_blocks]
    bwid[:n_real] = msh.block_widths[glob_blocks]
    return dict(nd=nd, bs=bs, B=B_sub, fdim=dom.face_dim[keep], fo=lfo,
                fn=lfn, widths=w_loc, centers=c_loc, block_origins=borig,
                block_widths=bwid)


class _LocalGrid:
    """A started halo exchange of own grids; `wait` gives the local grid
    [own | halo slots | dump], the dump block (finite, inert) last, and
    closes the exchange's ``march.halo`` device span (``halo``, entered
    where the exchange started)."""

    def __init__(self, own, pending, halo):
        self._own, self._pending, self._halo = own, pending, halo

    def wait(self):
        own = self._own
        local = torch.cat([own] + self._pending.wait() + [own[:1]], dim=0)
        self._halo.__exit__(None, None, None)
        return local


class ShardedBlockDomain:
    """One rank's share of the sharded block march: its local block
    tables, ghost BC and halo exchange on ``mesh.device``.

    Host attributes hold every rank's tables as the JAX package computes
    them: ``chunk``, ``halo`` (global halo blocks a rank), ``offs``,
    ``S`` (slots an offset), ``send_idx`` ({o: [P, S_o]}), ``l2g`` ([P,
    B_loc], -1 on pad slots), ``B_loc``; with ``overlap``, ``sub_src``,
    ``fr_idx``, ``fr_mask`` and the subsets ``own_blocks(p)`` /
    ``sub_blocks[p]``. `local_inputs(p)` and `local_bc_tables(p)` give any
    rank's `build_block_tables_raw` inputs and ``ctx.bc`` tables."""

    def __init__(self, dom: Domain, mesh: DeviceMesh, *,
                 overlap: bool = False, bc_names: Sequence[str] = None,
                 dense_families=None):
        """``bc_names``: build this rank's `GhostBC` for these families
        (``ctx.bbc`` / ``ctx.bbc_cs``); the per-ghost gather ``ctx.bc``
        is there regardless, for callbacks that take the image distances.
        ``dense_families`` is accepted and ignored (`GhostBC.from_numpy`)."""
        assert dom.n_partitions == 1, "build from a single-partition Domain"
        msh = dom.mesh
        self.dom, self.mesh = dom, mesh
        # the captured steps of the marches built on this domain
        self._graphs = Graphs()
        P = int(mesh.world_size)
        self.P = P
        bs = int(msh.block_size)
        nd = msh.ndim
        npb = bs ** nd
        B = msh.n_blocks
        self.bs, self.nd, self.npb, self.B = bs, nd, npb, B
        chunk = -(-B // P)
        self.chunk = chunk

        fo = dom.face_owner.astype(np.int64)
        fn = dom.face_neighbor.astype(np.int64)

        owner = lambda b: np.minimum(b // chunk, P - 1)  # noqa: E731
        self._owner = owner

        # ---- halo sets --------------------------------------------------
        # The RHS stencil at an own cell reaches 2 cells deep across the
        # face graph (pass B consumes the JST sensor and the gradients AT
        # the neighbour cell, which pass A computes from that cell's own
        # face neighbours: one block ring gave 7.5e-4 sharded-vs-single
        # error from a shocked state). The exact halo is the cell-level
        # 2-ring closure: the face-neighbour blocks plus the corner blocks
        # the 2-hop lateral paths touch.
        N = B * npb
        interior = (fo >= 0) & (fn >= 0)
        eo = fo[interior]
        en = fn[interior]
        need: List[set] = [set() for _ in range(P)]
        for p in range(P):
            lo, hi = p * chunk, min((p + 1) * chunk, B)
            m = np.zeros(N, bool)
            m[lo * npb: hi * npb] = True
            m = _expand2(m, eo, en)
            need[p].update(np.unique(np.nonzero(m)[0] // npb).tolist())
        for hb in dom._host_boundaries.values():
            gdev = owner(hb.ghosts // npb)
            sblk = hb.interp_idx // npb
            for p in range(P):
                sel = sblk[gdev == p]
                need[p].update(sel.reshape(-1).tolist())
        halo = []
        for p in range(P):
            lo, hi = p * chunk, min((p + 1) * chunk, B)
            halo.append(sorted(b for b in need[p] if not (lo <= b < hi)))
        self.halo = halo

        # ---- exchange offsets + send tables ------------------------------
        offs = sorted({
            int((int(owner(np.int64(b))) - p) % P)
            for p in range(P) for b in halo[p]
        })
        self.offs = offs
        # o = (owner - receiver) mod P: receiver p's offset-o halo comes
        # FROM rank (p + o) % P; send[o][p] = what p sends to (p - o) % P
        send: Dict[int, List[np.ndarray]] = {}
        S = {}
        for o in offs:
            send[o] = []
            for p in range(P):
                q = (p - o) % P
                lo, hi = p * chunk, min((p + 1) * chunk, B)
                blocks = np.asarray(
                    [b for b in halo[q] if lo <= b < hi], np.int64)
                send[o].append(blocks)
            S[o] = max(1, max(s.size for s in send[o]))
        self.S = S
        B_loc = chunk + sum(S[o] for o in offs) + 1
        self.B_loc = B_loc
        self.n_loc = B_loc * npb

        # ---- local block maps -------------------------------------------
        l2g = np.full((P, B_loc), -1, np.int64)
        send_idx = {o: np.zeros((P, S[o]), np.int32) for o in offs}
        for p in range(P):
            lo, hi = p * chunk, min((p + 1) * chunk, B)
            l2g[p, : hi - lo] = np.arange(lo, hi)
            base = chunk
            for o in offs:
                src = (p + o) % P
                blocks = send[o][src]
                l2g[p, base: base + blocks.size] = blocks
                send_idx[o][src, : blocks.size] = (
                    blocks - src * chunk).astype(np.int32)
                base += S[o]
        self.l2g = l2g
        self.send_idx = send_idx

        # ---- this rank's tables on its device ----------------------------
        p, dev = mesh.rank, mesh.device
        g2l = self.g2l(p)
        self.bt = BlockTables.from_numpy(
            build_block_tables_raw(**self.local_inputs(p)), dev)
        bcl = self.local_bc_tables(p)
        self._bc = dict(
            ghost=torch.as_tensor(bcl["ghost"], device=dev),
            idx=torch.as_tensor(bcl["idx"].astype(np.int64), device=dev),
            w=torch.as_tensor(bcl["w"], device=dev),
            eta=torch.as_tensor(bcl["eta"], device=dev),
            normals=torch.as_tensor(bcl["normals"], device=dev),
            family=torch.as_tensor(bcl["family"].astype(np.int64),
                                   device=dev),
            imd=torch.as_tensor(bcl["imd"], device=dev))
        self._send_dev = {o: torch.as_tensor(send_idx[o][p].astype(np.int64),
                                             device=dev) for o in offs}
        self.bbc = None
        if bc_names is not None:
            own_of_block = np.minimum(np.arange(B) // chunk, P - 1)
            self.bbc = local_ghost_bc(dom, bc_names, own_of_block, g2l, p,
                                      dev, dense_families=dense_families)

        # ---- interior/frontier overlap split -----------------------------
        self.overlap = bool(overlap) and P > 1
        if self.overlap:
            sub_blocks, fr_blocks = [], []
            for q in range(P):
                lo, hi = q * chunk, min((q + 1) * chunk, B)
                O = set(range(lo, hi))
                H = set(halo[q])
                # frontier = own blocks whose (2-cell-deep) RHS stencil
                # leaves the own cell range
                m = np.ones(N, bool)
                m[lo * npb: hi * npb] = False
                F = set(np.unique(np.nonzero(_expand2(m, eo, en))[0]
                                  // npb).tolist()) & O
                # subgrid = 2-cell-deep support of the frontier blocks,
                # restricted to locally present blocks
                m = np.zeros(N, bool)
                for b in F:
                    m[b * npb: (b + 1) * npb] = True
                Sq = set(np.unique(np.nonzero(_expand2(m, eo, en))[0]
                                   // npb).tolist()) & (O | H)
                fr_blocks.append(F)
                sub_blocks.append(np.asarray(sorted(Sq), np.int64))
            S_max = max(1, max(s.size for s in sub_blocks))
            self.sub_blocks = sub_blocks
            self.B_own_loc = chunk + 1
            self.B_sub_loc = S_max + 1
            sub_src = np.full((P, S_max + 1), B_loc - 1, np.int32)
            fr_idx = np.full((P, chunk), S_max, np.int32)
            fr_mask = np.zeros((P, chunk), np.float32)
            for q in range(P):
                lo = q * chunk
                Sq = sub_blocks[q]
                gq = self.g2l(q)
                assert (gq[Sq] >= 0).all(), "subgrid escaped the local grid"
                sub_src[q, : Sq.size] = gq[Sq]
                g2s = np.full(B, -1, np.int64)
                g2s[Sq] = np.arange(Sq.size)
                for b in fr_blocks[q]:
                    fr_idx[q, b - lo] = g2s[b]
                    fr_mask[q, b - lo] = 1.0
            self.sub_src, self.fr_idx, self.fr_mask = sub_src, fr_idx, fr_mask
            self.bt_own = BlockTables.from_numpy(build_block_tables_raw(
                **_subset_inputs(dom, self.own_blocks(p), chunk + 1)), dev)
            self.bt_sub = BlockTables.from_numpy(build_block_tables_raw(
                **_subset_inputs(dom, sub_blocks[p], S_max + 1)), dev)
            self._sub_src = torch.as_tensor(sub_src[p].astype(np.int64),
                                            device=dev)
            self._fr_idx = torch.as_tensor(fr_idx[p].astype(np.int64),
                                           device=dev)
            self._fr_mask = torch.as_tensor(fr_mask[p], device=dev)

    # -- host tables of any rank --------------------------------------------

    def g2l(self, p: int) -> np.ndarray:
        """Global block -> rank p's local slot (-1 where absent)."""
        g2l = np.full(self.B, -1, np.int64)
        real = self.l2g[p] >= 0
        g2l[self.l2g[p][real]] = np.nonzero(real)[0]
        return g2l

    def own_blocks(self, p: int) -> np.ndarray:
        lo, hi = p * self.chunk, min((p + 1) * self.chunk, self.B)
        return np.arange(lo, hi, dtype=np.int64)

    def local_inputs(self, p: int) -> dict:
        """Rank p's `build_block_tables_raw` inputs over its ``B_loc``
        local slots."""
        dom, msh = self.dom, self.dom.mesh
        bs, nd, npb, B_loc = self.bs, self.nd, self.npb, self.B_loc
        fo = dom.face_owner.astype(np.int64)
        fn = dom.face_neighbor.astype(np.int64)
        g2l = self.g2l(p)
        real = self.l2g[p] >= 0
        fob = np.where(fo >= 0, g2l[np.maximum(fo // npb, 0)], -2)
        fnb = np.where(fn >= 0, g2l[np.maximum(fn // npb, 0)], -2)
        keep = ((fo < 0) | (fob >= 0)) & ((fn < 0) | (fnb >= 0)) \
            & ~((fo < 0) & (fn < 0))
        lfo = np.where(fo[keep] >= 0, fob[keep] * npb + fo[keep] % npb, -1)
        lfn = np.where(fn[keep] >= 0, fnb[keep] * npb + fn[keep] % npb, -1)
        w_loc = np.ones((B_loc * npb, nd), np.float32)
        c_loc = np.zeros((B_loc * npb, nd), np.float32)
        src = self.l2g[p][real]
        dst = np.nonzero(real)[0]
        cells_src = (src[:, None] * npb + np.arange(npb)[None, :]).reshape(-1)
        cells_dst = (dst[:, None] * npb + np.arange(npb)[None, :]).reshape(-1)
        w_loc[cells_dst] = dom.widths[cells_src]
        c_loc[cells_dst] = dom.centers[cells_src]
        borig = np.zeros((B_loc, nd), np.float64)
        bwid = np.full((B_loc, nd), float(bs), np.float64)
        borig[dst] = msh.block_origins[src]
        bwid[dst] = msh.block_widths[src]
        return dict(nd=nd, bs=bs, B=B_loc, fdim=dom.face_dim[keep], fo=lfo,
                    fn=lfn, widths=w_loc, centers=c_loc,
                    block_origins=borig, block_widths=bwid)

    def local_bc_tables(self, p: int) -> dict:
        """Rank p's ``ctx.bc`` tables: its own ghosts of every family
        (the last listed family wins a shared ghost, as the sequential
        ``impose_bc`` does), in local flat ids, sorted by ghost."""
        dom, npb, chunk = self.dom, self.npb, self.chunk
        owner, g2l = self._owner, self.g2l(p)
        claimed = {}
        for i, (name, hb) in enumerate(dom._host_boundaries.items()):
            for g in hb.ghosts:
                claimed[int(g)] = i
        gl, il, wl, el, nl, fl, dl = [], [], [], [], [], [], []
        for i, (name, hb) in enumerate(dom._host_boundaries.items()):
            keep = np.array([claimed[int(g)] == i for g in hb.ghosts], bool)
            sel = (owner(hb.ghosts // npb) == p) & keep
            if not sel.any():
                continue
            g = hb.ghosts[sel]
            gi = hb.interp_idx[sel]
            assert (g2l[g // npb] >= 0).all()
            assert (g2l[gi // npb] >= 0).all(), \
                "BC stencil escaped the halo block set"
            gl.append(g2l[g // npb] * npb + g % npb)
            il.append(g2l[gi // npb] * npb + gi % npb)
            wl.append(hb.interp_w[sel])
            el.append(hb.ghost_distances[sel] / hb.image_distances[sel])
            nl.append(hb.normals[sel])
            fl.append(np.full(int(sel.sum()), i, np.int32))
            dl.append(hb.image_distances[sel])
        if not gl:
            return dict(ghost=np.zeros(0, np.int64),
                        idx=np.zeros((0, 1), np.int32),
                        w=np.zeros((0, 1), np.float32),
                        eta=np.zeros(0, np.float32),
                        normals=np.zeros((0, self.nd), np.float32),
                        family=np.zeros(0, np.int32),
                        imd=np.zeros(0, np.float32))
        K = max(a.shape[1] for a in il)

        def padk(a, rep):
            if a.shape[1] == K:
                return a
            fill = a[:, :1] if rep else np.zeros_like(a[:, :1])
            return np.concatenate([a] + [fill] * (K - a.shape[1]), axis=1)

        g = np.concatenate(gl)
        order = np.argsort(g)
        assert (g[order][np.nonzero(np.diff(g[order]) == 0)].size == 0)
        out = dict(
            ghost=g[order].astype(np.int64),
            idx=np.concatenate([padk(a, True) for a in il])[order]
            .astype(np.int32),
            w=np.concatenate([padk(a, False) for a in wl])[order]
            .astype(np.float32),
            eta=np.concatenate(el)[order].astype(np.float32),
            normals=np.concatenate(nl)[order].astype(np.float32),
            family=np.concatenate(fl)[order],
            imd=np.concatenate(dl)[order].astype(np.float32),
        )
        assert (out["ghost"] < chunk * npb).all(), \
            "own ghosts must live in own blocks"
        return out

    # -- channel-split layout helpers ----------------------------------------

    def cs_eligible(self) -> bool:
        """Every rank's local grid admits the channel-split kernel march:
        nd = 3 and a block size the pass-A and pass-B kernels take (4, 8
        or 16, `kernels.STENCIL_BLOCK_SIZES`). The JAX package's gate asks
        for 8 or 16, its TPU kernels' tilings, and for no generic sparse
        leftover face on any device; a rank's local grid has such faces
        where a halo block's neighbours are only partly present (a coarse
        block beside fine blocks of which some lie beyond the halo: 3,456
        to 6,656 a rank on the wall_h=0.1 sphere over 4 ranks), and
        `rhs_cs.euler_rhs_cs` adds them by torch ops around the kernels,
        so the port admits them. The JAX package's sharded sphere at that
        size takes its grid march."""
        return self.nd == 3 and self.bs in STENCIL_BLOCK_SIZES

    def _own_grids(self, a, pad_mode: str):
        """Global flat [N, ...] -> this rank's own grids [chunk, bs..,
        ...] ('edge': pad slots replicate block 0; 'zero')."""
        a = torch.as_tensor(a, device=self.mesh.device)
        if a.dtype == torch.float64:
            a = a.float()
        grids = a.reshape((self.B,) + (self.bs,) * self.nd + a.shape[1:])
        lo = self.mesh.rank * self.chunk
        own = grids[lo: lo + self.chunk]
        padn = self.chunk - own.shape[0]
        if padn:
            fill = (grids[:1].expand((padn,) + grids.shape[1:])
                    if pad_mode == "edge"
                    else grids.new_zeros((padn,) + grids.shape[1:]))
            own = torch.cat([own, fill], dim=0)
        return own

    def distribute_cs(self, a, pad_mode: str = "edge"):
        """Global flat [N, C] -> this rank's own channel-split grids
        [chunk, C, bs, bs**(nd-1)]."""
        own = self._own_grids(a, pad_mode)
        perm = (0, self.nd + 1) + tuple(range(1, self.nd + 1))
        return own.permute(perm).reshape(
            self.chunk, own.shape[-1], self.bs,
            self.npb // self.bs).contiguous()

    def collect_cs(self, a_own) -> np.ndarray:
        """Every rank's own cs grids -> global flat numpy [N, C] (a
        collective)."""
        C = a_own.shape[1]
        g = torch.cat(self.mesh.all_gather(a_own), dim=0)
        g = g.reshape((self.P * self.chunk, C) + (self.bs,) * self.nd)
        perm = (0,) + tuple(range(2, self.nd + 2)) + (1,)
        flat = g.permute(perm).reshape(-1, C)
        return flat[: self.B * self.npb].cpu().numpy()

    # -- state layout ------------------------------------------------------

    def distribute(self, a, pad_mode: str = "edge"):
        """Global flat [N, ...] -> this rank's own grids [chunk, bs..,
        ...]. ``pad_mode``: 'edge' replicates block 0 into pad slots
        (finite flow state); 'zero' for masks."""
        return self._own_grids(a, pad_mode).contiguous()

    def collect(self, a_own) -> np.ndarray:
        """Every rank's own grids -> global flat numpy [N, ...] (a
        collective)."""
        g = torch.cat(self.mesh.all_gather(a_own), dim=0)
        g = g.reshape((self.P * self.chunk * self.npb,)
                      + tuple(g.shape[1 + self.nd:]))
        return g[: self.B * self.npb].cpu().numpy()

    def distribute_local(self, a, fill=0.0):
        """Global flat [N, ...] -> this rank's LOCAL grids [B_loc, bs..,
        ...] with halo slots filled from their global blocks (pad and dump
        slots get ``fill``): static per-cell fields read inside the RHS
        (the TE fix blend), which need no exchange."""
        a = torch.as_tensor(a, device=self.mesh.device)
        if a.dtype == torch.float64:
            a = a.float()
        grids = a.reshape((self.B,) + (self.bs,) * self.nd + a.shape[1:])
        out = torch.full((self.B_loc,) + grids.shape[1:], fill,
                         dtype=grids.dtype, device=grids.device)
        l2g = self.l2g[self.mesh.rank]
        real = np.nonzero(l2g >= 0)[0]
        out[torch.as_tensor(real, device=out.device)] = grids[
            torch.as_tensor(l2g[real], device=out.device)]
        return out

    # -- execution ---------------------------------------------------------

    def exchange_start(self, own):
        """Start the halo exchange of own grids [chunk, ...]; the handle's
        ``wait()`` returns the local grid [B_loc, ...] = [own | halo slots
        | dump]. The device span ``march.halo`` runs from here to the
        end of ``wait()``."""
        P, p = self.P, self.mesh.rank
        halo = device_span("march.halo", own.device)
        halo.__enter__()
        # rank q sends to (q - o): receiver p hears from p + o
        sends = [(own.index_select(0, self._send_dev[o]), (p - o) % P,
                  (p + o) % P) for o in self.offs]
        return _LocalGrid(own, self.mesh.exchange_start(sends), halo)

    def exchange(self, own):
        """Own grids [chunk, ...] -> local grid [B_loc, ...]."""
        return self.exchange_start(own).wait()

    def bc(self, local, fns, guard=None):
        """Own-ghost update of the local grid by per-ghost gathers: image
        values, each family's callback (``fn(P_image, normals)``, or
        ``fn(P_image, normals, image_distances)`` for wall-model BCs), the
        eta blend, ``guard``, one write-back. Returns a new tensor."""
        t = self._bc
        C = local.shape[-1]
        flat = local.reshape(self.n_loc, C)
        if t["ghost"].shape[0] == 0:
            return local
        idx = t["idx"]
        Pi = (flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + (C,))
              * t["w"][..., None]).sum(dim=1)
        r = None
        for i, name in enumerate(fns):
            fn = fns[name]
            if len(inspect.signature(fn).parameters) >= 3:
                ri = fn(Pi, t["normals"], t["imd"])
            else:
                ri = fn(Pi, t["normals"])
            sel = (t["family"] == i)[:, None]
            r = ri if r is None else torch.where(sel, ri, r)
        eta = t["eta"][:, None]
        g = eta * Pi + (1.0 - eta) * r
        if guard is not None:
            g = guard(g)
        return flat.index_copy(0, t["ghost"], g).reshape(local.shape)

    def shard_fn(self, f, replicated=None):
        """Wrap ``f(ctx, *own_grids) -> own grids (or (grids, aux))`` into
        a function of this rank's own grids; it returns a tuple.

        ``ctx``: ``bt`` (local `BlockTables` over [chunk + halo + dump]
        blocks), ``exchange(own) -> local`` and ``exchange_start(own)``
        (its handle's ``wait()`` gives the local grid), ``own(local) ->
        own slice``, ``bc(local, fns, guard)``, ``bbc(local, fns, guard)``
        / ``bbc_cs(local_cs, fns, guard)`` (this rank's `GhostBC`, in
        place, with ``bc_names``), ``pmin`` / ``pmax`` / ``psum``,
        ``all_gather_flat`` and ``own_flat``, ``rep`` (``replicated``, as
        given: tensors every rank holds whole); with ``overlap``, also
        ``bt_own``, ``bt_sub``, ``with_dump``, ``subgrid`` and ``merge``.
        """
        sbd, mesh = self, self.mesh
        ctx = _Ctx()
        ctx.bt = self.bt
        ctx.exchange = self.exchange
        ctx.exchange_start = self.exchange_start
        ctx.bc = self.bc
        if self.bbc is not None:
            bbc = self.bbc
            ctx.bbc = (lambda local, fns, guard=None:
                       bbc.apply_grid(local, fns, guard=guard))
            ctx.bbc_cs = (lambda Pc, fns, guard=None:
                          bbc.apply_cs(Pc, fns, guard=guard))
        ctx.own = lambda loc: loc[: sbd.chunk]
        ctx.pmin = lambda x: mesh.all_reduce(x, "min")
        ctx.pmax = lambda x: mesh.all_reduce(x, "max")
        ctx.psum = lambda x: mesh.all_reduce(x, "sum")
        ctx.rep = {} if replicated is None else replicated

        def all_gather_flat(own):
            """Own grids [chunk, bs.., C] -> every rank's global flat
            [n_cells, C] (pad rows trimmed)."""
            g = torch.cat(mesh.all_gather(own), dim=0)
            flat = g.reshape((sbd.P * sbd.chunk * sbd.npb,)
                             + tuple(g.shape[1 + sbd.nd:]))
            return flat[: sbd.B * sbd.npb]

        def own_flat(flat):
            """Global flat [n_cells, ...] -> this rank's own grids
            [chunk, bs.., ...] (pad rows zero)."""
            pad = sbd.P * sbd.chunk * sbd.npb - sbd.B * sbd.npb
            if pad:
                flat = torch.cat([flat, flat.new_zeros(
                    (pad,) + tuple(flat.shape[1:]))], dim=0)
            grids = flat.reshape((sbd.P, sbd.chunk) + (sbd.bs,) * sbd.nd
                                 + tuple(flat.shape[1:]))
            return grids[mesh.rank]

        ctx.all_gather_flat = all_gather_flat
        ctx.own_flat = own_flat

        if self.overlap:
            # interior pass tables (own blocks + dump: no halo rows, so no
            # data dependence on the exchange) and frontier subgrid tables
            # (halo-adjacent own blocks + their 2-ring support, compacted)
            ctx.bt_own = self.bt_own
            ctx.bt_sub = self.bt_sub
            ctx.with_dump = lambda own: torch.cat([own, own[:1]], dim=0)
            ctx.subgrid = lambda loc: loc.index_select(0, sbd._sub_src)

            def merge(R_int, R_fr):
                """Interior results overwritten at frontier blocks."""
                Ri = R_int[: sbd.chunk]
                placed = R_fr.index_select(0, sbd._fr_idx)
                m = sbd._fr_mask.reshape((sbd.chunk,) + (1,) * (Ri.dim() - 1))
                return torch.where(m > 0, placed, Ri)

            ctx.merge = merge

        def call(*own):
            res = f(ctx, *own)
            if not isinstance(res, (tuple, list)):
                res = (res,)
            return tuple(res)

        return call
