"""Cut-cell wall metrics (host side, 2D): a verbatim numpy copy of the
JAX package's module (``tests/test_torch_host_build.py`` holds its tables
bit-equal to the original's).

FLAGGED DEVIATION from the reference wall treatment. The reference's
eta-blended ghost wall (``src/ImmersedBoundary.jl:1159-1247``) overwrites
the first fluid cell rows every step; at fine wall resolution the staircase
wall FLUXES manufacture a vortical pseudo-boundary-layer that sheds and
collapses the lift (quantified in BASELINE.md round 3: converged Cl falls
0.86 -> 0.65 between wall_h 1e-2 and 2.5e-3; every ghost-VALUE surgery
fails). The literature cure is a cut-cell wall: faces crossed by the
surface carry only their fluid-open fraction of the flux, and the wall
enters as an explicit pressure flux on the true (non-staircase) wall
geometry.

This module compiles the static cut geometry:

  * face apertures a in [0, 1] (fluid-open fraction of each face) from
    exact segment/polyline crossings;
  * cell fluid fractions alpha from exact Sutherland-Hodgman clipping of
    the wall polygon against the cell box;
  * per-cell wall vectors L_w * n_hat_w from the divergence-theorem
    closure  wall_vec = -sum_faces a * A * n_hat_out,  which makes the
    scheme watertight by construction (uniform flow parallel to a flat
    wall is an exact steady state, at any wall angle - the property the
    staircase wall lacks).

Faces between a solved cell and a frozen (center-in-solid) cell are
treated as fully closed (a = 0): their fluid sliver is absorbed into the
wall vector. Cells whose center is in the solid stay frozen; their small
fluid fractions are dropped (first-order local conservation error,
standard for non-merging cut-cell schemes).

The device-side corrections live in `ibx_torch.ops.block_ops.euler_rhs_grid`
(``cut3=`` argument): per-dim sparse removal of the solid-covered flux
fraction, the wall pressure term with a gradient-corrected wall pressure,
the 1/alpha volume scale and an alpha time-step scale.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree

from .stereolitography import Stereolitography


def _clip_polygon_to_box(poly: np.ndarray, lo, hi) -> float:
    """Area of (possibly nonconvex) polygon ``poly`` [M, 2] inside the
    axis box [lo, hi] (Sutherland-Hodgman against each box edge; the
    degenerate bridge edges S-H leaves for disconnected pieces cancel in
    the shoelace sum)."""
    P = poly
    for dim, bound, keep_low in ((0, lo[0], False), (0, hi[0], True),
                                 (1, lo[1], False), (1, hi[1], True)):
        if P.shape[0] < 3:
            return 0.0
        v = P[:, dim]
        inside = (v <= bound) if keep_low else (v >= bound)
        nxt = np.roll(np.arange(P.shape[0]), -1)
        out_pts = []
        Q = P[nxt]
        vin, vq = inside, inside[nxt]
        # vectorized edge intersections with the clip line
        denom = Q[:, dim] - P[:, dim]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(denom != 0, (bound - P[:, dim]) / denom, 0.0)
        X = P + t[:, None] * (Q - P)
        X[:, dim] = bound
        for i in range(P.shape[0]):
            if vin[i]:
                out_pts.append(P[i])
                if not vq[i]:
                    out_pts.append(X[i])
            elif vq[i]:
                out_pts.append(X[i])
        if len(out_pts) < 3:
            return 0.0
        P = np.asarray(out_pts)
    x, y = P[:, 0], P[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _face_aperture(p0, p1, inside0, segs) -> float:
    """Fluid-open fraction of the face segment p0 -> p1.

    ``inside0``: whether p0 lies inside the solid; ``segs`` [K, 2, 2]
    nearby wall segments. Crossing parities along the face flip the
    state at each proper intersection."""
    d = p1 - p0
    L2 = float(d @ d)
    if L2 == 0.0:
        return 0.0 if inside0 else 1.0
    ts = []
    for (a, b) in segs:
        e = b - a
        den = d[0] * e[1] - d[1] * e[0]
        if den == 0.0:
            continue
        w = a - p0
        t = (w[0] * e[1] - w[1] * e[0]) / den
        s = (w[0] * d[1] - w[1] * d[0]) / den
        if 0.0 <= s < 1.0 and 0.0 < t < 1.0:
            ts.append(t)
    if not ts:
        return 0.0 if inside0 else 1.0
    ts = np.sort(np.asarray(ts))
    # walk intervals, alternating the inside state
    bounds = np.concatenate([[0.0], ts, [1.0]])
    state = bool(inside0)
    open_len = 0.0
    for i in range(bounds.size - 1):
        if not state:
            open_len += bounds[i + 1] - bounds[i]
        state = not state
    return float(open_len)


def fluid_fractions_2d(
    stl: Stereolitography,
    dfield,
    centers: np.ndarray,
    widths: np.ndarray,
    inside: np.ndarray,
) -> np.ndarray:
    """Exact cell fluid fractions alpha in [0, 1] against a closed
    polyline (Sutherland-Hodgman clipping near the wall; away from it,
    0 for ``inside`` cells and 1 otherwise).

    The solved set of the cut-cell scheme is ``alpha > alpha_floor`` —
    INCLUDING cells whose center lies inside the solid. Freezing
    center-in-solid cut cells would close their faces along the Cartesian
    grid and rebuild exactly the staircase wall the scheme exists to
    remove (measured: O(1) spurious momentum residual on a slanted-wall
    freestream, tests/test_cutcell.py).
    """
    N = centers.shape[0]
    diams = np.sqrt((widths.astype(np.float64) ** 2).sum(1))
    r_s = getattr(dfield, "simplex_radius", 0.0)
    q_err = getattr(dfield, "query_error", 0.0)
    approx = dfield(centers)
    cand_idx = np.nonzero((approx - q_err - r_s) <= 1.0 * diams)[0]

    segs_all = stl.points[stl.simplices].astype(np.float64)
    mids = segs_all.mean(axis=1)
    seg_r = np.sqrt(((segs_all[:, 1] - segs_all[:, 0]) ** 2).sum(1)).max() / 2
    stree = cKDTree(mids)
    poly = stl.points[stl.simplices[:, 0]].astype(np.float64)

    alpha = np.where(np.asarray(inside, bool), 0.0, 1.0)
    for i in cand_idx:
        near = stree.query_ball_point(centers[i].astype(np.float64),
                                      diams[i] / 2 + seg_r + 1e-12)
        if not near:
            continue
        lo = centers[i] - widths[i] / 2.0
        hi = centers[i] + widths[i] / 2.0
        solid = _clip_polygon_to_box(poly, lo, hi)
        a = 1.0 - solid / float(np.prod(widths[i].astype(np.float64)))
        alpha[i] = min(max(a, 0.0), 1.0)
    return alpha


def cut_metrics_2d(
    stl: Stereolitography,
    dfield,
    centers: np.ndarray,
    widths: np.ndarray,
    solved: np.ndarray,
    face_dim: np.ndarray,
    face_owner: np.ndarray,
    face_neighbor: np.ndarray,
    *,
    alpha: np.ndarray = None,
    alpha_floor: float = 0.05,
) -> Dict:
    """Compile static 2D cut-cell tables.

    ``solved``: bool[N], cells marched by the scheme — all cells with
    fluid fraction above the floor (see `fluid_fractions_2d`), regardless
    of where their center lies. ``alpha``: precomputed fluid fractions
    (computed here when absent). ``face_*``: the Domain's global face
    tables. Returns a dict of numpy tables consumed by the case builder
    (see module docstring).
    """
    from .inside import points_inside_2d

    nd = centers.shape[1]
    assert nd == 2, "cut_metrics_2d is 2D"
    N = centers.shape[0]
    diams = np.sqrt((widths.astype(np.float64) ** 2).sum(1))

    # cells whose box may intersect the wall: approximate center distance
    # below the circumradius plus the distance-query slack
    r_s = getattr(dfield, "simplex_radius", 0.0)
    q_err = getattr(dfield, "query_error", 0.0)
    approx = dfield(centers)
    # any geometrically cut cell has center distance <= diam/2; a solved
    # cell with a frozen face-neighbor (forced-closed face) has center
    # distance <= its cell width ~ 0.71 diam — 1.0 diam covers both
    cand = (approx - q_err - r_s) <= 1.0 * diams
    cand_idx = np.nonzero(cand)[0]

    segs_all = stl.points[stl.simplices].astype(np.float64)  # [M, 2, 2]
    mids = segs_all.mean(axis=1)
    seg_r = np.sqrt(((segs_all[:, 1] - segs_all[:, 0]) ** 2).sum(1)).max() / 2
    stree = cKDTree(mids)

    # ---- candidate-incident faces ---------------------------------------
    # interior faces (owner AND neighbor real) plus hypercube boundary
    # faces (one side -1): boundary faces of box-adjacent cells must enter
    # the closure too, else every such cell is left with a spurious
    # A * n_hat wall-vector residue; where the wall crosses the outer box
    # they also need real apertures and flux removal
    in_cand = np.zeros(N + 1, bool)
    in_cand[cand_idx] = True
    solved_pad = np.concatenate([solved, [False]])
    fo = face_owner.astype(np.int64)
    fn = face_neighbor.astype(np.int64)
    touches = (((fo >= 0) & in_cand[np.maximum(fo, 0)])
               | ((fn >= 0) & in_cand[np.maximum(fn, 0)]))
    f_idx = np.nonzero(touches)[0]

    o_f = fo[f_idx]
    n_f = fn[f_idx]
    has_o = o_f >= 0
    has_n = n_f >= 0
    anchor = np.where(has_o, o_f, n_f)     # owner if real, else neighbor
    h_o = widths[np.maximum(o_f, 0)]
    h_n = widths[np.maximum(n_f, 0)]
    dims = face_dim[f_idx]
    both_solved = solved_pad[o_f] & solved_pad[n_f]
    hcube = has_o != has_n
    equal = np.all(np.abs(h_o - h_n) <= 1e-6 * widths[anchor], axis=1)

    # face segment endpoints (perpendicular dim dd spans min(h_o, h_n))
    A = np.empty(f_idx.size)
    P0 = np.empty((f_idx.size, 2))
    P1 = np.empty((f_idx.size, 2))
    for k in range(f_idx.size):
        d = int(dims[k])
        dd = 1 - d
        if hcube[k]:
            c = centers[anchor[k]].astype(np.float64)
            w = widths[anchor[k]]
            small = c
            # owner real -> the face sits at its plus side; neighbor real
            # (outer-box minus side) -> at its minus side
            x_plane = c[d] + (w[d] / 2 if has_o[k] else -w[d] / 2)
            half = w[dd] / 2
        else:
            # shared plane at the owner's plus side; span = smaller cell
            small = (centers[o_f[k]] if h_o[k, dd] <= h_n[k, dd]
                     else centers[n_f[k]]).astype(np.float64)
            x_plane = centers[o_f[k], d] + h_o[k, d] / 2
            half = min(h_o[k, dd], h_n[k, dd]) / 2
        A[k] = 2 * half
        p0 = np.array([0.0, 0.0])
        p0[d] = x_plane
        p0[dd] = small[dd] - half
        p1 = p0.copy()
        p1[dd] = small[dd] + half
        P0[k] = p0
        P1[k] = p1

    inside_p0 = points_inside_2d(stl, P0 + 1e-9 * (P1 - P0))

    # apertures: TRUE open fractions for every face touching a solved
    # cell — including faces into frozen cells, whose (mostly tiny) open
    # fractions exchange flux against the frozen cells' mirrored ghost
    # values (ghost-cell/cut-cell hybrid). Force-closing those faces
    # instead would displace the wall onto grid faces and rebuild
    # staircase slivers (measured O(0.3) spurious residuals at cells next
    # to sub-floor slivers).
    ap = np.ones(f_idx.size)
    near = stree.query_ball_point(
        0.5 * (P0 + P1), A / 2 + seg_r + 1e-12)
    any_solved = solved_pad[o_f] | solved_pad[n_f]
    for k in range(f_idx.size):
        if not any_solved[k]:
            continue
        lst = near[k]
        if not lst:
            ap[k] = 0.0 if inside_p0[k] else 1.0
            continue
        ap[k] = _face_aperture(P0[k], P1[k], bool(inside_p0[k]),
                               segs_all[lst])
    # hanging-face averaging weights (reference src/ImmersedBoundary.jl:
    # 501-506): a cell receiving n faces on one side accumulates each with
    # weight 1/n. Cut faces on 2:1 interfaces (feature-refined bands touch
    # the wall near the LE/TE) must remove with the SAME weights the
    # structured interface path applied.
    w_own = np.ones(f_idx.size)
    w_nbr = np.ones(f_idx.size)
    for d in range(nd):
        sel = dims == d
        o_d = o_f[sel]
        n_d = n_f[sel]
        cnt_o = np.bincount(o_d[o_d >= 0], minlength=N)
        cnt_n = np.bincount(n_d[n_d >= 0], minlength=N)
        w_own[sel] = np.where(o_d >= 0, 1.0 / np.maximum(
            cnt_o[np.maximum(o_d, 0)], 1), 1.0)
        w_nbr[sel] = np.where(n_d >= 0, 1.0 / np.maximum(
            cnt_n[np.maximum(n_d, 0)], 1), 1.0)

    # ---- cell fluid fractions -------------------------------------------
    if alpha is None:
        alpha = fluid_fractions_2d(stl, dfield, centers, widths)
    alpha = np.where(solved, np.maximum(alpha, alpha_floor), 1.0)

    # ---- wall vectors via the divergence-theorem closure ------------------
    # wall_vec = -sum_faces a A n_out (n_out per cell: +e_d at the owner's
    # plus face, -e_d at the neighbor's minus face), so the accumulation
    # below writes -S directly
    wall_vec = np.zeros((N, 2))
    aA = ap * A
    for k in range(f_idx.size):
        d = int(dims[k])
        if has_o[k]:
            wall_vec[o_f[k], d] -= aA[k]
        if has_n[k]:
            wall_vec[n_f[k], d] += aA[k]
    wall_vec[~solved] = 0.0
    # the closure only saw candidate-incident faces, so it is complete
    # only for candidate cells; a non-candidate cell sharing a face with a
    # candidate would keep a spurious partial sum (and is genuinely uncut)
    wall_vec[~cand] = 0.0
    # keep only genuinely cut cells (closure residual of a full cell is 0)
    wnorm = np.sqrt((wall_vec ** 2).sum(1))
    wc = np.nonzero(wnorm > 1e-9 * diams)[0]

    # wall pressure sampling point: exact projection of the cell center
    if wc.size:
        proj, _ = dfield.projection(
            centers[wc], R=np.maximum(approx[wc], 0.0) + 2 * r_s + 1e-9)
        xw_rel = (proj - centers[wc]).astype(np.float32)
    else:
        xw_rel = np.zeros((0, 2), np.float32)

    # cut-face removal tables: interior faces remove (1 - a) of the flux
    # from both sides; hypercube one-sided faces pass the real cell as both
    # owner and neighbor (the dense path's o == n mirror gives the same
    # face value) with the removal weight only on the real side
    vol = np.prod(widths.astype(np.float64), axis=1)
    cut_sel = (ap < 1.0 - 1e-9) & (np.where(hcube, solved_pad[anchor],
                                            any_solved))
    out_o = [[] for _ in range(nd)]
    out_n = [[] for _ in range(nd)]
    out_wr = [[] for _ in range(nd)]
    out_wl = [[] for _ in range(nd)]
    for k in np.nonzero(cut_sel)[0]:
        d = int(dims[k])
        w = 1.0 - ap[k]
        if hcube[k]:
            out_o[d].append(anchor[k])
            out_n[d].append(anchor[k])
            out_wr[d].append(w * w_own[k] if has_o[k] else 0.0)
            out_wl[d].append(0.0 if has_o[k] else w * w_nbr[k])
        else:
            out_o[d].append(o_f[k])
            out_n[d].append(n_f[k])
            out_wr[d].append(w * w_own[k])
            out_wl[d].append(w * w_nbr[k])
    return dict(
        owner=[np.asarray(o, np.int32) for o in out_o],
        neighbor=[np.asarray(n, np.int32) for n in out_n],
        wr=[np.asarray(w, np.float32) for w in out_wr],
        wl=[np.asarray(w, np.float32) for w in out_wl],
        wall_cells=wc.astype(np.int32),
        wall_coef=(wall_vec[wc] / vol[wc, None]).astype(np.float32),
        xw_rel=xw_rel,
        inv_alpha=(1.0 / alpha).astype(np.float32),
        alpha=alpha.astype(np.float32),
        n_cut_faces=int(cut_sel.sum()),
    )
