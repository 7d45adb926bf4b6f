"""Point-in-solid tests (host side).

The reference meshes the full hypercube including cells inside solid bodies
and leaves them evolving freely behind the ghost layer (SURVEY.md §1.1 /
``docs/theory.pdf`` ch. 3 describes blanking as intent, unimplemented). At
fine resolutions free interior cells can run away and contaminate image-point
stencils, so the solver freezes them — which needs a signed inside/outside
classification.
"""

from __future__ import annotations

import numpy as np

from .stereolitography import Stereolitography


def points_inside_2d(stl: Stereolitography, pts: np.ndarray,
                     chunk: int = 0) -> np.ndarray:
    """Winding-number (crossing) test for closed 2D polylines.

    pts: [N, 2]. Returns bool[N], True strictly inside.
    """
    pts = np.asarray(pts, dtype=np.float64)
    seg = stl.points[stl.simplices].astype(np.float64)  # [M, 2, 2]
    if chunk <= 0:
        # keep the [chunk, M] crossing matrix cache-resident: a 65536-row
        # chunk against a refined surface (~12k segments) allocates
        # multi-GB temporaries and thrashes this 1-CPU box
        chunk = max(256, (1 << 22) // max(1, seg.shape[0]))
    x1, y1 = seg[:, 0, 0], seg[:, 0, 1]
    x2, y2 = seg[:, 1, 0], seg[:, 1, 1]

    inside = np.zeros(pts.shape[0], dtype=bool)
    # prefilter by bounding box
    bb_lo = seg.reshape(-1, 2).min(axis=0)
    bb_hi = seg.reshape(-1, 2).max(axis=0)
    cand = np.nonzero(
        np.all((pts >= bb_lo) & (pts <= bb_hi), axis=1)
    )[0]

    for s in range(0, cand.size, chunk):
        idx = cand[s:s + chunk]
        px = pts[idx, 0][:, None]
        py = pts[idx, 1][:, None]
        cond = (y1[None, :] <= py) != (y2[None, :] <= py)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_int = x1[None, :] + (py - y1[None, :]) * (
                x2[None, :] - x1[None, :]
            ) / (y2[None, :] - y1[None, :])
        crossings = (cond & (px < x_int)).sum(axis=1)
        inside[idx] = (crossings % 2) == 1
    return inside


def points_inside_3d(stl: Stereolitography, pts: np.ndarray,
                     chunk: int = 0) -> np.ndarray:
    """Ray-parity test for closed triangulated surfaces (near-+x ray).

    pts: [N, 3]. Returns bool[N], True inside (parity of triangle
    crossings along the ray direction).

    The ray is tilted by irrational components so rays from points on
    axis-aligned feature planes (e.g. the ring stations of a lofted wing)
    never travel inside a triangle plane or exactly through shared edges --
    the classic ray-parity degeneracy (a shared edge hit counts in both
    adjacent triangles and cancels).

    Implementation: rotate everything into the ray frame once; the
    crossing test per (point, triangle) is then three 2D edge functions
    on the perpendicular coordinates plus one plane solve (~15 flops,
    [n, M] temporaries only). The earlier Moeller-Trumbore formulation
    built [n, M, 3] cross products per chunk and cost ~10 min of a 3D
    sphere build at 2.8M cells; this form does the same classification
    in seconds.
    """
    pts = np.asarray(pts, dtype=np.float64)
    tri = stl.points[stl.simplices].astype(np.float64)  # [M, 3, 3]
    inside = np.zeros(pts.shape[0], dtype=bool)
    if tri.shape[0] == 0:
        return inside
    bb_lo = tri.reshape(-1, 3).min(axis=0)
    bb_hi = tri.reshape(-1, 3).max(axis=0)
    cand = np.nonzero(
        np.all((pts >= bb_lo) & (pts <= bb_hi), axis=1)
    )[0]
    if cand.size == 0:
        return inside

    d = np.array([1.0, 1e-4 * np.sqrt(2.0), 1e-4 * np.sqrt(3.0)])
    d = d / np.linalg.norm(d)
    b1 = np.array([-d[1], d[0], 0.0])
    b1 /= np.linalg.norm(b1)
    b2 = np.cross(d, b1)
    R = np.stack([d, b1, b2])                       # ray frame rows

    V = tri @ R.T                                   # [M, 3, 3] rotated
    P = pts[cand] @ R.T                             # [n, 3]
    v0, v1, v2 = V[:, 0], V[:, 1], V[:, 2]
    # 2D edge functions in the perpendicular (y', z') plane:
    # s_e(q) = (b - a) x (q - a) = dy (qz - az) - dz (qy - ay)
    eyz = []
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        dy = b[:, 1] - a[:, 1]
        dz = b[:, 2] - a[:, 2]
        eyz.append((dy, dz, dz * a[:, 1] - dy * a[:, 2]))
    # plane crossing: x' = x0 - gy qy - gz qz with n = (v1-v0) x (v2-v0)
    n = np.cross(v1 - v0, v2 - v0)                  # O(M), once
    nx = n[:, 0]
    ok = np.abs(nx) > 1e-300
    inv_nx = np.where(ok, 1.0 / np.where(ok, nx, 1.0), 0.0)
    gy = n[:, 1] * inv_nx
    gz = n[:, 2] * inv_nx
    x0 = v0[:, 0] + gy * v0[:, 1] + gz * v0[:, 2]

    # (y', z')-plane binning: a point's ray can only cross triangles whose
    # perpendicular-plane projection contains (qy, qz), so bucket the
    # triangles into a ~sqrt(M) x sqrt(M) grid by projected bbox and test
    # each point only against its bin's triangles (tests per point drop
    # from M to O(10) on closed surfaces; the all-pairs form was 420 s of
    # a 5.3M-cell sphere build).
    M = tri.shape[0]
    ty_lo = V[..., 1].min(axis=1)
    ty_hi = V[..., 1].max(axis=1)
    tz_lo = V[..., 2].min(axis=1)
    tz_hi = V[..., 2].max(axis=1)
    G = max(1, int(np.sqrt(M)))
    ylo, yhi = ty_lo.min(), ty_hi.max()
    zlo, zhi = tz_lo.min(), tz_hi.max()
    dy_bin = max(yhi - ylo, 1e-300) / G
    dz_bin = max(zhi - zlo, 1e-300) / G

    def ybin(v):
        return np.clip(((v - ylo) / dy_bin).astype(np.int64), 0, G - 1)

    def zbin(v):
        return np.clip(((v - zlo) / dz_bin).astype(np.int64), 0, G - 1)

    by0, by1 = ybin(ty_lo), ybin(ty_hi)
    bz0, bz1 = zbin(tz_lo), zbin(tz_hi)
    spans = (by1 - by0 + 1) * (bz1 - bz0 + 1)
    tri_of = np.repeat(np.arange(M, dtype=np.int64), spans)
    # bin id per (triangle, covered bin) entry
    bin_ids = np.empty(tri_of.size, np.int64)
    pos_e = 0
    for t in range(M):          # O(M) python loop, spans are tiny
        yy = np.arange(by0[t], by1[t] + 1)
        zz = np.arange(bz0[t], bz1[t] + 1)
        n_e = yy.size * zz.size
        bin_ids[pos_e:pos_e + n_e] = (yy[:, None] * G + zz[None, :]).ravel()
        pos_e += n_e
    order_e = np.argsort(bin_ids, kind="stable")
    bin_ids = bin_ids[order_e]
    tri_of = tri_of[order_e]
    starts = np.searchsorted(bin_ids, np.arange(G * G, dtype=np.int64))
    ends = np.searchsorted(bin_ids, np.arange(G * G, dtype=np.int64),
                           side="right")

    pb = ybin(P[:, 1]) * G + zbin(P[:, 2])
    porder = np.argsort(pb, kind="stable")
    pb_s = pb[porder]
    uniq, first = np.unique(pb_s, return_index=True)
    first = np.append(first, pb_s.size)
    crossings = np.zeros(cand.size, np.int64)
    for k, b in enumerate(uniq):
        tl = tri_of[starts[b]:ends[b]]
        if tl.size == 0:
            continue
        pi = porder[first[k]:first[k + 1]]
        q = P[pi]
        qy = q[:, 1][:, None]
        qz = q[:, 2][:, None]
        pos = None
        neg = None
        for dy, dz, c0 in eyz:
            sgn = dy[None, tl] * qz - dz[None, tl] * qy + c0[None, tl]
            p = sgn > 0.0
            m = sgn < 0.0
            pos = p if pos is None else (pos & p)
            neg = m if neg is None else (neg & m)
        xhit = x0[None, tl] - gy[None, tl] * qy - gz[None, tl] * qz
        hit = (pos | neg) & ok[None, tl] & (xhit > q[:, 0][:, None])
        crossings[pi] = hit.sum(axis=1)
    inside[cand] = (crossings % 2) == 1
    return inside


def points_inside(stl: Stereolitography, pts: np.ndarray) -> np.ndarray:
    pts = np.asarray(pts)
    if pts.shape[1] == 2:
        return points_inside_2d(stl, pts)
    return points_inside_3d(stl, pts)
