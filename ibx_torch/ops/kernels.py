"""The hand-written CUDA kernels of the block march, their wrappers,
launch counters and plain PyTorch versions.

| kernel (counter)    | source               | replaces (pallas_rhs.py)  |
| ------------------- | -------------------- | ------------------------- |
| `rk2_update`        | csrc/rk2_update.cu   | `_kernel_update`          |
| `euler_pass_a`      | csrc/euler_pass_a.cu | `_kernel_a`               |
| `euler_pass_b`      | csrc/euler_pass_b.cu | `_kernel_b`               |
| `euler_pass_b_fold` | csrc/euler_pass_b.cu | `_kernel_b`, `have_cols`  |

All grids are float32 ``[B, C, bs, bs*bs]`` (within-block cell index
w = z*bs^2 + y*bs + x). The kernels are compiled for ``sm_90a`` with
``nvcc`` at first use, one process per source in parallel, linked into
one shared library under ``ibx_torch/_build/`` and called through
``ctypes`` on the current CUDA stream.

Each wrapper takes its plain version (``*_ref``, the same expressions
written with tensor ops) only for tensors on the CPU; for CUDA tensors it
launches the kernel, adds one to ``launches[name]`` and raises if the
launch fails. Nothing falls back. Passes A and B take the block sizes in
``STENCIL_BLOCK_SIZES`` (one CUDA block per mesh block, one thread per
(y, x) column) and raise ValueError on any other, on every device.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

from ..physics.fluid import Fluid

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rk2_update.cu", "euler_pass_a.cu", "euler_pass_b.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# block sizes of the pass-A and pass-B kernels: bs^2 threads a CUDA block
# (16 to 256); bs = 2 would leave 4 threads a block, bs = 32 ask for 1024
# threads and four times the shared-memory tile
STENCIL_BLOCK_SIZES = (4, 8, 16)

launches: Dict[str, int] = {"rk2_update": 0, "euler_pass_a": 0,
                            "euler_pass_b": 0, "euler_pass_b_fold": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda)")
    return cand


def _library_path() -> Path:
    files = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        digest.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"libibx_kernels_{digest.hexdigest()[:16]}.so"


def build_log() -> str:
    """What ``ptxas -v`` said about each kernel when the library was built
    (registers, spills, static shared memory), kept beside it."""
    return _library_path().with_suffix(".log").read_text()


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; cached per process
    and, on disk, by a hash of the sources and flags."""
    global _lib
    if _lib is not None:
        return _lib
    so = _library_path()
    tag = so.stem.rsplit("_", 1)[1]
    if not so.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        objs = [BUILD_DIR / f"{Path(s).stem}_{tag}.o" for s in SOURCES]

        def compile_one(src_obj):
            src, obj = src_obj
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                   str(CSRC / src), "-o", str(obj)]
            return cmd, subprocess.run(cmd, capture_output=True, text=True)

        with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as ex:
            results = list(ex.map(compile_one, zip(SOURCES, objs)))
        for cmd, r in results:
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n"
                                   f"{r.stdout}\n{r.stderr}")
            if verbose:
                print(r.stderr.strip(), flush=True)
        so.with_suffix(".log").write_text(
            "\n".join(r.stderr for _, r in results))
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n"
                               f"{r.stdout}\n{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.ibx_rk2_update.argtypes = [p, p, p, p, p, p, ll, i, f, f, f, f, p]
    lib.ibx_euler_pass_a.argtypes = [p, p, p, p, p, i, i, i, f, p]
    lib.ibx_euler_pass_b.argtypes = [p, p, p, p, p, p, p, p, i, i, i, f, f,
                                     f, p]
    lib.ibx_euler_pass_a_smem.argtypes = [i, i]
    lib.ibx_euler_pass_b_smem.argtypes = [i, i]
    for fn in (lib.ibx_rk2_update, lib.ibx_euler_pass_a,
               lib.ibx_euler_pass_b, lib.ibx_euler_pass_a_smem,
               lib.ibx_euler_pass_b_smem):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _geometry(Pc: torch.Tensor):
    if Pc.dim() != 4 or Pc.shape[1] != 5 or Pc.shape[3] != Pc.shape[2] ** 2:
        raise ValueError(f"state must be [B, 5, bs, bs*bs], got "
                         f"{tuple(Pc.shape)}")
    B, _, bs, _ = Pc.shape
    if bs < 2 or bs & (bs - 1):
        raise ValueError(f"block size must be a power of two, got {bs}")
    return B, bs


def _stencil_geometry(Pc: torch.Tensor):
    B, bs = _geometry(Pc)
    if bs not in STENCIL_BLOCK_SIZES:
        raise ValueError(f"passes A and B take block sizes "
                         f"{STENCIL_BLOCK_SIZES}, got {bs}")
    return B, bs


def _check_tables(meta, nbr_table, B, device) -> None:
    _check("meta", meta, (B, 16), device)
    if nbr_table.device != device or nbr_table.dtype != torch.int32 \
            or tuple(nbr_table.shape) != (B, 8) \
            or not nbr_table.is_contiguous():
        raise ValueError("nbr_table must be a contiguous int32 [B, 8] "
                         f"tensor on {device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


# ---------------------------------------------------------------------------
# rk2_update
# ---------------------------------------------------------------------------

def rk2_update_ref(fluid: Fluid, Pc, R0, R1, dtb, active, cfl: float):
    """Plain version of `rk2_update`: the expressions of `_kernel_update`
    (p2s -> Q0 + dt*R -> guarded s2p) with the channel axis 1."""
    p = Pc[:, 0:1]
    T = Pc[:, 1:2].clamp(min=10.0)
    u = Pc[:, 2:]
    kin = (u ** 2).sum(dim=1, keepdim=True) / 2
    rho = p / (fluid.R * T)
    E = rho * (fluid.cv * T + kin)
    Q0 = torch.cat([rho, E, rho * u], dim=1)

    dt = cfl / dtb
    if active is not None:
        dt = dt * active
    if R1 is not None:
        Qn = Q0 + dt * (R0 + R1) / 2
    else:
        Qn = Q0 + dt * R0

    rho = Qn[:, 0:1].clamp(min=1e-6)
    E = Qn[:, 1:2]
    u = Qn[:, 2:] / rho
    kin = (u ** 2).sum(dim=1, keepdim=True) / 2
    p = fluid.gm1 * (E - rho * kin)
    T = (p / (rho * fluid.R)).clamp(10.0, 2e4)
    vmag = torch.sqrt((u ** 2).sum(dim=1, keepdim=True) + 1e-12)
    scale = (3000.0 / vmag).clamp(max=1.0)
    return torch.cat([p.clamp(1.0, 1e9), T, u * scale], dim=1)


def rk2_update(fluid: Fluid, Pc, R0, R1, dtb, active, cfl: float):
    """Fused RK2 stage (stage 1 when ``R1`` is None): returns the guarded
    primitive state ``[B, 5, bs, bs*bs]``. ``dtb`` is the per-cell
    wave-speed bound, ``active`` an optional 0/1 freeze mask, both
    ``[B, 1, bs, bs*bs]``. Geometry comes from the operand shapes."""
    B, bs = _geometry(Pc)
    dev = Pc.device
    g5, g1 = (B, 5, bs, bs * bs), (B, 1, bs, bs * bs)
    _check("P", Pc, g5, dev)
    _check("R0", R0, g5, dev)
    if R1 is not None:
        _check("R1", R1, g5, dev)
    _check("dtb", dtb, g1, dev)
    if active is not None:
        _check("active", active, g1, dev)
    if dev.type == "cpu":
        return rk2_update_ref(fluid, Pc, R0, R1, dtb, active, cfl)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(Pc)
    err = build().ibx_rk2_update(
        _ptr(Pc), _ptr(R0), _ptr(R1), _ptr(dtb), _ptr(active), _ptr(out),
        B * bs ** 3, bs ** 3, float(cfl), fluid.R, fluid.gm1, fluid.cv,
        _stream(dev))
    _raise_on(err, "rk2_update")
    launches["rk2_update"] += 1
    return out


# ---------------------------------------------------------------------------
# shared plain-version helpers (5D view [B, C, z, y, x]; dim d on axis 4-d)
# ---------------------------------------------------------------------------

def _bview(v):
    """Per-block [B] vector shaped to broadcast against [B, C, z, y, x]."""
    return v.view((-1, 1, 1, 1, 1))


def _halo(X5, meta, nbr_table, d: int, s: int):
    """The side-s halo plane along dim d of every block: the neighbor
    block's opposite edge plane, or the own edge plane on a one-sided
    boundary side."""
    ax = 4 - d
    bs = X5.shape[ax]
    first = X5.narrow(ax, 0, 1)
    last = X5.narrow(ax, bs - 1, 1)
    bnd = _bview(meta[:, 9 + 2 * d + s])
    nb = nbr_table[:, 2 * d + s].long()
    if s == 0:
        return torch.where(bnd > 0, first, last[nb])
    return torch.where(bnd > 0, last, first[nb])


def _faces(X5, meta, nbr_table, d: int):
    """The minus and plus cells of the bs+1 faces along dim d of every
    block (face k between cells k-1 and k, the halo planes at the ends):
    two views of X5 extended by its halo planes."""
    ax = 4 - d
    bs = X5.shape[ax]
    ext = torch.cat([_halo(X5, meta, nbr_table, d, 0), X5,
                     _halo(X5, meta, nbr_table, d, 1)], dim=ax)
    return ext.narrow(ax, 0, bs + 1), ext.narrow(ax, 1, bs + 1)


def _face_mask(meta, d: int, bs: int):
    """The bs+1 faces' masks along dim d: edge_valid[d][0] on face 0,
    edge_valid[d][1] on face bs, 1 between."""
    B = meta.shape[0]
    m = torch.ones((B, bs + 1), dtype=meta.dtype, device=meta.device)
    m[:, 0] = meta[:, 3 + 2 * d]
    m[:, bs] = meta[:, 4 + 2 * d]
    shape = [B, 1, 1, 1, 1]
    shape[4 - d] = bs + 1
    return m.view(shape)


def _minus_plus(F, d: int):
    """Each cell's minus and plus face values from the bs+1 faces."""
    ax = 4 - d
    bs = F.shape[ax] - 1
    return F.narrow(ax, 0, bs), F.narrow(ax, 1, bs)


# ---------------------------------------------------------------------------
# euler_pass_a
# ---------------------------------------------------------------------------

def euler_pass_a_ref(fluid: Fluid, Pc, meta, nbr_table, *, with_dt: bool):
    """Plain version of `euler_pass_a`: the expressions of `_kernel_a`,
    each face average taken once (bs+1 faces a dim) and differenced."""
    B, bs = _geometry(Pc)
    P = Pc.view(B, 5, bs, bs, bs)

    def sound(T):
        return torch.sqrt(fluid.gR * T.clamp(min=10.0))

    du, G, U, sf = [], [], [], []
    for d in range(3):
        h = _bview(meta[:, d])
        m = _face_mask(meta, d, bs)
        Po, Pn = _faces(P, meta, nbr_table, d)
        Pf_m, Pf_p = _minus_plus((Po * h + Pn * h) / (h + h) * m, d)
        fd_m, fd_p = _minus_plus((Pn[:, 0:1] - Po[:, 0:1]) * m, d)
        du.append((Pf_p - Pf_m) / h)
        G.append((fd_p - fd_m) / h)
        U.append((fd_p.abs() + fd_m.abs()) / h)
        if with_dt:
            So = Po[:, 2 + d:3 + d].abs() + sound(Po[:, 1:2])
            Sn = Pn[:, 2 + d:3 + d].abs() + sound(Pn[:, 1:2])
            sf_m, sf_p = _minus_plus((So * h + Sn * h) / (h + h) * m, d)
            sf.append((sf_p + sf_m) / h)
    aux = torch.cat(G + U + sf, dim=1)
    return (torch.cat(du, dim=1).reshape(B, 15, bs, bs * bs),
            aux.reshape(B, aux.shape[1], bs, bs * bs))


def euler_pass_a(fluid: Fluid, Pc, meta, nbr_table, *, with_dt: bool):
    """RHS pass A: returns ``du [B, 15, bs, bs*bs]`` (Green-Gauss
    gradients, dim-major) and ``aux [B, 9 | 6, bs, bs*bs]`` (G per dim, U
    per dim, and with ``with_dt`` the wave-speed sums)."""
    B, bs = _stencil_geometry(Pc)
    dev = Pc.device
    _check("P", Pc, (B, 5, bs, bs * bs), dev)
    _check_tables(meta, nbr_table, B, dev)
    if dev.type == "cpu":
        return euler_pass_a_ref(fluid, Pc, meta, nbr_table, with_dt=with_dt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    du = torch.empty((B, 15, bs, bs * bs), dtype=Pc.dtype, device=dev)
    aux = torch.empty((B, 9 if with_dt else 6, bs, bs * bs),
                      dtype=Pc.dtype, device=dev)
    err = build().ibx_euler_pass_a(
        _ptr(Pc), _ptr(meta), _ptr(nbr_table), _ptr(du), _ptr(aux), B,
        bs.bit_length() - 1, int(with_dt), fluid.gR, _stream(dev))
    _raise_on(err, "euler_pass_a")
    launches["euler_pass_a"] += 1
    return du, aux


# ---------------------------------------------------------------------------
# euler_pass_b
# ---------------------------------------------------------------------------

def _hll_cs(fluid: Fluid, PL, PR, d: int):
    """Channel-split HLL flux (`_hll_flux`): channels on axis 1."""
    def side(X):
        p = X[:, 0:1]
        T = X[:, 1:2].clamp(min=10.0)
        u, v, w = X[:, 2:3], X[:, 3:4], X[:, 4:5]
        kin = (u * u + v * v + w * w) / 2
        rho = p / (fluid.R * T)
        E = rho * (fluid.cv * T + kin)
        Q = [rho, E, rho * u, rho * v, rho * w]
        un = X[:, 2 + d:3 + d]
        mom = [Q[2] * un, Q[3] * un, Q[4] * un]
        mom[d] = mom[d] + p
        F = [rho * un, (E + p) * un] + mom
        return Q, F, un, torch.sqrt(fluid.gR * T)

    QL, FL, uL, aL = side(PL)
    QR, FR, uR, aR = side(PR)
    SL = (uL + aL).clamp(min=0.0)
    SR = (uR - aR).clamp(max=0.0)
    denom = SL - SR
    safe = denom > 0
    den = torch.where(safe, denom, torch.ones_like(denom))
    return torch.cat([
        torch.where(safe, (SL * FL[k] - SR * FR[k] + SR * SL * (QR[k] - QL[k]))
                    / den, torch.zeros_like(den))
        for k in range(5)], dim=1)


def _face_b(fluid: Fluid, high_order: bool, d: int, h, Wo, Wn):
    """-HLL flux of the MUSCL-reconstructed face (`_face_b`); W stacks are
    [P(5), du_d(5), nu(1)] on axis 1."""
    Po, Pn, duo, dun = Wo[:, 0:5], Wn[:, 0:5], Wo[:, 5:10], Wn[:, 5:10]
    down = h / 2
    dneigh = h / 2
    grad_f = (Pn - Po) / (down + dneigh)
    slope_o = (2 * duo - grad_f) * down
    slope_n = (2 * dun - grad_f) * dneigh
    lim = torch.minimum(slope_n.abs(), slope_o.abs()) * (
        torch.sign(slope_n) + torch.sign(slope_o)) / 2
    D = torch.maximum(Wo[:, 10:11], Wn[:, 10:11]).clamp(min=1e-7)
    uf = (Po * dneigh + Pn * down) / (down + dneigh)
    if high_order:
        uf = uf + (duo * down - dun * dneigh) / 8
    PL = (Po + lim) * D + (1.0 - D) * uf
    PR = (Pn - lim) * D + (1.0 - D) * uf
    return -_hll_cs(fluid, PL, PR, d)


def fold_du_ref(du, cols6):
    """``du`` [B, 15, bs, bs*bs] with the fold's 2:1 corrections added at
    the side-s edge planes of each dim's channels (a new tensor): the values
    the fold kernel loads, and those the pre-add path stores."""
    rows, vals = cols6
    B, _, bs, _ = du.shape
    out = du.clone()
    o5 = out.view(B, 15, bs, bs, bs)
    # a block without a row adds the zero row last: no data-dependent
    # shape, so that a CUDA graph can capture it
    v4 = torch.cat([vals.view(vals.shape[0], 5, bs, bs),
                    vals.new_zeros((1, 5, bs, bs))])
    for d in range(3):
        for s in range(2):
            r = rows[:, 2 * d + s].long()
            idx = torch.where(r >= 0, r, v4.shape[0] - 1)
            o5[:, 5 * d:5 * d + 5].select(4 - d, bs - 1 if s else 0) \
                .add_(v4[idx])
    return out


def euler_pass_b_ref(fluid: Fluid, Pc, du, nu, meta, nbr_table, *,
                     high_order: bool, cols6=None):
    """Plain version of `euler_pass_b`: the expressions of `_kernel_b`,
    each face evaluated once (bs+1 faces a dim) and differenced; with
    ``cols6`` the corrections are added to ``du`` first (`fold_du_ref`)."""
    B, bs = _geometry(Pc)
    if cols6 is not None:
        du = fold_du_ref(du, cols6)
    acc = None
    for d in range(3):
        W = torch.cat([Pc, du[:, 5 * d:5 * d + 5], nu], dim=1).view(
            B, 11, bs, bs, bs)
        h = _bview(meta[:, d])
        Wo, Wn = _faces(W, meta, nbr_table, d)
        F = _face_b(fluid, high_order, d, h, Wo, Wn) * _face_mask(meta, d, bs)
        Fm, Fp = _minus_plus(F, d)
        Rd = (Fp - Fm) / h
        acc = Rd if acc is None else acc + Rd
    return acc.reshape(B, 5, bs, bs * bs)


def euler_pass_b(fluid: Fluid, Pc, du, nu, meta, nbr_table, *,
                 high_order: bool, cols6=None):
    """RHS pass B: ``R [B, 5, bs, bs*bs]`` from the state, the pass-A
    gradients ``du [B, 15, ..]`` and the sensor ``nu [B, 1, ..]``.

    Without ``cols6`` the gradients carry their 2:1 corrections already.
    With ``cols6 = (rows, vals)`` the kernel adds them as it loads (the
    `have_cols` fold, counted as ``euler_pass_b_fold``): ``rows`` int32
    [B, 6] is the row of ``vals`` f32 [V, 5, bs*bs] holding block b's
    correction on side s of dim d at column 2d + s, or -1; a row's lateral
    index is hi-major over the other two dims ((y, x) for d = 2, (z, x) for
    d = 1, (z, y) for d = 0), as in the JAX package's placed operands."""
    B, bs = _stencil_geometry(Pc)
    dev = Pc.device
    _check("P", Pc, (B, 5, bs, bs * bs), dev)
    _check("du", du, (B, 15, bs, bs * bs), dev)
    _check("nu", nu, (B, 1, bs, bs * bs), dev)
    _check_tables(meta, nbr_table, B, dev)
    rows = vals = None
    if cols6 is not None:
        rows, vals = cols6
        if rows.device != dev or rows.dtype != torch.int32 \
                or tuple(rows.shape) != (B, 6) or not rows.is_contiguous():
            raise ValueError("cols6 rows must be a contiguous int32 [B, 6] "
                             f"tensor on {dev}")
        _check("cols6 vals", vals, (vals.shape[0], 5, bs * bs), dev)
    if dev.type == "cpu":
        return euler_pass_b_ref(fluid, Pc, du, nu, meta, nbr_table,
                                high_order=high_order, cols6=cols6)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    name = "euler_pass_b" if cols6 is None else "euler_pass_b_fold"
    R = torch.empty_like(Pc)
    err = build().ibx_euler_pass_b(
        _ptr(Pc), _ptr(du), _ptr(nu), _ptr(meta), _ptr(nbr_table),
        _ptr(rows), _ptr(vals), _ptr(R), B, bs.bit_length() - 1,
        int(high_order), fluid.R, fluid.cv, fluid.gR, _stream(dev))
    _raise_on(err, name)
    launches[name] += 1
    return R
