"""The hand-written CUDA kernels of the block march, their wrappers,
launch counters and plain PyTorch versions.

| kernel (counter)    | source                  | replaces                  |
| ------------------- | ----------------------- | ------------------------- |
| `rk2_update`        | csrc/rk2_update.cu      | `_kernel_update`          |
| `euler_pass_a`      | csrc/euler_pass_a.cu    | `_kernel_a`               |
| `euler_pass_b`      | csrc/euler_pass_b.cu    | `_kernel_b`               |
| `euler_pass_b_fold` | csrc/euler_pass_b.cu    | `_kernel_b`, `have_cols`  |
| `euler_pass_a_2d`   | csrc/euler_pass_a_2d.cu | no TPU kernel: `face_a`   |
| `euler_pass_b_2d`   | csrc/euler_pass_b_2d.cu | no TPU kernel: `face_b`   |
| `interface_a_2d`    | csrc/interface_2d.cu    | no TPU kernel: 2:1 glue   |
| `interface_b_2d`    | csrc/interface_2d.cu    | no TPU kernel: 2:1 glue   |

(the TPU kernels of ``ibx/ops/pallas_rhs.py``; the JAX package has no
kernel at nd = 2, so the 2D passes replace the torch-op face evaluation
of `block_ops.face_accumulate` with `scheme.face_a` / `face_b`, and the
2D interface kernels its 2:1 glue, `scheme.interface_corrections`, which
the JAX package leaves to XLA ops.)
`stamp` (``csrc/stamp.cu``, no counter, no JAX counterpart) writes one
``(tag, %globaltimer)`` record for `utils.monitor.device_span`.

The 3D grids are float32 ``[B, C, bs, bs*bs]`` (within-block cell index
w = z*bs^2 + y*bs + x); the 2D ones are the march's cell-major
``[B, bs, bs, 4]`` (one float4 a cell). The kernels are compiled for
``sm_90a`` with ``nvcc`` at first use, one process per source in
parallel, linked into one shared library under ``ibx_torch/_build/`` and
called through ``ctypes`` on the current CUDA stream.

Each wrapper takes its plain version (``*_ref``, the same expressions
written with tensor ops) only for tensors on the CPU; for CUDA tensors it
launches the kernel, adds one to ``launches[name]`` and raises if the
launch fails. Nothing falls back. Passes A and B take the block sizes in
``STENCIL_BLOCK_SIZES`` (one CUDA block per mesh block, one thread per
(y, x) column in 3D, per cell in 2D) and raise ValueError on any other,
on every device.
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

from ..physics.fluid import Fluid, speed_of_sound
from .operators import abs_select
from .scheme import face_a, face_b

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rk2_update.cu", "euler_pass_a.cu", "euler_pass_b.cu",
           "euler_pass_a_2d.cu", "euler_pass_b_2d.cu", "interface_2d.cu",
           "stamp.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# block sizes of the pass-A and pass-B kernels: bs^2 threads a CUDA block
# (16 to 256); bs = 2 would leave 4 threads a block, bs = 32 ask for 1024
# threads and four times the shared-memory tile
STENCIL_BLOCK_SIZES = (4, 8, 16)

launches: Dict[str, int] = {"rk2_update": 0, "euler_pass_a": 0,
                            "euler_pass_b": 0, "euler_pass_b_fold": 0,
                            "euler_pass_a_2d": 0, "euler_pass_b_2d": 0,
                            "interface_a_2d": 0, "interface_b_2d": 0}

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
    lib.ibx_euler_pass_a_2d.argtypes = [p, p, p, p, p, p, p, p, p, i, i, f,
                                        f, p]
    lib.ibx_euler_pass_b_2d.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                        f, f, f, p]
    lib.ibx_interface_a_2d.argtypes = [p, p, p, p, i, i, i, f, p]
    lib.ibx_interface_b_2d.argtypes = [p, p, p, p, p, p, p, i, i, i, f, f, f,
                                       p]
    lib.ibx_stamp.argtypes = [p, p, ll, ll, p]
    for fn in (lib.ibx_rk2_update, lib.ibx_euler_pass_a,
               lib.ibx_euler_pass_b, lib.ibx_euler_pass_a_smem,
               lib.ibx_euler_pass_b_smem, lib.ibx_euler_pass_a_2d,
               lib.ibx_euler_pass_b_2d, lib.ibx_interface_a_2d,
               lib.ibx_interface_b_2d, lib.ibx_stamp):
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
# stamp
# ---------------------------------------------------------------------------

def stamp(slots: torch.Tensor, head: torch.Tensor, tag: int) -> None:
    """Write ``(tag, %globaltimer)`` into row ``head`` of ``slots`` (int64
    ``[capacity, 2]`` on the card) and advance ``head`` (int64 ``[1]``) by
    one, atomically, on the current stream; a head at or past the capacity
    writes nothing. Not counted in `launches`."""
    dev = slots.device
    if dev.type != "cuda" or head.device != dev:
        raise ValueError(f"stamp writes a ring on a card, got {dev}")
    if slots.dtype != torch.int64 or slots.dim() != 2 \
            or slots.shape[1] != 2 or not slots.is_contiguous() \
            or head.dtype != torch.int64 or head.numel() != 1:
        raise ValueError("stamp needs contiguous int64 slots [n, 2] and an "
                         "int64 head [1]")
    _raise_on(build().ibx_stamp(_ptr(slots), _ptr(head), slots.shape[0],
                                int(tag), _stream(dev)), "stamp")


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
# shared plain-version helpers, on both layouts: the 3D view [B, C, z, y, x]
# (dim d on axis ax = 4 - d) and the 2D grid [B, bs, bs, C] (ax = 2 - d)
# ---------------------------------------------------------------------------

def _bview(v):
    """Per-block [B] vector shaped to broadcast against [B, C, z, y, x]."""
    return v.view((-1, 1, 1, 1, 1))


def _halo(X, meta, nbr_table, d: int, s: int, ax: int):
    """The side-s halo plane along dim d (on axis ``ax``) of every block:
    the neighbor block's opposite edge plane, or the own edge plane on a
    one-sided boundary side (`block_ops._halos`)."""
    bs = X.shape[ax]
    first = X.narrow(ax, 0, 1)
    last = X.narrow(ax, bs - 1, 1)
    bnd = meta[:, 9 + 2 * d + s].view((-1,) + (1,) * (X.dim() - 1))
    nb = nbr_table[:, 2 * d + s].long()
    if s == 0:
        return torch.where(bnd > 0, first, last[nb])
    return torch.where(bnd > 0, last, first[nb])


def _faces(X, meta, nbr_table, d: int, ax: int):
    """The minus and plus cells of the bs+1 faces along dim d (on axis
    ``ax``) of every block (face k between cells k-1 and k, the halo
    planes at the ends): two views of X extended by its halo planes; and
    the faces' masks, shaped to broadcast against them (edge_valid[d][0]
    on face 0, edge_valid[d][1] on face bs, 1 between)."""
    bs = X.shape[ax]
    ext = torch.cat([_halo(X, meta, nbr_table, d, 0, ax), X,
                     _halo(X, meta, nbr_table, d, 1, ax)], dim=ax)
    B = meta.shape[0]
    m = torch.ones((B, bs + 1), dtype=meta.dtype, device=meta.device)
    m[:, 0] = meta[:, 3 + 2 * d]
    m[:, bs] = meta[:, 4 + 2 * d]
    shape = [B] + [1] * (X.dim() - 1)
    shape[ax] = bs + 1
    return ext.narrow(ax, 0, bs + 1), ext.narrow(ax, 1, bs + 1), \
        m.view(shape)


def _minus_plus(F, ax: int):
    """Each cell's minus and plus face values from the bs+1 faces."""
    bs = F.shape[ax] - 1
    return F.narrow(ax, 0, bs), F.narrow(ax, 1, bs)


def _fold_add(X, rows, vals, d: int, ax: int) -> None:
    """Add, in place, row ``rows[b, 2d + s]`` of the compact 2:1
    corrections ``vals`` (one edge plane a row) to block b's side-s edge
    plane along dim d (on axis ``ax``) of ``X``, for both sides (a block
    without a row adds the zero row last: no data-dependent shape, so that
    a CUDA graph can capture it)."""
    bs = X.shape[ax]
    vz = torch.cat([vals, vals.new_zeros((1,) + tuple(vals.shape[1:]))])
    for s in (0, 1):
        r = rows[:, 2 * d + s].long()
        idx = torch.where(r >= 0, r, vz.shape[0] - 1)
        X.select(ax, bs - 1 if s else 0).add_(vz[idx])


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
        Po, Pn, m = _faces(P, meta, nbr_table, d, 4 - d)
        Pf_m, Pf_p = _minus_plus((Po * h + Pn * h) / (h + h) * m, 4 - d)
        fd_m, fd_p = _minus_plus((Pn[:, 0:1] - Po[:, 0:1]) * m, 4 - d)
        du.append((Pf_p - Pf_m) / h)
        G.append((fd_p - fd_m) / h)
        U.append((fd_p.abs() + fd_m.abs()) / h)
        if with_dt:
            So = Po[:, 2 + d:3 + d].abs() + sound(Po[:, 1:2])
            Sn = Pn[:, 2 + d:3 + d].abs() + sound(Pn[:, 1:2])
            sf_m, sf_p = _minus_plus((So * h + Sn * h) / (h + h) * m,
                                     4 - d)
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
    v4 = vals.view(vals.shape[0], 5, bs, bs)
    for d in range(3):
        _fold_add(o5[:, 5 * d:5 * d + 5], rows, v4, d, 4 - d)
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
        Wo, Wn, m = _faces(W, meta, nbr_table, d, 4 - d)
        Fm, Fp = _minus_plus(_face_b(fluid, high_order, d, h, Wo, Wn) * m,
                             4 - d)
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


# ---------------------------------------------------------------------------
# 2D passes A and B (cell-major [B, bs, bs, 4]; dim d on axis 2 - d)
# ---------------------------------------------------------------------------

def euler_pass_a_2d_ref(fluid: Fluid, P3, meta, nbr_table, rows, vals, *,
                        with_dt: bool, cfl: float):
    """Plain version of `euler_pass_a_2d`: the torch-op body of
    `block_ops.euler_rhs_grid` for pass A (`scheme.face_a` on each face,
    the divergence, the 2:1 corrections added at the edge lines, the
    sensor and the dt bound), in its order, so that on the CPU it gives
    that body's values bit for bit."""
    ncomp = P3.shape[-1]
    fn = face_a(with_dt)
    nu = torch.full(tuple(P3.shape[:-1]) + (1,), 1e-7, dtype=P3.dtype,
                    device=P3.device)
    if with_dt:
        sound = speed_of_sound(fluid, P3[..., 1])[..., None]
    du, sf = [], []
    for d in range(2):
        parts = (P3,)
        if with_dt:
            parts = (P3, P3[..., 2 + d:3 + d].abs() + sound)
        # the padded formulation of `block_ops.face_accumulate`, face for
        # face the value of its default one
        h = meta[:, d].view(-1, 1, 1, 1)
        ext = [_faces(p, meta, nbr_table, d, 2 - d) for p in parts]
        F = fn(tuple(e[0] for e in ext), tuple(e[1] for e in ext), h, h)
        Fm, Fp = _minus_plus(F * ext[0][2], 2 - d)
        signed = ncomp + 1
        out = torch.cat([(Fp[..., :signed] - Fm[..., :signed]) / h,
                         (Fp[..., signed:] + Fm[..., signed:]) / h], dim=-1)
        _fold_add(out, rows, vals, d, 2 - d)
        du.append(out[..., :ncomp].contiguous())
        G, U = out[..., ncomp:ncomp + 1], out[..., ncomp + 1:ncomp + 2]
        nu = torch.maximum(nu, (1e-7 + abs_select(G)) / (1e-7 + U))
        if with_dt:
            sf.append(out[..., ncomp + 2])
    dt = cfl / (sf[0] + sf[1]) if with_dt else None
    return du[0], du[1], nu[..., 0], dt


def _check_rows(rows, vals, B: int, bs: int, K: int, device) -> None:
    if rows.device != device or rows.dtype != torch.int32 \
            or tuple(rows.shape) != (B, 4) or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous int32 [B, 4] tensor "
                         f"on {device}")
    _check("vals", vals, (vals.shape[0], bs, K), device)


def _grid2_geometry(P3):
    if P3.dim() != 4 or P3.shape[3] != 4 or P3.shape[1] != P3.shape[2]:
        raise ValueError(f"state must be [B, bs, bs, 4], got "
                         f"{tuple(P3.shape)}")
    B, bs = P3.shape[0], P3.shape[1]
    if bs not in STENCIL_BLOCK_SIZES:
        raise ValueError(f"passes A and B take block sizes "
                         f"{STENCIL_BLOCK_SIZES}, got {bs}")
    return B, bs


def _check_float4(**xs) -> None:
    """The 2D kernels read and write one float4 a cell: 16-byte aligned."""
    for name, x in xs.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the "
                             f"float4 loads")


def euler_pass_a_2d(fluid: Fluid, P3, meta, nbr_table, rows, vals, *,
                    with_dt: bool, cfl: float):
    """2D RHS pass A with its 2:1 corrections, sensor and dt: returns
    ``(du_x, du_y, nu, dt)``, the Green-Gauss gradients ``[B, bs, bs, 4]``
    a dim, the JST sensor ``nu [B, bs, bs]`` and, with ``with_dt``, the
    local step ``dt = cfl / wave-speed sum`` ``[B, bs, bs]`` (else None).
    ``rows`` int32 [B, 4] is the row of ``vals`` f32 [V, bs, 7 | 6] holding
    block b's correction of side s of dim d at column 2d + s, or -1
    (`BlockTables.fold_rows`); a row's channels are `scheme.face_a`'s,
    [du (4), G, U (, sf)], its index along the edge y for d = 0 and x for
    d = 1 (`scheme.interface_corrections`)."""
    B, bs = _grid2_geometry(P3)
    dev = P3.device
    _check("P", P3, (B, bs, bs, 4), dev)
    _check_tables(meta, nbr_table, B, dev)
    _check_rows(rows, vals, B, bs, 7 if with_dt else 6, dev)
    if dev.type == "cpu":
        return euler_pass_a_2d_ref(fluid, P3, meta, nbr_table, rows, vals,
                                   with_dt=with_dt, cfl=cfl)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_float4(P=P3)
    du = torch.empty((2, B, bs, bs, 4), dtype=P3.dtype, device=dev)
    nu = torch.empty((B, bs, bs), dtype=P3.dtype, device=dev)
    dt = torch.empty_like(nu) if with_dt else None
    err = build().ibx_euler_pass_a_2d(
        _ptr(P3), _ptr(meta), _ptr(nbr_table), _ptr(rows), _ptr(vals),
        _ptr(du[0]), _ptr(du[1]), _ptr(nu), _ptr(dt), B,
        bs.bit_length() - 1, fluid.gR, float(cfl), _stream(dev))
    _raise_on(err, "euler_pass_a_2d")
    launches["euler_pass_a_2d"] += 1
    return du[0], du[1], nu, dt


def euler_pass_b_2d_ref(fluid: Fluid, P3, du_x, du_y, nu, meta, nbr_table,
                        rows, vals, *, high_order: bool):
    """Plain version of `euler_pass_b_2d`: the torch-op body of
    `block_ops.euler_rhs_grid` for pass B (`scheme.face_b` on each
    face, the divergence a dim with its 2:1 corrections, the dims summed),
    in its order, so that on the CPU it gives that body's R bit for bit."""
    R = None
    for d, du in enumerate((du_x, du_y)):
        h = meta[:, d].view(-1, 1, 1, 1)
        ext = [_faces(p, meta, nbr_table, d, 2 - d)
               for p in (P3, du, nu[..., None])]
        F = face_b(fluid, high_order, d)(tuple(e[0] for e in ext),
                                         tuple(e[1] for e in ext), h, h)
        Fm, Fp = _minus_plus(F * ext[0][2], 2 - d)
        Rd = (Fp - Fm) / h
        _fold_add(Rd, rows, vals, d, 2 - d)
        R = Rd if R is None else R + Rd
    return R


def euler_pass_b_2d(fluid: Fluid, P3, du_x, du_y, nu, meta, nbr_table,
                    rows, vals, *, high_order: bool):
    """2D RHS pass B: ``R [B, bs, bs, 4]`` from the state, the pass-A
    gradients ``du_x``, ``du_y`` [B, bs, bs, 4] and the sensor ``nu`` [B,
    bs, bs], with the 2:1 corrections of R: ``rows`` as in
    `euler_pass_a_2d`, ``vals`` f32 [V, bs, 4]."""
    B, bs = _grid2_geometry(P3)
    dev = P3.device
    g4, g1 = (B, bs, bs, 4), (B, bs, bs)
    _check("P", P3, g4, dev)
    _check("du_x", du_x, g4, dev)
    _check("du_y", du_y, g4, dev)
    _check("nu", nu, g1, dev)
    _check_tables(meta, nbr_table, B, dev)
    _check_rows(rows, vals, B, bs, 4, dev)
    if dev.type == "cpu":
        return euler_pass_b_2d_ref(fluid, P3, du_x, du_y, nu, meta,
                                   nbr_table, rows, vals,
                                   high_order=high_order)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_float4(P=P3, du_x=du_x, du_y=du_y, vals=vals)
    R = torch.empty_like(P3)
    err = build().ibx_euler_pass_b_2d(
        _ptr(P3), _ptr(du_x), _ptr(du_y), _ptr(nu), _ptr(meta),
        _ptr(nbr_table), _ptr(rows), _ptr(vals), _ptr(R), B,
        bs.bit_length() - 1, int(high_order), fluid.R, fluid.cv, fluid.gR,
        _stream(dev))
    _raise_on(err, "euler_pass_b_2d")
    launches["euler_pass_b_2d"] += 1
    return R


# ---------------------------------------------------------------------------
# 2D 2:1 interface faces (row table `BlockTables.ifc_rows`)
# ---------------------------------------------------------------------------

def _ifc_lanes(ifc, bs: int):
    """The cells of the interface faces: per row of ``ifc`` [V, 6] and
    lane i along its edge, the flat id of its own edge cell [V, bs] and of
    the cell each sub-face q = 0, 1 faces (two [V, bs]; the fine side's one
    face is its q = 0, and its q = 1 repeats it), with the row's d, s and
    kind as [V, 1] columns, and [V, bs] True on the lanes of a partial
    coarse row that face its absent (-1) fine neighbor (they face the own
    block's opposite edge line instead, valid ids: their rows are
    zero)."""
    own, d, s, kind, n0, n1 = (c[:, None] for c in ifc.long().unbind(1))
    i = torch.arange(bs, device=ifc.device)

    def edge(b, side, j):
        e = side * (bs - 1)
        return (b * bs + torch.where(d == 0, j, e)) * bs \
            + torch.where(d == 0, e, j)

    nb = torch.where(2 * i < bs, n0, n1)
    absent = (kind == 1) & (nb < 0)
    fine = edge(n0, 1 - s, n1 * (bs // 2) + i // 2)
    theirs = []
    for q in (0, 1):
        m = 2 * i + q
        coarse = edge(torch.where(absent, own, nb), 1 - s, m % bs)
        theirs.append(torch.where(kind == 0, fine, coarse))
    return edge(own, s, i), theirs, d, s, kind, absent


def _ifc_rows_ref(h, ifc, bs: int, operands, face, n_signed: int):
    """The rows of the interface faces, as `scheme
    .interface_corrections` forms them: ``operands(ids, d)`` gives the
    channel parts at flat cell ids, ``face(Wo, Wn, ho, hn, d)`` the face
    values with the owner on the minus side; the first ``n_signed``
    channels flip on s = 0. A fine-side row is (v sgn)/h, a coarse-side row
    ((v_0 + v_1)(sgn/2))/h, with the facing cells' spacing 2h and h/2; a
    lane that faces a partial row's absent neighbor is zero."""
    mine, theirs, d, s, kind, absent = _ifc_lanes(ifc, bs)
    h_own = h[ifc[:, 0].long(), ifc[:, 1].long()][:, None, None]
    coarse = (kind == 1)[..., None]
    up = (s == 1)[..., None]
    h_t = torch.where(coarse, h_own / 2.0, 2.0 * h_own)
    ho, hn = torch.where(up, h_own, h_t), torch.where(up, h_t, h_own)
    Wm = operands(mine, d)
    F = []
    for q in (0, 1):
        Wt = operands(theirs[q], d)
        # the owner of a face is its minus-side cell
        F.append(face(tuple(torch.where(up, a, b) for a, b in zip(Wm, Wt)),
                      tuple(torch.where(up, b, a) for a, b in zip(Wm, Wt)),
                      ho, hn, d))
    ch = torch.arange(F[0].shape[-1], device=ifc.device)
    sgn = torch.where(~up & (ch < n_signed), -1.0, 1.0)
    rows = torch.where(coarse, (F[0] + F[1]) * (sgn * 0.5) / h_own,
                       F[0] * sgn / h_own)
    return torch.where(absent[..., None], 0.0, rows)


def interface_a_2d_ref(fluid: Fluid, P3, h, ifc, *, with_dt: bool):
    """Plain version of `interface_a_2d`: the edge cells gathered by row
    table, `scheme.face_a` on each face (its S_d = |u_d| + a taken on
    the gathered cells), signed and divided as `scheme
    .interface_corrections` does, so that on the CPU it gives the rows of
    that glue bit for bit."""
    cells = P3.reshape(-1, 4)
    fn = face_a(with_dt)

    def operands(idx, d):
        W = cells[idx]
        if not with_dt:
            return (W,)
        ud = torch.where(d[..., None] == 0, W[..., 2:3], W[..., 3:4])
        return (W, ud.abs() + speed_of_sound(fluid, W[..., 1])[..., None])

    return _ifc_rows_ref(h, ifc, P3.shape[1], operands,
                         lambda Wo, Wn, ho, hn, d: fn(Wo, Wn, ho, hn), 5)


def interface_b_2d_ref(fluid: Fluid, P3, du_x, du_y, nu, h, ifc, *,
                       high_order: bool):
    """Plain version of `interface_b_2d`: `scheme.face_b` on each
    interface face from the gathered edge cells of P, du_d and nu (both
    dims' face functions, each row taking its own), signed and divided as
    `scheme.interface_corrections` does: on the CPU the rows of that
    glue bit for bit."""
    cells, gx, gy = (x.reshape(-1, 4) for x in (P3, du_x, du_y))
    nu_c = nu.reshape(-1, 1)
    fns = [face_b(fluid, high_order, d) for d in range(2)]

    def operands(idx, d):
        return (cells[idx], torch.where(d[..., None] == 0, gx[idx], gy[idx]),
                nu_c[idx])

    def face(Wo, Wn, ho, hn, d):
        return torch.where(d[..., None] == 0, fns[0](Wo, Wn, ho, hn),
                           fns[1](Wo, Wn, ho, hn))

    return _ifc_rows_ref(h, ifc, P3.shape[1], operands, face, 4)


def _check_ifc(h, ifc, B: int, device) -> None:
    _check("h", h, (B, 2), device)
    if ifc.device != device or ifc.dtype != torch.int32 or ifc.dim() != 2 \
            or ifc.shape[1] != 6 or not ifc.is_contiguous():
        raise ValueError("ifc must be a contiguous int32 [V, 6] tensor on "
                         f"{device}")


def interface_a_2d(fluid: Fluid, P3, h, ifc, *, with_dt: bool):
    """Pass A's 2:1 interface rows at nd = 2: ``vals [V, bs, 7 | 6]``,
    `scheme.face_a`'s channels [du (4), G, U (, sf)] on the faces of
    each row of ``ifc`` (`BlockTables.ifc_rows`, rows in the order
    `BlockTables.fold_rows` numbers them) with ``h`` the blocks' spacing
    [B, 2]: the compact corrections of `euler_pass_a_2d`."""
    B, bs = _grid2_geometry(P3)
    dev = P3.device
    _check("P", P3, (B, bs, bs, 4), dev)
    _check_ifc(h, ifc, B, dev)
    if dev.type == "cpu":
        return interface_a_2d_ref(fluid, P3, h, ifc, with_dt=with_dt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_float4(P=P3)
    V = ifc.shape[0]
    vals = torch.empty((V, bs, 7 if with_dt else 6), dtype=P3.dtype,
                       device=dev)
    err = build().ibx_interface_a_2d(
        _ptr(P3), _ptr(h), _ptr(ifc), _ptr(vals), V * bs,
        bs.bit_length() - 1, int(with_dt), fluid.gR, _stream(dev))
    _raise_on(err, "interface_a_2d")
    launches["interface_a_2d"] += 1
    return vals


def interface_b_2d(fluid: Fluid, P3, du_x, du_y, nu, h, ifc, *,
                   high_order: bool):
    """Pass B's 2:1 interface rows at nd = 2: ``vals [V, bs, 4]``,
    `scheme.face_b` on the faces of each row of ``ifc`` from the state,
    the pass-A gradients ``du_x``, ``du_y`` [B, bs, bs, 4] and the sensor
    ``nu`` [B, bs, bs]: the compact corrections of `euler_pass_b_2d`."""
    B, bs = _grid2_geometry(P3)
    dev = P3.device
    g4 = (B, bs, bs, 4)
    _check("P", P3, g4, dev)
    _check("du_x", du_x, g4, dev)
    _check("du_y", du_y, g4, dev)
    _check("nu", nu, (B, bs, bs), dev)
    _check_ifc(h, ifc, B, dev)
    if dev.type == "cpu":
        return interface_b_2d_ref(fluid, P3, du_x, du_y, nu, h, ifc,
                                  high_order=high_order)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_float4(P=P3, du_x=du_x, du_y=du_y)
    V = ifc.shape[0]
    vals = torch.empty((V, bs, 4), dtype=P3.dtype, device=dev)
    err = build().ibx_interface_b_2d(
        _ptr(P3), _ptr(du_x), _ptr(du_y), _ptr(nu), _ptr(h), _ptr(ifc),
        _ptr(vals), V * bs, bs.bit_length() - 1, int(high_order), fluid.R,
        fluid.cv, fluid.gR, _stream(dev))
    _raise_on(err, "interface_b_2d")
    launches["interface_b_2d"] += 1
    return vals
