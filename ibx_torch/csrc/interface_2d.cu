// interface_a_2d, interface_b_2d: the 2:1 interface faces of the 2D block
// march, the compact correction rows that passes A and B fold in.
//
// Replace no TPU kernel: the JAX package leaves the 2:1 glue to XLA ops
// (`interface_corrections` in ibx/ops/block_ops.py). They replace the
// port's torch-op glue at nd = 2 (`block_ops.interface_corrections` over
// the edge lines, once a dim and pass). A 2:1 face lies between a block's
// edge cell and a cell of a neighbor block twice or half its size along
// the edge. Per interface row r (a block side (d, s) on a 2:1 interface,
// in the order `BlockTables.fold_rows` numbers them) and lane i along the
// edge (y for d = 0, x for d = 1), with h the own block's spacing along d:
//   fine side: one face, against cell fs_off bs/2 + i/2 of the coarse
//     neighbor's facing edge line, whose spacing is 2h;
//   coarse side: two sub-faces, against cells 2i and 2i + 1 of the two
//     fine neighbors' facing edge lines laid end to end, spacing h/2. A
//     partial coarse row (a sharded rank's halo block, one of whose fine
//     neighbors lies beyond the local grid) has -1 for that neighbor: the
//     lanes that face it read nothing and write zero, as the torch-op body
//     gives those cells no face on that side.
// The owner of a face is its minus-side cell, so on s = 1 it is the own
// cell and on s = 0 the neighbor's. Pass A's face (`block_ops.face_a`):
//   Pf = (P_o h_n + P_n h_o)/(h_o + h_n), fd = p_n - p_o, |fd| and, with
//   dt, (S_o h_n + S_n h_o)/(h_o + h_n), S = |u_d| + a;
// pass B's (`block_ops.face_b`): -HLL of the MUSCL-reconstructed face with
// the JST blend. The row is (v sgn)/h on the fine side and
// ((v_0 + v_1)(sgn/2))/h on the coarse side, where sgn is -1 on the signed
// channels (du, G; all four of R) on s = 0 and 1 otherwise.
//
// Row table `ifc` [V, 6] int32 (`BlockTables.ifc_rows`): own block, d, s,
// kind (0 fine side, 1 coarse side), then the coarse neighbor and fs_off
// on the fine side, the two fine neighbors (low, high; -1 where absent) on
// the coarse side.
// Output `vals` [V, bs, K], K = 7 (6 without dt) channels [du (4), G, U
// (, sf)] for pass A and 4 (R) for pass B.
//
// Bound on an H100: at the flagship's size (2208 rows of 16 lanes, about
// 47,000 faces a pass) launch and latency, not bytes. The byte bound is
// one read of each edge cell's operands (every neighbor cell of a 2:1
// face lies on an interface row's own edge line: P for pass A; P, du_d
// and nu for pass B) and one write of each row: 44 or 40 bytes a lane for
// pass A, 52 for pass B, about 0.5 us a launch.
//
// Design: one thread per (row, lane), 128 a CUDA block, so any bs in
// STENCIL_BLOCK_SIZES maps the same way. A thread reads its row of the
// table, its own edge cell, and the one or two facing cells straight from
// the grids (L2-resident at this size), evaluates its one or two faces
// with the dense passes' device functions (faces_2d.cuh: pass A's rounded
// once each, as its plain version, pass B's as pass B's) and writes its
// row lane. The rows of one kind lie together in the table, so a warp
// splits only where the fine rows of a side end.

#include "faces_2d.cuh"

namespace {

using namespace ibx;

constexpr int THREADS = 128;

// Cell id of lane j of block b's side-s edge line along d.
__device__ __forceinline__ long long edge_cell(int b, int d, int s, int j,
                                               int lbs) {
  const int bs = 1 << lbs, e = s ? bs - 1 : 0;
  return (((long long)b << lbs) + (d == 0 ? j : e)) * bs + (d == 0 ? e : j);
}

// Thread t's interface row r and lane i: the row's d, s and kind, the own
// edge cell and the own block's spacing h along d.
struct Lane {
  int d, s, coarse, r, i;
  long long cell;
  float h;
};

__device__ __forceinline__ Lane lane_of(const int* __restrict__ ifc,
                                        const float* __restrict__ h, int t,
                                        int lbs) {
  Lane l;
  l.r = t >> lbs;
  l.i = t & ((1 << lbs) - 1);
  const int* row = ifc + 6LL * l.r;
  const int own = row[0];
  l.d = row[1];
  l.s = row[2];
  l.coarse = row[3];
  l.cell = edge_cell(own, l.d, l.s, l.i, lbs);
  l.h = h[2LL * own + l.d];
  return l;
}

// The cell that sub-face q of a lane faces: on the fine side (q = 0 only)
// cell fs_off bs/2 + i/2 of the coarse neighbor's facing edge line; on the
// coarse side cell 2i + q of the fine neighbors' lines laid end to end.
__device__ __forceinline__ long long facing_cell(const int* __restrict__ ifc,
                                                 const Lane& l, int q,
                                                 int lbs) {
  const int bs = 1 << lbs;
  const int* row = ifc + 6LL * l.r;
  if (!l.coarse) {
    return edge_cell(row[4], l.d, 1 - l.s, row[5] * (bs >> 1) + (l.i >> 1),
                     lbs);
  }
  const int m = 2 * l.i + q;
  return edge_cell(m < bs ? row[4] : row[5], l.d, 1 - l.s, m & (bs - 1), lbs);
}

// Whether the lane is one of a partial coarse row's that face its absent
// fine neighbor: lanes i < bs/2 face the low one, the others the high one.
__device__ __forceinline__ bool absent(const int* __restrict__ ifc,
                                       const Lane& l, int lbs) {
  return l.coarse && ifc[6LL * l.r + (2 * l.i < (1 << lbs) ? 4 : 5)] < 0;
}

// Pass A's face between o (minus side) and n, each operation rounded once.
template <int K>
__device__ __forceinline__ void face_a(float4 o, float4 n, float ho,
                                       float hn, int d, float gR,
                                       float* out) {
  const float den = __fadd_rn(ho, hn), rden = __frcp_rn(den);
  float po[4], pn[4];
  unpack(o, po);
  unpack(n, pn);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out[c] = face_mean(po[c], pn[c], hn, ho, den, rden);
  }
  const float fd = __fsub_rn(pn[0], po[0]);
  out[4] = fd;
  out[5] = fd >= 0.f ? fd : -fd;  // `abs_select`
  if (K == 7) {
    const float So =
        __fadd_rn(fabsf(d == 0 ? po[2] : po[3]), sound(gR, po[1]));
    const float Sn =
        __fadd_rn(fabsf(d == 0 ? pn[2] : pn[3]), sound(gR, pn[1]));
    out[6] = face_mean(So, Sn, hn, ho, den, rden);
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    interface_a_2d_kernel(const float4* __restrict__ P,
                          const float* __restrict__ h,
                          const int* __restrict__ ifc,
                          float* __restrict__ vals, int n, int lbs,
                          float gR) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const Lane l = lane_of(ifc, h, t, lbs);
  float* out = vals + (long long)t * K;
  if (absent(ifc, l, lbs)) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = 0.f;
    return;
  }
  const float4 c = P[l.cell];
  // the facing cells' spacing: 2h on the fine side, h/2 on the coarse
  const float hf = l.coarse ? __fmul_rn(l.h, 0.5f) : __fmul_rn(2.f, l.h);
  const float ho = l.s ? l.h : hf, hn = l.s ? hf : l.h;
  float tot[K];
#pragma unroll 1
  for (int q = 0; q <= l.coarse; ++q) {
    const float4 f = P[facing_cell(ifc, l, q, lbs)];
    float F[K];
    face_a<K>(l.s ? c : f, l.s ? f : c, ho, hn, l.d, gR, F);
#pragma unroll
    for (int k = 0; k < K; ++k) tot[k] = q ? __fadd_rn(tot[k], F[k]) : F[k];
  }
  const float rh = __frcp_rn(l.h);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // du (4) and G are signed, U and sf are not
    const float sg = (l.s || k > 4) ? 1.f : -1.f;
    out[k] = div_by(__fmul_rn(tot[k], l.coarse ? 0.5f * sg : sg), l.h, rh);
  }
}

template <int K>
int launch_a(const float* P, const float* h, const int* ifc, float* vals,
             int n, int lbs, float gR, cudaStream_t st) {
  interface_a_2d_kernel<K><<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      reinterpret_cast<const float4*>(P), h, ifc, vals, n, lbs, gR);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(THREADS)
    interface_b_2d_kernel(const float4* __restrict__ P,
                          const float4* __restrict__ du_x,
                          const float4* __restrict__ du_y,
                          const float* __restrict__ nu,
                          const float* __restrict__ h,
                          const int* __restrict__ ifc,
                          float4* __restrict__ vals, int n, int lbs,
                          int high_order, Gas g) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const Lane l = lane_of(ifc, h, t, lbs);
  if (absent(ifc, l, lbs)) {
    vals[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float4* du = l.d == 0 ? du_x : du_y;
  float Pc[4], gc[4];
  unpack(P[l.cell], Pc);
  unpack(du[l.cell], gc);
  const float Dc = nu[l.cell];
  const float hf = l.coarse ? l.h * 0.5f : 2.f * l.h;
  const float down = (l.s ? l.h : hf) / 2, dneigh = (l.s ? hf : l.h) / 2;
  const float iden = 1.f / (down + dneigh);
  float tot[4];
#pragma unroll 1
  for (int q = 0; q <= l.coarse; ++q) {
    const long long fc = facing_cell(ifc, l, q, lbs);
    float Pf[4], gf[4], Po[4], Pn[4], go[4], gn[4], F[4];
    unpack(P[fc], Pf);
    unpack(du[fc], gf);
    const float Df = nu[fc];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      Po[k] = l.s ? Pc[k] : Pf[k];
      Pn[k] = l.s ? Pf[k] : Pc[k];
      go[k] = l.s ? gc[k] : gf[k];
      gn[k] = l.s ? gf[k] : gc[k];
    }
    face_b(l.d, down, dneigh, iden, high_order != 0, Po, Pn, go, gn,
           l.s ? Dc : Df, l.s ? Df : Dc, g, F);
#pragma unroll
    for (int k = 0; k < 4; ++k) tot[k] = q ? tot[k] + F[k] : F[k];
  }
  // every channel of R is signed
  const float sg = l.s ? 1.f : -1.f;
  const float m = l.coarse ? 0.5f * sg : sg;
  vals[t] = make_float4(tot[0] * m / l.h, tot[1] * m / l.h, tot[2] * m / l.h,
                        tot[3] * m / l.h);
}

}  // namespace

// P [B, bs, bs, 4], h [B, 2], ifc [V, 6] -> vals [V, bs, 7] (with_dt) or
// [V, bs, 6]; n = V bs threads, lbs = log2(bs). Returns the launch's CUDA
// error.
extern "C" int ibx_interface_a_2d(const float* P, const float* h,
                                  const int* ifc, float* vals, int n,
                                  int lbs, int with_dt, float gR,
                                  void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return with_dt ? launch_a<7>(P, h, ifc, vals, n, lbs, gR, st)
                 : launch_a<6>(P, h, ifc, vals, n, lbs, gR, st);
}

// P, du_x, du_y [B, bs, bs, 4], nu [B, bs, bs], h [B, 2], ifc [V, 6] ->
// vals [V, bs, 4]; n = V bs threads. Returns the launch's CUDA error.
extern "C" int ibx_interface_b_2d(const float* P, const float* du_x,
                                  const float* du_y, const float* nu,
                                  const float* h, const int* ifc,
                                  float* vals, int n, int lbs,
                                  int high_order, float gas_R, float cv,
                                  float gR, void* stream) {
  if (n == 0) return 0;
  const Gas g{gas_R, cv, gR};
  interface_b_2d_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                          (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(P),
      reinterpret_cast<const float4*>(du_x),
      reinterpret_cast<const float4*>(du_y), nu, h, ifc,
      reinterpret_cast<float4*>(vals), n, lbs, high_order, g);
  return (int)cudaGetLastError();
}
