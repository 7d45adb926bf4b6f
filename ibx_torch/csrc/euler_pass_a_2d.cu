// euler_pass_a_2d: RHS pass A of the 2D block march on the cell-major grid.
//
// Replaces no TPU kernel: the JAX package has no kernel at nd = 2 (its
// block march evaluates the faces with XLA ops). It replaces the torch-op
// face evaluation of `face_accumulate` with `face_a` at nd = 2
// (ibx_torch/ops/block_ops.py) for both dims, and the sensor and dt
// assembly after it. Per face along dim d, between the minus cell o and
// the plus cell n, with the edge mask m (edge_valid on a block edge, 1
// inside):
//   Pf = (P_o h + P_n h)/(h + h) m     face average, 4 channels;
//   fd = (p_n - p_o) m                 pressure difference;
//   sf = (S_o h + S_n h)/(h + h) m     wave speed, S = |u_d| + a (with dt),
// and per cell, from its two faces along d, plus the 2:1 interface
// correction c of its block side where the cell lies on one:
//   du_d = (Pf_plus - Pf_minus)/h + c          Green-Gauss gradient;
//   G_d  = (fd_plus - fd_minus)/h + c          signed pressure sum;
//   U_d  = (|fd_plus| + |fd_minus|)/h + c      absolute sum;
//   sf_d = (sf_plus + sf_minus)/h + c          wave-speed sum (with dt);
// then nu = max(1e-7, max_d (1e-7 + |G_d|)/(1e-7 + U_d)), the JST sensor,
// and dt = cfl/(sf_0 + sf_1), the local time step. A one-sided boundary
// side (bnd) mirrors the own edge. The corrections come compact, as
// interface_a_2d (interface_2d.cu) computes them before the launch from
// the state's edge cells: `rows` [B, 4] gives a block's row of
// `vals` [V, bs, K] for side s of dim d at 2d + s, or -1; a row's index
// along the edge is y for d = 0 and x for d = 1, its K = 7 (6 without dt)
// channels [du (4), G, U (, sf)]. Folding them here keeps G, U and sf out
// of device memory: the kernel writes du, nu and dt only.
//
// Bound on an H100: bytes. Each cell reads P (16 bytes) and writes du for
// both dims (32), nu (4) and, with dt, dt (4): 56 or 52 bytes a cell,
// 0.0147 or 0.0137 ms at 881,152 cells and 3.35 TB/s (the one-cell halo
// ring adds 4 bytes a cell of reads at bs = 16, read once from L2 or
// device memory; not counted). The float32 work, about 45 operations a
// face (fewer without dt), is a tenth of that time. On an H100 at 700 W
// a launch takes 0.030 ms with dt and 0.025 ms without, 51% and 56% of
// that bound (chip_smoke.py phase 10, launches queued behind a sleep).
//
// Design: at nd = 2 the cell-major state [B, bs, bs, 4] is one 16-byte
// float4 a cell, so the kernel reads and writes the layout the march keeps
// (no channel split): one CUDA block per mesh block, one thread per cell.
// The block's tile of P with its one-cell halo ring ((bs+2)^2 float4, 5 KB
// at bs = 16) is staged in shared memory, the halo gathered from the
// neighbor blocks' edges through `nbr`; with dt, each staging thread also
// stores the sound speed of its tile cell. A face of pass A costs a few
// adds and multiplies, so each thread evaluates its own four faces from
// the tile: a face is evaluated by both of its cells, with the same
// operands in the same order, so both see the same value, and no second
// barrier or face buffer is needed. Every output goes out as one coalesced
// store a cell (float4 for du).
//
// Rounding: every operation is the torch-op body's, in its order, rounded
// once (the _rn intrinsics: no FMA contraction; IEEE divides and square
// root; dt as cfl times the reciprocal, as `cfl / tensor` is), so the
// kernel gives its plain version's values bit for bit. A face average
// rounded otherwise moves du by an ulp of P over h: 4e-4 of the largest
// temperature gradient on the smooth test state of chip_smoke.py, where
// multiplies by reciprocals and contracted FMAs were tried. The divides by
// the block's h + h and h, 34 a cell, take its reciprocals once and one
// correction each with the exact remainder (Markstein), which gives the
// correctly rounded quotient away from the subnormal range, in 3
// instructions where an IEEE divide takes a dozen and a branch.

#include "faces_2d.cuh"

namespace {

using namespace ibx;

template <int BS, bool DT>
__global__ void __launch_bounds__(BS * BS)
    euler_pass_a_2d_kernel(const float4* __restrict__ P,
                           const float* __restrict__ meta,
                           const int* __restrict__ nbr,
                           const int* __restrict__ rows,
                           const float* __restrict__ vals,
                           float4* __restrict__ du_x,
                           float4* __restrict__ du_y, float* __restrict__ nu,
                           float* __restrict__ dt, float gR, float cfl) {
  constexpr int NL = BS * BS, TW = BS + 2, TN = TW * TW;
  constexpr int K = DT ? 7 : 6;  // correction channels
  __shared__ float4 sP[TN];
  __shared__ float sA[DT ? TN : 1];
  __shared__ Block2 bi;

  const int b = blockIdx.x, t = threadIdx.x;
  const int y = t / BS, x = t % BS, so = (y + 1) * TW + x + 1;
  load_block(bi, meta, nbr, rows, b);
  {
    const float4 c = P[(long long)b * NL + t];
    sP[so] = c;
    if (DT) sA[so] = sound(gR, c.y);
  }
  __syncthreads();
  for (int i = t; i < 4 * BS; i += NL) {
    const int q = i / BS, j = i % BS, slot = halo_slot<BS>(q, j);
    const float4 c = P[halo_cell<BS>(bi, b, q, j)];
    sP[slot] = c;
    if (DT) sA[slot] = sound(gR, c.y);
  }
  __syncthreads();

  const float4 c = sP[so];
  const float ac = DT ? sA[so] : 0.f;
  float s[2][K];  // per dim: du (4), G, U (, sf)
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int step = d == 0 ? 1 : TW;
    const int k = d == 0 ? x : y;
    const float h = bi.m[d], h2 = h + h;
    const float r = __frcp_rn(h), r2 = __frcp_rn(h2);
    const float mm = k == 0 ? bi.m[3 + 2 * d] : 1.f;
    const float mp = k == BS - 1 ? bi.m[4 + 2 * d] : 1.f;
    const float4 o = sP[so - step], n = sP[so + step];
    const float co[4] = {o.x, o.y, o.z, o.w};
    const float cc[4] = {c.x, c.y, c.z, c.w};
    const float cn[4] = {n.x, n.y, n.z, n.w};
    // the minus face (o, c) and the plus face (c, n)
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const float fm = face_avg(co[ch], cc[ch], h, h2, r2, mm);
      const float fp = face_avg(cc[ch], cn[ch], h, h2, r2, mp);
      s[d][ch] = div_by(__fsub_rn(fp, fm), h, r);
    }
    const float fdm = __fmul_rn(__fsub_rn(c.x, o.x), mm);
    const float fdp = __fmul_rn(__fsub_rn(n.x, c.x), mp);
    s[d][4] = div_by(__fsub_rn(fdp, fdm), h, r);
    s[d][5] = div_by(__fadd_rn(fabsf(fdp), fabsf(fdm)), h, r);
    if (DT) {
      const float Sc = __fadd_rn(fabsf(cc[2 + d]), ac);
      const float So = __fadd_rn(fabsf(co[2 + d]), sA[so - step]);
      const float Sn = __fadd_rn(fabsf(cn[2 + d]), sA[so + step]);
      const float sfm = face_avg(So, Sc, h, h2, r2, mm);
      const float sfp = face_avg(Sc, Sn, h, h2, r2, mp);
      s[d][K - 1] = div_by(__fadd_rn(sfp, sfm), h, r);
    }
    // the 2:1 correction of this cell's block side, if it lies on one
    const int side = k == 0 ? 0 : (k == BS - 1 ? 1 : -1);
    const int row = side < 0 ? -1 : bi.row[2 * d + side];
    if (row >= 0) {
      const float* v = vals + ((long long)row * BS + (d == 0 ? y : x)) * K;
#pragma unroll
      for (int ch = 0; ch < K; ++ch) s[d][ch] = __fadd_rn(s[d][ch], v[ch]);
    }
  }

  const long long cell = (long long)b * NL + t;
  du_x[cell] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
  du_y[cell] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
  float v = 1e-7f;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    v = fmaxf(v, __fdiv_rn(__fadd_rn(1e-7f, fabsf(s[d][4])),
                           __fadd_rn(1e-7f, s[d][5])));
  }
  nu[cell] = v;
  if (DT) {
    dt[cell] = __fmul_rn(__frcp_rn(__fadd_rn(s[0][K - 1], s[1][K - 1])), cfl);
  }
}

template <int BS, bool DT>
int launch(const float* P, const float* meta, const int* nbr,
           const int* rows, const float* vals, float* du_x, float* du_y,
           float* nu, float* dt, int n_blocks, float gR, float cfl,
           cudaStream_t st) {
  euler_pass_a_2d_kernel<BS, DT><<<n_blocks, BS * BS, 0, st>>>(
      reinterpret_cast<const float4*>(P), meta, nbr, rows, vals,
      reinterpret_cast<float4*>(du_x), reinterpret_cast<float4*>(du_y), nu,
      dt, gR, cfl);
  return (int)cudaGetLastError();
}

template <int BS>
int launch_bs(const float* P, const float* meta, const int* nbr,
              const int* rows, const float* vals, float* du_x, float* du_y,
              float* nu, float* dt, int n_blocks, float gR, float cfl,
              cudaStream_t st) {
  return dt != nullptr
             ? launch<BS, true>(P, meta, nbr, rows, vals, du_x, du_y, nu, dt,
                                n_blocks, gR, cfl, st)
             : launch<BS, false>(P, meta, nbr, rows, vals, du_x, du_y, nu,
                                 dt, n_blocks, gR, cfl, st);
}

}  // namespace

// P [B, bs, bs, 4] -> du_x, du_y [B, bs, bs, 4], nu [B, bs, bs] and, where
// dt is not null, dt [B, bs, bs]; rows [B, 4] and vals [V, bs, 7 | 6] are
// the 2:1 corrections. Block sizes 4, 8 and 16 (lbs 2..4;
// cudaErrorInvalidValue otherwise). Returns the launch's CUDA error.
extern "C" int ibx_euler_pass_a_2d(const float* P, const float* meta,
                                   const int* nbr, const int* rows,
                                   const float* vals, float* du_x,
                                   float* du_y, float* nu, float* dt,
                                   int n_blocks, int lbs, float gR,
                                   float cfl, void* stream) {
  if (n_blocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (lbs) {
    case 2:
      return launch_bs<4>(P, meta, nbr, rows, vals, du_x, du_y, nu, dt,
                          n_blocks, gR, cfl, st);
    case 3:
      return launch_bs<8>(P, meta, nbr, rows, vals, du_x, du_y, nu, dt,
                          n_blocks, gR, cfl, st);
    case 4:
      return launch_bs<16>(P, meta, nbr, rows, vals, du_x, du_y, nu, dt,
                           n_blocks, gR, cfl, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
