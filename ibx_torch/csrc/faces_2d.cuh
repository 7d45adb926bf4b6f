// Shared device helpers of the 2D block march's kernels: the dense passes
// (euler_pass_a_2d.cu, euler_pass_b_2d.cu) and the 2:1 interface faces
// (interface_2d.cu). An interface face is evaluated by the same functions
// as a dense face, so that it rounds like one.
//
// Layout: the march's cell-major grid [B, bs, bs, 4], one float4 a cell
// (p, T, u, v), cell (b, y, x) at (b bs + y) bs + x.
//
// Per-block tables (built by ibx_torch.topology.blocks.BlockTables):
//   meta [B, 16] f32: h_d (0, 1), edge_valid[d][s] (3 + 2d + s),
//                     bnd[d][s] (9 + 2d + s), pad;
//   nbr  [B, 8] i32:  dense neighbor block of side (d, s) at 2d + s;
//   rows [B, 4] i32:  the block's row of the compact 2:1 corrections for
//                     side (d, s) at 2d + s, or -1 (`fold_rows`).
#pragma once

#include <cuda_runtime.h>

namespace ibx {

struct Gas {
  float R, cv, gR;
};

// The tables of one mesh block: h_d (0, 1), edge_valid[d][s] (3 + 2d + s),
// bnd[d][s] (9 + 2d + s), the neighbor of side (d, s) and the fold's rows.
struct Block2 {
  float m[16];
  int nb[4];
  int row[4];
};

__device__ __forceinline__ void load_block(Block2& bi,
                                           const float* __restrict__ meta,
                                           const int* __restrict__ nbr,
                                           const int* __restrict__ rows,
                                           int b) {
  for (int i = threadIdx.x; i < 24; i += blockDim.x) {
    if (i < 16) {
      bi.m[i] = meta[16LL * b + i];
    } else if (i < 20) {
      bi.nb[i - 16] = nbr[8LL * b + (i - 16)];
    } else {
      bi.row[i - 20] = rows[4LL * b + (i - 20)];
    }
  }
}

// Source cell (block, y, x) of the halo slot of side q = 2d + s at lateral
// index j: the neighbor block's opposite edge cell, or the own edge cell
// on a bnd side.
template <int BS>
__device__ __forceinline__ long long halo_cell(const Block2& bi, int b,
                                               int q, int j) {
  const int d = q >> 1, s = q & 1;
  const bool bnd = bi.m[9 + q] > 0.f;
  const int e = bnd ? (s ? BS - 1 : 0) : (s ? 0 : BS - 1);
  const long long src = bnd ? b : bi.nb[q];
  return (src * BS + (d == 0 ? j : e)) * BS + (d == 0 ? e : j);
}

// Tile slot of the halo cell of side q at lateral index j.
template <int BS>
__device__ __forceinline__ int halo_slot(int q, int j) {
  constexpr int TW = BS + 2;
  return q == 0   ? (j + 1) * TW
         : q == 1 ? (j + 1) * TW + BS + 1
         : q == 2 ? j + 1
                  : (BS + 1) * TW + j + 1;
}

// x / y, correctly rounded, from r = RN(1/y): q = RN(x r) is within an
// ulp of x / y, the remainder x - q y is exact in one FMA, and one
// correction with r rounds the quotient correctly (Markstein's theorem;
// outside the subnormal and overflow ranges, which no finite state
// reaches here).
__device__ __forceinline__ float div_by(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

// The face value (a wa + b wb)/den, each operation rounded once (rden =
// RN(1/den)): `block_ops.face_a`'s (P_o h_n + P_n h_o)/(h_o + h_n) with a
// = P_o, wa = h_n, b = P_n, wb = h_o.
__device__ __forceinline__ float face_mean(float a, float b, float wa,
                                           float wb, float den, float rden) {
  return div_by(__fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb)), den, rden);
}

// The dense face value (a h + b h)/(h + h) m (h2 = h + h, r2 = RN(1/h2)).
__device__ __forceinline__ float face_avg(float a, float b, float h, float h2,
                                          float r2, float m) {
  return __fmul_rn(face_mean(a, b, h, h, h2, r2), m);
}

// The sound speed sqrt(gR max(T, 10)), each operation rounded once.
__device__ __forceinline__ float sound(float gR, float T) {
  return __fsqrt_rn(__fmul_rn(gR, fmaxf(T, 10.f)));
}

__device__ __forceinline__ float sgnf(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

__device__ __forceinline__ void unpack(float4 v, float* a) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// One side of the HLL flux along dim d: conservative state Q, directed
// flux F, normal velocity and speed of sound (`_flux_one_side`).
__device__ __forceinline__ void hll_side(const float* X, int d, Gas g,
                                         float* Q, float* F, float& un,
                                         float& aa) {
  const float p = X[0];
  const float T = fmaxf(X[1], 10.f);
  const float u = X[2], v = X[3];
  const float kin = (u * u + v * v) / 2;
  const float rho = p / (g.R * T);
  const float E = rho * (g.cv * T + kin);
  Q[0] = rho;
  Q[1] = E;
  Q[2] = rho * u;
  Q[3] = rho * v;
  un = d == 0 ? u : v;
  F[0] = rho * un;
  F[1] = (E + p) * un;
  F[2] = Q[2] * un + (d == 0 ? p : 0.f);
  F[3] = Q[3] * un + (d == 0 ? 0.f : p);
  aa = sqrtf(g.gR * T);
}

// -HLL flux of the MUSCL-reconstructed face between o (minus side) and n
// (`face_b`: down = h_o/2, dneigh = h_n/2, iden = 1/(down + dneigh); a
// dense face has down = dneigh = h/2 and iden = 1/h).
__device__ __forceinline__ void face_b(int d, float down, float dneigh,
                                       float iden, bool high_order,
                                       const float* Po, const float* Pn,
                                       const float* go, const float* gn,
                                       float Do, float Dn, Gas g,
                                       float* out) {
  const float Db = fmaxf(fmaxf(Do, Dn), 1e-7f);
  float PL[4], PR[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float grad_f = (Pn[c] - Po[c]) * iden;
    const float slope_o = (2 * go[c] - grad_f) * down;
    const float slope_n = (2 * gn[c] - grad_f) * dneigh;
    const float lim = fminf(fabsf(slope_n), fabsf(slope_o)) *
                      (sgnf(slope_n) + sgnf(slope_o)) / 2;
    float uf = (Po[c] * dneigh + Pn[c] * down) * iden;
    if (high_order) uf = uf + (go[c] * down - gn[c] * dneigh) / 8;
    PL[c] = (Po[c] + lim) * Db + (1.f - Db) * uf;
    PR[c] = (Pn[c] - lim) * Db + (1.f - Db) * uf;
  }
  float QL[4], FL[4], QR[4], FR[4], uL, aL, uR, aR;
  hll_side(PL, d, g, QL, FL, uL, aL);
  hll_side(PR, d, g, QR, FR, uR, aR);
  const float SL = fmaxf(uL + aL, 0.f);
  const float SR = fminf(uR - aR, 0.f);
  const float denom = SL - SR;
  const bool safe = denom > 0.f;
  const float inv = 1.f / denom;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float f =
        safe ? (SL * FL[k] - SR * FR[k] + SR * SL * (QR[k] - QL[k])) * inv
             : 0.f;
    out[k] = -f;
  }
}

}  // namespace ibx
