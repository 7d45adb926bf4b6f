// euler_pass_b: RHS pass B on the channel-split block grid.
//
// Replaces the Pallas kernel `_kernel_b` / `run_kernel_b` of
// ibx/ops/pallas_rhs.py (with its helpers `_face_b` and `_hll_flux`), in
// both of its variants: the default (no `have_cols`), which reads gradients
// whose 2:1 corrections the glue has already added, and the `have_cols`
// fold (`_edge_corr`), which adds them as it loads (template FOLD below).
// Per cell and dim d, each of the cell's two faces along d gets:
//   MUSCL slopes limited by minmod, the JST blend with
//   D = max(nu_o, nu_n, 1e-7), the optional high-order face value, and the
//   HLL flux with the reference's one-sided wave speeds
//   SL = max(uL + aL, 0), SR = min(uR - aR, 0);
// and R = sum_d (F_plus - F_minus)/h with F = -HLL. A face on a 2:1 block
// edge (edge_valid = 0) is zeroed; the glue adds the interface corrections
// afterwards. Expressions and operand order follow the JAX kernel.
//
// Bound on an H100: each cell reads P (5), du (15) and nu (1) and writes R
// (5): 26 float channels, 0.165 ms at 5,308,416 cells and 3.35 TB/s. Its
// float32 arithmetic, about 1.2 kflop a cell with every face evaluated
// from both sides, is about 0.1 ms at 67 TFLOP/s, so bytes bound it.
// Design: one thread per cell evaluates its minus and plus faces itself
// (the same expression as the TPU kernel's shifted minus face, so the
// same value), reading neighbors directly as in pass A. That doubles the
// flux arithmetic against a once-per-face evaluation but needs no
// cross-thread exchange; the TPU "shift F_minus and patch the far plane"
// trick is not carried over.
//
// The fold: the TPU kernel takes 12 placed full-B operands (own block's
// corrections for both sides of every dim, and each neighbor slot's
// correction gathered at the neighbor) and adds them to whole gradient
// blocks before its shifts. Here a correction belongs to the block whose
// gradient is read: `load_du` adds block r.b's side-s row whenever the
// cell r it reads lies on the side-s edge of r.b along d. That covers the
// own cell, an own edge cell read by an interior neighbor, the mirrored own
// cell of a bnd side and a neighbor block's used edge with one rule. The
// operands are compact: `rows` [B, 6] gives, per block and (d, s), a row of
// `vals` [V, 5, bs*bs] (-1 where the block has no interface there), with
// the lateral index hi-major over the other two dims ((y, x) for d = 2,
// (z, x) for d = 1, (z, y) for d = 0). On the 5.3M-cell sphere V = 1440
// rows (7.4 MB) against 79 MB for the TPU's 12 placed operands. The value
// loaded is du + c, one float32 add as in the pre-add path, so the folded
// R equals the pre-added R up to FMA contraction.

#include "block_cells.cuh"

namespace {

struct Gas {
  float R, cv, gR;
};

// Compact 2:1 gradient corrections of the fold (see the head comment).
struct Fold {
  const int* rows;    // [B, 6], row of (d, s) at 2d + s
  const float* vals;  // [V, 5, bs*bs]
};

// The 5 gradient channels of dim d at cell r, with FOLD the block's 2:1
// correction added where r lies on a side-s edge of its block along d
// (the value the pre-add path would have stored in du).
template <bool FOLD>
__device__ __forceinline__ void load_du(const float* __restrict__ du,
                                        CellRef r, int d, int lbs, int npb,
                                        Fold f, float* out) {
#pragma unroll
  for (int c = 0; c < 5; ++c) out[c] = du[cell_at(r, 15, 5 * d + c, npb)];
  if (!FOLD) return;
  const int bs = 1 << lbs;
  const int cd = (r.w >> (lbs * d)) & (bs - 1);
  if (cd != 0 && cd != bs - 1) return;
  const int row = f.rows[6LL * r.b + 2 * d + (cd == 0 ? 0 : 1)];
  if (row < 0) return;
  const int nl = bs * bs;
  const int l = d == 2   ? (r.w & (nl - 1))
                : d == 1 ? (((r.w >> (2 * lbs)) << lbs) | (r.w & (bs - 1)))
                         : (r.w >> lbs);
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    out[c] = out[c] + f.vals[((long long)row * 5 + c) * nl + l];
  }
}

__device__ __forceinline__ float sgnf(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

// One side of the HLL flux: conservative state Q, directed flux F, normal
// velocity and speed of sound (`_hll_flux.side`).
__device__ __forceinline__ void hll_side(const float* X, int d, Gas g,
                                         float* Q, float* F, float& un,
                                         float& aa) {
  const float p = X[0];
  const float T = fmaxf(X[1], 10.f);
  const float u = X[2], v = X[3], w = X[4];
  const float kin = (u * u + v * v + w * w) / 2;
  const float rho = p / (g.R * T);
  const float E = rho * (g.cv * T + kin);
  Q[0] = rho;
  Q[1] = E;
  Q[2] = rho * u;
  Q[3] = rho * v;
  Q[4] = rho * w;
  un = X[2 + d];
  F[0] = rho * un;
  F[1] = (E + p) * un;
#pragma unroll
  for (int k = 0; k < 3; ++k) F[2 + k] = Q[2 + k] * un;
  F[2 + d] = F[2 + d] + p;
  aa = sqrtf(g.gR * T);
}

// -HLL flux of the MUSCL-reconstructed face between owner o (minus side)
// and neighbor n (`_face_b` with ho = hn = h).
__device__ __forceinline__ void face_b(int d, float h, bool high_order,
                                       const float* Po, const float* Pn,
                                       const float* duo, const float* dun,
                                       float Do, float Dn, Gas g,
                                       float* out) {
  const float down = h / 2, dneigh = h / 2;
  const float D = fmaxf(fmaxf(Do, Dn), 1e-7f);
  float PL[5], PR[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float grad_f = (Pn[c] - Po[c]) / (down + dneigh);
    const float slope_o = (2 * duo[c] - grad_f) * down;
    const float slope_n = (2 * dun[c] - grad_f) * dneigh;
    const float lim = fminf(fabsf(slope_n), fabsf(slope_o)) *
                      (sgnf(slope_n) + sgnf(slope_o)) / 2;
    float uf = (Po[c] * dneigh + Pn[c] * down) / (down + dneigh);
    if (high_order) uf = uf + (duo[c] * down - dun[c] * dneigh) / 8;
    PL[c] = (Po[c] + lim) * D + (1.f - D) * uf;
    PR[c] = (Pn[c] - lim) * D + (1.f - D) * uf;
  }
  float QL[5], FL[5], QR[5], FR[5], uL, aL, uR, aR;
  hll_side(PL, d, g, QL, FL, uL, aL);
  hll_side(PR, d, g, QR, FR, uR, aR);
  const float SL = fmaxf(uL + aL, 0.f);
  const float SR = fminf(uR - aR, 0.f);
  const float denom = SL - SR;
  const bool safe = denom > 0.f;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float f =
        safe ? (SL * FL[k] - SR * FR[k] + SR * SL * (QR[k] - QL[k])) / denom
             : 0.f;
    out[k] = -f;
  }
}

template <bool FOLD>
__global__ void euler_pass_b_kernel(
    const float* __restrict__ P, const float* __restrict__ du,
    const float* __restrict__ nu, const float* __restrict__ meta,
    const int* __restrict__ nbr, Fold fold, float* __restrict__ R,
    int n_blocks, int lbs, int high_order, Gas g) {
  const int npb = 1 << (3 * lbs);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_blocks * npb) return;
  const int b = (int)(i >> (3 * lbs));
  const int w = (int)(i & (npb - 1));
  const int bs = 1 << lbs;
  const float* m = meta + 16LL * b;
  const int* nb = nbr + 8LL * b;
  const CellRef own{b, w};

  float x[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) x[c] = P[cell_at(own, 5, c, npb)];
  const float D = nu[cell_at(own, 1, 0, npb)];

  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int cd = (w >> (lbs * d)) & (bs - 1);
    const float h = m[d];
    const float ev_l = cd == 0 ? m[3 + 2 * d] : 1.f;
    const float ev_r = cd == bs - 1 ? m[4 + 2 * d] : 1.f;
    const CellRef rm = neighbor_cell(b, w, d, 0, lbs, m, nb);
    const CellRef rp = neighbor_cell(b, w, d, 1, lbs, m, nb);
    float g0[5], gm[5], gp[5], xm[5], xp[5];
    load_du<FOLD>(du, own, d, lbs, npb, fold, g0);
    load_du<FOLD>(du, rm, d, lbs, npb, fold, gm);
    load_du<FOLD>(du, rp, d, lbs, npb, fold, gp);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      xm[c] = P[cell_at(rm, 5, c, npb)];
      xp[c] = P[cell_at(rp, 5, c, npb)];
    }
    const float Dm = nu[cell_at(rm, 1, 0, npb)];
    const float Dp = nu[cell_at(rp, 1, 0, npb)];
    float Fm[5], Fp[5];
    face_b(d, h, high_order != 0, xm, x, gm, g0, Dm, D, g, Fm);
    face_b(d, h, high_order != 0, x, xp, g0, gp, D, Dp, g, Fp);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      acc[c] = acc[c] + (Fp[c] * ev_r - Fm[c] * ev_l) / h;
    }
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) R[cell_at(own, 5, c, npb)] = acc[c];
}

}  // namespace

// P [B, 5, npb], du [B, 15, npb], nu [B, 1, npb] -> R [B, 5, npb].
// fold_rows [B, 6] and fold_vals [V, 5, bs*bs] are the fold's operands, or
// both null for the default variant. Returns cudaGetLastError() after the
// launch.
extern "C" int ibx_euler_pass_b(const float* P, const float* du,
                                const float* nu, const float* meta,
                                const int* nbr, const int* fold_rows,
                                const float* fold_vals, float* R,
                                int n_blocks, int lbs, int high_order,
                                float gas_R, float cv, float gR,
                                void* stream) {
  const int threads = 256;
  const long long n = (long long)n_blocks << (3 * lbs);
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const Fold fold{fold_rows, fold_vals};
  const Gas g{gas_R, cv, gR};
  cudaStream_t st = (cudaStream_t)stream;
  if (fold_rows != nullptr) {
    euler_pass_b_kernel<true><<<blocks, threads, 0, st>>>(
        P, du, nu, meta, nbr, fold, R, n_blocks, lbs, high_order, g);
  } else {
    euler_pass_b_kernel<false><<<blocks, threads, 0, st>>>(
        P, du, nu, meta, nbr, fold, R, n_blocks, lbs, high_order, g);
  }
  return (int)cudaGetLastError();
}
