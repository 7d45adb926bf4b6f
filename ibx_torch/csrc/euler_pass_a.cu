// euler_pass_a: RHS pass A on the channel-split block grid.
//
// Replaces the Pallas kernel `_kernel_a` / `run_kernel_a` of
// ibx/ops/pallas_rhs.py. Per cell and dim d, from the face averages of the
// two faces along d:
//   du[5d + c] = (Pf_plus - Pf_minus)/h      Green-Gauss gradient, 15 ch;
//   aux[d]     = (fd_plus - fd_minus)/h      signed pressure-difference sum G;
//   aux[3 + d] = (|fd_plus| + |fd_minus|)/h  absolute sum U;
//   aux[6 + d] = (sf_plus + sf_minus)/h      wave-speed sum (with_dt only),
// with S = |u_d| + a. A face on a 2:1 block edge (edge_valid = 0) is zeroed;
// the XLA-side glue adds the interface corrections afterwards. A one-sided
// boundary side (bnd) mirrors the own edge. Expressions and operand order
// follow the JAX kernel.
//
// Bound on an H100: bytes. Each cell reads P (5 channels) and writes du
// (15) and aux (9 with dt, 6 without): 29 or 26 float channels a cell,
// 0.184 or 0.165 ms at 5,308,416 cells and 3.35 TB/s. Design: one thread
// per cell reads its neighbors directly (+-1, +-bs, +-bs^2 inside the
// block, the opposite edge cell of the neighbor block at a block edge);
// the six neighbor reads of a cell are the own reads of other threads, so
// they come from L1/L2 and device memory sees each input about once. The
// TPU kernel's whole-neighbor-block over-read and lane rolls are not
// carried over.

#include "block_cells.cuh"

namespace {

__global__ void euler_pass_a_kernel(
    const float* __restrict__ P, const float* __restrict__ meta,
    const int* __restrict__ nbr, float* __restrict__ du,
    float* __restrict__ aux, int n_blocks, int lbs, int with_dt, float gR) {
  const int npb = 1 << (3 * lbs);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_blocks * npb) return;
  const int b = (int)(i >> (3 * lbs));
  const int w = (int)(i & (npb - 1));
  const int bs = 1 << lbs;
  const float* m = meta + 16LL * b;
  const int* nb = nbr + 8LL * b;
  const int n_aux = with_dt ? 9 : 6;
  const CellRef own{b, w};

  float x[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) x[c] = P[cell_at(own, 5, c, npb)];
  const float a = sqrtf(gR * fmaxf(x[1], 10.f));

#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int cd = (w >> (lbs * d)) & (bs - 1);
    const float h = m[d];
    const float ml = cd == 0 ? m[3 + 2 * d] : 1.f;
    const float mr = cd == bs - 1 ? m[4 + 2 * d] : 1.f;
    const CellRef rm = neighbor_cell(b, w, d, 0, lbs, m, nb);
    const CellRef rp = neighbor_cell(b, w, d, 1, lbs, m, nb);
    float xm[5], xp[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      xm[c] = P[cell_at(rm, 5, c, npb)];
      xp[c] = P[cell_at(rp, 5, c, npb)];
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float pf_m = (xm[c] * h + x[c] * h) / (h + h) * ml;
      const float pf_p = (x[c] * h + xp[c] * h) / (h + h) * mr;
      du[cell_at(own, 15, 5 * d + c, npb)] = (pf_p - pf_m) / h;
    }
    const float fd_m = (x[0] - xm[0]) * ml;
    const float fd_p = (xp[0] - x[0]) * mr;
    aux[cell_at(own, n_aux, d, npb)] = (fd_p - fd_m) / h;
    aux[cell_at(own, n_aux, 3 + d, npb)] = (fabsf(fd_p) + fabsf(fd_m)) / h;
    if (with_dt) {
      const float S = fabsf(x[2 + d]) + a;
      const float Sm = fabsf(xm[2 + d]) + sqrtf(gR * fmaxf(xm[1], 10.f));
      const float Sp = fabsf(xp[2 + d]) + sqrtf(gR * fmaxf(xp[1], 10.f));
      const float sf_m = (Sm * h + S * h) / (h + h) * ml;
      const float sf_p = (S * h + Sp * h) / (h + h) * mr;
      aux[cell_at(own, n_aux, 6 + d, npb)] = (sf_p + sf_m) / h;
    }
  }
}

}  // namespace

// P [B, 5, npb] -> du [B, 15, npb], aux [B, 9 | 6, npb]. Returns
// cudaGetLastError() after the launch.
extern "C" int ibx_euler_pass_a(const float* P, const float* meta,
                                const int* nbr, float* du, float* aux,
                                int n_blocks, int lbs, int with_dt, float gR,
                                void* stream) {
  const int threads = 256;
  const long long n = (long long)n_blocks << (3 * lbs);
  const long long blocks = (n + threads - 1) / threads;
  euler_pass_a_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(P, meta, nbr, du, aux,
                                                n_blocks, lbs, with_dt, gR);
  return (int)cudaGetLastError();
}
