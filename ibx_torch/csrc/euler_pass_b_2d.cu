// euler_pass_b_2d: RHS pass B of the 2D block march on the cell-major grid.
//
// Replaces no TPU kernel: the JAX package has no kernel at nd = 2 (its
// block march evaluates the faces with XLA ops). It replaces the torch-op
// face evaluation of `face_accumulate` with `face_b` at nd = 2
// (ibx_torch/ops/block_ops.py) for both dims. Per face along dim d,
// between the minus cell o and the plus cell n: MUSCL slopes limited by
// minmod, the JST blend with D = max(nu_o, nu_n, 1e-7), the optional
// high-order face value, and the HLL flux with the reference's one-sided
// wave speeds SL = max(uL + aL, 0), SR = min(uR - aR, 0); F = -HLL. Per
// cell
//   R = [(F_plus - F_minus)/h + c]_x + [(F_plus - F_minus)/h + c]_y,
// with c the 2:1 interface correction of the cell's block side along that
// dim where it lies on one, added before the two dims are summed, as the
// torch-op body adds it. A face on a 2:1 block edge (edge_valid = 0) is
// zero and not evaluated; a one-sided boundary side (bnd) mirrors the own
// edge. The corrections come compact from interface_b_2d
// (interface_2d.cu, on the edge cells of P, du_d and nu): `rows` [B, 4]
// gives a block's row of `vals` [V, bs, 4] for side s
// of dim d at 2d + s, or -1; a row's index along the edge is y for d = 0
// and x for d = 1. So R is written whole, once.
//
// Bound on an H100: bytes. Each cell reads P, du_x, du_y (16 bytes each)
// and nu (4) and writes R (16): 68 bytes a cell, 0.0179 ms at 881,152
// cells and 3.35 TB/s (the halo ring's reads, about 10 bytes a cell at
// bs = 16, not counted). The float32 work is 2 + 2/bs face evaluations a
// cell of about 230 operations (0.0065 ms at 67 TFLOP/s if every add,
// mul, divide and square root were one instruction; the divides and
// square roots are sequences of about ten), so issue and latency, and not
// the bytes, set the pace, as in the 3D pass B: on an H100 at 700 W a
// launch takes 0.044 ms, 41% of the byte bound (chip_smoke.py phase 10).
//
// Design: one CUDA block per mesh block, one thread per cell, on the
// layout the march keeps (float4 a cell: no channel split). The block's
// tiles with their one-cell halo ring are staged in shared memory: P and
// nu on all four sides, du_x on the x sides and du_y on the y sides
// (17 KB at bs = 16), the halo gathered from the neighbor blocks' edges
// through `nbr`. The block's threads then share out its bs(bs+1) x faces
// and bs(bs+1) y faces, each evaluated once into a shared flux buffer (8.5
// KB), and each thread differences its two faces along each dim. The face
// function takes the dim at run time (a select of the normal velocity and
// of the momentum channel that takes p), so the warp that holds the last x
// faces and the first y faces does not split. The divides by h and by the
// HLL denominator are multiplies by reciprocals. h/2 and 1/h are taken
// again for each face: held across the face loop they cost 8 registers a
// thread (56 against 48), a CUDA block an SM, and 7% of the time (0.0468
// against 0.0437 ms, on one card in turns).

#include "faces_2d.cuh"

namespace {

using namespace ibx;

template <int BS>
__global__ void __launch_bounds__(BS * BS, BS >= 8 ? 768 / (BS * BS) : 16)
    euler_pass_b_2d_kernel(const float4* __restrict__ P,
                           const float4* __restrict__ du_x,
                           const float4* __restrict__ du_y,
                           const float* __restrict__ nu,
                           const float* __restrict__ meta,
                           const int* __restrict__ nbr,
                           const int* __restrict__ rows,
                           const float4* __restrict__ vals,
                           float4* __restrict__ R, int high_order, Gas g) {
  constexpr int NL = BS * BS, TW = BS + 2, TN = TW * TW;
  constexpr int NF = BS * (BS + 1);  // x faces (and y faces) of a block
  __shared__ float4 sP[TN], sGx[TN], sGy[TN];
  __shared__ float sNu[TN];
  __shared__ float4 sFx[NF];  // x face k of row y at y(bs+1) + k
  __shared__ float4 sFy[NF];  // y face k of column x at k bs + x
  __shared__ Block2 bi;

  const int b = blockIdx.x, t = threadIdx.x;
  const int y = t / BS, x = t % BS, so = (y + 1) * TW + x + 1;
  const long long cell = (long long)b * NL + t;
  load_block(bi, meta, nbr, rows, b);
  sP[so] = P[cell];
  sGx[so] = du_x[cell];
  sGy[so] = du_y[cell];
  sNu[so] = nu[cell];
  __syncthreads();
  for (int i = t; i < 4 * BS; i += NL) {
    const int q = i / BS, j = i % BS, slot = halo_slot<BS>(q, j);
    const long long src = halo_cell<BS>(bi, b, q, j);
    sP[slot] = P[src];
    sNu[slot] = nu[src];
    if (q < 2) {
      sGx[slot] = du_x[src];
    } else {
      sGy[slot] = du_y[src];
    }
  }
  __syncthreads();

  // the block's x and y faces, each once
  const bool ho = high_order != 0;
  for (int f = t; f < 2 * NF; f += NL) {
    const int d = f < NF ? 0 : 1;
    int k, io, in;
    if (d == 0) {
      const int yy = f / (BS + 1);
      k = f % (BS + 1);  // face k: between x = k-1 and x = k
      io = (yy + 1) * TW + k;
      in = io + 1;
    } else {
      const int xx = (f - NF) % BS;
      k = (f - NF) / BS;  // face k: between y = k-1 and y = k
      io = k * TW + xx + 1;
      in = io + TW;
    }
    const float ev = k == 0 ? bi.m[3 + 2 * d]
                            : (k == BS ? bi.m[4 + 2 * d] : 1.f);
    float F[4] = {0.f, 0.f, 0.f, 0.f};
    if (ev != 0.f) {
      const float4* sG = d == 0 ? sGx : sGy;
      float Po[4], Pn[4], go[4], gn[4];
      unpack(sP[io], Po);
      unpack(sP[in], Pn);
      unpack(sG[io], go);
      unpack(sG[in], gn);
      const float h = bi.m[d];
      const float hh = h / 2;
      face_b(d, hh, hh, 1.f / h, ho, Po, Pn, go, gn, sNu[io], sNu[in], g,
             F);
#pragma unroll
      for (int c = 0; c < 4; ++c) F[c] = F[c] * ev;
    }
    (d == 0 ? sFx[f] : sFy[f - NF]) = make_float4(F[0], F[1], F[2], F[3]);
  }
  __syncthreads();

  float Rd[2][4];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float ih = 1.f / bi.m[d];
    const float4 fm = d == 0 ? sFx[y * (BS + 1) + x] : sFy[y * BS + x];
    const float4 fp =
        d == 0 ? sFx[y * (BS + 1) + x + 1] : sFy[(y + 1) * BS + x];
    Rd[d][0] = (fp.x - fm.x) * ih;
    Rd[d][1] = (fp.y - fm.y) * ih;
    Rd[d][2] = (fp.z - fm.z) * ih;
    Rd[d][3] = (fp.w - fm.w) * ih;
    const int k = d == 0 ? x : y;
    const int side = k == 0 ? 0 : (k == BS - 1 ? 1 : -1);
    const int row = side < 0 ? -1 : bi.row[2 * d + side];
    if (row >= 0) {
      const float4 c = vals[(long long)row * BS + (d == 0 ? y : x)];
      Rd[d][0] = Rd[d][0] + c.x;
      Rd[d][1] = Rd[d][1] + c.y;
      Rd[d][2] = Rd[d][2] + c.z;
      Rd[d][3] = Rd[d][3] + c.w;
    }
  }
  R[cell] = make_float4(Rd[0][0] + Rd[1][0], Rd[0][1] + Rd[1][1],
                        Rd[0][2] + Rd[1][2], Rd[0][3] + Rd[1][3]);
}

template <int BS>
int launch(const float* P, const float* du_x, const float* du_y,
           const float* nu, const float* meta, const int* nbr,
           const int* rows, const float* vals, float* R, int n_blocks,
           int high_order, Gas g, cudaStream_t st) {
  euler_pass_b_2d_kernel<BS><<<n_blocks, BS * BS, 0, st>>>(
      reinterpret_cast<const float4*>(P),
      reinterpret_cast<const float4*>(du_x),
      reinterpret_cast<const float4*>(du_y), nu, meta, nbr, rows,
      reinterpret_cast<const float4*>(vals), reinterpret_cast<float4*>(R),
      high_order, g);
  return (int)cudaGetLastError();
}

}  // namespace

// P, du_x, du_y [B, bs, bs, 4], nu [B, bs, bs] -> R [B, bs, bs, 4]; rows
// [B, 4] and vals [V, bs, 4] are the 2:1 corrections. Block sizes 4, 8 and
// 16 (lbs 2..4; cudaErrorInvalidValue otherwise). Returns the launch's
// CUDA error.
extern "C" int ibx_euler_pass_b_2d(const float* P, const float* du_x,
                                   const float* du_y, const float* nu,
                                   const float* meta, const int* nbr,
                                   const int* rows, const float* vals,
                                   float* R, int n_blocks, int lbs,
                                   int high_order, float gas_R, float cv,
                                   float gR, void* stream) {
  if (n_blocks == 0) return 0;
  const Gas g{gas_R, cv, gR};
  cudaStream_t st = (cudaStream_t)stream;
  switch (lbs) {
    case 2:
      return launch<4>(P, du_x, du_y, nu, meta, nbr, rows, vals, R,
                       n_blocks, high_order, g, st);
    case 3:
      return launch<8>(P, du_x, du_y, nu, meta, nbr, rows, vals, R,
                       n_blocks, high_order, g, st);
    case 4:
      return launch<16>(P, du_x, du_y, nu, meta, nbr, rows, vals, R,
                        n_blocks, high_order, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
