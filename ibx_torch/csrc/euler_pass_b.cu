// euler_pass_b: RHS pass B on the channel-split block grid.
//
// Replaces the Pallas kernel `_kernel_b` / `run_kernel_b` of
// ibx/ops/pallas_rhs.py (with its helpers `_face_b` and `_hll_flux`), in
// both of its variants: the default (no `have_cols`), which reads gradients
// whose 2:1 corrections the glue has already added, and the `have_cols`
// fold (`_edge_corr`), which adds them as it loads (template FOLD below).
// Per face along dim d, between the minus cell o and the plus cell n:
//   MUSCL slopes limited by minmod, the JST blend with
//   D = max(nu_o, nu_n, 1e-7), the optional high-order face value, and the
//   HLL flux with the reference's one-sided wave speeds
//   SL = max(uL + aL, 0), SR = min(uR - aR, 0);
// and per cell R = sum_d (F_plus - F_minus)/h with F = -HLL. A face on a
// 2:1 block edge (edge_valid = 0) is zero (and not evaluated); the glue
// adds the interface corrections afterwards.
//
// Bound on an H100: each cell reads P (5), du (15) and nu (1) and writes R
// (5): 26 float channels, 0.165 ms at 5,308,416 cells and 3.35 TB/s. The
// float32 work, 3 + 3/bs face evaluations a cell of about 281 operations
// each, is 0.077 ms at 67 TFLOP/s if every add, mul, divide and square root
// were one instruction; they are not (an IEEE divide or square root is a
// sequence of about ten), and the kernel is bound by instruction issue and
// latency: 0.39 ms, about 42% of the byte bound, on an H100 at 700 W.
//
// Design: one CUDA block per mesh block, one thread per (y, x) column,
// marching z (block_cells.cuh). Each z-plane of P, nu and the x and y
// gradient channels is staged with its halo ring in a shared-memory tile,
// one plane ahead (cp.async, double-buffered). Per plane, the block's
// threads share out the bs(bs+1) x faces and bs(bs+1) y faces and evaluate
// each once into a shared flux buffer; a block's two edge faces along x and
// y are also evaluated by the neighbor block, as on the TPU. Along z each
// thread keeps the previous plane's cell and face flux in registers and
// evaluates only the face to the current plane. So a cell costs
// 2(bs+1)/bs + (bs+1)/bs = 3 + 3/bs face evaluations (3.19 at bs = 16),
// against 6 when each cell evaluates both of its faces. The per-block
// constants are hoisted (h/2, 1/h), and the divides by h and by the HLL
// denominator become multiplies by reciprocals: 3 IEEE divides a face
// (rho twice, 1/denominator) where there were 17. The launch bound asks
// for 3 blocks of 256 threads an SM (at most 85 registers), which ran
// faster on the H100 than 2 blocks at the 92 registers the kernel takes
// unbounded, the fold's few spilled bytes included.
//
// The fold: a 2:1 correction belongs to the block whose gradient is read:
// a du value read at cell r carries block r.b's side-s row when r lies on
// the side-s edge of r.b along d. That covers the own block's edge cells,
// the halo cells taken from a neighbor block (with that block's rows) and
// the mirrored own cells of a bnd side with one rule. The operands are
// compact: `rows` [B, 6] gives, per block and (d, s), a row of `vals`
// [V, 5, bs*bs] (-1 where the block has no interface there), with the
// lateral index hi-major over the other two dims ((y, x) for d = 2, (z, x)
// for d = 1, (z, y) for d = 0). A CUDA block resolves the 12 rows its
// tiles need once (`FoldRows`); the x and y corrections of a plane come in
// with its tile (cp.async into a small buffer) and are added in shared
// memory after one more barrier, the z ones on the register load. Row
// lookups and correction loads are so kept off the path between a plane's
// arrival and its faces. The value is du + c, one float32 add as in the
// pre-add path, so the folded R equals the pre-added R.
//
// ptxas (sm_90a, CUDA 12): at bs = 16, 80 registers and 52,692 bytes of
// dynamic shared memory (+96 static) without the fold; 80 registers with
// 24 bytes of spills and 57,812 bytes with it (chip_smoke.py phase 7
// prints every instantiation).

#include "block_cells.cuh"

namespace {

using ibx::BlockInfo;
using ibx::CellRef;
using ibx::Geom;
using ibx::cell_at;

struct Gas {
  float R, cv, gR;
};

// Compact 2:1 gradient corrections of the fold (see the head comment).
struct Fold {
  const int* rows;    // [B, 6], row of (d, s) at 2d + s
  const float* vals;  // [V, 5, bs*bs]
};

__device__ __forceinline__ float sgnf(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

// One side of the HLL flux: conservative state Q, directed flux F, normal
// velocity and speed of sound (`_hll_flux.side`).
template <int D>
__device__ __forceinline__ void hll_side(const float* X, Gas g, float* Q,
                                         float* F, float& un, float& aa) {
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
  un = X[2 + D];
  F[0] = rho * un;
  F[1] = (E + p) * un;
#pragma unroll
  for (int k = 0; k < 3; ++k) F[2 + k] = Q[2 + k] * un;
  F[2 + D] = F[2 + D] + p;
  aa = sqrtf(g.gR * T);
}

// -HLL flux of the MUSCL-reconstructed face between o (minus side) and n
// (`_face_b` with ho = hn = h; hh = h/2, ih = 1/h), in that operand order,
// so that the value is the one both of the face's cells used to compute.
template <int D>
__device__ __forceinline__ void face_b(float hh, float ih, bool high_order,
                                       const float* Po, const float* Pn,
                                       const float* duo, const float* dun,
                                       float Do, float Dn, Gas g,
                                       float* out) {
  const float Db = fmaxf(fmaxf(Do, Dn), 1e-7f);
  float PL[5], PR[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float grad_f = (Pn[c] - Po[c]) * ih;
    const float slope_o = (2 * duo[c] - grad_f) * hh;
    const float slope_n = (2 * dun[c] - grad_f) * hh;
    const float lim = fminf(fabsf(slope_n), fabsf(slope_o)) *
                      (sgnf(slope_n) + sgnf(slope_o)) / 2;
    float uf = (Po[c] * hh + Pn[c] * hh) * ih;
    if (high_order) uf = uf + (duo[c] * hh - dun[c] * hh) / 8;
    PL[c] = (Po[c] + lim) * Db + (1.f - Db) * uf;
    PR[c] = (Pn[c] - lim) * Db + (1.f - Db) * uf;
  }
  float QL[5], FL[5], QR[5], FR[5], uL, aL, uR, aR;
  hll_side<D>(PL, g, QL, FL, uL, aL);
  hll_side<D>(PR, g, QR, FR, uR, aR);
  const float SL = fmaxf(uL + aL, 0.f);
  const float SR = fminf(uR - aR, 0.f);
  const float denom = SL - SR;
  const bool safe = denom > 0.f;
  const float inv = 1.f / denom;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float f =
        safe ? (SL * FL[k] - SR * FR[k] + SR * SL * (QR[k] - QL[k])) * inv
             : 0.f;
    out[k] = -f;
  }
}

// Tiles in flight: plane z+1 is copied while plane z is computed.
constexpr int kStages = 2;

// Tile channels: P (0..4), nu (5), du_x (6..10), du_y (11..15).
constexpr int kTileCh = 16;

// Fold corrections a plane: for du_x the cells x = -1, 0, bs-1, bs of
// each row, for du_y the cells y = -1, 0, bs-1, bs of each column (the
// only ones on a block edge along that dim), 5 channels each: 40 bs
// floats, item i = ((4d + p) * 5 + c) * bs + j at position p, lateral j.
template <int BS>
__host__ __device__ constexpr int fold_floats() {
  return 40 * BS;
}

// The fold's rows of one mesh block, resolved once (-1: none): at 4d + p
// the row whose correction the du_d value at position p carries (p = 0, 3:
// the halo cells, that is the neighbor block's opposite edge or the
// mirrored own edge; p = 1, 2: the own edge cells), then the own z edges
// (8, 9) and the z halo planes (10, 11).
struct FoldRows {
  int r[12];
};

__device__ __forceinline__ void load_fold_rows(FoldRows& fr, Fold f,
                                               const BlockInfo& bi, int b) {
  const int i = threadIdx.x;
  if (i >= 12) return;
  int q;  // the (d, s) side whose row the entry takes
  bool halo;
  if (i < 8) {
    const int d = i >> 2, p = i & 3;
    q = 2 * d + (p >= 2 ? 1 : 0);
    halo = p == 0 || p == 3;
  } else {
    q = 4 + (i & 1);
    halo = i >= 10;
  }
  const bool own = !halo || bi.m[9 + q] > 0.f;
  fr.r[i] = own ? f.rows[6LL * b + q] : f.rows[6LL * bi.nb[q] + (q ^ 1)];
}

// Tile slot and source lateral index of fold item i.
template <int BS>
__device__ __forceinline__ int fold_slot(int i, int& c, int& d, int& dp) {
  constexpr int TW = BS + 2;
  const int j = i % BS;
  c = (i / BS) % 5;
  dp = i / (5 * BS);
  d = dp >> 2;
  const int p = dp & 3;
  const int e = p == 0 ? 0 : p == 1 ? 1 : p == 2 ? BS : BS + 1;
  return d == 0 ? (j + 1) * TW + e : e * TW + j + 1;
}

// The copies of plane z into `tile`: this thread's own cell, and its share
// of the halo ring (P and nu on all four sides, du_x on the x sides, du_y
// on the y sides: 11 channels on 4 sides of bs cells); with the fold, its
// share of the plane's x and y corrections into `fc`.
template <int BS, bool FOLD>
__device__ __forceinline__ void plane_b(
    float* tile, float* fc, const float* __restrict__ P,
    const float* __restrict__ du, const float* __restrict__ nu,
    const BlockInfo& bi, const FoldRows& fr, Fold fold, int b, int z,
    int t) {
  using G = Geom<BS>;
  constexpr int TN = G::TN, NPB = G::NPB;
  const CellRef own{b, z * G::NL + t};
  const int so = G::own(t / BS, t % BS);
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    ibx::cp_async4(tile + c * TN + so, P + cell_at(own, 5, c, NPB));
  }
  ibx::cp_async4(tile + 5 * TN + so, nu + cell_at(own, 1, 0, NPB));
#pragma unroll
  for (int c = 0; c < 10; ++c) {
    ibx::cp_async4(tile + (6 + c) * TN + so, du + cell_at(own, 15, c, NPB));
  }
  for (int i = t; i < 44 * BS; i += G::NL) {
    const int k = i / (4 * BS);  // 0..4 P, 5 nu, 6..10 du of the side's dim
    const int q = (i / BS) % 4, j = i % BS;
    const CellRef r = G::halo_src(bi, b, z, q, j);
    const int d = q >> 1;
    const int tc = k < 6 ? k : 6 + 5 * d + (k - 6);
    const float* src = k < 5    ? P + cell_at(r, 5, k, NPB)
                       : k == 5 ? nu + cell_at(r, 1, 0, NPB)
                                : du + cell_at(r, 15, 5 * d + k - 6, NPB);
    ibx::cp_async4(tile + tc * TN + G::halo(q, j), src);
  }
  if constexpr (FOLD) {
    for (int i = t; i < fold_floats<BS>(); i += G::NL) {
      int c, d, dp;
      fold_slot<BS>(i, c, d, dp);
      const int row = fr.r[dp];
      if (row < 0) continue;
      ibx::cp_async4(fc + i, fold.vals + ((long long)row * 5 + c) * G::NL +
                                 z * BS + i % BS);
    }
  }
}

// Adds the plane's landed x and y corrections to the du values of the
// tile: du + c, one float32 add as in the pre-add path.
template <int BS>
__device__ __forceinline__ void fix_plane(float* tile, const float* fc,
                                          const FoldRows& fr, int t) {
  constexpr int TN = Geom<BS>::TN;
  for (int i = t; i < fold_floats<BS>(); i += BS * BS) {
    int c, d, dp;
    const int slot = fold_slot<BS>(i, c, d, dp);
    if (fr.r[dp] < 0) continue;
    float& v = tile[(6 + 5 * d + c) * TN + slot];
    v = v + fc[i];
  }
}

// P, z gradient and nu of cell r, as a face operand [P(5), du_z(5), nu];
// with the fold, row `row` of the corrections (lateral index t) added to
// the gradient.
template <int BS, bool FOLD>
__device__ __forceinline__ void load_zcell(const float* __restrict__ P,
                                           const float* __restrict__ du,
                                           const float* __restrict__ nu,
                                           Fold fold, CellRef r, int row,
                                           int t, bool with_p, float* W) {
  constexpr int NPB = Geom<BS>::NPB;
  if (with_p) {
#pragma unroll
    for (int c = 0; c < 5; ++c) W[c] = P[cell_at(r, 5, c, NPB)];
    W[10] = nu[cell_at(r, 1, 0, NPB)];
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) W[5 + c] = du[cell_at(r, 15, 10 + c, NPB)];
  if constexpr (FOLD) {
    if (row < 0) return;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      W[5 + c] =
          W[5 + c] + fold.vals[((long long)row * 5 + c) * (BS * BS) + t];
    }
  }
}

template <int BS, bool FOLD>
__global__ void __launch_bounds__(BS * BS, BS >= 8 ? 768 / (BS * BS) : 16)
    euler_pass_b_kernel(const float* __restrict__ P,
                        const float* __restrict__ du,
                        const float* __restrict__ nu,
                        const float* __restrict__ meta,
                        const int* __restrict__ nbr, Fold fold,
                        float* __restrict__ R, int high_order, Gas g) {
  using G = Geom<BS>;
  constexpr int NL = G::NL, NPB = G::NPB, TN = G::TN, TW = G::TW;
  constexpr int NF = BS * (BS + 1);  // x faces (and y faces) of a plane
  constexpr int FXS = BS + 1;        // padded lateral stride of fx
  constexpr int FC = FOLD ? fold_floats<BS>() : 0;
  extern __shared__ float smem[];
  float* tiles = smem;                         // [kStages][kTileCh][TN]
  float* fcs = tiles + kStages * kTileCh * TN;  // [kStages][FC]
  float* fx = fcs + kStages * FC;              // [5][bs+1][FXS]: (k, y)
  float* fy = fx + 5 * (BS + 1) * FXS;         // [5][bs+1][bs]: (k, x)
  __shared__ BlockInfo bi;
  __shared__ FoldRows fr;

  const int b = blockIdx.x, t = threadIdx.x;
  const int y = t / BS, x = t % BS, so = G::own(y, x);
  ibx::load_block_info(bi, meta, nbr, b);
  __syncthreads();
  bool fix = false;  // does any x or y correction reach this block's tile
  if (FOLD) {
    load_fold_rows(fr, fold, bi, b);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) fix = fix || fr.r[i] >= 0;
  }
  const bool ho = high_order != 0;
  const float ih0 = 1.f / bi.m[0], ih1 = 1.f / bi.m[1], ih2 = 1.f / bi.m[2];

  float Wp[11];  // [P, du_z, nu] of the previous plane's cell of the column
  load_zcell<BS, FOLD>(P, du, nu, fold, G::zhalo_src(bi, b, 0, t),
                       FOLD ? fr.r[10] : -1, t, true, Wp);
  float Fzm[5], acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int z = 0; z < kStages - 1; ++z) {
    plane_b<BS, FOLD>(tiles + z * kTileCh * TN, fcs + z * FC, P, du, nu, bi,
                      fr, fold, b, z, t);
    ibx::cp_async_commit();
  }

  for (int z = 0; z < BS; ++z) {
    float* tile = tiles + (z % kStages) * kTileCh * TN;
    const int zn = z + kStages - 1;
    if (zn < BS) {
      plane_b<BS, FOLD>(tiles + (zn % kStages) * kTileCh * TN,
                        fcs + (zn % kStages) * FC, P, du, nu, bi, fr, fold, b,
                        zn, t);
    }
    ibx::cp_async_commit();
    float Wc[11];
    const int zrow = !FOLD ? -1 : z == 0 ? fr.r[8] : z == BS - 1 ? fr.r[9] : -1;
    load_zcell<BS, FOLD>(P, du, nu, fold, CellRef{b, z * NL + t}, zrow, t,
                         false, Wc);
    ibx::cp_async_wait<kStages - 1>();
    __syncthreads();
    if (FOLD && fix) {
      fix_plane<BS>(tile, fcs + (z % kStages) * FC, fr, t);
      __syncthreads();
    }

    // the plane's x and y faces, each once
    for (int f = t; f < 2 * NF; f += NL) {
      const bool is_x = f < NF;
      const int fl = is_x ? f : f - NF;
      const int k = fl / BS, j = fl % BS;  // face k: between k-1 and k
      const int io = is_x ? (j + 1) * TW + k : k * TW + j + 1;
      const int in = is_x ? io + 1 : io + TW;
      const int d = is_x ? 0 : 1;
      const float ev = k == 0 ? bi.m[3 + 2 * d]
                              : (k == BS ? bi.m[4 + 2 * d] : 1.f);
      float F[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (ev != 0.f) {
        float Po[5], Pn[5], go[5], gn[5];
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          Po[c] = tile[c * TN + io];
          Pn[c] = tile[c * TN + in];
          go[c] = tile[(6 + 5 * d + c) * TN + io];
          gn[c] = tile[(6 + 5 * d + c) * TN + in];
        }
        const float Do = tile[5 * TN + io], Dn = tile[5 * TN + in];
        if (is_x) {
          face_b<0>(bi.m[0] / 2, ih0, ho, Po, Pn, go, gn, Do, Dn, g, F);
        } else {
          face_b<1>(bi.m[1] / 2, ih1, ho, Po, Pn, go, gn, Do, Dn, g, F);
        }
#pragma unroll
        for (int c = 0; c < 5; ++c) F[c] = F[c] * ev;
      }
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        if (is_x) {
          fx[(c * (BS + 1) + k) * FXS + j] = F[c];
        } else {
          fy[(c * (BS + 1) + k) * BS + j] = F[c];
        }
      }
    }

    // the z face between plane z-1 and plane z of this column
#pragma unroll
    for (int c = 0; c < 5; ++c) Wc[c] = tile[c * TN + so];
    Wc[10] = tile[5 * TN + so];
    const float ev = z == 0 ? bi.m[7] : 1.f;
    float Fz[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (ev != 0.f) {
      face_b<2>(bi.m[2] / 2, ih2, ho, Wp, Wc, Wp + 5, Wc + 5, Wp[10], Wc[10],
                g, Fz);
#pragma unroll
      for (int c = 0; c < 5; ++c) Fz[c] = Fz[c] * ev;
    }
    if (z > 0) {
      const CellRef prev{b, (z - 1) * NL + t};
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        R[cell_at(prev, 5, c, NPB)] = acc[c] + (Fz[c] - Fzm[c]) * ih2;
      }
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) Fzm[c] = Fz[c];
#pragma unroll
    for (int c = 0; c < 11; ++c) Wp[c] = Wc[c];
    __syncthreads();

#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* ex = fx + c * (BS + 1) * FXS;
      const float* ey = fy + c * (BS + 1) * BS;
      acc[c] = (ex[(x + 1) * FXS + y] - ex[x * FXS + y]) * ih0 +
               (ey[(y + 1) * BS + x] - ey[y * BS + x]) * ih1;
    }
  }

  // the z face to plane bs (the +z neighbor's edge plane or the mirror)
  float Wn[11];
  load_zcell<BS, FOLD>(P, du, nu, fold, G::zhalo_src(bi, b, 1, t),
                       FOLD ? fr.r[11] : -1, t, true, Wn);
  const float ev = bi.m[8];
  float Fz[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (ev != 0.f) {
    face_b<2>(bi.m[2] / 2, ih2, ho, Wp, Wn, Wp + 5, Wn + 5, Wp[10], Wn[10], g,
              Fz);
#pragma unroll
    for (int c = 0; c < 5; ++c) Fz[c] = Fz[c] * ev;
  }
  const CellRef last{b, (BS - 1) * NL + t};
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    R[cell_at(last, 5, c, NPB)] = acc[c] + (Fz[c] - Fzm[c]) * ih2;
  }
}

// Dynamic shared memory of a CUDA block: the tiles (with the fold, their
// corrections) and the x and y flux buffers.
template <int BS, bool FOLD>
constexpr int smem_bytes() {
  return (int)sizeof(float) *
         (kStages * (kTileCh * Geom<BS>::TN + (FOLD ? fold_floats<BS>() : 0)) +
          5 * (BS + 1) * (BS + 1) + 5 * (BS + 1) * BS);
}

template <int BS, bool FOLD>
int launch(const float* P, const float* du, const float* nu,
           const float* meta, const int* nbr, Fold fold, float* R,
           int n_blocks, int high_order, Gas g, cudaStream_t st) {
  constexpr int smem = smem_bytes<BS, FOLD>();
  const auto kernel = euler_pass_b_kernel<BS, FOLD>;
  const cudaError_t e = ibx::allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_blocks, BS * BS, smem, st>>>(P, du, nu, meta, nbr, fold, R,
                                          high_order, g);
  return (int)cudaGetLastError();
}

template <int BS>
int launch_bs(const float* P, const float* du, const float* nu,
              const float* meta, const int* nbr, Fold fold, float* R,
              int n_blocks, int high_order, Gas g, cudaStream_t st) {
  return fold.rows != nullptr
             ? launch<BS, true>(P, du, nu, meta, nbr, fold, R, n_blocks,
                                high_order, g, st)
             : launch<BS, false>(P, du, nu, meta, nbr, fold, R, n_blocks,
                                 high_order, g, st);
}

}  // namespace

// P [B, 5, npb], du [B, 15, npb], nu [B, 1, npb] -> R [B, 5, npb], for
// block sizes 4, 8 and 16 (lbs 2..4; cudaErrorInvalidValue otherwise).
// fold_rows [B, 6] and fold_vals [V, 5, bs*bs] are the fold's operands, or
// both null for the default variant. Returns the launch's CUDA error.
extern "C" int ibx_euler_pass_b(const float* P, const float* du,
                                const float* nu, const float* meta,
                                const int* nbr, const int* fold_rows,
                                const float* fold_vals, float* R,
                                int n_blocks, int lbs, int high_order,
                                float gas_R, float cv, float gR,
                                void* stream) {
  if (n_blocks == 0) return 0;
  const Fold fold{fold_rows, fold_vals};
  const Gas g{gas_R, cv, gR};
  cudaStream_t st = (cudaStream_t)stream;
  switch (lbs) {
    case 2:
      return launch_bs<4>(P, du, nu, meta, nbr, fold, R, n_blocks,
                          high_order, g, st);
    case 3:
      return launch_bs<8>(P, du, nu, meta, nbr, fold, R, n_blocks,
                          high_order, g, st);
    case 4:
      return launch_bs<16>(P, du, nu, meta, nbr, fold, R, n_blocks,
                           high_order, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory bytes of one CUDA block at block size 1 << lbs,
// without (fold = 0) or with the fold.
extern "C" int ibx_euler_pass_b_smem(int lbs, int fold) {
  const bool f = fold != 0;
  return lbs == 2   ? (f ? smem_bytes<4, true>() : smem_bytes<4, false>())
         : lbs == 3 ? (f ? smem_bytes<8, true>() : smem_bytes<8, false>())
         : lbs == 4 ? (f ? smem_bytes<16, true>() : smem_bytes<16, false>())
                    : -1;
}
