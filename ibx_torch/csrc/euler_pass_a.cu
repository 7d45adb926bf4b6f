// euler_pass_a: RHS pass A on the channel-split block grid.
//
// Replaces the Pallas kernel `_kernel_a` / `run_kernel_a` of
// ibx/ops/pallas_rhs.py. Per face along dim d, between the minus cell o
// and the plus cell n, with the edge mask m (edge_valid on a 2:1 block
// edge, 1 elsewhere):
//   Pf = (P_o h + P_n h)/(h + h) m     face average, 5 channels;
//   fd = (p_n - p_o) m                 pressure difference;
//   sf = (S_o h + S_n h)/(h + h) m     wave speed, S = |u_d| + a (with_dt),
// and per cell, from its two faces along d:
//   du[5d + c] = (Pf_plus - Pf_minus)/h      Green-Gauss gradient, 15 ch;
//   aux[d]     = (fd_plus - fd_minus)/h      signed pressure-difference sum G;
//   aux[3 + d] = (|fd_plus| + |fd_minus|)/h  absolute sum U;
//   aux[6 + d] = (sf_plus + sf_minus)/h      wave-speed sum (with_dt only).
// The XLA-side glue adds the 2:1 interface corrections afterwards. A
// one-sided boundary side (bnd) mirrors the own edge. Expressions and
// operand order follow the JAX kernel, with the divides by h + h and by h
// taken as multiplies by their reciprocals (exact where h is a power of
// two, as on the octree meshes; within an ulp elsewhere).
//
// Bound on an H100: bytes. Each cell reads P (5 channels) and writes du
// (15) and aux (9 with dt, 6 without): 29 or 26 float channels a cell,
// 0.184 or 0.165 ms at 5,308,416 cells and 3.35 TB/s; 24 or 21 of those
// channels are stores, so the stores should set the pace. On an H100 at
// 700 W it reaches about 70% of that bound (0.261 ms with dt,
// chip_smoke.py phase 7); the rest is, as far as CUDA events can tell,
// the wait for each plane at the two barriers a plane. IEEE divides by
// h + h and h in place of the reciprocals took about twice as long on a
// marched flow field (a data-dependent slow path).
//
// Design: as pass B (block_cells.cuh): one CUDA block per mesh block, one
// thread per (y, x) column marching z, each z-plane of P staged with its
// halo ring in shared memory one plane ahead (cp.async, double-buffered).
// With dt, the sound speed a = sqrt(gR max(T, 10)) is taken once for each
// tile cell, by the thread that copied its T, into a sixth tile channel.
// The x and y faces of a plane are shared out over the block's threads and
// each face's Pf, fd (and sf) is computed once into a shared buffer; along
// z each thread keeps the previous cell and face in registers. Every
// output channel goes out plane by plane, a warp storing 128 contiguous
// bytes: the x and y parts of plane z after its faces, the z part of plane
// z-1 once the face to plane z is known.
//
// ptxas (sm_90a, CUDA 12): at bs = 16, 64 registers, no spills, and
// 31,260 bytes of dynamic shared memory (+96 static) with dt (launch
// bound: 4 blocks of 256 threads an SM; chip_smoke.py phase 7 prints every
// instantiation).

#include "block_cells.cuh"

namespace {

using ibx::BlockInfo;
using ibx::CellRef;
using ibx::Geom;
using ibx::cell_at;

// Tiles in flight: plane z+1 is copied while plane z is computed.
constexpr int kStages = 2;

// Face values of one face, in the order [Pf(5), fd, sf]; i2h = 1/(h + h).
template <bool DT>
__device__ __forceinline__ void face_a(float h, float i2h, float m,
                                       const float* Po, const float* Pn,
                                       float So, float Sn, float* v) {
#pragma unroll
  for (int c = 0; c < 5; ++c) v[c] = (Po[c] * h + Pn[c] * h) * i2h * m;
  v[5] = (Pn[0] - Po[0]) * m;
  if (DT) v[6] = (So * h + Sn * h) * i2h * m;
}

// The copies of plane z of P into `tile` (this thread's own cell and its
// share of the halo ring: 5 channels on 4 sides of bs cells); with `sound`
// (after the copies have landed) the sound speed of those same cells.
template <int BS>
__device__ __forceinline__ void plane_a(float* tile, bool sound,
                                        const float* __restrict__ P,
                                        const BlockInfo& bi, int b, int z,
                                        int t, float gR) {
  using G = Geom<BS>;
  constexpr int TN = G::TN;
  const int so = G::own(t / BS, t % BS);
  if (!sound) {
    const CellRef own{b, z * G::NL + t};
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      ibx::cp_async4(tile + c * TN + so, P + cell_at(own, 5, c, G::NPB));
    }
  } else {
    tile[5 * TN + so] = sqrtf(gR * fmaxf(tile[TN + so], 10.f));
  }
  for (int i = t; i < 20 * BS; i += G::NL) {
    const int c = i / (4 * BS), q = (i / BS) % 4, j = i % BS;
    const int slot = G::halo(q, j);
    if (!sound) {
      const CellRef r = G::halo_src(bi, b, z, q, j);
      ibx::cp_async4(tile + c * TN + slot, P + cell_at(r, 5, c, G::NPB));
    } else if (c == 1) {
      tile[5 * TN + slot] = sqrtf(gR * fmaxf(tile[TN + slot], 10.f));
    }
  }
}

template <int BS, bool DT>
__device__ __forceinline__ void load_zcell(const float* __restrict__ P,
                                           CellRef r, float gR, float* W) {
#pragma unroll
  for (int c = 0; c < 5; ++c) W[c] = P[cell_at(r, 5, c, Geom<BS>::NPB)];
  if (DT) W[5] = sqrtf(gR * fmaxf(W[1], 10.f));
}

// Stores the outputs of dim d at cell r from its minus and plus faces
// (ih = 1/h).
template <int BS, bool DT>
__device__ __forceinline__ void store_dim(float* __restrict__ du,
                                          float* __restrict__ aux, CellRef r,
                                          int d, float ih, const float* vm,
                                          const float* vp) {
  constexpr int NPB = Geom<BS>::NPB, NA = DT ? 9 : 6;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    du[cell_at(r, 15, 5 * d + c, NPB)] = (vp[c] - vm[c]) * ih;
  }
  aux[cell_at(r, NA, d, NPB)] = (vp[5] - vm[5]) * ih;
  aux[cell_at(r, NA, 3 + d, NPB)] = (fabsf(vp[5]) + fabsf(vm[5])) * ih;
  if (DT) aux[cell_at(r, NA, 6 + d, NPB)] = (vp[6] + vm[6]) * ih;
}

template <int BS, bool DT>
__global__ void __launch_bounds__(BS * BS, BS >= 8 ? 1024 / (BS * BS) : 16)
    euler_pass_a_kernel(const float* __restrict__ P,
                        const float* __restrict__ meta,
                        const int* __restrict__ nbr, float* __restrict__ du,
                        float* __restrict__ aux, float gR) {
  using G = Geom<BS>;
  constexpr int NL = G::NL, TN = G::TN, TW = G::TW;
  constexpr int NC = DT ? 6 : 5;     // tile channels: P and the sound speed
  constexpr int NV = DT ? 7 : 6;     // face values: Pf (5), fd, sf
  constexpr int NF = BS * (BS + 1);  // x faces (and y faces) of a plane
  constexpr int FXS = BS + 1;        // padded lateral stride of fx
  extern __shared__ float smem[];
  float* tiles = smem;                         // [kStages][NC][TN]
  float* fx = tiles + kStages * NC * TN;       // [NV][bs+1][FXS]: (k, y)
  float* fy = fx + NV * (BS + 1) * FXS;        // [NV][bs+1][bs]: (k, x)
  __shared__ BlockInfo bi;

  const int b = blockIdx.x, t = threadIdx.x;
  const int y = t / BS, x = t % BS, so = G::own(y, x);
  ibx::load_block_info(bi, meta, nbr, b);
  __syncthreads();
  float ih[3], i2h[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    ih[d] = 1.f / bi.m[d];
    i2h[d] = 1.f / (bi.m[d] + bi.m[d]);
  }

  float Wp[6];  // P (and a) of the previous plane's cell of the column
  load_zcell<BS, DT>(P, G::zhalo_src(bi, b, 0, t), gR, Wp);
  float Vzm[NV];  // values of the z face below the current plane
#pragma unroll
  for (int z = 0; z < kStages - 1; ++z) {
    plane_a<BS>(tiles + z * NC * TN, false, P, bi, b, z, t, gR);
    ibx::cp_async_commit();
  }

  for (int z = 0; z < BS; ++z) {
    float* tile = tiles + (z % kStages) * NC * TN;
    const int zn = z + kStages - 1;
    if (zn < BS) {
      plane_a<BS>(tiles + (zn % kStages) * NC * TN, false, P, bi, b, zn, t,
                  gR);
    }
    ibx::cp_async_commit();
    ibx::cp_async_wait<kStages - 1>();
    if (DT) plane_a<BS>(tile, true, P, bi, b, z, t, gR);
    __syncthreads();

    // the plane's x and y faces, each once
    for (int f = t; f < 2 * NF; f += NL) {
      const bool is_x = f < NF;
      const int fl = is_x ? f : f - NF;
      const int k = fl / BS, j = fl % BS;  // face k: between k-1 and k
      const int io = is_x ? (j + 1) * TW + k : k * TW + j + 1;
      const int in = is_x ? io + 1 : io + TW;
      const int d = is_x ? 0 : 1;
      const float m = k == 0 ? bi.m[3 + 2 * d]
                             : (k == BS ? bi.m[4 + 2 * d] : 1.f);
      float Po[5], Pn[5], v[NV];
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        Po[c] = tile[c * TN + io];
        Pn[c] = tile[c * TN + in];
      }
      float So = 0.f, Sn = 0.f;
      if (DT) {
        So = fabsf(is_x ? Po[2] : Po[3]) + tile[5 * TN + io];
        Sn = fabsf(is_x ? Pn[2] : Pn[3]) + tile[5 * TN + in];
      }
      face_a<DT>(bi.m[d], is_x ? i2h[0] : i2h[1], m, Po, Pn, So, Sn, v);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        if (is_x) {
          fx[(c * (BS + 1) + k) * FXS + j] = v[c];
        } else {
          fy[(c * (BS + 1) + k) * BS + j] = v[c];
        }
      }
    }

    // the z face between plane z-1 and plane z of this column, and the z
    // outputs of plane z-1
    float Wc[6], Vz[NV];
#pragma unroll
    for (int c = 0; c < 5; ++c) Wc[c] = tile[c * TN + so];
    if (DT) Wc[5] = tile[5 * TN + so];
    face_a<DT>(bi.m[2], i2h[2], z == 0 ? bi.m[7] : 1.f, Wp, Wc,
               DT ? fabsf(Wp[4]) + Wp[5] : 0.f,
               DT ? fabsf(Wc[4]) + Wc[5] : 0.f, Vz);
    if (z > 0) {
      store_dim<BS, DT>(du, aux, CellRef{b, (z - 1) * NL + t}, 2, ih[2], Vzm,
                        Vz);
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) Vzm[c] = Vz[c];
#pragma unroll
    for (int c = 0; c < NC; ++c) Wp[c] = Wc[c];
    __syncthreads();

    // the x and y outputs of plane z
    const CellRef cur{b, z * NL + t};
    float vm[NV], vp[NV];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      vm[c] = fx[(c * (BS + 1) + x) * FXS + y];
      vp[c] = fx[(c * (BS + 1) + x + 1) * FXS + y];
    }
    store_dim<BS, DT>(du, aux, cur, 0, ih[0], vm, vp);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      vm[c] = fy[(c * (BS + 1) + y) * BS + x];
      vp[c] = fy[(c * (BS + 1) + y + 1) * BS + x];
    }
    store_dim<BS, DT>(du, aux, cur, 1, ih[1], vm, vp);
  }

  // the z face to plane bs (the +z neighbor's edge plane or the mirror)
  float Wn[6], Vz[NV];
  load_zcell<BS, DT>(P, G::zhalo_src(bi, b, 1, t), gR, Wn);
  face_a<DT>(bi.m[2], i2h[2], bi.m[8], Wp, Wn,
             DT ? fabsf(Wp[4]) + Wp[5] : 0.f,
             DT ? fabsf(Wn[4]) + Wn[5] : 0.f, Vz);
  store_dim<BS, DT>(du, aux, CellRef{b, (BS - 1) * NL + t}, 2, ih[2], Vzm,
                    Vz);
}

// Dynamic shared memory of a CUDA block: the two tiles (P and, with dt,
// the sound speed) and the x and y face buffers.
template <int BS, bool DT>
constexpr int smem_bytes() {
  return (int)sizeof(float) * (kStages * (DT ? 6 : 5) * Geom<BS>::TN +
                               (DT ? 7 : 6) * (BS + 1) * (2 * BS + 1));
}

template <int BS, bool DT>
int launch(const float* P, const float* meta, const int* nbr, float* du,
           float* aux, int n_blocks, float gR, cudaStream_t st) {
  constexpr int smem = smem_bytes<BS, DT>();
  const auto kernel = euler_pass_a_kernel<BS, DT>;
  const cudaError_t e = ibx::allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_blocks, BS * BS, smem, st>>>(P, meta, nbr, du, aux, gR);
  return (int)cudaGetLastError();
}

template <int BS>
int launch_bs(const float* P, const float* meta, const int* nbr, float* du,
              float* aux, int n_blocks, int with_dt, float gR,
              cudaStream_t st) {
  return with_dt ? launch<BS, true>(P, meta, nbr, du, aux, n_blocks, gR, st)
                 : launch<BS, false>(P, meta, nbr, du, aux, n_blocks, gR, st);
}

}  // namespace

// P [B, 5, npb] -> du [B, 15, npb], aux [B, 9 | 6, npb], for block sizes
// 4, 8 and 16 (lbs 2..4; cudaErrorInvalidValue otherwise). Returns the
// launch's CUDA error.
extern "C" int ibx_euler_pass_a(const float* P, const float* meta,
                                const int* nbr, float* du, float* aux,
                                int n_blocks, int lbs, int with_dt, float gR,
                                void* stream) {
  if (n_blocks == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (lbs) {
    case 2:
      return launch_bs<4>(P, meta, nbr, du, aux, n_blocks, with_dt, gR, st);
    case 3:
      return launch_bs<8>(P, meta, nbr, du, aux, n_blocks, with_dt, gR, st);
    case 4:
      return launch_bs<16>(P, meta, nbr, du, aux, n_blocks, with_dt, gR, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory bytes of one CUDA block at block size 1 << lbs.
extern "C" int ibx_euler_pass_a_smem(int lbs, int with_dt) {
  const bool dt = with_dt != 0;
  return lbs == 2   ? (dt ? smem_bytes<4, true>() : smem_bytes<4, false>())
         : lbs == 3 ? (dt ? smem_bytes<8, true>() : smem_bytes<8, false>())
         : lbs == 4 ? (dt ? smem_bytes<16, true>() : smem_bytes<16, false>())
                    : -1;
}
