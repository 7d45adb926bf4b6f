// Shared device helpers for the channel-split block kernels.
//
// Layout: every grid is [B, C, bs, bs*bs] float32, i.e. per block and
// channel one contiguous run of bs^3 cells with the within-block index
// w = z*bs^2 + y*bs + x (x fastest). Each channel's z-plane is bs^2
// contiguous floats (1 KB at bs = 16).
//
// Per-block tables (built by ibx_torch.topology.blocks.BlockTables):
//   meta [B, 16] f32: h_d (0..2), edge_valid[d][s] (3 + 2d + s),
//                     bnd[d][s] (9 + 2d + s), pad;
//   nbr  [B, 8] i32:  dense neighbor block of side (d, s) at 2d + s.
//
// The stencil kernels (pass A, pass B) run one CUDA block per mesh block
// and one thread per (y, x) column, and march z. Each z-plane is staged in
// shared memory as a (bs+2)^2 tile per channel: the plane and its one-cell
// halo ring along x and y, taken from the neighbor blocks' edge planes (or
// the mirrored own edge on a bnd side); the four corners stay unused. The
// copies go global -> shared with cp.async, one plane ahead of the plane
// being computed (two tiles, double-buffered). The z neighbors come from
// the previous plane, which each thread keeps in registers, and from the
// +-z neighbor blocks' edge planes at the first and last plane.
#pragma once

#include <cuda_runtime.h>

namespace ibx {

// The 16 meta floats and 8 neighbor ids of one mesh block, read once per
// CUDA block into shared memory.
struct BlockInfo {
  float m[16];
  int nb[8];
};

// Fills `bi` from the tables (every thread calls it; sync afterwards).
__device__ __forceinline__ void load_block_info(BlockInfo& bi,
                                                const float* __restrict__ meta,
                                                const int* __restrict__ nbr,
                                                int b) {
  for (int i = threadIdx.x; i < 24; i += blockDim.x) {
    if (i < 16) {
      bi.m[i] = meta[16LL * b + i];
    } else {
      bi.nb[i - 16] = nbr[8LL * b + (i - 16)];
    }
  }
}

struct CellRef {
  int b;  // block id
  int w;  // within-block cell index
};

// Address of channel c of a cell in a [B, C, npb] grid.
__device__ __forceinline__ long long cell_at(CellRef r, int C, int c,
                                             int npb) {
  return ((long long)r.b * C + c) * npb + r.w;
}

template <int BS>
struct Geom {
  static constexpr int NL = BS * BS;      // cells a plane, threads a block
  static constexpr int NPB = BS * BS * BS;
  static constexpr int TW = BS + 2;       // tile row stride
  static constexpr int TN = TW * TW;      // tile floats a channel

  // Tile slot of own cell (y, x).
  __device__ __forceinline__ static int own(int y, int x) {
    return (y + 1) * TW + x + 1;
  }

  // Tile slot of the halo cell of side q (0: -x, 1: +x, 2: -y, 3: +y) at
  // lateral index j (y for the x sides, x for the y sides).
  __device__ __forceinline__ static int halo(int q, int j) {
    return q == 0   ? (j + 1) * TW
           : q == 1 ? (j + 1) * TW + BS + 1
           : q == 2 ? j + 1
                    : (BS + 1) * TW + j + 1;
  }

  // Source cell of that halo slot in plane z: the neighbor block's
  // opposite edge cell, or the own edge cell on a bnd side.
  __device__ __forceinline__ static CellRef halo_src(const BlockInfo& bi,
                                                     int b, int z, int q,
                                                     int j) {
    const int d = q >> 1, s = q & 1;
    const bool bnd = bi.m[9 + q] > 0.f;
    const int e = bnd ? (s ? BS - 1 : 0) : (s ? 0 : BS - 1);
    const int w = d == 0 ? z * NL + j * BS + e : z * NL + e * BS + j;
    return CellRef{bnd ? b : bi.nb[q], w};
  }

  // Source cell of the z-neighbor column of plane -1 (s = 0) or plane bs
  // (s = 1) at column t.
  __device__ __forceinline__ static CellRef zhalo_src(const BlockInfo& bi,
                                                      int b, int s, int t) {
    const bool bnd = bi.m[13 + s] > 0.f;
    const int e = bnd ? (s ? BS - 1 : 0) : (s ? 0 : BS - 1);
    return CellRef{bnd ? b : bi.nb[4 + s], e * NL + t};
  }
};

// cp.async of one float, global -> shared (cached in L1), and its group
// fences: the copies of a thread become visible to that thread after
// cp_async_wait, and to the block after a __syncthreads() that follows it.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Raises the kernel's dynamic shared memory limit when `bytes` passes the
// 48 KB default; returns the CUDA error of that call (0 otherwise).
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace ibx
