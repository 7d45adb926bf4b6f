// Shared device helpers for the channel-split block kernels.
//
// Layout: every grid is [B, C, bs, bs*bs] float32, i.e. per block and
// channel one contiguous run of bs^3 cells with the within-block index
// w = z*bs^2 + y*bs + x (x fastest). One thread handles one cell.
//
// Per-block tables (built by ibx_torch.topology.blocks.BlockTables):
//   meta [B, 16] f32: h_d (0..2), edge_valid[d][s] (3 + 2d + s),
//                     bnd[d][s] (9 + 2d + s), pad;
//   nbr  [B, 8] i32:  dense neighbor block of side (d, s) at 2d + s.
#pragma once

#include <cuda_runtime.h>

struct CellRef {
  int b;  // block id
  int w;  // within-block cell index
};

// The side-s neighbor along dim d of cell w in block b: the next cell
// inside the block; at the block edge the opposite edge cell of the dense
// neighbor block; the own cell where the side is a one-sided boundary
// (bnd), which mirrors the own edge (`block_ops.pad_dim` semantics).
__device__ __forceinline__ CellRef neighbor_cell(
    int b, int w, int d, int s, int lbs, const float* __restrict__ m,
    const int* __restrict__ nbr) {
  const int bs = 1 << lbs;
  const int sd = 1 << (lbs * d);
  const int cd = (w >> (lbs * d)) & (bs - 1);
  CellRef r{b, w};
  if (s == 0) {
    if (cd > 0) {
      r.w = w - sd;
    } else if (!(m[9 + 2 * d] > 0.f)) {
      r.b = nbr[2 * d];
      r.w = w + (bs - 1) * sd;
    }
  } else {
    if (cd < bs - 1) {
      r.w = w + sd;
    } else if (!(m[10 + 2 * d] > 0.f)) {
      r.b = nbr[2 * d + 1];
      r.w = w - (bs - 1) * sd;
    }
  }
  return r;
}

// Address of channel c of a cell in a [B, C, npb] grid.
__device__ __forceinline__ long long cell_at(CellRef r, int C, int c,
                                             int npb) {
  return ((long long)r.b * C + c) * npb + r.w;
}
