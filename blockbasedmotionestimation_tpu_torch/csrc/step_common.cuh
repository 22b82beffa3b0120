// What every colour-step kernel shares (reg_step.cu, fused_step.cu): the
// candidate gather of one cell and the reference's _finish_step
// (blockbasedmotionestimation_tpu/kernels/reg_step.py), i.e. presence, the
// border-case tie-break ranks, the in-image mask, the f32 energy and the
// lexicographic (energy, rank) winner written in place.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace bbme_step {

// the reference's slot order: own MV first, then the 8 neighbours
static __constant__ int kSlotDy[9] = {0, 0, 0, 1, -1, -1, -1, 1, 1};
static __constant__ int kSlotDx[9] = {0, -1, 1, 1, -1, 1, 0, 0, -1};
constexpr int kBigRank = 127;

__device__ __forceinline__ int border_case(int i, int j, int nby, int nbx) {
  const bool rows_in = i > 0 && i < nby - 1;
  const bool cols_in = j > 0 && j < nbx - 1;
  if (rows_in && cols_in) return 0;     // interior
  if (i == 0 && cols_in) return 1;      // top row
  if (i == nby - 1 && cols_in) return 2;  // bottom row
  if (j == 0 && rows_in) return 3;      // left col
  if (j == nbx - 1 && rows_in) return 4;  // right col
  if (i == 0 && j == 0) return 5;       // top-left
  if (i == 0) return 6;                 // top-right
  if (j == 0) return 7;                 // bottom-left
  return 8;                             // bottom-right
}

__device__ __forceinline__ int load_cost(const void* base, bool is16, size_t o) {
  return is16 ? static_cast<int>(static_cast<const uint16_t*>(base)[o])
              : static_cast<const int*>(base)[o];
}

// One cell (b, i, j) of colour (ci, cj) from a thread index over the
// colour's B * mc * nc cells.
struct Cell {
  long long b;
  int i;
  int j;
};

__device__ __forceinline__ Cell cell_of(long long idx, int nby, int nbx,
                                        int ci, int cj) {
  const int mc = (nby - ci + 1) / 2;
  const int nc = (nbx - cj + 1) / 2;
  const int jj = static_cast<int>(idx % nc);
  const long long t = idx / nc;
  const int ii = static_cast<int>(t % mc);
  return Cell{t / mc, ci + 2 * ii, cj + 2 * jj};
}

// The cell's 9 candidate MVs (0 off the grid), their ranks (border case of
// the global extents h/cur x w/cur) and presence.
__device__ __forceinline__ void load_candidates(
    const int* __restrict__ grid, const int* __restrict__ rank_table, Cell c,
    int nby, int nbx, int nby_t, int nbx_t, int cx[9], int cy[9], int rank[9],
    bool present[9]) {
  const int cs = border_case(c.i, c.j, nby_t, nbx_t);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int gi = c.i + kSlotDy[k];
    const int gj = c.j + kSlotDx[k];
    const bool in_grid = gi >= 0 && gi < nby && gj >= 0 && gj < nbx;
    cx[k] = 0;
    cy[k] = 0;
    if (in_grid) {
      const size_t o = ((c.b * nby + gi) * nbx + gj) * 2;
      cx[k] = grid[o];
      cy[k] = grid[o + 1];
    }
    rank[k] = rank_table[cs * 9 + k];
    present[k] =
        rank[k] < kBigRank && gi >= 0 && gi < nby_t && gj >= 0 && gj < nbx_t;
  }
}

// Whether candidate k's target sub-block lies in the h x w frame.
__device__ __forceinline__ bool in_image(Cell c, int cur, int h, int w,
                                         int cx, int cy) {
  const int tx = c.j * cur + cx;
  const int ty = c.i * cur + cy;
  return tx >= 0 && tx <= w - cur && ty >= 0 && ty <= h - cur;
}

// energy = cost + lam * smoothness in f32 with separate, correctly rounded
// multiply and add (no FMA), FLT_MAX where the candidate is absent, out of
// the image or not evaluable; the lexicographic (energy, rank) winner is
// written to the cell.  usable[k] = present && in image && evaluable.
__device__ __forceinline__ void finish_step(int* __restrict__ grid, Cell c,
                                            int nby, int nbx, float lam,
                                            const int cx[9], const int cy[9],
                                            const int rank[9],
                                            const bool present[9],
                                            const int cost[9],
                                            const bool usable[9]) {
  float best_e = 0.0f;
  int best_r = 0;
  int best = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    int smooth = 0;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      if (present[q]) smooth += abs(cx[k] - cx[q]) + abs(cy[k] - cy[q]);
    }
    const float e = usable[k] ? __fadd_rn(__int2float_rn(cost[k]),
                                          __fmul_rn(lam, __int2float_rn(smooth)))
                              : FLT_MAX;
    if (k == 0 || e < best_e || (e == best_e && rank[k] < best_r)) {
      best_e = e;
      best_r = rank[k];
      best = k;
    }
  }
  const size_t o = ((c.b * nby + c.i) * nbx + c.j) * 2;
  grid[o] = cx[best];
  grid[o + 1] = cy[best];
}

}  // namespace bbme_step
