// Kernel 10: one colour step of the cv_compact rounds, in place on the MV
// grid.
//
// Replaces blockbasedmotionestimation_tpu/kernels/reg_step.py
// windowed_color_step_pm_compact (the cv_compact rounds cur < bs): the
// colour step of kernels D/D'/8/9 with each cost looked up in a K-slot table
// (color_step_compact_kernel).  D, D', 8 and 9 themselves run a round a
// cooperative launch in fused_step.cu (round_kernel<kStored>).  Steps 1, 2
// and 4-6 are step_common.cuh's.
//
// One thread per cell (i, j) of colour (ci, cj), i = ci + 2*ii, j = cj + 2*jj:
//   1. reads its 9 candidate MVs (own + 8 neighbours, the reference's slot
//      order) from the grid, 0 outside it;
//   2. takes presence and tie-break rank from the border case (global
//      extents h/cur, w/cur) and the rank table;
//   3. finds each candidate's delta from its parent's window centre among
//      its chunk's K slots and reads the cost of the slot that holds it;
//   4. masks candidates whose target block leaves the image;
//   5. energy = cost + lam * smoothness in f32 with separate, correctly
//      rounded multiply and add (__fmul_rn/__fadd_rn, no FMA), FLT_MAX when
//      not evaluable, and the lexicographic (energy, rank) winner;
//   6. writes the winner in place.
// All 8 neighbours of a cell have another colour, so the in-place write is
// race-free, and one launch per colour reproduces the reference's
// Gauss-Seidel colour order.
//
// Bound: the K x 9 slot compares of each cell, and the latency of its
// data-dependent table reads.
#include <cstdint>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

using namespace bbme_step;

// Kernel 10 (windowed_color_step_pm_compact): the stored step with each cost
// taken from a K-slot table.  The cell's chunk (`chunk` consecutive parents
// of the frame) lists K volume indices (dy + r, dx + r), -1 unused; each slot
// is compared with the 9 candidates' deltas from the parent's window centre,
// and a matching slot gives the cost (slots are distinct: at most one
// matches).  A candidate in no slot is excluded, and if the cell's own MV is
// in none, every candidate is (the reference's incumbent-safety guard: the
// all-FLT_MAX tie goes to rank 0, the own MV).  The slot list is read as
// int2 from L1/L2: the K x 9 compares, not memory, are the step's work.
__global__ void color_step_compact_kernel(int* __restrict__ grid,
                                          const void* __restrict__ table,
                                          int table16,
                                          const int2* __restrict__ slots,
                                          const int* __restrict__ pm,
                                          const int* __restrict__ rank_table,
                                          long long total, int nby, int nbx,
                                          int f, int cur, int h, int w, int r,
                                          int k_slots, int nch, int chunk,
                                          int ci, int cj, float lam) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= total) return;
  const Cell c = cell_of(idx, nby, nbx, ci, cj);
  int cx[9], cy[9], rank[9];
  bool present[9];
  load_candidates(grid, rank_table, c, nby, nbx, h / cur, w / cur, cx, cy,
                  rank, present);

  const int npy = nby / f;
  const int npx = nbx / f;
  const int p = (c.i / f) * npx + c.j / f;  // the parent in its frame
  const size_t po = (c.b * npy * npx + p) * 2;
  int kdy[9], kdx[9], slot[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    kdy[k] = cy[k] - pm[po + 1] + r;
    kdx[k] = cx[k] - pm[po] + r;
    slot[k] = -1;
  }
  const int2* sl = slots + (c.b * nch + p / chunk) * k_slots;
  for (int s = 0; s < k_slots; ++s) {
    const int2 d = sl[s];
    if (d.x < 0) continue;  // unused: matches nothing
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (kdy[k] == d.x && kdx[k] == d.y) slot[k] = s;
    }
  }
  const size_t plane = static_cast<size_t>(nby) * nbx;
  const size_t cell = static_cast<size_t>(c.i) * nbx + c.j;
  int cost[9];
  bool usable[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const bool covered = slot[k] >= 0 && slot[0] >= 0;
    cost[k] = covered ? load_cost(table, table16,
                                  (c.b * k_slots + slot[k]) * plane + cell)
                      : 0;
    usable[k] = present[k] && covered && in_image(c, cur, h, w, cx[k], cy[k]);
  }
  finish_step(grid, c, nby, nbx, lam, cx, cy, rank, present, cost, usable);
}

}  // namespace

// Kernel 10.  grid: (B, nby, nbx, 2) i32, updated in place; table: (B, K,
// nby, nbx) u16 (table16) or i32; slots: (B, nch, K, 2) i32, one list per
// `chunk` parents; pm: (B, nby/f, nbx/f, 2) i32 window centres; rank_table:
// (9, 9) i32.
extern "C" int bbme_color_step_compact(void* grid, const void* table,
                                       int table16, const void* slots,
                                       const void* pm, const void* rank_table,
                                       int batch, int nby, int nbx, int f,
                                       int cur, int h, int w, int r,
                                       int k_slots, int nch, int chunk, int ci,
                                       int cj, float lam, void* stream) {
  if (chunk < 1 || nch != ((nby / f) * (nbx / f) + chunk - 1) / chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(batch) * ((nby - ci + 1) / 2) *
                          ((nbx - cj + 1) / 2);
  if (total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  color_step_compact_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(grid), table, table16, static_cast<const int2*>(slots),
      static_cast<const int*>(pm), static_cast<const int*>(rank_table), total,
      nby, nbx, f, cur, h, w, r, k_slots, nch, chunk, ci, cj, lam);
  return static_cast<int>(cudaGetLastError());
}
