// One colour step of the windowed regularizer, in place on the MV grid.
//
// Replaces blockbasedmotionestimation_tpu/kernels/reg_step.py
// windowed_color_step_rival (kernel D, rounds at cur = bs) and
// windowed_color_step_pm_rival (kernel D', rounds at cur < bs), and their
// non-rival forms: one kernel for every round, since the cell layout here is
// the plain grid and the parent of cell (i, j) is (i / f, j / f).
//
// One thread per cell (i, j) of colour (ci, cj), i = ci + 2*ii, j = cj + 2*jj:
//   1. reads its 9 candidate MVs (own + 8 neighbours, the reference's slot
//      order) from the grid, 0 outside it;
//   2. takes presence and tie-break rank from the border case (global
//      extents h/cur, w/cur) and the rank table;
//   3. picks each candidate's cost from the main volume when the candidate
//      lies in the parent's window, else from the rival volume when it lies
//      in the rival window (own window first);
//   4. masks candidates whose target block leaves the image;
//   5. energy = cost + lam * smoothness in f32 with separate, correctly
//      rounded multiply and add (__fmul_rn/__fadd_rn, no FMA), FLT_MAX when
//      not evaluable, and the lexicographic (energy, rank) winner;
//   6. writes the winner in place.
// All 8 neighbours of a cell have another colour, so the in-place write is
// race-free, and one launch per colour reproduces the reference's
// Gauss-Seidel colour order.
//
// Bound: device-memory latency of the 9 data-dependent cost reads per cell
// (~0.65 M cells per 1080p frame at cur = 2).  Neighbouring threads are
// neighbouring cells, so on smooth motion their cost reads are neighbouring
// addresses of one delta plane.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ int kSlotDy[9] = {0, 0, 0, 1, -1, -1, -1, 1, 1};
__constant__ int kSlotDx[9] = {0, -1, 1, 1, -1, 1, 0, 0, -1};
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

__global__ void color_step_kernel(int* __restrict__ grid,
                                  const void* __restrict__ cv, int cv16,
                                  const void* __restrict__ rcv, int rcv16,
                                  const int* __restrict__ pm,
                                  const int* __restrict__ rpm,
                                  const int* __restrict__ rank_table,
                                  long long total, int nby, int nbx, int f,
                                  int cur, int h, int w, int r, int r2,
                                  int ci, int cj, float lam) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= total) return;
  const int mc = (nby - ci + 1) / 2;
  const int nc = (nbx - cj + 1) / 2;
  const int jj = static_cast<int>(idx % nc);
  const long long t = idx / nc;
  const int ii = static_cast<int>(t % mc);
  const long long b = t / mc;
  const int i = ci + 2 * ii;
  const int j = cj + 2 * jj;
  const int nby_t = h / cur;
  const int nbx_t = w / cur;
  const int cs = border_case(i, j, nby_t, nbx_t);

  int cx[9], cy[9], rank[9];
  bool present[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int gi = i + kSlotDy[k];
    const int gj = j + kSlotDx[k];
    const bool in_grid = gi >= 0 && gi < nby && gj >= 0 && gj < nbx;
    cx[k] = 0;
    cy[k] = 0;
    if (in_grid) {
      const size_t o = ((b * nby + gi) * nbx + gj) * 2;
      cx[k] = grid[o];
      cy[k] = grid[o + 1];
    }
    rank[k] = rank_table[cs * 9 + k];
    present[k] = rank[k] < kBigRank && gi >= 0 && gi < nby_t && gj >= 0 && gj < nbx_t;
  }

  const int npy = nby / f;
  const int npx = nbx / f;
  const size_t po = ((b * npy + i / f) * npx + j / f) * 2;
  const int pmx = pm[po];
  const int pmy = pm[po + 1];
  const int rpmx = rpm ? rpm[po] : 0;
  const int rpmy = rpm ? rpm[po + 1] : 0;
  const int side = 2 * r + 1;
  const int side2 = 2 * r2 + 1;
  const size_t plane = static_cast<size_t>(nby) * nbx;
  const size_t cell = static_cast<size_t>(i) * nbx + j;

  float best_e = 0.0f;
  int best_r = 0;
  int best = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int ddx = cx[k] - pmx;
    const int ddy = cy[k] - pmy;
    const bool in_window = ddx >= -r && ddx <= r && ddy >= -r && ddy <= r;
    bool evaluable = in_window;
    int cost = 0;
    if (in_window) {
      const size_t key = static_cast<size_t>(ddy + r) * side + (ddx + r);
      cost = load_cost(cv, cv16, (b * side * side + key) * plane + cell);
    } else if (rcv) {
      const int rdx = cx[k] - rpmx;
      const int rdy = cy[k] - rpmy;
      if (rdx >= -r2 && rdx <= r2 && rdy >= -r2 && rdy <= r2) {
        const size_t key = static_cast<size_t>(rdy + r2) * side2 + (rdx + r2);
        cost = load_cost(rcv, rcv16, (b * side2 * side2 + key) * plane + cell);
        evaluable = true;
      }
    }
    const int tx = j * cur + cx[k];
    const int ty = i * cur + cy[k];
    const bool in_img = tx >= 0 && tx <= w - cur && ty >= 0 && ty <= h - cur;
    int smooth = 0;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      if (present[q]) smooth += abs(cx[k] - cx[q]) + abs(cy[k] - cy[q]);
    }
    const float e = (present[k] && in_img && evaluable)
                        ? __fadd_rn(__int2float_rn(cost),
                                    __fmul_rn(lam, __int2float_rn(smooth)))
                        : FLT_MAX;
    if (k == 0 || e < best_e || (e == best_e && rank[k] < best_r)) {
      best_e = e;
      best_r = rank[k];
      best = k;
    }
  }
  const size_t o = ((b * nby + i) * nbx + j) * 2;
  grid[o] = cx[best];
  grid[o + 1] = cy[best];
}

}  // namespace

// grid: (B, nby, nbx, 2) i32, updated in place; cv: (B, side^2, nby, nbx);
// rcv: (B, side2^2, nby, nbx) or null; pm / rpm: (B, nby/f, nbx/f, 2) i32
// window centres (rpm null without rival); rank_table: (9, 9) i32.
extern "C" int bbme_color_step(void* grid, const void* cv, int cv16,
                               const void* rcv, int rcv16, const void* pm,
                               const void* rpm, const void* rank_table,
                               int batch, int nby, int nbx, int f, int cur,
                               int h, int w, int r, int r2, int ci, int cj,
                               float lam, void* stream) {
  const long long total = static_cast<long long>(batch) * ((nby - ci + 1) / 2) *
                          ((nbx - cj + 1) / 2);
  if (total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  color_step_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(grid), cv, cv16, rcv, rcv16,
      static_cast<const int*>(pm), static_cast<const int*>(rpm),
      static_cast<const int*>(rank_table), total, nby, nbx, f, cur, h, w, r,
      r2, ci, cj, lam);
  return static_cast<int>(cudaGetLastError());
}
