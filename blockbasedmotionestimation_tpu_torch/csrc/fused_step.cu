// The colour steps of the sub-block rounds that recompute candidate costs
// from window pixels instead of reading them all from stored volumes.
//
// Replaces blockbasedmotionestimation_tpu/kernels/fused_step.py
//   windowed_color_step_pm_hybrid (kernel E, rounds cur <= fuse_max): main
//     candidates from the dense main volume at cur, rival candidates
//     recomputed against the rival window;
//   windowed_color_step_pm_hybrid_tail (kernel F, the cur = 2 round with the
//     stored band): main candidates with |dx delta| <= store_r from the band,
//     the other main-window candidates recomputed against the main window,
//     rival candidates against the rival window;
//   windowed_color_step_pm_fused (kernel 11, cv_fused rounds cur <= fuse):
//     no volume at all, every main-window candidate recomputed against the
//     main window;
//   windowed_color_step_pm_fused_rival (kernel 12): kernel 11 plus the rival
//     window for candidates outside the main one.
// One template, hybrid_step_kernel<Form>, for the four.
// One colour step of one colour, in place, like reg_step.cu: one thread per
// cell (i, j) of colour (ci, cj).  Candidates, ranks, the in-image mask and
// the (energy, rank) winner are step_common.cuh's, as for D/D'.
//
// A recomputed cost is the cur x cur SAD (or SSD) of the cell's frame-1
// sub-block against the window the volumes were built from, at the
// candidate's delta: window (b, p) of edge bs + 2R holds the frame-2 pixels
// around parent p's window centre with the gather's zero padding, so
// delta (dy, dx) of the sub-block at (oy, ox) in its parent reads window
// rows R + dy + oy .., cols R + dx + ox ...  The integer sum is exact in any
// order, so it equals the volume's value bit for bit.  The TPU kernels' bbox
// visit, x-parity planes and one-hot picks were for Mosaic and VMEM and are
// not carried over.
//
// Bound: device-memory latency of the data-dependent reads, as for D/D'.
// Picks are one 2- or 4-byte read per candidate; a recompute reads cur^2
// frame-1 and cur^2 window bytes (<= 512 B at cur = 16), through L1/L2.
// After the search most candidates lie in the band (F) or the main window
// (E), so recomputes are rare but for motion edges and frame borders.  The
// fused steps (11, 12) recompute every usable candidate: at cur <= 4 that
// is <= 9 x 32 bytes per cell, mostly hits in L1/L2 since neighbouring
// cells share candidates and window rows.
#include <cstdint>
#include <cuda_runtime.h>

#include "step_common.cuh"

namespace {

using namespace bbme_step;

struct HybridArgs {
  int* grid;
  const void* cv;     // E: (B, side^2, nby, nbx); F: band (B, side*side_st, nby, nbx); 11/12: null
  int cv16;
  const uint8_t* im1;   // (B, h, w) frame-1 level image
  const uint8_t* win;   // F, 11, 12: (B, nP, bs + 2r, bs + 2r) main windows
  const uint8_t* rwin;  // (B, nP, bs + 2r2, bs + 2r2) rival windows; 11: null
  const int* pm;        // (B, npy, npx, 2) main window centres
  const int* rpm;       // (B, npy, npx, 2) rival window centres; 11: null
  const int* rank_table;
  long long total;
  int nby, nbx, f, cur, h, w, r, store_r, r2, ssd, ci, cj;
  float lam;
};

// cur x cur SAD/SSD of frame-1 sub-block a (row pitch w) against window
// pixels v (row pitch ws)
__device__ __forceinline__ int block_cost(const uint8_t* __restrict__ a, int w,
                                          const uint8_t* __restrict__ v, int ws,
                                          int cur, int ssd) {
  int s = 0;
  for (int y = 0; y < cur; ++y) {
    for (int x = 0; x < cur; ++x) {
      const int d = static_cast<int>(a[y * w + x]) - static_cast<int>(v[y * ws + x]);
      s += ssd ? d * d : abs(d);
    }
  }
  return s;
}

enum Form { kHybrid, kTail, kFused };  // E, F, 11/12

template <Form kForm>
__global__ void hybrid_step_kernel(HybridArgs a) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= a.total) return;
  const Cell c = cell_of(idx, a.nby, a.nbx, a.ci, a.cj);
  int cx[9], cy[9], rank[9];
  bool present[9];
  load_candidates(a.grid, a.rank_table, c, a.nby, a.nbx, a.h / a.cur,
                  a.w / a.cur, cx, cy, rank, present);

  const int npy = a.nby / a.f;
  const int npx = a.nbx / a.f;
  const long long p = (c.b * npy + c.i / a.f) * npx + c.j / a.f;  // b * nP + parent
  const int pmx = a.pm[p * 2];
  const int pmy = a.pm[p * 2 + 1];
  const int rpmx = a.rwin ? a.rpm[p * 2] : 0;
  const int rpmy = a.rwin ? a.rpm[p * 2 + 1] : 0;
  const int bs = a.f * a.cur;
  const int oy = (c.i % a.f) * a.cur;  // the sub-block in its parent
  const int ox = (c.j % a.f) * a.cur;
  const uint8_t* blk = a.im1 + (static_cast<size_t>(c.b) * a.h + c.i * a.cur) * a.w +
                       static_cast<size_t>(c.j) * a.cur;
  const int side = 2 * a.r + 1;
  const int side_st = kForm == kTail ? 2 * a.store_r + 1 : side;
  const int cr = kForm == kTail ? a.store_r : a.r;  // stored dx radius
  const int ws = bs + 2 * a.r;
  const int rws = bs + 2 * a.r2;
  const size_t plane = static_cast<size_t>(a.nby) * a.nbx;
  const size_t cell = static_cast<size_t>(c.i) * a.nbx + c.j;

  int cost[9];
  bool usable[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int ddx = cx[k] - pmx;
    const int ddy = cy[k] - pmy;
    const bool in_window = ddx >= -a.r && ddx <= a.r && ddy >= -a.r && ddy <= a.r;
    const int rdx = cx[k] - rpmx;
    const int rdy = cy[k] - rpmy;
    const bool in_rival = a.rwin != nullptr && rdx >= -a.r2 && rdx <= a.r2 &&
                          rdy >= -a.r2 && rdy <= a.r2;
    usable[k] = present[k] && (in_window || in_rival) &&
                in_image(c, a.cur, a.h, a.w, cx[k], cy[k]);
    cost[k] = 0;
    if (!usable[k]) continue;  // its energy is FLT_MAX whatever the cost
    if (kForm != kFused && in_window && ddx >= -cr && ddx <= cr) {
      const size_t key = static_cast<size_t>(ddy + a.r) * side_st + (ddx + cr);
      cost[k] = load_cost(a.cv, a.cv16, (c.b * side * side_st + key) * plane + cell);
    } else if (in_window) {  // F beyond the band, 11/12 always: the main window
      const uint8_t* v = a.win + (static_cast<size_t>(p) * ws + a.r + ddy + oy) * ws +
                         a.r + ddx + ox;
      cost[k] = block_cost(blk, a.w, v, ws, a.cur, a.ssd);
    } else {  // the rival window
      const uint8_t* v = a.rwin + (static_cast<size_t>(p) * rws + a.r2 + rdy + oy) * rws +
                         a.r2 + rdx + ox;
      cost[k] = block_cost(blk, a.w, v, rws, a.cur, a.ssd);
    }
  }
  finish_step(a.grid, c, a.nby, a.nbx, a.lam, cx, cy, rank, present, cost, usable);
}

template <Form kForm>
int launch(const HybridArgs& a, void* stream) {
  if (a.total <= 0) return 0;
  const int threads = 256;
  const long long blocks = (a.total + threads - 1) / threads;
  hybrid_step_kernel<kForm><<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

long long cells(int batch, int nby, int nbx, int ci, int cj) {
  return static_cast<long long>(batch) * ((nby - ci + 1) / 2) * ((nbx - cj + 1) / 2);
}

}  // namespace

// Kernel E.  grid: (B, nby, nbx, 2) i32, updated in place; cv: (B, side^2,
// nby, nbx) main volume at cur; im1: (B, h, w) u8; rwin: (B, nP, bs + 2 r2,
// bs + 2 r2) u8 rival windows; pm / rpm: (B, nby/f, nbx/f, 2) i32 window
// centres; rank_table: (9, 9) i32.
extern "C" int bbme_color_step_hybrid(void* grid, const void* cv, int cv16,
                                      const void* im1, const void* rwin,
                                      const void* pm, const void* rpm,
                                      const void* rank_table, int batch,
                                      int nby, int nbx, int f, int cur, int h,
                                      int w, int r, int r2, int ssd, int ci,
                                      int cj, float lam, void* stream) {
  const HybridArgs a{static_cast<int*>(grid), cv, cv16,
                     static_cast<const uint8_t*>(im1), nullptr,
                     static_cast<const uint8_t*>(rwin),
                     static_cast<const int*>(pm), static_cast<const int*>(rpm),
                     static_cast<const int*>(rank_table),
                     cells(batch, nby, nbx, ci, cj), nby, nbx, f, cur, h, w, r,
                     -1, r2, ssd, ci, cj, lam};
  return launch<kHybrid>(a, stream);
}

// Kernel F.  As E, with band: (B, side * (2 store_r + 1), nby, nbx) the
// stored cur=2 band and win: (B, nP, bs + 2r, bs + 2r) u8 main windows.
extern "C" int bbme_color_step_hybrid_tail(void* grid, const void* band,
                                           int band16, const void* im1,
                                           const void* win, const void* rwin,
                                           const void* pm, const void* rpm,
                                           const void* rank_table, int batch,
                                           int nby, int nbx, int f, int cur,
                                           int h, int w, int r, int store_r,
                                           int r2, int ssd, int ci, int cj,
                                           float lam, void* stream) {
  if (store_r < 0 || store_r > r) return static_cast<int>(cudaErrorInvalidValue);
  const HybridArgs a{static_cast<int*>(grid), band, band16,
                     static_cast<const uint8_t*>(im1),
                     static_cast<const uint8_t*>(win),
                     static_cast<const uint8_t*>(rwin),
                     static_cast<const int*>(pm), static_cast<const int*>(rpm),
                     static_cast<const int*>(rank_table),
                     cells(batch, nby, nbx, ci, cj), nby, nbx, f, cur, h, w, r,
                     store_r, r2, ssd, ci, cj, lam};
  return launch<kTail>(a, stream);
}

// Kernels 11 (rwin, rpm null) and 12.  grid: (B, nby, nbx, 2) i32, updated
// in place; im1: (B, h, w) u8; win: (B, nP, bs + 2r, bs + 2r) u8 main
// windows; rwin: (B, nP, bs + 2 r2, bs + 2 r2) u8 rival windows; pm / rpm:
// (B, nby/f, nbx/f, 2) i32 window centres; rank_table: (9, 9) i32.
extern "C" int bbme_color_step_fused(void* grid, const void* im1,
                                     const void* win, const void* rwin,
                                     const void* pm, const void* rpm,
                                     const void* rank_table, int batch,
                                     int nby, int nbx, int f, int cur, int h,
                                     int w, int r, int r2, int ssd, int ci,
                                     int cj, float lam, void* stream) {
  if ((rwin == nullptr) != (rpm == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const HybridArgs a{static_cast<int*>(grid), nullptr, 0,
                     static_cast<const uint8_t*>(im1),
                     static_cast<const uint8_t*>(win),
                     static_cast<const uint8_t*>(rwin),
                     static_cast<const int*>(pm), static_cast<const int*>(rpm),
                     static_cast<const int*>(rank_table),
                     cells(batch, nby, nbx, ci, cj), nby, nbx, f, cur, h, w, r,
                     -1, r2, ssd, ci, cj, lam};
  return launch<kFused>(a, stream);
}
