// Pooled cost volumes at the sub-block sizes, in one pass.
//
// Replaces blockbasedmotionestimation_tpu/kernels/cv_diff.py delta_pooled_cvs
// (kernel B: its static diff + deeper-size calls and its "planes"/"reshape"
// variant), deep_pooled_cvs (kernel C) and full_block_volume (kernel 13, the
// cur = bs volume alone): one kernel, generic over bs.  For
// parent block P of frame 1 and every delta (dy, dx) in [-r, r]^2 it
// computes |P - W[r+dy.., r+dx..]| (or the square) against the parent's
// frame-2 window W, sums it over 2x2 cells (cur = 2), and pools 2x2 cells up
// to cur = bs.  Output for size cur is the reference's _compute_cv layout with
// a leading batch dim: cv[b, dy*side + dx, py*f + sy, px*f + sx], f = bs/cur.
// Sizes whose worst-case cost fits stay 16-bit (is16_mask), the rest int32.
//
// What is written is narrowed two ways, with the same diffs and pooling:
//   - emit_mask: bit i set writes size 2 << i; the others are pooled in
//     shared memory only (kernel C writes cur > fuse_max and cur = bs,
//     kernel 13 cur = bs);
//   - store_r >= 0: the cur=2 volume keeps only dx in [-store_r, store_r]
//     with every dy row, index dy*side_st + (dx - r + store_r) (the stored
//     band the cur=2 colour step reads; the rest it recomputes).
//
// One thread block per (parent, dy): the parent block and the bs window rows
// that row of deltas reads sit in shared memory; the cur=2 sums of all dx go
// to shared memory, and each coarser size is pooled from the previous one in
// shared memory (ping-pong buffers), so every diff is computed once.
//
// Bound: device-memory writes.  At the 1080p level-0 main window the dense
// volumes are ~1.9 GB per frame (cur=2 alone 1089 deltas x 640 x 1024 cells x
// 2 B; the band at store_r = 4 keeps 297 of the 1089); the diffs are ~1.1 G
// integer ops per frame.  Each warp writes its cells in runs of consecutive
// sx, so the cur=2 stores are 32-byte runs.  Offsets are 64-bit: the B=8
// dense cur=2 volume has 5.7 G entries.  (Measured on the H100 the diff pass,
// not the writes, bounds it: PERF.md.)
//
// Also here: kernel 14, compact_tables (cv_diff.py compact_tables, the
// cv_compact mode): the pooled costs at only the K slot deltas of each
// parent's 128-parent chunk, for cur = 2 .. bs/2.  One thread block per
// (frame, parent) loops over the K slots.  Its work is K * bs^2 diffs per
// parent (K = 64: ~6% of B's 1089 deltas at bs 32, r 16) and K * 4/3 * (bs/2)^2
// table entries; the table writes (16-bit, ~1 GB at the 1080p level 0, B=8,
// K=64) bound it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCurs = 8;

struct CvOuts {
  void* p[kMaxCurs];
};

__device__ __forceinline__ void store_cost(void* base, bool is16, size_t o,
                                           int v) {
  if (is16) {
    static_cast<uint16_t*>(base)[o] = static_cast<uint16_t>(v);
  } else {
    static_cast<int*>(base)[o] = v;
  }
}

__global__ void pooled_cvs_kernel(const uint8_t* __restrict__ im1,
                                  const uint8_t* __restrict__ windows,
                                  CvOuts outs, int ncur, int is16_mask,
                                  int emit_mask, int h, int w, int bs,
                                  int side, int store_r, int ssd,
                                  int buf1_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npx = w / bs;
  const int npy = h / bs;
  const int n_p = npy * npx;
  const int n = blockIdx.x;
  const int dyi = blockIdx.y;
  const int b = n / n_p;
  const int p = n % n_p;
  const int py = p / npx;
  const int px = p % npx;
  const int f2 = bs / 2;
  const int wcols = side - 1 + bs;  // the window edge

  int* buf0 = reinterpret_cast<int*>(smem);  // side * f2 * f2
  int* buf1 = buf0 + side * f2 * f2;         // buf1_len
  uint8_t* patch = reinterpret_cast<uint8_t*>(buf1 + buf1_len);  // bs * bs
  uint8_t* wrow = patch + bs * bs;                                // bs * wcols

  for (int t = threadIdx.x; t < bs * bs; t += blockDim.x) {
    const int y = t / bs;
    const int x = t % bs;
    patch[t] = im1[(static_cast<size_t>(b) * h + py * bs + y) * w + px * bs + x];
  }
  const uint8_t* wbase = windows + static_cast<size_t>(n) * wcols * wcols;
  for (int t = threadIdx.x; t < bs * wcols; t += blockDim.x) {
    const int y = t / wcols;
    const int x = t % wcols;
    wrow[t] = wbase[static_cast<size_t>(dyi + y) * wcols + x];
  }
  __syncthreads();

  const size_t ndelta = static_cast<size_t>(side) * side;
  int f = f2;
  // cur = 2: cell sums straight from the pixels; the band keeps dx columns
  // [lo, lo + side_st) of the side
  {
    const bool emit = emit_mask & 1;
    const int side_st = store_r < 0 ? side : 2 * store_r + 1;
    const int lo = store_r < 0 ? 0 : (side - 1) / 2 - store_r;
    const size_t nd2 = static_cast<size_t>(side) * side_st;
    const size_t ncol = static_cast<size_t>(npx) * f;
    const size_t plane = static_cast<size_t>(npy) * f * ncol;
    for (int it = threadIdx.x; it < side * f * f; it += blockDim.x) {
      const int dxi = it / (f * f);
      const int c = it % (f * f);
      const int sy = c / f;
      const int sx = c % f;
      int s = 0;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int y = 2 * sy + u;
          const int x = 2 * sx + v;
          const int d = static_cast<int>(patch[y * bs + x]) -
                        static_cast<int>(wrow[y * wcols + dxi + x]);
          s += ssd ? d * d : abs(d);
        }
      }
      buf0[it] = s;
      if (emit && dxi >= lo && dxi < lo + side_st) {
        const size_t o =
            (b * nd2 + static_cast<size_t>(dyi) * side_st + (dxi - lo)) * plane +
            static_cast<size_t>(py * f + sy) * ncol + px * f + sx;
        store_cost(outs.p[0], is16_mask & 1, o, s);
      }
    }
  }
  // cur = 4 .. bs: 2x2 pooling of the previous size, in shared memory
  int* src = buf0;
  int* dst = buf1;
  for (int lvl = 1; lvl < ncur; ++lvl) {
    __syncthreads();
    const bool emit = (emit_mask >> lvl) & 1;
    const int fp = f;
    f >>= 1;
    const size_t ncol = static_cast<size_t>(npx) * f;
    const size_t plane = static_cast<size_t>(npy) * f * ncol;
    for (int it = threadIdx.x; it < side * f * f; it += blockDim.x) {
      const int dxi = it / (f * f);
      const int c = it % (f * f);
      const int sy = c / f;
      const int sx = c % f;
      const int* q = src + dxi * fp * fp + (2 * sy) * fp + 2 * sx;
      const int s = q[0] + q[1] + q[fp] + q[fp + 1];
      dst[it] = s;
      if (emit) {
        const size_t o =
            (b * ndelta + static_cast<size_t>(dyi) * side + dxi) * plane +
            static_cast<size_t>(py * f + sy) * ncol + px * f + sx;
        store_cost(outs.p[lvl], (is16_mask >> lvl) & 1, o, s);
      }
    }
    int* tmp = src;
    src = dst;
    dst = tmp;
  }
}

// Kernel 14: one thread block per (frame, parent).  The parent block and its
// whole window sit in shared memory; for each of the K slots of the parent's
// chunk (`chunk` consecutive parents of the frame), the cur=2 cell sums of the
// block against the window at the slot's delta, then 2x2 pooling up to
// bs/2, each size written at slot k of its table.  A slot of -1 writes 0.
__global__ void compact_tables_kernel(const uint8_t* __restrict__ im1,
                                      const uint8_t* __restrict__ windows,
                                      const int* __restrict__ slots,
                                      CvOuts outs, int ncur, int is16_mask,
                                      int h, int w, int bs, int ws,
                                      int k_slots, int nch, int chunk, int ssd,
                                      int buf1_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npx = w / bs;
  const int npy = h / bs;
  const int n_p = npy * npx;
  const int n = blockIdx.x;
  const int b = n / n_p;
  const int p = n % n_p;
  const int py = p / npx;
  const int px = p % npx;
  const int f2 = bs / 2;

  int* buf0 = reinterpret_cast<int*>(smem);                       // f2 * f2
  int* buf1 = buf0 + f2 * f2;                                     // buf1_len
  uint8_t* patch = reinterpret_cast<uint8_t*>(buf1 + buf1_len);  // bs * bs
  uint8_t* win = patch + bs * bs;                                 // ws * ws

  for (int t = threadIdx.x; t < bs * bs; t += blockDim.x) {
    patch[t] = im1[(static_cast<size_t>(b) * h + py * bs + t / bs) * w + px * bs + t % bs];
  }
  const uint8_t* wbase = windows + static_cast<size_t>(n) * ws * ws;
  for (int t = threadIdx.x; t < ws * ws; t += blockDim.x) win[t] = wbase[t];
  __syncthreads();

  const int* sl = slots + (static_cast<size_t>(b) * nch + p / chunk) * k_slots * 2;
  for (int k = 0; k < k_slots; ++k) {
    const int dy = sl[2 * k];
    const int dx = sl[2 * k + 1];
    const bool used = dy >= 0 && dx >= 0;
    int f = f2;
    {
      const size_t ncol = static_cast<size_t>(npx) * f;
      const size_t plane = static_cast<size_t>(npy) * f * ncol;
      for (int c = threadIdx.x; c < f * f; c += blockDim.x) {
        const int sy = c / f;
        const int sx = c % f;
        int s = 0;
        if (used) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int y = 2 * sy + u;
              const int x = 2 * sx + v;
              const int d = static_cast<int>(patch[y * bs + x]) -
                            static_cast<int>(win[(dy + y) * ws + dx + x]);
              s += ssd ? d * d : abs(d);
            }
          }
        }
        buf0[c] = s;
        const size_t o = (static_cast<size_t>(b) * k_slots + k) * plane +
                         static_cast<size_t>(py * f + sy) * ncol + px * f + sx;
        store_cost(outs.p[0], is16_mask & 1, o, s);
      }
    }
    int* src = buf0;
    int* dst = buf1;
    for (int lvl = 1; lvl < ncur; ++lvl) {
      __syncthreads();
      const int fp = f;
      f >>= 1;
      const size_t ncol = static_cast<size_t>(npx) * f;
      const size_t plane = static_cast<size_t>(npy) * f * ncol;
      for (int c = threadIdx.x; c < f * f; c += blockDim.x) {
        const int sy = c / f;
        const int sx = c % f;
        const int* q = src + (2 * sy) * fp + 2 * sx;
        const int s = q[0] + q[1] + q[fp] + q[fp + 1];
        dst[c] = s;
        const size_t o = (static_cast<size_t>(b) * k_slots + k) * plane +
                         static_cast<size_t>(py * f + sy) * ncol + px * f + sx;
        store_cost(outs.p[lvl], (is16_mask >> lvl) & 1, o, s);
      }
      int* tmp = src;
      src = dst;
      dst = tmp;
    }
    __syncthreads();  // the next slot overwrites buf0
  }
}

}  // namespace

// im1: (B, h, w) u8 frame-1 level image (parents are its bs x bs blocks);
// windows: (B * nP, bs + 2r, bs + 2r) u8; side = 2r + 1.
// outs[i]: volume of cur = 2 << i, (B, side^2, npy * f, npx * f), 16-bit
// where bit i of is16_mask is set, else int32; written where bit i of
// emit_mask is set (else unused, may be null).  store_r >= 0 narrows outs[0]
// to (B, side * (2 store_r + 1), h / 2, w / 2); -1 keeps it dense.
extern "C" int bbme_pooled_cvs(const void* im1, const void* windows,
                               void* const* outs, int ncur, int is16_mask,
                               int emit_mask, int batch, int h, int w, int bs,
                               int side, int store_r, int ssd, void* stream) {
  if (ncur < 1 || ncur > kMaxCurs) return static_cast<int>(cudaErrorInvalidValue);
  if (store_r > (side - 1) / 2) return static_cast<int>(cudaErrorInvalidValue);
  CvOuts o{};
  for (int i = 0; i < ncur; ++i) o.p[i] = outs[i];
  const int f2 = bs / 2;
  const int buf1_len = side * (f2 / 2 > 0 ? (f2 / 2) * (f2 / 2) : 1);
  const size_t smem = sizeof(int) * (static_cast<size_t>(side) * f2 * f2 + buf1_len) +
                      static_cast<size_t>(bs) * bs +
                      static_cast<size_t>(bs) * (side - 1 + bs);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pooled_cvs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>(batch) * (h / bs) * (w / bs), side);
  if (grid.x == 0) return 0;
  pooled_cvs_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(im1), static_cast<const uint8_t*>(windows), o,
      ncur, is16_mask, emit_mask, h, w, bs, side, store_r, ssd, buf1_len);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 14.  im1: (B, h, w) u8; windows: (B * nP, ws, ws) u8, ws = bs + 2r;
// slots: (B, nch, K, 2) i32 window offsets (dy + r, dx + r) of each chunk's
// slots, -1 unused, one list per `chunk` parents; outs[i]: table of cur =
// 2 << i, (B, K, h / cur, w / cur), 16-bit where bit i of is16_mask is set, else int32, for cur = 2 .. bs/2
// (ncur = log2(bs) - 1 sizes).
extern "C" int bbme_compact_tables(const void* im1, const void* windows,
                                   const void* slots, void* const* outs,
                                   int ncur, int is16_mask, int batch, int h,
                                   int w, int bs, int ws, int k_slots, int nch,
                                   int chunk, int ssd, void* stream) {
  if (ncur < 1 || ncur > kMaxCurs || (2 << ncur) != bs || chunk < 1 ||
      nch != ((h / bs) * (w / bs) + chunk - 1) / chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CvOuts o{};
  for (int i = 0; i < ncur; ++i) o.p[i] = outs[i];
  const int f2 = bs / 2;
  const int buf1_len = f2 / 2 > 0 ? (f2 / 2) * (f2 / 2) : 1;
  const size_t smem = sizeof(int) * (static_cast<size_t>(f2) * f2 + buf1_len) +
                      static_cast<size_t>(bs) * bs + static_cast<size_t>(ws) * ws;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        compact_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>(batch) * (h / bs) * (w / bs);
  if (blocks == 0 || k_slots == 0) return 0;
  compact_tables_kernel<<<blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(im1), static_cast<const uint8_t*>(windows),
      static_cast<const int*>(slots), o, ncur, is16_mask, h, w, bs, ws, k_slots,
      nch, chunk, ssd, buf1_len);
  return static_cast<int>(cudaGetLastError());
}
