// Spiral block search: per block, the (2S+1)^2 SAD/SSD costs against its
// search window and their (cost, spiral rank) argmin.
//
// Replaces blockbasedmotionestimation_tpu/kernels/sad_search.py
// sad_spiral_argmin (kernel 7).  On the TPU that kernel put 128 blocks on
// the lanes, looped over window rows with the columns unrolled at static
// offsets, and streamed the spiral ranks from SMEM by scalar prefetch.  Here
// one thread block takes one (frame, block) pair: it stages the bs x bs
// block (read straight from the level image im1) and its win x win window
// (kernel A's output) in shared memory, and each thread scores the deltas
// d = tid, tid + blockDim, ... of the window in raster order.  Neighbouring
// threads take neighbouring dx, so their window reads fall in the same or
// adjacent words and every block read is a broadcast.
//
// Out-of-frame offsets cost INT32_MAX (the walk skips them but its cursor
// advances, so they still carry a rank).  Visiting in raster order with a
// lexicographic (cost, rank) update equals the walk's first-visit-wins
// strict <; the per-thread bests are reduced the same way, explicitly, by
// warp shuffles and then shared memory: no atomics, no unordered min.  The
// state starts at (INT32_MAX, INT32_MAX, centre), so a block whose offsets
// are all masked keeps the centre, as on the TPU.
//
// Bound: integer operations (a difference, an absolute value or square and
// an add per pixel per delta, 3 * nblk * side^2 * bs^2: 68.5 G at the 1080p
// level 0 at B=8, ~1 ms at the card's CUDA-core rate); its bytes (block,
// window, two int32 outputs per block) are ~0.1 GB.  This first version
// reads shared memory byte by byte; byte-SIMD sums (__vsadu4), window rows
// held in registers and several blocks per thread block are later work.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (cost, rank) lexicographic: is (c, r) better than (bc, br)?
__device__ __forceinline__ bool better(int c, int r, int bc, int br) {
  return c < bc || (c == bc && r < br);
}

__global__ void __launch_bounds__(kThreads)
sad_spiral_argmin_kernel(const uint8_t* __restrict__ im1,
                         const uint8_t* __restrict__ windows,
                         const int* __restrict__ cy, const int* __restrict__ cx,
                         const int* __restrict__ rank, int* __restrict__ out_dy,
                         int* __restrict__ out_dx, int n_per_frame, int nbx,
                         int h, int w, int bs, int ext, int ssd) {
  extern __shared__ uint8_t smem[];
  const int win = bs + 2 * ext;
  const int side = 2 * ext + 1;
  uint8_t* blk = smem;             // bs * bs
  uint8_t* wsm = smem + bs * bs;   // win * win

  const long long k = blockIdx.x;  // global block index, frame-major
  const long long b = k / n_per_frame;
  const int p = static_cast<int>(k % n_per_frame);
  const int oy = (p / nbx) * bs;
  const int ox = (p % nbx) * bs;
  const int tid = threadIdx.x;

  for (int i = tid; i < bs * bs; i += kThreads) {
    blk[i] = im1[(b * h + oy + i / bs) * static_cast<long long>(w) + ox + i % bs];
  }
  const uint8_t* wsrc = windows + k * win * win;
  for (int i = tid; i < win * win; i += kThreads) wsm[i] = wsrc[i];
  __syncthreads();

  const int ccy = cy[k];
  const int ccx = cx[k];
  int best_c = INT_MAX, best_r = INT_MAX, best_d = ext * side + ext;
  for (int d = tid; d < side * side; d += kThreads) {
    const int dy = d / side;
    const int dx = d - dy * side;
    const int ty = ccy + dy - ext;
    const int tx = ccx + dx - ext;
    int c = INT_MAX;
    if (ty >= 0 && ty <= h - bs && tx >= 0 && tx <= w - bs) {
      c = 0;
      for (int y = 0; y < bs; ++y) {
        const uint8_t* brow = blk + y * bs;
        const uint8_t* wrow = wsm + (dy + y) * win + dx;
        for (int x = 0; x < bs; ++x) {
          const int e = static_cast<int>(brow[x]) - static_cast<int>(wrow[x]);
          c += ssd ? e * e : abs(e);
        }
      }
    }
    const int r = rank[d];
    if (better(c, r, best_c, best_r)) {
      best_c = c;
      best_r = r;
      best_d = d;
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    const int oc = __shfl_down_sync(0xffffffffu, best_c, off);
    const int orr = __shfl_down_sync(0xffffffffu, best_r, off);
    const int od = __shfl_down_sync(0xffffffffu, best_d, off);
    if (better(oc, orr, best_c, best_r)) {
      best_c = oc;
      best_r = orr;
      best_d = od;
    }
  }
  __shared__ int s_c[kWarps], s_r[kWarps], s_d[kWarps];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    s_c[warp] = best_c;
    s_r[warp] = best_r;
    s_d[warp] = best_d;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < kWarps; ++i) {
      if (better(s_c[i], s_r[i], best_c, best_r)) {
        best_c = s_c[i];
        best_r = s_r[i];
        best_d = s_d[i];
      }
    }
    out_dy[k] = best_d / side;
    out_dx[k] = best_d % side;
  }
}

}  // namespace

// im1: (B, h, w) u8 level image; windows: (B * n_per_frame, win, win) u8
// with win = bs + 2 * ext, window k's pixel (0, 0) at frame position
// (cy[k] - ext, cx[k] - ext); cy, cx: (B * n_per_frame,) i32 window centres;
// rank: (side * side,) i32 spiral first-visit ranks in raster order;
// out_dy, out_dx: (B * n_per_frame,) i32 winning offsets in window
// coordinates (0 .. 2 * ext, centre ext).  Blocks are the frame's row-major
// nbx-wide grid of bs x bs blocks.
extern "C" int bbme_sad_spiral_argmin(const void* im1, const void* windows,
                                      const void* cy, const void* cx,
                                      const void* rank, void* out_dy,
                                      void* out_dx, int nblk, int n_per_frame,
                                      int nbx, int h, int w, int bs, int ext,
                                      int ssd, void* stream) {
  if (nblk == 0) return 0;
  const int win = bs + 2 * ext;
  const size_t smem = static_cast<size_t>(win) * win + static_cast<size_t>(bs) * bs;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sad_spiral_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sad_spiral_argmin_kernel<<<static_cast<unsigned>(nblk), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(im1), static_cast<const uint8_t*>(windows),
      static_cast<const int*>(cy), static_cast<const int*>(cx),
      static_cast<const int*>(rank), static_cast<int*>(out_dy),
      static_cast<int*>(out_dx), n_per_frame, nbx, h, w, bs, ext, ssd);
  return static_cast<int>(cudaGetLastError());
}
