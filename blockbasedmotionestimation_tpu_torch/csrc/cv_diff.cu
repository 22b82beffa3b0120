// Pooled cost volumes at every sub-block size, in one pass.
//
// Replaces blockbasedmotionestimation_tpu/kernels/cv_diff.py delta_pooled_cvs
// (kernel B) and its "planes"/"reshape" variants: one kernel, generic over bs.
// For parent block P of frame 1 and every delta (dy, dx) in [-r, r]^2 it
// computes |P - W[r+dy.., r+dx..]| (or the square) against the parent's
// frame-2 window W, sums it over 2x2 cells (cur = 2), and pools 2x2 cells up
// to cur = bs.  Output for size cur is the reference's _compute_cv layout with
// a leading batch dim: cv[b, dy*side + dx, py*f + sy, px*f + sx], f = bs/cur.
// Sizes whose worst-case cost fits stay 16-bit (is16_mask), the rest int32.
//
// One thread block per (parent, dy): the parent block and the bs window rows
// that row of deltas reads sit in shared memory; the cur=2 sums of all dx go
// to shared memory, and each coarser size is pooled from the previous one in
// shared memory (ping-pong buffers), so every diff is computed once.
//
// Bound: device-memory writes.  At the 1080p level-0 main window the volumes
// are ~1.9 GB per frame (cur=2 alone 1089 deltas x 640 x 1024 cells x 2 B);
// the diffs are ~1.1 G integer ops per frame.  Each warp writes its cells in
// runs of consecutive sx, so the cur=2 stores are 32-byte runs.
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
                                  CvOuts outs, int ncur, int is16_mask, int h,
                                  int w, int bs, int side, int ssd,
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
  // cur = 2: cell sums straight from the pixels
  {
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
      const size_t o = (b * ndelta + static_cast<size_t>(dyi) * side + dxi) * plane +
                       static_cast<size_t>(py * f + sy) * ncol + px * f + sx;
      store_cost(outs.p[0], is16_mask & 1, o, s);
    }
  }
  // cur = 4 .. bs: 2x2 pooling of the previous size, in shared memory
  int* src = buf0;
  int* dst = buf1;
  for (int lvl = 1; lvl < ncur; ++lvl) {
    __syncthreads();
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
      const size_t o = (b * ndelta + static_cast<size_t>(dyi) * side + dxi) * plane +
                       static_cast<size_t>(py * f + sy) * ncol + px * f + sx;
      store_cost(outs.p[lvl], (is16_mask >> lvl) & 1, o, s);
    }
    int* tmp = src;
    src = dst;
    dst = tmp;
  }
}

}  // namespace

// im1: (B, h, w) u8 frame-1 level image (parents are its bs x bs blocks);
// windows: (B * nP, bs + 2r, bs + 2r) u8; side = 2r + 1.
// outs[i]: volume of cur = 2 << i, (B, side^2, npy * f, npx * f), 16-bit
// where bit i of is16_mask is set, else int32.
extern "C" int bbme_pooled_cvs(const void* im1, const void* windows,
                               void* const* outs, int ncur, int is16_mask,
                               int batch, int h, int w, int bs, int side,
                               int ssd, void* stream) {
  if (ncur < 1 || ncur > kMaxCurs) return static_cast<int>(cudaErrorInvalidValue);
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
      ncur, is16_mask, h, w, bs, side, ssd, buf1_len);
  return static_cast<int>(cudaGetLastError());
}
