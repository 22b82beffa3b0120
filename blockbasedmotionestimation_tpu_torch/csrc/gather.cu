// Per-parent frame-2 window gather.
//
// Replaces blockbasedmotionestimation_tpu/kernels/gather.py gather_windows_dma
// (kernel A).  On the TPU the data-dependent offsets could not be DMA'd
// directly, so that kernel kept 8 row-shifted copies of the frame, fetched
// 128-column superwindows and extracted the columns with a one-hot MXU
// matmul.  Hopper loads bytes at any address, so here the gather is what it
// computes: out[k, y, x] = im2p[b, by[k] + y, bx[k] + x], where im2p is the
// frame of batch entry b zero-padded by ext on every side.  The padding is
// never materialised: a source pixel outside the frame reads as 0.
//
// Bound: device-memory traffic (one byte read and one written per output
// pixel, B * nP * win^2 bytes each way, ~84 MB at the 1080p B=8 level-0 main
// window).  One thread per output pixel; neighbouring threads write
// neighbouring bytes and read neighbouring bytes of one frame row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_windows_kernel(const uint8_t* __restrict__ im2,
                                      const int* __restrict__ by,
                                      const int* __restrict__ bx,
                                      uint8_t* __restrict__ out,
                                      long long total, int n_per_frame, int h,
                                      int w, int win, int ext) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % win);
  const long long t = idx / win;
  const int y = static_cast<int>(t % win);
  const long long k = t / win;
  const long long b = k / n_per_frame;
  const int sy = by[k] + y - ext;
  const int sx = bx[k] + x - ext;
  uint8_t v = 0;
  if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
    v = im2[(b * h + sy) * w + sx];
  }
  out[idx] = v;
}

}  // namespace

// im2: (B, h, w) u8; by, bx: (B * n_per_frame,) i32 window top-left in the
// ext-padded frame; out: (B * n_per_frame, win, win) u8.
extern "C" int bbme_gather_windows(const void* im2, const void* by,
                                   const void* bx, void* out, int nblk,
                                   int n_per_frame, int h, int w, int win,
                                   int ext, void* stream) {
  const long long total = static_cast<long long>(nblk) * win * win;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  gather_windows_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(im2), static_cast<const int*>(by),
      static_cast<const int*>(bx), static_cast<uint8_t*>(out), total,
      n_per_frame, h, w, win, ext);
  return static_cast<int>(cudaGetLastError());
}
