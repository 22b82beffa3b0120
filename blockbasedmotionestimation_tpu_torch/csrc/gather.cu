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
// Bound: device-memory traffic (the frames read once, B * nP * win^2 bytes
// written, ~105 MB at the 1080p B=8 level-0 main window).  The first design
// (one thread per output byte) decoded (k, y, x) from a flat 64-bit index
// with three 64-bit divisions a byte and stored single bytes, so integer
// instructions, not bytes, bounded it (0.433 ms against a 0.031 ms bound).
// The design now:
//   - a block takes one window: k is blockIdx.x, so the frame, the window's
//     offsets and the inside test are decoded once a block, and indices
//     inside a frame are 32-bit (the wrapper checks h * w < 2^31);
//   - a thread takes a chunk of kW bytes of one window row (kW = 16, 8 or 4
//     as win allows, one 32-bit division an item for the row) and writes it
//     with one uint4 / uint2 / u32 store; a window row of win % 4 != 0 is cut
//     into 4-byte chunks stored byte by byte, its last chunk short (the
//     row's byte tail, in the same kernel);
//   - a chunk's frame bytes start at any address: the thread loads the
//     aligned 32-bit words that cover them (one more than kW / 4 when the
//     start is unaligned) and assembles each output word with
//     __funnelshift_r.  An aligned word holding a byte of the frame lies in
//     the frame's allocation, so no load leaves it;
//   - a window wholly inside the frame (a block-uniform test) takes the
//     path without bounds tests; an edge window loads only the words that
//     hold an in-frame byte of the row and masks the others' bytes to 0;
//   - neighbouring parents' windows overlap by win - bs columns and rows;
//     the loads go through the read-only path (__ldg), and L1/L2 absorb
//     the reuse (the level-0 frames, 21 MB at B=8, fit the 50 MB L2).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

// the low n bytes of a word set (n in 0..4)
__device__ __forceinline__ uint32_t low_bytes(int n) {
  return n >= 4 ? 0xffffffffu : (1u << (8 * n)) - 1u;
}

// kW bytes of a frame row starting at column sx (any alignment) as kW / 4
// words; kEdge: only words holding a column in [0, w) are loaded, and
// bytes of columns outside it are 0.  row: the row's first byte.
template <int kW, bool kEdge>
__device__ __forceinline__ void load_chunk(const uint8_t* row, int sx, int w,
                                           uint32_t (&v)[kW / 4]) {
  constexpr int kN = kW / 4;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row) + static_cast<intptr_t>(sx);
  const uint32_t s = static_cast<uint32_t>(addr & 3);
  const uint32_t* al = reinterpret_cast<const uint32_t*>(addr - s);
  uint32_t wd[kN + 1];
#pragma unroll
  for (int j = 0; j <= kN; ++j) {
    bool need = j < kN || s != 0;
    if (kEdge) {
      const int c0 = sx - static_cast<int>(s) + 4 * j;  // column of the word's first byte
      need = need && c0 + 3 >= 0 && c0 < w;
    }
    wd[j] = need ? __ldg(al + j) : 0u;
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    v[i] = __funnelshift_r(wd[i], wd[i + 1], 8 * s);
    if (kEdge) {
      const int c = sx + 4 * i;  // column of the output word's first byte
      const int lo = min(max(-c, 0), 4);
      const int hi = min(max(w - c, 0), 4);
      v[i] &= low_bytes(hi) & ~low_bytes(lo);
    }
  }
}

// kW: bytes a thread writes (16, 8 or 4); kBytes: stores byte by byte
// (win % 4 != 0, kW = 4).  cpr: chunks a window row, ceil(win / kW).
template <int kW, bool kBytes>
__global__ void __launch_bounds__(kMaxThreads) gather_windows_kernel(
    const uint8_t* __restrict__ im2, const int* __restrict__ by, const int* __restrict__ bx,
    uint8_t* __restrict__ out, int n_per_frame, int h, int w, int win, int ext, int cpr) {
  const int k = blockIdx.x;
  const uint8_t* frame = im2 + static_cast<size_t>(k / n_per_frame) * h * w;
  uint8_t* dst = out + static_cast<size_t>(k) * win * win;
  const int y0 = __ldg(by + k) - ext;  // the window's top-left in the frame
  const int x0 = __ldg(bx + k) - ext;
  // every byte any chunk loads lies in the frame (a short last chunk reads
  // up to cpr * kW - win columns past the window)
  const bool inside = y0 >= 0 && y0 + win <= h && x0 >= 0 && x0 + cpr * kW <= w;
  const int items = win * cpr;
  for (int t = threadIdx.x; t < items; t += blockDim.x) {
    const int y = t / cpr;
    const int xo = (t - y * cpr) * kW;  // the chunk's first byte in the window row
    const int sy = y0 + y;
    uint32_t v[kW / 4];
    if (inside) {
      load_chunk<kW, false>(frame + sy * w, x0 + xo, w, v);
    } else if (sy >= 0 && sy < h) {
      load_chunk<kW, true>(frame + sy * w, x0 + xo, w, v);
    } else {
#pragma unroll
      for (int i = 0; i < kW / 4; ++i) v[i] = 0u;
    }
    uint8_t* o = dst + y * win + xo;
    if constexpr (kBytes) {
      const int n = min(4, win - xo);
      for (int q = 0; q < n; ++q) o[q] = static_cast<uint8_t>(v[0] >> (8 * q));
    } else if constexpr (kW == 16) {
      *reinterpret_cast<uint4*>(o) = make_uint4(v[0], v[1], v[2], v[3]);
    } else if constexpr (kW == 8) {
      *reinterpret_cast<uint2*>(o) = make_uint2(v[0], v[1]);
    } else {
      *reinterpret_cast<uint32_t*>(o) = v[0];
    }
  }
}

template <int kW, bool kBytes>
cudaError_t launch(const void* im2, const void* by, const void* bx, void* out, int nblk,
                   int n_per_frame, int h, int w, int win, int ext, cudaStream_t stream) {
  const int cpr = (win + kW - 1) / kW;
  const int items = win * cpr;
  // the fewest passes of at most kMaxThreads, their threads in whole warps
  const int passes = (items + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((items + passes - 1) / passes + 31) / 32 * 32;
  gather_windows_kernel<kW, kBytes><<<nblk, threads, 0, stream>>>(
      static_cast<const uint8_t*>(im2), static_cast<const int*>(by),
      static_cast<const int*>(bx), static_cast<uint8_t*>(out), n_per_frame, h, w, win, ext, cpr);
  return cudaGetLastError();
}

}  // namespace

// im2: (B, h, w) u8; by, bx: (B * n_per_frame,) i32 window top-left in the
// ext-padded frame; out: (B * n_per_frame, win, win) u8, 16-byte aligned.
extern "C" int bbme_gather_windows(const void* im2, const void* by,
                                   const void* bx, void* out, int nblk,
                                   int n_per_frame, int h, int w, int win,
                                   int ext, void* stream) {
  if (nblk == 0 || win == 0) return 0;
  if (nblk < 0 || n_per_frame < 1 || win < 1 || ext < 0 ||
      static_cast<long long>(h) * w >= (1LL << 31) ||
      static_cast<long long>(win) * win >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (win % 16 == 0) {
    e = launch<16, false>(im2, by, bx, out, nblk, n_per_frame, h, w, win, ext, s);
  } else if (win % 8 == 0) {
    e = launch<8, false>(im2, by, bx, out, nblk, n_per_frame, h, w, win, ext, s);
  } else if (win % 4 == 0) {
    e = launch<4, false>(im2, by, bx, out, nblk, n_per_frame, h, w, win, ext, s);
  } else {
    e = launch<4, true>(im2, by, bx, out, nblk, n_per_frame, h, w, win, ext, s);
  }
  return static_cast<int>(e);
}
