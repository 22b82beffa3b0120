// Spiral block search: per block, the (2S+1)^2 SAD/SSD costs against its
// search window and their (cost, spiral rank) argmin.
//
// Replaces blockbasedmotionestimation_tpu/kernels/sad_search.py
// sad_spiral_argmin (kernel 7).  On the TPU that kernel put 128 blocks on
// the lanes, looped over window rows with the columns unrolled at static
// offsets, and streamed the spiral ranks from SMEM by scalar prefetch.  Here
// one thread block takes one (frame, block) pair: it stages the bs x bs
// block (read straight from the level image im1) and its win x win window
// (kernel A's output) in shared memory, and each thread scores a work item
// of one delta row dy and a run of 4 consecutive dx (dx0 = 4 * run).
//
// Out-of-frame offsets cost INT32_MAX (the walk skips them but its cursor
// advances, so they still carry a rank).  A lexicographic (cost, rank)
// update equals the walk's first-visit-wins strict <, whatever the order
// of the visits (ranks are distinct); the per-thread bests are reduced the
// same way, explicitly, by warp shuffles and then shared memory: no atomics,
// no unordered min.  The state starts at (INT32_MAX, INT32_MAX, centre), so
// a block whose offsets are all masked keeps the centre, as on the TPU.
//
// Bound: integer operations (a difference, an absolute value or square and
// an add per pixel per delta, 3 * nblk * side^2 * bs^2: 68.5 G at the 1080p
// level 0 at B=8, ~1 ms at the card's 67 T/s CUDA-core rate); its bytes
// (block, window, two int32 outputs per block) are ~0.1 GB.  The first
// design (one thread a delta, two byte loads, a subtract, an abs and an add
// a pixel) took 5.70 ms there (PERF.md).  This design does the packed work:
//   - four pixels an instruction: a window row's words at a run's dx are
//     funnel shifts (__funnelshift_r) of two aligned words, and SAD is one
//     VABSDIFF4 with accumulate (vabsdiff4.u32.u32.u32.add) a word, SSD
//     |d| by __vabsdiffu4 dotted with itself by dp4a (|d|^2 = d^2).  The
//     packed sums stay exact: at most 255^2 * 128^2 < 2^31 (bs 256's SSD
//     wraps modulo 2^32 exactly as the plain version's int32 sum does);
//   - the window words are reused across the 4 dx of a run: per block word
//     k of a row, one shared load of window word run + k + 1 (word run + k
//     carried from the step before), three funnel shifts and four packed
//     diffs, i.e. for SAD 1 + 3 + 4 plus a quarter of a 16-byte block load
//     = 8.25 instructions per 16 pixel-deltas (0.52 a pixel-delta, against
//     ~5 before), for SSD 12.25 (0.77).  The block row is read by every
//     thread at once (a broadcast), 16 bytes a load;
//   - the window sits in shared memory with an odd row pitch in words
//     where it fits, so the 32 lanes of a warp, on consecutive dy of one
//     run, read 32 different banks; 33 dy x 9 runs = 297 items at S = 16
//     take a 320-thread block;
//   - staging: the window with 16-byte global loads (win % 16 == 0, as at
//     every level of the default configuration), else 4-byte or byte
//     loads, each word stored at its padded place; the block with 16-byte
//     cp.async where its rows are 16-byte aligned (bs % 16 == 0), issued
//     first so that it lands while the window is staged, else words or
//     bytes (bs = 2 rows pad to a word with zeros, and the window words
//     are masked to the same two bytes).  cp.async does not serve the
//     window: its conflict-free odd pitch leaves its rows unaligned.
// Tensor cores compute products, not absolute differences, so they do not
// serve SAD; SSD's cross term could go to int8 mma, which is not done here.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRun = 4;                    // consecutive dx a work item scores
constexpr size_t kSmemLimit = 227 * 1024;  // kernels/sad_search.py SMEM_LIMIT
constexpr size_t kStaticSmem = 3 * kMaxWarps * sizeof(int);  // the reduction's

// (cost, rank) lexicographic: is (c, r) better than (bc, br)?
__device__ __forceinline__ bool better(int c, int r, int bc, int br) {
  return c < bc || (c == bc && r < br);
}

// the packed cost of four pixels, plus acc: SAD by VABSDIFF4 with
// accumulate, SSD by dp4a of |d| with itself
template <bool kSsd>
__device__ __forceinline__ uint32_t word_cost(uint32_t a, uint32_t v, uint32_t acc) {
  if constexpr (kSsd) {
    const uint32_t ad = __vabsdiffu4(a, v);
    return __dp4a(ad, ad, acc);
  } else {
    uint32_t d;
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(v), "r"(acc));
    return d;
  }
}

// words a block row takes (bs = 2: one, its upper two bytes zero)
__host__ __device__ constexpr int row_words(int bs) { return bs >= 4 ? bs / 4 : 1; }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t{15}; }

// Stage the window (wvec: 16, 4 or 1 bytes a global load) at pitch `pitch`
// words, and the block (bvec: 16 = cp.async, 4 or 1) at row_words(BS).
template <int BS>
__device__ __forceinline__ void stage(const uint8_t* __restrict__ wsrc,
                                      const uint8_t* __restrict__ bsrc, long long w,
                                      uint32_t* wsm, uint32_t* blk, int win, int pitch,
                                      int wvec, int bvec) {
  constexpr int NW = row_words(BS);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (bvec == 16) {  // BS % 16 == 0: rows of whole 16-byte chunks
    constexpr int kChunks = BS / 16 > 0 ? BS / 16 : 1;
    for (int q = tid; q < BS * kChunks; q += nt) {
      const int y = q / kChunks;
      const int c = q - y * kChunks;
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(blk + y * NW + 4 * c));
      const uint8_t* src = bsrc + y * w + 16 * c;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else if (bvec == 4) {
    for (int q = tid; q < BS * NW; q += nt) {
      const int y = q / NW;
      blk[q] = __ldg(reinterpret_cast<const uint32_t*>(bsrc + y * w) + (q - y * NW));
    }
  } else {
    for (int q = tid; q < BS * NW; q += nt) {
      const int y = q / NW;
      const int c = q - y * NW;
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * c + j < BS) v |= static_cast<uint32_t>(__ldg(bsrc + y * w + 4 * c + j)) << (8 * j);
      }
      blk[q] = v;
    }
  }
  if (wvec == 16) {  // win % 16 == 0, 16-byte aligned windows
    const int per_row = win / 16;
    const uint4* src = reinterpret_cast<const uint4*>(wsrc);
    for (int q = tid; q < win * per_row; q += nt) {
      const uint4 v = __ldg(src + q);
      const int y = q / per_row;
      uint32_t* d = wsm + y * pitch + 4 * (q - y * per_row);
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else if (wvec == 4) {  // win % 4 == 0
    const int per_row = win / 4;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(wsrc);
    for (int q = tid; q < win * per_row; q += nt) {
      const int y = q / per_row;
      wsm[y * pitch + q - y * per_row] = __ldg(src + q);
    }
  } else {  // win % 4 == 2: rows start mid-word
    const int per_row = (win + 3) / 4;
    for (int q = tid; q < win * per_row; q += nt) {
      const int y = q / per_row;
      const int c = q - y * per_row;
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * c + j < win) v |= static_cast<uint32_t>(__ldg(wsrc + y * win + 4 * c + j)) << (8 * j);
      }
      wsm[y * pitch + c] = v;
    }
  }
  if (bvec == 16) asm volatile("cp.async.wait_all;\n" ::);
}

template <int BS, bool kSsd>
__global__ void __launch_bounds__(kMaxThreads, 2)
sad_spiral_argmin_kernel(const uint8_t* __restrict__ im1,
                         const uint8_t* __restrict__ windows,
                         const int* __restrict__ cy, const int* __restrict__ cx,
                         const int* __restrict__ rank, int* __restrict__ out_dy,
                         int* __restrict__ out_dx, int n_per_frame, int nbx,
                         int h, int w, int full_h, int ext, int pitch, int wvec,
                         int bvec) {
  constexpr int NW = row_words(BS);
  // bs = 2: two bytes of a word are pixels; the window words are cut to them
  constexpr uint32_t kMask = BS >= 4 ? 0xffffffffu : 0x0000ffffu;
  extern __shared__ __align__(16) uint32_t smem[];
  const int win = BS + 2 * ext;
  const int side = 2 * ext + 1;
  const int nruns = (side + kRun - 1) / kRun;
  uint32_t* wsm = smem;                                               // win x pitch
  uint32_t* blk = smem + align16(static_cast<size_t>(win) * pitch * 4) / 4;  // BS x NW

  const long long k = blockIdx.x;  // global block index, frame-major
  const long long b = k / n_per_frame;
  const int p = static_cast<int>(k % n_per_frame);
  const int oy = (p / nbx) * BS;
  const int ox = (p % nbx) * BS;
  const int tid = threadIdx.x;
  stage<BS>(windows + k * win * win, im1 + (b * h + oy) * static_cast<long long>(w) + ox, w,
            wsm, blk, win, pitch, wvec, bvec);
  __syncthreads();

  const int ccy = cy[k];
  const int ccx = cx[k];
  int best_c = INT_MAX, best_r = INT_MAX, best_d = ext * side + ext;
  for (int item = tid; item < side * nruns; item += blockDim.x) {
    const int dy = item % side;  // consecutive lanes: consecutive dy, one run
    const int dx0 = kRun * (item / side);
    const int ty = ccy + dy - ext;
    const int tx0 = ccx + dx0 - ext;
    const bool row_ok = ty >= 0 && ty <= full_h - BS;  // the frame's rows, not the strip's
    // the run's dx that are deltas of the window and keep the block in frame
    uint32_t ok = 0;
#pragma unroll
    for (int s = 0; s < kRun; ++s) {
      const int tx = tx0 + s;
      if (row_ok && dx0 + s < side && tx >= 0 && tx <= w - BS) ok |= 1u << s;
    }
    uint32_t acc[kRun] = {0u, 0u, 0u, 0u};
    if (ok) {
      const uint32_t* wr = wsm + dy * pitch + dx0 / kRun;
#pragma unroll 2
      for (int y = 0; y < BS; ++y, wr += pitch) {
        const uint32_t* br = blk + y * NW;
        uint32_t w0 = wr[0];
#pragma unroll
        for (int q = 0; q < NW; q += 4) {
          uint32_t bw[4];
          if constexpr (NW >= 4) {
            const uint4 v = *reinterpret_cast<const uint4*>(br + q);
            bw[0] = v.x;
            bw[1] = v.y;
            bw[2] = v.z;
            bw[3] = v.w;
          } else {
#pragma unroll
            for (int j = 0; j < NW; ++j) bw[j] = br[j];
          }
#pragma unroll
          for (int j = 0; j < (NW < 4 ? NW : 4); ++j) {
            const uint32_t w1 = wr[q + j + 1];
            acc[0] = word_cost<kSsd>(bw[j], w0 & kMask, acc[0]);
            acc[1] = word_cost<kSsd>(bw[j], __funnelshift_r(w0, w1, 8) & kMask, acc[1]);
            acc[2] = word_cost<kSsd>(bw[j], __funnelshift_r(w0, w1, 16) & kMask, acc[2]);
            acc[3] = word_cost<kSsd>(bw[j], __funnelshift_r(w0, w1, 24) & kMask, acc[3]);
            w0 = w1;
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kRun; ++s) {
      const int dx = dx0 + s;
      if (dx >= side) break;
      const int d = dy * side + dx;
      const int c = (ok >> s) & 1 ? static_cast<int>(acc[s]) : INT_MAX;
      const int r = __ldg(rank + d);
      if (better(c, r, best_c, best_r)) {
        best_c = c;
        best_r = r;
        best_d = d;
      }
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
  __shared__ int s_c[kMaxWarps], s_r[kMaxWarps], s_d[kMaxWarps];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    s_c[warp] = best_c;
    s_r[warp] = best_r;
    s_d[warp] = best_d;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) {
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

// Shared bytes of a launch at window row pitch `pitch` words: the window,
// then the block at a 16-byte boundary.
size_t smem_of(int bs, int win, int pitch) {
  return align16(static_cast<size_t>(win) * pitch * 4) +
         static_cast<size_t>(bs) * row_words(bs) * 4;
}

template <int BS, bool kSsd>
int launch(const uint8_t* im1, const uint8_t* windows, const int* cy, const int* cx,
           const int* rank, int* out_dy, int* out_dx, int nblk, int n_per_frame, int nbx,
           int h, int w, int full_h, int ext, cudaStream_t stream) {
  const int win = BS + 2 * ext;
  const int side = 2 * ext + 1;
  // the narrowest pitch that holds a row, made odd (conflict-free) if that fits
  int pitch = (win + 3) / 4;
  if (pitch % 2 == 0 && smem_of(BS, win, pitch + 1) + kStaticSmem <= kSmemLimit) ++pitch;
  const size_t smem = smem_of(BS, win, pitch);
  if (smem + kStaticSmem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sad_spiral_argmin_kernel<BS, kSsd>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const uintptr_t wp = reinterpret_cast<uintptr_t>(windows);
  const uintptr_t ip = reinterpret_cast<uintptr_t>(im1);
  const int wvec = win % 16 == 0 && wp % 16 == 0 ? 16 : win % 4 == 0 && wp % 4 == 0 ? 4 : 1;
  const int bvec = BS % 16 == 0 && w % 16 == 0 && ip % 16 == 0  ? 16
                   : BS % 4 == 0 && w % 4 == 0 && ip % 4 == 0 ? 4
                                                               : 1;
  const int items = side * ((side + kRun - 1) / kRun);
  const int threads = items >= kMaxThreads ? kMaxThreads : (items + 31) / 32 * 32;
  kernel<<<static_cast<unsigned>(nblk), threads, smem, stream>>>(
      im1, windows, cy, cx, rank, out_dy, out_dx, n_per_frame, nbx, h, w, full_h, ext, pitch,
      wvec, bvec);
  return static_cast<int>(cudaGetLastError());
}

template <int BS>
int launch_cost(int ssd, const uint8_t* im1, const uint8_t* windows, const int* cy,
                const int* cx, const int* rank, int* out_dy, int* out_dx, int nblk,
                int n_per_frame, int nbx, int h, int w, int full_h, int ext,
                cudaStream_t stream) {
  return ssd ? launch<BS, true>(im1, windows, cy, cx, rank, out_dy, out_dx, nblk, n_per_frame,
                                nbx, h, w, full_h, ext, stream)
             : launch<BS, false>(im1, windows, cy, cx, rank, out_dy, out_dx, nblk, n_per_frame,
                                 nbx, h, w, full_h, ext, stream);
}

}  // namespace

// im1: (B, h, w) u8 level image; windows: (B * n_per_frame, win, win) u8
// with win = bs + 2 * ext, window k's pixel (0, 0) at frame position
// (cy[k] - ext, cx[k] - ext); cy, cx: (B * n_per_frame,) i32 window centres;
// rank: (side * side,) i32 spiral first-visit ranks in raster order;
// out_dy, out_dx: (B * n_per_frame,) i32 winning offsets in window
// coordinates (0 .. 2 * ext, centre ext).  Blocks are the frame's row-major
// nbx-wide grid of bs x bs blocks; bs is a power of two, 2 .. 256 (any
// other returns cudaErrorInvalidValue, as does a window over the shared
// memory of a thread block).  im1 may be a row strip of its frame (the
// tiled engine): the centres are then the frame's rows, and an offset keeps
// its block in the frame by the frame's height full_h (h for whole frames).
extern "C" int bbme_sad_spiral_argmin(const void* im1, const void* windows,
                                      const void* cy, const void* cx,
                                      const void* rank, void* out_dy,
                                      void* out_dx, int nblk, int n_per_frame,
                                      int nbx, int h, int w, int full_h, int bs,
                                      int ext, int ssd, void* stream) {
  if (nblk == 0) return 0;
  if (ext < 0 || full_h < h) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const uint8_t*>(im1);
  const auto* wn = static_cast<const uint8_t*>(windows);
  const auto* y = static_cast<const int*>(cy);
  const auto* x = static_cast<const int*>(cx);
  const auto* rk = static_cast<const int*>(rank);
  auto* ody = static_cast<int*>(out_dy);
  auto* odx = static_cast<int*>(out_dx);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 2: return launch_cost<2>(ssd, a, wn, y, x, rk, ody, odx, nblk, n_per_frame, nbx, h, w, full_h, ext, st);
    case 4: return launch_cost<4>(ssd, a, wn, y, x, rk, ody, odx, nblk, n_per_frame, nbx, h, w, full_h, ext, st);
    case 8: return launch_cost<8>(ssd, a, wn, y, x, rk, ody, odx, nblk, n_per_frame, nbx, h, w, full_h, ext, st);
    case 16: return launch_cost<16>(ssd, a, wn, y, x, rk, ody, odx, nblk, n_per_frame, nbx, h, w, full_h, ext, st);
    case 32: return launch_cost<32>(ssd, a, wn, y, x, rk, ody, odx, nblk, n_per_frame, nbx, h, w, full_h, ext, st);
    case 64: return launch_cost<64>(ssd, a, wn, y, x, rk, ody, odx, nblk, n_per_frame, nbx, h, w, full_h, ext, st);
    case 128: return launch_cost<128>(ssd, a, wn, y, x, rk, ody, odx, nblk, n_per_frame, nbx, h, w, full_h, ext, st);
    case 256: return launch_cost<256>(ssd, a, wn, y, x, rk, ody, odx, nblk, n_per_frame, nbx, h, w, full_h, ext, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
