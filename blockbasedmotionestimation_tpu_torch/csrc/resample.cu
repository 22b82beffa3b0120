// OpenCV-exact 8-bit resampling: the driver's cv::resize(INTER_LINEAR)
// upscale and cv::pyrDown, a launch a frame stack (upscale) or a pyramid
// level (pyrDown).
//
// Replaces no TPU kernel: the JAX package runs both as XLA integer ops
// (blockbasedmotionestimation_tpu/ops/resample.py), and the port's plain
// versions (kernels/resample.py) run them as chains of int32 torch ops,
// each pass reading and writing a full-size int32 tensor (about 13 passes
// over the upscale's output, about 25 a pyramid level).
//
// Bound: device-memory traffic.  Each kernel reads its u8 input and writes
// its u8 output once; every int32 intermediate stays in registers.  At the
// full-HD 4x driver a batch of 8 frames writes 265 MB of upscale and reads
// those 265 MB back for the pyramid's first level.
//
// resize_linear_kernel: a thread makes kCols = 16 consecutive output
// bytes of kResizeRows = 16 consecutive output rows.  The row and column
// tables are the ones the plain version reads (OpenCV's float32 source
// coordinates, cvRound coefficients; computed once on the host and kept on
// the device), so the tables, not the kernel's arithmetic, carry the
// exactness.  The horizontal taps of a source row, src[xs0] * xa0 +
// src[xs1] * xa1 in int32 (kept >> 4, the only way the vertical step reads
// them), are computed once for the output rows that read that row (at
// factor 4, four rows): a thread keeps the taps of its current row pair and
// moves them down when the next output row starts one source row lower.
// The row loop is unrolled and its table entries loaded up front, so the
// loads of a row overlap the arithmetic of the one before.  The threads of
// a warp take neighbouring column chunks of the same rows, so that test is
// uniform across the warp and a warp's stores of a row cover 512
// contiguous bytes.  The source frame (2 MB at 1080p) is read through L1 /
// L2.  On an H100 at 1080p B=8 x4, 16 rows a thread took 0.42 ms, 8 rows
// 0.57 and 32 rows 0.60.
//
// pyrdown_kernel: a thread makes kOut = 8 consecutive output bytes of
// kPyrRows = 8 output rows.  An input row's 19 bytes (output columns
// x0..x0+7 read input columns 2*x0-2 .. 2*x0+16) come in as one aligned
// 16-byte load and two 4-byte loads where the row allows it, or byte by
// byte with reflect-101 at the frame's left and right edges.  Both passes
// run on two outputs a 32-bit word, in 16-bit lanes (output j and j + 4):
// a lane holds at most 16 * 255 after the horizontal pass and 256 * 255 +
// 128 before the rounding, so no lane carries into the next.  Rows move
// down two input rows an output row: the three horizontally filtered rows
// an output row shares with the next stay in registers, so each input row
// is filtered once a thread.  Reflect-101 on rows is index arithmetic; the
// (acc + 128) >> 8 rounding is the only one, as in cv::pyrDown.  On an
// H100 at the full-HD level 0 (B=8) the lanes took 0.19 ms against 0.22 for
// one output a word.
//
// Frame offsets are 64-bit; indices inside a frame are 32-bit (the entry
// points refuse frames of 2^31 pixels or more).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;    // threads of a block along the column chunks
constexpr int kGroups = 4;   // row groups of a block
constexpr int kResizeRows = 16;  // output rows a resize thread
constexpr int kCols = 16;        // output bytes a resize thread, a row
constexpr int kPyrRows = 8;      // output rows a pyrDown thread
constexpr int kOut = 8;          // output bytes a pyrDown thread, a row
constexpr int kIn = 2 * kOut + 3;  // input bytes they read, a row

// block b of a grid over (row group g, chunk c): blockIdx.x = gb * n_cb + cb
struct Tile {
  int chunk;
  long long group;
};

__device__ __forceinline__ Tile tile_of(int n_cb) {
  const int cb = blockIdx.x % n_cb;
  const long long gb = blockIdx.x / n_cb;
  return {cb * kWarp + static_cast<int>(threadIdx.x),
          gb * kGroups + static_cast<long long>(threadIdx.y)};
}

// ---- cv::resize(INTER_LINEAR), 8u ----

// kVec: dst_w % 16 == 0 and out 16-byte aligned, one 16-byte store a row
template <bool kVec>
__global__ void __launch_bounds__(kWarp* kGroups) resize_linear_kernel(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ out,
    const int64_t* __restrict__ ys0, const int64_t* __restrict__ ys1,
    const int32_t* __restrict__ yb0, const int32_t* __restrict__ yb1,
    const int64_t* __restrict__ xs0, const int64_t* __restrict__ xs1,
    const int32_t* __restrict__ xa0, const int32_t* __restrict__ xa1,
    long long n_groups, int row_groups, int n_cb, int src_h, int src_w, int dst_h, int dst_w) {
  const Tile t = tile_of(n_cb);
  const int x0 = t.chunk * kCols;
  if (x0 >= dst_w || t.group >= n_groups) return;
  const long long frame = t.group / row_groups;
  const int y0 = static_cast<int>(t.group - frame * row_groups) * kResizeRows;
  const uint8_t* fsrc = src + frame * src_h * static_cast<long long>(src_w);
  uint8_t* fout = out + frame * dst_h * static_cast<long long>(dst_w);
  const int nx = min(kCols, dst_w - x0);

  int q0[kResizeRows], q1[kResizeRows], b0[kResizeRows], b1[kResizeRows];
#pragma unroll
  for (int i = 0; i < kResizeRows; ++i) {
    const int y = min(y0 + i, dst_h - 1);
    q0[i] = static_cast<int>(__ldg(ys0 + y));
    q1[i] = static_cast<int>(__ldg(ys1 + y));
    b0[i] = __ldg(yb0 + y);
    b1[i] = __ldg(yb1 + y);
  }
  int c0[kCols], c1[kCols], a0[kCols], a1[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int x = x0 + min(j, nx - 1);  // columns past the frame repeat its last
    c0[j] = static_cast<int>(__ldg(xs0 + x));
    c1[j] = static_cast<int>(__ldg(xs1 + x));
    a0[j] = __ldg(xa0 + x);
    a1[j] = __ldg(xa1 + x);
  }
  // the horizontal taps of source row r, >> 4
  auto taps = [&](int r, int (&s)[kCols]) {
    const uint8_t* p = fsrc + r * static_cast<long long>(src_w);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[j] = (static_cast<int>(__ldg(p + c0[j])) * a0[j] +
              static_cast<int>(__ldg(p + c1[j])) * a1[j]) >> 4;
    }
  };
  int s0[kCols], s1[kCols];
  int r0 = -1, r1 = -1;  // the source rows whose taps s0, s1 hold
#pragma unroll
  for (int i = 0; i < kResizeRows; ++i) {
    const int y = y0 + i;
    if (y >= dst_h) break;
    if (q0[i] != r0) {
      if (q0[i] == r1) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) s0[j] = s1[j];
      } else {
        taps(q0[i], s0);
      }
    }
    if (q1[i] != r1) {
      if (q1[i] == q0[i]) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) s1[j] = s0[j];
      } else {
        taps(q1[i], s1);
      }
    }
    r0 = q0[i];
    r1 = q1[i];
    // OpenCV VResizeLinear<uchar>:
    //   uchar((((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2)
    // every term is non-negative, so only the upper bound clamps
    uint32_t w[kCols / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int v = min((((b0[i] * s0[j]) >> 16) + ((b1[i] * s1[j]) >> 16) + 2) >> 2, 255);
      w[j / 4] |= static_cast<uint32_t>(v) << (8 * (j % 4));
    }
    uint8_t* o = fout + y * static_cast<long long>(dst_w) + x0;
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int j = 0; j < nx; ++j) o[j] = static_cast<uint8_t>(w[j / 4] >> (8 * (j % 4)));
    }
  }
}

// ---- cv::pyrDown, 8u ----

// BORDER_REFLECT_101 of p into [0, n), n >= 2 (gfedcb|abcdefgh|gfedcba)
__device__ __forceinline__ int reflect101(int p, int n) {
  const int m = 2 * n - 2;
  p %= m;
  if (p < 0) p += m;
  return p < n ? p : m - p;
}

// the input bytes of one row for output columns x0..x0+kOut-1: byte k of
// wd is column 2*x0 - 4 + k (k = 2..20 hold the 19 the outputs read).
// inside: the row is 16-byte aligned and the columns lie in it (no
// reflection)
__device__ __forceinline__ void pyr_load(const uint8_t* __restrict__ row, int x0, int w,
                                         bool inside, uint32_t (&wd)[6]) {
  if (inside) {
    const int c = 2 * x0;  // a multiple of 16
    wd[0] = __ldg(reinterpret_cast<const uint32_t*>(row + c - 4));
    const uint4 mid = __ldg(reinterpret_cast<const uint4*>(row + c));
    wd[1] = mid.x;
    wd[2] = mid.y;
    wd[3] = mid.z;
    wd[4] = mid.w;
    wd[5] = __ldg(reinterpret_cast<const uint32_t*>(row + c + 16));
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) wd[k] = 0u;
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
      const int k = i + 2;
      wd[k / 4] |= static_cast<uint32_t>(__ldg(row + reflect101(2 * x0 - 2 + i, w)))
                   << (8 * (k % 4));
    }
  }
}

// the horizontal 1-4-6-4-1 pass of one row: lane 0 of h[p] is output
// column x0 + p, lane 1 column x0 + p + 4.  With b[i] the byte of column
// 2*x0 - 2 + i, P[k] holds b[k] and b[k + 8] in its lanes, and
// h[p] = P[2p] + 4 P[2p+1] + 6 P[2p+2] + 4 P[2p+3] + P[2p+4]
__device__ __forceinline__ void pyr_hpass(const uint32_t (&wd)[6], uint32_t (&h)[4]) {
  uint32_t P[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) {
    const int m = k + 2;  // b[k] is byte m of wd, b[k + 8] byte m + 8
    const int s = m % 4;
    P[k] = __byte_perm(wd[m / 4], wd[m / 4 + 2], s | (s << 4) | ((4 + s) << 8) | ((4 + s) << 12)) &
           0x00ff00ffu;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    h[p] = P[2 * p] + P[2 * p + 4] + 4u * (P[2 * p + 1] + P[2 * p + 3]) + 6u * P[2 * p + 2];
  }
}

// kVec: w % 16 == 0 and src 16-byte aligned (so rows are; out rows then
// start at multiples of 8)
template <bool kVec>
__global__ void __launch_bounds__(kWarp* kGroups) pyrdown_kernel(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ out, long long n_groups,
    int row_groups, int n_cb, int h, int w) {
  const Tile t = tile_of(n_cb);
  const int ho = h / 2, wo = w / 2;
  const int x0 = t.chunk * kOut;
  if (x0 >= wo || t.group >= n_groups) return;
  const long long frame = t.group / row_groups;
  const int y0 = static_cast<int>(t.group - frame * row_groups) * kPyrRows;
  const int y1 = min(y0 + kPyrRows, ho);
  const uint8_t* fsrc = src + frame * h * static_cast<long long>(w);
  uint8_t* fout = out + frame * ho * static_cast<long long>(wo);
  // a chunk whose 19 input columns lie inside the row
  const bool inside = kVec && x0 > 0 && 2 * x0 + 20 <= w;
  const int nx = min(kOut, wo - x0);

  auto filt = [&](int r, uint32_t (&hr)[4]) {
    uint32_t wd[6];
    pyr_load(fsrc + reflect101(r, h) * static_cast<long long>(w), x0, w, inside, wd);
    pyr_hpass(wd, hr);
  };
  // rows 2y-2, 2y-1, 2y of output row y
  uint32_t ha[4], hb[4], hc[4], hd[4], he[4];
  filt(2 * y0 - 2, ha);
  filt(2 * y0 - 1, hb);
  filt(2 * y0, hc);
  for (int y = y0; y < y1; ++y) {
    filt(2 * y + 1, hd);
    filt(2 * y + 2, he);
    uint32_t acc[4];  // output p in byte 0, output p + 4 in byte 2
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      acc[p] = ((ha[p] + he[p] + 4u * (hb[p] + hd[p]) + 6u * hc[p] + 0x00800080u) >> 8) &
               0x00ff00ffu;
      ha[p] = hc[p];
      hb[p] = hd[p];
      hc[p] = he[p];
    }
    const uint32_t lo01 = __byte_perm(acc[0], acc[1], 0x6240);  // outputs 0, 1, 4, 5
    const uint32_t lo23 = __byte_perm(acc[2], acc[3], 0x6240);  // outputs 2, 3, 6, 7
    const uint32_t v[2] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632)};
    uint8_t* o = fout + y * static_cast<long long>(wo) + x0;
    if (kVec) {
      *reinterpret_cast<uint2*>(o) = make_uint2(v[0], v[1]);
    } else {
      for (int j = 0; j < nx; ++j) o[j] = static_cast<uint8_t>(v[j / 4] >> (8 * (j % 4)));
    }
  }
}

// grid of (row groups, chunks): blocks, and chunk blocks a row group block
bool grid_of(long long n_groups, int chunks, int& n_cb, int& blocks) {
  n_cb = (chunks + kWarp - 1) / kWarp;
  const long long n = (n_groups + kGroups - 1) / kGroups * n_cb;
  if (n >= (1LL << 31)) return false;
  blocks = static_cast<int>(n);
  return true;
}

}  // namespace

// src: (n, src_h, src_w) u8; out: (n, dst_h, dst_w) u8; ys0, ys1, xs0, xs1:
// (dst_h,) / (dst_w,) int64 source rows and columns; yb0, yb1, xa0, xa1:
// int32 coefficients (kernels/resample.py builds them)
extern "C" int bbme_resize_linear(const void* src, void* out, const void* ys0, const void* ys1,
                                  const void* yb0, const void* yb1, const void* xs0,
                                  const void* xs1, const void* xa0, const void* xa1, int n,
                                  int src_h, int src_w, int dst_h, int dst_w, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || src_h < 1 || src_w < 1 || dst_h < 1 || dst_w < 1 ||
      static_cast<long long>(src_h) * src_w >= (1LL << 31) ||
      static_cast<long long>(dst_h) * dst_w >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_groups = (dst_h + kResizeRows - 1) / kResizeRows;
  const long long n_groups = static_cast<long long>(n) * row_groups;
  int n_cb, blocks;
  if (!grid_of(n_groups, (dst_w + kCols - 1) / kCols, n_cb, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = dst_w % kCols == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 threads(kWarp, kGroups);
  auto s = static_cast<cudaStream_t>(stream);
  auto launch = vec ? resize_linear_kernel<true> : resize_linear_kernel<false>;
  launch<<<blocks, threads, 0, s>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out),
      static_cast<const int64_t*>(ys0), static_cast<const int64_t*>(ys1),
      static_cast<const int32_t*>(yb0), static_cast<const int32_t*>(yb1),
      static_cast<const int64_t*>(xs0), static_cast<const int64_t*>(xs1),
      static_cast<const int32_t*>(xa0), static_cast<const int32_t*>(xa1), n_groups, row_groups,
      n_cb, src_h, src_w, dst_h, dst_w);
  return static_cast<int>(cudaGetLastError());
}

// src: (n, h, w) u8, h and w even; out: (n, h / 2, w / 2) u8
extern "C" int bbme_pyrdown(const void* src, void* out, int n, int h, int w, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || h < 2 || w < 2 || h % 2 || w % 2 ||
      static_cast<long long>(h) * w >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_groups = (h / 2 + kPyrRows - 1) / kPyrRows;
  const long long n_groups = static_cast<long long>(n) * row_groups;
  int n_cb, blocks;
  if (!grid_of(n_groups, (w / 2 + kOut - 1) / kOut, n_cb, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = w % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const dim3 threads(kWarp, kGroups);
  auto s = static_cast<cudaStream_t>(stream);
  auto launch = vec ? pyrdown_kernel<true> : pyrdown_kernel<false>;
  launch<<<blocks, threads, 0, s>>>(static_cast<const uint8_t*>(src),
                                    static_cast<uint8_t*>(out), n_groups, row_groups, n_cb, h, w);
  return static_cast<int>(cudaGetLastError());
}
