// Pooled cost volumes at the sub-block sizes, in one pass.
//
// Replaces blockbasedmotionestimation_tpu/kernels/cv_diff.py delta_pooled_cvs
// (kernel B: its static diff + deeper-size calls and its "planes"/"reshape"
// variant), deep_pooled_cvs (kernel C) and full_block_volume (kernel 13, the
// cur = bs volume alone): one kernel, templated on bs.  For parent block P
// of frame 1 and every delta (dy, dx) in [-r, r]^2 it computes |P - W[r+dy..,
// r+dx..]| (or the square) against the parent's frame-2 window W, sums it
// over 2x2 cells (cur = 2), and pools 2x2 cells up to cur = bs.  Output for
// size cur is the reference's _compute_cv layout with a leading batch dim:
// cv[b, dy*side + dx, py*f + sy, px*f + sx], f = bs/cur; uint16 where the
// worst-case cost fits (sad at cur <= 16), else int32.
//
// What is written is narrowed two ways, with the same diffs and pooling:
//   - emit_mask: bit i set writes size 2 << i (kernel C writes cur > fuse_max
//     and cur = bs, kernel 13 cur = bs);
//   - store_r >= 0: the cur=2 volume keeps only dx in [-store_r, store_r]
//     with every dy row, index dy*side_st + (dx - r + store_r) (the stored
//     band the cur=2 colour step reads; the rest it recomputes).
//
// What bounds it.  B on the main path (store_r = 4) writes ~7 GB at the
// 1080p level 0, B=8 (every delta at cur 4..32, the band at cur 2): 2.11 ms
// of device-memory writes at full rate; but a parent adds only a 16/8/4/4-
// byte run to each volume row at cur 4/8/16/32, so how the writes are laid
// out, not their count, sets its time.  C and 13 write little (cur >= 8 or
// cur = bs only); their ~13-23 G pixel diffs per launch bound them.  The
// previous design (one block per (parent, dy), byte-wise diffs with runtime
// divisions, a shared-memory pass per pooled size) ran B at 31.75 ms and C
// at 17.09 ms on the H100 (PERF.md): its diff pass, not its writes, bound it.
//
// The design:
//   - one thread block per pp neighbouring parents of a row and group of dy
//     rows.  A block of pp parents writes each volume row in runs pp times
//     as long: the wrapper takes pp = 4 for the calls that write cur 2 or 4
//     and pp = 2 for the others (the times at each pp: PERF.md).  At the
//     1080p levels 0-1 a group is every dy row, so each window is read from
//     device memory once (16-byte loads of its 16-aligned cover); below that
//     the wrapper splits the rows so the grid fills the card
//     (cv_diff.volume_geometry);
//   - bs is a template parameter: cell indices are shifts, the pooling
//     levels unroll, every output pointer index is a constant;
//   - shared memory holds inputs only: the patches, the window rows, and the
//     rows' four byte-shifted word copies (word m of copy s = bytes 4m+s ..
//     4m+s+3), even rows before odd rows at a pitch of 16 * odd bytes, so a
//     thread's 16-byte row loads do not conflict across its quarter-warp;
//   - a thread owns one (parent, dy, cur=2 row sy) and NDX deltas dx = k + 4i
//     of one residue k, so one shifted copy serves all of them: window word
//     m meets patch word j at dx = k + 4(m - j).  The patch's two rows sit in
//     registers for the whole block;
//   - four pixels per instruction: when cur = 2 is not written (C, 13) one
//     vabsdiff4 with accumulate (VABSDIFF4.U8.ACC) sums a word's four |d|
//     into the cur=4 half-cell: 1 instruction per 4 diffs; for B the byte
//     |d| (VABSDIFF4.U8) goes to the two cur=2 cells with two dp4a (3 per 4
//     diffs); ssd squares the byte |d| with dp4a (d^2 = |d|^2);
//   - pooling in registers: the 2x2 sum of a size is a pair sum in the
//     thread plus __shfl_xor across the neighbouring sy lanes, two cells a
//     word while they fit 16 bits; no shared buffer and no barrier after the
//     inputs are staged, but at bs = 128: its 64 sy lanes span two warps, so
//     a thread takes one delta and the cur = 128 cell is pooled through 16
//     bytes of shared memory, between two barriers;
//   - stores: each lane writes its row run of cells as 16/8/4-byte vectors
//     (the cur=2 row of a bs=32 parent is 32 bytes); offsets are 64-bit (the
//     B=8 dense cur=2 volume has 5.7 G entries).
//
// ptxas (sm_90a, CUDA 12.9): every instance has 0 bytes of stack and no
// spills; bs 32 uses 128 registers for B's loop (cur 2 written), 79 for C's
// and 13's, 87 for ssd.  The bs-32 loop of C and 13 holds 64 VABSDIFF4 among
// 748 instructions, B's 64 VABSDIFF4 and 156 IDP among 1100 (PERF.md).
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
constexpr int kMaxThreads = 256;

struct CvOuts {
  void* p[kMaxCurs];
};

// ------------------------------------------------------------ pooled volumes

constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v / 2); }

// mode of the diff loop: cur=2 cells with sad, cur=4 half-cells with sad
// (cur = 2 not written), cur=2 cells with ssd
enum { kSad2 = 0, kSad4 = 1, kSsd = 2 };

// The compile-time shape of one bs; kernels/cv_diff.py volume_geometry
// mirrors kNdx, kVec and the shared-memory layout (VolumeLayout below).
template <int BS>
struct Shape {
  static constexpr int kF2 = BS / 2;                      // cur=2 cells per row
  static constexpr int kNW = BS >= 4 ? BS / 4 : 1;        // patch words per row
  static constexpr int kNdx = BS >= 128 ? 1 : BS >= 64 ? 2 : 4;  // deltas per thread
  static constexpr int kVec = kNdx % 4 == 0 ? 4 : kNdx % 2 == 0 ? 2 : 1;  // words per row load
  static constexpr int kNLoad = (kNdx + kNW - 1 + kVec - 1) / kVec * kVec;
  static constexpr int kLevels = log2i(BS);               // cur = 2 .. BS
  static constexpr int kPatchPitch = BS >= 4 ? BS : 4;    // bytes
  static constexpr int kPatchBytes = (BS * kPatchPitch + 15) / 16 * 16;
};

// Shared memory of one block of pp parents: the pp patches, then their
// four shifted copies ([pp][4][rows][wpr] words, rows = dyg + bs - 1), then
// their raw window rows (raw_bytes each); at bs >= 128 (a cur=2 column of 64
// lanes, two warps) 16 bytes through which the warps pool the cur = bs cell.
struct VolumeLayout {
  int rows, wpr, raw_bytes, copies_off, raw_off, xchg_off, bytes;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int BS>
__host__ __device__ inline VolumeLayout volume_layout(int side, int dyg, int pp) {
  using S = Shape<BS>;
  VolumeLayout l;
  const int wc = side - 1 + BS;
  const int cnt_max = ((side + 3) / 4 + S::kNdx - 1) / S::kNdx;  // residue 0 has most
  l.rows = dyg + BS - 1;
  l.wpr = round_up((cnt_max - 1) * S::kNdx + S::kNLoad, 4);
  if ((l.wpr / 4) % 2 == 0) l.wpr += 4;  // pitch 16 * odd bytes
  l.raw_bytes = round_up(l.rows * wc + 4 * l.wpr + 32, 16);
  l.copies_off = pp * S::kPatchBytes;
  l.raw_off = l.copies_off + pp * 4 * l.rows * l.wpr * 4;
  l.xchg_off = l.raw_off + pp * l.raw_bytes;
  l.bytes = l.xchg_off + (S::kF2 > 32 ? 16 : 0);
  return l;
}

// sum of |a - b| over the four bytes, plus c: VABSDIFF4.U8.ACC, one
// instruction (its byte-masked forms, .b10 / .b32, compile to a byte-wise
// emulation on sm_90, so the cur=2 pairs take __vabsdiffu4 and two dp4a)
__device__ __forceinline__ uint32_t sad_all(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// n 32-bit words to p (aligned to 4 * n bytes), as 16/8/4-byte stores
template <int N>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&v)[N], int n) {
  if (n % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      if (4 * q < n) {
        reinterpret_cast<uint4*>(p)[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
    }
  } else if (n == 2) {
    if constexpr (N >= 2) *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = v[0];
  }
}

// cells v[0..n) to a volume row at element offset off: uint16 or int32
template <int N>
__device__ __forceinline__ void store_cells(void* base, size_t off, const int (&v)[N], int n,
                                            bool is16) {
  if (is16) {
    uint16_t* p = static_cast<uint16_t*>(base) + off;
    if (n == 1) {
      *p = static_cast<uint16_t>(v[0]);
      return;
    }
    uint32_t wds[N / 2 > 0 ? N / 2 : 1];
#pragma unroll
    for (int q = 0; q < N / 2; ++q) wds[q] = __byte_perm(v[2 * q], v[2 * q + 1], 0x5410);
    store_words(p, wds, n / 2);
  } else {
    uint32_t wds[N];
#pragma unroll
    for (int q = 0; q < N; ++q) wds[q] = static_cast<uint32_t>(v[q]);
    store_words(static_cast<int*>(base) + off, wds, n);
  }
}

template <int BS, int MODE>
__global__ void __launch_bounds__(kMaxThreads, BS >= 64 ? 1 : 2)
pooled_cvs_kernel(const uint8_t* __restrict__ im1, const uint8_t* __restrict__ windows,
                  CvOuts outs, int emit_mask, int h, int w, int side, int store_r, int dyg,
                  int lpp) {
  using S = Shape<BS>;
  constexpr int F2 = S::kF2, NW = S::kNW, NDX = S::kNdx;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pp = 1 << lpp;  // parents of the block: px0 .. px0 + pp - 1 of one row
  const VolumeLayout lay = volume_layout<BS>(side, dyg, pp);
  const int npx = w / BS;
  const int npy = h / BS;
  const int ntx = (npx + pp - 1) >> lpp;
  const int b = blockIdx.x / (npy * ntx);
  const int tile = blockIdx.x - b * npy * ntx;
  const int py = tile / ntx;
  const int px0 = (tile - py * ntx) << lpp;
  const int np_blk = min(pp, npx - px0);
  const int n0 = (b * npy + py) * npx + px0;  // window index of parent px0
  const int wc = side - 1 + BS;
  const int dy0 = blockIdx.y * dyg;
  const int ndy = min(dyg, side - dy0);
  const int rows_in = min(lay.rows, wc - dy0);
  const int half = (lay.rows + 1) / 2;  // stored row of rel: (rel & 1) * half + rel / 2
  const int copy_words = 4 * lay.rows * lay.wpr;

  // 1. the patches (bytes) and each window's rows [dy0, dy0 + rows_in):
  //    16-byte loads of their 16-aligned cover (inside the allocation, whose
  //    blocks are 512-byte aligned)
  for (int t = threadIdx.x; t < np_blk * BS * BS; t += blockDim.x) {
    const int y = t / (np_blk * BS);
    const int x = t - y * (np_blk * BS);  // across the np_blk patches of the row
    smem[(x / BS) * S::kPatchBytes + y * S::kPatchPitch + x % BS] =
        im1[(static_cast<size_t>(b) * h + py * BS + y) * w + px0 * BS + x];
  }
  int s0[8];  // the cover's offset of each window (pp <= 8)
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q < np_blk) {
      const uint8_t* src = windows + (static_cast<size_t>(n0 + q) * wc + dy0) * wc;
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(src) & ~static_cast<uintptr_t>(15);
      s0[q] = static_cast<int>(reinterpret_cast<uintptr_t>(src) - a0);
      const int nvec = (s0[q] + rows_in * wc + 15) / 16;
      uint4* raw = reinterpret_cast<uint4*>(smem + lay.raw_off + q * lay.raw_bytes);
      for (int t = threadIdx.x; t < nvec; t += blockDim.x) {
        raw[t] = __ldg(reinterpret_cast<const uint4*>(a0) + t);
      }
    }
  }
  __syncthreads();
  // 2. the shifted copies
  uint32_t* copies = reinterpret_cast<uint32_t*>(smem + lay.copies_off);
  const int per_win = 4 * rows_in * lay.wpr;
  for (int t = threadIdx.x; t < np_blk * per_win; t += blockDim.x) {
    const int q = t / per_win;
    const int e = t - q * per_win;
    const int m = e % lay.wpr;
    const int rr = e / lay.wpr;
    const int rel = rr % rows_in;
    const int s = rr / rows_in;
    int sq = s0[0];
#pragma unroll
    for (int qq = 1; qq < 8; ++qq) sq = q == qq ? s0[qq] : sq;
    const int at = sq + rel * wc + 4 * m + s;
    const uint32_t* raw_w = reinterpret_cast<const uint32_t*>(smem + lay.raw_off + q * lay.raw_bytes);
    copies[q * copy_words + (s * lay.rows + (rel & 1) * half + rel / 2) * lay.wpr + m] =
        __byte_perm(raw_w[at >> 2], raw_w[(at >> 2) + 1], 0x3210 + 0x1111 * (at & 3));
  }
  __syncthreads();

  // 3. this thread's parent pi and cur=2 row sy: its two patch rows in
  //    registers (the block's threads are a multiple of F2 * pp)
  const int sy = threadIdx.x % F2;
  const int pi = (threadIdx.x / F2) & (pp - 1);
  const int px = px0 + pi;
  const uint8_t* patch = smem + pi * S::kPatchBytes;
  const uint32_t* pcopies = copies + pi * copy_words;
  uint32_t pw[2][NW];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      pw[u][j] = reinterpret_cast<const uint32_t*>(patch + (2 * sy + u) * S::kPatchPitch)[j];
    }
  }
  // items of a dy row: residue k, chunk c of NDX deltas dx = k + 4 (c NDX + i)
  int cnt[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) cnt[k] = k < side ? ((side - k + 3) / 4 + NDX - 1) / NDX : 0;
  const int items = cnt[0] + cnt[1] + cnt[2] + cnt[3];
  const int total = ndy * items * F2 * pp;
  const int r = (side - 1) / 2;
  const int side_st = store_r < 0 ? side : 2 * store_r + 1;
  const int lo = store_r < 0 ? 0 : r - store_r;

  // every lane of a warp runs every iteration (the shuffles need them all);
  // lanes past the end compute item 0 and store nothing
  for (int base = 0; base < total; base += blockDim.x) {
    const int wi = base + threadIdx.x;
    const bool active = wi < total;
    const int t = active ? (wi / F2) >> lpp : 0;
    const int dyl = t / items;
    int c = t - dyl * items;
    int k = 0;
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      if (k == kk && c >= cnt[kk]) {
        c -= cnt[kk];
        k = kk + 1;
      }
    }
    // diffs: acc[i][..] for dx = k + 4 (c NDX + i)
    constexpr int NACC = MODE == kSad4 ? NW : F2;
    uint32_t acc[NDX][NACC];
#pragma unroll
    for (int i = 0; i < NDX; ++i) {
#pragma unroll
      for (int q = 0; q < NACC; ++q) acc[i][q] = 0;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int rel = dyl + 2 * sy + u;
      const uint32_t* row =
          pcopies + (k * lay.rows + (rel & 1) * half + rel / 2) * lay.wpr + c * NDX;
      uint32_t wv[S::kNLoad];
#pragma unroll
      for (int q = 0; q < S::kNLoad; q += S::kVec) {
        if constexpr (S::kVec == 4) {
          const uint4 x = reinterpret_cast<const uint4*>(row)[q / 4];
          wv[q] = x.x;
          wv[q + 1] = x.y;
          wv[q + 2] = x.z;
          wv[q + 3] = x.w;
        } else if constexpr (S::kVec == 2) {
          const uint2 x = reinterpret_cast<const uint2*>(row)[q / 2];
          wv[q] = x.x;
          wv[q + 1] = x.y;
        } else {
          wv[q] = row[q];
        }
      }
#pragma unroll
      for (int i = 0; i < NDX; ++i) {
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const uint32_t a = pw[u][j];
          const uint32_t v = wv[i + j];
          if constexpr (MODE == kSad4) {
            acc[i][j] = sad_all(a, v, acc[i][j]);
          } else if constexpr (MODE == kSad2) {
            const uint32_t ad = __vabsdiffu4(a, v);
            acc[i][2 * j] = __dp4a(ad, 0x00000101u, acc[i][2 * j]);
            if constexpr (F2 > 1) acc[i][2 * j + 1] = __dp4a(ad, 0x01010000u, acc[i][2 * j + 1]);
          } else {
            const uint32_t ad = __vabsdiffu4(a, v);
            acc[i][2 * j] = __dp4a(ad, ad & 0x0000ffffu, acc[i][2 * j]);
            if constexpr (F2 > 1) {
              acc[i][2 * j + 1] = __dp4a(ad, ad & 0xffff0000u, acc[i][2 * j + 1]);
            }
          }
        }
      }
    }

    // pooling and stores, one delta at a time
    const int dy = dy0 + dyl;
#pragma unroll
    for (int i = 0; i < NDX; ++i) {
      const int dx = k + 4 * (c * NDX + i);
      const bool ok = active && pi < np_blk && dx < side;
      int v[F2];
      if constexpr (MODE == kSad4) {
#pragma unroll
        for (int q = 0; q < NW; ++q) v[q] = static_cast<int>(acc[i][q]);
      } else {
#pragma unroll
        for (int q = 0; q < F2; ++q) v[q] = static_cast<int>(acc[i][q]);
        if ((emit_mask & 1) && ok && dx >= lo && dx < lo + side_st) {
          const int f = F2;
          const size_t ncol = static_cast<size_t>(npx) * f;
          const size_t plane = static_cast<size_t>(npy) * f * ncol;
          const size_t o = (static_cast<size_t>(b) * side * side_st +
                            static_cast<size_t>(dy) * side_st + (dx - lo)) * plane +
                           static_cast<size_t>(py * f + sy) * ncol + static_cast<size_t>(px) * f;
          store_cells(outs.p[0], o, v, F2, MODE != kSsd);
        }
      }
      // each coarser size: the horizontal pair sums h, then the vertical pair
      // across lanes sy ^ 2^(l-1).  With sad at cur <= 16 two cells ride in
      // one word (each < 2^16: the uint16 stored layout), so one shuffle
      // moves two cells and the word is stored as it is.
      uint32_t pk[F2 / 2 > 0 ? F2 / 2 : 1];
      bool prev_packed = false;
#pragma unroll
      for (int l = 1; l < S::kLevels; ++l) {
        const int nf = F2 >> l;  // cells per row at cur = 2 << l
        const bool packed = MODE != kSsd && (2 << l) <= 16 && nf >= 2;
        int hs[F2 / 2 > 0 ? F2 / 2 : 1];
#pragma unroll
        for (int q = 0; q < F2 / 2; ++q) {
          if (q < nf) {
            if (MODE == kSad4 && l == 1) {
              hs[q] = v[q];
            } else if (prev_packed) {
              hs[q] = static_cast<int>(__dp2a_lo(pk[q], 0x0101u, 0u));
            } else {
              hs[q] = v[2 * q] + v[2 * q + 1];
            }
          }
        }
        const int mask = 1 << (l - 1);
        if (packed) {
#pragma unroll
          for (int q = 0; q < F2 / 4; ++q) {
            if (q < nf / 2) {
              pk[q] = __byte_perm(hs[2 * q], hs[2 * q + 1], 0x5410);
              pk[q] += __shfl_xor_sync(0xffffffffu, pk[q], mask);
            }
          }
        } else if (mask >= 32) {
          // bs >= 128: lanes sy and sy ^ 32 are in two warps; the one cell
          // (nf = 1) goes through shared memory, one slot per group of F2
          // lanes.  Every thread of the block runs every iteration, so the
          // barriers are uniform.
          int* xchg = reinterpret_cast<int*>(smem + lay.xchg_off);
          __syncthreads();  // the previous delta's readers are done
          if (sy == 32) xchg[threadIdx.x / F2] = hs[0];
          __syncthreads();
          v[0] = sy == 0 ? hs[0] + xchg[threadIdx.x / F2] : hs[0];
        } else {
#pragma unroll
          for (int q = 0; q < F2 / 2; ++q) {
            if (q < nf) v[q] = hs[q] + __shfl_xor_sync(0xffffffffu, hs[q], mask);
          }
        }
        if (((emit_mask >> l) & 1) && ok && (sy & ((1 << l) - 1)) == 0) {
          const int f = nf;
          const size_t ncol = static_cast<size_t>(npx) * f;
          const size_t plane = static_cast<size_t>(npy) * f * ncol;
          const size_t o = (static_cast<size_t>(b) * side * side + static_cast<size_t>(dy) * side + dx) *
                               plane +
                           static_cast<size_t>(py * f + (sy >> l)) * ncol + static_cast<size_t>(px) * f;
          if (packed) {
            store_words(static_cast<uint16_t*>(outs.p[l]) + o, pk, nf / 2);
          } else {
            store_cells(outs.p[l], o, v, nf, MODE != kSsd && (2 << l) <= 16);
          }
        }
        prev_packed = packed;
      }
    }
  }
}

template <int BS, int MODE>
int launch_pooled(const void* im1, const void* windows, const CvOuts& o, int emit_mask, int batch,
                  int h, int w, int side, int store_r, int dyg, int lpp, int threads, int smem,
                  cudaStream_t stream) {
  auto kernel = pooled_cvs_kernel<BS, MODE>;
  if (smem != volume_layout<BS>(side, dyg, 1 << lpp).bytes || threads % ((BS / 2) << lpp) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles_x = (w / BS + (1 << lpp) - 1) >> lpp;
  const dim3 grid(static_cast<unsigned>(batch) * (h / BS) * tiles_x, (side + dyg - 1) / dyg);
  if (grid.x == 0) return 0;
  kernel<<<grid, threads, smem, stream>>>(static_cast<const uint8_t*>(im1),
                                          static_cast<const uint8_t*>(windows), o, emit_mask, h, w,
                                          side, store_r, dyg, lpp);
  return static_cast<int>(cudaGetLastError());
}

template <int BS>
int launch_bs(const void* im1, const void* windows, const CvOuts& o, int emit_mask, int batch,
              int h, int w, int side, int store_r, int ssd, int dyg, int lpp, int threads,
              int smem, cudaStream_t stream) {
  if (ssd) {
    return launch_pooled<BS, kSsd>(im1, windows, o, emit_mask, batch, h, w, side, store_r, dyg,
                                   lpp, threads, smem, stream);
  }
  if ((emit_mask & 1) || BS == 2) {
    return launch_pooled<BS, kSad2>(im1, windows, o, emit_mask, batch, h, w, side, store_r, dyg,
                                    lpp, threads, smem, stream);
  }
  return launch_pooled<BS, (BS >= 4 ? kSad4 : kSad2)>(im1, windows, o, emit_mask, batch, h, w, side,
                                                    store_r, dyg, lpp, threads, smem, stream);
}

// ------------------------------------------------------- compact tables (14)

__device__ __forceinline__ void store_cost(void* base, bool is16, size_t o, int v) {
  if (is16) {
    static_cast<uint16_t*>(base)[o] = static_cast<uint16_t>(v);
  } else {
    static_cast<int*>(base)[o] = v;
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
// where bit i of is16_mask is set, else int32 (it must be cv_dtype's choice:
// sad at cur <= 16); written where bit i of emit_mask is set (else unused,
// may be null; else 16-byte aligned).  store_r >= 0 narrows outs[0] to
// (B, side * (2 store_r + 1), h / 2, w / 2); -1 keeps it dense.  The launch
// geometry (dy rows per block, threads, shared bytes) is
// kernels/cv_diff.py volume_geometry's; the shared bytes must equal this
// file's layout for it.  bs is one of 2, 4, .., 128: any other is refused.
extern "C" int bbme_pooled_cvs(const void* im1, const void* windows,
                               void* const* outs, int ncur, int is16_mask,
                               int emit_mask, int batch, int h, int w, int bs,
                               int side, int store_r, int ssd, int dy_per_cta,
                               int parents_per_cta, int threads, int smem_bytes,
                               void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (ncur < 1 || ncur > kMaxCurs || (2 << (ncur - 1)) != bs) return bad;
  if (side < 1 || side % 2 == 0 || store_r > (side - 1) / 2) return bad;
  if (emit_mask <= 0 || emit_mask >= (1 << ncur) || (store_r >= 0 && !(emit_mask & 1))) return bad;
  int lpp = 0;
  while ((1 << lpp) < parents_per_cta) ++lpp;
  if (dy_per_cta < 1 || dy_per_cta > side || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || (1 << lpp) != parents_per_cta || parents_per_cta > 8) {
    return bad;
  }
  CvOuts o{};
  for (int i = 0; i < ncur; ++i) {
    const bool want16 = !ssd && (2 << i) <= 16;
    if (((is16_mask >> i) & 1) != static_cast<int>(want16)) return bad;
    if ((emit_mask >> i) & 1) {
      if (outs[i] == nullptr || reinterpret_cast<uintptr_t>(outs[i]) % 16 != 0) return bad;
      o.p[i] = outs[i];
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bs) {
#define BBME_BS(N)                                                                          \
  case N:                                                                                   \
    return launch_bs<N>(im1, windows, o, emit_mask, batch, h, w, side, store_r, ssd,        \
                        dy_per_cta, lpp, threads, smem_bytes, st);
    BBME_BS(2)
    BBME_BS(4)
    BBME_BS(8)
    BBME_BS(16)
    BBME_BS(32)
    BBME_BS(64)
    BBME_BS(128)
#undef BBME_BS
    default:
      return bad;
  }
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
