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
// What bounds it.  B's writes.  At the 1080p level 0, B=8, the band form
// (store_r = 4: every delta at cur 4..32, the band at cur 2) writes ~7 GB,
// 2.11 ms at full rate, and the dense form ~15.4 GB, 4.59 ms; a parent adds
// a run of only 32/16/8/4/4 bytes to each volume row at cur 2/4/8/16/32, so
// how the writes are laid out, not their count, sets the time.  Timed one
// emit set at a time at the search-centred level 0 (2048x2560, B=8, dense,
// CUDA events, PERF.md), the cur-2 volume alone took 12.88 ms for its 6.8 ms
// of bytes while each lane stored its 32-byte run as two 16-byte pieces,
// every store half-filling 16 sectors of 16 rows; stored by lane pairs
// (below) it takes 9.93 ms, and the whole dense call 23.16 -> 19.02 ms
// (1080p: dense 11.16 -> 9.28 ms, band 4.90 -> 4.96).  Staging the block's
// runs through shared memory to store whole 128-byte lines cost two
// barriers a delta between a group's warps and ran slower (cur 2 alone
// 15.55 ms, dense 23.97).  C and 13 write little (cur >= 8 or cur = bs
// only); their ~13-23 G pixel diffs per launch bound them.  The previous
// design (one block per (parent, dy), byte-wise diffs with runtime
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
//   - stores: each lane writes its row run of cells as 16/8/4-byte vectors;
//     where a lane's cur=2 run is whole 32-byte sectors and a warp holds two
//     parents (sad at bs 32, ssd at bs 16 and 32; paired_cur2), the lanes
//     of parents 2j and 2j + 1 swap half their runs with shuffles, so that
//     each 16-byte store fills whole sectors (store_pair_run, kernel 14's);
//     offsets are 64-bit (the B=8 dense cur=2 volume has 5.7 G entries).
//
// ptxas (sm_90a, CUDA 12.9): every instance has 0 bytes of stack and no
// spills; bs 32 uses 126 registers for B's loop (cur 2 written), 79 for C's
// and 13's, 127 for ssd.  The bs-32 loop of C and 13 holds 64 VABSDIFF4 among
// 748 instructions, B's 64 VABSDIFF4 and 156 IDP among 1100 (PERF.md).
//
// Also here: kernel 14, compact_tables (replaces blockbasedmotionestimation_tpu/
// kernels/cv_diff.py compact_tables, the cv_compact mode): the pooled costs at
// only the K slot deltas of each parent's 128-parent chunk, for cur = 2 ..
// bs/2, as (B, K, h/cur, w/cur) tables.  Its work is small (K * bs^2 diffs
// a parent: at the 1080p level 0, B=8, K=64, 1.34 G, ~0.02 ms at four
// pixels an instruction); its table writes bound it (~0.89 GB of uint16 at
// that level, 0.2974 ms at 3.35 TB/s).  The previous design (a block per
// parent looping over the slots, byte-wise diffs with runtime divisions, a
// shared-memory pass and a barrier per pooled size, scalar 2-byte stores)
// ran it at 3.2546 ms on the H100 (PERF.md).  This one is the volume
// kernel's, per slot instead of per delta: templated on bs (4 .. 128) and
// the cost, a block of pp neighbouring parents of a row (each window read
// once, into aligned words at an odd pitch), a thread a (parent, slot,
// cur=2 row), the window words at the slot's dx funnel-shifted out of two
// aligned words, byte-packed diffs, pooling in registers with no barrier
// after the staging, and row runs stored as vectors (compact_tables_kernel).
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

// the diffs of patch word a against window word v (four pixels), added to
// acc: the cur=4 half-cell j (kSad4), else the two cur=2 cells 2j and 2j+1,
// the byte |d| summed in pairs by dp4a (ssd: |d| times itself, d^2 = |d|^2)
template <int MODE, int NACC>
__device__ __forceinline__ void add_word(uint32_t (&acc)[NACC], int j, uint32_t a, uint32_t v) {
  if constexpr (MODE == kSad4) {
    acc[j] = sad_all(a, v, acc[j]);
  } else if constexpr (MODE == kSad2) {
    const uint32_t ad = __vabsdiffu4(a, v);
    acc[2 * j] = __dp4a(ad, 0x00000101u, acc[2 * j]);
    if constexpr (NACC > 1) acc[2 * j + 1] = __dp4a(ad, 0x01010000u, acc[2 * j + 1]);
  } else {
    const uint32_t ad = __vabsdiffu4(a, v);
    acc[2 * j] = __dp4a(ad, ad & 0x0000ffffu, acc[2 * j]);
    if constexpr (NACC > 1) acc[2 * j + 1] = __dp4a(ad, ad & 0xffff0000u, acc[2 * j + 1]);
  }
}

// 2x2 pooling in registers, from size 1 << l to size 2 << l (nf = F2 >> l
// cells a row): the horizontal pair sums hs in the thread (pair_sums), then
// the vertical pair across lanes sy ^ 2^(l-1) (lane_pairs).  With sad at
// cur <= 16 two cells ride in one word pk (each < 2^16: the uint16 stored
// layout), so one shuffle moves two cells and the word is stored as it is.
template <int F2>
__host__ __device__ constexpr int half_cells() { return F2 / 2 > 0 ? F2 / 2 : 1; }

template <int MODE>
__device__ __forceinline__ bool packed_size(int l, int nf) {
  return MODE != kSsd && (2 << l) <= 16 && nf >= 2;
}

template <int F2, int MODE, int H>
__device__ __forceinline__ void pair_sums(int l, bool prev_packed, const int (&v)[F2],
                                          const uint32_t (&pk)[H], int (&hs)[H]) {
  const int nf = F2 >> l;
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
}

// every lane of the warp must call it (the shuffles take them all)
template <int F2, int H>
__device__ __forceinline__ void lane_pairs(bool packed, int nf, int mask, const int (&hs)[H],
                                           int (&v)[F2], uint32_t (&pk)[H]) {
  if (packed) {
#pragma unroll
    for (int q = 0; q < F2 / 4; ++q) {
      if (q < nf / 2) {
        pk[q] = __byte_perm(hs[2 * q], hs[2 * q + 1], 0x5410);
        pk[q] += __shfl_xor_sync(0xffffffffu, pk[q], mask);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < F2 / 2; ++q) {
      if (q < nf) v[q] = hs[q] + __shfl_xor_sync(0xffffffffu, hs[q], mask);
    }
  }
}

// element offset of the run of nf cells a parent (py, px) adds to its row
// sub-row `sub` of plane `plane` of a (npy * nf, npx * nf) pooled layout
__device__ __forceinline__ size_t run_offset(size_t plane, int npy, int npx, int nf, int py,
                                             int sub, int px) {
  const size_t ncol = static_cast<size_t>(npx) * nf;
  return plane * static_cast<size_t>(npy) * nf * ncol +
         static_cast<size_t>(py * nf + sub) * ncol + static_cast<size_t>(px) * nf;
}

// a size's run: the packed words pk (uint16 cells), else the cells v
template <int F2, int H>
__device__ __forceinline__ void store_run(void* base, size_t off, bool packed,
                                          const uint32_t (&pk)[H], const int (&v)[F2], int nf,
                                          bool is16) {
  if (packed) {
    store_words(static_cast<uint16_t*>(base) + off, pk, nf / 2);
  } else {
    store_cells(base, off, v, nf, is16);
  }
}

// A parent's cur=2 run of N words (N % 8 == 0: an even number of 16-byte
// pieces), stored together with the run after it, which the lane
// `lane ^ lane_mask` holds: the pair's run starts at `pair_run` (the even
// parent's, 32-byte aligned), the even lane writes its pieces 2i and the odd
// lane its pieces 2i + 1, so each 16-byte store instruction fills whole
// 32-byte sectors (a lane alone half-fills two).  Every lane of the warp
// calls it; `both`: the pair stores (else the even lane stores alone).
template <int N>
__device__ __forceinline__ void store_pair_run(uint32_t* pair_run, const uint32_t (&wd)[N],
                                               bool odd, bool active, bool both, int lane_mask) {
  constexpr int NP = N / 4;  // pieces of one run
  static_assert(N % 8 == 0, "an even number of 16-byte pieces");
  // the even lane hands over its odd pieces 2t + 1, the odd lane its even
  // pieces 2t (the pair's pieces NP + 2t)
  uint32_t got[NP / 2][4];
#pragma unroll
  for (int t = 0; t < NP / 2; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      got[t][e] = __shfl_xor_sync(0xffffffffu, odd ? wd[8 * t + e] : wd[8 * t + 4 + e], lane_mask);
    }
  }
  if (!active) return;
  uint4* dst = reinterpret_cast<uint4*>(pair_run);
  if (!both) {
#pragma unroll
    for (int i = 0; i < NP; ++i) dst[i] = make_uint4(wd[4 * i], wd[4 * i + 1], wd[4 * i + 2], wd[4 * i + 3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    // the pair's piece 2i (even lane: its own below NP, else handed over)
    // and 2i + 1 (odd lane: handed over below NP, else its own); every
    // index a constant once unrolled, only the pick depends on the lane
    uint32_t ve[4], vo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ve[e] = 2 * i < NP ? wd[4 * min(2 * i, NP - 1) + e] : got[max(0, (2 * i - NP) / 2)][e];
      vo[e] = 2 * i + 1 < NP ? got[min(i, NP / 2 - 1)][e] : wd[4 * max(0, 2 * i + 1 - NP) + e];
    }
    dst[2 * i + odd] = odd ? make_uint4(vo[0], vo[1], vo[2], vo[3])
                           : make_uint4(ve[0], ve[1], ve[2], ve[3]);
  }
}

// Whether the lanes of a block's parents 2j and 2j + 1 store their cur=2
// runs of a row together (store_pair_run): where a lane's run is a whole
// number of 32-byte sectors (sad at bs 32, ssd at bs 16 and 32) and a warp
// holds two parents' rows (bs <= 32), in blocks of pp > 1 parents.
// kernels/cv_diff.py paired_curs mirrors it.
template <int F2, int MODE>
__host__ __device__ constexpr bool paired_cur2() {
  return MODE != kSad4 && F2 <= 16 && F2 * (MODE == kSsd ? 4 : 2) % 32 == 0;
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
        for (int j = 0; j < NW; ++j) add_word<MODE>(acc[i], j, pw[u][j], wv[i + j]);
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
        const bool st = (emit_mask & 1) && ok && dx >= lo && dx < lo + side_st;
        const size_t plane = static_cast<size_t>(b) * side * side_st +
                             static_cast<size_t>(dy) * side_st + (dx - lo);
        bool own = st;
        if constexpr (paired_cur2<F2, MODE>()) {
          // a warp's lanes share its delta where pp > 1, so they all take
          // the branch; a delta the band leaves out skips the exchange
          if (pp > 1 && __any_sync(0xffffffffu, st)) {
            constexpr int RUN = MODE == kSsd ? F2 : F2 / 2;  // words of a lane's run
            uint32_t wd[RUN];
#pragma unroll
            for (int q = 0; q < RUN; ++q) {
              wd[q] = MODE == kSsd ? static_cast<uint32_t>(v[q])
                                   : __byte_perm(v[2 * q], v[2 * q + 1], 0x5410);
            }
            uint32_t* pair_run = reinterpret_cast<uint32_t*>(
                static_cast<char*>(outs.p[0]) +
                run_offset(plane, npy, npx, F2, py, sy, px - (pi & 1)) * (MODE == kSsd ? 4 : 2));
            store_pair_run(pair_run, wd, (pi & 1) != 0, st, (pi | 1) < np_blk, F2);
            own = false;
          }
        }
        if (own) {
          store_cells(outs.p[0], run_offset(plane, npy, npx, F2, py, sy, px), v, F2,
                      MODE != kSsd);
        }
      }
      constexpr int H = half_cells<F2>();
      uint32_t pk[H];
      bool prev_packed = false;
#pragma unroll
      for (int l = 1; l < S::kLevels; ++l) {
        const int nf = F2 >> l;  // cells per row at cur = 2 << l
        const bool packed = packed_size<MODE>(l, nf);
        int hs[H];
        pair_sums<F2, MODE>(l, prev_packed, v, pk, hs);
        const int mask = 1 << (l - 1);
        if (packed || mask < 32) {
          lane_pairs(packed, nf, mask, hs, v, pk);
        } else {
          // bs >= 128: lanes sy and sy ^ 32 are in two warps; the one cell
          // (nf = 1) goes through shared memory, one slot per group of F2
          // lanes.  Every thread of the block runs every iteration, so the
          // barriers are uniform.
          int* xchg = reinterpret_cast<int*>(smem + lay.xchg_off);
          __syncthreads();  // the previous delta's readers are done
          if (sy == 32) xchg[threadIdx.x / F2] = hs[0];
          __syncthreads();
          v[0] = sy == 0 ? hs[0] + xchg[threadIdx.x / F2] : hs[0];
        }
        if (((emit_mask >> l) & 1) && ok && (sy & ((1 << l) - 1)) == 0) {
          const size_t plane = static_cast<size_t>(b) * side * side +
                               static_cast<size_t>(dy) * side + dx;
          store_run(outs.p[l], run_offset(plane, npy, npx, nf, py, sy >> l, px), packed, pk, v,
                    nf, MODE != kSsd && (2 << l) <= 16);
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

// Shared memory of one kernel-14 block of pp parents: each parent's window
// as aligned words, its ws rows stored even rows first, then odd rows, at
// an odd pitch of at least (ws + 3) / 4 + 1 words (a row's words and the
// word past them, the funnel shift's high word), windows win_words apart
// with win_words = f2 (mod 32) below f2 = 32, so the f2 sy lanes of each of
// a warp's 32 / f2 parents read 32 distinct banks.
// kernels/cv_diff.py compact_smem mirrors it.
struct CompactLayout {
  int pitch, half, win_words, bytes;
};

__host__ __device__ inline CompactLayout compact_layout(int f2, int ws, int pp) {
  CompactLayout l;
  l.pitch = (ws + 3) / 4 + 1;
  if (l.pitch % 2 == 0) ++l.pitch;
  l.half = (ws + 1) / 2;
  l.win_words = ws * l.pitch;
  if (f2 < 32) l.win_words += ((f2 - l.win_words) % 32 + 32) % 32;
  l.bytes = 4 * pp * l.win_words;
  return l;
}

// Kernel 14: one thread block per pp neighbouring parents of a row and
// group of slots_per_cta slots.  Each window is read from device memory once
// (16-byte loads of its 16-aligned cover) into the layout above; then one
// barrier, and none after it.  A thread owns one (parent, slot, cur=2 row
// sy): its two patch rows sit in registers for the whole block, and for
// each slot (dy, dx) of its parent's chunk it funnel-shifts the window
// words at byte offset dx out of two aligned words, takes the byte |d| of
// four pixels at once, sums them into its bs/2 cur=2 cells with dp4a, and
// pools them in registers up to cur = bs/2 (pair sums in the thread, then
// __shfl_xor across the neighbouring sy lanes, which all sit in one warp:
// at bs 128 the cur = 64 cell spans 32 of them).  Each size is stored as its
// parent's row run (16/8/4-byte vectors); a cur=2 run of 32 bytes or more
// together with the next parent's (store_pair_run).  A slot of -1 stores
// zeros.  Below bs 64 an SM holds four blocks for sad (64 registers a
// thread) and three for ssd (80): the loop is latency-bound, and four
// blocks ran sad faster than three at the 1080p level 0, where ssd, held to
// 64 registers, spilled and ran slower.
template <int BS, int MODE>
__global__ void __launch_bounds__(kMaxThreads, BS >= 64 ? 1 : MODE == kSsd ? 3 : 4)
compact_tables_kernel(const uint8_t* __restrict__ im1, const uint8_t* __restrict__ windows,
                      const int* __restrict__ slots, CvOuts outs, int h, int w, int ws,
                      int k_slots, int nch, int chunk, int slots_per_cta, int lpp) {
  using S = Shape<BS>;
  constexpr int F2 = S::kF2, NW = S::kNW, H = half_cells<F2>();
  static_assert(BS >= 4 && F2 <= 64, "kernel 14 is built for bs 4 .. 128");
  extern __shared__ __align__(16) unsigned char smem[];
  const int pp = 1 << lpp;
  const CompactLayout lay = compact_layout(F2, ws, pp);
  const int npx = w / BS;
  const int npy = h / BS;
  const int ntx = (npx + pp - 1) >> lpp;
  const int b = blockIdx.x / (npy * ntx);
  const int tile = blockIdx.x - b * npy * ntx;
  const int py = tile / ntx;
  const int px0 = (tile - py * ntx) << lpp;
  const int np_blk = min(pp, npx - px0);
  const int n0 = (b * npy + py) * npx + px0;  // window index of parent px0
  const int wbytes = ws * ws;

  // 1. the windows: each 16-byte vector of a window's cover goes to its
  //    rows as words (rows and window 4-aligned), else as bytes
  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);
  const int nvec = (15 + wbytes + 15) / 16;  // the most vectors a cover has
  for (int t = threadIdx.x; t < np_blk * nvec; t += blockDim.x) {
    const int q = t / nvec;
    const int c = t - q * nvec;
    const uint8_t* src = windows + static_cast<size_t>(n0 + q) * wbytes;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(src) & ~static_cast<uintptr_t>(15);
    const int s0 = static_cast<int>(reinterpret_cast<uintptr_t>(src) - a0);
    if (16 * c >= s0 + wbytes) continue;
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(a0) + c);
    const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
    uint32_t* rows = wsm + q * lay.win_words;
    const int o = 16 * c - s0;  // window byte of the vector's first byte
    if ((ws & 3) == 0 && (s0 & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int oi = o + 4 * i;
        if (oi >= 0 && oi < wbytes) {
          const int y = oi / ws;
          rows[((y & 1) * lay.half + (y >> 1)) * lay.pitch + ((oi - y * ws) >> 2)] = wd[i];
        }
      }
    } else {
      uint8_t* rb = reinterpret_cast<uint8_t*>(rows);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int oi = o + i;
        if (oi >= 0 && oi < wbytes) {
          const int y = oi / ws;
          rb[4 * ((y & 1) * lay.half + (y >> 1)) * lay.pitch + (oi - y * ws)] =
              static_cast<uint8_t>(wd[i >> 2] >> (8 * (i & 3)));
        }
      }
    }
  }
  __syncthreads();

  // 2. this thread's parent pi, cur=2 row sy and slot si of each iteration
  //    (the block's threads are a multiple of F2 * pp); its patch rows
  const int sy = threadIdx.x & (F2 - 1);
  const int pi = (threadIdx.x / F2) & (pp - 1);
  const int si = (threadIdx.x / F2) >> lpp;
  const int spi = blockDim.x / (F2 << lpp);  // slots an iteration
  const int px = px0 + pi;
  const bool pactive = pi < np_blk;
  uint32_t pw[2][NW];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const uint8_t* row = im1 + (static_cast<size_t>(b) * h + py * BS + 2 * sy + u) * w +
                         static_cast<size_t>(pactive ? px : px0) * BS;
#pragma unroll
    for (int j = 0; j < NW; j += (NW % 4 == 0 ? 4 : NW)) {
      if constexpr (NW % 4 == 0) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(row) + j / 4);
        pw[u][j] = x.x;
        pw[u][j + 1] = x.y;
        pw[u][j + 2] = x.z;
        pw[u][j + 3] = x.w;
      } else if constexpr (NW == 2) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(row));
        pw[u][0] = x.x;
        pw[u][1] = x.y;
      } else {
        pw[u][0] = __ldg(reinterpret_cast<const uint32_t*>(row));
      }
    }
  }
  // each parent reads its own chunk's slot list (a block's parents may lie
  // in two chunks)
  const int p = py * npx + (pactive ? px : px0);
  const int* sl = slots + (static_cast<size_t>(b) * nch + p / chunk) * k_slots * 2;
  const uint32_t* wrows = wsm + pi * lay.win_words;
  const int kbeg = blockIdx.y * slots_per_cta;
  const int kend = min(k_slots, kbeg + slots_per_cta);

  // 3. the slots; every lane of a warp runs every iteration (the shuffles
  //    need them all); lanes past the end compute zeros and store nothing
  for (int k0 = kbeg; k0 < kend; k0 += spi) {
    const int k = k0 + si;
    const bool active = pactive && k < kend;
    const int dy = active ? __ldg(sl + 2 * k) : -1;
    const int dx = active ? __ldg(sl + 2 * k + 1) : -1;
    uint32_t acc[F2];
#pragma unroll
    for (int q = 0; q < F2; ++q) acc[q] = 0;
    if (dy >= 0 && dx >= 0) {
      const int sh = 8 * (dx & 3);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int y = dy + 2 * sy + u;
        const uint32_t* row = wrows + ((y & 1) * lay.half + (y >> 1)) * lay.pitch + (dx >> 2);
        uint32_t wv[NW + 1];
#pragma unroll
        for (int j = 0; j <= NW; ++j) wv[j] = row[j];
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          add_word<MODE>(acc, j, pw[u][j], __funnelshift_r(wv[j], wv[j + 1], sh));
        }
      }
    }
    const size_t plane = static_cast<size_t>(b) * k_slots + k;
    int v[F2];
#pragma unroll
    for (int q = 0; q < F2; ++q) v[q] = static_cast<int>(acc[q]);
    constexpr int RUN = MODE == kSsd ? F2 : F2 / 2;  // words of a parent's cur=2 run
    if constexpr (F2 < 32 && RUN % 8 == 0) {
      // runs of 32 bytes or more, two parents a warp: stored in pairs
      uint32_t wd[RUN];
#pragma unroll
      for (int q = 0; q < RUN; ++q) {
        if constexpr (MODE == kSsd) {
          wd[q] = static_cast<uint32_t>(v[q]);
        } else {
          wd[q] = __byte_perm(v[2 * q], v[2 * q + 1], 0x5410);
        }
      }
      const int even_px = px - (pi & 1);
      uint32_t* pair_run = reinterpret_cast<uint32_t*>(
          static_cast<char*>(outs.p[0]) +
          run_offset(plane, npy, npx, F2, py, sy, even_px) * (MODE == kSsd ? 4 : 2));
      store_pair_run(pair_run, wd, (pi & 1) != 0, active, pp > 1 && (pi | 1) < np_blk, F2);
    } else if (active) {
      store_cells(outs.p[0], run_offset(plane, npy, npx, F2, py, sy, px), v, F2, MODE != kSsd);
    }
    uint32_t pk[H];
    bool prev_packed = false;
#pragma unroll
    for (int l = 1; l < S::kLevels - 1; ++l) {  // cur = 4 .. BS/2: masks <= 16, in the warp
      const int nf = F2 >> l;
      const bool packed = packed_size<MODE>(l, nf);
      int hs[H];
      pair_sums<F2, MODE>(l, prev_packed, v, pk, hs);
      lane_pairs(packed, nf, 1 << (l - 1), hs, v, pk);
      if (active && (sy & ((1 << l) - 1)) == 0) {
        store_run(outs.p[l], run_offset(plane, npy, npx, nf, py, sy >> l, px), packed, pk, v, nf,
                  MODE != kSsd && (2 << l) <= 16);
      }
      prev_packed = packed;
    }
  }
}

template <int BS, int MODE>
int launch_tables(const void* im1, const void* windows, const void* slots, const CvOuts& o,
                  int batch, int h, int w, int ws, int k_slots, int nch, int chunk,
                  int slots_per_cta, int lpp, int threads, int smem, cudaStream_t stream) {
  auto kernel = compact_tables_kernel<BS, MODE>;
  if (smem != compact_layout(BS / 2, ws, 1 << lpp).bytes || threads % ((BS / 2) << lpp) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles_x = (w / BS + (1 << lpp) - 1) >> lpp;
  const dim3 grid(static_cast<unsigned>(batch) * (h / BS) * tiles_x,
                  (k_slots + slots_per_cta - 1) / slots_per_cta);
  if (grid.x == 0 || k_slots == 0) return 0;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(im1), static_cast<const uint8_t*>(windows),
      static_cast<const int*>(slots), o, h, w, ws, k_slots, nch, chunk, slots_per_cta, lpp);
  return static_cast<int>(cudaGetLastError());
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


// Kernel 14.  im1: (B, h, w) u8, 16-byte aligned; windows: (B * nP, ws, ws)
// u8, ws = bs + 2r; slots: (B, nch, K, 2) i32 window offsets (dy + r, dx +
// r) of each chunk's slots, each in [0, 2r], or -1 unused, one list per
// `chunk` parents; outs[i]: table of cur = 2 << i, (B, K, h / cur, w /
// cur), 16-bit where bit i of is16_mask is set, else int32 (it must be
// cv_dtype's choice: sad at cur <= 16), 16-byte aligned, for cur = 2 ..
// bs/2 (ncur = log2(bs) - 1 sizes).  The launch geometry (parents and
// slots per block, threads, shared bytes) is kernels/cv_diff.py
// compact_geometry's; the shared bytes must equal compact_layout's.  bs is
// one of 4, 8, .., 128: any other is refused.
extern "C" int bbme_compact_tables(const void* im1, const void* windows,
                                   const void* slots, void* const* outs,
                                   int ncur, int is16_mask, int batch, int h,
                                   int w, int bs, int ws, int k_slots, int nch,
                                   int chunk, int ssd, int slots_per_cta,
                                   int parents_per_cta, int threads,
                                   int smem_bytes, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (ncur < 1 || ncur > kMaxCurs || (2 << ncur) != bs || h % bs != 0 || w % bs != 0 ||
      ws < bs || (ws - bs) % 2 != 0 || chunk < 1 || k_slots < 0 ||
      nch != ((h / bs) * (w / bs) + chunk - 1) / chunk ||
      reinterpret_cast<uintptr_t>(im1) % 16 != 0) {
    return bad;
  }
  int lpp = 0;
  while ((1 << lpp) < parents_per_cta) ++lpp;
  if (slots_per_cta < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (1 << lpp) != parents_per_cta || parents_per_cta > 8) {
    return bad;
  }
  CvOuts o{};
  for (int i = 0; i < ncur; ++i) {
    const bool want16 = !ssd && (2 << i) <= 16;
    if (((is16_mask >> i) & 1) != static_cast<int>(want16) || outs[i] == nullptr ||
        reinterpret_cast<uintptr_t>(outs[i]) % 16 != 0) {
      return bad;
    }
    o.p[i] = outs[i];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bs) {
#define BBME_BS(N)                                                                          \
  case N:                                                                                   \
    return ssd ? launch_tables<N, kSsd>(im1, windows, slots, o, batch, h, w, ws, k_slots,   \
                                        nch, chunk, slots_per_cta, lpp, threads,            \
                                        smem_bytes, st)                                     \
               : launch_tables<N, kSad2>(im1, windows, slots, o, batch, h, w, ws, k_slots,  \
                                         nch, chunk, slots_per_cta, lpp, threads,           \
                                         smem_bytes, st);
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
