// The colour steps of the windowed regularizer's rounds, a round a launch:
// the steps that recompute candidate costs from window pixels instead of
// reading them all from stored volumes, and the steps that read every cost
// from stored volumes.
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
//     window for candidates outside the main one;
// and blockbasedmotionestimation_tpu/kernels/reg_step.py
//   windowed_color_step_rival (kernel D, rounds at cur = bs) and
//   windowed_color_step_pm_rival (kernel D', rounds at cur < bs): main
//     candidates from the main volume at cur, rival candidates (outside the
//     main window, inside the rival one) from the rival volume at cur;
//   windowed_color_step (8) and windowed_color_step_pm (9): the same
//     without rival windows;
//   windowed_color_step_pm_compact (kernel 10, cv_compact's rounds cur <
//     bs): the stored step without rival windows, each cost taken from a
//     K-slot table at the slot of the cell's chunk that holds its delta.
// One template, round_kernel<Form, CUR, kStrips>, for the nine (CUR 2, 4, 8, 16 as
// the rounds use them, 0 for any other cur; the stored form kStored serves
// D, D', 8 and 9, since the cell layout here is the plain grid and the
// parent of cell (i, j) is (i / f, j / f); kCompact serves 10).  A launch
// runs a span of consecutive colour steps of one round: step s has colour
// COLORS[(step0 + s) % 4] ((0,0), (0,1), (1,0), (1,1)) and multiplier
// lam[(step0 + s) / 4], so a whole round (step0 = 0, 4 * sweeps steps) is
// one launch, and a span of one step is a single colour step.  Each step
// updates the MV grid in place; all 8 neighbours of a cell have another
// colour, so a step's writes never meet its own reads.
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
// What bounded the first design (one thread per cell on a flat 64-bit
// index, one launch per colour step, byte-wise recomputes, each of a
// cell's cost reads and recomputes in turn): E took 0.122 ms a level-0 step
// against a 6 us bound, and the default path made 128 of these launches a
// batch from Python (PERF.md).  The design now:
//   - one cooperative launch per round (cudaLaunchCooperativeKernel), the
//     grid sized to the blocks that fit on the card at once, blocks walking
//     the tiles of each step in a grid-stride loop; cooperative_groups'
//     grid.sync() between steps replaces the launch boundary and is what
//     makes one step's writes visible to the next (the grid is read with
//     ld.global.cg, past L1, since other SMs wrote it in the previous step);
//   - a block takes a tile of one colour in one frame: 32 cells of a row
//     (a warp) x 8 rows, 32-bit indices inside the frame.  Each step stages
//     the tile's MVs with their one-cell halo (17 x 65 grid entries), its
//     parents' window centres and the rank table in shared memory, each
//     thread issuing all its loads before its stores; a neighbour's MV is
//     then a shared-memory read.  Nothing stays resident across the
//     barrier (the level-0 cur = 2 grid is 42 MB);
//   - a cell issues all its stored-cost reads at once, then its
//     recomputes.  A recompute takes four pixels an instruction: window
//     rows sit at data-dependent offsets, so each word is a funnel shift of
//     two aligned loads (the second only when the row is unaligned); SAD is
//     VABSDIFF4 with accumulate, SSD the byte |d| dotted with itself by
//     dp4a (exact: every byte <= 255).  At cur = 2 a cell's two rows are one
//     packed word and all of a cell's recomputes load at once; at cur >= 4
//     the warp shares them out (recompute_warp), so a lane with several no
//     longer holds its warp up for each in turn (before that, the few
//     cells with rival recomputes set the time of E at cur 16 and 8);
//   - lambda per sweep comes by value in the argument struct, computed on
//     the host as today; energies use __fmul_rn/__fadd_rn (built with
//     --fmad=false) and the reference's (energy, rank) order.
// The stored form (D, D', 8, 9) is the same step with the rival cost read
// from the rival volume instead of recomputed: no window, no frame-1 block,
// a cell's main and rival reads all issued at once.  Before it, D was one
// launch a colour step of a one-thread-a-cell kernel, each a few
// microseconds of device work behind ~30 us of host work.
// The compact form (kernel 10) is the stored form without rival windows,
// each cost's plane looked up: a chunk's K slots hold distinct deltas, so
// the map smap (ops/compact.py slot_map: (B, nch, side^2) u16, the slot
// of each delta key (dy + r) * side + (dx + r), 0xFFFF where none; built
// once a level, ~350 KB at the 1080p level 0, L2-resident) turns each
// candidate's delta into its slot with one read, and the table entry of
// that slot is the cost: a cell issues its 9 map reads at once, then its
// table reads at once.  A candidate in no slot (or outside the window) is
// excluded, and if the cell's own MV is in none, every candidate is (the
// reference's incumbent-safety guard: the all-FLT_MAX tie goes to rank 0,
// the own MV).  Before it, kernel 10 was one launch a colour step of a
// one-thread-a-cell kernel that compared each of its 9 candidates with all
// K slots of its chunk (576 compares a cell at K = 64).
// Tiles (the tiled engine, parallel/tiled.py): a batch entry may be a row
// strip of nby grid rows of a frame of nby_total, whose row 0 is the frame's
// grid row row0_b[b], or a 2-D tile whose column 0 is also the frame's grid
// column col0_b[b] of nbx_total.  Colours are global: a tile whose first row
// (column) is odd holds colour row ci (column cj) at local rows (ci +
// row0_b) % 2, ... (columns (cj + col0_b) % 2, ...); the border case,
// presence and in-image tests use the frame's rows and columns and its
// height full_h and width full_w; the rows just above and below the tile
// come from ghost (B, 2, nbx, 2), and on 2-D tiles the columns just left
// and right of it from ghost_cols (B, 2, nby + 2, 2), over rows -1 .. nby,
// so the diagonal neighbours' corner cells come with them.  The caller
// refreshes both from the neighbouring tiles before every step, so a tiled
// round is a launch a step (a span of one), never one cooperative launch.
// Row strips are tiles with col0_b and ghost_cols null (column 0, the
// frame's width); without row0_b (null) an entry is a whole frame, as
// before.  Tiles run their own instantiation (kStrips).
// What bounds it now (PERF.md): latency.  A block works its tiles one after
// another (stage, barrier, cells), 2-3 blocks an SM, so a level-0 step
// takes many times what its bytes need; at the coarse levels a step costs
// a few microseconds whatever its size (staging, cells and grid barrier in
// turn).
#include <cfloat>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

// the reference's slot order: own MV first, then the 8 neighbours
__constant__ int kSlotDy[9] = {0, 0, 0, 1, -1, -1, -1, 1, 1};
__constant__ int kSlotDx[9] = {0, -1, 1, 1, -1, 1, 0, 0, -1};
constexpr int kBigRank = 127;  // a rank-table entry that marks an absent slot

// The border case of cell (i, j) of an nby x nbx grid: the row of the rank
// table (the reference's _finish_step tie-break ranks).
__device__ __forceinline__ int border_case(int i, int j, int nby, int nbx) {
  const bool rows_in = i > 0 && i < nby - 1;
  const bool cols_in = j > 0 && j < nbx - 1;
  if (rows_in && cols_in) return 0;     // interior
  if (i == 0 && cols_in) return 1;      // top row
  if (i == nby - 1 && cols_in) return 2;  // bottom row
  if (j == 0 && rows_in) return 3;      // left col
  if (j == nbx - 1 && rows_in) return 4;  // right col
  if (i == 0 && j == 0) return 5;       // top-left
  if (i == 0) return 6;                 // top-right
  if (j == 0) return 7;                 // bottom-left
  return 8;                             // bottom-right
}

// Whether candidate (cx, cy) of cell (i, j) keeps its cur x cur target
// block in the h x w frame.
__device__ __forceinline__ bool in_image(int i, int j, int cur, int h, int w, int cx, int cy) {
  const int tx = j * cur + cx;
  const int ty = i * cur + cy;
  return tx >= 0 && tx <= w - cur && ty >= 0 && ty <= h - cur;
}

constexpr int kTileW = 32;                 // cells of a tile row: one warp
constexpr int kTileR = 8;                  // rows of a tile: the block's warps
constexpr int kThreads = kTileW * kTileR;  // 256
constexpr int kHaloR = 2 * kTileR + 1;     // grid rows a tile and its neighbours span
constexpr int kHaloC = 2 * kTileW + 1;     // grid cols
constexpr int kParR = 2 * kTileR;          // parent rows a tile spans (f = 1: 15)
constexpr int kParC = 2 * kTileW;          // parent cols (f = 1: 63)
constexpr int kMaxSweeps = 8;              // kernels/rounds.py MAX_SWEEPS

struct RoundArgs {
  int* grid;            // (B, nby, nbx, 2) i32, updated in place
  const void* cv;       // E, stored: (B, side^2, nby, nbx); F: band (B, side*side_st, nby, nbx);
                        // compact: table (B, K, nby, nbx); 11/12: null
  const void* rcv;      // stored: (B, side2^2, nby, nbx) rival volume, or null (8, 9)
  const uint8_t* im1;   // (B, h, w) frame-1 level image
  const uint8_t* win;   // F, 11, 12: (B, nP, bs + 2r, bs + 2r) main windows
  const uint8_t* rwin;  // (B, nP, bs + 2r2, bs + 2r2) rival windows; 11: null
  const int* pm;        // (B, npy, npx, 2) main window centres
  const int* rpm;       // (B, npy, npx, 2) rival window centres; null without rival (11, 8, 9)
  const int* rank_table;
  const uint16_t* smap;  // compact: (B, nch, side^2) slot of each delta key, 0xFFFF none
  int cv16, rcv16, batch, nby, nbx, f, cur, h, w, r, store_r, r2, ssd;
  int k_slots, nch, chunk;  // compact: K, chunks a frame, parents a chunk
  int step0, nsteps;    // the span: colour index of its first step, its steps
  float lam[kMaxSweeps];  // lambda x multiplier of each sweep the span touches
  const int* row0_b;    // tiles: (B,) the frame's grid row of each entry's row 0; null: whole frames
  const int2* ghost;    // tiles: (B, 2, nbx) the grid rows just above and below each tile
  int nby_total, full_h;  // the frame's grid rows and pixel rows (nby, h for whole frames)
  const int* col0_b;    // 2-D tiles: (B,) the frame's grid column of each entry's column 0
  const int2* ghost_cols;  // 2-D tiles: (B, 2, nby + 2) the grid columns left and right, rows -1 .. nby
  int nbx_total, full_w;  // the frame's grid columns and pixel columns (nbx, w unless 2-D tiles)
};

// sum of |a - b| over the four bytes, plus c: VABSDIFF4.U8.ACC
__device__ __forceinline__ uint32_t sad_all(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t word_cost(uint32_t a, uint32_t v, uint32_t acc, int ssd) {
  if (ssd) {
    const uint32_t ad = __vabsdiffu4(a, v);
    return __dp4a(ad, ad, acc);
  }
  return sad_all(a, v, acc);
}

// E, F, 11/12, D/D'/8/9, 10; the codes kernels/rounds.py FORMS passes
enum Form { kHybrid = 0, kTail = 1, kFused = 2, kStored = 3, kCompact = 4 };
constexpr uint32_t kNoSlot = 0xffffu;  // a delta key no slot of the chunk holds

// whether a form recomputes costs from window pixels (reads frame 1)
__host__ __device__ constexpr bool recomputes(Form f) { return f != kStored && f != kCompact; }

// a stored cost: a u16 or i32 volume entry, widened to int
__device__ __forceinline__ int volume_entry(const void* vol, int is16, size_t o) {
  return is16 ? static_cast<int>(__ldg(static_cast<const uint16_t*>(vol) + o))
              : __ldg(static_cast<const int*>(vol) + o);
}

struct Tiles {
  int mc, nc, tx, per_frame;
};

__device__ __forceinline__ Tiles tiles_of(int nby, int nbx, int ci, int cj) {
  Tiles t;
  t.mc = (nby - ci + 1) / 2;
  t.nc = (nbx - cj + 1) / 2;
  t.tx = (t.nc + kTileW - 1) / kTileW;
  t.per_frame = ((t.mc + kTileR - 1) / kTileR) * t.tx;
  return t;
}

// The cur = 2 recomputes of one cell, each the block's packed rows av
// against two 2-byte window rows: every load of all of them is issued
// before any is used, so the cell waits one round trip, not one each.
__device__ __forceinline__ void recompute2(uint32_t redo, const uintptr_t (&vk)[9],
                                           const int (&wsk)[9], uint32_t av, int ssd,
                                           int (&cost)[9]) {
  uint32_t lo[9][2], hi[9][2];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const uintptr_t p = vk[k] + static_cast<uintptr_t>(y * wsk[k]);
      const uint32_t* al = reinterpret_cast<const uint32_t*>(p & ~static_cast<uintptr_t>(3));
      lo[k][y] = (redo >> k) & 1 ? __ldg(al) : 0u;
      hi[k][y] = ((redo >> k) & 1) && (p & 3) == 3 ? __ldg(al + 1) : 0u;
    }
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (!((redo >> k) & 1)) continue;
    uint32_t vv = 0;
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const uint32_t s = static_cast<uint32_t>((vk[k] + y * wsk[k]) & 3);
      vv |= (__funnelshift_r(lo[k][y], hi[k][y], 8 * s) & 0xffffu) << (16 * y);
    }
    cost[k] = static_cast<int>(word_cost(av, vv, 0u, ssd));
  }
}

// Lanes that share one recompute at CUR (0: any cur >= 32): a cur x cur
// block is cur^2 / 4 words.
template <int CUR>
__host__ __device__ constexpr int group_lanes() {
  return CUR == 4 ? 4 : CUR == 8 ? 16 : 32;
}

// Lane sub's share, of a group of G, of the cost of frame-1 block a (pitch
// w, rows 4-byte aligned: the entry point checks) against window pixels v
// (pitch ws, any alignment): words sub, sub + G, ... of the block's cur^2/4,
// each a funnel shift of two aligned loads (the second only when the row
// is not aligned, so no load leaves the row).
template <int CUR, int G>
__device__ __forceinline__ uint32_t share_cost(const uint8_t* __restrict__ a, int w,
                                               const uint8_t* __restrict__ v, int ws, int cur,
                                               int sub, int ssd) {
  const int nwr = (CUR > 0 ? CUR : cur) >> 2;  // words a row
  const int nwt = (CUR > 0 ? CUR : cur) * nwr;
  uint32_t acc = 0;
#pragma unroll
  for (int id = sub; id < nwt; id += G) {
    const int y = id / nwr;
    const int x = id - y * nwr;
    const uint8_t* p = v + y * ws + 4 * x;
    const uint32_t s = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) & 3);
    const uint32_t* al = reinterpret_cast<const uint32_t*>(p - s);
    const uint32_t lo = __ldg(al);
    const uint32_t hi = s != 0 ? __ldg(al + 1) : 0u;
    acc = word_cost(__ldg(reinterpret_cast<const uint32_t*>(a + y * w) + x),
                    __funnelshift_r(lo, hi, 8 * s), acc, ssd);
  }
  return acc;
}

// The position of the (n + 1)-th set bit of m, or -1.
__device__ __forceinline__ int nth_set(uint32_t m, int n) {
  if (__popc(m) <= n) return -1;
  int pos = 0;  // the largest pos with fewer than n + 1 set bits below it
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__popc(m & ((1u << (pos + step)) - 1)) <= n) pos += step;
  }
  return pos;
}

// The recomputes of a warp's cells, shared out across its lanes: for each
// candidate slot k, the lanes whose cell needs candidate k recomputed
// (bit k of redo) are the owners of a task each, and groups of G lanes take
// 32 / G tasks at a time (the owner's window pointer, pitch and block
// shuffled to its group, the group's partial sums reduced by shuffles and
// the sum shuffled back).  A lane with several recomputes no longer holds
// up its warp for each in turn.  Every lane of the warp calls this.
template <int CUR>
__device__ __forceinline__ void recompute_warp(uint32_t redo, const uintptr_t (&vk)[9],
                                               const int (&wsk)[9], uintptr_t blk, int w,
                                               int cur, int ssd, int (&cost)[9]) {
  constexpr int G = group_lanes<CUR>();
  constexpr int T = 32 / G;  // tasks a pass
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int sub = lane % G;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    uint32_t m = __ballot_sync(kAll, (redo >> k) & 1);
    while (m != 0) {
      const int owner = nth_set(m, lane / G);
      const int src = owner >= 0 ? owner : lane;
      const uintptr_t v = __shfl_sync(kAll, static_cast<unsigned long long>(vk[k]), src);
      const int ws = __shfl_sync(kAll, wsk[k], src);
      const uintptr_t a = __shfl_sync(kAll, static_cast<unsigned long long>(blk), src);
      uint32_t part = 0;
      if (owner >= 0) {
        part = share_cost<CUR, G>(reinterpret_cast<const uint8_t*>(a), w,
                                  reinterpret_cast<const uint8_t*>(v), ws, cur, sub, ssd);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) part += __shfl_xor_sync(kAll, part, off);
      const int rank = __popc(m & ((1u << lane) - 1));
      const bool mine = ((m >> lane) & 1) && rank < T;
      const uint32_t sum = __shfl_sync(kAll, part, mine ? rank * G : lane);
      if (mine) cost[k] = static_cast<int>(sum);
      const int next = nth_set(m, T);  // the first task of the next pass
      m = next < 0 ? 0u : m & ~((1u << next) - 1);
    }
  }
}

// A cell of a tile: entry b, local grid cell (i, j), its place (ly, lx) in
// the staged halo, the first parent row and column staged, and the entry's
// first grid row and column in its frame.
struct CellAt {
  int b, i, j, ly, lx, pr0, pc0, r0, c0;  // r0, c0: the frame's grid row, column of (0, 0)
};

// One cell's colour step: the 9 candidates from the staged halo, every
// stored cost loaded at once, then the recomputes, then the reference's
// _finish_step (presence, the border-case tie-break ranks, the in-image
// mask, energy = cost + lam * smoothness in f32 with separate, correctly
// rounded multiply and add, FLT_MAX where not usable, the lexicographic
// (energy, rank) winner), with presence and usability as bit masks and the
// winner tracked as it is found.
template <Form kForm, int CUR, bool kStrips>
__device__ __forceinline__ void cell_step(const RoundArgs& a, int2 (*s_mv)[kHaloC],
                                          const int2* s_pm, const int2* s_rpm,
                                          const int* s_rank, const CellAt at, bool valid,
                                          float lam) {
  const int cur = CUR > 0 ? CUR : a.cur;
  const int i = at.i;
  const int j = at.j;
  // the cell's row and column in its frame, the frame's rows, columns,
  // height and width (whole frames read the fields they read before tiles)
  const int gi0 = i + at.r0;
  const int gj0 = j + at.c0;
  const int nby_t = kStrips ? a.nby_total : a.nby;
  const int nbx_t = kStrips ? a.nbx_total : a.nbx;
  const int full_h = kStrips ? a.full_h : a.h;
  const int full_w = kStrips ? a.full_w : a.w;
  const int* rank = s_rank + border_case(gi0, gj0, nby_t, nbx_t) * 9;
  int cx[9], cy[9];
  uint32_t present = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int2 mv = s_mv[at.ly + kSlotDy[k]][at.lx + kSlotDx[k]];
    const int gi = gi0 + kSlotDy[k];
    const int gj = gj0 + kSlotDx[k];
    cx[k] = mv.x;
    cy[k] = mv.y;
    if (valid && rank[k] < kBigRank && gi >= 0 && gi < nby_t && gj >= 0 && gj < nbx_t) {
      present |= 1u << k;
    }
  }
  const int pi = i / a.f;
  const int pj = j / a.f;
  const int ps = (pi - at.pr0) * kParC + pj - at.pc0;
  const int2 pmv = s_pm[ps];
  const bool rival = a.rpm != nullptr;
  const int2 rpmv = rival ? s_rpm[ps] : make_int2(0, 0);
  const int cr = kForm == kTail ? a.store_r : a.r;  // stored dx radius
  // stored: the main volume (or band) holds the cost; rstored: the rival
  // volume (kStored); in_main: recomputed against the main window
  uint32_t usable = 0, stored = 0, in_main = 0, rstored = 0;
  // a delta plane holds < 2^31 entries; offsets into a volume in 64 bits (a
  // search-centred cur = 2 volume at B=8 holds ~5.7 G)
  const int plane = a.nby * a.nbx;
  const int cell = i * a.nbx + j;
  int cost[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) cost[k] = 0;
  if constexpr (kForm == kCompact) {
    // each candidate's slot in its chunk's list (kNoSlot where none), every
    // map read at once, then the table entry of each usable one's slot
    const int side = 2 * a.r + 1;
    const int p = pi * (a.nbx / a.f) + pj;  // the parent in its frame
    const uint16_t* map =
        a.smap + (static_cast<size_t>(at.b) * a.nch + p / a.chunk) * (side * side);
    uint32_t slot[9], covered = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int ddx = cx[k] - pmv.x;
      const int ddy = cy[k] - pmv.y;
      const bool in_window = ddx >= -a.r && ddx <= a.r && ddy >= -a.r && ddy <= a.r;
      slot[k] = valid && in_window ? __ldg(map + (ddy + a.r) * side + ddx + a.r) : kNoSlot;
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) covered |= static_cast<uint32_t>(slot[k] != kNoSlot) << k;
    if (!(covered & 1)) covered = 0;  // the own MV in no slot: every candidate excluded
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (((present & covered) >> k) & 1 && in_image(gi0, gj0, cur, full_h, full_w, cx[k], cy[k])) {
        usable |= 1u << k;
      }
    }
    stored = usable;
    const size_t frame = static_cast<size_t>(at.b) * a.k_slots;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if ((usable >> k) & 1) {
        cost[k] = volume_entry(a.cv, a.cv16, (frame + slot[k]) * plane + cell);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 9 && kForm != kCompact; ++k) {
    const int ddx = cx[k] - pmv.x;
    const int ddy = cy[k] - pmv.y;
    const bool in_window = ddx >= -a.r && ddx <= a.r && ddy >= -a.r && ddy <= a.r;
    const int rdx = cx[k] - rpmv.x;
    const int rdy = cy[k] - rpmv.y;
    const bool in_rival = rival && rdx >= -a.r2 && rdx <= a.r2 && rdy >= -a.r2 && rdy <= a.r2;
    if (((present >> k) & 1) && (in_window || in_rival) &&
        in_image(gi0, gj0, cur, full_h, full_w, cx[k], cy[k])) {
      usable |= 1u << k;
      if (kForm != kFused && in_window && ddx >= -cr && ddx <= cr) {
        stored |= 1u << k;
      } else if (in_window) {
        in_main |= 1u << k;
      } else if (kForm == kStored) {
        rstored |= 1u << k;
      }
    }
  }
  // every stored cost at once
  if constexpr (kForm == kStored) {
    // own window first, then the rival's: u16 or i32 each, widened
    const int side = 2 * a.r + 1;
    const int rside = 2 * a.r2 + 1;
    const size_t frame = static_cast<size_t>(at.b) * side * side * plane + cell;
    const size_t rframe = static_cast<size_t>(at.b) * rside * rside * plane + cell;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const bool own = (stored >> k) & 1;
      const int key = own ? (cy[k] - pmv.y + a.r) * side + (cx[k] - pmv.x + a.r)
                          : (cy[k] - rpmv.y + a.r2) * rside + (cx[k] - rpmv.x + a.r2);
      if (((stored | rstored) >> k) & 1) {
        cost[k] = volume_entry(own ? a.cv : a.rcv, own ? a.cv16 : a.rcv16,
                               (own ? frame : rframe) + static_cast<size_t>(key) * plane);
      }
    }
  } else if constexpr (kForm != kFused && kForm != kCompact) {
    const int side = 2 * a.r + 1;
    const int side_st = kForm == kTail ? 2 * a.store_r + 1 : side;
    const size_t frame = static_cast<size_t>(at.b) * side * side_st * plane + cell;
    if (a.cv16) {
      const uint16_t* vol = static_cast<const uint16_t*>(a.cv) + frame;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int key = (cy[k] - pmv.y + a.r) * side_st + (cx[k] - pmv.x + cr);
        if ((stored >> k) & 1) cost[k] = __ldg(vol + static_cast<size_t>(key) * plane);
      }
    } else {
      const int* vol = static_cast<const int*>(a.cv) + frame;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int key = (cy[k] - pmv.y + a.r) * side_st + (cx[k] - pmv.x + cr);
        if ((stored >> k) & 1) cost[k] = __ldg(vol + static_cast<size_t>(key) * plane);
      }
    }
  }
  // the recomputes (none in the stored and compact forms): the main window
  // (F beyond the band, 11/12 always) or the rival window; at cur >= 4
  // shared out across the warp
  const uint32_t redo = usable & ~stored;
  if (recomputes(kForm) && (CUR == 2 ? redo != 0 : __any_sync(0xffffffffu, redo != 0))) {
    const int bs = a.f * cur;
    const int oy = (i - pi * a.f) * cur;  // the sub-block in its parent
    const int ox = (j - pj * a.f) * cur;
    const size_t p = static_cast<size_t>(at.b) * (a.nby / a.f) * (a.nbx / a.f) +
                     pi * (a.nbx / a.f) + pj;  // b * nP + parent
    const int ws = bs + 2 * a.r;
    const int rws = bs + 2 * a.r2;
    const uintptr_t wmain = reinterpret_cast<uintptr_t>(a.win) +
                            (p * ws + a.r + oy) * ws + a.r + ox;
    const uintptr_t wriv = reinterpret_cast<uintptr_t>(a.rwin) +
                           (p * rws + a.r2 + oy) * rws + a.r2 + ox;
    uintptr_t vk[9];
    int wsk[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const bool m = (in_main >> k) & 1;
      vk[k] = m ? wmain + static_cast<intptr_t>((cy[k] - pmv.y) * ws + (cx[k] - pmv.x))
                : wriv + static_cast<intptr_t>((cy[k] - rpmv.y) * rws + (cx[k] - rpmv.x));
      wsk[k] = m ? ws : rws;
    }
    const uint8_t* blk = a.im1 + (static_cast<size_t>(at.b) * a.h + i * cur) * a.w + j * cur;
    if constexpr (CUR == 2) {
      const uint32_t av =
          static_cast<uint32_t>(__ldg(reinterpret_cast<const uint16_t*>(blk))) |
          (static_cast<uint32_t>(__ldg(reinterpret_cast<const uint16_t*>(blk + a.w))) << 16);
      recompute2(redo, vk, wsk, av, a.ssd, cost);
    } else {
      recompute_warp<CUR>(redo, vk, wsk, reinterpret_cast<uintptr_t>(blk), a.w, cur, a.ssd,
                          cost);
    }
  }
  // energy = cost + lam * smoothness (f32, separately rounded), FLT_MAX
  // where not usable; the lexicographic (energy, rank) winner
  // smooth[k] = sum over present q of |cx[k] - cx[q]| + |cy[k] - cy[q]|
  // (an integer: the order of the sum does not matter), each pair once
  int smooth[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) smooth[k] = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int q = k + 1; q < 9; ++q) {
      const int d = abs(cx[k] - cx[q]) + abs(cy[k] - cy[q]);
      if ((present >> q) & 1) smooth[k] += d;
      if ((present >> k) & 1) smooth[q] += d;
    }
  }
  float best_e = 0.0f;
  int best_r = 0, best_x = 0, best_y = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float e = ((usable >> k) & 1) ? __fadd_rn(__int2float_rn(cost[k]),
                                                    __fmul_rn(lam, __int2float_rn(smooth[k])))
                                        : FLT_MAX;
    const int rk = rank[k];
    if (k == 0 || e < best_e || (e == best_e && rk < best_r)) {
      best_e = e;
      best_r = rk;
      best_x = cx[k];
      best_y = cy[k];
    }
  }
  if (valid) {
    reinterpret_cast<int2*>(a.grid)[(static_cast<size_t>(at.b) * a.nby + i) * a.nbx + j] =
        make_int2(best_x, best_y);
  }
}

// One tile of a step: frame b, tile (ty, tx) of the colour's cells, its
// halo's top-left grid cell (gi0, gj0) and its parents (npr x npc from
// (pr0, pc0)).
struct TileAt {
  int b, ty, tx, gi0, gj0, pr0, pc0, npr, npc;
};

__device__ __forceinline__ TileAt tile_at(int t, const Tiles& tl, int ci, int cj, int f,
                                          int npy, int npx) {
  TileAt T;
  T.b = t / tl.per_frame;
  const int tr = t - T.b * tl.per_frame;
  T.ty = tr / tl.tx;
  T.tx = tr - T.ty * tl.tx;
  T.gi0 = ci + 2 * kTileR * T.ty - 1;
  T.gj0 = cj + 2 * kTileW * T.tx - 1;
  T.pr0 = (T.gi0 + 1) / f;
  T.pc0 = (T.gj0 + 1) / f;
  T.npr = min(npy - 1, (T.gi0 + 1 + 2 * (kTileR - 1)) / f) - T.pr0 + 1;
  T.npc = min(npx - 1, (T.gj0 + 1 + 2 * (kTileW - 1)) / f) - T.pc0 + 1;
  return T;
}

__device__ __forceinline__ int2 parent_of(const int* centres, const TileAt& T, int e, int npy,
                                          int npx) {
  const int y = e / T.npc;
  const int x = e - y * T.npc;
  return __ldg(reinterpret_cast<const int2*>(centres) + (T.b * npy + T.pr0 + y) * npx + T.pc0 + x);
}

// Stage a tile: its halo of MVs (read past L1, ld.global.cg: other SMs
// wrote the grid in the previous step; a tiled entry's rows -1 and nby from
// its ghost rows, and on 2-D tiles its columns -1 and nbx, corners
// included, from its ghost columns) and its parents' window centres.
template <bool kStrips>
__device__ __forceinline__ void stage(const RoundArgs& a, const TileAt& T, int2 (*s_mv)[kHaloC],
                                      int2* s_pm, int2* s_rpm) {
  const int2* grid = reinterpret_cast<const int2*>(a.grid) +
                     static_cast<size_t>(T.b) * a.nby * a.nbx;
  // every load of the thread's share first, then the stores: one round
  // trip to L2 a tile, not one an entry
  constexpr int kHaloPer = (kHaloR * kHaloC + kThreads - 1) / kThreads;
  int2 mv[kHaloPer];
#pragma unroll
  for (int m = 0; m < kHaloPer; ++m) {
    const int e = threadIdx.x + m * kThreads;
    const int y = e / kHaloC;
    const int gi = T.gi0 + y;
    const int gj = T.gj0 + e - y * kHaloC;
    mv[m] = make_int2(0, 0);
    if (e < kHaloR * kHaloC && gi >= 0 && gi < a.nby && gj >= 0 && gj < a.nbx) {
      mv[m] = __ldcg(grid + gi * a.nbx + gj);
    } else if constexpr (kStrips) {
      if (e < kHaloR * kHaloC && gj >= 0 && gj < a.nbx && (gi == -1 || gi == a.nby)) {
        mv[m] = __ldcg(a.ghost + (static_cast<size_t>(T.b) * 2 + (gi < 0 ? 0 : 1)) * a.nbx + gj);
      } else if (e < kHaloR * kHaloC && a.ghost_cols != nullptr && (gj == -1 || gj == a.nbx) &&
                 gi >= -1 && gi <= a.nby) {
        mv[m] = __ldcg(a.ghost_cols + (static_cast<size_t>(T.b) * 2 + (gj < 0 ? 0 : 1)) *
                                          (a.nby + 2) + gi + 1);
      }
    }
  }
  const bool rival = a.rpm != nullptr;
  const int npy = a.nby / a.f;
  const int npx = a.nbx / a.f;
  constexpr int kParPer = 2;  // f >= 2: at most 9 x 33 parents; f = 1 loops on
  int2 pm[kParPer], rpm[kParPer];
#pragma unroll
  for (int m = 0; m < kParPer; ++m) {
    const int e = threadIdx.x + m * kThreads;
    if (e < T.npr * T.npc) {
      pm[m] = parent_of(a.pm, T, e, npy, npx);
      if (rival) rpm[m] = parent_of(a.rpm, T, e, npy, npx);
    }
  }
#pragma unroll
  for (int m = 0; m < kHaloPer; ++m) {
    const int e = threadIdx.x + m * kThreads;
    if (e < kHaloR * kHaloC) s_mv[e / kHaloC][e % kHaloC] = mv[m];
  }
#pragma unroll
  for (int m = 0; m < kParPer; ++m) {
    const int e = threadIdx.x + m * kThreads;
    if (e < T.npr * T.npc) {
      const int slot = (e / T.npc) * kParC + e % T.npc;
      s_pm[slot] = pm[m];
      if (rival) s_rpm[slot] = rpm[m];
    }
  }
  for (int e = threadIdx.x + kParPer * kThreads; e < T.npr * T.npc; e += kThreads) {
    const int slot = (e / T.npc) * kParC + e % T.npc;
    s_pm[slot] = parent_of(a.pm, T, e, npy, npx);
    if (rival) s_rpm[slot] = parent_of(a.rpm, T, e, npy, npx);
  }
}

// Blocks an SM holds at once for a cur: the cur = 2 steps need fewer
// registers (no shared recomputes) and gain from more warps.
__host__ __device__ constexpr int min_blocks(int cur) { return cur == 2 ? 3 : 2; }

// kStrips: the entries are tiles (row0_b and ghost given; on 2-D tiles also
// col0_b and ghost_cols); a separate instantiation, so whole frames run the
// code they ran before tiles.
template <Form kForm, int CUR, bool kStrips>
__global__ void __launch_bounds__(kThreads, min_blocks(CUR)) round_kernel(const RoundArgs a) {
  __shared__ int2 s_mv[kHaloR][kHaloC];
  __shared__ int2 s_pm[kParR * kParC];
  __shared__ int2 s_rpm[kParR * kParC];
  __shared__ int s_rank[81];
  const int lane = threadIdx.x % kTileW;
  const int row = threadIdx.x / kTileW;
  for (int t = threadIdx.x; t < 81; t += kThreads) s_rank[t] = a.rank_table[t];
  const int npy = a.nby / a.f;
  const int npx = a.nbx / a.f;
  cg::grid_group gg = cg::this_grid();

  for (int s = 0; s < a.nsteps; ++s) {
    const int g = a.step0 + s;
    const int ci = (g >> 1) & 1;
    const int cj = g & 1;
    float lam = a.lam[0];  // a.lam[g >> 2], without a local copy of the array
#pragma unroll
    for (int q = 1; q < kMaxSweeps; ++q) lam = (g >> 2) == q ? a.lam[q] : lam;
    // tiles: an entry's local colour row is (ci + its first row) % 2 and
    // its local colour column (cj + its first column) % 2, so every entry
    // gets the tiles of the larger counts (local row and column 0)
    const Tiles tl = tiles_of(a.nby, a.nbx, kStrips ? 0 : ci, kStrips ? 0 : cj);
    const int ntiles = a.batch * tl.per_frame;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int r0 = kStrips ? __ldg(a.row0_b + t / tl.per_frame) : 0;
      const int c0 = kStrips && a.col0_b != nullptr ? __ldg(a.col0_b + t / tl.per_frame) : 0;
      const int lci = kStrips ? (ci + r0) & 1 : ci;
      const int lcj = kStrips ? (cj + c0) & 1 : cj;
      const int mc = kStrips ? (a.nby - lci + 1) / 2 : tl.mc;
      const int nc = kStrips ? (a.nbx - lcj + 1) / 2 : tl.nc;
      const TileAt T = tile_at(t, tl, lci, lcj, a.f, npy, npx);
      __syncthreads();  // the previous tile's readers are done
      stage<kStrips>(a, T, s_mv, s_pm, s_rpm);
      __syncthreads();
      // every lane of a warp takes part (the recomputes are shared out
      // across the warp); lanes past the colour's cells write nothing
      const int ii = kTileR * T.ty + row;
      const int jj = kTileW * T.tx + lane;
      const bool valid = ii < mc && jj < nc;
      const CellAt at{T.b, lci + 2 * ii, lcj + 2 * jj, 2 * row + 1, 2 * lane + 1, T.pr0, T.pc0,
                      r0, c0};
      cell_step<kForm, CUR, kStrips>(a, s_mv, s_pm, s_rpm, s_rank, at, valid, lam);
    }
    if (s + 1 < a.nsteps) gg.sync();  // the step's writes, visible to the next
  }
}

// The blocks one cooperative launch may hold on this device (cached per
// device and instantiation).
template <Form kForm, int CUR, bool kStrips>
int resident_blocks(int* out) {
  static int cached[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0, coop = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, round_kernel<kForm, CUR, kStrips>,
                                                      kThreads, 0);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop || per_sm * sms <= 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    cached[dev] = per_sm * sms;
  }
  *out = cached[dev];
  return 0;
}

// Checks shared by every form; fills the span.  lams: n_lam values;
// reads_im1: the form reads frame-1 blocks (all but the stored and compact
// ones).
int prepare(RoundArgs& a, bool reads_im1, int step0, int nsteps, const float* lams, int n_lam) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.f < 1 || a.cur < 2 || (a.cur & (a.cur - 1)) || a.nby % a.f || a.nbx % a.f) return bad;
  if (a.nby != a.h / a.cur || a.nbx != a.w / a.cur || a.r < 0 || a.r2 < 0) return bad;
  if (a.full_h % a.cur || a.nby_total != a.full_h / a.cur || a.nby_total < a.nby) return bad;
  if (a.full_w % a.cur || a.nbx_total != a.full_w / a.cur || a.nbx_total < a.nbx) return bad;
  if (static_cast<long long>(a.nby_total) * a.nbx_total * 2 >= (1LL << 31) ||
      static_cast<long long>(a.full_h) * a.full_w >= (1LL << 31)) {
    return bad;  // indices inside a frame are 32-bit
  }
  // the recompute's frame-1 words: rows aligned to 4 bytes (2 at cur = 2)
  const int align = a.cur >= 4 ? 4 : 2;
  if (reads_im1 && (a.w % align || reinterpret_cast<uintptr_t>(a.im1) % align)) return bad;
  if (step0 < 0 || step0 > 3 || nsteps < 1 || n_lam < 1 || n_lam > kMaxSweeps ||
      (step0 + nsteps - 1) / 4 >= n_lam) {
    return bad;
  }
  a.step0 = step0;
  a.nsteps = nsteps;
  for (int q = 0; q < kMaxSweeps; ++q) a.lam[q] = q < n_lam ? lams[q] : 0.0f;
  return 0;
}

template <Form kForm, int CUR, bool kStrips>
int launch_cur(RoundArgs& a, void* stream) {
  // colour (0, 0) has the most tiles
  const long long tiles =
      static_cast<long long>(a.batch) *
      ((((a.nby + 1) / 2) + kTileR - 1) / kTileR) * ((((a.nbx + 1) / 2) + kTileW - 1) / kTileW);
  if (tiles == 0) return 0;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const int code = resident_blocks<kForm, CUR, kStrips>(&resident);
  if (code != 0) return code;
  const unsigned blocks = static_cast<unsigned>(tiles < resident ? tiles : resident);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(round_kernel<kForm, CUR, kStrips>,
                                                    dim3(blocks), dim3(kThreads), params, 0,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch is not sticky; clear it
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// Tiles or whole frames (the compact form takes no tiles).
template <Form kForm, int CUR>
int launch_strips(RoundArgs& a, void* stream) {
  if constexpr (kForm != kCompact) {
    if (a.row0_b != nullptr) return launch_cur<kForm, CUR, true>(a, stream);
  }
  return launch_cur<kForm, CUR, false>(a, stream);
}

// One cooperative launch of the span; the kernel is instantiated for cur 2,
// 4, 8 and 16 (the rounds E, F, 11, 12 and D' run) and for any other cur
// (D's cur = bs rounds at 32 and beyond).
template <Form kForm>
int launch(RoundArgs& a, int step0, int nsteps, const float* lams, int n_lam, void* stream) {
  const int code = prepare(a, recomputes(kForm), step0, nsteps, lams, n_lam);
  if (code != 0) return code;
  switch (a.cur) {
    case 2: return launch_strips<kForm, 2>(a, stream);
    case 4: return launch_strips<kForm, 4>(a, stream);
    case 8: return launch_strips<kForm, 8>(a, stream);
    case 16: return launch_strips<kForm, 16>(a, stream);
    default: return launch_strips<kForm, 0>(a, stream);
  }
}

RoundArgs args_of(void* grid, const void* cv, int cv16, const void* im1, const void* win,
                  const void* rwin, const void* pm, const void* rpm, const void* rank_table,
                  int batch, int nby, int nbx, int f, int cur, int h, int w, int r,
                  int store_r, int r2, int ssd) {
  RoundArgs a{};
  a.grid = static_cast<int*>(grid);
  a.cv = cv;
  a.im1 = static_cast<const uint8_t*>(im1);
  a.win = static_cast<const uint8_t*>(win);
  a.rwin = static_cast<const uint8_t*>(rwin);
  a.pm = static_cast<const int*>(pm);
  a.rpm = static_cast<const int*>(rpm);
  a.rank_table = static_cast<const int*>(rank_table);
  a.cv16 = cv16;
  a.batch = batch;
  a.nby = nby;
  a.nbx = nbx;
  a.f = f;
  a.cur = cur;
  a.h = h;
  a.w = w;
  a.r = r;
  a.store_r = store_r;
  a.r2 = r2;
  a.ssd = ssd;
  a.nby_total = nby;
  a.full_h = h;
  a.nbx_total = nbx;
  a.full_w = w;
  return a;
}

// A launch's tiles: row0_b (B,) i32 and ghost (B, 2, nbx, 2) i32 both
// given, or both null (whole frames); full_h the frame's height in pixels
// (h for whole frames); on 2-D tiles col0_b (B,) i32 and ghost_cols (B, 2,
// nby + 2, 2) i32 given as well, else both null and full_w = w.  0 or an
// error.
int strip_args(RoundArgs& a, const void* row0_b, const void* ghost, int full_h,
               const void* col0_b, const void* ghost_cols, int full_w) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((row0_b == nullptr) != (ghost == nullptr)) return bad;
  if ((col0_b == nullptr) != (ghost_cols == nullptr)) return bad;
  if (row0_b == nullptr && (full_h != a.h || col0_b != nullptr)) return bad;
  if (col0_b == nullptr && full_w != a.w) return bad;
  if (a.cur < 1) return bad;
  a.row0_b = static_cast<const int*>(row0_b);
  a.ghost = static_cast<const int2*>(ghost);
  a.full_h = full_h;
  a.nby_total = full_h / a.cur;
  a.col0_b = static_cast<const int*>(col0_b);
  a.ghost_cols = static_cast<const int2*>(ghost_cols);
  a.full_w = full_w;
  a.nbx_total = full_w / a.cur;
  return 0;
}

// The compact form's arguments (kernel 10): the table in cv, the slot map,
// K slots a chunk of `chunk` parents, nch chunks a frame; 0 or an error.
int compact_args(RoundArgs& a, const void* smap, int k_slots, int nch, int chunk) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.f < 1 || chunk < 1 || k_slots < 1 || k_slots >= static_cast<int>(kNoSlot)) return bad;
  if (nch != ((a.nby / a.f) * (a.nbx / a.f) + chunk - 1) / chunk) return bad;
  a.smap = static_cast<const uint16_t*>(smap);
  a.k_slots = k_slots;
  a.nch = nch;
  a.chunk = chunk;
  return 0;
}

}  // namespace

// The round kernel's one entry point: a span of steps of one round of
// form `form` (enum Form: 0 E, 1 F, 2 11 and 12, 3 D, D', 8 and 9, 4 10),
// one cooperative launch.  Every pointer any form reads is an argument;
// a form that takes none is passed null (and 0 for its ints):
//   grid: (B, nby, nbx, 2) i32, updated in place;
//   cv: the stored costs at cur, u16 (cv16) or i32: E and the stored form
//     (B, side^2, nby, nbx), F the band (B, side * (2 store_r + 1), nby,
//     nbx), 10 the table (B, K, nby, nbx); 11 and 12 null;
//   rcv (rcv16): the stored form's rival volume (B, side2^2, nby, nbx), or
//     null without rival windows;
//   im1: (B, h, w) u8 frame 1 (E, F, 11, 12); win: (B, nP, bs + 2r,
//     bs + 2r) u8 main windows (F, 11, 12); rwin: (B, nP, bs + 2 r2,
//     bs + 2 r2) u8 rival windows (E, F, 12);
//   pm / rpm: (B, nby/f, nbx/f, 2) i32 window centres, rpm null without
//     rival windows; rank_table: (9, 9) i32;
//   smap (10): (B, nch, (2r + 1)^2) u16, the slot of each delta key in the
//     list of each chunk of `chunk` parents (0xFFFF: none), k_slots K;
//   store_r: F's band radius (read by F only); ssd: 1 for SSD (the forms
//     that recompute);
//   tiles: row0_b (B,) i32 and ghost (B, 2, nbx, 2) i32 and the frame's
//     height full_h, or null, null and h; on 2-D tiles col0_b (B,) i32,
//     ghost_cols (B, 2, nby + 2, 2) i32 and the frame's width full_w, else
//     null, null and w (see the top of this file; 10 takes none);
//   the span: step0 the colour index of its first step, nsteps its steps,
//     lams (host memory) the n_lam (1 .. 8) f32 multipliers of the sweeps
//     it touches.  A single colour step (ci, cj) is (2 ci + cj, 1, {lam},
//     1); a round of nsweeps sweeps (0, 4 nsweeps, lams, nsweeps).
// 0 or a CUDA error code.
extern "C" int bbme_round(int form, void* grid, const void* cv, int cv16, const void* rcv,
                          int rcv16, const void* im1, const void* win, const void* rwin,
                          const void* pm, const void* rpm, const void* rank_table,
                          const void* smap, int batch, int nby, int nbx, int f, int cur, int h,
                          int w, int r, int store_r, int r2, int ssd, int k_slots, int nch,
                          int chunk, const void* row0_b, const void* ghost, int full_h,
                          const void* col0_b, const void* ghost_cols, int full_w, int step0,
                          int nsteps, const float* lams, int n_lam, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (form < kHybrid || form > kCompact) return bad;
  const Form kind = static_cast<Form>(form);
  if (kind == kTail && (store_r < 0 || store_r > r)) return bad;
  // the rival centres go with the rival volume (stored), the rival windows
  // (the forms that recompute) and nothing in the compact form
  const void* rival = kind == kStored ? rcv : kind == kCompact ? nullptr : rwin;
  if ((rival == nullptr) != (rpm == nullptr)) return bad;
  if (kind == kCompact && (row0_b != nullptr || col0_b != nullptr)) return bad;
  RoundArgs a = args_of(grid, cv, cv16, im1, win, rwin, pm, rpm, rank_table, batch, nby, nbx, f,
                        cur, h, w, r, kind == kTail ? store_r : -1, r2, ssd);
  a.rcv = rcv;
  a.rcv16 = rcv16;
  int code = strip_args(a, row0_b, ghost, full_h, col0_b, ghost_cols, full_w);
  if (code == 0 && kind == kCompact) code = compact_args(a, smap, k_slots, nch, chunk);
  if (code != 0) return code;
  switch (kind) {
    case kHybrid: return launch<kHybrid>(a, step0, nsteps, lams, n_lam, stream);
    case kTail: return launch<kTail>(a, step0, nsteps, lams, n_lam, stream);
    case kFused: return launch<kFused>(a, step0, nsteps, lams, n_lam, stream);
    case kStored: return launch<kStored>(a, step0, nsteps, lams, n_lam, stream);
    default: return launch<kCompact>(a, step0, nsteps, lams, n_lam, stream);
  }
}
