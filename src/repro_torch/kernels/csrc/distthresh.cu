// Distance-threshold kernels for Hopper (sm_90a), with a plain C interface.
//
// Five kernels share one interval solve, `interval_solve`, the operation
// sequence of `_interval_math` in repro/kernels/distthresh.py (and of
// repro_torch/kernels/ref.py::interval_math).  Built with -fmad=false and
// IEEE division and square root, so no product is fused into an add and
// every rounding falls where the reference's does: the hit sets equal the
// reference's bit for bit, and the MBR prune slack
// (repro_torch/core/index.py::prune_limit) stays valid.
//
// distthresh_compact_kernel  replaces distthresh_compact_pallas
//   (append="chunk", repro/kernels/distthresh.py:536, pallas_call at :640).
//   The CUDA block is decoupled from the logical (cand_blk x qry_blk) tile:
//   each tile is cut into sub-tiles of `sub_rows` entry rows x the tile's
//   columns, at most kSubPairs = 1,024 pairs (sub_rows = 1,024 / columns,
//   from the batch's column count), and one 256-thread block runs each
//   sub-tile (grid: tiles x sub-tiles; blockIdx.y is the sub-tile).  The
//   block stages its entry rows' and the tile's query columns' derived
//   terms (make_side: velocity and anchor once per row and per column) in
//   shared memory.  Thread t solves pairs t, t + 256, ... of the sub-tile's
//   row-major pair list once each and keeps (hit, t_enter, t_exit) in
//   registers; a block exclusive scan of the threads' hit counts (warp
//   shuffles + shared memory) gives each thread's offset, thread 0 claims
//   the block's base with one atomicAdd on `count` (the paper's §5
//   atomic_inc, one per sub-tile rather than one per tile), and the hits
//   are written at base + offset.  Rows past `capacity` are dropped and
//   `count` stays exact; the order of rows changes from run to run.  With
//   the early-out armed, every block of a tile runs the tile's 3-axis box
//   test on the same boxes and a dead tile's blocks exit; only sub-tile 0
//   adds the dead tile to `pruned`, so `pruned` counts logical tiles.
//   At S1's largest batch (7,500 x 100 at 256 x 256 tiles) that is 30
//   tiles x 26 sub-tiles = 780 blocks on 132 SMs, where one block per tile
//   gave 30.
//   Bound: float32 arithmetic on the non-tensor cores, 3 operations per
//   pair and ~45 more per temporally overlapping pair, against 32 bytes
//   per entry and query read once and 16 per hit written.
//   Left on the table: the launch itself and the same-address atomics on
//   `count` (one per sub-tile with hits) set the time at these sizes; the
//   solve's IEEE division and square root are long dependent chains,
//   which 4 pairs per thread overlap only as far as the compiler
//   interleaves them; each sub-tile restages its tile's query columns.
//
// distthresh_compact_live_kernel  replaces distthresh_compact_live_pallas
//   (repro/kernels/distthresh.py:697, pallas_call at :782).  The same
//   sub-tile body with blockIdx.x as the slot of a live-tile list read from
//   device memory (blockIdx.y the sub-tile); slots >= n_live return at
//   once.  Same bound, same gaps.
//
// distthresh_compact_rowloop_kernel  replaces distthresh_compact_pallas
//   (append="rowloop", repro/kernels/distthresh.py:536, pallas_call at :640,
//   body _rowloop_tile_body at :412).  On the TPU the row loop existed to
//   avoid a gather; here it is its own design, a warp per entry row, with
//   the block decoupled from the logical tile as in the chunk kernel: a
//   block of 8 warps takes `rows` = 8 x per_warp consecutive rows of one
//   tile (per_warp rows per warp, chosen so that a block holds about
//   kSubPairs pairs and a warp's rows fit in kRowChunks chunks of 32
//   columns), and the grid is tiles x row blocks (blockIdx.y).  At S1's
//   largest batch (7,500 x 100 at 256 x 256 tiles) that is 30 x 32 = 960
//   blocks, where one block per tile gave 30.  The block stages its rows'
//   and the tile's columns' derived terms in shared memory.  Lane l of a
//   warp solves columns l, l + 32, ... of each of the warp's rows once;
//   one __ballot_sync per (row, 32-column chunk) slot gives the slot's hit
//   mask, kept in registers with the lanes' intervals for the first
//   kRowChunks slots (later slots, only in tiles wider than 256 columns,
//   are solved again in the write pass).  A block exclusive scan of the
//   warps' hit totals gives each warp's offset, thread 0 claims the
//   block's base with one atomicAdd on `count`, and a hit lane writes at
//   base + warp offset + hits of the warp's earlier slots + popc(mask &
//   lanes below).  So each block fills one contiguous run of slots, rows
//   ascending and columns ascending within a row: the row-loop append at
//   block granularity.  Slots past `capacity` are dropped and `count`
//   stays exact; the order of the blocks' runs changes from run to run.
//   The armed variant runs the tile box test in every block of the tile;
//   only row block 0 counts a dead tile in `pruned`.
//   Bound: the chunk kernel's (float32 arithmetic, ~45 operations per
//   temporally overlapping pair).
//   Left on the table: lanes past the last column idle in a row's last
//   chunk (100 columns fill 4 chunks of 32: 22 % of the lanes), and the
//   wrapper's six output fills, which take about as long as the kernel.
//
// distthresh_compact_live_rowloop_kernel  replaces
//   distthresh_compact_live_pallas(append="rowloop") (:697, pallas_call at
//   :782): the same row-block body with blockIdx.x as the slot of a
//   live-tile list (blockIdx.y the row block); slots >= n_live return at
//   once.  Same bound, same gaps; besides, ptxas reports 16 bytes of
//   spills here and none in the tile-grid kernel (likely the tile ids
//   read from the list, which unlike blockIdx cannot be recomputed).
//
// distthresh_dense_kernel  replaces distthresh_pallas
//   (repro/kernels/distthresh.py:214, pallas_call at :242).  A 256-thread
//   block takes a row-major span of the (C, Q) outputs: `rows` entry rows
//   x `cols` = min(Q, 256) query columns, rows = max(1, 1,024 / cols); the
//   grid is row blocks (x) x column blocks (y).  Where Q <= 256 a block's
//   outputs are one contiguous span of each array.  The block stages its
//   columns' and rows' derived terms (make_side once per column and once
//   per row) in shared memory; thread t solves pairs t, t + 256, ... (at
//   most 4) of the block's row-major pair list and writes t_enter, t_exit
//   (0 where there is no hit) and the int8 hit, neighbouring lanes at
//   neighbouring addresses.  Only a block's last round of pairs leaves
//   lanes idle.
//   Bound: the 9 bytes per pair it writes, ~2.7 us per 10^6 pairs at
//   3.35 TB/s.  In practice it is bound by instruction issue: on S1's
//   batches every pair overlaps in time, so each runs the whole solve,
//   whose IEEE divisions and square root are sequences of many
//   instructions with a slow-path check each.
//   Left on the table: the int8 hit stores stay scalar (one byte a lane,
//   32 bytes a warp; 16-byte vector stores of 4 pairs a thread gained
//   nothing on the H100).
//
// distthresh_tile_prep_kernel + distthresh_tile_prep_limit_kernel  replace
//   no pallas_call: they are the device side of the spatial early-out's
//   operands, which the reference builds in jnp (_jit_tile_mbrs and
//   _jit_prune_threshold, repro/kernels/ops.py:194-221) and the port built
//   on the host in numpy on every dispatch.  The first kernel runs one
//   256-thread block per entry tile and per query tile (grid: entry tiles
//   + query tiles) over the resident slices: each thread folds its rows'
//   endpoint boxes (float32 min/max, exact) and its rows' solve magnitudes
//   (solve_scale's per-row term in float64), the block reduces them with
//   warp shuffles, and thread 0 writes the tile's (lo_xyz, hi_xyz, 0, 0)
//   row and the tile's largest magnitude.  The second, one block, takes
//   the largest of those, floors it at 1 and evaluates prune_limit there in
//   float64, then rounds once to float32: the threshold the armed compact
//   kernels read from device memory.  Every float64 operation is an
//   explicitly rounded intrinsic in numpy's order, so d_prune equals
//   np.float32(prune_limit(d, max(solve_scale(entries),
//   solve_scale(queries)))) bit for bit.  No host read, no synchronize.
//   Bound: the bytes of the two slices read once (32 per row).
//   Left on the table: the query slice is read column by column at the
//   batch's row stride; the second launch (one block) exists only to take
//   the maximum across blocks.
//
// Every launch function returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kAEps = 1e-12f;
constexpr float kBEps = 1e-12f;

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

// Per-segment quantities that depend on one side only: velocity and the
// absolute-time anchor p0 - v*ts (the same expressions as the reference,
// evaluated once per row / column instead of once per pair).
struct Side {
  float vx, vy, vz;  // velocity (0 for a zero-length temporal extent)
  float ax, ay, az;  // anchor x0 - vx*ts
  float ts, te;
};

__device__ __forceinline__ Side make_side(float x0, float y0, float z0,
                                          float x1, float y1, float z1,
                                          float ts, float te) {
  Side s;
  float dt = te - ts;
  float safe = dt > 0.0f ? dt : 1.0f;
  float live = dt > 0.0f ? 1.0f : 0.0f;
  s.vx = (x1 - x0) / safe * live;
  s.vy = (y1 - y0) / safe * live;
  s.vz = (z1 - z0) / safe * live;
  s.ax = x0 - s.vx * ts;
  s.ay = y0 - s.vy * ts;
  s.az = z0 - s.vz * ts;
  s.ts = ts;
  s.te = te;
  return s;
}

// The interval solve of one (entry, query) pair; `dd` is d*d in float32.
// Returns hit; writes the interval where it hits.
__device__ __forceinline__ bool interval_solve(const Side& e, const Side& q,
                                               float dd, float* t_enter,
                                               float* t_exit) {
  float lo = fmaxf(e.ts, q.ts);
  float hi = fminf(e.te, q.te);
  if (!(lo <= hi)) return false;
  float dvx = e.vx - q.vx;
  float dvy = e.vy - q.vy;
  float dvz = e.vz - q.vz;
  float drx = e.ax - q.ax;
  float dry = e.ay - q.ay;
  float drz = e.az - q.az;
  float a = dvx * dvx + dvy * dvy + dvz * dvz;
  float b = 2.0f * (drx * dvx + dry * dvy + drz * dvz);
  float c = drx * drx + dry * dry + drz * drz - dd;
  float rlo, rhi;
  if (a > kAEps) {
    float disc = b * b - 4.0f * a * c;
    if (!(disc >= 0.0f)) return false;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    rlo = (-b - sq) / (2.0f * a);
    rhi = (-b + sq) / (2.0f * a);
  } else if (fabsf(b) > kBEps) {
    float root = -c / b;
    rlo = b > 0.0f ? -f_inf() : root;
    rhi = b > 0.0f ? root : f_inf();
  } else {
    if (!(c <= 0.0f)) return false;
    rlo = -f_inf();
    rhi = f_inf();
  }
  float te = fmaxf(rlo, lo);
  float tx = fminf(rhi, hi);
  if (!(te <= tx)) return false;
  *t_enter = te;
  *t_exit = tx;
  return true;
}

__device__ __forceinline__ Side load_entry(const float* __restrict__ entries,
                                           int row) {
  const float* p = entries + (size_t)row * 8;
  return make_side(p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]);
}

// Block exclusive scan of one int per thread (blockDim.x a multiple of 32,
// at most 1024).  Every thread must call it.  Returns the exclusive prefix
// and writes the block total to *total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[nwarps - 1];
  return (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
}

// Store a derived side as column k of an 8-row shared-memory table whose
// rows are `ld` floats apart.
__device__ __forceinline__ void stage_side(float* smem, int ld, int k,
                                           const Side& s) {
  smem[0 * ld + k] = s.vx;
  smem[1 * ld + k] = s.vy;
  smem[2 * ld + k] = s.vz;
  smem[3 * ld + k] = s.ax;
  smem[4 * ld + k] = s.ay;
  smem[5 * ld + k] = s.az;
  smem[6 * ld + k] = s.ts;
  smem[7 * ld + k] = s.te;
}

// Stage query tile tj's columns in shared memory as derived columns
// (velocity, anchor, ts, te; 8 rows of `ld` >= the tile's columns floats)
// and return how many columns are valid.  Every thread of the block must
// call it.
__device__ __forceinline__ int stage_queries(int tj,
                                             const float* __restrict__ qT,
                                             long long ldq, int Q,
                                             int qry_blk, int valid_q,
                                             float* smem, int ld) {
  const int q0 = tj * qry_blk;
  const int ncols = max(0, min(qry_blk, min(Q, valid_q) - q0));
  for (int k = threadIdx.x; k < ncols; k += blockDim.x) {
    const float* p = qT + q0 + k;
    stage_side(smem, ld, k,
               make_side(p[0], p[ldq], p[2 * ldq], p[3 * ldq], p[4 * ldq],
                         p[5 * ldq], p[6 * ldq], p[7 * ldq]));
  }
  __syncthreads();
  return ncols;
}

__device__ __forceinline__ Side staged_side(const float* smem, int ld,
                                            int k) {
  return {smem[k],          smem[ld + k],     smem[2 * ld + k],
          smem[3 * ld + k], smem[4 * ld + k], smem[5 * ld + k],
          smem[6 * ld + k], smem[7 * ld + k]};
}

// Blocks of the fused compaction: 8 warps, each thread solving up to 4
// pairs of its sub-tile.
constexpr int kSubThreads = 256;
constexpr int kPairsPerThread = 4;
constexpr int kSubPairs = kSubThreads * kPairsPerThread;

// Sub-tile `sub` of (entry tile ti, query tile tj) of the fused
// compaction: entry rows [ti * cand_blk + sub * sub_rows, + sub_rows) of
// the tile x its columns.  `ld` >= every tile's column count is the
// stride of the staged query table; sub_rows * ld <= kSubPairs.
__device__ __forceinline__ void compact_subtile(
    int ti, int tj, int sub, int sub_rows, int ld,
    const float* __restrict__ entries, int C, const float* __restrict__ qT,
    long long ldq, int Q, float d, int cand_blk, int qry_blk, int valid_c,
    int valid_q, int capacity, int* __restrict__ e_idx,
    int* __restrict__ q_idx, float* __restrict__ t_enter,
    float* __restrict__ t_exit, int* __restrict__ count) {
  // 8 * ld derived query columns, then 8 * sub_rows derived entry rows.
  extern __shared__ float smem[];
  __shared__ int s_base;
  const int r_tile = sub * sub_rows;
  const int row0 = ti * cand_blk + r_tile;
  const int nrows =
      min(sub_rows, min(cand_blk - r_tile, min(C, valid_c) - row0));
  if (nrows <= 0) return;                      // uniform across the block
  const int q0 = tj * qry_blk;
  const int ncols = stage_queries(tj, qT, ldq, Q, qry_blk, valid_q, smem, ld);
  if (ncols == 0) return;
  float* es = smem + 8 * ld;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x)
    stage_side(es, sub_rows, r, load_entry(entries, row0 + r));
  __syncthreads();

  // Each pair of the sub-tile solved once; results stay in registers.
  const int pairs = nrows * ncols;
  const float dd = d * d;
  bool h[kPairsPerThread];
  float te[kPairsPerThread], tx[kPairsPerThread];
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int p = threadIdx.x + k * kSubThreads;
    h[k] = false;
    if (p < pairs) {
      const int r = p / ncols;
      h[k] = interval_solve(staged_side(es, sub_rows, r),
                            staged_side(smem, ld, p - r * ncols), dd, &te[k],
                            &tx[k]);
    }
  }

  // Offsets: a block scan of the threads' hit counts, one atomicAdd on
  // `count` per sub-tile.
  int n = 0;
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) n += h[k] ? 1 : 0;
  int total;
  int dst = block_exclusive_scan(n, &total);
  if (total == 0) return;
  if (threadIdx.x == 0) s_base = atomicAdd(count, total);
  __syncthreads();
  dst += s_base;
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    if (h[k] && dst < capacity) {
      const int p = threadIdx.x + k * kSubThreads;
      const int r = p / ncols;
      e_idx[dst] = row0 + r;
      q_idx[dst] = q0 + p - r * ncols;
      t_enter[dst] = te[k];
      t_exit[dst] = tx[k];
    }
    dst += h[k] ? 1 : 0;
  }
}

// (row, 32-column chunk) slots whose results one warp keeps in registers:
// 8 chunks cover a 256-column tile; a wider tile solves its later chunks
// again in the write pass.
constexpr int kRowChunks = 8;
constexpr int kRowWarps = kSubThreads / 32;

// Row block `blk` of (entry tile ti, query tile tj) of the row-loop
// compaction: entry rows [ti * cand_blk + blk * rows, + rows) of the tile,
// rows = kRowWarps * per_warp, warp w taking rows [w * per_warp, + per_warp)
// of the block.  `ld` >= every tile's column count is the stride of the
// staged query table, and per_warp * (the tile's chunks) <= kRowChunks
// unless per_warp is 1.  Lane l solves columns l, l + 32, ... of each of
// its warp's rows; one ballot per (row, chunk) slot gives the slot's hit
// mask.  One atomicAdd on `count` per block; the block's hits fill one
// contiguous run, rows ascending, columns ascending within a row.  Slots
// past `capacity` are dropped; `count` stays exact.
__device__ __forceinline__ void rowloop_block(
    int ti, int tj, int blk, int per_warp, int ld,
    const float* __restrict__ entries, int C, const float* __restrict__ qT,
    long long ldq, int Q, float d, int cand_blk, int qry_blk, int valid_c,
    int valid_q, int capacity, int* __restrict__ e_idx,
    int* __restrict__ q_idx, float* __restrict__ t_enter,
    float* __restrict__ t_exit, int* __restrict__ count) {
  // 8 * ld derived query columns, then 8 * rows derived entry rows.
  extern __shared__ float smem[];
  __shared__ int s_base;
  const int rows = kRowWarps * per_warp;
  const int r_tile = blk * rows;
  const int row0 = ti * cand_blk + r_tile;
  const int nrows =
      min(rows, min(cand_blk - r_tile, min(C, valid_c) - row0));
  if (nrows <= 0) return;                      // uniform across the block
  const int q0 = tj * qry_blk;
  const int ncols = stage_queries(tj, qT, ldq, Q, qry_blk, valid_q, smem, ld);
  if (ncols == 0) return;
  float* es = smem + 8 * ld;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x)
    stage_side(es, rows, r, load_entry(entries, row0 + r));
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int nchunks = (ncols + 31) / 32;
  const int wr = (threadIdx.x >> 5) * per_warp;  // the warp's first row
  // Uniform across a warp (a warp past the block's rows has none), so
  // every ballot below runs with all 32 lanes.
  const int slots = max(0, min(per_warp, nrows - wr)) * nchunks;
  const float dd = d * d;
  auto solve = [&](int s, float* a, float* b) {
    const int r = s / nchunks;
    const int k = (s - r * nchunks) * 32 + lane;
    return k < ncols && interval_solve(staged_side(es, rows, wr + r),
                                       staged_side(smem, ld, k), dd, a, b);
  };
  auto write = [&](int s, int dst, float a, float b) {
    const int r = s / nchunks;
    e_idx[dst] = row0 + wr + r;
    q_idx[dst] = q0 + (s - r * nchunks) * 32 + lane;
    t_enter[dst] = a;
    t_exit[dst] = b;
  };

  // Each pair solved once.  The slots past kRowChunks are counted first,
  // so that no register slot is live across their solves; the first
  // kRowChunks slots' results stay in registers (the array indices are
  // compile-time after unrolling).
  int n = 0;
  for (int s = kRowChunks; s < slots; ++s) {
    float a, b;
    n += __popc(__ballot_sync(0xffffffffu, solve(s, &a, &b)));
  }
  unsigned mask[kRowChunks];
  float te[kRowChunks], tx[kRowChunks];
#pragma unroll
  for (int s = 0; s < kRowChunks; ++s) {
    mask[s] = 0u;
    if (s < slots) {
      mask[s] = __ballot_sync(0xffffffffu, solve(s, &te[s], &tx[s]));
      n += __popc(mask[s]);
    }
  }

  // Offsets: a block scan of the warps' hit totals (lane 0 carries its
  // warp's), one atomicAdd on `count` per block.
  int total;
  int dst0 = __shfl_sync(0xffffffffu,
                         block_exclusive_scan(lane == 0 ? n : 0, &total), 0);
  if (total == 0) return;
  if (threadIdx.x == 0) s_base = atomicAdd(count, total);
  __syncthreads();
  dst0 += s_base;                              // the warp's first slot
  if (dst0 >= capacity) return;                // uniform across the warp
#pragma unroll
  for (int s = 0; s < kRowChunks; ++s) {
    if (s < slots) {
      const int dst = dst0 + __popc(mask[s] & lanes_below);
      if (((mask[s] >> lane) & 1u) && dst < capacity)
        write(s, dst, te[s], tx[s]);
      dst0 += __popc(mask[s]);
    }
  }
  for (int s = kRowChunks; s < slots && dst0 < capacity; ++s) {
    float a, b;
    const bool h = solve(s, &a, &b);
    const unsigned m = __ballot_sync(0xffffffffu, h);
    const int dst = dst0 + __popc(m & lanes_below);
    if (h && dst < capacity) write(s, dst, a, b);
    dst0 += __popc(m);
  }
}

// The tile-level early-out, same float32 ops as _tile_mbr_live.
__device__ __forceinline__ bool tile_mbr_live(const float* em, const float* qm,
                                              float dp) {
  float gap2 = 0.0f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float g = fmaxf(fmaxf(qm[ax] - em[3 + ax], em[ax] - qm[3 + ax]), 0.0f);
    gap2 = gap2 + g * g;
  }
  return gap2 <= dp * dp;
}

// The armed early-out of logical tile (ti, tj) for one of its blocks:
// every block of the tile takes the same decision on the same boxes and
// the same threshold (read from device memory), and only the tile's first
// block (blockIdx.y == 0) counts a dead tile, so `pruned` counts logical
// tiles.  Every thread of the block must call it.
__device__ __forceinline__ bool tile_live(int ti, int tj,
                                          const float* __restrict__ e_mbr,
                                          const float* __restrict__ q_mbr,
                                          const float* __restrict__ d_prune,
                                          int* __restrict__ pruned) {
  __shared__ int s_live;
  if (threadIdx.x == 0) {
    s_live = tile_mbr_live(e_mbr + 8 * ti, q_mbr + 8 * tj, *d_prune);
    if (!s_live && blockIdx.y == 0) atomicAdd(pruned, 1);
  }
  __syncthreads();
  return s_live;
}

template <bool kPrune>
__global__ void __launch_bounds__(kSubThreads) distthresh_compact_kernel(
    const float* __restrict__ entries, int C, const float* __restrict__ qT,
    long long ldq, int Q, float d, int cand_blk, int qry_blk, int valid_c,
    int valid_q, int capacity, int ntq, int sub_rows, int ld,
    const float* __restrict__ e_mbr, const float* __restrict__ q_mbr,
    const float* __restrict__ d_prune, int* __restrict__ e_idx,
    int* __restrict__ q_idx, float* __restrict__ t_enter,
    float* __restrict__ t_exit, int* __restrict__ count,
    int* __restrict__ pruned) {
  const int ti = blockIdx.x / ntq;
  const int tj = blockIdx.x % ntq;
  if (kPrune && !tile_live(ti, tj, e_mbr, q_mbr, d_prune, pruned)) return;
  compact_subtile(ti, tj, blockIdx.y, sub_rows, ld, entries, C, qT, ldq, Q, d,
                  cand_blk, qry_blk, valid_c, valid_q, capacity, e_idx,
                  q_idx, t_enter, t_exit, count);
}

__global__ void __launch_bounds__(kSubThreads) distthresh_compact_live_kernel(
    const float* __restrict__ entries, int C, const float* __restrict__ qT,
    long long ldq, int Q, float d, int cand_blk, int qry_blk, int valid_c,
    int valid_q, int capacity, int sub_rows, int ld,
    const int* __restrict__ tile_i, const int* __restrict__ tile_j,
    const int* __restrict__ n_live, int* __restrict__ e_idx,
    int* __restrict__ q_idx, float* __restrict__ t_enter,
    float* __restrict__ t_exit, int* __restrict__ count) {
  const int slot = blockIdx.x;
  if (slot >= *n_live) return;
  compact_subtile(tile_i[slot], tile_j[slot], blockIdx.y, sub_rows, ld,
                  entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c,
                  valid_q, capacity, e_idx, q_idx, t_enter, t_exit, count);
}


template <bool kPrune>
__global__ void __launch_bounds__(kSubThreads)
    distthresh_compact_rowloop_kernel(
        const float* __restrict__ entries, int C, const float* __restrict__ qT,
        long long ldq, int Q, float d, int cand_blk, int qry_blk,
        int valid_c, int valid_q, int capacity, int ntq, int per_warp,
        int ld, const float* __restrict__ e_mbr,
        const float* __restrict__ q_mbr, const float* __restrict__ d_prune,
        int* __restrict__ e_idx, int* __restrict__ q_idx,
        float* __restrict__ t_enter, float* __restrict__ t_exit,
        int* __restrict__ count, int* __restrict__ pruned) {
  const int ti = blockIdx.x / ntq;
  const int tj = blockIdx.x % ntq;
  if (kPrune && !tile_live(ti, tj, e_mbr, q_mbr, d_prune, pruned)) return;
  rowloop_block(ti, tj, blockIdx.y, per_warp, ld, entries, C, qT, ldq, Q, d,
                cand_blk, qry_blk, valid_c, valid_q, capacity, e_idx, q_idx,
                t_enter, t_exit, count);
}

__global__ void __launch_bounds__(kSubThreads)
    distthresh_compact_live_rowloop_kernel(
        const float* __restrict__ entries, int C, const float* __restrict__ qT,
        long long ldq, int Q, float d, int cand_blk, int qry_blk,
        int valid_c, int valid_q, int capacity, int per_warp, int ld,
        const int* __restrict__ tile_i, const int* __restrict__ tile_j,
        const int* __restrict__ n_live, int* __restrict__ e_idx,
        int* __restrict__ q_idx, float* __restrict__ t_enter,
        float* __restrict__ t_exit, int* __restrict__ count) {
  const int slot = blockIdx.x;
  if (slot >= *n_live) return;
  rowloop_block(tile_i[slot], tile_j[slot], blockIdx.y, per_warp, ld, entries,
                C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c, valid_q,
                capacity, e_idx, q_idx, t_enter, t_exit, count);
}

// Block (blockIdx.x, blockIdx.y) of the dense kernel: entry rows
// [blockIdx.x * rows, + rows) x query columns [blockIdx.y * cols, + cols),
// rows * cols <= kSubPairs.
__global__ void __launch_bounds__(kSubThreads) distthresh_dense_kernel(
    const float* __restrict__ entries, int C, const float* __restrict__ qT,
    long long ldq, int Q, float d, int rows, int cols,
    float* __restrict__ t_enter, float* __restrict__ t_exit,
    int8_t* __restrict__ hit) {
  // 8 * cols derived query columns, then 8 * rows derived entry rows.
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * rows;
  const int c0 = blockIdx.y * cols;
  const int nr = min(rows, C - r0);
  const int nc = stage_queries(blockIdx.y, qT, ldq, Q, cols, Q, smem, cols);
  float* es = smem + 8 * cols;
  for (int r = threadIdx.x; r < nr; r += blockDim.x)
    stage_side(es, rows, r, load_entry(entries, r0 + r));
  __syncthreads();

  const int pairs = nr * nc;
  const float dd = d * d;
  // (row, column) of pair p = threadIdx.x + k * 256, stepped without a
  // division per pair.
  int r = threadIdx.x / nc;
  int c = threadIdx.x - r * nc;
  const int dr = kSubThreads / nc;
  const int dc = kSubThreads - dr * nc;
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int p = threadIdx.x + k * kSubThreads;
    if (k > 0) {
      r += dr;
      c += dc;
      if (c >= nc) {
        c -= nc;
        ++r;
      }
    }
    if (p < pairs) {
      float te = 0.0f, tx = 0.0f;
      const bool h = interval_solve(staged_side(es, rows, r),
                                    staged_side(smem, cols, c), dd, &te, &tx);
      const size_t o = (size_t)(r0 + r) * Q + c0 + c;
      t_enter[o] = h ? te : 0.0f;
      t_exit[o] = h ? tx : 0.0f;
      hit[o] = h ? 1 : 0;
    }
  }
}

// Blocks of the tile-prune preparation.
constexpr int kPrepThreads = 256;

// solve_scale's term of one packed segment (repro_torch/core/index.py), in
// float64 with numpy's operations in numpy's order, each rounded once: per
// axis max(|p0|, |p1|) + |v|·|ts|, v = (p1 − p0) / (te − ts), or 0 where
// te − ts <= 0; the largest over the three axes.  All terms are >= 0.
__device__ __forceinline__ double solve_mag(const float* p) {
  const double ts = p[6];
  const double dt = __dsub_rn((double)p[7], ts);
  double m = 0.0;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const double a = p[ax], b = p[3 + ax];
    const double v = dt > 0.0 ? __ddiv_rn(__dsub_rn(b, a), dt) : 0.0;
    m = fmax(m, __dadd_rn(fmax(fabs(a), fabs(b)), __dmul_rn(fabs(v),
                                                             fabs(ts))));
  }
  return m;
}

// One block per tile: blocks [0, ntc) the entry tiles of `entries` (rows
// of 8 floats), blocks [ntc, ntc + ntq) the query tiles of `qT` (8 rows
// `ldq` apart).  Writes the tile's (lo_xyz, hi_xyz, 0, 0) box, the
// _host_tile_mbrs layout, and the largest solve magnitude of its rows to
// tile_mag[blockIdx.x].
__global__ void __launch_bounds__(kPrepThreads) distthresh_tile_prep_kernel(
    const float* __restrict__ entries, int C, const float* __restrict__ qT,
    long long ldq, int Q, int cand_blk, int qry_blk, int ntc,
    float* __restrict__ e_mbr, float* __restrict__ q_mbr,
    double* __restrict__ tile_mag) {
  const bool entry = blockIdx.x < ntc;
  const int tile = entry ? blockIdx.x : blockIdx.x - ntc;
  const int blk = entry ? cand_blk : qry_blk;
  const int r0 = tile * blk;
  const int r1 = min(entry ? C : Q, r0 + blk);
  float box[6] = {f_inf(), f_inf(), f_inf(), -f_inf(), -f_inf(), -f_inf()};
  double mag = 0.0;
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    float p[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      p[k] = entry ? entries[(size_t)r * 8 + k] : qT[k * ldq + r];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      box[ax] = fminf(box[ax], fminf(p[ax], p[3 + ax]));
      box[3 + ax] = fmaxf(box[3 + ax], fmaxf(p[ax], p[3 + ax]));
    }
    mag = fmax(mag, solve_mag(p));
  }
  // Warp reduction, then the warps' partials through shared memory.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      box[ax] = fminf(box[ax], __shfl_down_sync(0xffffffffu, box[ax], o));
      box[3 + ax] = fmaxf(box[3 + ax],
                          __shfl_down_sync(0xffffffffu, box[3 + ax], o));
    }
    mag = fmax(mag, __shfl_down_sync(0xffffffffu, mag, o));
  }
  __shared__ float s_box[kPrepThreads / 32][6];
  __shared__ double s_mag[kPrepThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s_box[wid][k] = box[k];
    s_mag[wid] = mag;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      box[ax] = fminf(box[ax], s_box[w][ax]);
      box[3 + ax] = fmaxf(box[3 + ax], s_box[w][3 + ax]);
    }
    mag = fmax(mag, s_mag[w]);
  }
  float* out = (entry ? e_mbr : q_mbr) + 8 * (size_t)tile;
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k] = box[k];
  out[6] = 0.0f;
  out[7] = 0.0f;
  tile_mag[blockIdx.x] = mag;
}

// One block: the largest of the n tile magnitudes, floored at 1 (the
// dispatch's solve_scale), and prune_limit(d, scale) in float64, operation
// by operation as repro_torch/core/index.py evaluates it, rounded once to
// float32.
__global__ void __launch_bounds__(kPrepThreads)
    distthresh_tile_prep_limit_kernel(const double* __restrict__ tile_mag,
                                      int n, double d,
                                      float* __restrict__ d_prune) {
  double m = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmax(m, tile_mag[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmax(m, __shfl_down_sync(0xffffffffu, m, o));
  __shared__ double s_m[kPrepThreads / 32];
  if ((threadIdx.x & 31) == 0) s_m[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmax(m, s_m[w]);
  // scale = max(mag, 1.0); err = 4e-6 * scale * scale;
  // slack = min(err / max(2 d, 1e-12), sqrt(err));
  // d + 1e-5 d + slack + 1e-9, left to right.
  const double scale = 1.0 > m ? 1.0 : m;
  const double err = __dmul_rn(__dmul_rn(4e-6, scale), scale);
  const double two_d = __dmul_rn(2.0, d);
  const double by_d = __ddiv_rn(err, 1e-12 > two_d ? 1e-12 : two_d);
  const double root = __dsqrt_rn(err);
  const double slack = root < by_d ? root : by_d;
  *d_prune = __double2float_rn(__dadd_rn(
      __dadd_rn(__dadd_rn(d, __dmul_rn(1e-5, d)), slack), 1e-9));
}

// The most columns a tile of the batch can have: the stride of the
// compact kernels' staged query table.
int tile_ld(int Q, int qry_blk, int valid_q) {
  return std::max(1, std::min(qry_blk, std::min(Q, valid_q)));
}

// Entry rows of the batch's fullest tile.
int tile_rows(int C, int cand_blk, int valid_c) {
  return std::max(1, std::min(cand_blk, std::min(C, valid_c)));
}

// Sub-tile geometry of the fused compaction for a batch: the staged
// table's stride, the entry rows per sub-tile, and the sub-tiles per tile.
struct SubTiles {
  int ld, rows, per_tile;
  SubTiles(int C, int Q, int cand_blk, int qry_blk, int valid_c,
           int valid_q) {
    ld = tile_ld(Q, qry_blk, valid_q);
    rows = std::max(1, std::min(cand_blk, kSubPairs / ld));
    per_tile = (tile_rows(C, cand_blk, valid_c) + rows - 1) / rows;
  }
  size_t smem() const { return sizeof(float) * 8 * (size_t)(ld + rows); }
};

// Row-block geometry of the row-loop compaction for a batch: the staged
// table's stride, the rows per warp (about kSubPairs pairs per block, a
// warp's slots in kRowChunks registers where the tile allows, no more
// warps' worth of rows than the tile has), the rows per block, and the row
// blocks per tile.
struct RowBlocks {
  int ld, per_warp, rows, per_tile;
  RowBlocks(int C, int Q, int cand_blk, int qry_blk, int valid_c,
            int valid_q) {
    ld = tile_ld(Q, qry_blk, valid_q);
    const int chunks = (ld + 31) / 32;
    const int tr = tile_rows(C, cand_blk, valid_c);
    per_warp = std::max(
        1, std::min(kSubPairs / (kRowWarps * ld),
                    std::min(kRowChunks / chunks,
                             (tr + kRowWarps - 1) / kRowWarps)));
    rows = kRowWarps * per_warp;
    per_tile = (tr + rows - 1) / rows;
  }
  size_t smem() const { return sizeof(float) * 8 * (size_t)(ld + rows); }
};

// Dense geometry: `cols` = min(Q, 256) query columns x `rows` entry rows
// per block, rows on grid x (y stops at 65,535).
struct DenseBlocks {
  int rows, cols;
  dim3 grid;
  DenseBlocks(int C, int Q) {
    cols = std::max(1, std::min(Q, kSubThreads));
    rows = std::max(1, kSubPairs / cols);
    grid = dim3((C + rows - 1) / rows, (Q + cols - 1) / cols);
  }
  size_t smem() const { return sizeof(float) * 8 * (size_t)(rows + cols); }
};

}  // namespace

extern "C" {

int distthresh_dense_launch(const float* entries, int C, const float* qT,
                            long long ldq, int Q, float d, float* t_enter,
                            float* t_exit, int8_t* hit, void* stream) {
  const DenseBlocks g(C, Q);
  distthresh_dense_kernel<<<g.grid, kSubThreads, g.smem(),
                            (cudaStream_t)stream>>>(
      entries, C, qT, ldq, Q, d, g.rows, g.cols, t_enter, t_exit, hit);
  return (int)cudaGetLastError();
}

// Blocks of the dense kernel's grid for a (C, Q) batch.
int distthresh_dense_blocks(int C, int Q) {
  const DenseBlocks g(C, Q);
  return (int)(g.grid.x * g.grid.y);
}

// Sub-tiles per logical tile of the fused compaction's grid (blocks:
// this times the tiles, or the live-tile slots).
int distthresh_compact_subtiles(int C, int Q, int cand_blk, int qry_blk,
                                int valid_c, int valid_q) {
  return SubTiles(C, Q, cand_blk, qry_blk, valid_c, valid_q).per_tile;
}

// Row blocks per logical tile of the row-loop compaction's grid (blocks:
// this times the tiles, or the live-tile slots).
int distthresh_compact_rowloop_blocks(int C, int Q, int cand_blk,
                                      int qry_blk, int valid_c, int valid_q) {
  return RowBlocks(C, Q, cand_blk, qry_blk, valid_c, valid_q).per_tile;
}

// The spatial early-out's operands for one dispatch, on `stream`: the
// per-tile boxes into e_mbr (ceil(C / cand_blk), 8) and q_mbr
// (ceil(Q / qry_blk), 8), their magnitudes into the scratch tile_mag (one
// double per tile), then the float32 threshold into *d_prune.
int distthresh_tile_prep_launch(const float* entries, int C, const float* qT,
                                long long ldq, int Q, int cand_blk,
                                int qry_blk, double d, float* e_mbr,
                                float* q_mbr, double* tile_mag,
                                float* d_prune, void* stream) {
  const int ntc = (C + cand_blk - 1) / cand_blk;
  const int ntq = (Q + qry_blk - 1) / qry_blk;
  cudaStream_t s = (cudaStream_t)stream;
  if (ntc + ntq > 0) {
    distthresh_tile_prep_kernel<<<ntc + ntq, kPrepThreads, 0, s>>>(
        entries, C, qT, ldq, Q, cand_blk, qry_blk, ntc, e_mbr, q_mbr,
        tile_mag);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  distthresh_tile_prep_limit_kernel<<<1, kPrepThreads, 0, s>>>(
      tile_mag, ntc + ntq, d, d_prune);
  return (int)cudaGetLastError();
}

int distthresh_compact_launch(const float* entries, int C, const float* qT,
                              long long ldq, int Q, float d, int cand_blk,
                              int qry_blk, int valid_c, int valid_q,
                              int capacity, const float* e_mbr,
                              const float* q_mbr, const float* d_prune,
                              int* e_idx, int* q_idx, float* t_enter,
                              float* t_exit, int* count, int* pruned,
                              void* stream) {
  const int ntc = (C + cand_blk - 1) / cand_blk;
  const int ntq = (Q + qry_blk - 1) / qry_blk;
  const SubTiles sub(C, Q, cand_blk, qry_blk, valid_c, valid_q);
  const dim3 grid(ntc * ntq, sub.per_tile);
  cudaStream_t s = (cudaStream_t)stream;
  if (e_mbr != nullptr) {
    distthresh_compact_kernel<true><<<grid, kSubThreads, sub.smem(), s>>>(
        entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c, valid_q,
        capacity, ntq, sub.rows, sub.ld, e_mbr, q_mbr, d_prune, e_idx, q_idx,
        t_enter, t_exit, count, pruned);
  } else {
    distthresh_compact_kernel<false><<<grid, kSubThreads, sub.smem(), s>>>(
        entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c, valid_q,
        capacity, ntq, sub.rows, sub.ld, nullptr, nullptr, nullptr, e_idx,
        q_idx, t_enter, t_exit, count, pruned);
  }
  return (int)cudaGetLastError();
}

int distthresh_compact_live_launch(const float* entries, int C,
                                   const float* qT, long long ldq, int Q,
                                   float d, int cand_blk, int qry_blk,
                                   int valid_c, int valid_q, int capacity,
                                   const int* tile_i, const int* tile_j,
                                   const int* n_live, int n_slots, int* e_idx,
                                   int* q_idx, float* t_enter, float* t_exit,
                                   int* count, void* stream) {
  const SubTiles sub(C, Q, cand_blk, qry_blk, valid_c, valid_q);
  const dim3 grid(n_slots, sub.per_tile);
  distthresh_compact_live_kernel<<<grid, kSubThreads, sub.smem(),
                                   (cudaStream_t)stream>>>(
      entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c, valid_q,
      capacity, sub.rows, sub.ld, tile_i, tile_j, n_live, e_idx, q_idx,
      t_enter, t_exit, count);
  return (int)cudaGetLastError();
}

int distthresh_compact_rowloop_launch(
    const float* entries, int C, const float* qT, long long ldq, int Q,
    float d, int cand_blk, int qry_blk, int valid_c, int valid_q,
    int capacity, const float* e_mbr, const float* q_mbr,
    const float* d_prune, int* e_idx, int* q_idx, float* t_enter,
    float* t_exit, int* count, int* pruned, void* stream) {
  const int ntc = (C + cand_blk - 1) / cand_blk;
  const int ntq = (Q + qry_blk - 1) / qry_blk;
  const RowBlocks rb(C, Q, cand_blk, qry_blk, valid_c, valid_q);
  const dim3 grid(ntc * ntq, rb.per_tile);
  cudaStream_t s = (cudaStream_t)stream;
  if (e_mbr != nullptr) {
    distthresh_compact_rowloop_kernel<true><<<grid, kSubThreads, rb.smem(),
                                              s>>>(
        entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c, valid_q,
        capacity, ntq, rb.per_warp, rb.ld, e_mbr, q_mbr, d_prune, e_idx,
        q_idx, t_enter, t_exit, count, pruned);
  } else {
    distthresh_compact_rowloop_kernel<false><<<grid, kSubThreads, rb.smem(),
                                               s>>>(
        entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c, valid_q,
        capacity, ntq, rb.per_warp, rb.ld, nullptr, nullptr, nullptr, e_idx,
        q_idx, t_enter, t_exit, count, pruned);
  }
  return (int)cudaGetLastError();
}

int distthresh_compact_live_rowloop_launch(
    const float* entries, int C, const float* qT, long long ldq, int Q,
    float d, int cand_blk, int qry_blk, int valid_c, int valid_q,
    int capacity, const int* tile_i, const int* tile_j, const int* n_live,
    int n_slots, int* e_idx, int* q_idx, float* t_enter, float* t_exit,
    int* count, void* stream) {
  const RowBlocks rb(C, Q, cand_blk, qry_blk, valid_c, valid_q);
  const dim3 grid(n_slots, rb.per_tile);
  distthresh_compact_live_rowloop_kernel<<<grid, kSubThreads, rb.smem(),
                                           (cudaStream_t)stream>>>(
      entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c, valid_q,
      capacity, rb.per_warp, rb.ld, tile_i, tile_j, n_live, e_idx, q_idx,
      t_enter, t_exit, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
