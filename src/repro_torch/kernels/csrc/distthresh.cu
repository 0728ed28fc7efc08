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
//   avoid a gather; here it is its own design: one block per tile, one
//   warp per entry row.  Lane l solves columns l, l+32, ... once and
//   keeps (hit, t_enter, t_exit) in registers (up to 8 chunks, qry_blk <=
//   256; wider tiles recompute in a second pass), one __ballot_sync per
//   chunk gives the row's hits, lane 0 claims the row's base with one
//   atomicAdd, and each hit lane writes at base + earlier chunks' hits +
//   popc(mask & lanes below).  Each pair is solved once; columns stay
//   ascending within a row; `count` stays exact on overflow; rows land in
//   a run-dependent order.  The armed variant runs the tile box test
//   first, as the chunk kernel does.
//   Bound: float32 arithmetic, ~45 operations per temporally overlapping
//   pair, plus one global atomic per row that has hits.
//   Left on the table: one atomic per row instead of one per tile; at most
//   8 warps per block, so a 256-row tile runs 32 rows per warp in turn;
//   lanes past the last column idle in the last chunk (100 columns fill 4
//   chunks of 32).
//
// distthresh_compact_live_rowloop_kernel  replaces
//   distthresh_compact_live_pallas(append="rowloop") (:697, pallas_call at
//   :782): the row-loop body over a live-tile list, one block per slot.
//
// distthresh_dense_kernel  replaces distthresh_pallas
//   (repro/kernels/distthresh.py:214, pallas_call at :242).  One thread per
//   (entry, query) pair in 32x8 blocks; writes t_enter, t_exit and int8 hit
//   (intervals 0 where there is no hit).  Bound: the 9 bytes per pair it
//   writes, ~2.7 us per 10^6 pairs at 3.35 TB/s.  Left on the table: each
//   thread reloads its entry and query (L1 serves the repeats).
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

// Chunks of 32 columns whose results one warp keeps in registers
// (qry_blk <= 256); a wider tile recomputes its row in a second pass.
constexpr int kRowChunks = 8;

// One (entry tile ti, query tile tj) of the row-loop compaction: one warp
// per entry row, the block's warps striding over the tile's rows.  Lane l
// solves columns l, l + 32, ...; one ballot per 32-column chunk gives the
// row's hit mask, lane 0 claims the row's base with one atomicAdd on
// `count`, and each hit lane writes at base + (hits of earlier chunks) +
// (hits of lower lanes in its chunk), so columns stay in ascending order
// within a row.  Rows past `capacity` are dropped; `count` stays exact.
__device__ __forceinline__ void rowloop_tile(
    int ti, int tj, const float* __restrict__ entries, int C,
    const float* __restrict__ qT, long long ldq, int Q, float d,
    int cand_blk, int qry_blk, int valid_c, int valid_q, int capacity,
    int* __restrict__ e_idx, int* __restrict__ q_idx,
    float* __restrict__ t_enter, float* __restrict__ t_exit,
    int* __restrict__ count) {
  extern __shared__ float smem[];  // 8 * qry_blk: derived query columns
  const int q0 = tj * qry_blk;
  const int ncols =
      stage_queries(tj, qT, ldq, Q, qry_blk, valid_q, smem, qry_blk);
  const int nchunks = (ncols + 31) / 32;
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int nrows = min(cand_blk, min(C, valid_c) - ti * cand_blk);
  const float dd = d * d;

  // The warp index is uniform across a warp, so every ballot below runs
  // with all 32 lanes.
  for (int r = threadIdx.x >> 5; r < nrows; r += blockDim.x >> 5) {
    const int row = ti * cand_blk + r;
    const Side e = load_entry(entries, row);
    unsigned mask[kRowChunks];
    float te[kRowChunks], tx[kRowChunks];
    int n_r = 0;
    if (nchunks <= kRowChunks) {
#pragma unroll
      for (int c = 0; c < kRowChunks; ++c) {
        mask[c] = 0u;
        if (c < nchunks) {
          const int k = c * 32 + lane;
          bool h = false;
          if (k < ncols)
            h = interval_solve(e, staged_side(smem, qry_blk, k), dd, &te[c],
                               &tx[c]);
          mask[c] = __ballot_sync(0xffffffffu, h);
          n_r += __popc(mask[c]);
        }
      }
    } else {
      for (int c = 0; c < nchunks; ++c) {
        const int k = c * 32 + lane;
        float a, b;
        const bool h = k < ncols &&
            interval_solve(e, staged_side(smem, qry_blk, k), dd, &a, &b);
        n_r += __popc(__ballot_sync(0xffffffffu, h));
      }
    }
    if (n_r == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(count, n_r);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= capacity) continue;

    int before = 0;  // hits of this row in earlier chunks
    if (nchunks <= kRowChunks) {
#pragma unroll
      for (int c = 0; c < kRowChunks; ++c) {
        if (c < nchunks) {
          if ((mask[c] >> lane) & 1u) {
            const int dst = base + before + __popc(mask[c] & lanes_below);
            if (dst < capacity) {
              e_idx[dst] = row;
              q_idx[dst] = q0 + c * 32 + lane;
              t_enter[dst] = te[c];
              t_exit[dst] = tx[c];
            }
          }
          before += __popc(mask[c]);
        }
      }
    } else {
      for (int c = 0; c < nchunks && base + before < capacity; ++c) {
        const int k = c * 32 + lane;
        float a, b;
        const bool h = k < ncols &&
            interval_solve(e, staged_side(smem, qry_blk, k), dd, &a, &b);
        const unsigned m = __ballot_sync(0xffffffffu, h);
        const int dst = base + before + __popc(m & lanes_below);
        if (h && dst < capacity) {
          e_idx[dst] = row;
          q_idx[dst] = q0 + k;
          t_enter[dst] = a;
          t_exit[dst] = b;
        }
        before += __popc(m);
      }
    }
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

template <bool kPrune>
__global__ void __launch_bounds__(kSubThreads) distthresh_compact_kernel(
    const float* __restrict__ entries, int C, const float* __restrict__ qT,
    long long ldq, int Q, float d, int cand_blk, int qry_blk, int valid_c,
    int valid_q, int capacity, int ntq, int sub_rows, int ld,
    const float* __restrict__ e_mbr, const float* __restrict__ q_mbr,
    float d_prune, int* __restrict__ e_idx, int* __restrict__ q_idx,
    float* __restrict__ t_enter, float* __restrict__ t_exit,
    int* __restrict__ count, int* __restrict__ pruned) {
  const int ti = blockIdx.x / ntq;
  const int tj = blockIdx.x % ntq;
  if (kPrune) {
    // Every sub-tile of a tile takes the same decision; sub-tile 0 counts
    // the dead tile once.
    __shared__ int s_live;
    if (threadIdx.x == 0) {
      s_live = tile_mbr_live(e_mbr + 8 * ti, q_mbr + 8 * tj, d_prune);
      if (!s_live && blockIdx.y == 0) atomicAdd(pruned, 1);
    }
    __syncthreads();
    if (!s_live) return;
  }
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
__global__ void distthresh_compact_rowloop_kernel(
    const float* __restrict__ entries, int C, const float* __restrict__ qT,
    long long ldq, int Q, float d, int cand_blk, int qry_blk, int valid_c,
    int valid_q, int capacity, int ntq, const float* __restrict__ e_mbr,
    const float* __restrict__ q_mbr, float d_prune, int* __restrict__ e_idx,
    int* __restrict__ q_idx, float* __restrict__ t_enter,
    float* __restrict__ t_exit, int* __restrict__ count,
    int* __restrict__ pruned) {
  const int ti = blockIdx.x / ntq;
  const int tj = blockIdx.x % ntq;
  if (kPrune) {
    __shared__ int s_live;
    if (threadIdx.x == 0) {
      s_live = tile_mbr_live(e_mbr + 8 * ti, q_mbr + 8 * tj, d_prune);
      if (!s_live) atomicAdd(pruned, 1);
    }
    __syncthreads();
    if (!s_live) return;
  }
  rowloop_tile(ti, tj, entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c,
               valid_q, capacity, e_idx, q_idx, t_enter, t_exit, count);
}

__global__ void distthresh_compact_live_rowloop_kernel(
    const float* __restrict__ entries, int C, const float* __restrict__ qT,
    long long ldq, int Q, float d, int cand_blk, int qry_blk, int valid_c,
    int valid_q, int capacity, const int* __restrict__ tile_i,
    const int* __restrict__ tile_j, const int* __restrict__ n_live,
    int* __restrict__ e_idx, int* __restrict__ q_idx,
    float* __restrict__ t_enter, float* __restrict__ t_exit,
    int* __restrict__ count) {
  const int slot = blockIdx.x;
  if (slot >= *n_live) return;
  rowloop_tile(tile_i[slot], tile_j[slot], entries, C, qT, ldq, Q, d,
               cand_blk, qry_blk, valid_c, valid_q, capacity, e_idx, q_idx,
               t_enter, t_exit, count);
}

__global__ void distthresh_dense_kernel(const float* __restrict__ entries,
                                        int C, const float* __restrict__ qT,
                                        long long ldq, int Q, float d,
                                        float* __restrict__ t_enter,
                                        float* __restrict__ t_exit,
                                        int8_t* __restrict__ hit) {
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= C || col >= Q) return;
  const float* p = qT + col;
  Side q = make_side(p[0], p[ldq], p[2 * ldq], p[3 * ldq], p[4 * ldq],
                     p[5 * ldq], p[6 * ldq], p[7 * ldq]);
  Side e = load_entry(entries, row);
  float te = 0.0f, tx = 0.0f;
  bool h = interval_solve(e, q, d * d, &te, &tx);
  const size_t o = (size_t)row * Q + col;
  t_enter[o] = h ? te : 0.0f;
  t_exit[o] = h ? tx : 0.0f;
  hit[o] = h ? 1 : 0;
}

int round_up_warp(int n) { return (n + 31) / 32 * 32; }

// Sub-tile geometry of the fused compaction for a batch: the most columns
// a tile can have (the staged table's stride), the entry rows per
// sub-tile, and the sub-tiles per tile.
struct SubTiles {
  int ld, rows, per_tile;
  SubTiles(int C, int Q, int cand_blk, int qry_blk, int valid_c,
           int valid_q) {
    ld = std::max(1, std::min(qry_blk, std::min(Q, valid_q)));
    rows = std::max(1, std::min(cand_blk, kSubPairs / ld));
    const int tile_rows =
        std::max(1, std::min(cand_blk, std::min(C, valid_c)));
    per_tile = (tile_rows + rows - 1) / rows;
  }
  size_t smem() const { return sizeof(float) * 8 * (size_t)(ld + rows); }
};

// Row-loop blocks: one warp per row in flight, at most 8 warps.
int rowloop_threads(int cand_blk) {
  const int t = round_up_warp(cand_blk);
  return t < 256 ? t : 256;
}

}  // namespace

extern "C" {

int distthresh_dense_launch(const float* entries, int C, const float* qT,
                            long long ldq, int Q, float d, float* t_enter,
                            float* t_exit, int8_t* hit, void* stream) {
  dim3 block(32, 8);
  dim3 grid((C + 7) / 8, (Q + 31) / 32);  // rows on x: y stops at 65535
  distthresh_dense_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      entries, C, qT, ldq, Q, d, t_enter, t_exit, hit);
  return (int)cudaGetLastError();
}

// Sub-tiles per logical tile of the fused compaction's grid (blocks:
// this times the tiles, or the live-tile slots).
int distthresh_compact_subtiles(int C, int Q, int cand_blk, int qry_blk,
                                int valid_c, int valid_q) {
  return SubTiles(C, Q, cand_blk, qry_blk, valid_c, valid_q).per_tile;
}

int distthresh_compact_launch(const float* entries, int C, const float* qT,
                              long long ldq, int Q, float d, int cand_blk,
                              int qry_blk, int valid_c, int valid_q,
                              int capacity, const float* e_mbr,
                              const float* q_mbr, float d_prune, int* e_idx,
                              int* q_idx, float* t_enter, float* t_exit,
                              int* count, int* pruned, void* stream) {
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
        capacity, ntq, sub.rows, sub.ld, nullptr, nullptr, 0.0f, e_idx, q_idx,
        t_enter, t_exit, count, pruned);
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
    int capacity, const float* e_mbr, const float* q_mbr, float d_prune,
    int* e_idx, int* q_idx, float* t_enter, float* t_exit, int* count,
    int* pruned, void* stream) {
  const int ntc = (C + cand_blk - 1) / cand_blk;
  const int ntq = (Q + qry_blk - 1) / qry_blk;
  const size_t smem = sizeof(float) * 8 * (size_t)qry_blk;
  const int threads = rowloop_threads(cand_blk);
  cudaStream_t s = (cudaStream_t)stream;
  if (e_mbr != nullptr) {
    distthresh_compact_rowloop_kernel<true><<<ntc * ntq, threads, smem, s>>>(
        entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c, valid_q,
        capacity, ntq, e_mbr, q_mbr, d_prune, e_idx, q_idx, t_enter, t_exit,
        count, pruned);
  } else {
    distthresh_compact_rowloop_kernel<false><<<ntc * ntq, threads, smem, s>>>(
        entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c, valid_q,
        capacity, ntq, nullptr, nullptr, 0.0f, e_idx, q_idx, t_enter, t_exit,
        count, pruned);
  }
  return (int)cudaGetLastError();
}

int distthresh_compact_live_rowloop_launch(
    const float* entries, int C, const float* qT, long long ldq, int Q,
    float d, int cand_blk, int qry_blk, int valid_c, int valid_q,
    int capacity, const int* tile_i, const int* tile_j, const int* n_live,
    int n_slots, int* e_idx, int* q_idx, float* t_enter, float* t_exit,
    int* count, void* stream) {
  const size_t smem = sizeof(float) * 8 * (size_t)qry_blk;
  distthresh_compact_live_rowloop_kernel<<<n_slots,
                                           rowloop_threads(cand_blk), smem,
                                           (cudaStream_t)stream>>>(
      entries, C, qT, ldq, Q, d, cand_blk, qry_blk, valid_c, valid_q,
      capacity, tile_i, tile_j, n_live, e_idx, q_idx, t_enter, t_exit, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
