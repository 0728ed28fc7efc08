// Causal GQA flash attention for Hopper (sm_90a): two forward kernels,
// then the backward's (below).
//
// Both replace the reference's Pallas TPU kernel `flashattn_pallas`
// (src/repro/kernels/flashattn.py, body `_flash_kernel`): the prefill
// attention of the LLM serving path.  Same contract: q (BH, S, hd) with
// BH = BKV * g, k and v (BKV, T, hd), query head bh reads KV head bh / g;
// query row i sits at key position (T - S) + i and sees keys at or before
// it; scores are scaled by 1/sqrt(hd); masked scores take the finite
// sentinel -1e30; the online softmax (m, l, acc) runs in float32 and the
// output is written in q's type (round to nearest even).  The wrapper
// (kernels/flashattn.py) picks the kernel by dtype; neither falls back to
// the other.  S and T are any lengths with S <= T: the last query tile
// and the last key tile are ragged (rows past S are not written, keys
// past T are always causally masked, since every row sits below T).
// Tiles wholly above the causal diagonal of a query tile are never
// loaded, and the longest causal query tiles are scheduled first.
//
// flashattn_wgmma_kernel<hd>: bf16 inputs, on the tensor cores.
// * One warpgroup (128 threads) per (bh, 64-row query tile).
// * Copies by TMA (cp.async.bulk.tensor), tracked by mbarriers: the Q tile
//   once, bf16 and unscaled; K and V tiles of 64 keys through a ring of
//   kStages = 2 stages, refilled by one elected thread as soon as every
//   warp has finished with a stage, so the next tile's copy overlaps this
//   tile's products.  The tensor maps are 3-D over (heads, rows, hd),
//   encoded on the host per call; rows past S or T are zero-filled by the
//   hardware.  Each box row is one swizzle span: 32 B at hd 16, 64 B at
//   32, 128 B at 64, and two 64-column boxes at 128.  hd 112 (224-byte
//   rows, more than one 128 B span and not a whole number of 64-column
//   boxes) takes hd 128's shared-memory tiles over a tensor map whose
//   rows are 112 wide: the second box's columns 112-127 lie past the
//   tensor's edge, so TMA fills them with zeros (and still counts the
//   whole box's bytes on the barrier).  Q K^T stops after 112 columns;
//   P V runs over all 128, whose last 16 stay 0 and are not stored.
// * S = Q K^T: hd/16 `wgmma.mma_async m64n64k16` with both operands
//   K-major in shared memory, float32 accumulators in registers.  The
//   bf16 x bf16 products are exact in float32; only the order of the sum
//   differs from the plain version.  The 1/sqrt(hd) scale is applied to
//   the float32 score (exact at hd 16 and 64, within an ulp at 32, 112
//   and 128).
// * Online softmax in registers: a thread holds 2 rows x 16 keys of the
//   64 x 64 tile, a row's max takes two shuffles within the quad that
//   shares it, and each score's exponential is computed once, as exp2f of
//   the score prescaled by log2(e) (the scale and log2(e) are one float32
//   factor).  Only the tiles that cross the diagonal are masked.
// * O += P V: P is rounded to bf16 in registers and is the A operand of
//   `wgmma m64n{hd}k16` straight from registers (the accumulator fragment
//   of S is the A fragment of the product, so a pair of neighbouring
//   scores packs into one __nv_bfloat162); V is the B operand, MN-major
//   in shared memory through the descriptor's transpose bit; hd 128 runs
//   as two n64 halves.  The row sums l add the float32 p, as SDPA does.
//   O is divided by max(l, 1e-30) at the end and stored as bf16.
// * Numerics: rounding P to bf16 moves an output by at most about
//   2^-9 * max|v| of its row's KV head beyond the float32 plain version,
//   on top of the output's own bf16 rounding; chip_smoke.py's FLASH_TOL
//   states the bound derived from that.
// * Bound on an H100 SXM (989 TFLOP/s bf16 dense, 700 W): 4 * hd flops per
//   (query, key) pair that the causal mask keeps, on the tensor cores:
//   0.0348 ms at granite-3-2b's prefill (BH 256, S = T = 1024, hd 64).
//   At zamba2-7b's (BH 256, g 1, hd 112) the bytes bound it instead: q,
//   k, v read and o written once, 235 MB, 0.070 ms at 3.35 TB/s.  hd 112
//   spends 128/112 of the value product's tensor-core work (the zero
//   columns).
// * Left on the table: one warpgroup does everything in turn (no producer
//   warp, no second consumer warpgroup, no overlap of tile kt + 1's
//   scores with tile kt's softmax); the g query heads of a GQA group each
//   re-read their KV head's tiles (from L2), instead of one block serving
//   the group; models/attention.py permutes q, k and v into this layout
//   and the output back, a copy each way that a kernel reading the
//   model's layout would save; the diagonal tiles are computed whole.
//
// flashattn_kernel<hd, float>: float32 inputs, on the CUDA cores.  TF32
// products would keep 10 mantissa bits, too few for the float32
// tolerance, so float32 keeps the reference's float32 arithmetic:
// * One block per (bh, 64-row query tile), 256 threads: four threads per
//   query row, each holding a quarter of the row's q and of its
//   accumulator in registers, in float4 chunks interleaved so that the
//   four threads of a row read 64 contiguous bytes of a shared-memory row.
//   A row's score is the four partial dots summed with two shuffles; q is
//   scaled by 1/sqrt(hd) before the dot, as the reference does.
// * K and V stream through shared memory in tiles of 64 keys (2 * 64 * hd
//   * 4 bytes: 64 KB at hd = 128, so the launch raises the dynamic
//   shared-memory limit past 48 KB); keys past T are staged as zeros.
// * Products accumulate with explicit fmaf, as the float32 matrix
//   products of the plain version do on the card, so the build's
//   -fmad=false (kept for the distance kernels) does not split them.
// * Bound: the same 4 * hd flops per causal pair, here against the
//   float32 peak of the CUDA cores (67 TFLOP/s on an H100 SXM at 700 W).
// * Left on the table: synchronous staging, expf on all four threads of a
//   row, and a 64-score register array that allows one block per SM.
//
// Both forward kernels take an optional float32 lse (BH, S): when it is
// not null they write each row's log-sum-exp m + log(max(l, 1e-30)) (the
// wgmma kernel converts its log2-domain m by ln 2), the residual the
// backward recomputes the probabilities from.  Serving passes null.
//
// The backward, every head dim above, S <= T with queries aligned to the
// end of the keys.  The reference has no Pallas kernel here: its flash
// backward is the custom VJP of chunked_causal_attention, jnp (_flash_bwd,
// src/repro/models/attention.py:175-208), which these kernels compute:
// delta = rowsum(dO * O); per (query, key) pair the causal mask keeps, p =
// exp((q * scale) . k - lse), ds = p (dO . v - delta) scale; dV = sum p
// dO, dK = sum ds q, dQ = sum ds k.  P is recomputed in float32 from lse,
// as the reference does, also where the bf16 forward rounded it to bf16
// before its value product.  Three launches: delta, dK/dV, dQ.  Neither
// route falls back to the other, and neither uses atomics: each sum (the
// GQA sum over a KV head's g query heads, dQ's over key tiles) runs in one
// block in a fixed order, so two calls give the same bits.
// * flashattn_bwd_delta_kernel<T>: one warp per query row, both routes.
//
// bf16: flashattn_bwd_{dkdv,dq}_wgmma_kernel<hd>, on the tensor cores, the
// forward's building blocks (Tile<hd>, TMA maps, 64 x 64 wgmma tiles, one
// warpgroup per block, a kStages = 2 mbarrier ring refilled by one thread;
// hd 112 on hd 128's tiles, the K-major products stopping after 112
// columns).
// * dkdv: one block per (KV head, 64-key tile), tile 0 (the most query
//   tiles) first.  K and V arrive once by TMA; the block then walks the g
//   query heads of the group and, for each, the query tiles that see its
//   keys, Q and dO tiles streaming through the ring, each stage with the
//   tile's 64 lse and 64 delta floats (copied by the block's 128 threads,
//   one float each, read an item ahead and stored as the stage is
//   refilled: a TMA copy of them would start at any row, and rows past S
//   must read as 0).  Per tile: S^T = K Q^T and dP^T = V dO^T (both
//   operands K-major in shared memory), P^T = exp2(S^T scale log2(e) -
//   lse log2(e)) and dS^T = P^T (dP^T - delta) scale in float32
//   registers, masked on tiles that cross the diagonal or run past S (TMA
//   zero-fills Q rows past S, but exp of 0 - an unloaded lse is not 0);
//   then dV += P^T dO and dK += dS^T Q with A from registers and dO or Q
//   as the MN-major B, as the forward's V.
// * dq: one block per (query head, 64-row tile), longest rows first, the
//   forward's layout: Q and dO once, K and V tiles through the ring; S = Q
//   K^T, dP = dO V^T, P and dS per row from the row's lse and delta in
//   registers, dQ += dS K (K MN-major).
// * Rounding: P and dS enter the tensor cores as hi + lo bf16 pairs (hi =
//   bf16(x), lo = bf16(x - hi), x - hi exact in float32), two wgmma per
//   product, so about 16 bits of each survive: a single bf16 rounding, as
//   SDPA's backward does, misses chip_smoke.py's BWD_TOL by tens of times
//   on seeded normal inputs, the pair passes it at the float32
//   arithmetic's margin (tests/test_torch_flashattn.py emulates both).
//   q, k, v and dO are bf16 already, so S and dP are exact products with
//   float32 sums.  Outputs are rounded once to bf16.
// * Bound on an H100 SXM: five products of 2 * hd flops per causal pair
//   (scores, dO V^T, dV, dQ, dK) at the tensor cores' bf16 peak, 0.087
//   ms at granite-3-2b's training shape (BH 256, S = T = 1024, hd 64, g
//   4).  The kernels run ten: S and dP in both kernels, and dV, dK and dQ
//   twice (hi and lo), about 0.17 ms at that peak; the diagonal tiles are
//   computed whole.
// * Left on the table: one warpgroup does everything in turn (no producer
//   warp, no second consumer warpgroup, no overlap of one tile's products
//   with the next tile's exponentials); S and dP are computed twice, once
//   per kernel; the last key tiles of the dK/dV grid walk g query tiles,
//   the first g * S / 64 (no persistent grid to balance them).
//
// float32: flashattn_bwd_{dkdv,dq}_kernel<hd, float>, on the CUDA cores
// in float32 arithmetic (TF32 keeps 10 bits, too few for BWD_TOL's
// float32 row).
// * dkdv: one block per (KV head, 64-key tile), four threads per key
//   holding k, v and the dk, dv sums in registers; the block walks the
//   group's query heads and tiles as the bf16 kernel does, each staged in
//   shared memory (q, dO, lse, delta).
// * dq: one block per (query head, 64-row tile), the forward's layout,
//   over the visible K/V tiles.
// * Left on the table: each pair's exp is computed by four threads, and
//   each query row's q and dO are read from shared memory once per key
//   thread.
#include <cuda.h>  // CUtensorMap and its enums; the CUDA driver's entry
                   // point is looked up at run time, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlockQ = 64;                  // query rows per block
constexpr int kBlockK = 64;                  // keys per shared-memory tile
constexpr float kNegInf = -1e30f;            // the reference's sentinel

// ---------------------------------------------------------------------
// float32: the CUDA-core kernel.
// ---------------------------------------------------------------------
constexpr int kLanes = 4;                    // threads per query row
constexpr int kThreads = kBlockQ * kLanes;   // 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

template <typename T>
__device__ __forceinline__ float4 load4(const T* p, float scale) {
  return make_float4(to_f32(p[0]) * scale, to_f32(p[1]) * scale,
                     to_f32(p[2]) * scale, to_f32(p[3]) * scale);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flashattn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s_len, int t_len, int g,
                 float scale) {
  constexpr int kRow4 = HD / 4;              // float4 chunks in a row
  constexpr int kVec = kRow4 / kLanes;       // chunks per thread
  static_assert(kVec >= 1 && kRow4 % kLanes == 0, "hd must be 16..128");
  extern __shared__ float4 smem[];
  float4* ks = smem;                         // [kBlockK][kRow4]
  float4* vs = smem + kBlockK * kRow4;

  const int bh = blockIdx.x;
  // The longest causal rows first: they take the most key tiles.
  const int qtile = gridDim.y - 1 - blockIdx.y;
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int qi = qtile * kBlockQ + row;
  const int offset = t_len - s_len;          // >= 0, checked by the wrapper
  const int q_pos = offset + qi;
  const T* kb = k + static_cast<size_t>(bh / g) * t_len * HD;
  const T* vb = v + static_cast<size_t>(bh / g) * t_len * HD;

  // Chunk c of this thread is the row's float4 number c * kLanes + lane.
  float4 qr[kVec], acc[kVec];
  const T* qrow = q + (static_cast<size_t>(bh) * s_len + qi) * HD;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    qr[c] = qi < s_len ? load4(qrow + (c * kLanes + lane) * 4, scale)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // Keys up to the position of the block's last valid row.
  const int last_row = min(s_len, (qtile + 1) * kBlockQ) - 1;
  const int n_tiles = (offset + last_row) / kBlockK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                         // the previous tile is used up
    for (int i = threadIdx.x; i < kBlockK * kRow4; i += kThreads) {
      const int r = i / kRow4;
      const int c4 = i % kRow4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < t_len) {
        const size_t at = static_cast<size_t>(k0 + r) * HD + c4 * 4;
        kv = load4(kb + at, 1.f);
        vv = load4(vb + at, 1.f);
      }
      ks[i] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    float sc[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float4 kk = ks[j * kRow4 + c * kLanes + lane];
        part = fmaf(qr[c].x, kk.x, part);
        part = fmaf(qr[c].y, kk.y, part);
        part = fmaf(qr[c].z, kk.z, part);
        part = fmaf(qr[c].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      sc[j] = k0 + j <= q_pos ? part : kNegInf;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      acc[c].x *= corr;
      acc[c].y *= corr;
      acc[c].z *= corr;
      acc[c].w *= corr;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float4 vv = vs[j * kRow4 + c * kLanes + lane];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (qi < s_len) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * s_len + qi) * HD;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      T* p = orow + (c * kLanes + lane) * 4;
      store_out(p + 0, acc[c].x / denom);
      store_out(p + 1, acc[c].y / denom);
      store_out(p + 2, acc[c].z / denom);
      store_out(p + 3, acc[c].w / denom);
    }
    if (lse != nullptr && lane == 0)
      lse[static_cast<size_t>(bh) * s_len + qi] = m + logf(denom);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int s_len, int t_len, int g, float scale,
               cudaStream_t stream) {
  const int smem = 2 * kBlockK * HD * static_cast<int>(sizeof(float));
  auto* kern = flashattn_kernel<HD, float>;
  if (smem > 48 * 1024) {
    // Once per instantiation (and so outside any graph capture after the
    // first call): lift the dynamic shared-memory limit.
    static const cudaError_t set = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return set;
  }
  const dim3 grid(bh, (s_len + kBlockQ - 1) / kBlockQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, s_len, t_len,
      g, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16: the tensor-core kernel.
// ---------------------------------------------------------------------
constexpr int kWgThreads = 128;              // one warpgroup
constexpr int kStages = 2;                   // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry of one 64-row tile of Q, K or V at head dim HD:
// kBoxes TMA boxes of kBox columns, each box kBlockK rows of kRowBytes
// (the swizzle span), boxes one after another.  kCols = kBoxes * kBox
// columns are held: HD itself, except 128 at HD = 112, where the last
// box runs 16 columns past the tensor's edge (zero-filled by TMA).
template <int HD>
struct Tile {
  static constexpr int kBox = HD < 64 ? HD : 64;
  static constexpr int kBoxes = (HD + kBox - 1) / kBox;
  static constexpr int kCols = kBoxes * kBox;
  static constexpr int kRowBytes = kBox * 2;
  static constexpr int kBoxBytes = kBlockK * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  // wgmma descriptor layout type of the swizzle: 1 = 128 B, 2 = 64 B,
  // 3 = 32 B; and the TMA swizzle of the same span.
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : (kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B);
  // Q, then kStages (K, V) pairs, each tile 1024-byte aligned (the
  // swizzle pattern repeats every 1024 bytes), plus alignment slack.
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also sets the bytes the barrier's phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier has completed the phase of parity `phase`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
  __syncwarp();  // the warp leaves the spin together (wgmma is .aligned)
}

// TMA: the box at coordinates (c0, c1, c2), innermost first, of `map`
// into shared memory at `dst`; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Keeps the compiler from moving reads of wgmma accumulators above the
// wait that makes them valid.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand (rows x HD, HD contiguous; Q as A, K as B of Q K^T), the
// 16 columns of k-step kk: within a box, a k-step is 32 bytes further
// along the row; 8-row groups are 8 rows apart (SBO); LBO is unused.
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using G = Tile<HD>;
  const int col = kk * 16;
  return smem_desc(tile + (col / G::kBox) * G::kBoxBytes + (col % G::kBox) * 2,
                   16, 8 * G::kRowBytes, G::kLayout);
}

// MN-major operand (V: keys x kBox, the N dimension contiguous), the 16
// keys of k-step kk of box `box`: 16 rows further; the two 8-key halves
// of the step are 8 rows apart (SBO); N fits one swizzle atom (LBO unused).
template <int HD>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int box,
                                                 int kk) {
  using G = Tile<HD>;
  return smem_desc(tile + box * G::kBoxBytes + kk * 16 * G::kRowBytes,
                   G::kBoxBytes, 8 * G::kRowBytes, G::kLayout);
}

// D (64 x 64, f32) = A (64 x 16, shared, K-major) * B (64 x 16, shared,
// K-major) + (scale_d ? D : 0).
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, f32) += A (64 x 16 bf16, registers) * B (16 x 16, shared,
// MN-major: the transpose bit).
__device__ __forceinline__ void mma_rs_n16(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16 bf16, registers) * B (16 x 32, shared,
// MN-major: the transpose bit).
__device__ __forceinline__ void mma_rs_n32(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16 bf16, registers) * B (16 x 64, shared,
// MN-major: the transpose bit).
__device__ __forceinline__ void mma_rs_n64(float* d, const uint32_t* a,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db) {
  if constexpr (N == 16) mma_rs_n16(d, a, db);
  else if constexpr (N == 32) mma_rs_n32(d, a, db);
  else mma_rs_n64(d, a, db);
}

// Fragment layout of a wgmma m64nN float32 accumulator: thread t of the
// warpgroup (warp w = t / 32, lane) holds element i (0 <= i < N / 2) at
// row 16 w + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4)
// + i % 2.  So each thread holds two rows, r and r + 8.
template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flashattn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int s_len, int t_len, int g,
                       float scale_log2) {
  using G = Tile<HD>;
  constexpr int kN = HD < 64 ? HD : 64;      // columns of one value product
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // K/V stages, Q
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bar_q = smem_u32(&bars[kStages]);

  const int bh = blockIdx.x;
  // The longest causal rows first: they take the most key tiles.
  const int qtile = gridDim.y - 1 - blockIdx.y;
  const int kvh = bh / g;
  const int offset = t_len - s_len;          // >= 0, checked by the wrapper
  const int last_row = min(s_len, (qtile + 1) * kBlockQ) - 1;
  const int n_tiles = (offset + last_row) / kBlockK + 1;
  const int tid = threadIdx.x;

  // Stage st holds K at base + (1 + 2 st) tiles and V right after it.
  auto load_kv = [&](int kt, int st) {
    const uint32_t bar = smem_u32(&bars[st]);
    const uint32_t sk = base + (1 + 2 * st) * G::kBytes;
    mbar_expect_tx(bar, 2 * G::kBytes);
#pragma unroll
    for (int b = 0; b < G::kBoxes; ++b) {
      tma_load(sk + b * G::kBoxBytes, &tk, bar, b * G::kBox, kt * kBlockK,
               kvh);
      tma_load(sk + G::kBytes + b * G::kBoxBytes, &tv, bar, b * G::kBox,
               kt * kBlockK, kvh);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, G::kBytes);
#pragma unroll
    for (int b = 0; b < G::kBoxes; ++b)
      tma_load(sq + b * G::kBoxBytes, &tq, bar_q, b * G::kBox,
               qtile * kBlockQ, bh);
    for (int kt = 0; kt < kStages && kt < n_tiles; ++kt) load_kv(kt, kt);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);    // this thread's rows: r0, r0 + 8
  const int c0 = (lane & 3) * 2;             // its first column in each 8
  const int pos0 = offset + qtile * kBlockQ + r0;  // key position of row r0
  float oacc[G::kCols / 2];                  // columns past HD stay 0
#pragma unroll
  for (int i = 0; i < G::kCols / 2; ++i) oacc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kStages;
    const uint32_t sk = base + (1 + 2 * st) * G::kBytes;
    const uint32_t sv = sk + G::kBytes;
    mbar_wait(smem_u32(&bars[st]), (kt / kStages) & 1);

    // S = Q K^T, float32, unscaled.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss_n64(s, kmajor_desc<HD>(sq, kk), kmajor_desc<HD>(sk, kk),
                 kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Scale into the log2 domain, mask the diagonal tiles, row maxima.
    const int k0 = kt * kBlockK;
    const bool diag = k0 + kBlockK - 1 > offset + qtile * kBlockQ;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i >> 1) & 1;
      const int key = k0 + (i >> 2) * 8 + c0 + (i & 1);
      float x = s[i] * scale_log2;
      if (diag && key > pos0 + (hi ? 8 : 0)) x = kNegInf;
      s[i] = x;
      if (hi) mx1 = fmaxf(mx1, x);
      else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp2(s - m), once per score; rounded to bf16 as the A fragments
    // of the 4 k-steps (16 keys each) of the value product.  Row sums of
    // the float32 P stay per thread until the end.
    uint32_t pa[4][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const bool hi = (i >> 1) & 1;
      const float mm = hi ? mn1 : mn0;
      const float p_lo = exp2f(s[i] - mm), p_hi = exp2f(s[i + 1] - mm);
      if (hi) ps1 += p_lo + p_hi;
      else ps0 += p_lo + p_hi;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p_lo, p_hi);
    }
    l0 = fmaf(l0, corr0, ps0);
    l1 = fmaf(l1, corr1, ps1);
#pragma unroll
    for (int i = 0; i < G::kCols / 2; ++i)
      oacc[i] *= ((i >> 1) & 1) ? corr1 : corr0;

    // O += P V.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
      for (int b = 0; b < G::kBoxes; ++b)
        mma_rs<kN>(oacc + b * (kN / 2), pa[kk], mnmajor_desc<HD>(sv, b, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);

    // Every warp is done with stage st: refill it with tile kt + kStages.
    __syncthreads();
    if (tid == 0 && kt + kStages < n_tiles) load_kv(kt + kStages, st);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int qi0 = qtile * kBlockQ + r0;
  // The row's log-sum-exp in natural units: m is in the log2 domain.
  if (lse != nullptr && (lane & 3) == 0) {
    float* row_lse = lse + static_cast<size_t>(bh) * s_len;
    if (qi0 < s_len) row_lse[qi0] = m0 * kLn2 + logf(den0);
    if (qi0 + 8 < s_len) row_lse[qi0 + 8] = m1 * kLn2 + logf(den1);
  }
  // Element i lies in column 8 (i / 4) + ..., so i < HD / 2 stores
  // exactly the columns below HD.
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const bool hi = (i >> 1) & 1;
    const int qi = qi0 + (hi ? 8 : 0);
    if (qi < s_len) {
      const float den = hi ? den1 : den0;
      const int col = (i >> 2) * 8 + c0;
      *reinterpret_cast<__nv_bfloat162*>(
          o + (static_cast<size_t>(bh) * s_len + qi) * HD + col) =
          __floats2bfloat162_rn(oacc[i] / den, oacc[i + 1] / den);
    }
  }
}

// cuTensorMapEncodeTiled, from the CUDA driver through the runtime's
// entry point lookup (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over (heads, rows, HD) bf16, contiguous, in boxes of
// (1, kBlockK, kBox); out-of-range rows (and at HD = 112 the columns
// 112-127 of the second box) read as zeros.
template <int HD>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int heads,
            int rows) {
  using G = Tile<HD>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(rows) * HD * 2};
  const cuuint32_t box[3] = {G::kBox, kBlockK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, G::kSwizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int s_len, int t_len, int g, float scale,
                cudaStream_t stream) {
  using G = Tile<HD>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode<HD>(fn, &tq, q, bh, s_len) ||
      !encode<HD>(fn, &tk, k, bh / g, t_len) ||
      !encode<HD>(fn, &tv, v, bh / g, t_len))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kern = flashattn_wgmma_kernel<HD>;
  // Once per instantiation (and so outside any graph capture after the
  // first call).
  static const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (set != cudaSuccess) return set;
  const dim3 grid(bh, (s_len + kBlockQ - 1) / kBlockQ);
  kern<<<grid, kWgThreads, G::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, s_len, t_len, g,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int HD>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           float* lse, int bh, int s_len, int t_len, int g, float scale,
           cudaStream_t stream) {
  return bf16 ? launch_bf16<HD>(q, k, v, o, lse, bh, s_len, t_len, g, scale,
                                stream)
              : launch_f32<HD>(q, k, v, o, lse, bh, s_len, t_len, g, scale,
                               stream);
}

int launch_hd(bool bf16, const void* q, const void* k, const void* v,
              void* o, void* lse, int bh, int s_len, int t_len, int hd, int g,
              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 16: return launch<16>(bf16, q, k, v, o, l, bh, s_len, t_len, g, scale, st);
    case 32: return launch<32>(bf16, q, k, v, o, l, bh, s_len, t_len, g, scale, st);
    case 64: return launch<64>(bf16, q, k, v, o, l, bh, s_len, t_len, g, scale, st);
    case 112: return launch<112>(bf16, q, k, v, o, l, bh, s_len, t_len, g, scale, st);
    case 128: return launch<128>(bf16, q, k, v, o, l, bh, s_len, t_len, g, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------
// Backward: the delta kernel (both routes), then the float32 route's two
// kernels on the CUDA cores.
// ---------------------------------------------------------------------
constexpr int kDeltaRows = 8;                // rows (one warp each) a block

// delta[r] = sum_d do[r, d] * o[r, d] in float32, one warp per row of the
// (rows, hd) tensors; lanes take every 32nd column, then a butterfly sum.
template <typename T>
__global__ void __launch_bounds__(kDeltaRows * 32)
flashattn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                           float* __restrict__ delta, int rows, int hd) {
  const int r = blockIdx.x * kDeltaRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;                     // whole warps only
  const T* orow = o + static_cast<size_t>(r) * hd;
  const T* drow = dout + static_cast<size_t>(r) * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32)
    acc = fmaf(to_f32(drow[c]), to_f32(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// dK and dV of one KV head's tile of kBlockK keys.  Four threads per key
// (the forward's layout, with keys in place of query rows), each holding a
// quarter of the key's k and v and of its dk and dv accumulators in
// registers.  The block walks the g query heads of the group in order and,
// for each, the query tiles that can see its keys, staging each tile's q
// and dO (and their lse and delta) in shared memory; per query row it
// recomputes p = exp((q * scale) . k - lse) under the causal mask, dp =
// dO . v, ds = p (dp - delta) scale, and adds p dO to dv and ds q to dk.
// The whole GQA sum happens in this block in a fixed order: no atomics,
// and two calls give the same bits.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flashattn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int s_len,
                          int t_len, int g, float scale) {
  constexpr int kRow4 = HD / 4;
  constexpr int kVec = kRow4 / kLanes;
  static_assert(kVec >= 1 && kRow4 % kLanes == 0, "hd must be 16..128");
  extern __shared__ float4 smem[];
  float4* qs = smem;                         // [kBlockQ][kRow4], unscaled
  float4* ds = smem + kBlockQ * kRow4;       // dO tile
  float* lse_s = reinterpret_cast<float*>(smem + 2 * kBlockQ * kRow4);
  float* delta_s = lse_s + kBlockQ;

  const int kvh = blockIdx.x;
  const int ktile = blockIdx.y;              // tile 0 sees the most queries
  const int key = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int kj = ktile * kBlockK + key;      // this thread's key position
  const int offset = t_len - s_len;          // >= 0, checked by the wrapper

  float4 kr[kVec], vr[kVec], dka[kVec], dva[kVec];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t krow = (static_cast<size_t>(kvh) * t_len + kj) * HD;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const int at = (c * kLanes + lane) * 4;
    kr[c] = kj < t_len ? load4(k + krow + at, 1.f) : zero;
    vr[c] = kj < t_len ? load4(v + krow + at, 1.f) : zero;
    dka[c] = zero;
    dva[c] = zero;
  }

  // Query rows at positions below the tile's first key see none of it.
  const int first_row = max(0, ktile * kBlockK - offset);
  const int n_qtiles = (s_len + kBlockQ - 1) / kBlockQ;
  for (int j = 0; j < g; ++j) {
    const int bh = kvh * g + j;
    for (int qt = first_row / kBlockQ; qt < n_qtiles; ++qt) {
      const int i0 = qt * kBlockQ;
      const int rows = min(kBlockQ, s_len - i0);
      __syncthreads();                       // the previous tile is used up
      for (int i = threadIdx.x; i < kBlockQ * kRow4; i += kThreads) {
        const int r = i / kRow4;
        float4 qv = zero, dov = zero;
        if (r < rows) {
          const size_t at = (static_cast<size_t>(bh) * s_len + i0 + r) * HD +
                            (i % kRow4) * 4;
          qv = load4(q + at, 1.f);
          dov = load4(dout + at, 1.f);
        }
        qs[i] = qv;
        ds[i] = dov;
      }
      if (threadIdx.x < rows) {
        const size_t at = static_cast<size_t>(bh) * s_len + i0 + threadIdx.x;
        lse_s[threadIdx.x] = lse[at];
        delta_s[threadIdx.x] = delta[at];
      }
      __syncthreads();

      for (int r = 0; r < rows; ++r) {
        float sc = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float4 qq = qs[r * kRow4 + c * kLanes + lane];
          const float4 dd = ds[r * kRow4 + c * kLanes + lane];
          sc = fmaf(qq.x * scale, kr[c].x, sc);
          sc = fmaf(qq.y * scale, kr[c].y, sc);
          sc = fmaf(qq.z * scale, kr[c].z, sc);
          sc = fmaf(qq.w * scale, kr[c].w, sc);
          dp = fmaf(dd.x, vr[c].x, dp);
          dp = fmaf(dd.y, vr[c].y, dp);
          dp = fmaf(dd.z, vr[c].z, dp);
          dp = fmaf(dd.w, vr[c].w, dp);
        }
        sc += __shfl_xor_sync(0xffffffffu, sc, 1);
        sc += __shfl_xor_sync(0xffffffffu, sc, 2);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 2);
        // Keys past T sit above every query row's position: masked too.
        const float p = kj <= offset + i0 + r ? expf(sc - lse_s[r]) : 0.f;
        const float dsc = p * (dp - delta_s[r]) * scale;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float4 qq = qs[r * kRow4 + c * kLanes + lane];
          const float4 dd = ds[r * kRow4 + c * kLanes + lane];
          dva[c].x = fmaf(p, dd.x, dva[c].x);
          dva[c].y = fmaf(p, dd.y, dva[c].y);
          dva[c].z = fmaf(p, dd.z, dva[c].z);
          dva[c].w = fmaf(p, dd.w, dva[c].w);
          dka[c].x = fmaf(dsc, qq.x, dka[c].x);
          dka[c].y = fmaf(dsc, qq.y, dka[c].y);
          dka[c].z = fmaf(dsc, qq.z, dka[c].z);
          dka[c].w = fmaf(dsc, qq.w, dka[c].w);
        }
      }
    }
  }

  if (kj < t_len) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const size_t at = krow + (c * kLanes + lane) * 4;
      store_out(dk + at + 0, dka[c].x);
      store_out(dk + at + 1, dka[c].y);
      store_out(dk + at + 2, dka[c].z);
      store_out(dk + at + 3, dka[c].w);
      store_out(dv + at + 0, dva[c].x);
      store_out(dv + at + 1, dva[c].y);
      store_out(dv + at + 2, dva[c].z);
      store_out(dv + at + 3, dva[c].w);
    }
  }
}

// dQ of one query head's tile of kBlockQ rows: the forward's layout (four
// threads per row; q scaled by 1/sqrt(hd) and dO in registers, K and V
// tiles of kBlockK keys staged in shared memory, only the tiles the causal
// mask leaves visible); per key, p and ds as in the dK/dV kernel, and dq
// += ds k.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flashattn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int s_len, int t_len, int g, float scale) {
  constexpr int kRow4 = HD / 4;
  constexpr int kVec = kRow4 / kLanes;
  static_assert(kVec >= 1 && kRow4 % kLanes == 0, "hd must be 16..128");
  extern __shared__ float4 smem[];
  float4* ks = smem;                         // [kBlockK][kRow4]
  float4* vs = smem + kBlockK * kRow4;

  const int bh = blockIdx.x;
  const int qtile = gridDim.y - 1 - blockIdx.y;  // the longest rows first
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int qi = qtile * kBlockQ + row;
  const bool valid = qi < s_len;
  const int offset = t_len - s_len;
  const int q_pos = offset + qi;
  const T* kb = k + static_cast<size_t>(bh / g) * t_len * HD;
  const T* vb = v + static_cast<size_t>(bh / g) * t_len * HD;

  float4 qr[kVec], dor[kVec], dqa[kVec];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t qrow = (static_cast<size_t>(bh) * s_len + qi) * HD;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    const int at = (c * kLanes + lane) * 4;
    qr[c] = valid ? load4(q + qrow + at, scale) : zero;
    dor[c] = valid ? load4(dout + qrow + at, 1.f) : zero;
    dqa[c] = zero;
  }
  const size_t at_row = static_cast<size_t>(bh) * s_len + qi;
  const float lse_i = valid ? lse[at_row] : 0.f;
  const float delta_i = valid ? delta[at_row] : 0.f;

  const int last_row = min(s_len, (qtile + 1) * kBlockQ) - 1;
  const int n_tiles = (offset + last_row) / kBlockK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                         // the previous tile is used up
    for (int i = threadIdx.x; i < kBlockK * kRow4; i += kThreads) {
      const int r = i / kRow4;
      float4 kv = zero, vv = zero;
      if (k0 + r < t_len) {
        const size_t at = static_cast<size_t>(k0 + r) * HD + (i % kRow4) * 4;
        kv = load4(kb + at, 1.f);
        vv = load4(vb + at, 1.f);
      }
      ks[i] = kv;
      vs[i] = vv;
    }
    __syncthreads();

    for (int jj = 0; jj < kBlockK; ++jj) {
      float sc = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float4 kk = ks[jj * kRow4 + c * kLanes + lane];
        const float4 vv = vs[jj * kRow4 + c * kLanes + lane];
        sc = fmaf(qr[c].x, kk.x, sc);
        sc = fmaf(qr[c].y, kk.y, sc);
        sc = fmaf(qr[c].z, kk.z, sc);
        sc = fmaf(qr[c].w, kk.w, sc);
        dp = fmaf(dor[c].x, vv.x, dp);
        dp = fmaf(dor[c].y, vv.y, dp);
        dp = fmaf(dor[c].z, vv.z, dp);
        dp = fmaf(dor[c].w, vv.w, dp);
      }
      sc += __shfl_xor_sync(0xffffffffu, sc, 1);
      sc += __shfl_xor_sync(0xffffffffu, sc, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const float p = valid && k0 + jj <= q_pos ? expf(sc - lse_i) : 0.f;
      const float dsc = p * (dp - delta_i) * scale;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float4 kk = ks[jj * kRow4 + c * kLanes + lane];
        dqa[c].x = fmaf(dsc, kk.x, dqa[c].x);
        dqa[c].y = fmaf(dsc, kk.y, dqa[c].y);
        dqa[c].z = fmaf(dsc, kk.z, dqa[c].z);
        dqa[c].w = fmaf(dsc, kk.w, dqa[c].w);
      }
    }
  }

  if (valid) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      T* p = dq + qrow + (c * kLanes + lane) * 4;
      store_out(p + 0, dqa[c].x);
      store_out(p + 1, dqa[c].y);
      store_out(p + 2, dqa[c].z);
      store_out(p + 3, dqa[c].w);
    }
  }
}

// ---------------------------------------------------------------------
// Backward, bf16: the two tensor-core kernels.
// ---------------------------------------------------------------------

// Two floats as a hi + lo pair of bf16x2 words: hi = bf16(x), lo =
// bf16(x - hi); x - hi is exact in float32, so hi + lo keeps about 16
// bits of x.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// The 32 float32 accumulators of a 64 x 64 wgmma tile as the hi and lo A
// fragments of the 4 k-steps (16 columns each) of a product over its
// columns: the accumulator fragment is the A fragment, as in the forward.
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    split_bf16(x[i], x[i + 1], hi[i / 8][(i % 8) / 2], lo[i / 8][(i % 8) / 2]);
}

// D (64 x 64) = A B^T for two 64-row tiles in shared memory, both K-major
// (A at `a`, B at `b`), over the first HD columns.
template <int HD>
__device__ __forceinline__ void mma_ss_tiles(float (&d)[32], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma_ss_n64(d, kmajor_desc<HD>(a, kk), kmajor_desc<HD>(b, kk), kk > 0);
}

// D (64 x kCols) += (hi + lo) B: A a 64 x 64 pair of register fragments,
// B the 64-row tile at `tile`, MN-major (the forward's V); hi then lo at
// each k-step, a fixed order.
template <int HD>
__device__ __forceinline__ void mma_rs_pair(float* d,
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4],
                                            uint32_t tile) {
  using G = Tile<HD>;
  constexpr int kN = HD < 64 ? HD : 64;
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
    for (int b = 0; b < G::kBoxes; ++b) {
      mma_rs<kN>(d + b * (kN / 2), hi[kk], mnmajor_desc<HD>(tile, b, kk));
      mma_rs<kN>(d + b * (kN / 2), lo[kk], mnmajor_desc<HD>(tile, b, kk));
    }
  }
}

// Shared memory of the dK/dV kernel: K and V, kStages (Q, dO) pairs, each
// tile 1024-byte aligned, then kStages rows of kBlockQ lse and kBlockQ
// delta floats (thread t copies float t of a stage's row).
template <int HD>
struct DkdvSmem {
  static constexpr int kRowFloats = 2 * kBlockQ;
  static_assert(kRowFloats == kWgThreads, "one row float per thread");
  static constexpr int kBytes = (2 + 2 * kStages) * Tile<HD>::kBytes +
                                kStages * kRowFloats * 4 + 1024;
};

// dK and dV of one KV head's tile of kBlockK keys: the forward's
// structure with keys as the rows (one warpgroup; thread t holds key rows
// r0 and r0 + 8 of the 64 x 64 S^T and dP^T tiles, and of dK and dV).
template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flashattn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int s_len,
                                int t_len, int g, float scale) {
  using G = Tile<HD>;
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // Q/dO stages, K/V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + G::kBytes;
  // Stage st: Q at tile 2 + 2 st, dO right after it; its lse and delta
  // rows after every tile.
  float* rows = reinterpret_cast<float*>(
      smem_raw + (base - raw) + (2 + 2 * kStages) * G::kBytes);
  const uint32_t bar_kv = smem_u32(&bars[kStages]);

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;       // tile 0 sees the most queries
  const int offset = t_len - s_len;          // >= 0, checked by the wrapper
  // Query rows at positions below the tile's first key see none of it.
  const int first_qt = max(0, k0 - offset) / kBlockQ;
  const int per_head = (s_len + kBlockQ - 1) / kBlockQ - first_qt;
  const int n_items = g * per_head;          // (query head, query tile)s
  const int tid = threadIdx.x;

  // Item it is query head kvh g + it / per_head, query tile first_qt + it
  // % per_head.  Its Q and dO tiles come by TMA; its lse and delta rows
  // (rows past S read as 0) by the threads, one float each.
  auto load_q = [&](int it, int st) {
    const int bh = kvh * g + it / per_head;
    const int i0 = (first_qt + it % per_head) * kBlockQ;
    const uint32_t bar = smem_u32(&bars[st]);
    const uint32_t sq = base + (2 + 2 * st) * G::kBytes;
    mbar_expect_tx(bar, 2 * G::kBytes);
#pragma unroll
    for (int b = 0; b < G::kBoxes; ++b) {
      tma_load(sq + b * G::kBoxBytes, &tq, bar, b * G::kBox, i0, bh);
      tma_load(sq + G::kBytes + b * G::kBoxBytes, &tdo, bar, b * G::kBox,
               i0, bh);
    }
  };
  auto row_value = [&](int it) {
    const int bh = kvh * g + it / per_head;
    const int qi = (first_qt + it % per_head) * kBlockQ + tid % kBlockQ;
    const float* src = tid < kBlockQ ? lse : delta;
    return qi < s_len ? src[static_cast<size_t>(bh) * s_len + qi] : 0.f;
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int it = 0; it < kStages && it < n_items; ++it)
    rows[it * DkdvSmem<HD>::kRowFloats + tid] = row_value(it);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * G::kBytes);
#pragma unroll
    for (int b = 0; b < G::kBoxes; ++b) {
      tma_load(sk + b * G::kBoxBytes, &tk, bar_kv, b * G::kBox, k0, kvh);
      tma_load(sv + b * G::kBoxBytes, &tv, bar_kv, b * G::kBox, k0, kvh);
    }
    for (int it = 0; it < kStages && it < n_items; ++it) load_q(it, it);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);    // this thread's keys: r0, r0 + 8
  const int c0 = (lane & 3) * 2;             // its first column in each 8
  const int key0 = k0 + r0;                  // key position of row r0
  const float scale_log2 = scale * kLog2e;
  float dka[G::kCols / 2], dva[G::kCols / 2];  // columns past HD stay 0
#pragma unroll
  for (int i = 0; i < G::kCols / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_items; ++it) {
    const int st = it % kStages;
    const int i0 = (first_qt + it % per_head) * kBlockQ;
    const uint32_t sq = base + (2 + 2 * st) * G::kBytes;
    const uint32_t sdo = sq + G::kBytes;
    const float* lse_s = rows + st * DkdvSmem<HD>::kRowFloats;
    const float* delta_s = lse_s + kBlockQ;
    // Item it + kStages's row float, read now, stored after this item.
    const float next_row =
        it + kStages < n_items ? row_value(it + kStages) : 0.f;
    mbar_wait(smem_u32(&bars[st]), (it / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T, float32, unscaled.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    mma_ss_tiles<HD>(s, sk, sq);
    mma_ss_tiles<HD>(dp, sv, sdo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in place.  Element i is key row r0 + 8 ((i / 2) % 2)
    // and query column 8 (i / 4) + c0 + i % 2 of the tile, whose lse and
    // delta come from the stage's rows.  Masked: keys after the query's
    // position (keys past T among them) and query rows past S.
    const bool edge = k0 + kBlockK - 1 > offset + i0 || i0 + kBlockQ > s_len;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i >> 2) * 8 + c0 + (i & 1);
      const int key = key0 + ((i >> 1) & 1) * 8;
      float p = 0.f, ds = 0.f;
      if (!edge || (i0 + col < s_len && key <= offset + i0 + col)) {
        p = exp2f(fmaf(s[i], scale_log2, -(lse_s[col] * kLog2e)));
        ds = p * (dp[i] - delta_s[col]) * scale;
      }
      s[i] = p;
      dp[i] = ds;
    }
    uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
    split_frags(s, ph, pl);
    split_frags(dp, dh, dl);

    // dV += P^T dO and dK += dS^T Q.
    wgmma_fence();
    mma_rs_pair<HD>(dva, ph, pl, sdo);
    mma_rs_pair<HD>(dka, dh, dl, sq);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);

    // Every warp is done with stage st: refill it with item it + kStages
    // (the rows are read again only after the next item's barrier).
    __syncthreads();
    if (it + kStages < n_items) {
      rows[st * DkdvSmem<HD>::kRowFloats + tid] = next_row;
      if (tid == 0) load_q(it + kStages, st);
    }
  }

  // Element i lies in column 8 (i / 4) + ..., so i < HD / 2 stores
  // exactly the columns below HD; keys past T are not stored.
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int kj = key0 + ((i >> 1) & 1) * 8;
    if (kj < t_len) {
      const size_t at = (static_cast<size_t>(kvh) * t_len + kj) * HD +
                        (i >> 2) * 8 + c0;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[i], dka[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[i], dva[i + 1]);
    }
  }
}

// dQ of one query head's tile of kBlockQ rows: the forward's layout (thread
// t holds query rows r0 and r0 + 8), over the K/V tiles the causal mask
// leaves visible, in order.
template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flashattn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int s_len,
                              int t_len, int g, float scale) {
  using G = Tile<HD>;
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // K/V stages, Q/dO
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + G::kBytes;
  const uint32_t bar_q = smem_u32(&bars[kStages]);

  const int bh = blockIdx.x;
  // The longest causal rows first: they take the most key tiles.
  const int qtile = gridDim.y - 1 - blockIdx.y;
  const int kvh = bh / g;
  const int offset = t_len - s_len;          // >= 0, checked by the wrapper
  const int last_row = min(s_len, (qtile + 1) * kBlockQ) - 1;
  const int n_tiles = (offset + last_row) / kBlockK + 1;
  const int tid = threadIdx.x;

  // Stage st holds K at tile 2 + 2 st and V right after it.
  auto load_kv = [&](int kt, int st) {
    const uint32_t bar = smem_u32(&bars[st]);
    const uint32_t sk = base + (2 + 2 * st) * G::kBytes;
    mbar_expect_tx(bar, 2 * G::kBytes);
#pragma unroll
    for (int b = 0; b < G::kBoxes; ++b) {
      tma_load(sk + b * G::kBoxBytes, &tk, bar, b * G::kBox, kt * kBlockK,
               kvh);
      tma_load(sk + G::kBytes + b * G::kBoxBytes, &tv, bar, b * G::kBox,
               kt * kBlockK, kvh);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * G::kBytes);
#pragma unroll
    for (int b = 0; b < G::kBoxes; ++b) {
      tma_load(sq + b * G::kBoxBytes, &tq, bar_q, b * G::kBox,
               qtile * kBlockQ, bh);
      tma_load(sdo + b * G::kBoxBytes, &tdo, bar_q, b * G::kBox,
               qtile * kBlockQ, bh);
    }
    for (int kt = 0; kt < kStages && kt < n_tiles; ++kt) load_kv(kt, kt);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);    // this thread's rows: r0, r0 + 8
  const int c0 = (lane & 3) * 2;             // its first column in each 8
  const int pos0 = offset + qtile * kBlockQ + r0;  // key position of row r0
  const int qi0 = qtile * kBlockQ + r0;
  const float scale_log2 = scale * kLog2e;
  // Each row's lse (in the log2 domain) and delta; rows past S (zero Q
  // and dO, not stored) take 0.
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qi0 + 8 * h;
    const size_t at = static_cast<size_t>(bh) * s_len + qi;
    lse2[h] = qi < s_len ? lse[at] * kLog2e : 0.f;
    dlt[h] = qi < s_len ? delta[at] : 0.f;
  }
  float dqa[G::kCols / 2];                   // columns past HD stay 0
#pragma unroll
  for (int i = 0; i < G::kCols / 2; ++i) dqa[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kStages;
    const uint32_t sk = base + (2 + 2 * st) * G::kBytes;
    const uint32_t sv = sk + G::kBytes;
    mbar_wait(smem_u32(&bars[st]), (kt / kStages) & 1);

    // S = Q K^T and dP = dO V^T, float32, unscaled.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    mma_ss_tiles<HD>(s, sq, sk);
    mma_ss_tiles<HD>(dp, sdo, sv);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS in place of dP; only the tiles that cross the diagonal are
    // masked (keys past T among them).
    const int k0 = kt * kBlockK;
    const bool diag = k0 + kBlockK - 1 > offset + qtile * kBlockQ;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int key = k0 + (i >> 2) * 8 + c0 + (i & 1);
      float ds = 0.f;
      if (!diag || key <= pos0 + 8 * h) {
        const float p = exp2f(fmaf(s[i], scale_log2, -lse2[h]));
        ds = p * (dp[i] - dlt[h]) * scale;
      }
      dp[i] = ds;
    }
    uint32_t dh[4][4], dl[4][4];
    split_frags(dp, dh, dl);

    // dQ += dS K.
    wgmma_fence();
    mma_rs_pair<HD>(dqa, dh, dl, sk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dqa);

    // Every warp is done with stage st: refill it with tile kt + kStages.
    __syncthreads();
    if (tid == 0 && kt + kStages < n_tiles) load_kv(kt + kStages, st);
  }

#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int qi = qi0 + ((i >> 1) & 1) * 8;
    if (qi < s_len)
      *reinterpret_cast<__nv_bfloat162*>(
          dq + (static_cast<size_t>(bh) * s_len + qi) * HD + (i >> 2) * 8 +
          c0) = __floats2bfloat162_rn(dqa[i], dqa[i + 1]);
  }
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, void* delta,
                         int rows, int hd, cudaStream_t stream) {
  flashattn_bwd_delta_kernel<T><<<(rows + kDeltaRows - 1) / kDeltaRows,
                                  kDeltaRows * 32, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows, hd);
  return cudaGetLastError();
}

// float32: delta, then the CUDA-core dK/dV and dQ kernels.
template <int HD>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* lse, const void* dout,
                   void* delta, void* dq, void* dk, void* dv, int bh,
                   int s_len, int t_len, int g, float scale,
                   cudaStream_t stream) {
  using T = float;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* tl = static_cast<const float*>(lse);
  float* td = static_cast<float*>(delta);
  cudaError_t err = launch_delta<T>(o, dout, delta, bh * s_len, HD, stream);
  if (err != cudaSuccess) return err;

  // Each limit is lifted once per instantiation (and so outside any graph
  // capture after the first call).
  auto* dkdv = flashattn_bwd_dkdv_kernel<HD, T>;
  constexpr int dkdv_smem = 2 * kBlockQ * HD * sizeof(float) +
                            2 * kBlockQ * sizeof(float);
  static const cudaError_t dkdv_set =
      dkdv_smem > 48 * 1024
          ? cudaFuncSetAttribute(dkdv,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dkdv_smem)
          : cudaSuccess;
  if (dkdv_set != cudaSuccess) return dkdv_set;
  dkdv<<<dim3(bh / g, (t_len + kBlockK - 1) / kBlockK), kThreads, dkdv_smem,
         stream>>>(tq, tk, tv, tdo, tl, td, static_cast<T*>(dk),
                   static_cast<T*>(dv), s_len, t_len, g, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto* dqk = flashattn_bwd_dq_kernel<HD, T>;
  constexpr int dq_smem = 2 * kBlockK * HD * sizeof(float);
  static const cudaError_t dq_set =
      dq_smem > 48 * 1024
          ? cudaFuncSetAttribute(dqk,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 dq_smem)
          : cudaSuccess;
  if (dq_set != cudaSuccess) return dq_set;
  dqk<<<dim3(bh, (s_len + kBlockQ - 1) / kBlockQ), kThreads, dq_smem,
        stream>>>(tq, tk, tv, tdo, tl, td, static_cast<T*>(dq), s_len, t_len,
                  g, scale);
  return cudaGetLastError();
}

// bf16: delta, then the tensor-core dK/dV and dQ kernels, the tensor maps
// encoded here as launch_bf16 encodes the forward's.
template <int HD>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* lse, const void* dout,
                    void* delta, void* dq, void* dk, void* dv, int bh,
                    int s_len, int t_len, int g, float scale,
                    cudaStream_t stream) {
  using G = Tile<HD>;
  const int rows = bh * s_len;
  cudaError_t err = launch_delta<__nv_bfloat16>(o, dout, delta, rows, HD,
                                                stream);
  if (err != cudaSuccess) return err;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode<HD>(fn, &tq, q, bh, s_len) ||
      !encode<HD>(fn, &tdo, dout, bh, s_len) ||
      !encode<HD>(fn, &tk, k, bh / g, t_len) ||
      !encode<HD>(fn, &tv, v, bh / g, t_len))
    return static_cast<int>(cudaErrorInvalidValue);

  // Each limit is lifted once per instantiation (and so outside any graph
  // capture after the first call).
  auto* dkdv = flashattn_bwd_dkdv_wgmma_kernel<HD>;
  constexpr int dkdv_smem = DkdvSmem<HD>::kBytes;
  static const cudaError_t dkdv_set = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
  if (dkdv_set != cudaSuccess) return dkdv_set;
  dkdv<<<dim3(bh / g, (t_len + kBlockK - 1) / kBlockK), kWgThreads,
         dkdv_smem, stream>>>(tq, tk, tv, tdo,
                              static_cast<const float*>(lse),
                              static_cast<const float*>(delta),
                              static_cast<__nv_bfloat16*>(dk),
                              static_cast<__nv_bfloat16*>(dv), s_len, t_len,
                              g, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto* dqk = flashattn_bwd_dq_wgmma_kernel<HD>;
  constexpr int dq_smem = (2 + 2 * kStages) * G::kBytes + 1024;
  static const cudaError_t dq_set = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (dq_set != cudaSuccess) return dq_set;
  dqk<<<dim3(bh, (s_len + kBlockQ - 1) / kBlockQ), kWgThreads, dq_smem,
        stream>>>(tq, tk, tv, tdo, static_cast<const float*>(lse),
                  static_cast<const float*>(delta),
                  static_cast<__nv_bfloat16*>(dq), s_len, t_len, g, scale);
  return cudaGetLastError();
}

int launch_bwd_hd(bool bf16, const void* q, const void* k, const void* v,
                  const void* o, const void* lse, const void* dout,
                  void* delta, void* dq, void* dk, void* dv, int bh,
                  int s_len, int t_len, int hd, int g, float scale,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_BWD(HD)                                                        \
  (bf16 ? launch_bwd_bf16<HD>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh, \
                              s_len, t_len, g, scale, st)                   \
        : launch_bwd_f32<HD>(q, k, v, o, lse, dout, delta, dq, dk, dv, bh,  \
                             s_len, t_len, g, scale, st))
  switch (hd) {
    case 16: return FLASH_BWD(16);
    case 32: return FLASH_BWD(32);
    case 64: return FLASH_BWD(64);
    case 112: return FLASH_BWD(112);
    case 128: return FLASH_BWD(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD
}

}  // namespace

// q (bh, s_len, hd), k and v (bh / g, t_len, hd), o like q; all
// contiguous and 16-byte aligned, of one type; lse null, or float32 (bh,
// s_len), which then receives each row's log-sum-exp m + log(max(l,
// 1e-30)) (the backward's residual).  flashattn_f32_launch runs the
// CUDA-core kernel on float32, flashattn_bf16_launch the tensor-core
// kernel on bfloat16.  Each returns the launch's cudaError_t.
extern "C" int flashattn_f32_launch(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int bh,
                                    int s_len, int t_len, int hd, int g,
                                    float scale, void* stream) {
  return launch_hd(false, q, k, v, o, lse, bh, s_len, t_len, hd, g, scale,
                   stream);
}

extern "C" int flashattn_bf16_launch(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int bh, int s_len, int t_len, int hd,
                                     int g, float scale, void* stream) {
  return launch_hd(true, q, k, v, o, lse, bh, s_len, t_len, hd, g, scale,
                   stream);
}

// The backward of the same attention: q, k, v, o as above, lse float32
// (bh, s_len) from the forward, dout like o; delta float32 (bh, s_len)
// scratch; dq like q, dk and dv like k; in bf16 q, k, v and dout 16-byte
// aligned (the TMA copies).  Launches the delta, dK/dV and dQ kernels in
// that order on `stream`; returns the first launch error.
extern "C" int flashattn_bwd_f32_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int bh, int s_len, int t_len, int hd, int g, float scale,
    void* stream) {
  return launch_bwd_hd(false, q, k, v, o, lse, dout, delta, dq, dk, dv, bh,
                       s_len, t_len, hd, g, scale, stream);
}

extern "C" int flashattn_bwd_bf16_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int bh, int s_len, int t_len, int hd, int g, float scale,
    void* stream) {
  return launch_bwd_hd(true, q, k, v, o, lse, dout, delta, dq, dk, dv, bh,
                       s_len, t_len, hd, g, scale, stream);
}
