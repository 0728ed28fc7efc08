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
// flashattn_tf32x3_kernel<hd>: float32 inputs, on the tensor cores.  One
// TF32 product keeps 10 of float32's 23 mantissa bits, 10-71x outside
// the float32 tolerance; three keep about 21: each operand x is split as
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna; x - hi is exact in
// float32), and a product is hi * hi + hi * lo + lo * hi, each term exact
// in float32 and summed in float32 by the tensor cores (lo * lo, ~2^-22
// of the product, is dropped).  On an H100 the worst case of
// chip_smoke.py's checks reaches 0.26 of FLASH_TOL[float32];
// tests/test_torch_flashattn.py emulates the kernel on the CPU, with its
// key tiles and a model of the tensor cores' accumulate, at 0.16 of it
// at worst over the tests' shapes.
// * The bf16 kernel's structure: one warpgroup per (bh, 64-row query
//   tile), longest rows first, Q once and K/V tiles of kBK keys through a
//   kStages = 2 TMA ring refilled by one elected thread, 3-D tensor maps
//   (float32 boxes of 32 columns, 128 B swizzle; 16 columns, 64 B, at hd
//   16; hd 112 on hd 128's tiles, TMA zero-filling columns 112-127).
// * The split pass: after each copy lands, the block's threads rewrite
//   it in shared memory: q (scaled by 1/sqrt(hd) in float32 first, as the
//   reference scales it before the product) and K become hi in place with
//   lo beside them (elementwise, so the swizzled layout carries over); V
//   becomes V^T hi and lo.  PTX has no transpose bit for tf32 operands,
//   so every shared-memory operand is K-major: P V needs V with the keys
//   contiguous.  The split pass writes each 8 keys of V^T in the order 0
//   2 4 6 1 3 5 7: a thread's S accumulator holds keys 2c and 2c + 1 of
//   each 8, tf32's A fragment takes columns c and c + 4, so under that
//   order the accumulator is the A fragment as it stands (no shuffle).
//   Then fence.proxy.async and a barrier before the products read it.
//   The split is done here, not by a wrapper pass over the whole tensors
//   (which would split each K/V tile once instead of once per block):
//   no scratch tensors (the backward would need eight more copies of q,
//   dO, K and V), and each tile still crosses device memory once per
//   block.  hi is rounded explicitly, so the products do not depend on
//   how wgmma treats the low 13 bits of a tf32 operand.
// * S = (q scale) K^T: three wgmma m64n{kBK}k8 per k-step, both operands
//   K-major in shared memory.  Online softmax in registers as the bf16
//   kernel's, in natural units (expf(s - m), as the plain version).
// * O = O corr + P V: P split in registers into hi and lo A fragments,
//   V^T hi and lo as B; N = hd in chunks of at most 64 (hd 112: 64 + 48).
//   Each tile's P V goes to an accumulator of its own, added to O in
//   float32 registers (mma3_rs says why).  The row sums l add the
//   unsplit float32 p.
// * Shared memory and tiles: Q, its lo, two stages of (K, V) as they land,
//   K's lo and V^T's hi and lo: kBK = 64 keys up to hd 64 (145 KB), 32 at
//   hd 112 and 128 (177 KB).  The split tiles are single-buffered.
// * Bound on an H100 SXM: 4 * hd flops per causal pair at a third of the
//   tensor cores' TF32 peak (495 / 3 TFLOP/s): 0.208 ms at granite-3-2b's
//   prefill (BH 256, S = T = 1024, hd 64).
// * Left on the table: the split passes run on every block that reads a
//   tile (each K/V tile is split by every query tile and head of its
//   group, where a wrapper pass could split it once), in turn with the
//   products (no producer warp, no overlap); one block per SM (shared
//   memory); the diagonal tiles are computed whole.
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
// float32: flashattn_bwd_{dkdv,dq}_tf32x3_kernel<hd>, the bf16 kernels'
// grids, walks, fixed summation order and masks, every product three
// TF32 products of split operands as in the float32 forward (0.61 of
// BWD_TOL[float32] at worst on an H100, 0.38 in the CPU emulation; one
// TF32 product misses it by 84-192x), P and dS split in registers.  Their B operands are
// K-major: S^T = K (q scale)^T and dP^T = V dO^T take Q and dO as they
// land (hi in place), dV += P^T dO and dK += dS^T q take dO^T and q^T
// (q unscaled), and dQ += dS K takes K^T, each written by the split pass
// with the rows of each 8 in the order 0 2 4 6 1 3 5 7.
// * dkdv: K and V split once; per (query head, query tile) item, Q and dO
//   land in the ring and are split in place and transposed: 8 tiles per
//   item.  Each item's dV and dK products go to an accumulator of their
//   own, added to the sums in float32 registers (dq per key tile, as the
//   forward: mma3_rs says why).  Query rows per item kBQ: 64 up to hd 64 (226 KB of shared
//   memory), 16 at hd 112 and 128 (209 KB).  dV's products wait before
//   dS is split, so one pair of A fragments is live at a time.
// * dq: Q and dO split once; per key tile, K (in place and transposed)
//   and V (in place).  Keys per tile kBK: 64 up to hd 64 (193 KB), 16 at
//   hd 112 and 128 (193 KB).
// * Bound on an H100 SXM: five products of 2 * hd flops per causal pair
//   at 495 / 3 TFLOP/s, 0.521 ms at granite-3-2b's training shape; the
//   kernels run seven (S and dP in both), 0.73 ms at that rate.
// * Left on the table: the bf16 kernels' list, plus the split passes
//   (every Q/dO tile split and transposed by each key tile's block that
//   reads it) in turn with the products, and one block per SM.
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

// Reads of either input type as float32 (the delta kernel).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// ---------------------------------------------------------------------
// float32: the three-TF32 tensor-core kernels' building blocks, then the
// forward (the backward's two kernels follow the bf16 ones below).
// ---------------------------------------------------------------------

// Shared-memory geometry of a float32 tile of R rows by C columns (C
// contiguous) as TMA lays it out: kBoxes boxes of kBox columns, each R
// rows of kRowBytes (one swizzle span: 32 floats, or the whole row when C
// is 16), boxes one after another.  kCols = kBoxes * kBox columns are
// held: C itself, except 128 at C = 112, whose last box runs 16 columns
// past the tensor's edge (zero-filled by TMA).
template <int R, int C>
struct FTile {
  static constexpr int kBox = C < 32 ? C : 32;
  static constexpr int kBoxes = (C + kBox - 1) / kBox;
  static constexpr int kCols = kBoxes * kBox;
  static constexpr int kRowBytes = kBox * 4;
  static constexpr int kBoxBytes = R * kRowBytes;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static_assert(kRowBytes == 64 || kRowBytes == 128, "64 or 128 B rows");
  static_assert(kBoxBytes % 1024 == 0, "whole swizzle atoms");
  // wgmma descriptor layout type and TMA swizzle of the span.
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B;

  // Byte offset of element (r, c) in a tile that starts 1024-byte
  // aligned: the swizzle XORs the 16-byte chunk index (address bits 4-6,
  // or 4-5 for 64 B rows) with bits 7-9 (7-8), as TMA and wgmma apply it.
  __device__ static __forceinline__ uint32_t at(int r, int c) {
    const uint32_t off =
        (c / kBox) * kBoxBytes + r * kRowBytes + (c % kBox) * 4;
    return off ^ (((off >> 7) & (kRowBytes / 16 - 1)) << 4);
  }

  // The tile as a K-major wgmma operand (its rows the M or N dimension,
  // from row r0, a multiple of 8): the 8 columns of k-step kk, 32 bytes
  // further along the row within a box; 8-row groups 8 rows apart (SBO).
  __device__ static __forceinline__ uint64_t desc(uint32_t tile, int kk,
                                                  int r0 = 0) {
    const int col = kk * 8;
    return smem_desc(tile + (col / kBox) * kBoxBytes + r0 * kRowBytes +
                         (col % kBox) * 4,
                     16, 8 * kRowBytes, kLayout);
  }
};

// The shared-memory proxy fence that makes the threads' stores visible to
// wgmma (and to the TMA copies that later overwrite the same bytes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts4(uint32_t a, const uint32_t (&x)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3])
               : "memory");
}
__device__ __forceinline__ void sts1(uint32_t a, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(x) : "memory");
}

// x as hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest (ties
// away): x - hi is exact in float32, so hi + lo keeps about 21 of x's 24
// bits, and hi * hi + hi * lo + lo * hi (each product exact in float32)
// misses x * y by about 2^-21 of it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// Row r's column in a transposed tile: within each group of 8, the even
// rows first, then the odd ones (0 2 4 6 1 3 5 7).  A thread's
// accumulator holds columns 2c and 2c + 1 of each 8, and tf32's A fragment
// takes columns c and c + 4 of a k-step: stored in this order, the B
// operand's column c is 2c and column c + 4 is 2c + 1, so the accumulator
// is the A fragment as it stands (frags below).  A summation index may be
// permuted when both operands follow it.
__device__ __forceinline__ int perm8(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
}

// The split pass over an R x HD float32 tile at `tile` as TMA landed it,
// by all kWgThreads threads (the caller then fences the proxy and
// synchronizes).  kNat: each x becomes hi = tf32(x * scale) in place and
// lo = tf32(x * scale - hi) at the same offset of `lo` (elementwise, so
// the swizzled layout carries over).  kTrans: hi and lo of x itself go to
// the transposed tiles FTile<kCols, R> at t_hi and t_lo, row r to column
// perm8(r).  Consecutive threads take consecutive rows of one 4-column
// chunk: the reads and the transposed stores are free of bank conflicts.
template <int R, int HD, bool kNat, bool kTrans>
__device__ __forceinline__ void split_pass(uint32_t tile, uint32_t lo,
                                           uint32_t t_hi, uint32_t t_lo,
                                           float scale, int tid) {
  using S = FTile<R, HD>;
  using T = FTile<S::kCols, R>;
#pragma unroll 4
  for (int i = tid; i < R * S::kCols / 4; i += kWgThreads) {
    const int r = i % R, c = (i / R) * 4;
    const uint32_t off = S::at(r, c);
    const float4 x4 = lds4(tile + off);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    if constexpr (kTrans) {
      const int pr = perm8(r);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t h, l;
        split_tf32(x[j], h, l);
        sts1(t_hi + T::at(c + j, pr), h);
        sts1(t_lo + T::at(c + j, pr), l);
      }
    }
    if constexpr (kNat) {
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(x[j] * scale, h[j], l[j]);
      sts4(tile + off, h);
      sts4(lo + off, l);
    }
  }
}

// The accumulator of a 64 x W product as the hi and lo A fragments of the
// W / 8 k-steps of a product over its columns: tf32's fragment holds (r,
// c), (r + 8, c), (r, c + 4), (r + 8, c + 4) of the k-step (c = lane % 4),
// which are accumulator elements 4j, 4j + 2, 4j + 1, 4j + 3 under perm8.
template <int W>
__device__ __forceinline__ void frags(const float (&x)[W / 2],
                                      uint32_t (&hi)[W / 8][4],
                                      uint32_t (&lo)[W / 8][4]) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    split_tf32(x[4 * j + 0], hi[j][0], lo[j][0]);
    split_tf32(x[4 * j + 2], hi[j][1], lo[j][1]);
    split_tf32(x[4 * j + 1], hi[j][2], lo[j][2]);
    split_tf32(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// Keeps the registers of A fragments from reuse before the wait that ends
// the wgmma reading them.
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[k][j])::"memory");
}

// wgmma m64nNk8 with tf32 operands and float32 accumulators: D = A B^T
// (+ D when scale_d), _ss with A and B K-major in shared memory, _rs with
// A from registers.  PTX has no transpose bit for tf32: every
// shared-memory operand is K-major.
__device__ __forceinline__ void tf32_ss_n16(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_ss_n32(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_ss_n64(float* d, uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_rs_n16(float* d, const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_rs_n32(float* d, const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_rs_n48(float* d, const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tf32_rs_n64(float* d, const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void tf32_ss(float* d, uint64_t da, uint64_t db,
                                        int scale_d) {
  if constexpr (N == 16) tf32_ss_n16(d, da, db, scale_d);
  else if constexpr (N == 32) tf32_ss_n32(d, da, db, scale_d);
  else tf32_ss_n64(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void tf32_rs(float* d, const uint32_t (&a)[4],
                                        uint64_t db, int scale_d) {
  if constexpr (N == 16) tf32_rs_n16(d, a, db, scale_d);
  else if constexpr (N == 32) tf32_rs_n32(d, a, db, scale_d);
  else if constexpr (N == 48) tf32_rs_n48(d, a, db, scale_d);
  else tf32_rs_n64(d, a, db, scale_d);
}

// D (64 x N) = (A_hi + A_lo)(B_hi + B_lo)^T over the first HD columns of
// two K-major tiles (A FTile<64, HD>, B FTile<N, HD>): three TF32
// products per k-step, lo hi, hi lo, then hi hi, a fixed order.
template <int HD, int N>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint32_t a_hi,
                                        uint32_t a_lo, uint32_t b_hi,
                                        uint32_t b_lo) {
  using A = FTile<kBlockQ, HD>;
  using B = FTile<N, HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    tf32_ss<N>(d, A::desc(a_lo, kk), B::desc(b_hi, kk), kk > 0);
    tf32_ss<N>(d, A::desc(a_hi, kk), B::desc(b_lo, kk), 1);
    tf32_ss<N>(d, A::desc(a_hi, kk), B::desc(b_hi, kk), 1);
  }
}

// D (64 x HD) = (X_hi + X_lo) B, X the W columns of a 64 x W accumulator
// as frags() laid them out, B its W rows as a transposed tile FTile<kCols,
// W> (K-major, the HD columns its rows) at b_hi and b_lo: per k-step, N =
// HD in chunks of at most 64 rows, three products each, as mma3_ss.
//
// The callers start D afresh for each tile (or query item) and add it to
// their running sum in float32 registers.  The tensor cores' adds into an
// accumulator keep fewer low bits than float32's round to nearest: kept
// in one accumulator across all items, dK and dV at S = T = 1,000, g 4
// drifted up to 4e-5 of their largest value from the plain version on an
// H100 (up to 4.2x BWD_TOL[float32]); with one accumulator per item,
// chip_smoke.py's checks read at most 0.61x of it.  So each accumulator
// sums one tile's 3 W / 8 products and the long sums round to nearest
// (tests/test_torch_flashattn.py::_tc_mm models the drift on the CPU).
template <int HD, int W>
__device__ __forceinline__ void mma3_rs(float (&d)[HD / 2],
                                        const uint32_t (&hi)[W / 8][4],
                                        const uint32_t (&lo)[W / 8][4],
                                        uint32_t b_hi, uint32_t b_lo) {
  using B = FTile<FTile<kBlockQ, HD>::kCols, W>;
  constexpr int kN0 = HD < 64 ? HD : 64;
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    tf32_rs<kN0>(d, lo[kk], B::desc(b_hi, kk), kk > 0);
    tf32_rs<kN0>(d, hi[kk], B::desc(b_lo, kk), 1);
    tf32_rs<kN0>(d, hi[kk], B::desc(b_hi, kk), 1);
    if constexpr (HD > 64) {
      tf32_rs<HD - 64>(d + 32, lo[kk], B::desc(b_hi, kk, 64), kk > 0);
      tf32_rs<HD - 64>(d + 32, hi[kk], B::desc(b_lo, kk, 64), 1);
      tf32_rs<HD - 64>(d + 32, hi[kk], B::desc(b_hi, kk, 64), 1);
    }
  }
}

// The most shared memory a block may hold (static barriers included).
constexpr int kSmemLimit = 232448 - 64;

// Shared memory of the float32 forward at head dim HD: Q (hi in place,
// scaled) and its lo; kStages (K, V) pairs as they land (K's hi in place);
// K's lo and V^T's hi and lo, rewritten for each key tile.  Keys per tile
// kBK: 64 up to hd 64 (145 KB), 32 at hd 112 and 128 (177 KB; 64 would
// take 289 KB).
template <int HD>
struct FwdF32 {
  static constexpr int kBK = HD <= 64 ? 64 : 32;
  using Q = FTile<kBlockQ, HD>;
  using K = FTile<kBK, HD>;
  using VT = FTile<Q::kCols, kBK>;
  static constexpr int kQlo = Q::kBytes;
  static constexpr int kStage0 = 2 * Q::kBytes;
  static constexpr int kKlo = kStage0 + kStages * 2 * K::kBytes;
  static constexpr int kVThi = kKlo + K::kBytes;
  static constexpr int kVTlo = kVThi + VT::kBytes;
  static constexpr int kSmem = kVTlo + VT::kBytes + 1024;
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

// The float32 forward: flashattn_wgmma_kernel's structure, each product
// three TF32 products (see the header).  Thread t holds query rows r0 and
// r0 + 8 of the 64-row tile, as there.
template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flashattn_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        float* __restrict__ o, float* __restrict__ lse,
                        int s_len, int t_len, int g, float scale) {
  using L = FwdF32<HD>;
  using K = typename L::K;
  constexpr int kBK = L::kBK;
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // K/V stages, Q
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sq_lo = base + L::kQlo;
  const uint32_t sk_lo = base + L::kKlo;
  const uint32_t svt_hi = base + L::kVThi, svt_lo = base + L::kVTlo;
  const uint32_t bar_q = smem_u32(&bars[kStages]);

  const int bh = blockIdx.x;
  // The longest causal rows first: they take the most key tiles.
  const int qtile = gridDim.y - 1 - blockIdx.y;
  const int kvh = bh / g;
  const int offset = t_len - s_len;          // >= 0, checked by the wrapper
  const int last_row = min(s_len, (qtile + 1) * kBlockQ) - 1;
  const int n_tiles = (offset + last_row) / kBK + 1;
  const int tid = threadIdx.x;

  // Stage st holds K, then V.
  auto stage = [&](int st) { return base + L::kStage0 + 2 * st * K::kBytes; };
  auto load_kv = [&](int kt, int st) {
    const uint32_t bar = smem_u32(&bars[st]);
    const uint32_t sk = stage(st);
    mbar_expect_tx(bar, 2 * K::kBytes);
#pragma unroll
    for (int b = 0; b < K::kBoxes; ++b) {
      tma_load(sk + b * K::kBoxBytes, &tk, bar, b * K::kBox, kt * kBK, kvh);
      tma_load(sk + K::kBytes + b * K::kBoxBytes, &tv, bar, b * K::kBox,
               kt * kBK, kvh);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::Q::kBytes);
#pragma unroll
    for (int b = 0; b < L::Q::kBoxes; ++b)
      tma_load(sq + b * L::Q::kBoxBytes, &tq, bar_q, b * L::Q::kBox,
               qtile * kBlockQ, bh);
    for (int kt = 0; kt < kStages && kt < n_tiles; ++kt) load_kv(kt, kt);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);    // this thread's rows: r0, r0 + 8
  const int c0 = (lane & 3) * 2;             // its first column in each 8
  const int pos0 = offset + qtile * kBlockQ + r0;  // key position of row r0
  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // q scaled by 1/sqrt(hd) in float32 before the split, as the reference
  // scales it before the product.
  mbar_wait(bar_q, 0);
  split_pass<kBlockQ, HD, true, false>(sq, sq_lo, 0, 0, scale, tid);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kStages;
    const uint32_t sk = stage(st), sv = sk + K::kBytes;
    mbar_wait(smem_u32(&bars[st]), (kt / kStages) & 1);
    split_pass<kBK, HD, true, false>(sk, sk_lo, 0, 0, 1.f, tid);
    split_pass<kBK, HD, false, true>(sv, 0, svt_hi, svt_lo, 1.f, tid);
    fence_proxy_async();
    __syncthreads();

    // S = (q scale) K^T, float32.
    float s[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
    mma3_ss<HD, kBK>(s, sq, sq_lo, sk, sk_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Mask the diagonal tiles, row maxima, the online softmax's update.
    const int k0 = kt * kBK;
    const bool diag = k0 + kBK - 1 > offset + qtile * kBlockQ;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const bool hi = (i >> 1) & 1;
      const int key = k0 + (i >> 2) * 8 + c0 + (i & 1);
      if (diag && key > pos0 + (hi ? 8 : 0)) s[i] = kNegInf;
      if (hi) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const bool hi = (i >> 1) & 1;
      s[i] = expf(s[i] - (hi ? mn1 : mn0));
      if (hi) ps1 += s[i];
      else ps0 += s[i];
    }
    l0 = l0 * corr0 + ps0;
    l1 = l1 * corr1 + ps1;

    // O = O corr + P V, P split in registers, the tile's P V in an
    // accumulator of its own (mma3_rs).
    uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
    frags<kBK>(s, ph, pl);
    float pv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) pv[i] = 0.f;
    wgmma_fence();
    mma3_rs<HD, kBK>(pv, ph, pl, svt_hi, svt_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    fence_frags(ph);
    fence_frags(pl);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i)
      oacc[i] = oacc[i] * (((i >> 1) & 1) ? corr1 : corr0) + pv[i];

    // Every warp is done with stage st and the split tiles: refill it
    // with tile kt + kStages.
    __syncthreads();
    if (tid == 0 && kt + kStages < n_tiles) load_kv(kt + kStages, st);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const int qi0 = qtile * kBlockQ + r0;
  if (lse != nullptr && (lane & 3) == 0) {
    float* row_lse = lse + static_cast<size_t>(bh) * s_len;
    if (qi0 < s_len) row_lse[qi0] = m0 + logf(den0);
    if (qi0 + 8 < s_len) row_lse[qi0 + 8] = m1 + logf(den1);
  }
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const bool hi = (i >> 1) & 1;
    const int qi = qi0 + (hi ? 8 : 0);
    if (qi < s_len) {
      const float den = hi ? den1 : den0;
      *reinterpret_cast<float2*>(
          o + (static_cast<size_t>(bh) * s_len + qi) * HD + (i >> 2) * 8 +
          c0) = make_float2(oacc[i] / den, oacc[i + 1] / den);
    }
  }
}

// A 3-D map over (heads, rows, HD) float32, contiguous, in boxes of (1,
// R, kBox) as FTile<R, HD> lays them out; out-of-range rows (and at HD =
// 112 the columns 112-127 of the last box) read as zeros.
template <int R, int HD>
bool encode_f32(EncodeTiled fn, CUtensorMap* map, const void* base,
                int heads, int rows) {
  using F = FTile<R, HD>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 4,
                                 static_cast<cuuint64_t>(rows) * HD * 4};
  const cuuint32_t box[3] = {F::kBox, R, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, F::kSwizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o,
                  float* lse, int bh, int s_len, int t_len, int g,
                  float scale, cudaStream_t stream) {
  using L = FwdF32<HD>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode_f32<kBlockQ, HD>(fn, &tq, q, bh, s_len) ||
      !encode_f32<L::kBK, HD>(fn, &tk, k, bh / g, t_len) ||
      !encode_f32<L::kBK, HD>(fn, &tv, v, bh / g, t_len))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kern = flashattn_tf32x3_kernel<HD>;
  // Once per instantiation (and so outside any graph capture after the
  // first call).
  static const cudaError_t set = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (set != cudaSuccess) return set;
  const dim3 grid(bh, (s_len + kBlockQ - 1) / kBlockQ);
  kern<<<grid, kWgThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<float*>(o), lse, s_len, t_len, g, scale);
  return cudaGetLastError();
}

template <int HD>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           float* lse, int bh, int s_len, int t_len, int g, float scale,
           cudaStream_t stream) {
  return bf16 ? launch_bf16<HD>(q, k, v, o, lse, bh, s_len, t_len, g, scale,
                                stream)
              : launch_tf32x3<HD>(q, k, v, o, lse, bh, s_len, t_len, g,
                                  scale, stream);
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
// Backward: the delta kernel, both routes.
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

// ---------------------------------------------------------------------
// Backward, float32: the two three-TF32 tensor-core kernels.
// ---------------------------------------------------------------------

// Shared memory of the float32 dK/dV kernel at head dim HD: K and V (hi in
// place) and their lo; kStages (Q, dO) pairs as they land, each with its
// tile's kBQ lse and kBQ delta floats; Q's (scaled) and dO's lo, and
// Q^T's and dO^T's hi and lo, rewritten for each query tile.  Query rows
// per tile kBQ: 64 up to hd 64 (226 KB), 16 at hd 112 and 128 (209 KB;
// 32 would take 289 KB).
template <int HD>
struct DkdvF32 {
  static constexpr int kBQ = HD <= 64 ? 64 : 16;
  static constexpr int kRowFloats = 2 * kBQ;  // lse, then delta
  static_assert(kRowFloats <= kWgThreads, "one row float per thread");
  using K = FTile<kBlockK, HD>;
  using Q = FTile<kBQ, HD>;
  using QT = FTile<K::kCols, kBQ>;
  static constexpr int kKlo = K::kBytes, kV = 2 * K::kBytes,
                       kVlo = 3 * K::kBytes, kStage0 = 4 * K::kBytes;
  static constexpr int kQlo = kStage0 + kStages * 2 * Q::kBytes;
  static constexpr int kDolo = kQlo + Q::kBytes;
  static constexpr int kQThi = kDolo + Q::kBytes;
  static constexpr int kQTlo = kQThi + QT::kBytes;
  static constexpr int kDoThi = kQTlo + QT::kBytes;
  static constexpr int kDoTlo = kDoThi + QT::kBytes;
  static constexpr int kRows = kDoTlo + QT::kBytes;
  static constexpr int kSmem = kRows + kStages * kRowFloats * 4 + 1024;
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

// dK and dV of one KV head's tile of kBlockK keys: the bf16 kernel's walk
// (the group's query heads, each's query tiles that see the keys, in
// order), each product three TF32 products.  Thread t holds key rows r0
// and r0 + 8 of S^T, dP^T, dK and dV.
template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flashattn_bwd_dkdv_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 float* __restrict__ dk,
                                 float* __restrict__ dv, int s_len,
                                 int t_len, int g, float scale) {
  using L = DkdvF32<HD>;
  using K = typename L::K;
  using Q = typename L::Q;
  constexpr int kBQ = L::kBQ;
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // Q/dO stages, K/V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base, sk_lo = base + L::kKlo;
  const uint32_t sv = base + L::kV, sv_lo = base + L::kVlo;
  const uint32_t sq_lo = base + L::kQlo, sdo_lo = base + L::kDolo;
  const uint32_t sqt_hi = base + L::kQThi, sqt_lo = base + L::kQTlo;
  const uint32_t sdot_hi = base + L::kDoThi, sdot_lo = base + L::kDoTlo;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  const uint32_t bar_kv = smem_u32(&bars[kStages]);

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;       // tile 0 sees the most queries
  const int offset = t_len - s_len;          // >= 0, checked by the wrapper
  // Query rows at positions below the tile's first key see none of it.
  const int first_qt = max(0, k0 - offset) / kBQ;
  const int per_head = (s_len + kBQ - 1) / kBQ - first_qt;
  const int n_items = g * per_head;          // (query head, query tile)s
  const int tid = threadIdx.x;

  // Item it is query head kvh g + it / per_head, query tile first_qt + it
  // % per_head: Q and dO by TMA into stage st, lse and delta rows (rows
  // past S read as 0) by the first kRowFloats threads, one float each.
  auto stage = [&](int st) { return base + L::kStage0 + 2 * st * Q::kBytes; };
  auto load_q = [&](int it, int st) {
    const int bh = kvh * g + it / per_head;
    const int i0 = (first_qt + it % per_head) * kBQ;
    const uint32_t bar = smem_u32(&bars[st]);
    const uint32_t sq = stage(st);
    mbar_expect_tx(bar, 2 * Q::kBytes);
#pragma unroll
    for (int b = 0; b < Q::kBoxes; ++b) {
      tma_load(sq + b * Q::kBoxBytes, &tq, bar, b * Q::kBox, i0, bh);
      tma_load(sq + Q::kBytes + b * Q::kBoxBytes, &tdo, bar, b * Q::kBox,
               i0, bh);
    }
  };
  auto row_value = [&](int it) {
    const int bh = kvh * g + it / per_head;
    const int qi = (first_qt + it % per_head) * kBQ + tid % kBQ;
    const float* src = tid < kBQ ? lse : delta;
    return qi < s_len ? src[static_cast<size_t>(bh) * s_len + qi] : 0.f;
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < L::kRowFloats)
    for (int it = 0; it < kStages && it < n_items; ++it)
      rows[it * L::kRowFloats + tid] = row_value(it);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * K::kBytes);
#pragma unroll
    for (int b = 0; b < K::kBoxes; ++b) {
      tma_load(sk + b * K::kBoxBytes, &tk, bar_kv, b * K::kBox, k0, kvh);
      tma_load(sv + b * K::kBoxBytes, &tv, bar_kv, b * K::kBox, k0, kvh);
    }
    for (int it = 0; it < kStages && it < n_items; ++it) load_q(it, it);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);    // this thread's keys: r0, r0 + 8
  const int c0 = (lane & 3) * 2;             // its first column in each 8
  const int key0 = k0 + r0;                  // key position of row r0
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

  mbar_wait(bar_kv, 0);
  split_pass<kBlockK, HD, true, false>(sk, sk_lo, 0, 0, 1.f, tid);
  split_pass<kBlockK, HD, true, false>(sv, sv_lo, 0, 0, 1.f, tid);
  for (int it = 0; it < n_items; ++it) {
    const int st = it % kStages;
    const int i0 = (first_qt + it % per_head) * kBQ;
    const uint32_t sq = stage(st), sdo = sq + Q::kBytes;
    const float* lse_s = rows + st * L::kRowFloats;
    const float* delta_s = lse_s + kBQ;
    // Item it + kStages's row float, read now, stored after this item.
    const float next_row = tid < L::kRowFloats && it + kStages < n_items
                               ? row_value(it + kStages)
                               : 0.f;
    mbar_wait(smem_u32(&bars[st]), (it / kStages) & 1);
    // Q scaled for the scores, unscaled (transposed) for dK.
    split_pass<kBQ, HD, true, true>(sq, sq_lo, sqt_hi, sqt_lo, scale, tid);
    split_pass<kBQ, HD, true, true>(sdo, sdo_lo, sdot_hi, sdot_lo, 1.f, tid);
    fence_proxy_async();
    __syncthreads();

    // S^T = K (q scale)^T and dP^T = V dO^T, float32.
    float s[kBQ / 2], dp[kBQ / 2];
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    mma3_ss<HD, kBQ>(s, sk, sk_lo, sq, sq_lo);
    mma3_ss<HD, kBQ>(dp, sv, sv_lo, sdo, sdo_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in place.  Element i is key row r0 + 8 ((i / 2) % 2)
    // and query column 8 (i / 4) + c0 + i % 2 of the tile.  Masked: keys
    // after the query's position (keys past T among them) and query rows
    // past S (TMA zero-fills them, but exp(0 - 0) is not 0).
    const bool edge = k0 + kBlockK - 1 > offset + i0 || i0 + kBQ > s_len;
#pragma unroll
    for (int i = 0; i < kBQ / 2; ++i) {
      const int col = (i >> 2) * 8 + c0 + (i & 1);
      const int key = key0 + ((i >> 1) & 1) * 8;
      float p = 0.f, ds = 0.f;
      if (!edge || (i0 + col < s_len && key <= offset + i0 + col)) {
        p = expf(s[i] - lse_s[col]);
        ds = p * (dp[i] - delta_s[col]) * scale;
      }
      s[i] = p;
      dp[i] = ds;
    }

    // dV += P^T dO, then dK += dS^T q: each A split in registers, each
    // item's product in an accumulator of its own (mma3_rs) added to the
    // sum; the wait between keeps one pair of fragments live at a time.
    float part[HD / 2];
    {
      uint32_t hi[kBQ / 8][4], lo[kBQ / 8][4];
      frags<kBQ>(s, hi, lo);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) part[i] = 0.f;
      wgmma_fence();
      mma3_rs<HD, kBQ>(part, hi, lo, sdot_hi, sdot_lo);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      fence_frags(hi);
      fence_frags(lo);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dva[i] += part[i];
    }
    {
      uint32_t hi[kBQ / 8][4], lo[kBQ / 8][4];
      frags<kBQ>(dp, hi, lo);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) part[i] = 0.f;
      wgmma_fence();
      mma3_rs<HD, kBQ>(part, hi, lo, sqt_hi, sqt_lo);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      fence_frags(hi);
      fence_frags(lo);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dka[i] += part[i];
    }

    // Every warp is done with stage st and the split tiles: refill it
    // with item it + kStages (the rows are read again only after the
    // next item's barrier).
    __syncthreads();
    if (it + kStages < n_items) {
      if (tid < L::kRowFloats) rows[st * L::kRowFloats + tid] = next_row;
      if (tid == 0) load_q(it + kStages, st);
    }
  }

  // Element i lies in column 8 (i / 4) + c0 + i % 2; keys past T are not
  // stored.
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int kj = key0 + ((i >> 1) & 1) * 8;
    if (kj < t_len) {
      const size_t at = (static_cast<size_t>(kvh) * t_len + kj) * HD +
                        (i >> 2) * 8 + c0;
      *reinterpret_cast<float2*>(dk + at) = make_float2(dka[i], dka[i + 1]);
      *reinterpret_cast<float2*>(dv + at) = make_float2(dva[i], dva[i + 1]);
    }
  }
}

// Shared memory of the float32 dQ kernel at head dim HD: Q (hi in place,
// scaled) and dO, each with its lo; kStages (K, V) pairs as they land;
// K's and V's lo and K^T's hi and lo, rewritten for each key tile.  Keys
// per tile kBK: 64 up to hd 64 (193 KB), 16 at hd 112 and 128 (193 KB;
// 32 would take 257 KB).
template <int HD>
struct DqF32 {
  static constexpr int kBK = HD <= 64 ? 64 : 16;
  using Q = FTile<kBlockQ, HD>;
  using K = FTile<kBK, HD>;
  using KT = FTile<Q::kCols, kBK>;
  static constexpr int kQlo = Q::kBytes, kDo = 2 * Q::kBytes,
                       kDolo = 3 * Q::kBytes, kStage0 = 4 * Q::kBytes;
  static constexpr int kKlo = kStage0 + kStages * 2 * K::kBytes;
  static constexpr int kVlo = kKlo + K::kBytes;
  static constexpr int kKThi = kVlo + K::kBytes;
  static constexpr int kKTlo = kKThi + KT::kBytes;
  static constexpr int kSmem = kKTlo + KT::kBytes + 1024;
  static_assert(kSmem <= kSmemLimit, "shared memory");
};

// dQ of one query head's tile of kBlockQ rows: the bf16 kernel's layout
// (thread t holds query rows r0 and r0 + 8), over the key tiles the
// causal mask leaves visible, in order; each product three TF32 products.
template <int HD>
__global__ void __launch_bounds__(kWgThreads)
flashattn_bwd_dq_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dq, int s_len, int t_len,
                               int g, float scale) {
  using L = DqF32<HD>;
  using Q = typename L::Q;
  using K = typename L::K;
  constexpr int kBK = L::kBK;
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // K/V stages, Q/dO
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sq_lo = base + L::kQlo;
  const uint32_t sdo = base + L::kDo, sdo_lo = base + L::kDolo;
  const uint32_t sk_lo = base + L::kKlo, sv_lo = base + L::kVlo;
  const uint32_t skt_hi = base + L::kKThi, skt_lo = base + L::kKTlo;
  const uint32_t bar_q = smem_u32(&bars[kStages]);

  const int bh = blockIdx.x;
  // The longest causal rows first: they take the most key tiles.
  const int qtile = gridDim.y - 1 - blockIdx.y;
  const int kvh = bh / g;
  const int offset = t_len - s_len;          // >= 0, checked by the wrapper
  const int last_row = min(s_len, (qtile + 1) * kBlockQ) - 1;
  const int n_tiles = (offset + last_row) / kBK + 1;
  const int tid = threadIdx.x;

  // Stage st holds K, then V.
  auto stage = [&](int st) { return base + L::kStage0 + 2 * st * K::kBytes; };
  auto load_kv = [&](int kt, int st) {
    const uint32_t bar = smem_u32(&bars[st]);
    const uint32_t sk = stage(st);
    mbar_expect_tx(bar, 2 * K::kBytes);
#pragma unroll
    for (int b = 0; b < K::kBoxes; ++b) {
      tma_load(sk + b * K::kBoxBytes, &tk, bar, b * K::kBox, kt * kBK, kvh);
      tma_load(sk + K::kBytes + b * K::kBoxBytes, &tv, bar, b * K::kBox,
               kt * kBK, kvh);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * Q::kBytes);
#pragma unroll
    for (int b = 0; b < Q::kBoxes; ++b) {
      tma_load(sq + b * Q::kBoxBytes, &tq, bar_q, b * Q::kBox,
               qtile * kBlockQ, bh);
      tma_load(sdo + b * Q::kBoxBytes, &tdo, bar_q, b * Q::kBox,
               qtile * kBlockQ, bh);
    }
    for (int kt = 0; kt < kStages && kt < n_tiles; ++kt) load_kv(kt, kt);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);    // this thread's rows: r0, r0 + 8
  const int c0 = (lane & 3) * 2;             // its first column in each 8
  const int pos0 = offset + qtile * kBlockQ + r0;  // key position of row r0
  const int qi0 = qtile * kBlockQ + r0;
  // Each row's lse and delta; rows past S (zero Q and dO, not stored)
  // take 0.
  float lse_r[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qi0 + 8 * h;
    const size_t at = static_cast<size_t>(bh) * s_len + qi;
    lse_r[h] = qi < s_len ? lse[at] : 0.f;
    dlt[h] = qi < s_len ? delta[at] : 0.f;
  }
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;

  mbar_wait(bar_q, 0);
  split_pass<kBlockQ, HD, true, false>(sq, sq_lo, 0, 0, scale, tid);
  split_pass<kBlockQ, HD, true, false>(sdo, sdo_lo, 0, 0, 1.f, tid);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt % kStages;
    const uint32_t sk = stage(st), sv = sk + K::kBytes;
    mbar_wait(smem_u32(&bars[st]), (kt / kStages) & 1);
    split_pass<kBK, HD, true, true>(sk, sk_lo, skt_hi, skt_lo, 1.f, tid);
    split_pass<kBK, HD, true, false>(sv, sv_lo, 0, 0, 1.f, tid);
    fence_proxy_async();
    __syncthreads();

    // S = (q scale) K^T and dP = dO V^T, float32.
    float s[kBK / 2], dp[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    mma3_ss<HD, kBK>(s, sq, sq_lo, sk, sk_lo);
    mma3_ss<HD, kBK>(dp, sdo, sdo_lo, sv, sv_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS in place of dP; only the tiles that cross the diagonal are
    // masked (keys past T among them).
    const int k0 = kt * kBK;
    const bool diag = k0 + kBK - 1 > offset + qtile * kBlockQ;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int h = (i >> 1) & 1;
      const int key = k0 + (i >> 2) * 8 + c0 + (i & 1);
      float ds = 0.f;
      if (!diag || key <= pos0 + 8 * h) {
        const float p = expf(s[i] - lse_r[h]);
        ds = p * (dp[i] - dlt[h]) * scale;
      }
      dp[i] = ds;
    }

    // dQ += dS K, dS split in registers, the tile's product in an
    // accumulator of its own (mma3_rs) added to the sum.
    uint32_t hi[kBK / 8][4], lo[kBK / 8][4];
    frags<kBK>(dp, hi, lo);
    float part[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) part[i] = 0.f;
    wgmma_fence();
    mma3_rs<HD, kBK>(part, hi, lo, skt_hi, skt_lo);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    fence_frags(hi);
    fence_frags(lo);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dqa[i] += part[i];

    // Every warp is done with stage st and the split tiles: refill it
    // with tile kt + kStages.
    __syncthreads();
    if (tid == 0 && kt + kStages < n_tiles) load_kv(kt + kStages, st);
  }

#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int qi = qi0 + ((i >> 1) & 1) * 8;
    if (qi < s_len)
      *reinterpret_cast<float2*>(
          dq + (static_cast<size_t>(bh) * s_len + qi) * HD + (i >> 2) * 8 +
          c0) = make_float2(dqa[i], dqa[i + 1]);
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

// float32: delta, then the three-TF32 dK/dV and dQ kernels, their tensor
// maps encoded here (each kernel's own box heights).
template <int HD>
int launch_bwd_tf32x3(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* dout,
                      void* delta, void* dq, void* dk, void* dv, int bh,
                      int s_len, int t_len, int g, float scale,
                      cudaStream_t stream) {
  using KV = DkdvF32<HD>;
  using QD = DqF32<HD>;
  cudaError_t err = launch_delta<float>(o, dout, delta, bh * s_len, HD,
                                        stream);
  if (err != cudaSuccess) return err;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap kv_q, kv_do, kv_k, kv_v, dq_q, dq_do, dq_k, dq_v;
  if (!encode_f32<KV::kBQ, HD>(fn, &kv_q, q, bh, s_len) ||
      !encode_f32<KV::kBQ, HD>(fn, &kv_do, dout, bh, s_len) ||
      !encode_f32<kBlockK, HD>(fn, &kv_k, k, bh / g, t_len) ||
      !encode_f32<kBlockK, HD>(fn, &kv_v, v, bh / g, t_len) ||
      !encode_f32<kBlockQ, HD>(fn, &dq_q, q, bh, s_len) ||
      !encode_f32<kBlockQ, HD>(fn, &dq_do, dout, bh, s_len) ||
      !encode_f32<QD::kBK, HD>(fn, &dq_k, k, bh / g, t_len) ||
      !encode_f32<QD::kBK, HD>(fn, &dq_v, v, bh / g, t_len))
    return static_cast<int>(cudaErrorInvalidValue);

  // Each limit is lifted once per instantiation (and so outside any graph
  // capture after the first call).
  auto* dkdv = flashattn_bwd_dkdv_tf32x3_kernel<HD>;
  static const cudaError_t dkdv_set = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, KV::kSmem);
  if (dkdv_set != cudaSuccess) return dkdv_set;
  dkdv<<<dim3(bh / g, (t_len + kBlockK - 1) / kBlockK), kWgThreads,
         KV::kSmem, stream>>>(kv_q, kv_k, kv_v, kv_do,
                              static_cast<const float*>(lse),
                              static_cast<const float*>(delta),
                              static_cast<float*>(dk),
                              static_cast<float*>(dv), s_len, t_len, g,
                              scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto* dqk = flashattn_bwd_dq_tf32x3_kernel<HD>;
  static const cudaError_t dq_set = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, QD::kSmem);
  if (dq_set != cudaSuccess) return dq_set;
  dqk<<<dim3(bh, (s_len + kBlockQ - 1) / kBlockQ), kWgThreads, QD::kSmem,
        stream>>>(dq_q, dq_k, dq_v, dq_do, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<float*>(dq),
                  s_len, t_len, g, scale);
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
        : launch_bwd_tf32x3<HD>(q, k, v, o, lse, dout, delta, dq, dk, dv,   \
                                bh, s_len, t_len, g, scale, st))
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
// three-TF32 kernel on float32, flashattn_bf16_launch the bf16 kernel on
// bfloat16, both on the tensor cores.  Each returns the launch's
// cudaError_t.
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
// scratch; dq like q, dk and dv like k; q, k, v and dout 16-byte aligned
// (the TMA copies).  Launches the delta, dK/dV and dQ kernels in
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
