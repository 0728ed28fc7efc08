// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel `flashattn_pallas`
// (src/repro/kernels/flashattn.py, body `_flash_kernel`): the prefill
// attention of the LLM serving path.  Same contract: q (BH, S, hd) with
// BH = BKV * g, k and v (BKV, T, hd), query head bh reads KV head bh / g;
// query row i sits at key position (T - S) + i and sees keys at or before
// it; q is scaled by 1/sqrt(hd) in float32 before the dot; masked scores
// take the finite sentinel -1e30; the online softmax (m, l, acc) runs in
// float32 and the output is written in q's type (round to nearest even).
//
// Design (a first, simple one; speed is later work):
// * One block per (bh, 64-row query tile), 256 threads: four threads per
//   query row, each holding a quarter of the row's q and of its
//   accumulator in registers, in float4 chunks interleaved so that the
//   four threads of a row read 64 contiguous bytes of a shared-memory row.
//   A row's score is the four partial dots summed with two shuffles.
// * K and V stream through shared memory in tiles of 64 keys, converted
//   to float32 when staged (2 * 64 * hd * 4 bytes: 64 KB at hd = 128, so
//   the launch raises the dynamic shared-memory limit past 48 KB).
// * Tiles wholly above the causal diagonal of the block are never
//   loaded.  The TPU kernel needed S and T to be multiples of its blocks;
//   here the last query tile and the last key tile are ragged: rows past
//   S are computed on zeros and not written, keys past T are staged as
//   zeros and are always masked (every row's position is below T).
// * Products accumulate with explicit fmaf, as the float32 matrix
//   products of the plain version do on the card, so the build's
//   -fmad=false (kept for the distance kernels) does not split them.
//
// Bound on an H100: the causal product needs 4 * hd flops per (query,
// key) pair that the mask keeps; against the bf16 tensor-core peak that
// is the operations bound at the serving shape.  This kernel does its
// math on the float32 CUDA cores (the reference's f32 arithmetic), whose
// peak is 67 TFLOP/s, so it cannot come near that bound; moving the two
// products onto wgmma tiles is the redesign's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;                  // query rows per block
constexpr int kBlockK = 64;                  // keys per shared-memory tile
constexpr int kLanes = 4;                    // threads per query row
constexpr int kThreads = kBlockQ * kLanes;   // 256
constexpr float kNegInf = -1e30f;            // the reference's sentinel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p, float scale) {
  return make_float4(to_f32(p[0]) * scale, to_f32(p[1]) * scale,
                     to_f32(p[2]) * scale, to_f32(p[3]) * scale);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flashattn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s_len,
                 int t_len, int g, float scale) {
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
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int s_len, int t_len, int g, float scale, cudaStream_t stream) {
  const int smem = 2 * kBlockK * HD * static_cast<int>(sizeof(float));
  auto* kern = flashattn_kernel<HD, T>;
  if (smem > 48 * 1024) {
    // Once per instantiation (and so outside any graph capture after the
    // first call): lift the dynamic shared-memory limit.
    static const cudaError_t set = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return set;
  }
  const dim3 grid(bh, (s_len + kBlockQ - 1) / kBlockQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, t_len, g, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int bh,
              int s_len, int t_len, int hd, int g, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16, T>(q, k, v, o, bh, s_len, t_len, g, scale, stream);
    case 32: return launch<32, T>(q, k, v, o, bh, s_len, t_len, g, scale, stream);
    case 64: return launch<64, T>(q, k, v, o, bh, s_len, t_len, g, scale, stream);
    case 128: return launch<128, T>(q, k, v, o, bh, s_len, t_len, g, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, s_len, hd), k and v (bh / g, t_len, hd), o like q; all
// contiguous, of one type: float32 (bf16 = 0) or bfloat16 (bf16 = 1).
// Returns the launch's cudaError_t.
extern "C" int flashattn_launch(const void* q, const void* k, const void* v,
                                void* o, int bh, int s_len, int t_len, int hd,
                                int g, int bf16, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, o, bh, s_len, t_len, hd, g,
                                    scale, st);
  return launch_hd<float>(q, k, v, o, bh, s_len, t_len, hd, g, scale, st);
}
