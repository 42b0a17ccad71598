// Blockwise (flash) attention forward for Hopper (sm_90a).
//
// K4 repro_torch_flash_attention replaces the Pallas kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (_flash_kernel, with ops.flash_mha's GQA expansion):
//   softmax(Q K^T / sqrt(hd)) V with the online (m, l, acc) recurrence in
//   float32, key tiles wholly above the causal diagonal skipped, one
//   division by max(l, 1e-20) and one cast to q's type at the end.
//
// Layout: the model's (B, S, H, hd) for q and out, (B, S, K, hd) for k/v;
// query head h reads kv head h / (H / K), so the reference's jnp.repeat
// of the kv heads is never materialized.  Any S: rows and keys past S
// are masked (the reference asserts S % block == 0).  hd is a multiple
// of 8 up to 128; the tiles are zero-padded to HDP (16, 32, 64 or 128).
//
// Bound on an H100: at the model's shapes (B=4, S=1024, H=32, K=8,
// hd=128, causal) the function moves ~84 MB (25 us at 3.35 TB/s) and
// does 34.4 GFLOP of products over the causal half (query i sees keys
// 0..i; 34.8 us at the 989 TFLOP/s bf16 tensor-core peak), so it is
// bound by operations.
//
// Design (first, simple form): one block of 256 threads per (b*h,
// 64-row query tile).  Q is staged once in shared memory as float32;
// each 64-key tile of K and then of V is staged in one shared buffer
// (K for the scores, V for the product), rows padded by one float so a
// warp reading a column hits 32 banks.  Scores and products are float32
// FMAs on the CUDA cores, as the TPU kernel computes in float32; each
// thread owns a 4x4 score patch and a 4 x (HDP/16) slice of the
// accumulator in registers, and four threads share a row's softmax.
// wgmma and TMA come later.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {
namespace flash {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsF = 256;
constexpr float kNegInf = -1e30f;
static_assert(kThreadsF == 4 * kBlockQ, "four threads per row in the softmax");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// rows [row0, row0 + 64) of a (B, S, heads, hd) tensor at head `head`
// -> smem[64][HDP + 1] float32, zero past S and past hd
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(float* smem, const T* __restrict__ src,
                                          int b, int row0, int head, int S,
                                          int heads, int hd) {
  constexpr int kStride = HDP + 1;
  for (int e = threadIdx.x; e < kBlockK * HDP; e += kThreadsF) {
    const int r = e / HDP;
    const int d = e - r * HDP;
    const int s = row0 + r;
    float v = 0.f;
    if (s < S && d < hd) {
      v = load_f32(src + ((static_cast<int64_t>(b) * S + s) * heads + head) * hd + d);
    }
    smem[r * kStride + d] = v;
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreadsF)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 int K, int hd, int causal, float scale) {
  constexpr int kStride = HDP + 1;
  constexpr int kCols = HDP / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                          // [64][HDP + 1]
  float* kv_s = q_s + kBlockQ * kStride;      // [64][HDP + 1]
  float* p_s = kv_s + kBlockK * kStride;      // [64][65]
  float* m_s = p_s + kBlockQ * (kBlockK + 1); // [64]
  float* l_s = m_s + kBlockQ;                 // [64]
  float* a_s = l_s + kBlockQ;                 // [64]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / K);
  const int q0 = blockIdx.x * kBlockQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, HDP>(q_s, q, b, q0, h, S, H, hd);
  if (threadIdx.x < kBlockQ) {
    m_s[threadIdx.x] = kNegInf;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const int n_tiles_all = (S + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(n_tiles_all, (q0 + kBlockQ - 1) / kBlockK + 1)
                             : n_tiles_all;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    load_tile<T, HDP>(kv_s, k, b, k0, kvh, S, K, hd);
    __syncthreads();
    // scores of this thread's 4x4 patch: rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * kStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool valid = kpos < S && (!causal || kpos <= q0 + r);
        p_s[r * (kBlockK + 1) + c] = valid ? sc[i][j] * scale : neg_inf();
      }
    }
    __syncthreads();
    // V tile into the shared buffer; row owners run the online softmax
    load_tile<T, HDP>(kv_s, v, b, k0, kvh, S, K, hd);
    {
      // four threads per row (neighbouring lanes), 16 keys each
      const int r = threadIdx.x >> 2;
      const int part = threadIdx.x & 3;
      float* row = p_s + r * (kBlockK + 1) + part * 16;
      const float m_prev = m_s[r];
      float m_new = m_prev;
#pragma unroll
      for (int c = 0; c < 16; ++c) m_new = fmaxf(m_new, row[c]);
      m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
      m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        // masked keys contribute exactly 0, even while no key of the
        // row has been valid yet (m_new still kNegInf)
        const float p = row[c] == neg_inf() ? 0.f : expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    // acc <- alpha * acc + P V, with P V summed straight into the
    // rescaled accumulator: 4 + kCols shared loads per 4 * kCols FMAs
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pr[4], vr[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = p_s[(ty + 16 * i) * (kBlockK + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vr[j] = kv_s[c * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int s = q0 + r;
    if (s >= S) continue;
    const float l = fmaxf(l_s[r], 1e-20f);
    T* dst = out + ((static_cast<int64_t>(b) * S + s) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dst[d] = from_float<T>(acc[i][j] / l);
    }
  }
}

inline size_t smem_bytes(int hdp) {
  return sizeof(float) *
         (static_cast<size_t>(kBlockQ + kBlockK) * (hdp + 1) + kBlockQ * (kBlockK + 1) +
          3 * kBlockQ);
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int K, int hd, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_kernel<T, HDP><<<grid, kThreadsF, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, K, hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
             int K, int hd, int causal, float scale, cudaStream_t stream) {
  if (hd <= 16) return launch<T, 16>(q, k, v, out, B, S, H, K, hd, causal, scale, stream);
  if (hd <= 32) return launch<T, 32>(q, k, v, out, B, S, H, K, hd, causal, scale, stream);
  if (hd <= 64) return launch<T, 64>(q, k, v, out, B, S, H, K, hd, causal, scale, stream);
  return launch<T, 128>(q, k, v, out, B, S, H, K, hd, causal, scale, stream);
}

}  // namespace flash
}  // namespace repro_torch

// q/out (B, S, H, hd), k/v (B, S, K, hd), contiguous, float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1); 8 <= hd <= 128, hd % 8 == 0, H % K == 0
// (the wrapper checks).  Returns cudaGetLastError() after the launch.
extern "C" int repro_torch_flash_attention(const void* q, const void* k, const void* v,
                                           void* out, int batch, int seq, int heads,
                                           int kv_heads, int head_dim, int causal,
                                           float scale, int is_bf16, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return repro_torch::flash::dispatch<__nv_bfloat16>(q, k, v, out, batch, seq, heads,
                                                       kv_heads, head_dim, causal, scale, s);
  }
  return repro_torch::flash::dispatch<float>(q, k, v, out, batch, seq, heads, kv_heads,
                                             head_dim, causal, scale, s);
}
