// Blockwise (flash) attention backward for Hopper (sm_90a): dQ, dK, dV of K4.
//
// repro_torch_flash_attention_bwd has no Pallas counterpart: the reference
// differentiates its XLA attention (models/layers.py::_sdpa and
// blockwise_attention) with XLA's autodiff, and its Pallas kernel
// (kernels/flash_attention/kernel.py::flash_attention) has no backward.
// It differentiates K4's function exactly as K4 computes it: scores
// s = q.k / sqrt(hd) in float32, keys above the causal diagonal masked at
// -1e30 (their probability is exactly 0), p = exp(s - m) / max(l, 1e-20).
// With lse = m + log(max(l, 1e-20)) per query row and D = rowsum(dO o O),
//   P = exp(S - lse),  dP = dO V^T,  dS = P o (dP - D),
//   dV = P^T dO,  dK = dS^T Q / sqrt(hd),  dQ = dS K / sqrt(hd),
// with the G = H / K query heads of a kv head summed into its dK and dV.
//
// Layout: K4's, q/out/dout/dq (B, S, H, hd), k/v/dk/dv (B, S, K, hd), query
// head h on kv head h / (H / K); any S; hd a multiple of 8 up to 128;
// float32 or bfloat16 in and out, float32 everywhere inside.
//
// Bound on an H100: at K4's table shape (B=4, S=1024, H=32, K=8, hd=128,
// causal, bf16) five S x S x hd products over the causal half (Q K^T,
// dO V^T, P^T dO, dS^T Q, dS K) are 86 GFLOP, 87 us at the 989 TFLOP/s
// bf16 tensor-core peak, against ~50 MB of inputs and outputs (15 us at
// 3.35 TB/s): bound by operations.
//
// This first design is simple and right, not fast: every product runs as
// float32 FMAs on the CUDA cores from float32 tiles in shared memory, in
// three kernels launched back to back on the caller's stream:
//   1. prep, one block per (b, h, 64-row query tile): D for its rows, and
//      lse by a pass over the key tiles left of the diagonal with an
//      online (m, l) per row (K4's forward is not touched and saves
//      nothing);
//   2. dK/dV, one block per (b, kv head, 64-key tile): K and V stay in
//      shared memory while the block walks the G query heads of its
//      group and, for each, the query tiles at or below the diagonal,
//      recomputing P and dS for the tile and summing P^T dO and dS^T Q
//      in registers;
//   3. dQ, one block per (b, h, 64-row query tile), walking the key tiles
//      left of the diagonal and summing dS K in registers.
// Each output element is summed by one thread of one block in a fixed
// order: no atomics, so repeated runs give the same bits.  The lse and D
// rows (B, H, S) float32 are scratch that the wrapper allocates.
// A block is 256 threads as 16 x 16; thread (ty, tx) holds rows ty + 16 i
// and columns tx + 16 j of a 64 x 64 score patch.  Tiles are zero-padded
// to HDP (16, 32, 64 or 128) columns with a row stride of HDP + 1 floats,
// so a warp's reads of 16 rows at one column hit 16 banks.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace flash_bwd {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPStride = kTile + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// rows [row0, row0 + 64) of a (B, S, heads, hd) tensor at head `head`
// -> smem[64][HDP + 1] float32, zero past S and past hd
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(float* smem, const T* __restrict__ src, int b, int row0,
                                          int head, int S, int heads, int hd) {
  constexpr int kStride = HDP + 1;
  for (int e = threadIdx.x; e < kTile * HDP; e += kThreads) {
    const int r = e / HDP;
    const int d = e - r * HDP;
    const int s = row0 + r;
    float x = 0.f;
    if (s < S && d < hd) {
      x = to_f32(src[((static_cast<int64_t>(b) * S + s) * heads + head) * hd + d]);
    }
    smem[r * kStride + d] = x;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two staged tiles
template <int HDP>
__device__ __forceinline__ void patch_product(const float* a_s, const float* b_s, int ty, int tx,
                                              float (&acc)[4][4]) {
  constexpr int kStride = HDP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a_s[(ty + 16 * i) * kStride + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * kStride + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool is_valid(int qpos, int kpos, int S, int causal) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos);
}

// ---------------------------------------------------------------- 1. prep

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ out,
                    const T* __restrict__ dout, float* __restrict__ lse,
                    float* __restrict__ delta, int S, int H, int K, int hd, int causal,
                    float scale) {
  constexpr int kStride = HDP + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [64][HDP + 1]
  float* k_s = q_s + kTile * kStride;     // [64][HDP + 1]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / K);
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  {  // D = rowsum(dO o O): four neighbouring lanes per row
    const int r = threadIdx.x >> 2;
    const int part = threadIdx.x & 3;
    const int s = q0 + r;
    float acc = 0.f;
    if (s < S) {
      const int64_t base = ((static_cast<int64_t>(b) * S + s) * H + h) * hd;
      for (int d = part; d < hd; d += 4) {
        acc = fmaf(to_f32(dout[base + d]), to_f32(out[base + d]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && s < S) delta[static_cast<int64_t>(bh) * S + s] = acc;
  }

  load_tile<T, HDP>(q_s, q, b, q0, h, S, H, hd);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int n_all = (S + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_all, qt + 1) : n_all;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, HDP>(k_s, k, b, k0, kvh, S, K, hd);
    __syncthreads();
    float sc[4][4];
    patch_product<HDP>(q_s, k_s, ty, tx, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] *= scale;
        if (is_valid(qpos, k0 + tx + 16 * j, S, causal)) mt = fmaxf(mt, sc[i][j]);
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (is_valid(qpos, k0 + tx + 16 * j, S, causal)) sum += expf(sc[i][j] - mt);
      }
      l[i] = l[i] * expf(m[i] - mt) + sum;
      m[i] = mt;
    }
  }
  // combine the 16 lanes of a row (tx = lane & 15)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      l[i] = l[i] * expf(m[i] - mn) + lo * expf(mo - mn);
      m[i] = mn;
    }
    const int s = q0 + ty + 16 * i;
    if (tx == 0 && s < S) {
      lse[static_cast<int64_t>(bh) * S + s] = m[i] + logf(fmaxf(l[i], 1e-20f));
    }
  }
}

// ------------------------------------------------------------- 2. dK, dV

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int S, int H, int K, int hd, int causal, float scale) {
  constexpr int kStride = HDP + 1;
  constexpr int kCols = HDP / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                      // [64][HDP + 1]
  float* v_s = k_s + kTile * kStride;     // [64][HDP + 1]
  float* q_s = v_s + kTile * kStride;     // [64][HDP + 1]
  float* do_s = q_s + kTile * kStride;    // [64][HDP + 1]
  float* p_s = do_s + kTile * kStride;    // [64][65], row = query
  float* ds_s = p_s + kTile * kPStride;   // [64][65]
  float* lse_s = ds_s + kTile * kPStride; // [64]
  float* d_s = lse_s + kTile;             // [64]

  const int bk = blockIdx.y;
  const int b = bk / K;
  const int kvh = bk - b * K;
  const int G = H / K;
  const int kt = blockIdx.x;  // longest key tiles (under the mask) first
  const int k0 = kt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, HDP>(k_s, k, b, k0, kvh, S, K, hd);
  load_tile<T, HDP>(v_s, v, b, k0, kvh, S, K, hd);
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  const int nq = (S + kTile - 1) / kTile;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t row_base = (static_cast<int64_t>(b) * H + h) * S;
    for (int t = causal ? kt : 0; t < nq; ++t) {
      const int q0 = t * kTile;
      __syncthreads();  // the last tile's readers are done
      load_tile<T, HDP>(q_s, q, b, q0, h, S, H, hd);
      load_tile<T, HDP>(do_s, dout, b, q0, h, S, H, hd);
      if (threadIdx.x < kTile) {
        const int s = q0 + threadIdx.x;
        lse_s[threadIdx.x] = s < S ? lse[row_base + s] : 0.f;
        d_s[threadIdx.x] = s < S ? delta[row_base + s] : 0.f;
      }
      __syncthreads();
      // rows: queries ty + 16 i; columns: keys tx + 16 j
      float sc[4][4], dp[4][4];
      patch_product<HDP>(q_s, k_s, ty, tx, sc);
      patch_product<HDP>(do_s, v_s, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const float p = is_valid(q0 + r, k0 + c, S, causal)
                              ? expf(sc[i][j] * scale - lse_s[r]) : 0.f;
          p_s[r * kPStride + c] = p;
          ds_s[r * kPStride + c] = p * (dp[i][j] - d_s[r]);
        }
      }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q; this thread: keys ty + 16 i,
      // columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float pv[4], sv[4], dov[kCols], qv[kCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[r * kPStride + ty + 16 * i];
          sv[i] = ds_s[r * kPStride + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          dov[j] = do_s[r * kStride + tx + 16 * j];
          qv[j] = q_s[r * kStride + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
    const int64_t base = ((static_cast<int64_t>(b) * S + s) * K + kvh) * hd;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) {
        dk[base + d] = from_float<T>(dk_acc[i][j] * scale);
        dv[base + d] = from_float<T>(dv_acc[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------------ 3. dQ

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int K,
                  int hd, int causal, float scale) {
  constexpr int kStride = HDP + 1;
  constexpr int kCols = HDP / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [64][HDP + 1]
  float* do_s = q_s + kTile * kStride;    // [64][HDP + 1]
  float* k_s = do_s + kTile * kStride;    // [64][HDP + 1]
  float* v_s = k_s + kTile * kStride;     // [64][HDP + 1]
  float* ds_s = v_s + kTile * kStride;    // [64][65], row = query
  float* lse_s = ds_s + kTile * kPStride; // [64]
  float* d_s = lse_s + kTile;             // [64]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / K);
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int q0 = qt * kTile;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t row_base = static_cast<int64_t>(bh) * S;

  load_tile<T, HDP>(q_s, q, b, q0, h, S, H, hd);
  load_tile<T, HDP>(do_s, dout, b, q0, h, S, H, hd);
  if (threadIdx.x < kTile) {
    const int s = q0 + threadIdx.x;
    lse_s[threadIdx.x] = s < S ? lse[row_base + s] : 0.f;
    d_s[threadIdx.x] = s < S ? delta[row_base + s] : 0.f;
  }
  float dq_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dq_acc[i][j] = 0.f;

  const int n_all = (S + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_all, qt + 1) : n_all;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, HDP>(k_s, k, b, k0, kvh, S, K, hd);
    load_tile<T, HDP>(v_s, v, b, k0, kvh, S, K, hd);
    __syncthreads();
    float sc[4][4], dp[4][4];
    patch_product<HDP>(q_s, k_s, ty, tx, sc);
    patch_product<HDP>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = is_valid(q0 + r, k0 + c, S, causal)
                            ? expf(sc[i][j] * scale - lse_s[r]) : 0.f;
        ds_s[r * kPStride + c] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();
    // dQ += dS K; this thread: queries ty + 16 i, columns tx + 16 j
#pragma unroll 2
    for (int c = 0; c < kTile; ++c) {
      float sv[4], kv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = ds_s[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[c * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) dq_acc[i][j] = fmaf(sv[i], kv[j], dq_acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const int64_t base = ((static_cast<int64_t>(b) * S + s) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dq[base + d] = from_float<T>(dq_acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------- launch

inline size_t tile_floats(int hdp) { return static_cast<size_t>(kTile) * (hdp + 1); }

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, int B, int S, int H, int K,
           int hd, int causal, float scale, cudaStream_t stream) {
  const size_t prep_smem = sizeof(float) * 2 * tile_floats(HDP);
  const size_t dkdv_smem =
      sizeof(float) * (4 * tile_floats(HDP) + 2 * kTile * kPStride + 2 * kTile);
  const size_t dq_smem = sizeof(float) * (4 * tile_floats(HDP) + kTile * kPStride + 2 * kTile);
  cudaError_t err = cudaFuncSetAttribute(bwd_prep_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(prep_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkdv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_tiles = (S + kTile - 1) / kTile;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* dout_ = static_cast<const T*>(dout);
  bwd_prep_kernel<T, HDP><<<dim3(n_tiles, B * H), kThreads, prep_smem, stream>>>(
      q_, k_, static_cast<const T*>(out), dout_, lse, delta, S, H, K, hd, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<T, HDP><<<dim3(n_tiles, B * K), kThreads, dkdv_smem, stream>>>(
      q_, k_, v_, dout_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, K, hd,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<T, HDP><<<dim3(n_tiles, B * H), kThreads, dq_smem, stream>>>(
      q_, k_, v_, dout_, lse, delta, static_cast<T*>(dq), S, H, K, hd, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             void* dq, void* dk, void* dv, float* lse, float* delta, int B, int S, int H, int K,
             int hd, int causal, float scale, cudaStream_t stream) {
  auto run = [&](auto hdp) {
    return launch<T, decltype(hdp)::value>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, S, H,
                                           K, hd, causal, scale, stream);
  };
  if (hd <= 16) return run(std::integral_constant<int, 16>{});
  if (hd <= 32) return run(std::integral_constant<int, 32>{});
  if (hd <= 64) return run(std::integral_constant<int, 64>{});
  return run(std::integral_constant<int, 128>{});
}

}  // namespace flash_bwd
}  // namespace repro_torch

// q/out/dout/dq (B, S, H, hd), k/v/dk/dv (B, S, K, hd), one type (float32,
// or bfloat16 when is_bf16); lse and delta: (B, H, S) float32 scratch.
// Returns cudaGetLastError after the launches (0 = launched).
extern "C" int repro_torch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                               const void* out, const void* dout, void* dq,
                                               void* dk, void* dv, float* lse, float* delta,
                                               int batch, int seq, int heads, int kv_heads,
                                               int head_dim, int causal, float scale,
                                               int is_bf16, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  namespace f = repro_torch::flash_bwd;
  if (is_bf16) {
    return f::dispatch<__nv_bfloat16>(q, k, v, out, dout, dq, dk, dv, lse, delta, batch, seq,
                                      heads, kv_heads, head_dim, causal, scale, s);
  }
  return f::dispatch<float>(q, k, v, out, dout, dq, dk, dv, lse, delta, batch, seq, heads,
                            kv_heads, head_dim, causal, scale, s);
}
