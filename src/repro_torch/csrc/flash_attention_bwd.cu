// Blockwise (flash) attention backward for Hopper (sm_90a): dQ, dK, dV of K4.
//
// repro_torch_flash_attention_bwd has no Pallas counterpart: the reference
// differentiates its XLA attention (models/layers.py::_sdpa and
// blockwise_attention) with XLA's autodiff, and its Pallas kernel
// (kernels/flash_attention/kernel.py::flash_attention) has no backward.
// It differentiates K4's function exactly as K4 computes it: scores
// s = q.k / sqrt(hd) in float32, keys above the causal diagonal and, under
// a sliding window (window > 0, causal only), keys at or below i - window
// masked at -1e30 (their probability is exactly 0),
// p = exp(s - m) / max(l, 1e-20).
// With lse = m + log(max(l, 1e-20)) per query row and D = rowsum(dO o O),
//   P = exp(S - lse),  dP = dO V^T,  dS = P o (dP - D),
//   dV = P^T dO,  dK = dS^T Q / sqrt(hd),  dQ = dS K / sqrt(hd),
// with the G = H / K query heads of a kv head summed into its dK and dV.
//
// Layout: K4's, q/out/dout/dq (B, S, H, hd), k/v/dk/dv (B, Sk, K, hd), query
// head h on kv head h / (H / K); any S and Sk (Sk != S only without the
// causal mask: the encdec family's cross-attention); hd a multiple of 8 up
// to 128.  Query rows past S and keys past Sk are masked as S was before
// the key length came: no tile past either is ever issued, and lse and D
// stay per query row.
// Under a window every pass skips the tiles wholly outside it, as it skips
// tiles wholly above the diagonal: a query tile's key tiles start at
// max(0, q0 - window + 1) / block, and a key tile's query tiles end at the
// last that holds a row below k0 + block - 1 + window.
// Three passes, launched back to back on the caller's stream: prep (lse
// and D per query row, into (B, H, rows) float32 scratch that the wrapper
// allocates, rows = S rounded up to 128), dK/dV, dQ.  Each output element
// is summed by one thread of one CTA in a fixed order: no atomics, so
// repeated runs give the same bits.
//
// Bound on an H100: at K4's table shape (B=4, S=1024, H=32, K=8, hd=128,
// causal, bf16) five S x S x hd products over the causal half (Q K^T,
// dO V^T, P^T dO, dS^T Q, dS K) are 86 GFLOP, 87 us at the 989 TFLOP/s
// bf16 tensor-core peak, against ~50 MB of inputs and outputs (15 us at
// 3.35 TB/s): bound by operations.
//
// bfloat16 inputs (the models' type, the training path) take the
// tensor-core kernels of namespace tc, prep_tc_kernel, dkdv_tc_kernel and
// dq_tc_kernel.  They share K4's forward design (csrc/flash_attention.cu):
//   * persistent CTAs of 384 threads, one per SM, walking work items with
//     a stride of the grid, the longest under the causal mask first;
//     warpgroup 0 is the producer (one thread issues TMA loads; setmaxnreg
//     24/240), warpgroups 1 and 2 each own 64 rows (queries or keys) of a
//     128-row item;
//   * TMA over 4-D maps (hd, heads, S, B) with 64-column x 64-row boxes and
//     the 128-byte swizzle; rows past S and columns past hd arrive as
//     zeros; the dK/dV pass brings lse and D rows by bulk copy beside
//     its Q and dO tiles;
//   * every product on wgmma (m64, bf16 in, float32 accumulators):
//     scores with both operands K-major from shared memory, the products
//     of P and dS with P or dS in registers (the accumulator layout of a
//     k16 slice is the A layout) and dO, Q or K read MN-major.  P and dS
//     are each carried as two bf16 parts, hi = bf16(x) and lo =
//     bf16(x - hi), one wgmma each: a single bf16 rounding of either puts
//     gradients near 0 beyond the card check of one bf16 ulp
//     (tests/test_torch_flash_attention_grad.py emulates both).  The
//     kernels therefore execute ~2x the function's operations, which caps
//     them near 50% of the bound.
//   * the softmax work in float32 registers: each exponential one
//     ex2.approx.ftz, the mask only on tiles that cross the diagonal, the
//     window's lower edge or S (two forms of the loop), work items in a snake order
//     of rounds (longest first, every other round reversed), and the
//     prep and dQ items' inputs double-buffered;
//   1. prep, per (b, h, 128-row query tile): S = Q K^T over the key tiles
//      left of the diagonal with the online (m, l) in float32 (K4's
//      forward without P V; the forward saves nothing), lse = m +
//      log2(max(l, 1e-20)) in the log2 domain, and D from O and dO tiles
//      brought by TMA beside Q;
//   2. dK/dV, per (b, kv head, 128-key tile): K and V loaded once; the Q
//      and dO tiles (64 rows) of the G query heads of the group stream
//      through a ring with their lse and D rows.  Keys are the M rows:
//      S^T = K Q^T and dP^T = V dO^T are already P^T and dP^T in the A
//      layout, and dV += P^T dO, dK += dS^T Q follow in registers;
//   3. dQ, per (b, h, 128-row query tile): Q and dO loaded once, K and V
//      tiles (64 keys) streaming; S = Q K^T, dP = dO V^T, dQ += dS K.  It
//      recomputes S and dP rather than summing dQ with atomics in pass 2.
//
// float32 inputs (not on the main path) keep the first design,
// the bwd_*_kernel<float> below: every product runs as float32 FMAs on the
// CUDA cores from float32 tiles in shared memory, in three kernels:
//   1. prep, one block per (b, h, 64-row query tile): D for its rows, and
//      lse by a pass over the key tiles left of the diagonal with an
//      online (m, l) per row;
//   2. dK/dV, one block per (b, kv head, 64-key tile): K and V stay in
//      shared memory while the block walks the G query heads of its
//      group and, for each, the query tiles at or below the diagonal,
//      recomputing P and dS for the tile and summing P^T dO and dS^T Q
//      in registers;
//   3. dQ, one block per (b, h, 64-row query tile), walking the key tiles
//      left of the diagonal and summing dS K in registers.
// A block is 256 threads as 16 x 16; thread (ty, tx) holds rows ty + 16 i
// and columns tx + 16 j of a 64 x 64 score patch.  Tiles are zero-padded
// to HDP (16, 32, 64 or 128) columns with a row stride of HDP + 1 floats,
// so a warp's reads of 16 rows at one column hit 16 banks.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace flash_bwd {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPStride = kTile + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

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

__device__ __forceinline__ bool is_valid(int qpos, int kpos, int S, int Sk, int causal,
                                         int window) {
  return qpos < S && kpos < Sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// the first 64-row key tile that holds a key in the window of query row0
__host__ __device__ __forceinline__ int first_key_tile(int row0, int window, int rows) {
  return window > 0 ? (row0 - window + 1 > 0 ? row0 - window + 1 : 0) / rows : 0;
}

// one past the last 64-row query tile that holds a query seeing a key of
// [k0, k0 + krows) under the window (rows below k0 + krows - 1 + window),
// at most n_qt
__host__ __device__ __forceinline__ int query_tiles_end(int k0, int krows, int window, int n_qt,
                                                        int rows) {
  if (window <= 0) return n_qt;
  const int end = (k0 + krows - 2 + window) / rows + 1;
  return end < n_qt ? end : n_qt;
}

// ---------------------------------------------------------------- 1. prep

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
    bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ out,
                    const T* __restrict__ dout, float* __restrict__ lse,
                    float* __restrict__ delta, int S, int Sk, int H, int K, int hd,
                    int causal, int window, float scale) {
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
  const int n_all = (Sk + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_all, qt + 1) : n_all;
  for (int t = first_key_tile(q0, window, kTile); t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, HDP>(k_s, k, b, k0, kvh, Sk, K, hd);
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
        if (is_valid(qpos, k0 + tx + 16 * j, S, Sk, causal, window)) mt = fmaxf(mt, sc[i][j]);
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (is_valid(qpos, k0 + tx + 16 * j, S, Sk, causal, window)) {
          sum += expf(sc[i][j] - mt);
        }
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
                    int S, int Sk, int H, int K, int hd, int causal, int window,
                    float scale) {
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

  load_tile<T, HDP>(k_s, k, b, k0, kvh, Sk, K, hd);
  load_tile<T, HDP>(v_s, v, b, k0, kvh, Sk, K, hd);
  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  // the query tiles that see this key tile: from the diagonal's to the
  // window's last
  const int nq = query_tiles_end(k0, kTile, window, (S + kTile - 1) / kTile, kTile);
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
          const float p = is_valid(q0 + r, k0 + c, S, Sk, causal, window)
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
    if (s >= Sk) continue;
    const int64_t base = ((static_cast<int64_t>(b) * Sk + s) * K + kvh) * hd;
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
                  const float* __restrict__ delta, T* __restrict__ dq, int S, int Sk, int H,
                  int K, int hd, int causal, int window, float scale) {
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

  const int n_all = (Sk + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_all, qt + 1) : n_all;
  for (int t = first_key_tile(q0, window, kTile); t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, HDP>(k_s, k, b, k0, kvh, Sk, K, hd);
    load_tile<T, HDP>(v_s, v, b, k0, kvh, Sk, K, hd);
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
        const float p = is_valid(q0 + r, k0 + c, S, Sk, causal, window)
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
           void* dq, void* dk, void* dv, float* lse, float* delta, int B, int S, int Sk, int H,
           int K, int hd, int causal, int window, float scale, cudaStream_t stream) {
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

  const int n_tiles = (S + kTile - 1) / kTile;      // query tiles
  const int n_key_tiles = (Sk + kTile - 1) / kTile;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* dout_ = static_cast<const T*>(dout);
  bwd_prep_kernel<T, HDP><<<dim3(n_tiles, B * H), kThreads, prep_smem, stream>>>(
      q_, k_, static_cast<const T*>(out), dout_, lse, delta, S, Sk, H, K, hd, causal, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_kernel<T, HDP><<<dim3(n_key_tiles, B * K), kThreads, dkdv_smem, stream>>>(
      q_, k_, v_, dout_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, Sk, H, K, hd,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<T, HDP><<<dim3(n_tiles, B * H), kThreads, dq_smem, stream>>>(
      q_, k_, v_, dout_, lse, delta, static_cast<T*>(dq), S, Sk, H, K, hd, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             void* dq, void* dk, void* dv, float* lse, float* delta, int B, int S, int Sk, int H,
             int K, int hd, int causal, int window, float scale, cudaStream_t stream) {
  auto run = [&](auto hdp) {
    return launch<T, decltype(hdp)::value>(q, k, v, out, dout, dq, dk, dv, lse, delta, B, S, Sk,
                                           H, K, hd, causal, window, scale, stream);
  };
  if (hd <= 16) return run(std::integral_constant<int, 16>{});
  if (hd <= 32) return run(std::integral_constant<int, 32>{});
  if (hd <= 64) return run(std::integral_constant<int, 64>{});
  return run(std::integral_constant<int, 128>{});
}

// -------------------------------------------------- bfloat16, tensor cores
namespace tc {

using namespace repro_torch::hopper;

constexpr int kBlock = 128;    // rows (queries or keys) of a work item
constexpr int kRows = 64;      // rows of a box, a streamed tile, a warpgroup's share
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kRowBytes = kTmaBox * 2;
constexpr int kRowsBytes = kRows * 4;  // one tile's lse or D rows, float32

// lse and D rows per (b, h): S rounded up to whole items, so that every
// item's rows exist
__host__ __device__ constexpr int padded_rows(int S) { return (S + kBlock - 1) / kBlock * kBlock; }

__host__ __device__ constexpr int tile_bytes(int hdp, int rows) { return rows * hdp * 2; }

// rows [row0, row0 + R) of `head`, batch row b -> an R-row tile stored as
// [HDP / 64 boxes][R rows][128 B], in 64-row boxes, counted on `bar`
template <int HDP, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int row0, int b) {
#pragma unroll
  for (int c = 0; c < HDP / kTmaBox; ++c) {
#pragma unroll
    for (int r = 0; r < R; r += kRows) {
      tma_load_4d(dst + (c * R + r) * kRowBytes, map, bar, c * kTmaBox, head, row0 + r, b);
    }
  }
}

// K-major operand: rows [r, r + 64) of an R-row tile, k16 slice kk of hd
template <int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int r, int kk) {
  return desc_sw128(tile + ((kk >> 2) * R + r) * kRowBytes + (kk & 3) * 32, 16, 1024);
}

// MN-major B operand: rows [16 kk, 16 kk + 16) of a 64-row tile as the K
// dimension, its hd columns as N (the second 64-column block one box on)
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * kRowBytes, kRows * kRowBytes, 1024);
}

// acc(64 x 64) = A B^T over hd: A rows [a_row, a_row + 64) of an RA-row
// tile, B a 64-row tile; issued and committed, not waited for
template <int HDP, int RA>
__device__ __forceinline__ void scores(float (&acc)[32], uint32_t a, int a_row, uint32_t b) {
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    wgmma_ss<kRows>(acc, kmajor<RA>(a, a_row, kk), kmajor<kRows>(b, 0, kk), kk > 0 ? 1 : 0);
  }
  wg_commit();
}

// a 64 x 64 float32 accumulator as hi + lo bf16 A fragments: k16 slice kk
// holds columns 16 kk .. 16 kk + 15, register e of it the pair
// (8 kk + 2 e, +1)
__device__ __forceinline__ void split_frags(const float (&x)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_bf16x2(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], hi[kk][e], lo[kk][e]);
    }
  }
}

// acc(64 x HDP) += X B, X = hi + lo (64 x 64) and B a 64-row tile read
// MN-major: eight wgmmas, issued (the caller fences and commits)
template <int HDP>
__device__ __forceinline__ void product_rs(float (&acc)[HDP / 2], const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<HDP>(acc, hi[kk], mnmajor(b, kk));
    wgmma_rs<HDP>(acc, lo[kk], mnmajor(b, kk));
  }
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// 2^x as one ex2.approx.ftz (relative error ~2^-22, 2^-inf = +0); the
// accurate exp2f costs ~0.08 ms more per call at qwen3-8b's shape on an
// H100 (scripts/time_model_kernels.py --variants)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one of the eight consumer warps releases a ring stage or a buffer
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// The work item of a persistent CTA's round r: rounds of gridDim.x items,
// every other one walked backwards, so that a CTA that drew a long item
// (items come longest first) draws a short one next.  Past the last item
// in the last round: -1.
__device__ __forceinline__ int item_of_round(int r, int n_items) {
  const int g = static_cast<int>(gridDim.x);
  const int b = static_cast<int>(blockIdx.x);
  const int w = r * g + ((r & 1) ? g - 1 - b : b);
  return w < n_items ? w : -1;
}

// Work item w of the prep and dQ passes: (b*h, 128-row query tile), the
// highest query tiles (the longest under the causal mask) first, with the
// 64-key tiles [kt0, n_kt): from the first in the window of its first row
// to the last that reaches its last row, or without the causal mask the
// last of the Sk keys.
struct QItem {
  int q0, b, h, kt0, n_kt;
};

__device__ __forceinline__ QItem q_item(int w, int BH, int H, int S, int Sk, int causal,
                                        int window) {
  const int n_qt = (S + kBlock - 1) / kBlock;
  const int qt = causal ? n_qt - 1 - w / BH : w / BH;
  const int bh = w - (w / BH) * BH;
  QItem it;
  it.q0 = qt * kBlock;
  it.b = bh / H;
  it.h = bh - it.b * H;
  const int n_kt_all = (Sk + kRows - 1) / kRows;
  it.n_kt = causal ? min(n_kt_all, (it.q0 + kBlock - 1) / kRows + 1) : n_kt_all;
  it.kt0 = first_key_tile(it.q0, window, kRows);
  return it;
}

// the key tiles [lo, hi) that the consumer warpgroup of rows [row_lo,
// row_lo + 64) computes: none for rows wholly past S; under the causal
// mask the item's last tile can lie wholly above its rows, under a window
// its first wholly below their window
struct Tiles {
  int lo, hi;
};

__device__ __forceinline__ Tiles tiles_of(const QItem& it, int row_lo, int S, int causal,
                                          int window) {
  if (row_lo >= S) return {it.kt0, it.kt0};
  return {first_key_tile(row_lo, window, kRows),
          causal ? min(it.n_kt, (row_lo + kRows - 1) / kRows + 1) : it.n_kt};
}

// ---------------------------------------------------------------- 1. prep

template <int HDP>
struct PrepLayout {
  static constexpr int kBuffers = 2;  // of the items' Q, O and dO tiles
  static constexpr int kStages = 2;   // of the K ring
  // [buffer] an item's 128-row Q, O and dO tiles, so the next item's
  // load overlaps this one's work
  static constexpr int kQ = 0;
  static constexpr int kO = kQ + tile_bytes(HDP, kBlock);
  static constexpr int kDO = kO + tile_bytes(HDP, kBlock);
  static constexpr int kIn = 3 * tile_bytes(HDP, kBlock);  // one buffer
  static constexpr int kK = kBuffers * kIn;                // [stage] 64-row K tiles
  static constexpr int kBar = kK + kStages * tile_bytes(HDP, kRows);
  static constexpr int kBars = 2 * kBuffers + 2 * kStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment slack
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    prep_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap o_map,
                   const __grid_constant__ CUtensorMap do_map, float* __restrict__ lse,
                   float* __restrict__ delta, int B, int S, int Sk, int H, int K, int causal,
                   int window, float scale_log2) {
  using L = PrepLayout<HDP>;
  constexpr int kStages = L::kStages;
  constexpr int kBuffers = L::kBuffers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + L::kBar;
  auto q_full = [&](int qb) { return bars + 8u * qb; };
  auto q_empty = [&](int qb) { return bars + 8u * (kBuffers + qb); };
  auto k_full = [&](int st) { return bars + 8u * (2 * kBuffers + st); };
  auto k_empty = [&](int st) { return bars + 8u * (2 * kBuffers + kStages + st); };
  const int BH = B * H;
  const int n_items = (S + kBlock - 1) / kBlock * BH;
  const int rows = padded_rows(S);

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < kBuffers; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), kConsumerWarps);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(k_empty(st), kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: one thread loads each item's Q, O and dO
    // and keeps the K ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int kv = 0;  // K tiles issued so far: the ring's stage and phase
      for (int rd = 0, n = 0; rd * static_cast<int>(gridDim.x) < n_items; ++rd) {
        const int w = item_of_round(rd, n_items);
        if (w < 0) continue;
        const QItem it = q_item(w, BH, H, S, Sk, causal, window);
        const int qb = n % kBuffers;
        const uint32_t in = base + qb * L::kIn;
        mbar_wait(q_empty(qb), ((n / kBuffers) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), L::kIn);
        load_tile<HDP, kBlock>(in + L::kQ, &q_map, q_full(qb), it.h, it.q0, it.b);
        load_tile<HDP, kBlock>(in + L::kO, &o_map, q_full(qb), it.h, it.q0, it.b);
        load_tile<HDP, kBlock>(in + L::kDO, &do_map, q_full(qb), it.h, it.q0, it.b);
        ++n;
        for (int t = it.kt0; t < it.n_kt; ++t, ++kv) {
          const int st = kv % kStages;
          mbar_wait(k_empty(st), ((kv / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full(st), tile_bytes(HDP, kRows));
          load_tile<HDP, kRows>(base + L::kK + st * tile_bytes(HDP, kRows), &k_map, k_full(st),
                                it.h / (H / K), t * kRows, it.b);
        }
      }
    }
  } else {
    // ---------------- consumers: rows [q0 + 64 cw, +64) of each item
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int cq = 2 * (lane & 3);
    int kv = 0;
    for (int rd = 0, n = 0; rd * static_cast<int>(gridDim.x) < n_items; ++rd) {
      const int w = item_of_round(rd, n_items);
      if (w < 0) continue;
      const QItem it = q_item(w, BH, H, S, Sk, causal, window);
      const int qb = n % kBuffers;
      const uint32_t in = base + qb * L::kIn;
      const int row_lo = it.q0 + kRows * cw;
      // accumulator element j: row r0 + 8 ((j >> 1) & 1), key
      // 8 (j >> 2) + cq + (j & 1) of the tile
      const int r0 = row_lo + 16 * warp + (lane >> 2);
      const Tiles mine = tiles_of(it, row_lo, S, causal, window);
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this thread's share of the row sums
      mbar_wait(q_full(qb), (n / kBuffers) & 1);
      for (int t = it.kt0; t < it.n_kt; ++t) {
        const int st = (kv + t - it.kt0) % kStages;
        mbar_wait(k_full(st), ((kv + t - it.kt0) / kStages) & 1);
        if (t >= mine.lo && t < mine.hi) {
          const int k0 = t * kRows;
          float s[32];
          scores<HDP, kBlock>(s, in + L::kQ, kRows * cw,
                              base + L::kK + st * tile_bytes(HDP, kRows));
          wg_wait<0>();
          fence_regs(s);
          // mask (only a tile that crosses the diagonal, the window's lower
          // edge or Sk needs one), online (m, l) in the log2 domain: K4's
          // forward without P V
          const bool edge = k0 + kRows > Sk || (causal && k0 + kRows - 1 > row_lo) ||
                            (window > 0 && k0 <= row_lo + kRows - 1 - window);
          auto scale_and_mask = [&](auto masked) {
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              s[j] *= scale_log2;
              if constexpr (decltype(masked)::value) {
                const int key = k0 + 8 * (j >> 2) + cq + (j & 1);
                const int row = r0 + 8 * ((j >> 1) & 1);
                if (!(key < Sk && (!causal || key <= row) && (window <= 0 || key > row - window))) {
                  s[j] = neg_inf();
                }
              }
            }
          };
          if (edge) {
            scale_and_mask(std::true_type{});
          } else {
            scale_and_mask(std::false_type{});
          }
          float mx[2] = {m[0], m[1]};
#pragma unroll
          for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            l[r] *= ex2(m[r] - mx[r]);
            m[r] = mx[r];
          }
          // masked keys contribute exactly 0 (2^-inf)
#pragma unroll
          for (int j = 0; j < 32; ++j) l[(j >> 1) & 1] += ex2(s[j] - m[(j >> 1) & 1]);
        }
        release(k_empty(st));
      }
      kv += it.n_kt - it.kt0;
      // D = rowsum(dO o O) from the tiles in shared memory: two threads per
      // row, each summing half of its 16-byte chunks.  The 128-byte swizzle
      // permutes the chunks within a row alike in O and dO, so chunks at
      // one address pair up; columns past hd are zeros.
      constexpr int kHalf = HDP / 16;  // chunks per thread
      const int rr = kRows * cw + ((threadIdx.x & 127) >> 1);
      float d_acc = 0.f;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const int ch = (threadIdx.x & 1) * kHalf + i;
        const int off = ((ch >> 3) * kBlock + rr) * kRowBytes + (ch & 7) * 16;
        const uint4 o4 = *reinterpret_cast<const uint4*>(base_ptr + qb * L::kIn + L::kO + off);
        const uint4 g4 = *reinterpret_cast<const uint4*>(base_ptr + qb * L::kIn + L::kDO + off);
        const uint32_t ow[4] = {o4.x, o4.y, o4.z, o4.w};
        const uint32_t gw[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
          const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[e]));
          d_acc = fmaf(gf.x, of.x, d_acc);
          d_acc = fmaf(gf.y, of.y, d_acc);
        }
      }
      d_acc += __shfl_xor_sync(0xffffffffu, d_acc, 1);
      release(q_empty(qb));  // Q, O and dO are no longer read
      // lse in the log2 domain, and D; rows past S (up to the padded
      // rows) get 0
      const int64_t row_base = static_cast<int64_t>(it.b * H + it.h) * rows;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = r0 + 8 * r;
        if ((lane & 3) == 0) {
          lse[row_base + row] = row < S ? m[r] + log2f(fmaxf(l[r], 1e-20f)) : 0.f;
        }
      }
      if ((threadIdx.x & 1) == 0) {
        delta[row_base + it.q0 + rr] = it.q0 + rr < S ? d_acc : 0.f;
      }
      ++n;
    }
  }
}

// ------------------------------------------------------------- 2. dK, dV

template <int HDP>
struct DkdvLayout {
  static constexpr int kStages = 2;  // of the Q/dO ring
  static constexpr int kK = 0;                                         // 128-row K tile
  static constexpr int kV = kK + tile_bytes(HDP, kBlock);              // 128-row V tile
  static constexpr int kQ = kV + tile_bytes(HDP, kBlock);              // [stage] 64-row Q
  static constexpr int kDO = kQ + kStages * tile_bytes(HDP, kRows);    // [stage] 64-row dO
  static constexpr int kLse = kDO + kStages * tile_bytes(HDP, kRows);  // [stage] 64 floats
  static constexpr int kD = kLse + kStages * kRowsBytes;               // [stage] 64 floats
  static constexpr int kBar = kD + kStages * kRowsBytes;
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages) + 1024;
};

// Work item w of the dK/dV pass: (b*K + kv head, 128-key tile), the lowest
// key tiles (the longest under the causal mask) first; its 64-row query
// tiles [t0, t1): from the diagonal's to the last that holds a row in the
// window of its last key
struct KItem {
  int k0, b, kvh, t0, t1;
};

__device__ __forceinline__ KItem k_item(int w, int BK, int K, int causal, int window,
                                        int n_qt) {
  const int kt = w / BK;
  const int bk = w - kt * BK;
  KItem it;
  it.k0 = kt * kBlock;
  it.b = bk / K;
  it.kvh = bk - it.b * K;
  it.t0 = causal ? it.k0 / kRows : 0;
  it.t1 = query_tiles_end(it.k0, kBlock, window, n_qt, kRows);
  return it;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    dkdv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int B, int S, int Sk, int H, int K, int hd,
                   int causal, int window, float scale_log2, float scale) {
  using L = DkdvLayout<HDP>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + L::kBar;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto q_full = [&](int st) { return bars + 8u * (2 + st); };
  auto q_empty = [&](int st) { return bars + 8u * (2 + kStages + st); };
  const int G = H / K;
  const int BK = B * K;
  const int n_items = (Sk + kBlock - 1) / kBlock * BK;
  const int n_qt = (S + kRows - 1) / kRows;
  const int rows = padded_rows(S);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerWarps);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(q_full(st), 1);
      mbar_init(q_empty(st), kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: K and V once per item, then the ring of
    // (Q, dO, lse, D) tiles of the group's query heads
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int c = 0;  // Q tiles issued so far: the ring's stage and phase
      for (int rd = 0, n = 0; rd * static_cast<int>(gridDim.x) < n_items; ++rd) {
        const int w = item_of_round(rd, n_items);
        if (w < 0) continue;
        const KItem it = k_item(w, BK, K, causal, window, n_qt);
        mbar_wait(kv_empty, (n++ & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * tile_bytes(HDP, kBlock));
        load_tile<HDP, kBlock>(base + L::kK, &k_map, kv_full, it.kvh, it.k0, it.b);
        load_tile<HDP, kBlock>(base + L::kV, &v_map, kv_full, it.kvh, it.k0, it.b);
        for (int g = 0; g < G; ++g) {
          const int h = it.kvh * G + g;
          const int64_t row_base = static_cast<int64_t>(it.b * H + h) * rows;
          for (int t = it.t0; t < it.t1; ++t, ++c) {
            const int st = c % kStages;
            mbar_wait(q_empty(st), ((c / kStages) & 1) ^ 1);
            mbar_expect_tx(q_full(st), 2 * tile_bytes(HDP, kRows) + 2 * kRowsBytes);
            load_tile<HDP, kRows>(base + L::kQ + st * tile_bytes(HDP, kRows), &q_map, q_full(st),
                                  h, t * kRows, it.b);
            load_tile<HDP, kRows>(base + L::kDO + st * tile_bytes(HDP, kRows), &do_map,
                                  q_full(st), h, t * kRows, it.b);
            bulk_load(base + L::kLse + st * kRowsBytes, lse + row_base + t * kRows, kRowsBytes,
                      q_full(st));
            bulk_load(base + L::kD + st * kRowsBytes, delta + row_base + t * kRows, kRowsBytes,
                      q_full(st));
          }
        }
      }
    }
  } else {
    // ---------------- consumers: keys [k0 + 64 cw, +64) of each item
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int cq = 2 * (lane & 3);
    int c = 0;
    for (int rd = 0, n = 0; rd * static_cast<int>(gridDim.x) < n_items; ++rd) {
      const int w = item_of_round(rd, n_items);
      if (w < 0) continue;
      const KItem it = k_item(w, BK, K, causal, window, n_qt);
      const int key_lo = it.k0 + kRows * cw;
      // accumulator element j: key key0 + 8 ((j >> 1) & 1), column (a query
      // of the tile in S^T, a column of hd in dK and dV) 8 (j >> 2) + cq +
      // (j & 1)
      const int key0 = key_lo + 16 * warp + (lane >> 2);
      float dk_acc[HDP / 2], dv_acc[HDP / 2];
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) {
        dk_acc[j] = 0.f;
        dv_acc[j] = 0.f;
      }
      mbar_wait(kv_full, n++ & 1);
      for (int g = 0; g < G; ++g) {
        for (int t = it.t0; t < it.t1; ++t, ++c) {
          const int st = c % kStages;
          mbar_wait(q_full(st), (c / kStages) & 1);
          // skipped: keys wholly past Sk, a query tile wholly above them, or
          // one wholly past their window
          if (key_lo < Sk && (!causal || t * kRows + kRows - 1 >= key_lo) &&
              (window <= 0 || t * kRows < key_lo + kRows - 1 + window)) {
            const uint32_t q_tile = base + L::kQ + st * tile_bytes(HDP, kRows);
            const uint32_t do_tile = base + L::kDO + st * tile_bytes(HDP, kRows);
            const float* lse_s =
                reinterpret_cast<const float*>(base_ptr + L::kLse + st * kRowsBytes);
            const float* d_s = reinterpret_cast<const float*>(base_ptr + L::kD + st * kRowsBytes);
            // ---- S^T = K Q^T and dP^T = V dO^T on the tensor cores
            float s[32], dp[32];
            scores<HDP, kBlock>(s, base + L::kK, kRows * cw, q_tile);
            scores<HDP, kBlock>(dp, base + L::kV, kRows * cw, do_tile);
            wg_wait<0>();
            fence_regs(s);
            fence_regs(dp);
            // ---- P^T = exp2(S^T scale - lse), dS^T = P^T o (dP^T - D); the
            // mask only where the tile crosses the diagonal, the window's
            // edge, S or Sk
            const bool edge = key_lo + kRows > Sk || t * kRows + kRows > S ||
                              (causal && key_lo + kRows - 1 > t * kRows) ||
                              (window > 0 && t * kRows + kRows - 1 >= key_lo + window);
            auto probs = [&](auto masked) {
#pragma unroll
              for (int cc = 0; cc < 8; ++cc) {
                const float2 lq = *reinterpret_cast<const float2*>(lse_s + 8 * cc + cq);
                const float2 dq = *reinterpret_cast<const float2*>(d_s + 8 * cc + cq);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int j = 4 * cc + e;
                  float p = ex2(s[j] * scale_log2 - ((e & 1) ? lq.y : lq.x));
                  if constexpr (decltype(masked)::value) {
                    const int key = key0 + 8 * (e >> 1);
                    const int query = t * kRows + 8 * cc + cq + (e & 1);
                    // masked pairs give p = 0 exactly
                    if (!(key < Sk && query < S && (!causal || key <= query) &&
                          (window <= 0 || key > query - window))) {
                      p = 0.f;
                    }
                  }
                  s[j] = p;
                  dp[j] = p * (dp[j] - ((e & 1) ? dq.y : dq.x));
                }
              }
            };
            if (edge) {
              probs(std::true_type{});
            } else {
              probs(std::false_type{});
            }
            // ---- dV += P^T dO and dK += dS^T Q, each A operand as hi + lo
            uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
            split_frags(s, p_hi, p_lo);
            split_frags(dp, ds_hi, ds_lo);
            wg_fence();
            product_rs<HDP>(dv_acc, p_hi, p_lo, do_tile);
            product_rs<HDP>(dk_acc, ds_hi, ds_lo, q_tile);
            wg_commit();
            wg_wait<0>();
            fence_regs(dv_acc);
            fence_regs(dk_acc);
          }
          release(q_empty(st));
        }
      }
      release(kv_empty);  // K and V are no longer read
      // ---- epilogue: dK scaled once, one cast each
#pragma unroll
      for (int j = 0; j < HDP / 2; j += 2) {
        const int key = key0 + 8 * ((j >> 1) & 1);
        const int col = 8 * (j >> 2) + cq;
        if (key < Sk && col < hd) {
          const int64_t at = ((static_cast<int64_t>(it.b) * Sk + key) * K + it.kvh) * hd + col;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) =
              __floats2bfloat162_rn(dk_acc[j] * scale, dk_acc[j + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(dv_acc[j], dv_acc[j + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ 3. dQ

template <int HDP>
struct DqLayout {
  static constexpr int kBuffers = 2;  // of the items' Q and dO tiles
  static constexpr int kStages = 2;   // of the K/V ring
  // [buffer] an item's 128-row Q and dO tiles
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + tile_bytes(HDP, kBlock);
  static constexpr int kIn = 2 * tile_bytes(HDP, kBlock);           // one buffer
  static constexpr int kK = kBuffers * kIn;                         // [stage] 64-row K
  static constexpr int kV = kK + kStages * tile_bytes(HDP, kRows);  // [stage] 64-row V
  static constexpr int kBar = kV + kStages * tile_bytes(HDP, kRows);
  static constexpr int kBytes = kBar + 8 * (2 * kBuffers + 3 * kStages) + 1024;
};

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                 const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int B, int S,
                 int Sk, int H, int K, int hd, int causal, int window, float scale_log2,
                 float scale) {
  using L = DqLayout<HDP>;
  constexpr int kStages = L::kStages;
  constexpr int kBuffers = L::kBuffers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBar;
  auto q_full = [&](int qb) { return bars + 8u * qb; };
  auto q_empty = [&](int qb) { return bars + 8u * (kBuffers + qb); };
  auto k_full = [&](int st) { return bars + 8u * (2 * kBuffers + st); };
  auto v_full = [&](int st) { return bars + 8u * (2 * kBuffers + kStages + st); };
  auto empty = [&](int st) { return bars + 8u * (2 * kBuffers + 2 * kStages + st); };
  const int BH = B * H;
  const int n_items = (S + kBlock - 1) / kBlock * BH;
  const int rows = padded_rows(S);

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < kBuffers; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), kConsumerWarps);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: one thread loads each item's Q and dO and
    // keeps the K/V ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles issued so far: the ring's stage and phase
      for (int rd = 0, n = 0; rd * static_cast<int>(gridDim.x) < n_items; ++rd) {
        const int w = item_of_round(rd, n_items);
        if (w < 0) continue;
        const QItem it = q_item(w, BH, H, S, Sk, causal, window);
        const int kvh = it.h / (H / K);
        const int qb = n % kBuffers;
        const uint32_t in = base + qb * L::kIn;
        mbar_wait(q_empty(qb), ((n / kBuffers) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), L::kIn);
        load_tile<HDP, kBlock>(in + L::kQ, &q_map, q_full(qb), it.h, it.q0, it.b);
        load_tile<HDP, kBlock>(in + L::kDO, &do_map, q_full(qb), it.h, it.q0, it.b);
        ++n;
        for (int t = it.kt0; t < it.n_kt; ++t, ++kv) {
          const int st = kv % kStages;
          mbar_wait(empty(st), ((kv / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full(st), tile_bytes(HDP, kRows));
          load_tile<HDP, kRows>(base + L::kK + st * tile_bytes(HDP, kRows), &k_map, k_full(st),
                                kvh, t * kRows, it.b);
          mbar_expect_tx(v_full(st), tile_bytes(HDP, kRows));
          load_tile<HDP, kRows>(base + L::kV + st * tile_bytes(HDP, kRows), &v_map, v_full(st),
                                kvh, t * kRows, it.b);
        }
      }
    }
  } else {
    // ---------------- consumers: rows [q0 + 64 cw, +64) of each item
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const int cq = 2 * (lane & 3);
    int kv = 0;
    for (int rd = 0, n = 0; rd * static_cast<int>(gridDim.x) < n_items; ++rd) {
      const int w = item_of_round(rd, n_items);
      if (w < 0) continue;
      const QItem it = q_item(w, BH, H, S, Sk, causal, window);
      const int qb = n % kBuffers;
      const uint32_t in = base + qb * L::kIn;
      const int row_lo = it.q0 + kRows * cw;
      // accumulator element j: row r0 + 8 ((j >> 1) & 1), column (a key of
      // the tile in S, a column of hd in dQ) 8 (j >> 2) + cq + (j & 1)
      const int r0 = row_lo + 16 * warp + (lane >> 2);
      const Tiles mine = tiles_of(it, row_lo, S, causal, window);
      const int64_t row_base = static_cast<int64_t>(it.b * H + it.h) * rows;
      const float lse_r[2] = {lse[row_base + r0], lse[row_base + r0 + 8]};
      const float d_r[2] = {delta[row_base + r0], delta[row_base + r0 + 8]};
      float dq_acc[HDP / 2];
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) dq_acc[j] = 0.f;
      mbar_wait(q_full(qb), (n / kBuffers) & 1);
      for (int t = it.kt0; t < it.n_kt; ++t) {
        const int st = (kv + t - it.kt0) % kStages;
        const uint32_t phase = ((kv + t - it.kt0) / kStages) & 1;
        mbar_wait(k_full(st), phase);
        mbar_wait(v_full(st), phase);
        if (t >= mine.lo && t < mine.hi) {
          const int k0 = t * kRows;
          const uint32_t k_tile = base + L::kK + st * tile_bytes(HDP, kRows);
          // ---- S = Q K^T and dP = dO V^T on the tensor cores
          float s[32], dp[32];
          scores<HDP, kBlock>(s, in + L::kQ, kRows * cw, k_tile);
          scores<HDP, kBlock>(dp, in + L::kDO, kRows * cw,
                              base + L::kV + st * tile_bytes(HDP, kRows));
          wg_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          // ---- dS = P o (dP - D), P = exp2(S scale - lse); the mask only
          // where the tile crosses the diagonal, the window's lower edge, S
          // or Sk
          const bool edge = k0 + kRows > Sk || row_lo + kRows > S ||
                            (causal && k0 + kRows - 1 > row_lo) ||
                            (window > 0 && k0 <= row_lo + kRows - 1 - window);
          auto probs = [&](auto masked) {
#pragma unroll
            for (int j = 0; j < 32; ++j) {
              const int r = (j >> 1) & 1;
              float p = ex2(s[j] * scale_log2 - lse_r[r]);
              if constexpr (decltype(masked)::value) {
                const int key = k0 + 8 * (j >> 2) + cq + (j & 1);
                const int row = r0 + 8 * r;
                // masked pairs give p = 0 exactly
                if (!(key < Sk && row < S && (!causal || key <= row) &&
                      (window <= 0 || key > row - window))) {
                  p = 0.f;
                }
              }
              dp[j] = p * (dp[j] - d_r[r]);
            }
          };
          if (edge) {
            probs(std::true_type{});
          } else {
            probs(std::false_type{});
          }
          // ---- dQ += dS K, dS as hi + lo, K read MN-major
          uint32_t ds_hi[4][4], ds_lo[4][4];
          split_frags(dp, ds_hi, ds_lo);
          wg_fence();
          product_rs<HDP>(dq_acc, ds_hi, ds_lo, k_tile);
          wg_commit();
          wg_wait<0>();
          fence_regs(dq_acc);
        }
        release(empty(st));
      }
      kv += it.n_kt - it.kt0;
      release(q_empty(qb));  // Q and dO are no longer read
      // ---- epilogue: scaled once, one cast
#pragma unroll
      for (int j = 0; j < HDP / 2; j += 2) {
        const int row = r0 + 8 * ((j >> 1) & 1);
        const int col = 8 * (j >> 2) + cq;
        if (row < S && col < hd) {
          *reinterpret_cast<__nv_bfloat162*>(
              dq + ((static_cast<int64_t>(it.b) * S + row) * H + it.h) * hd + col) =
              __floats2bfloat162_rn(dq_acc[j] * scale, dq_acc[j + 1] * scale);
        }
      }
      ++n;
    }
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, int B, int S, int Sk, int H,
           int K, int hd, int causal, int window, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  CUtensorMap qm, km, vm, om, dom;
  if (!make_map(encode, &qm, q, B, S, H, hd, kRows) ||
      !make_map(encode, &km, k, B, Sk, K, hd, kRows) ||
      !make_map(encode, &vm, v, B, Sk, K, hd, kRows) ||
      !make_map(encode, &om, out, B, S, H, hd, kRows) ||
      !make_map(encode, &dom, dout, B, S, H, hd, kRows)) {
    return kErrEncode;
  }
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(prep_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  PrepLayout<HDP>::kBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dkdv_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DkdvLayout<HDP>::kBytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dq_tc_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DqLayout<HDP>::kBytes)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // one persistent CTA per SM, or one per work item if there are fewer
  const long long n_tiles = (S + kBlock - 1) / kBlock;        // query items per (b, h)
  const long long n_key_tiles = (Sk + kBlock - 1) / kBlock;   // key items per (b, kv head)
  auto grid = [&](long long n_items) {
    return static_cast<int>(n_items < n_sm ? n_items : n_sm);
  };
  const float scale_log2 = scale * 1.4426950408889634f;
  prep_tc_kernel<HDP><<<grid(n_tiles * B * H), kThreads, PrepLayout<HDP>::kBytes, stream>>>(
      qm, km, om, dom, lse, delta, B, S, Sk, H, K, causal, window, scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dkdv_tc_kernel<HDP><<<grid(n_key_tiles * B * K), kThreads, DkdvLayout<HDP>::kBytes, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, S, Sk, H, K, hd, causal, window, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  dq_tc_kernel<HDP><<<grid(n_tiles * B * H), kThreads, DqLayout<HDP>::kBytes, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dq), B, S, Sk, H, K, hd, causal,
      window, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace flash_bwd
}  // namespace repro_torch

// lse and D scratch rows per (b, h) for a sequence of `seq` rows (the
// float32 kernels use the first `seq` of each)
extern "C" int repro_torch_flash_attention_bwd_rows(int seq) {
  return repro_torch::flash_bwd::tc::padded_rows(seq);
}

// q/out/dout/dq (B, S, H, hd), k/v/dk/dv (B, kv_seq, K, hd), one type
// (float32, or bfloat16 when is_bf16); lse and delta: (B, H, rows) float32
// scratch, rows from repro_torch_flash_attention_bwd_rows(seq), one per
// query row; kv_seq >= 1, and kv_seq == seq under the causal mask; window
// > 0 only with causal.  Returns cudaGetLastError after the launches (0 =
// launched), or a negative code when a TMA map could not be made (bf16
// only).
extern "C" int repro_torch_flash_attention_bwd_kv(
    const void* q, const void* k, const void* v, const void* out, const void* dout, void* dq,
    void* dk, void* dv, float* lse, float* delta, int batch, int seq, int kv_seq, int heads,
    int kv_heads, int head_dim, int causal, int window, float scale, int is_bf16, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  namespace f = repro_torch::flash_bwd;
  if (is_bf16) {
    if (head_dim <= 64) {
      return f::tc::launch<64>(q, k, v, out, dout, dq, dk, dv, lse, delta, batch, seq, kv_seq,
                               heads, kv_heads, head_dim, causal, window, scale, s);
    }
    return f::tc::launch<128>(q, k, v, out, dout, dq, dk, dv, lse, delta, batch, seq, kv_seq,
                              heads, kv_heads, head_dim, causal, window, scale, s);
  }
  return f::dispatch<float>(q, k, v, out, dout, dq, dk, dv, lse, delta, batch, seq, kv_seq,
                            heads, kv_heads, head_dim, causal, window, scale, s);
}

// The entries with one length for queries and keys (kv_seq = seq), with
// and without a window, as before the key length came, so that
// scripts/time_model_kernels.py --against can time an older checkout and
// today's sources through one call.
extern "C" int repro_torch_flash_attention_bwd_windowed(
    const void* q, const void* k, const void* v, const void* out, const void* dout, void* dq,
    void* dk, void* dv, float* lse, float* delta, int batch, int seq, int heads, int kv_heads,
    int head_dim, int causal, int window, float scale, int is_bf16, void* stream) {
  return repro_torch_flash_attention_bwd_kv(q, k, v, out, dout, dq, dk, dv, lse, delta, batch,
                                            seq, seq, heads, kv_heads, head_dim, causal, window,
                                            scale, is_bf16, stream);
}

extern "C" int repro_torch_flash_attention_bwd(const void* q, const void* k, const void* v,
                                               const void* out, const void* dout, void* dq,
                                               void* dk, void* dv, float* lse, float* delta,
                                               int batch, int seq, int heads, int kv_heads,
                                               int head_dim, int causal, float scale,
                                               int is_bf16, void* stream) {
  return repro_torch_flash_attention_bwd_kv(q, k, v, out, dout, dq, dk, dv, lse, delta, batch,
                                            seq, seq, heads, kv_heads, head_dim, causal, 0, scale,
                                            is_bf16, stream);
}
