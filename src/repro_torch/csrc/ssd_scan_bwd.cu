// Mamba2 SSD chunked scan backward for Hopper (sm_90a): the gradients of K5.
//
// repro_torch_ssd_scan_bwd has no Pallas counterpart: the reference trains
// through XLA's autodiff of src/repro/models/ssm.py::_ssd_core (its
// Pallas kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan has no
// backward).  It differentiates K5's function (csrc/ssd_scan.cu): per
// (batch, head), with cum the running sum of dt * A within a chunk, seg its
// last value, H the state entering the chunk and G the gradient of the
// state leaving it (dh for the last chunk),
//   M_ij = (C_i . B_j) exp(cum_i - cum_j)            for j <= i only
//   v_j  = sum_{i>=j} M_ij g_i + exp(seg - cum_j) G B_j,   dx_j = dt_j v_j
//   dC_i = sum_h [ sum_{j<=i} W_ij B_j + exp(cum_i) H^T g_i ]
//   dB_j = sum_h [ sum_{i>=j} W_ij C_i + exp(seg - cum_j) dt_j G^T x_j ]
//   W_ij = exp(cum_i - cum_j) dt_j (g_i . x_j)       for j <= i only
//   G_prev = exp(seg) G + sum_i exp(cum_i) g_i C_i^T  (a reverse scan)
// with g = dy and B, C shared by every head (ngroups = 1).  cum's
// gradient is g_k . y_k - dt_k x_k . v_k (y recomputed in float32), plus
// <G, state leaving the chunk> at the chunk's last row; its reverse running
// sum r within the chunk is the gradient of dt * A, so ddt_k = x_k . v_k +
// A r_k and dA = sum_{b, k} dt_k r_k.  Above the diagonal the exponent is
// positive and may overflow, so no exponential is taken there.
//
// Bound on an H100: at mamba2-1.3b's training shape (B=4, S=1024, 64
// heads, P=64, N=128, bf16) the function reads x, dy (33.5 MB each), dt,
// B, C and writes dx (33.5 MB), ddt, dB, dC (~1 MB each): ~107 MB, 32 us at
// 3.35 TB/s.  Its operations at the chunk length that needs fewest (16),
// counted as chip_smoke.ssd_bwd_flops counts them, are ~22.7 GFLOP; at
// float32 accuracy on the bf16 tensor cores a product with a float32
// operand takes hi + lo parts (twice the products; C.B^T and g.x^T have
// bf16 operands): ~45.0 GFLOP, 46 us at 989 TFLOP/s: bound by operations.
//
// This first design runs every product as float32 FMAs on the CUDA cores
// (~32 GFLOP executed; 0.48 ms at the 67 TFLOP/s float32 peak), for bf16
// and float32 inputs alike (both computed in float32), from float32 tiles
// in shared memory: each thread of a 256-thread block owns a 4 x 4 (or 4 x
// 8) piece of a 64-row output and reads both operands k-major as 16-byte
// vectors.  Tiles are staged from global memory as 16-byte vectors (8 bf16
// or 4 floats), eight per thread in flight.  It walks its own 64-row
// chunks, whatever chunk the forward used (the gradients do not depend on
// it beyond rounding), in six launches on the caller's stream:
//   1. prep_kernel, per (b, chunk, head): cum and dt of the chunk into a
//      scratch (cd), the chunk's state sum_j exp(seg - cum_j) dt_j x_j B_j^T
//      into hs and sum_i exp(cum_i) g_i C_i^T into gs (float32, (B, nc, nh,
//      P, N) each);
//   2. pair_kernel, per (b, chunk, group of heads): C.B^T of the chunk
//      (group 0) and the group's sum over heads of W, so dB and dC take
//      their intra-chunk parts from one 64 x 64 matrix: eight float32
//      partials of 16 KB per (b, chunk), summed in order by step 5;
//   3. pass_kernel, elementwise over (b, head, P*N / 4): in place, hs becomes
//      the state entering each chunk (and hlast the final state) and gs
//      the gradient of the state leaving it, serial over the chunks, each
//      thread's loads eight chunks ahead of its stores;
//   4. dx_kernel, per (b, chunk, head): y and v by four 64-row products,
//      dx, then cum's gradient, its reverse running sum, ddt and the
//      chunk's share of dA (one partial per (b, chunk, head));
//   5. dbc_kernel, per (b, chunk, 64 columns of N), a cluster of 8 blocks
//      that split the heads: dB and dC, the intra-chunk parts from the
//      summed W, the state parts as one product over (head, P) per block;
//      the 8 partial tiles are added in block order through distributed
//      shared memory;
//   6. da_kernel: dA as the sum of its partials over (b, chunk) in order.
// Nothing is summed with atomics, so two calls give the same bits, and no
// per-head partial of dB or dC is materialised.  The states are recomputed
// rather than kept from the forward, at the price of their traffic: hs and
// gs are 134 MB each at the training shape and cross memory ~5 times each
// (~1.3 GB, ~0.4 ms at 3.35 TB/s), ten times the function's own bytes --
// the first thing a tensor-core redesign with longer chunks would cut.
// P and N are multiples of 16, P <= 64, N <= 128 (the wrapper checks), and
// x, dy, B, C and dh start on 16-byte boundaries (the wrapper copies a view
// that does not); rows past S load as zero with dt = 0, so any S works.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {
namespace ssd_bwd {

constexpr int kL = 64;  // rows of a chunk
constexpr int kThreads = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLd = kL + 4;  // row of a transposed tile: 16-byte aligned, 4-way bank conflicts
constexpr int kGroups = 8;   // head groups of pair_kernel's W partials

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Thread t of a 256-thread block owns rows 4 (t / 16) .. + 3 and columns
// 4 (t % 16) + 64 q .. + 3 (q < NQ) of a 64 x 64 NQ output tile, and adds
// sum_{k < K} a[k][row] b[k][col] into acc: both operands k-major in shared
// memory, with rows of lda and ldb floats (multiples of 4).
template <int NQ>
__device__ __forceinline__ void tile_fma(float (&acc)[4][4 * NQ], const float* a, int lda,
                                         const float* b, int ldb, int K) {
  const int r0 = 4 * (threadIdx.x >> 4);
  const int c0 = 4 * (threadIdx.x & 15);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * lda + r0);
    const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 bv = *reinterpret_cast<const float4*>(b + k * ldb + c0 + 64 * q);
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][4 * q + c] = fmaf(ar[r], br[c], acc[r][4 * q + c]);
    }
  }
}

template <int C>
__device__ __forceinline__ void zero(float (&acc)[4][C]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
}

// 16 bytes of src as float32: 4 floats, or 8 bf16 widened exactly (a
// bf16's bits are a float32's high half).
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stage rows [0, rows) x columns [0, cols_pad) of src (row r at src + r *
// stride) into dst as float32, times scale[r] when scale is given: element
// (r, c) at dst[r * ld + c], or at dst[c * ld + r] when kTrans.  Rows at or
// past `valid` and columns at or past `cols` are zero.  Each thread reads
// 16-byte vectors (cols, cols_pad and stride multiples of a vector, src
// 16-byte aligned) and issues kStageBatch of them before it stores any, so
// they are in flight together.  A transposed tile is walked rows first, so
// a warp's scalar stores fall on 32 banks; a row-major one columns first,
// stored as float4s.
constexpr int kStageBatch = 8;

template <bool kTrans, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int64_t stride, int rows,
                                      int valid, int cols, int cols_pad, const float* scale) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = cols_pad / V;
  const int total = rows * vpr;
  for (int base = threadIdx.x; base < total; base += kStageBatch * blockDim.x) {
    float v[kStageBatch][V];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = base + u * blockDim.x;
      const int r = kTrans ? e % rows : e / vpr;
      const int c = V * (kTrans ? e / rows : e % vpr);
      if (e < total && r < valid && c < cols) {
        load16(src + r * stride + c, v[u]);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) v[u][q] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = base + u * blockDim.x;
      if (e < total) {
        const int r = kTrans ? e % rows : e / vpr;
        const int c = V * (kTrans ? e / rows : e % vpr);
        const float s = scale == nullptr ? 1.f : scale[r];
        if (kTrans) {
#pragma unroll
          for (int q = 0; q < V; ++q) dst[(c + q) * ld + r] = v[u][q] * s;
        } else {
#pragma unroll
          for (int q = 0; q < V; q += 4) {
            *reinterpret_cast<float4*>(dst + r * ld + c + q) =
                make_float4(v[u][q] * s, v[u][q + 1] * s, v[u][q + 2] * s, v[u][q + 3] * s);
          }
        }
      }
    }
  }
}

// Sum of v over the 16 threads that share a row group (half a warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- 1. per (b, chunk, head): cum and dt, the chunk state and the
// carried gradient's input
template <typename T>
__global__ void __launch_bounds__(kThreads)
    prep_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ dy, float* __restrict__ cd,
                float* __restrict__ hs, float* __restrict__ gs, int S, int nh, int P, int N,
                int nc) {
  extern __shared__ __align__(16) float smem[];
  float* u_s = smem;                  // [kL][kMaxP] x_j, times dt_j exp(seg - cum_j)
  float* w_s = u_s + kL * kMaxP;      // [kL][kMaxP] g_i, times exp(cum_i)
  float* b_s = w_s + kL * kMaxP;      // [kL][kMaxN]
  float* c_s = b_s + kL * kMaxN;      // [kL][kMaxN]
  float* dt_s = c_s + kL * kMaxN;     // [kL]
  float* cum_s = dt_s + kL;           // [kL]
  float* fu_s = cum_s + kL;           // [kL]
  float* fw_s = fu_s + kL;            // [kL]
  const int head = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = c * kL;
  const int valid = min(kL, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * nh + head;
  const int t = threadIdx.x;
  if (t < kL) dt_s[t] = t < valid ? dt[(row0 + t) * nh + head] : 0.f;
  __syncthreads();
  if (t == 0) {
    const float a = A[head];
    float run = 0.f;
    for (int j = 0; j < kL; ++j) {
      run += dt_s[j] * a;
      cum_s[j] = run;
    }
  }
  __syncthreads();
  const float seg = cum_s[kL - 1];
  if (t < kL) {
    cd[bch * 2 * kL + t] = cum_s[t];
    cd[bch * 2 * kL + kL + t] = dt_s[t];
    fu_s[t] = dt_s[t] * expf(seg - cum_s[t]);
    fw_s[t] = expf(cum_s[t]);
  }
  __syncthreads();
  stage<false>(u_s, kMaxP, x + (row0 * nh + head) * P, static_cast<int64_t>(nh) * P, kL, valid, P,
               kMaxP, fu_s);
  stage<false>(w_s, kMaxP, dy + (row0 * nh + head) * P, static_cast<int64_t>(nh) * P, kL, valid, P,
               kMaxP, fw_s);
  stage<false>(b_s, kMaxN, Bm + row0 * N, N, kL, valid, N, kMaxN, nullptr);
  stage<false>(c_s, kMaxN, Cm + row0 * N, N, kL, valid, N, kMaxN, nullptr);
  __syncthreads();
  const int r0 = 4 * (t >> 4);
  const int c0 = 4 * (t & 15);
  float acc[4][8];
  for (int which = 0; which < 2; ++which) {
    zero(acc);
    tile_fma<2>(acc, which == 0 ? u_s : w_s, kMaxP, which == 0 ? b_s : c_s, kMaxN, kL);
    float* dst = (which == 0 ? hs : gs) + bch * P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (r0 + r >= P) break;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = c0 + 64 * q;
        if (n < N) {
          *reinterpret_cast<float4*>(dst + (r0 + r) * N + n) =
              make_float4(acc[r][4 * q], acc[r][4 * q + 1], acc[r][4 * q + 2], acc[r][4 * q + 3]);
        }
      }
    }
  }
}

// ---- 2. per (b, chunk, group of heads): C.B^T (group 0) and the group's
// sum over its heads of W_ij = exp(cum_i - cum_j) dt_j (g_i . x_j), j <= i
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pair_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                const T* __restrict__ dy, const float* __restrict__ cd, float* __restrict__ cb,
                float* __restrict__ wpart, int S, int nh, int P, int N, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* ct_s = smem;                 // [kMaxN][kLd] C^T
  float* bt_s = ct_s + kMaxN * kLd;   // [kMaxN][kLd] B^T
  float* gt_s = bt_s + kMaxN * kLd;   // [kMaxP][kLd] g^T of a head
  float* xt_s = gt_s + kMaxP * kLd;   // [kMaxP][kLd] x^T of a head
  float* cum_s = xt_s + kMaxP * kLd;  // [kL]
  float* dt_s = cum_s + kL;           // [kL]
  const int grp = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = c * kL;
  const int valid = min(kL, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const int r0 = 4 * (threadIdx.x >> 4);
  const int c0 = 4 * (threadIdx.x & 15);
  if (grp == 0) {
    stage<true>(ct_s, kLd, Cm + row0 * N, N, kL, valid, N, kMaxN, nullptr);
    stage<true>(bt_s, kLd, Bm + row0 * N, N, kL, valid, N, kMaxN, nullptr);
    __syncthreads();
    float acc[4][4];
    zero(acc);
    tile_fma<1>(acc, ct_s, kLd, bt_s, kLd, N);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(cb + (bc * kL + r0 + r) * kL + c0) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  float wacc[4][4];
  zero(wacc);
  const int per = (nh + kGroups - 1) / kGroups;
  const int h_end = min(nh, (grp + 1) * per);
  for (int head = grp * per; head < h_end; ++head) {
    __syncthreads();  // the previous head's tiles are consumed
    const int64_t bch = bc * nh + head;
    stage<true>(gt_s, kLd, dy + (row0 * nh + head) * P, static_cast<int64_t>(nh) * P, kL, valid,
                P, kMaxP, nullptr);
    stage<true>(xt_s, kLd, x + (row0 * nh + head) * P, static_cast<int64_t>(nh) * P, kL, valid,
                P, kMaxP, nullptr);
    if (threadIdx.x < kL) {
      cum_s[threadIdx.x] = cd[bch * 2 * kL + threadIdx.x];
      dt_s[threadIdx.x] = cd[bch * 2 * kL + kL + threadIdx.x];
    }
    __syncthreads();
    float gx[4][4];
    zero(gx);
    tile_fma<1>(gx, gt_s, kLd, xt_s, kLd, P);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r0 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = c0 + q;
        if (j <= i) wacc[r][q] += gx[r][q] * expf(cum_s[i] - cum_s[j]) * dt_s[j];
      }
    }
  }
  float* dst = wpart + (bc * kGroups + grp) * kL * kL;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    *reinterpret_cast<float4*>(dst + (r0 + r) * kL + c0) =
        make_float4(wacc[r][0], wacc[r][1], wacc[r][2], wacc[r][3]);
  }
}

// ---- 3. elementwise over (b, head, P*N / 4): in place, hs holds the state
// entering each chunk and gs the gradient of the state leaving it.  Loads
// run kPassAhead chunks ahead of the stores: a batch's loads are issued
// before the previous batch is stored (other chunks, so other addresses).
constexpr int kPassAhead = 8;

__device__ __forceinline__ float4 fma4(float4 h, float d, float4 s) {
  return make_float4(h.x * d + s.x, h.y * d + s.y, h.z * d + s.z, h.w * d + s.w);
}

// Over the n chunks at at0, at0 + step, ... (units of (b, chunk, head)),
// each chunk's value v is replaced in buf by the running r before it, and r
// becomes r exp(seg) + v; returns r after the last chunk.
__device__ __forceinline__ float4 pass_walk(float* __restrict__ buf, const float* __restrict__ cd,
                                            int64_t at0, int64_t step, int n, int PN, int e,
                                            float4 r) {
  float4 va[kPassAhead], vb[kPassAhead];
  float da[kPassAhead], db[kPassAhead];
  auto load = [&](int c0, float4(&v)[kPassAhead], float(&d)[kPassAhead]) {
#pragma unroll
    for (int q = 0; q < kPassAhead; ++q) {
      if (c0 + q < n) {
        const int64_t at = at0 + (c0 + q) * step;
        v[q] = *reinterpret_cast<const float4*>(buf + at * PN + e);
        d[q] = expf(cd[at * 2 * kL + kL - 1]);
      }
    }
  };
  auto store = [&](int c0, const float4(&v)[kPassAhead], const float(&d)[kPassAhead]) {
#pragma unroll
    for (int q = 0; q < kPassAhead; ++q) {
      if (c0 + q < n) {
        *reinterpret_cast<float4*>(buf + (at0 + (c0 + q) * step) * PN + e) = r;
        r = fma4(r, d[q], v[q]);
      }
    }
  };
  load(0, va, da);
  for (int c0 = 0; c0 < n; c0 += 2 * kPassAhead) {
    if (c0 + kPassAhead < n) load(c0 + kPassAhead, vb, db);
    store(c0, va, da);
    if (c0 + kPassAhead >= n) break;
    if (c0 + 2 * kPassAhead < n) load(c0 + 2 * kPassAhead, va, da);
    store(c0 + kPassAhead, vb, db);
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
    pass_kernel(const float* __restrict__ cd, const float* __restrict__ dh, float* __restrict__ hs,
                float* __restrict__ gs, float* __restrict__ hlast, int nh, int PN, int nc) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= PN) return;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t first = static_cast<int64_t>(b) * nc * nh + head;  // (b, chunk 0, head)
  const int64_t last = (static_cast<int64_t>(b) * nh + head) * PN + e;
  *reinterpret_cast<float4*>(hlast + last) =
      pass_walk(hs, cd, first, nh, nc, PN, e, make_float4(0.f, 0.f, 0.f, 0.f));
  const float4 g = dh == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                                 : *reinterpret_cast<const float4*>(dh + last);
  pass_walk(gs, cd, first + static_cast<int64_t>(nc - 1) * nh, -static_cast<int64_t>(nh), nc, PN,
            e, g);
}

// ---- 4. per (b, chunk, head): dx, ddt and the chunk's share of dA
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dx_kernel(const T* __restrict__ x, const float* __restrict__ A, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const T* __restrict__ dy, const float* __restrict__ cd,
              const float* __restrict__ cb, const float* __restrict__ hs,
              const float* __restrict__ gs, const float* __restrict__ hlast, T* __restrict__ dx,
              float* __restrict__ ddt, float* __restrict__ dap, int S, int nh, int P, int N,
              int nc) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                   // [kL][kMaxP] x_j
  float* g_s = x_s + kL * kMaxP;       // [kL][kMaxP] g_i
  float* ct_s = g_s + kL * kMaxP;      // [kMaxN][kLd] C^T
  float* bt_s = ct_s + kMaxN * kLd;    // [kMaxN][kLd] B^T
  float* ht_s = bt_s + kMaxN * kLd;    // [kMaxN][kLd] H^T, the state entering
  float* gg_s = ht_s + kMaxN * kLd;    // [kMaxN][kLd] G^T, the gradient leaving
  float* m_s = gg_s + kMaxN * kLd;     // [kL][kL] M_ij at [i][j]
  float* mt_s = m_s + kL * kL;         // [kL][kLd] M_ij dt_j at [j][i]
  float* cum_s = mt_s + kL * kLd;      // [kL]
  float* dt_s = cum_s + kL;            // [kL]
  float* gy_s = dt_s + kL;             // [kL] g_k . y_k
  float* xv_s = gy_s + kL;             // [kL] x_k . v_k
  float* red_s = xv_s + kL;            // [kThreads / 32]
  const int head = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = c * kL;
  const int valid = min(kL, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const int64_t bch = bc * nh + head;
  const int PN = P * N;
  const int t = threadIdx.x;
  if (t < kL) {
    cum_s[t] = cd[bch * 2 * kL + t];
    dt_s[t] = cd[bch * 2 * kL + kL + t];
  }
  const int64_t ld_x = static_cast<int64_t>(nh) * P;
  stage<false>(x_s, kMaxP, x + (row0 * nh + head) * P, ld_x, kL, valid, P, kMaxP, nullptr);
  stage<false>(g_s, kMaxP, dy + (row0 * nh + head) * P, ld_x, kL, valid, P, kMaxP, nullptr);
  stage<true>(ct_s, kLd, Cm + row0 * N, N, kL, valid, N, kMaxN, nullptr);
  stage<true>(bt_s, kLd, Bm + row0 * N, N, kL, valid, N, kMaxN, nullptr);
  stage<true>(ht_s, kLd, hs + bch * PN, N, kMaxP, P, N, kMaxN, nullptr);
  stage<true>(gg_s, kLd, gs + bch * PN, N, kMaxP, P, N, kMaxN, nullptr);
  __syncthreads();
  for (int e = t; e < kL * kL; e += kThreads) {
    const int i = e / kL;
    const int j = e - i * kL;
    const float m = j <= i ? cb[bc * kL * kL + e] * expf(cum_s[i] - cum_s[j]) : 0.f;
    m_s[e] = m;
    mt_s[j * kLd + i] = m * dt_s[j];
  }
  __syncthreads();
  const int r0 = 4 * (t >> 4);
  const int c0 = 4 * (t & 15);
  const float seg = cum_s[kL - 1];
  float a1[4][4], a2[4][4];
  // y_i = sum_j M_ij dt_j x_j + exp(cum_i) H C_i, then g_i . y_i
  zero(a1);
  zero(a2);
  tile_fma<1>(a1, mt_s, kLd, x_s, kMaxP, kL);
  tile_fma<1>(a2, ct_s, kLd, ht_s, kLd, N);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = r0 + r;
    const float ec = expf(cum_s[i]);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) s += g_s[i * kMaxP + c0 + q] * (a1[r][q] + ec * a2[r][q]);
    s = row_sum(s);
    if (c0 == 0) gy_s[i] = s;
  }
  // v_j = sum_i M_ij g_i + exp(seg - cum_j) G B_j; dx_j = dt_j v_j, then x_j . v_j
  zero(a1);
  zero(a2);
  tile_fma<1>(a1, m_s, kL, g_s, kMaxP, kL);
  tile_fma<1>(a2, bt_s, kLd, gg_s, kLd, N);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = r0 + r;
    const float f = expf(seg - cum_s[j]);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = a1[r][q] + f * a2[r][q];
      s += x_s[j * kMaxP + c0 + q] * v;
      if (j < valid && c0 + q < P) {
        dx[((row0 + j) * nh + head) * P + c0 + q] = from_float<T>(dt_s[j] * v);
      }
    }
    s = row_sum(s);
    if (c0 == 0) xv_s[j] = s;
  }
  // <G, state leaving the chunk>, summed in a fixed order
  const float* hnext = c + 1 < nc ? hs + (bch + nh) * PN
                                  : hlast + (static_cast<int64_t>(b) * nh + head) * PN;
  float dot = 0.f;
#pragma unroll 8
  for (int e = t; e < PN; e += kThreads) {
    const int p = e / N;
    dot += gg_s[(e - p * N) * kLd + p] * hnext[e];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  if ((t & 31) == 0) red_s[t >> 5] = dot;
  __syncthreads();
  if (t == 0) {
    float gdot = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) gdot += red_s[w];
    const float a = A[head];
    float r = 0.f, da = 0.f;
    for (int k = kL - 1; k >= 0; --k) {
      r += gy_s[k] - dt_s[k] * xv_s[k] + (k == kL - 1 ? gdot : 0.f);
      if (k < valid) ddt[(row0 + k) * nh + head] = xv_s[k] + a * r;
      da += dt_s[k] * r;
    }
    dap[bch] = da;
  }
}

// ---- 5. per (b, chunk, 64 columns of N), a cluster of kCluster blocks
// that split the heads: dB and dC.  Block 0 of the cluster also takes the
// intra-chunk parts from the summed W; each block sums its heads' state
// parts; then block q adds rows 8 q .. 8 q + 7 of the kCluster partial tiles,
// read from the blocks' shared memory in block order, and stores them.
constexpr int kCluster = 8;

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    dbc_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
               const T* __restrict__ dy, const float* __restrict__ cd,
               const float* __restrict__ wpart, const float* __restrict__ hs,
               const float* __restrict__ gs, T* __restrict__ dB, T* __restrict__ dC, int S, int nh,
               int P, int N, int nc) {
  extern __shared__ __align__(16) float smem[];
  // the intra-chunk parts (block 0)
  float* w_s = smem;                   // [kL][kL] W_ij at [i][j]
  float* wt_s = w_s + kL * kL;         // [kL][kLd] W_ij at [j][i]
  float* bn_s = wt_s + kL * kLd;       // [kL][64] B_j, the block's columns
  float* cn_s = bn_s + kL * 64;        // [kL][64] C_i
  // a head's state parts, in the same memory
  float* eg_s = smem;                  // [kMaxP][kLd] exp(cum_i) g_i at [p][i]
  float* ex_s = eg_s + kMaxP * kLd;    // [kMaxP][kLd] exp(seg - cum_j) dt_j x_j at [p][j]
  float* hn_s = ex_s + kMaxP * kLd;    // [kMaxP][64] H, the block's columns
  float* gn_s = hn_s + kMaxP * 64;     // [kMaxP][64] G
  // the block's partial dC and dB tiles, in the same memory
  float* part_s = smem;                // [2][kL][64]
  float* fi_s = gn_s + kMaxP * 64;     // [kL]
  float* fj_s = fi_s + kL;             // [kL]
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / kCluster) * 64;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int nw = min(64, N - n0);
  const int s0 = c * kL;
  const int valid = min(kL, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const int PN = P * N;
  const int t = threadIdx.x;
  float acc_c[4][4], acc_b[4][4];
  zero(acc_c);
  zero(acc_b);
  if (rank == 0) {
    for (int e = t; e < kL * kL; e += kThreads) {
      const int i = e / kL;
      const int j = e - i * kL;
      float w = 0.f;
      for (int g = 0; g < kGroups; ++g) w += wpart[(bc * kGroups + g) * kL * kL + e];
      w_s[e] = w;
      wt_s[j * kLd + i] = w;
    }
    stage<false>(bn_s, 64, Bm + row0 * N + n0, N, kL, valid, nw, 64, nullptr);
    stage<false>(cn_s, 64, Cm + row0 * N + n0, N, kL, valid, nw, 64, nullptr);
    __syncthreads();
    tile_fma<1>(acc_c, wt_s, kLd, bn_s, 64, kL);  // sum_j W_ij B_j
    tile_fma<1>(acc_b, w_s, kL, cn_s, 64, kL);    // sum_i W_ij C_i
  }
  const int64_t ld_x = static_cast<int64_t>(nh) * P;
  const int per = (nh + kCluster - 1) / kCluster;
  const int h_end = min(nh, (rank + 1) * per);
  for (int head = rank * per; head < h_end; ++head) {
    const int64_t bch = bc * nh + head;
    __syncthreads();  // the previous head's tiles (or block 0's W tiles) are consumed
    if (t < kL) {
      const float cum = cd[bch * 2 * kL + t];
      const float seg = cd[bch * 2 * kL + kL - 1];
      fi_s[t] = expf(cum);
      fj_s[t] = expf(seg - cum) * cd[bch * 2 * kL + kL + t];
    }
    __syncthreads();
    stage<true>(eg_s, kLd, dy + (row0 * nh + head) * P, ld_x, kL, valid, P, kMaxP, fi_s);
    stage<true>(ex_s, kLd, x + (row0 * nh + head) * P, ld_x, kL, valid, P, kMaxP, fj_s);
    stage<false>(hn_s, 64, hs + bch * PN + n0, N, kMaxP, P, nw, 64, nullptr);
    stage<false>(gn_s, 64, gs + bch * PN + n0, N, kMaxP, P, nw, 64, nullptr);
    __syncthreads();
    tile_fma<1>(acc_c, eg_s, kLd, hn_s, 64, P);  // exp(cum_i) H^T g_i
    tile_fma<1>(acc_b, ex_s, kLd, gn_s, 64, P);  // exp(seg - cum_j) dt_j G^T x_j
  }
  const int r0 = 4 * (t >> 4);
  const int c0 = 4 * (t & 15);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    *reinterpret_cast<float4*>(part_s + (r0 + r) * 64 + c0) =
        make_float4(acc_c[r][0], acc_c[r][1], acc_c[r][2], acc_c[r][3]);
    *reinterpret_cast<float4*>(part_s + kL * 64 + (r0 + r) * 64 + c0) =
        make_float4(acc_b[r][0], acc_b[r][1], acc_b[r][2], acc_b[r][3]);
  }
  cluster.sync();  // every block's partial tiles are written
  constexpr int kRows = kL / kCluster;
  for (int e = t; e < 2 * kRows * 64; e += kThreads) {
    const int which = e / (kRows * 64);  // 0: dC, 1: dB
    const int i = rank * kRows + (e / 64) % kRows;
    const int col = e % 64;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      sum += cluster.map_shared_rank(part_s, q)[which * kL * 64 + i * 64 + col];
    }
    if (i < valid && col < nw) (which ? dB : dC)[(row0 + i) * N + n0 + col] = from_float<T>(sum);
  }
  cluster.sync();  // no block leaves while another reads its tiles
}

// ---- 6. dA[h] = sum over (b, chunk) of the partials, in order
__global__ void da_kernel(const float* __restrict__ dap, float* __restrict__ dA, int B, int nc,
                          int nh) {
  for (int h = blockIdx.x * blockDim.x + threadIdx.x; h < nh; h += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int bc = 0; bc < B * nc; ++bc) s += dap[static_cast<int64_t>(bc) * nh + h];
    dA[h] = s;
  }
}

constexpr size_t kPrepSmem = (2 * kL * kMaxP + 2 * kL * kMaxN + 4 * kL) * sizeof(float);
constexpr size_t kPairSmem = ((2 * kMaxN + 2 * kMaxP) * kLd + 2 * kL) * sizeof(float);
constexpr size_t kDxSmem =
    (2 * kL * kMaxP + 4 * kMaxN * kLd + kL * kL + kL * kLd + 4 * kL + kThreads / 32) *
    sizeof(float);
constexpr int kDbcW = kL * kL + kL * kLd + 2 * kL * 64;        // block 0's W tiles
constexpr int kDbcHead = 2 * kMaxP * kLd + 2 * kMaxP * 64;     // a head's tiles
constexpr size_t kDbcSmem = (kDbcHead + 2 * kL) * sizeof(float);
static_assert(kDbcW <= kDbcHead && 2 * kL * 64 <= kDbcHead, "fi_s must follow every tile");
static_assert(kDxSmem <= 232448, "dx_kernel's shared memory exceeds an H100 block's");

// The scratch of one call, carved from one buffer (256-byte aligned parts),
// all float32: cum and dt per (b, chunk, head) (B, nc, nh, 2, kL), C.B^T
// (B, nc, kL, kL), W's group partials (B, nc, kGroups, kL, kL), hs and gs
// (B, nc, nh, P, N) each, the final state (B, nh, P, N), dA's partials
// (B, nc, nh).
struct Scratch {
  float *cd, *cb, *wpart, *hs, *gs, *hlast, *dap;
};

inline size_t scratch_layout(int B, int S, int nh, int P, int N, char* base, Scratch* out) {
  const size_t nc = (S + kL - 1) / kL;
  const size_t bc = static_cast<size_t>(B) * nc;
  size_t off = 0;
  auto take = [&](size_t floats) {
    float* p = base == nullptr ? nullptr : reinterpret_cast<float*>(base + off);
    off += (floats * sizeof(float) + 255) & ~static_cast<size_t>(255);
    return p;
  };
  Scratch s;
  s.cd = take(bc * nh * 2 * kL);
  s.cb = take(bc * kL * kL);
  s.wpart = take(bc * kGroups * kL * kL);
  s.hs = take(bc * nh * P * N);
  s.gs = take(bc * nh * P * N);
  s.hlast = take(static_cast<size_t>(B) * nh * P * N);
  s.dap = take(bc * nh);
  if (out != nullptr) *out = s;
  return off;
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const void* dy, const float* dh, void* dx, float* ddt, float* dA, void* dB, void* dC,
           void* scratch, int B, int S, int nh, int P, int N, cudaStream_t stream) {
  const int nc = (S + kL - 1) / kL;
  Scratch sc;
  scratch_layout(B, S, nh, P, N, static_cast<char*>(scratch), &sc);
  const auto* xt = static_cast<const T*>(x);
  const auto* bt = static_cast<const T*>(Bm);
  const auto* ct = static_cast<const T*>(Cm);
  const auto* gt = static_cast<const T*>(dy);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(prep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kPrepSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kPairSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kDxSmem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dbc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kDbcSmem))) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int PN = P * N;
  prep_kernel<T><<<dim3(nh, nc, B), kThreads, kPrepSmem, stream>>>(
      xt, dt, A, bt, ct, gt, sc.cd, sc.hs, sc.gs, S, nh, P, N, nc);
  pair_kernel<T><<<dim3(kGroups, nc, B), kThreads, kPairSmem, stream>>>(
      xt, bt, ct, gt, sc.cd, sc.cb, sc.wpart, S, nh, P, N, nc);
  pass_kernel<<<dim3((PN / 4 + kThreads - 1) / kThreads, nh, B), kThreads, 0, stream>>>(
      sc.cd, dh, sc.hs, sc.gs, sc.hlast, nh, PN, nc);
  dx_kernel<T><<<dim3(nh, nc, B), kThreads, kDxSmem, stream>>>(
      xt, A, bt, ct, gt, sc.cd, sc.cb, sc.hs, sc.gs, sc.hlast, static_cast<T*>(dx), ddt, sc.dap,
      S, nh, P, N, nc);
  dbc_kernel<T><<<dim3(kCluster * ((N + 63) / 64), nc, B), kThreads, kDbcSmem, stream>>>(
      xt, bt, ct, gt, sc.cd, sc.wpart, sc.hs, sc.gs, static_cast<T*>(dB), static_cast<T*>(dC), S,
      nh, P, N, nc);
  da_kernel<<<(nh + kThreads - 1) / kThreads, kThreads, 0, stream>>>(sc.dap, dA, B, nc, nh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd_bwd
}  // namespace repro_torch

// Bytes of device scratch one call needs.
extern "C" long long repro_torch_ssd_scan_bwd_scratch(int batch, int seq, int heads, int P,
                                                      int N) {
  return static_cast<long long>(
      repro_torch::ssd_bwd::scratch_layout(batch, seq, heads, P, N, nullptr, nullptr));
}

// K5's arguments (x (B, S, nh, P) and Bm/Cm (B, S, N) float32 (is_bf16 =
// 0) or bfloat16 (is_bf16 = 1); dt (B, S, nh) and A (nh,) float32), dy in
// x's layout and type, dh (B, nh, P, N) float32 or null for 0; outputs dx,
// ddt, dA, dB, dC in the inputs' layouts and types; all contiguous (the
// wrapper checks); repro_torch_ssd_scan_bwd_scratch(...) bytes of device
// scratch (256-byte aligned).  P and N multiples of 16, P <= 64, N <= 128.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_torch_ssd_scan_bwd(const void* x, const float* dt, const float* A,
                                        const void* Bm, const void* Cm, const void* dy,
                                        const float* dh, void* dx, float* ddt, float* dA,
                                        void* dB, void* dC, void* scratch, int batch, int seq,
                                        int heads, int P, int N, int is_bf16, void* stream) {
  using namespace repro_torch::ssd_bwd;
  if (heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || seq == 0) {  // no rows: dA is 0
    da_kernel<<<(heads + kThreads - 1) / kThreads, kThreads, 0, s>>>(nullptr, dA, 0, 0, heads);
    return static_cast<int>(cudaGetLastError());
  }
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, dy, dh, dx, ddt, dA, dB, dC, scratch, batch,
                                 seq, heads, P, N, s);
  }
  return launch<float>(x, dt, A, Bm, Cm, dy, dh, dx, ddt, dA, dB, dC, scratch, batch, seq, heads,
                       P, N, s);
}
