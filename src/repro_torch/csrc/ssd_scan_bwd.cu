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
// bfloat16 inputs (the models' type, the main path) take the tensor-core
// design (namespace tc) over the forward's chunks of L rows (L a multiple
// of 64, at most 256: 256 for mamba2-1.3b, so 4 chunks of 1024 rows and
// chunk states of 33.5 MB each), in six launches on the caller's stream:
//   1. prep_tc_kernel, per (b, chunk, head, kind): cum and dt into cd, and
//      one chunk state over 64-row slabs, as K5's forward state_kernel:
//      sum_j exp(seg - cum_j) dt_j x_j B_j^T into hs or sum_i exp(cum_i)
//      g_i C_i^T into gs (float32);
//   2. pair_tc_kernel, per (b, chunk, 64 x 64 tile on or below the
//      diagonal), a cluster of 8 blocks over the heads: the tile of C.B^T
//      and of W summed over the heads, so dB and dC take their intra-chunk
//      parts from one (L, L) matrix per (b, chunk);
//   3. pass_tc_kernel, elementwise over (b, head, P*N / 4): H, the state
//      entering each chunk, and G, the gradient of the state leaving it,
//      written as hi + lo bf16 (their operand form: no consumer splits
//      them again), and <G, state leaving the chunk> in warp partials;
//   4. dx_tc_kernel, per (b, chunk, head, 64-row tile) in two kinds of
//      block: y_i (for g_i . y_i) and v_j (for dx_j and x_j . v_j), each the
//      state product scaled by its row factor plus the intra-chunk product
//      over the 64-key slabs on the kept side of the diagonal, M taken from
//      C.B^T and the masked exponentials, one double-buffered stage list;
//   5. finish_tc_kernel, one warp per (b, chunk, head): cum's gradient, its
//      reverse running sum over the chunk, ddt and the chunk's share of dA;
//   6. dbc_tc_kernel, per (b, chunk, 64-row tile, 64 columns of N, dB or
//      dC), a cluster of 8 blocks that share the intra-chunk part's slabs
//      (from the summed W) and the heads' state parts; the 8 partial tiles
//      added in block order through distributed shared memory; its first
//      block also sums dA's partials in order.
// Every product runs as mma.sync m16n8k16 bf16 with float32 accumulators
// from ldmatrix fragments; x, dy, B and C are bf16 and exact as operands,
// and every operand that carries a float32 factor (M, M dt, W, the chunk
// states' u and exp(cum) g, H and G) goes in as hi + lo bf16 parts, two
// products (~2^-17 relative): one bf16 rounding would miss the card check
// (tests/test_torch_ssd_scan_grad.py emulates both).  Row factors that
// depend only on the output row (exp(cum_i), exp(seg - cum_j) dt_j) scale
// the float32 accumulators instead.  Tiles are staged as bf16 by cp.async,
// double-buffered; steps 4 and 6 take 56 and 54 KB of shared memory at P =
// 64, so four blocks fit on an SM.  Exponentials are taken as exp(cum_i - cum_j) for
// kept pairs only (exponent <= 0), never as a product of exp(cum_i) and
// exp(-cum_j), which overflows over 256 rows.
//
// float32 inputs (off the main path) keep the first design: every product as float32 FMAs on the CUDA cores (~32 GFLOP
// executed; 0.48 ms at the 67 TFLOP/s float32 peak) from float32 tiles in
// shared memory: each thread of a 256-thread block owns a 4 x 4 (or 4 x
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
// The C entry repro_torch_ssd_scan_bwd runs the first design for both
// types (another checkout's wrapper calls it so); the wrapper calls
// repro_torch_ssd_scan_bwd_chunked, which routes by type.
// In both designs nothing is summed with atomics, so two calls give the
// same bits, and no per-head partial of dB or dC is materialised; the
// chunk states are recomputed rather than kept from the forward.  P and N
// are multiples of 16, P <= 64, N <= 128 (the wrapper checks), and x, dy,
// B, C and dh start on 16-byte boundaries (the wrapper copies a view that
// does not); rows past S load as zero with dt = 0, so any S works.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

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


// ------------------------------------------------ bfloat16, tensor cores
namespace tc {

using namespace repro_torch::hopper;

constexpr int kT = 64;              // rows of a tile (a slab of a chunk)
constexpr int kMaxL = 256;          // the longest chunk
constexpr int kPad = 8;             // bf16 pad of a shared row (ldmatrix without bank conflicts)
constexpr int kLdRow = kT + 8;      // float row of a 64 x 64 tile read along its rows
constexpr int kLdCol = kT + 4;      // float row of a 64 x 64 tile read along its columns
constexpr int kBf16Ld = kT + kPad;  // bf16 row of a 64-column tile
constexpr int kGroups = 8;          // head groups: the blocks of a cluster
constexpr float kLog2e = 1.4426950408889634f;

// exp(x) of a masked exponent (x <= 0 wherever the value is kept)
__device__ __forceinline__ float exp_masked(float x) { return exp2f(x * kLog2e); }

template <int C>
__device__ __forceinline__ void zero(float (&acc)[C][4]) {
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// The A fragment of a float32 16 x 16 tile as hi + lo bf16 parts; f(r, k)
// is the element at row r, column k of the tile (lane l holds rows l / 4
// and l / 4 + 8, columns 2 (l % 4), + 1, + 8 and + 9).
template <typename F>
__device__ __forceinline__ void a_split(F f, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = g + 8 * (q & 1);
    const int k = 2 * t4 + 8 * (q >> 1);
    split_bf16x2(f(r, k), f(r, k + 1), hi[q], lo[q]);
  }
}

// The A fragment of rows m0 .. m0 + 15, columns k0 .. k0 + 15 of a bf16
// [m][k] tile in shared memory (rows ld elements apart).
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const __nv_bfloat16* s, int ld, int m0,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, smem_u32(s + (m0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4)));
}

// B fragments of the first nt n8 tiles (nt even) for K rows k0 .. k0 + 15,
// from a bf16 tile in shared memory stored [k][n] (b_krows) or [n][k]
// (b_nrows).
__device__ __forceinline__ void b_krows(uint32_t (&bf)[8][2], const __nv_bfloat16* s, int ld,
                                        int k0, int nt) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (2 * np < nt) {
      ldmatrix_x4_trans(bf[2 * np], bf[2 * np + 1],
                        smem_u32(s + (k0 + (lane & 7) + 8 * (mi & 1)) * ld + 16 * np +
                                 8 * (mi >> 1)));
    }
  }
}

__device__ __forceinline__ void b_nrows(uint32_t (&bf)[8][2], const __nv_bfloat16* s, int ld,
                                        int k0, int nt) {
  const int lane = threadIdx.x & 31;
  const int mi = lane >> 3;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    if (2 * np < nt) {
      ldmatrix_x4(bf[2 * np], bf[2 * np + 1],
                  smem_u32(s + (16 * np + (lane & 7) + 8 * (mi >> 1)) * ld + k0 + 8 * (mi & 1)));
    }
  }
}

// acc[n] += a B_n over the first nt n8 tiles
__device__ __forceinline__ void mma_tiles(float (&acc)[8][4], const uint32_t (&a)[4],
                                          const uint32_t (&bf)[8][2], int nt) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n < nt) mma_bf16_16816(acc[n], a, bf[n][0], bf[n][1]);
  }
}

// ---- 1. per (b, chunk, head, kind): cum and dt of the chunk into cd (kind
// 0), and a chunk state over the chunk's 64-row slabs, which cp.async
// double-buffers, as K5's forward state_kernel: kind 0 sum_j u_j B_j^T
// with u_j = exp(seg - cum_j) dt_j x_j into hs, kind 1 sum_i exp(cum_i) g_i
// C_i^T into gs; the float32 factor rides on the A operand as hi + lo.
// 8 warps, each a 16 x 64 tile of (P, N).
__global__ void __launch_bounds__(256)
    prep_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                   float* __restrict__ cd, float* __restrict__ hs, float* __restrict__ gs, int S,
                   int nh, int P, int N, int L, int nc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* cum_s = reinterpret_cast<float*>(smem_raw);          // [kMaxL]
  float* fac_s = cum_s + kMaxL;                               // [kMaxL] dt, then each row's factor
  float* warp_s = fac_s + kMaxL;                              // [4]
  auto* op_s = reinterpret_cast<__nv_bfloat16*>(warp_s + 4);  // [2][64][P + kPad] x or g
  __nv_bfloat16* rw_s = op_s + 2 * kT * (P + kPad);           // [2][64][N + kPad] B or C
  const int head = blockIdx.x >> 1;
  const bool into = blockIdx.x & 1;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * nh + head;
  const int ldp = P + kPad;
  const int ldn = N + kPad;
  const __nv_bfloat16* op = into ? dy : x;
  const __nv_bfloat16* rw = into ? Cm : Bm;
  auto load_slab = [&](int slab) {
    const int k0 = slab * kT;
    const bool any = k0 < valid;  // a slab wholly past S reads nothing
    cp_async_rows(smem_u32(op_s + (slab & 1) * kT * ldp),
                  any ? op + ((row0 + k0) * nh + head) * P : op, static_cast<int64_t>(nh) * P * 2,
                  kT, P * 2, ldp * 2, valid - k0);
    cp_async_rows(smem_u32(rw_s + (slab & 1) * kT * ldn), any ? rw + (row0 + k0) * N : rw,
                  static_cast<int64_t>(N) * 2, kT, N * 2, ldn * 2, valid - k0);
    cp_async_commit();
  };
  load_slab(0);
  chunk_cumsum(dt + row0 * nh + head, nh, valid, A[head], L, fac_s, cum_s, warp_s);
  const float seg = cum_s[L - 1];
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    if (!into) {
      cd[bch * 2 * L + j] = cum_s[j];
      cd[bch * 2 * L + L + j] = fac_s[j];
    }
    fac_s[j] = into ? expf(cum_s[j]) : fac_s[j] * expf(seg - cum_s[j]);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int mi = lane >> 3;
  // the warp's 16 x 64 output tile of (P, N): at most 8 tiles, one per warp
  const int n_groups = (N + 63) / 64;
  const bool has_tile = warp < (P / 16) * n_groups;
  const int p0 = 16 * (warp / n_groups);
  const int n0 = 64 * (warp % n_groups);
  const int nt = min(8, (N - n0) / 8);
  float acc[8][4];
  zero(acc);
  uint32_t bf[8][2];
  const int n_slabs = L / kT;
  for (int slab = 0; slab < n_slabs; ++slab) {
    if (slab + 1 < n_slabs) {
      load_slab(slab + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (has_tile) {
      const __nv_bfloat16* os = op_s + (slab & 1) * kT * ldp;
      const __nv_bfloat16* rs = rw_s + (slab & 1) * kT * ldn + n0;
      const float* fac = fac_s + slab * kT;
#pragma unroll
      for (int kk = 0; kk < kT; kk += 16) {
        // A = (factor x)^T (p x row) from x[row][p], as hi + lo
        uint32_t xa[4], ah[4], al[4];
        ldmatrix_x4_trans(xa, smem_u32(os + (kk + (lane & 7) + 8 * (mi >> 1)) * ldp + p0 +
                                       8 * (mi & 1)));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = kk + 2 * t4 + 8 * (q >> 1);
          const float x0 = __uint_as_float(xa[q] << 16);  // bf16 -> float32, exact
          const float x1 = __uint_as_float(xa[q] & 0xffff0000u);
          split_bf16x2(x0 * fac[j], x1 * fac[j + 1], ah[q], al[q]);
        }
        b_krows(bf, rs, ldn, kk, nt);
        mma_tiles(acc, ah, bf, nt);
        mma_tiles(acc, al, bf, nt);
      }
    }
    __syncthreads();
  }
  if (!has_tile) return;
  float* dst = (into ? gs : hs) + bch * P * N;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n >= nt) break;
    const int col = n0 + 8 * n + 2 * t4;
    *reinterpret_cast<float2*>(dst + (p0 + g) * N + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(dst + (p0 + g + 8) * N + col) = make_float2(acc[n][2], acc[n][3]);
  }
}

// ---- 2. per (b, chunk, 64 x 64 tile (ti, tj <= ti) of its rows and keys),
// a cluster of kGroups blocks that split the heads: block 0 also writes the
// tile of C.B^T; each block sums its heads' W_ij = exp(cum_i - cum_j) dt_j
// (g_i . x_j), j <= i (g.x^T on the tensor cores, exact bf16 operands, the
// heads' tiles double-buffered); then block q adds rows 8 q .. 8 q + 7 of
// the kGroups partial tiles in block order through distributed shared
// memory.  4 warps, 16 rows each.
__global__ void __cluster_dims__(kGroups, 1, 1) __launch_bounds__(128)
    pair_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                   const float* __restrict__ cd, float* __restrict__ cb,
                   float* __restrict__ wsum, int S, int nh, int P, int N, int L, int nc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  int ti = 0, rest = blockIdx.x / kGroups;
  while (rest > ti) {
    rest -= ti + 1;
    ++ti;
  }
  const int tj = rest;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const int ldp = P + kPad;
  const int ldn = N + kPad;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = 16 * warp;
  const int vi = valid - ti * kT;  // rows of each tile before S
  const int vj = valid - tj * kT;
  uint32_t a[4];
  uint32_t bf[8][2];
  if (rank == 0) {
    auto* c_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][ldn] C rows i
    __nv_bfloat16* b_s = c_s + kT * ldn;                    // [64][ldn] B rows j
    cp_async_rows(smem_u32(c_s), vi > 0 ? Cm + (row0 + ti * kT) * N : Cm,
                  static_cast<int64_t>(N) * 2, kT, N * 2, ldn * 2, vi);
    cp_async_rows(smem_u32(b_s), vj > 0 ? Bm + (row0 + tj * kT) * N : Bm,
                  static_cast<int64_t>(N) * 2, kT, N * 2, ldn * 2, vj);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float acc[8][4];
    zero(acc);
    for (int k0 = 0; k0 < N; k0 += 16) {
      a_rows(a, c_s, ldn, m0, k0);
      b_nrows(bf, b_s, ldn, k0, 8);
      mma_tiles(acc, a, bf, 8);
    }
    float* dst = cb + (bc * L + ti * kT + m0 + g) * L + tj * kT;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t4;
      *reinterpret_cast<float2*>(dst + col) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(dst + 8 * L + col) = make_float2(acc[n][2], acc[n][3]);
    }
    __syncthreads();  // c_s and b_s are consumed before the heads' tiles land there
  }
  // a head's buffer: g rows i and x rows j [64][ldp] each, cum_i, cum_j, dt_j [64] each
  const int buf_bytes = 2 * kT * ldp * 2 + 3 * kT * 4;
  const int64_t ld_x = static_cast<int64_t>(nh) * P;
  auto load_head = [&](int h, int k) {
    uint8_t* p = smem_raw + k * buf_bytes;
    const float* cdh = cd + (bc * nh + h) * 2 * L;
    cp_async_rows(smem_u32(p), vi > 0 ? dy + ((row0 + ti * kT) * nh + h) * P : dy, ld_x * 2, kT,
                  P * 2, ldp * 2, vi);
    cp_async_rows(smem_u32(p + kT * ldp * 2), vj > 0 ? x + ((row0 + tj * kT) * nh + h) * P : x,
                  ld_x * 2, kT, P * 2, ldp * 2, vj);
    const uint32_t f = smem_u32(p + 2 * kT * ldp * 2);
    cp_async_rows(f, cdh + ti * kT, 0, 1, kT * 4, 0, 1);
    cp_async_rows(f + kT * 4, cdh + tj * kT, 0, 1, kT * 4, 0, 1);
    cp_async_rows(f + 2 * kT * 4, cdh + L + tj * kT, 0, 1, kT * 4, 0, 1);
    cp_async_commit();
  };
  const int per = (nh + kGroups - 1) / kGroups;
  const int h0 = rank * per;
  const int h1 = min(nh, h0 + per);
  float wacc[8][4];
  zero(wacc);
  if (h0 < h1) load_head(h0, 0);
  for (int h = h0; h < h1; ++h) {
    const int k = (h - h0) & 1;
    if (h + 1 < h1) {
      load_head(h + 1, k ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const auto* g_s = reinterpret_cast<const __nv_bfloat16*>(smem_raw + k * buf_bytes);
    const __nv_bfloat16* x_s = g_s + kT * ldp;
    const float* cum_i = reinterpret_cast<const float*>(x_s + kT * ldp);
    const float* cum_j = cum_i + kT;
    const float* dt_j = cum_j + kT;
    float gx[8][4];
    zero(gx);
    for (int k0 = 0; k0 < P; k0 += 16) {
      a_rows(a, g_s, ldp, m0, k0);
      b_nrows(bf, x_s, ldp, k0, 8);
      mma_tiles(gx, a, bf, 8);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = m0 + g + 8 * r;
      const float ci = cum_i[i];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * n + 2 * t4 + e;
          const float w = gx[n][2 * r + e] * exp_masked(ci - cum_j[j]) * dt_j[j];
          if (ti != tj || j <= i) wacc[n][2 * r + e] += w;
        }
      }
    }
    __syncthreads();  // buffer k is consumed before it is loaded again
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem_raw);  // [64][kLdCol]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(part + (m0 + g + 8 * r) * kLdCol + 8 * n + 2 * t4) =
          make_float2(wacc[n][2 * r], wacc[n][2 * r + 1]);
    }
  }
  cluster.sync();  // every block's partial tile is written
  constexpr int kRows = kT / kGroups;
  float* dst = wsum + (bc * L + ti * kT) * L + tj * kT;
  for (int e = threadIdx.x; e < kRows * kT; e += blockDim.x) {
    const int i = rank * kRows + e / kT;
    const int j = e % kT;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) s += cluster.map_shared_rank(part, q)[i * kLdCol + j];
    dst[static_cast<int64_t>(i) * L + j] = s;
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// Four floats as hi + lo bf16 parts: hi at dst, lo at dst + PN.
__device__ __forceinline__ void store_split(__nv_bfloat16* dst, int PN, float4 v) {
  uint32_t hi[2], lo[2];
  split_bf16x2(v.x, v.y, hi[0], lo[0]);
  split_bf16x2(v.z, v.w, hi[1], lo[1]);
  *reinterpret_cast<uint2*>(dst) = make_uint2(hi[0], hi[1]);
  *reinterpret_cast<uint2*>(dst + PN) = make_uint2(lo[0], lo[1]);
}

__device__ __forceinline__ float4 load_split(const __nv_bfloat16* src, int PN) {
  const uint2 h = *reinterpret_cast<const uint2*>(src);
  const uint2 l = *reinterpret_cast<const uint2*>(src + PN);
  return make_float4(__uint_as_float(h.x << 16) + __uint_as_float(l.x << 16),
                     __uint_as_float(h.x & 0xffff0000u) + __uint_as_float(l.x & 0xffff0000u),
                     __uint_as_float(h.y << 16) + __uint_as_float(l.y << 16),
                     __uint_as_float(h.y & 0xffff0000u) + __uint_as_float(l.y & 0xffff0000u));
}

// ---- 3. elementwise over (b, head, P*N / 4): the state entering each chunk
// (hp) and the gradient of the state leaving it (gp), as hi + lo bf16, the
// operand form of steps 4 and 6; kAhead chunks' loads in flight.  The
// reverse walk also takes <G, state leaving the chunk> (the state read
// back from hp, or the final one): one partial per warp and chunk.
constexpr int kAhead = 4;

__global__ void __launch_bounds__(256)
    pass_tc_kernel(const float* __restrict__ cd, const float* __restrict__ dh,
                   const float* __restrict__ hs, const float* __restrict__ gs,
                   __nv_bfloat16* __restrict__ hp, __nv_bfloat16* __restrict__ gp,
                   float* __restrict__ gdp, int nh, int PN, int L, int nc) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= PN) return;  // PN / 4 is a multiple of 64: whole warps leave
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t first = static_cast<int64_t>(b) * nc * nh + head;  // (b, chunk 0, head)
  const int nw = PN / 128;
  const int w = e / 128;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float4 v[kAhead];
    float d[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (c0 + q < nc) {
        const int64_t bch = first + static_cast<int64_t>(c0 + q) * nh;
        v[q] = *reinterpret_cast<const float4*>(hs + bch * PN + e);
        d[q] = expf(cd[bch * 2 * L + L - 1]);
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (c0 + q < nc) {
        const int64_t bch = first + static_cast<int64_t>(c0 + q) * nh;
        store_split(hp + bch * 2 * PN + e, PN, h);
        h = make_float4(h.x * d[q] + v[q].x, h.y * d[q] + v[q].y, h.z * d[q] + v[q].z,
                        h.w * d[q] + v[q].w);
      }
    }
  }
  float4 gr = dh == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                            : *reinterpret_cast<const float4*>(
                                  dh + (static_cast<int64_t>(b) * nh + head) * PN + e);
  for (int c0 = nc - 1; c0 >= 0; c0 -= kAhead) {
    float4 v[kAhead], out[kAhead];
    float d[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int c = c0 - q;
      if (c >= 0) {
        const int64_t bch = first + static_cast<int64_t>(c) * nh;
        v[q] = *reinterpret_cast<const float4*>(gs + bch * PN + e);
        d[q] = expf(cd[bch * 2 * L + L - 1]);
        out[q] = c + 1 < nc ? load_split(hp + (bch + nh) * 2 * PN + e, PN) : h;
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int c = c0 - q;
      if (c >= 0) {
        const int64_t bch = first + static_cast<int64_t>(c) * nh;
        store_split(gp + bch * 2 * PN + e, PN, gr);
        float dot = gr.x * out[q].x + gr.y * out[q].y + gr.z * out[q].z + gr.w * out[q].w;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if ((threadIdx.x & 31) == 0) gdp[bch * nw + w] = dot;
        gr = make_float4(gr.x * d[q] + v[q].x, gr.y * d[q] + v[q].y, gr.z * d[q] + v[q].z,
                         gr.w * d[q] + v[q].w);
      }
    }
  }
}

// ---- 4. per (b, chunk, head, 64-row tile), two kinds of block, adjacent in
// the grid: kind y takes y_i = exp(cum_i) H C_i + sum_{j<=i} M_ij dt_j x_j
// and writes g_i . y_i; kind v takes v_j = exp(seg - cum_j) G B_j +
// sum_{i>=j} M_ij g_i and writes dx_j = dt_j v_j and x_j . v_j.  The state
// product comes first (C or B rows against H or G, hi + lo) and is scaled
// by its rows' factor; the intra-chunk product adds to it over the 64-key
// slabs on or below the tile's diagonal (on or above, for v): M from C.B^T
// (read from L2) and the masked exponentials, as hi + lo, against x or g
// rows (exact).  The block walks one list of stages that cp.async
// double-buffers: the state product's 64-column slices of N, then the
// slabs.  kDxRows / 16 warps, 16 rows x P each (a warp past the chunk's
// end only stages).  At P = 64 a stage takes 27 KB, so the block takes 56
// KB of shared memory and four blocks fit on an SM; 128-row tiles (half
// the state tiles' and the slabs' traffic per row, fewer blocks per SM)
// ran slower.
constexpr int kDxRows = 64;
constexpr int kLdColDx = kDxRows + 4;  // float row of a 64 x kDxRows tile read along its columns

// Bytes of one stage of dx_part: the larger of a slice of the state
// product (kDxRows rows of C or B and 2P rows of H or G, 64 bf16 columns
// each) and a slab (M's tile, then 64 rows of x or g).
inline __host__ __device__ int dx_stage_bytes(int P) {
  const int slice = (kDxRows + 2 * P) * kBf16Ld * 2;
  const int slab = kDxRows * kLdRow * 4 + kT * (P + kPad) * 2;
  return slice > slab ? slice : slab;
}

template <bool kV>
__device__ __forceinline__ void dx_part(const __nv_bfloat16* __restrict__ x,
                                        const __nv_bfloat16* __restrict__ Bm,
                                        const __nv_bfloat16* __restrict__ Cm,
                                        const __nv_bfloat16* __restrict__ dy,
                                        const float* __restrict__ cd, const float* __restrict__ cb,
                                        const __nv_bfloat16* __restrict__ hp,
                                        const __nv_bfloat16* __restrict__ gp,
                                        __nv_bfloat16* __restrict__ dx, float* __restrict__ rowt,
                                        int S, int nh, int P, int N, int L, int nc,
                                        uint8_t* smem_raw) {
  const int nb = L / kT;
  const int n_tiles = (L + kDxRows - 1) / kDxRows;
  const int t = (blockIdx.x >> 1) % n_tiles;
  const int head = (blockIdx.x >> 1) / n_tiles;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const int64_t bch = bc * nh + head;
  const int ldp = P + kPad;
  const int r0 = t * kDxRows;             // the tile's first row in the chunk
  const int tr = min(kDxRows, L - r0);    // and its rows
  float* cd_s = reinterpret_cast<float*>(smem_raw);               // [2][kMaxL] cum, dt
  uint8_t* stages = reinterpret_cast<uint8_t*>(cd_s + 2 * kMaxL);  // [2][stage]
  const int stage_bytes = dx_stage_bytes(P);
  const __nv_bfloat16* rows = kV ? Bm : Cm;
  const __nv_bfloat16* state = (kV ? gp : hp) + bch * 2 * P * N;
  const __nv_bfloat16* op = kV ? dy : x;
  // y: the key slabs up to the tile's last row, M's rows r0.. (tr x 64);
  // v: the slabs from the tile's first row, M's columns r0.. (64 x tr)
  const int s_first = kV ? r0 / kT : 0;
  const int s_last = kV ? nb - 1 : (r0 + tr - 1) / kT;
  const int n_slices = (N + 63) / 64;
  const int n_stages = n_slices + s_last - s_first + 1;
  auto load_stage = [&](int q) {
    uint8_t* p = stages + (q & 1) * stage_bytes;
    if (q < n_slices) {  // columns n0.. of the rows (C or B) and the state (H or G, hi then lo)
      const int n0 = 64 * q;
      const int w = min(64, N - n0);
      cp_async_rows(smem_u32(p), r0 < valid ? rows + (row0 + r0) * N + n0 : rows,
                    static_cast<int64_t>(N) * 2, kDxRows, w * 2, kBf16Ld * 2, valid - r0);
      cp_async_rows(smem_u32(p + kDxRows * kBf16Ld * 2), state + n0, static_cast<int64_t>(N) * 2,
                    2 * P, w * 2, kBf16Ld * 2, 2 * P);
    } else {
      const int s = s_first + q - n_slices;
      if (kV) {
        cp_async_rows(smem_u32(p), cb + (bc * L + s * kT) * L + r0, static_cast<int64_t>(L) * 4,
                      kT, tr * 4, kLdColDx * 4, kT);
      } else {
        cp_async_rows(smem_u32(p), cb + (bc * L + r0) * L + s * kT, static_cast<int64_t>(L) * 4,
                      kDxRows, kT * 4, kLdRow * 4, tr);
      }
      const int k0 = s * kT;
      cp_async_rows(smem_u32(p + kDxRows * kLdRow * 4),
                    k0 < valid ? op + ((row0 + k0) * nh + head) * P : op,
                    static_cast<int64_t>(nh) * P * 2, kT, P * 2, ldp * 2, valid - k0);
    }
    cp_async_commit();
  };
  // cum and dt join the first stage's group
  cp_async_rows(smem_u32(cd_s), cd + bch * 2 * L, static_cast<int64_t>(L) * 4, 2, L * 4,
                kMaxL * 4, 2);
  load_stage(0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = 16 * warp;  // the warp's first row in the tile
  const int i0 = r0 + m0;    // ... in the chunk
  const bool active = m0 < tr;
  const int nt = P / 8;
  const float* cum_s = cd_s;
  const float* dt_s = cd_s + kMaxL;
  float acc[8][4];
  zero(acc);
  uint32_t a[4], ah[4], al[4];
  uint32_t bh[8][2], bl[8][2];
  for (int q = 0; q < n_stages; ++q) {
    if (q + 1 < n_stages) {
      load_stage(q + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* p = stages + (q & 1) * stage_bytes;
    if (q < n_slices) {
      const auto* rw_s = reinterpret_cast<const __nv_bfloat16*>(p);
      const __nv_bfloat16* st_s = rw_s + kDxRows * kBf16Ld;
      const int w = min(64, N - 64 * q);
      for (int kk = 0; active && kk < w; kk += 16) {
        a_rows(a, rw_s, kBf16Ld, m0, kk);
        b_nrows(bh, st_s, kBf16Ld, kk, nt);
        b_nrows(bl, st_s + P * kBf16Ld, kBf16Ld, kk, nt);
        mma_tiles(acc, a, bh, nt);
        mma_tiles(acc, a, bl, nt);
      }
      if (q == n_slices - 1) {  // the state product is whole: its rows' factors
        const float seg = cum_s[L - 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float cum = cum_s[i0 + g + 8 * r];
          const float f = kV ? expf(seg - cum) : expf(cum);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            acc[n][2 * r] *= f;
            acc[n][2 * r + 1] *= f;
          }
        }
      }
      __syncthreads();
      continue;
    }
    const int s = s_first + q - n_slices;
    const float* ms = reinterpret_cast<const float*>(p);
    const auto* os = reinterpret_cast<const __nv_bfloat16*>(p + kDxRows * kLdRow * 4);
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {
      const int k0 = s * kT + kk;  // the step's first key in the chunk (j for y, i for v)
      // y keeps keys j <= i, v keys i >= j: a step wholly on the kept side
      // needs no mask, one wholly on the other is skipped
      if (!active || (kV ? k0 + 15 < i0 : k0 > i0)) continue;
      const bool full = kV ? k0 > i0 : k0 < i0;
      if (kV) {
        a_split(
            [&](int r, int k) {
              const int j = i0 + r;
              const int i = k0 + k;
              const float m = ms[(kk + k) * kLdColDx + m0 + r] * exp_masked(cum_s[i] - cum_s[j]);
              return full || i >= j ? m : 0.f;
            },
            ah, al);
      } else {
        a_split(
            [&](int r, int k) {
              const int i = i0 + r;
              const int j = k0 + k;
              const float m =
                  ms[(m0 + r) * kLdRow + kk + k] * exp_masked(cum_s[i] - cum_s[j]) * dt_s[j];
              return full || j <= i ? m : 0.f;
            },
            ah, al);
      }
      b_krows(bh, os, ldp, kk, nt);
      mma_tiles(acc, ah, bh, nt);
      mma_tiles(acc, al, bh, nt);
    }
    __syncthreads();
  }
  // the rows' dot products (g_i . y_i, or x_j . v_j) and dx
  const __nv_bfloat16* other = kV ? x : dy;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    if (i >= valid) continue;
    const int64_t at = ((row0 + i) * nh + head) * P;
    const float d = dt_s[i];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n < nt) {
        const int p = 8 * n + 2 * t4;
        const float2 o =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(other + at + p));
        rs[r] += o.x * acc[n][2 * r] + o.y * acc[n][2 * r + 1];
        if (kV) {
          *reinterpret_cast<__nv_bfloat162*>(dx + at + p) =
              __floats2bfloat162_rn(d * acc[n][2 * r], d * acc[n][2 * r + 1]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    if (t4 == 0 && active) rowt[bch * 2 * L + (kV ? L : 0) + i0 + g + 8 * r] = rs[r];
  }
}

__global__ void __launch_bounds__(32 * kDxRows / 16)
    dx_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ Bm,
                 const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                 const float* __restrict__ cd, const float* __restrict__ cb,
                 const __nv_bfloat16* __restrict__ hp, const __nv_bfloat16* __restrict__ gp,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ rowt, int S, int nh, int P,
                 int N, int L, int nc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  if (blockIdx.x & 1) {
    dx_part<true>(x, Bm, Cm, dy, cd, cb, hp, gp, dx, rowt, S, nh, P, N, L, nc, smem_raw);
  } else {
    dx_part<false>(x, Bm, Cm, dy, cd, cb, hp, gp, dx, rowt, S, nh, P, N, L, nc, smem_raw);
  }
}

// ---- 5. per (b, chunk, head), one warp: cum's gradient g_k . y_k - dt_k
// x_k . v_k (plus <G, state leaving> at the last row), its reverse running
// sum r over the chunk (each lane L / 32 consecutive rows, then a warp scan
// of the lanes' sums), ddt_k = x_k . v_k + A r_k and the chunk's share of
// dA, sum_k dt_k r_k.
__global__ void __launch_bounds__(256)
    finish_tc_kernel(const float* __restrict__ cd, const float* __restrict__ rowt,
                     const float* __restrict__ gdp, const float* __restrict__ A,
                     float* __restrict__ ddt, float* __restrict__ dap, int S, int nh, int L,
                     int nc, int nw, int64_t items) {
  const int64_t bch = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (bch >= items) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int head = static_cast<int>(bch % nh);
  const int64_t bc = bch / nh;
  const int c = static_cast<int>(bc % nc);
  const int64_t b = bc / nc;
  const int valid = min(L, S - c * L);
  const int64_t row0 = b * S + static_cast<int64_t>(c) * L;
  const float* dt = cd + bch * 2 * L + L;
  const float* gy = rowt + bch * 2 * L;
  const float* xv = gy + L;
  float gdot = 0.f;
  for (int q = lane; q < nw; q += 32) gdot += gdp[bch * nw + q];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) gdot += __shfl_xor_sync(0xffffffffu, gdot, o);
  const int per = L / 32;  // 2 .. 8
  const int k0 = lane * per;
  float d[8];
  float run = 0.f;
#pragma unroll
  for (int q = 7; q >= 0; --q) {
    if (q < per) {
      const int k = k0 + q;
      run += gy[k] - dt[k] * xv[k] + (k == L - 1 ? gdot : 0.f);
      d[q] = run;  // the lane's sum from row k to its last
    }
  }
  float later = run;  // then the sum over this lane and the ones after it
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, later, o);
    if (lane + o < 32) later += u;
  }
  later -= run;
  const float a = A[head];
  float da = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q < per) {
      const int k = k0 + q;
      const float r = d[q] + later;
      if (k < valid) ddt[(row0 + k) * nh + head] = xv[k] + a * r;
      da += dt[k] * r;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(0xffffffffu, da, o);
  if (lane == 0) dap[bch] = da;
}

// ---- 6. per (b, chunk, 64-row tile, 64 columns of N, output), a cluster of
// kGroups blocks that share the work of one tile of dC or of dB.  The work
// items are the slabs of the intra-chunk part -- the summed W (hi + lo)
// against B rows over the slabs on or below the tile's diagonal for dC,
// against C rows over those on or above it for dB -- then the heads' state
// parts, exp(cum_i) g_i H for dC and exp(seg - cum_j) dt_j x_j G for dB,
// each head's product (H and G as hi + lo) scaled by its rows' factors;
// block r takes items r, r + kGroups, ..., one stage each, double-buffered
// by cp.async (27 KB a stage at P = 64: four blocks fit on an SM).  Then
// block q adds rows 8 q .. 8 q + 7 of the kGroups partial tiles in block
// order through distributed shared memory.  The grid's first block also
// sums dA's partials (step 5's) in order.
inline __host__ __device__ int dbc_stage_bytes(int P) {
  const int slab = kT * kLdRow * 4 + kT * kBf16Ld * 2;             // W's tile, B or C rows
  const int head = kT * (P + kPad) * 2 + 2 * P * kBf16Ld * 2;       // g or x, H or G
  return slab > head ? slab : head;
}

__global__ void __cluster_dims__(kGroups, 1, 1) __launch_bounds__(128)
    dbc_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ Bm,
                  const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                  const float* __restrict__ cd, const float* __restrict__ wsum,
                  const __nv_bfloat16* __restrict__ hp, const __nv_bfloat16* __restrict__ gp,
                  const float* __restrict__ dap, __nv_bfloat16* __restrict__ dB,
                  __nv_bfloat16* __restrict__ dC, float* __restrict__ dA, int B, int S, int nh,
                  int P, int N, int L, int nc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nb = L / kT;
  const int nn = (N + 63) / 64;
  const int tile = blockIdx.x / kGroups;
  const bool for_b = tile & 1;  // this cluster's output: dB, or dC
  const int t = (tile >> 1) / nn;
  const int n0 = ((tile >> 1) % nn) * 64;
  const int nt = min(8, (N - n0) / 8);
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const int PN = P * N;
  const int ldp = P + kPad;
  const int r0 = t * kT;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
    const int64_t n_bc = static_cast<int64_t>(B) * nc;
    for (int h = threadIdx.x; h < nh; h += blockDim.x) {
      float s = 0.f;
      for (int64_t q = 0; q < n_bc; ++q) s += dap[q * nh + h];
      dA[h] = s;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = 16 * warp;
  const int stage_bytes = dbc_stage_bytes(P);
  // items: the W slabs s (dC: 0 .. t; dB: t .. nb - 1), then the heads
  const int s_first = for_b ? t : 0;
  const int n_w = for_b ? nb - t : t + 1;
  const int n_items = n_w + nh;
  const int vr = valid - r0;
  const __nv_bfloat16* rw = for_b ? Cm : Bm;            // the W slabs' rows
  const __nv_bfloat16* as = for_b ? x : dy;            // the heads' A operand
  const __nv_bfloat16* st = for_b ? gp : hp;           // and their state
  auto load_item = [&](int item, int k) {
    uint8_t* p = smem_raw + k * stage_bytes;
    if (item < n_w) {
      const int s = s_first + item;
      const float* src =
          for_b ? wsum + (bc * L + s * kT) * L + r0 : wsum + (bc * L + r0) * L + s * kT;
      cp_async_rows(smem_u32(p), src, static_cast<int64_t>(L) * 4, kT, kT * 4,
                    (for_b ? kLdCol : kLdRow) * 4, kT);
      cp_async_rows(smem_u32(p + kT * kLdRow * 4),
                    s * kT < valid ? rw + (row0 + s * kT) * N + n0 : rw,
                    static_cast<int64_t>(N) * 2, kT, nt * 16, kBf16Ld * 2, valid - s * kT);
    } else {
      const int64_t bch = bc * nh + item - n_w;
      cp_async_rows(smem_u32(p), vr > 0 ? as + ((row0 + r0) * nh + item - n_w) * P : as,
                    static_cast<int64_t>(nh) * P * 2, kT, P * 2, ldp * 2, vr);
      cp_async_rows(smem_u32(p + kT * ldp * 2), st + bch * 2 * PN + n0,
                    static_cast<int64_t>(N) * 2, 2 * P, nt * 16, kBf16Ld * 2, 2 * P);
    }
    cp_async_commit();
  };
  float acc[8][4];
  zero(acc);
  uint32_t a[4], ah[4], al[4];
  uint32_t bh[8][2], bl[8][2];
  if (rank < n_items) load_item(rank, 0);
  for (int item = rank, k = 0; item < n_items; item += kGroups, k ^= 1) {
    // a head's rows' factors, read while its tiles land
    float f[2] = {0.f, 0.f};
    if (item >= n_w) {
      const float* cdh = cd + (bc * nh + item - n_w) * 2 * L;
      const float seg = cdh[L - 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r0 + m0 + g + 8 * r;
        const float cum = cdh[i];
        f[r] = for_b ? expf(seg - cum) * cdh[L + i] : expf(cum);
      }
    }
    if (item + kGroups < n_items) {
      load_item(item + kGroups, k ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* p = smem_raw + k * stage_bytes;
    if (item < n_w) {
      const int s = s_first + item;
      const float* ws = reinterpret_cast<const float*>(p);
      const auto* rs = reinterpret_cast<const __nv_bfloat16*>(p + kT * kLdRow * 4);
#pragma unroll
      for (int kk = 0; kk < kT; kk += 16) {
        // on the diagonal slab W is 0 above the diagonal: skip the steps there
        if (s == t && (for_b ? kk + 15 < m0 : kk > m0)) continue;
        if (for_b) {
          a_split([&](int r, int kx) { return ws[(kk + kx) * kLdCol + m0 + r]; }, ah, al);
        } else {
          a_split([&](int r, int kx) { return ws[(m0 + r) * kLdRow + kk + kx]; }, ah, al);
        }
        b_krows(bh, rs, kBf16Ld, kk, nt);
        mma_tiles(acc, ah, bh, nt);
        mma_tiles(acc, al, bh, nt);
      }
    } else {
      const auto* a_s = reinterpret_cast<const __nv_bfloat16*>(p);
      const __nv_bfloat16* st_s = a_s + kT * ldp;
      float tmp[8][4];
      zero(tmp);
      for (int k0 = 0; k0 < P; k0 += 16) {
        a_rows(a, a_s, ldp, m0, k0);
        b_krows(bh, st_s, kBf16Ld, k0, nt);
        b_krows(bl, st_s + P * kBf16Ld, kBf16Ld, k0, nt);
        mma_tiles(tmp, a, bh, nt);
        mma_tiles(tmp, a, bl, nt);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += f[e >> 1] * tmp[n][e];
      }
    }
    __syncthreads();  // buffer k is consumed before it is loaded again
  }
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem_raw);  // [64][kLdCol]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(part + (m0 + g + 8 * r) * kLdCol + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
  cluster.sync();  // every block's partial tile is written
  constexpr int kRows = kT / kGroups;
  const int nw = nt * 8;
  __nv_bfloat16* out = for_b ? dB : dC;
  for (int e = threadIdx.x; e < kRows * kT; e += blockDim.x) {
    const int i = rank * kRows + e / kT;
    const int col = e % kT;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) s += cluster.map_shared_rank(part, q)[i * kLdCol + col];
    if (r0 + i < valid && col < nw) out[(row0 + r0 + i) * N + n0 + col] = __float2bfloat16_rn(s);
  }
  cluster.sync();  // no block leaves while another reads its tile
}

inline size_t larger(size_t a, size_t b) { return a > b ? a : b; }

inline size_t prep_smem(int P, int N) {
  return (2ull * kMaxL + 4) * 4 + (2ull * kT * (P + kPad) + 2ull * kT * (N + kPad)) * 2;
}
inline size_t pair_smem(int P, int N) {
  return larger(larger(2ull * kT * (N + kPad) * 2,                         // C and B rows
                       2ull * (2ull * kT * (P + kPad) * 2 + 3ull * kT * 4)),  // two heads' tiles
                static_cast<size_t>(kT) * kLdCol * 4);                    // the partial tile
}
inline size_t dx_smem(int P) { return 2ull * kMaxL * 4 + 2ull * dx_stage_bytes(P); }
inline size_t dbc_smem(int P) {
  return larger(2ull * dbc_stage_bytes(P), static_cast<size_t>(kT) * kLdCol * 4);
}

// The scratch of one call, carved from one buffer (256-byte aligned
// parts): cum and dt (B, nc, nh, 2, L), C.B^T and the head-summed W (B, nc,
// L, L) each, the chunk states hs and gs (B, nc, nh, P, N) float32 each,
// the states entering (hp) and the gradients leaving (gp) each chunk as hi
// + lo bf16 (B, nc, nh, 2, P, N) each, <G, state leaving>'s warp partials
// (B, nc, nh, P N / 128), the rows' g.y and x.v (B, nc, nh, 2, L), and
// dA's partials (B, nc, nh).
struct Scratch {
  float *cd, *cb, *wsum, *hs, *gs, *gdp, *rowt, *dap;
  __nv_bfloat16 *hp, *gp;
};

inline size_t scratch_layout(int B, int S, int nh, int P, int N, int L, char* base,
                             Scratch* out) {
  const size_t nc = (S + L - 1) / L;
  const size_t bc = static_cast<size_t>(B) * nc;
  const size_t bcn = bc * nh;
  const size_t PN = static_cast<size_t>(P) * N;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : base + off;
    off += (bytes + 255) & ~static_cast<size_t>(255);
    return p;
  };
  Scratch s;
  s.cd = reinterpret_cast<float*>(take(bcn * 2 * L * 4));
  s.cb = reinterpret_cast<float*>(take(bc * L * L * 4));
  s.wsum = reinterpret_cast<float*>(take(bc * L * L * 4));
  s.hs = reinterpret_cast<float*>(take(bcn * PN * 4));
  s.gs = reinterpret_cast<float*>(take(bcn * PN * 4));
  s.hp = reinterpret_cast<__nv_bfloat16*>(take(bcn * 2 * PN * 2));
  s.gp = reinterpret_cast<__nv_bfloat16*>(take(bcn * 2 * PN * 2));
  s.gdp = reinterpret_cast<float*>(take(bcn * (PN / 128) * 4));
  s.rowt = reinterpret_cast<float*>(take(bcn * 2 * L * 4));
  s.dap = reinterpret_cast<float*>(take(bcn * 4));
  if (out != nullptr) *out = s;
  return off;
}

int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const void* dy, const float* dh, void* dx, float* ddt, float* dA, void* dB, void* dC,
           void* scratch, int B, int S, int nh, int P, int N, int L, cudaStream_t stream) {
  const int nc = (S + L - 1) / L;
  const int nb = L / kT;
  const int PN = P * N;
  Scratch sc;
  scratch_layout(B, S, nh, P, N, L, static_cast<char*>(scratch), &sc);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(Bm);
  const auto* cm = static_cast<const __nv_bfloat16*>(Cm);
  const auto* gb = static_cast<const __nv_bfloat16*>(dy);
  const size_t s1 = prep_smem(P, N), s2 = pair_smem(P, N), s4 = dx_smem(P), s6 = dbc_smem(P);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(prep_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s1))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(pair_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s2))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dx_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s4))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dbc_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s6))) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int64_t items = static_cast<int64_t>(B) * nc * nh;
  prep_tc_kernel<<<dim3(2 * nh, nc, B), 256, s1, stream>>>(xb, dt, A, bb, cm, gb, sc.cd, sc.hs,
                                                          sc.gs, S, nh, P, N, L, nc);
  pair_tc_kernel<<<dim3(kGroups * nb * (nb + 1) / 2, nc, B), 128, s2, stream>>>(
      xb, bb, cm, gb, sc.cd, sc.cb, sc.wsum, S, nh, P, N, L, nc);
  pass_tc_kernel<<<dim3((PN / 4 + 255) / 256, nh, B), 256, 0, stream>>>(
      sc.cd, dh, sc.hs, sc.gs, sc.hp, sc.gp, sc.gdp, nh, PN, L, nc);
  dx_tc_kernel<<<dim3(2 * ((L + kDxRows - 1) / kDxRows) * nh, nc, B), 32 * kDxRows / 16, s4,
                 stream>>>(
      xb, bb, cm, gb, sc.cd, sc.cb, sc.hp, sc.gp, static_cast<__nv_bfloat16*>(dx), sc.rowt, S, nh,
      P, N, L, nc);
  finish_tc_kernel<<<static_cast<unsigned>((items + 7) / 8), 256, 0, stream>>>(
      sc.cd, sc.rowt, sc.gdp, A, ddt, sc.dap, S, nh, L, nc, PN / 128, items);
  dbc_tc_kernel<<<dim3(kGroups * 2 * nb * ((N + 63) / 64), nc, B), 128, s6, stream>>>(
      xb, bb, cm, gb, sc.cd, sc.wsum, sc.hp, sc.gp, sc.dap, static_cast<__nv_bfloat16*>(dB),
      static_cast<__nv_bfloat16*>(dC), dA, B, S, nh, P, N, L, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

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

// Bytes of device scratch of repro_torch_ssd_scan_bwd_chunked at chunk L
// (bfloat16; float32 takes repro_torch_ssd_scan_bwd's).
extern "C" long long repro_torch_ssd_scan_bwd_chunked_scratch(int batch, int seq, int heads,
                                                              int P, int N, int chunk,
                                                              int is_bf16) {
  using namespace repro_torch::ssd_bwd;
  return static_cast<long long>(
      is_bf16 ? tc::scratch_layout(batch, seq, heads, P, N, chunk, nullptr, nullptr)
              : scratch_layout(batch, seq, heads, P, N, nullptr, nullptr));
}

// repro_torch_ssd_scan_bwd with the forward's chunk length: bfloat16
// inputs take the tensor-core kernels over chunks of `chunk` rows (a
// multiple of 64, at most 256), float32 ones the CUDA-core kernels above;
// repro_torch_ssd_scan_bwd_chunked_scratch(...) bytes of scratch.
extern "C" int repro_torch_ssd_scan_bwd_chunked(const void* x, const float* dt, const float* A,
                                                const void* Bm, const void* Cm, const void* dy,
                                                const float* dh, void* dx, float* ddt, float* dA,
                                                void* dB, void* dC, void* scratch, int batch,
                                                int seq, int heads, int P, int N, int chunk,
                                                int is_bf16, void* stream) {
  if (!is_bf16) {
    return repro_torch_ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dh, dx, ddt, dA, dB, dC, scratch, batch,
                                    seq, heads, P, N, 0, stream);
  }
  if (heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || seq == 0) {  // no rows: dA is 0
    return static_cast<int>(cudaMemsetAsync(dA, 0, sizeof(float) * heads, s));
  }
  return repro_torch::ssd_bwd::tc::launch(x, dt, A, Bm, Cm, dy, dh, dx, ddt, dA, dB, dC, scratch,
                                          batch, seq, heads, P, N, chunk, s);
}
