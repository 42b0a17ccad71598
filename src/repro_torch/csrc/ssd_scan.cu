// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// K5 repro_torch_ssd_scan replaces the Pallas kernel
//   src/repro/kernels/ssd_scan/kernel.py::ssd_scan (_ssd_kernel):
//   per (batch, head), with dA = dt * A and cum its running sum,
//     y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . h            (h: state carried in)
//     h  <- exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
//   chunk by chunk, all in float32; y in x's type, final h in float32.
//   B and C are shared by all heads (ngroups = 1).
//
// Bound on an H100: at mamba2-1.3b's shapes (B=4, S=1024, 64 heads,
// P=64, N=128) the function moves ~78.6 MB (23.5 us at 3.35 TB/s).  Its
// float32 operations at the chunk length that needs fewest (16; C.B^T
// counted once per batch row, as ngroups = 1 shares it across heads) are
// 9.15 GFLOP; computed at float32 accuracy on the bf16 tensor cores they
// take at most twice that (the hi + lo split below), 18.5 us at 989
// TFLOP/s, so on tensor cores the function is bound by bytes.
//
// bfloat16 x, B and C (the models' type, the main path) take four launches
// over chunks of L rows (the caller's chunk rounded up to a multiple of 64,
// at most 256 and at most S rounded up; 256 for mamba2-1.3b), with the
// chunks in parallel, as the chunked SSD decomposition allows:
//   1. cb_kernel, per (b, chunk, 64 x 64 tile on or below the diagonal):
//      C.B^T once per (b, chunk), into a float32 scratch (B, nc, L, L)
//      that every head's blocks read from L2;
//   2. state_kernel, per (b, chunk, head): the chunk's cumulative dA (a
//      warp scan), kept for step 4, and the chunk state sum_j u_j (x) B_j
//      with u_j = x_j dt_j exp(seg - cum_j), seg = cum_last;
//   3. pass_kernel, elementwise over (b, head, P, N): h_c =
//      exp(seg_c) h_{c-1} + S_c, serial over the chunks; the state entering
//      each chunk goes out as hi + lo bf16, the last one to h_out;
//   4. scan_kernel, per (b, chunk, 128 rows, pair of heads):
//      y_i = sum_{j<=i} W_ij x_j + exp(cum_i) C_i . h_{c-1}, with
//      W_ij = (C.B^T)_ij exp(cum_i - cum_j) dt_j taken only for j <= i
//      (above the diagonal the exponent would overflow).  The two heads
//      share the C rows and the C.B^T slabs, and a head's 128 rows share its
//      h_{c-1}: the kernel's time goes with its traffic from L2, which
//      these shares cut (64-row blocks of one head were slower).
// Every block stages its operands with cp.async, double-buffering 64-key
// slabs.  At chunk 256 the chunk states are 33.5 MB and cross memory three
// times (written, read, and read again as hi + lo), beside the function's
// own 78.6 MB.  Products run as mma.sync m16n8k16 bf16 with float32
// accumulators (once on tensor cores the function is bound by bytes at
// these shapes, so wgmma's larger tiles would buy little).  C, B and x are
// bf16 and exact as operands; the operands that carry float32 factors --
// W, u and the carried state h -- go in as hi + lo bf16 parts (two
// products, ~2^-17 relative), since one bf16 rounding would put h ~1e-3
// off, beyond the 5e-4 check.  Rows past S load as zero with dt = 0, so
// any S works.  P and N are multiples of 16, P <= 64, N <= 128 (the
// wrapper checks; the shared memory of step 4 is sized for that).
//
// float32 x (not on the main path) keeps the first form, ssd_kernel<float>:
// one block of 256 threads per (head, batch) walks the sequence in 32-row
// sub-chunks with the (P, N) state in shared memory; float32 FMAs on the
// CUDA cores.
#include <cuda_runtime.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace ssd {

// ------------------------------------------------------------------ float32

constexpr int kSub = 32;
constexpr int kThreadsS = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }

template <typename T>
__global__ void __launch_bounds__(kThreadsS)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ h_out,
               int S, int nh, int P, int N) {
  extern __shared__ float smem[];
  // rows of B, C and the state are padded by one float, so a warp that
  // walks a column (32 rows j at one n) hits 32 banks
  const int hs = N + 1;
  float* xdt_s = smem;                     // [kSub][P]   dt_j * x_j
  float* b_s = xdt_s + kSub * P;           // [kSub][N + 1]
  float* c_s = b_s + kSub * hs;            // [kSub][N + 1]
  float* h_s = c_s + kSub * hs;            // [P][N + 1]
  float* w_s = h_s + P * hs;               // [kSub][kSub + 1]
  float* dt_s = w_s + kSub * (kSub + 1);   // [kSub]
  float* cum_s = dt_s + kSub;              // [kSub]
  float* dec_s = cum_s + kSub;             // [kSub] exp(seg - cum_j)

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float a = A[head];

  for (int e = tid; e < P * N; e += kThreadsS) {
    h_s[(e / N) * hs + e % N] = 0.f;
  }
  for (int s0 = 0; s0 < S; s0 += kSub) {
    // ---- stage the sub-chunk (zero past S) ----
    if (tid < kSub) {
      const int s = s0 + tid;
      dt_s[tid] = s < S ? dt[(static_cast<int64_t>(b) * S + s) * nh + head] : 0.f;
    }
    for (int e = tid; e < kSub * P; e += kThreadsS) {
      const int j = e / P;
      const int p = e - j * P;
      const int s = s0 + j;
      xdt_s[e] = s < S ? load_f32(x + ((static_cast<int64_t>(b) * S + s) * nh + head) * P + p)
                       : 0.f;
    }
    for (int e = tid; e < kSub * N; e += kThreadsS) {
      const int j = e / N;
      const int n = e - j * N;
      const int s = s0 + j;
      const int64_t src = (static_cast<int64_t>(b) * S + s) * N + n;
      b_s[j * hs + n] = s < S ? load_f32(Bm + src) : 0.f;
      c_s[j * hs + n] = s < S ? load_f32(Cm + src) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int j = 0; j < kSub; ++j) {
        c += dt_s[j] * a;
        cum_s[j] = c;
      }
    }
    for (int e = tid; e < kSub * P; e += kThreadsS) xdt_s[e] *= dt_s[e / P];
    __syncthreads();
    // ---- decay-masked C.B^T tile, and the state-update decays ----
    const float seg = cum_s[kSub - 1];
    for (int e = tid; e < kSub * kSub; e += kThreadsS) {
      const int i = e / kSub;
      const int j = e - i * kSub;
      float w = 0.f;
      if (j <= i) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(c_s[i * hs + n], b_s[j * hs + n], cb);
        w = cb * expf(cum_s[i] - cum_s[j]);
      }
      w_s[i * (kSub + 1) + j] = w;
    }
    if (tid < kSub) dec_s[tid] = expf(seg - cum_s[tid]);
    __syncthreads();
    // ---- y: intra-chunk form plus the carried state's contribution ----
    for (int e = tid; e < kSub * P; e += kThreadsS) {
      const int i = e / P;
      const int p = e - i * P;
      const int s = s0 + i;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) {
        intra = fmaf(w_s[i * (kSub + 1) + j], xdt_s[j * P + p], intra);
      }
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(c_s[i * hs + n], h_s[p * hs + n], inter);
      if (s < S) {
        y[((static_cast<int64_t>(b) * S + s) * nh + head) * P + p] =
            from_float<T>(intra + expf(cum_s[i]) * inter);
      }
    }
    __syncthreads();
    // ---- state update ----
    const float seg_decay = expf(seg);
    for (int e = tid; e < P * N; e += kThreadsS) {
      const int p = e / N;
      const int n = e - p * N;
      float upd = 0.f;
      for (int j = 0; j < kSub; ++j) {
        upd = fmaf(xdt_s[j * P + p] * dec_s[j], b_s[j * hs + n], upd);
      }
      h_s[p * hs + n] = seg_decay * h_s[p * hs + n] + upd;
    }
    __syncthreads();
  }
  float* dst = h_out + (static_cast<int64_t>(b) * nh + head) * P * N;
  for (int e = tid; e < P * N; e += kThreadsS) dst[e] = h_s[(e / N) * hs + e % N];
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           void* y, float* h_out, int B, int S, int nh, int P, int N, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nh, B);
  ssd_kernel<T><<<grid, kThreadsS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), h_out, S, nh, P, N);
  return static_cast<int>(cudaGetLastError());
}


// -------------------------------------------------- bfloat16, tensor cores
namespace tc {

using namespace repro_torch::hopper;

constexpr int kTile = 64;     // rows of a chunk block, columns of a C.B^T tile
constexpr int kMaxChunk = 256;
constexpr int kPad = 8;       // bf16 pad of a shared row (ldmatrix without bank conflicts)
constexpr float kLog2e = 1.4426950408889634f;

// ---- 1. C.B^T, once per (b, chunk): one 64 x 64 tile on or below the
// diagonal per block of 4 warps, each warp 16 rows x 64 columns
__global__ void __launch_bounds__(128)
    cb_kernel(const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
              float* __restrict__ cb, int S, int N, int L, int nc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][N + kPad]
  __nv_bfloat16* b_s = c_s + kTile * (N + kPad);                      // [64][N + kPad]
  int ti = 0, rest = blockIdx.x;  // tile pair (ti, tj), tj <= ti
  while (rest > ti) {
    rest -= ti + 1;
    ++ti;
  }
  const int tj = rest;
  const int bc = blockIdx.y;  // b * nc + c
  const int b = bc / nc;
  const int s0 = (bc - b * nc) * L;
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int ld = N + kPad;
  cp_async_rows(smem_u32(c_s), ti * kTile < S - s0 ? Cm + (row0 + ti * kTile) * N : Cm,
                static_cast<int64_t>(N) * 2, kTile, N * 2, ld * 2, S - s0 - ti * kTile);
  cp_async_rows(smem_u32(b_s), tj * kTile < S - s0 ? Bm + (row0 + tj * kTile) * N : Bm,
                static_cast<int64_t>(N) * 2, kTile, N * 2, ld * 2, S - s0 - tj * kTile);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  for (int k0 = 0; k0 < N; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_u32(c_s + (16 * warp + (lane & 15)) * ld + k0 + 8 * (lane >> 4)));
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      // B rows j are the product's columns; matrices (j 0-7 | 8-15) x (k 0-7 | 8-15)
      uint32_t b0[2], b1[2];
      const int mi = lane >> 3;
      ldmatrix_x4(b0, b1, smem_u32(b_s + (8 * nt + (lane & 7) + 8 * (mi >> 1)) * ld + k0 +
                                   8 * (mi & 1)));
      mma_bf16_16816(acc[nt], a, b0[0], b0[1]);
      mma_bf16_16816(acc[nt + 1], a, b1[0], b1[1]);
    }
  }
  const int g = lane >> 2;
  const int t4 = lane & 3;
  float* dst = cb + (static_cast<int64_t>(bc) * L + ti * kTile + 16 * warp + g) * L + tj * kTile;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * t4;
    *reinterpret_cast<float2*>(dst + col) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(dst + 8 * L + col) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- 2. chunk states, per (b, chunk, head): S_c[p][n] = sum_j u_j[p] B_j[n]
// with u_j = x_j dt_j exp(seg - cum_j), over 64-row slabs of the chunk that
// cp.async double-buffers; 8 warps, each one 16 x 64 output tile of (P, N).
// Also writes seg and the chunk's cum and dt for scan_kernel.
__global__ void __launch_bounds__(256)
    state_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ seg_out,
                 float* __restrict__ cumdt, int S, int nh, int P, int N, int L, int nc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* cum_s = reinterpret_cast<float*>(smem_raw);  // [256]
  float* dt_s = cum_s + kMaxChunk;                    // [256], then the u factors
  float* warp_s = dt_s + kMaxChunk;                   // [4]
  __nv_bfloat16* xr_s = reinterpret_cast<__nv_bfloat16*>(warp_s + 4);  // [2][64][P + kPad]
  __nv_bfloat16* b_s = xr_s + 2 * kTile * (P + kPad);                  // [2][64][N + kPad]
  const int head = blockIdx.x;
  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * nh + head;
  const int ldp = P + kPad;
  const int ldn = N + kPad;
  const uint32_t xr_u = smem_u32(xr_s);
  const uint32_t b_u = smem_u32(b_s);
  auto load_slab = [&](int slab) {
    const int k0 = slab * kTile;
    const bool any = k0 < valid;  // a slab wholly past S reads nothing
    cp_async_rows(xr_u + (slab & 1) * kTile * ldp * 2,
                  any ? x + ((row0 + k0) * nh + head) * P : x, static_cast<int64_t>(nh) * P * 2,
                  kTile, P * 2, ldp * 2, valid - k0);
    cp_async_rows(b_u + (slab & 1) * kTile * ldn * 2, any ? Bm + (row0 + k0) * N : Bm,
                  static_cast<int64_t>(N) * 2, kTile, N * 2, ldn * 2, valid - k0);
    cp_async_commit();
  };
  load_slab(0);
  chunk_cumsum(dt + row0 * nh + head, nh, valid, A[head], L, dt_s, cum_s, warp_s);
  const float seg = cum_s[L - 1];
  if (threadIdx.x == 0) seg_out[bch] = seg;
  float* cd = cumdt + bch * 2 * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    cd[j] = cum_s[j];
    cd[L + j] = dt_s[j];
    dt_s[j] *= expf(seg - cum_s[j]);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int mi = lane >> 3;
  // the warp's 16 x 64 output tile of (P, N): P <= 64 and N <= 128 give
  // at most 8 tiles, one per warp
  const int n_groups = (N + 63) / 64;
  const bool has_tile = warp < (P / 16) * n_groups;
  const int p0 = 16 * (warp / n_groups);
  const int n0 = 64 * (warp % n_groups);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int n_slabs = L / kTile;
  for (int slab = 0; slab < n_slabs; ++slab) {
    if (slab + 1 < n_slabs) {
      load_slab(slab + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (has_tile) {
      const __nv_bfloat16* xr = xr_s + (slab & 1) * kTile * ldp;
      const __nv_bfloat16* bs = b_s + (slab & 1) * kTile * ldn;
      const float* fac = dt_s + slab * kTile;
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        // A = u^T (p x j): x^T from x[j][p], matrices (p 0-7 | 8-15) x
        // (j 0-7 | 8-15), times each key's factor, as hi + lo
        uint32_t xa[4], ah[4], al[4];
        ldmatrix_x4_trans(xa, smem_u32(xr + (kk + (lane & 7) + 8 * (mi >> 1)) * ldp + p0 +
                                       8 * (mi & 1)));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = kk + 2 * t4 + 8 * (q >> 1);
          const float x0 = __uint_as_float(xa[q] << 16);  // bf16 -> float32, exact
          const float x1 = __uint_as_float(xa[q] & 0xffff0000u);
          split_bf16x2(x0 * fac[j], x1 * fac[j + 1], ah[q], al[q]);
        }
        // B = B_chunk (j x n), row-major: matrices (j 0-7 | 8-15) x (n 0-7 | 8-15);
        // all hi products before the lo ones, so no product waits on the last
        uint32_t bf[8][2];
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (n0 + 16 * np < N) {
            ldmatrix_x4_trans(bf[2 * np], bf[2 * np + 1],
                              smem_u32(bs + (kk + (lane & 7) + 8 * (mi & 1)) * ldn + n0 + 16 * np +
                                       8 * (mi >> 1)));
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (n0 + 8 * nt < N) mma_bf16_16816(acc[nt], ah, bf[nt][0], bf[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (n0 + 8 * nt < N) mma_bf16_16816(acc[nt], al, bf[nt][0], bf[nt][1]);
        }
      }
    }
    __syncthreads();
  }
  if (!has_tile) return;
  float* dst = states + bch * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = n0 + 8 * nt + 2 * t4;
    if (n >= N) break;
    *reinterpret_cast<float2*>(dst + (p0 + g) * N + n) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(dst + (p0 + g + 8) * N + n) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- 3. state passing, elementwise over (b, head, P*N / 4): h_c =
// exp(seg_c) h_{c-1} + S_c, four chunks' loads in flight at a time; the
// state entering chunk c > 0 goes to hprev as hi + lo bf16
__global__ void __launch_bounds__(256)
    pass_kernel(const float* __restrict__ states, const float* __restrict__ seg,
                __nv_bfloat16* __restrict__ hprev, float* __restrict__ h_out, int nh, int PN,
                int nc) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= PN) return;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 sv[4];
    float d[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c0 + q < nc) {
        const int64_t bch = (static_cast<int64_t>(b) * nc + c0 + q) * nh + head;
        sv[q] = *reinterpret_cast<const float4*>(states + bch * PN + e);
        d[q] = seg[bch];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c0 + q < nc) {
        if (c0 + q > 0) {
          const int64_t bch = (static_cast<int64_t>(b) * nc + c0 + q) * nh + head;
          uint32_t hi[2], lo[2];
          split_bf16x2(h.x, h.y, hi[0], lo[0]);
          split_bf16x2(h.z, h.w, hi[1], lo[1]);
          __nv_bfloat16* dst = hprev + bch * 2 * PN + e;
          *reinterpret_cast<uint2*>(dst) = make_uint2(hi[0], hi[1]);
          *reinterpret_cast<uint2*>(dst + PN) = make_uint2(lo[0], lo[1]);
        }
        const float dd = expf(d[q]);
        h = make_float4(h.x * dd + sv[q].x, h.y * dd + sv[q].y, h.z * dd + sv[q].z,
                        h.w * dd + sv[q].w);
      }
    }
  }
  *reinterpret_cast<float4*>(h_out + (static_cast<int64_t>(b) * nh + head) * PN + e) = h;
}

constexpr int kCbLd = kTile + 8;  // float row of a staged C.B^T tile
constexpr int kScanRows = 128;    // chunk rows per scan_kernel block
constexpr int kScanHeads = 2;     // heads per scan_kernel block
constexpr int kScanWarps = kScanRows / 16 * kScanHeads;

// ---- 4. outputs, per (b, chunk, 128-row block, pair of heads): 16 warps,
// eight per head, each 16 rows x P columns.  The two heads share the
// block's C rows and C.B^T slabs, and the eight warps of a head share its
// h_{c-1}, so each crosses L2 once per block.  cp.async brings each head's
// cum/dt and h_{c-1} (hi + lo) and the C rows at once, then double-buffers
// 64-key slabs of C.B^T and x.
__global__ void __launch_bounds__(32 * kScanWarps, 1)
    scan_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ Cm,
                const float* __restrict__ cb, const __nv_bfloat16* __restrict__ hprev,
                const float* __restrict__ cumdt, __nv_bfloat16* __restrict__ y, int S, int nh,
                int P, int N, int L, int nc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int ldp = P + kPad;
  const int ldn = N + kPad;
  float* cd_s = reinterpret_cast<float*>(smem_raw);         // [heads][cum, dt][256]
  float* cb_s = cd_s + kScanHeads * 2 * kMaxChunk;          // [2][128][kCbLd]
  auto* c_s = reinterpret_cast<__nv_bfloat16*>(cb_s + 2 * kScanRows * kCbLd);  // [128][ldn]
  __nv_bfloat16* h_s = c_s + kScanRows * ldn;               // [heads][hi, lo][P][ldn]
  __nv_bfloat16* x_s = h_s + kScanHeads * 2 * P * ldn;      // [2][heads][64][ldp]
  const int h0 = blockIdx.x * kScanHeads;
  const int nheads = min(kScanHeads, nh - h0);
  const int r_blk = blockIdx.y * kScanRows;  // the block's first chunk row
  const int bc = blockIdx.z;                 // b * nc + c
  const int b = bc / nc;
  const int c = bc - b * nc;
  const int s0 = c * L;
  const int valid = min(L, S - s0);
  const int64_t row0 = static_cast<int64_t>(b) * S + s0;
  const int n_slabs = (min(L, r_blk + kScanRows) + kTile - 1) / kTile;

  for (int hw = 0; hw < nheads; ++hw) {
    const int64_t bch = static_cast<int64_t>(bc) * nh + h0 + hw;
    cp_async_rows(smem_u32(cd_s + hw * 2 * kMaxChunk), cumdt + bch * 2 * L, L * 4, 2, L * 4,
                  kMaxChunk * 4, 2);
    if (c > 0) {  // hi rows then lo rows, contiguous in both places
      cp_async_rows(smem_u32(h_s + hw * 2 * P * ldn), hprev + bch * 2 * P * N,
                    static_cast<int64_t>(N) * 2, 2 * P, N * 2, ldn * 2, 2 * P);
    }
  }
  cp_async_rows(smem_u32(c_s), r_blk < valid ? Cm + (row0 + r_blk) * N : Cm,
                static_cast<int64_t>(N) * 2, kScanRows, N * 2, ldn * 2, valid - r_blk);
  cp_async_commit();
  auto load_slab = [&](int slab) {
    const int k0 = slab * kTile;
    // C.B^T rows past the chunk (a 64-row chunk tail) load as zero
    cp_async_rows(smem_u32(cb_s + (slab & 1) * kScanRows * kCbLd),
                  cb + (static_cast<int64_t>(bc) * L + r_blk) * L + k0,
                  static_cast<int64_t>(L) * 4, kScanRows, kTile * 4, kCbLd * 4, L - r_blk);
    for (int hw = 0; hw < nheads; ++hw) {
      cp_async_rows(smem_u32(x_s + ((slab & 1) * kScanHeads + hw) * kTile * ldp),
                    k0 < valid ? x + ((row0 + k0) * nh + h0 + hw) * P : x,
                    static_cast<int64_t>(nh) * P * 2, kTile, P * 2, ldp * 2, valid - k0);
    }
    cp_async_commit();
  };
  load_slab(0);

  const int lane = threadIdx.x & 31;
  const int hw = threadIdx.x / (32 * kScanRows / 16);  // which head of the block
  const int wr = (threadIdx.x >> 5) % (kScanRows / 16);  // which 16 rows
  const int i0 = r_blk + 16 * wr;                        // the warp's first chunk row
  const bool active = hw < nheads && i0 < L;
  const int head = h0 + hw;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int mi = lane >> 3;
  const float* cum_s = cd_s + hw * 2 * kMaxChunk;
  const float* dt_s = cum_s + kMaxChunk;
  const __nv_bfloat16* hh_s = h_s + hw * 2 * P * ldn;
  const __nv_bfloat16* hl_s = hh_s + P * ldn;
  float yi[8][4], yc[8][4];  // intra-chunk part, carried-state part
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) yi[i][e] = yc[i][e] = 0.f;

  // y_intra: W (rows i, keys j <= i) times x, W as hi + lo
  for (int slab = 0; slab < n_slabs; ++slab) {
    if (slab + 1 < n_slabs) {
      load_slab(slab + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* cbt = cb_s + (slab & 1) * kScanRows * kCbLd + (16 * wr + g) * kCbLd;
      const __nv_bfloat16* xs = x_s + ((slab & 1) * kScanHeads + hw) * kTile * ldp;
      const float cum_r[2] = {cum_s[i0 + g], cum_s[i0 + g + 8]};
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        const int j0 = slab * kTile + kk;
        if (j0 > i0) break;
        // W as hi + lo; exp only for j <= i (above the diagonal it would
        // overflow), and no test at all for a step wholly below the diagonal
        const bool below = j0 + 15 < i0;
        uint32_t wh[4], wl[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = q & 1;  // row g or g + 8
          const int i = i0 + g + 8 * r;
          const int jl = kk + 2 * t4 + 8 * (q >> 1);
          const int j = slab * kTile + jl;
          const float2 v = *reinterpret_cast<const float2*>(cbt + 8 * r * kCbLd + jl);
          float w0 = v.x * exp2f((cum_r[r] - cum_s[j]) * kLog2e) * dt_s[j];
          float w1 = v.y * exp2f((cum_r[r] - cum_s[j + 1]) * kLog2e) * dt_s[j + 1];
          if (!below) {
            w0 = j <= i ? w0 : 0.f;
            w1 = j + 1 <= i ? w1 : 0.f;
          }
          split_bf16x2(w0, w1, wh[q], wl[q]);
        }
        // B = x (j x p), row-major: matrices (j 0-7 | 8-15) x (p 0-7 | 8-15);
        // all hi products before the lo ones, so no product waits on the last
        uint32_t bf[8][2];
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (16 * np < P) {
            ldmatrix_x4_trans(bf[2 * np], bf[2 * np + 1],
                              smem_u32(xs + (kk + (lane & 7) + 8 * (mi & 1)) * ldp + 16 * np +
                                       8 * (mi >> 1)));
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (8 * nt < P) mma_bf16_16816(yi[nt], wh, bf[nt][0], bf[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (8 * nt < P) mma_bf16_16816(yi[nt], wl, bf[nt][0], bf[nt][1]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  // y_carried: C_i . h_{c-1}, h as hi + lo
  if (c > 0) {
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(c_s + (16 * wr + (lane & 15)) * ldn + k0 + 8 * (lane >> 4)));
      // B = h^T (n x p) from h[p][n]: matrices (p 0-7 | 8-15) x (n 0-7 | 8-15)
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (16 * np < P) {
          const int boff = (16 * np + (lane & 7) + 8 * (mi >> 1)) * ldn + k0 + 8 * (mi & 1);
          ldmatrix_x4(bh[2 * np], bh[2 * np + 1], smem_u32(hh_s + boff));
          ldmatrix_x4(bl[2 * np], bl[2 * np + 1], smem_u32(hl_s + boff));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (8 * nt < P) mma_bf16_16816(yc[nt], a, bh[nt][0], bh[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (8 * nt < P) mma_bf16_16816(yc[nt], a, bl[nt][0], bl[nt][1]);
      }
    }
  }
  const float dec[2] = {expf(cum_s[i0 + g]), expf(cum_s[i0 + g + 8])};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int p = 8 * nt + 2 * t4;
    if (p >= P) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + g + 8 * r;
      if (i < valid) {
        *reinterpret_cast<__nv_bfloat162*>(y + ((row0 + i) * nh + head) * P + p) =
            __floats2bfloat162_rn(yi[nt][2 * r] + dec[r] * yc[nt][2 * r],
                                  yi[nt][2 * r + 1] + dec[r] * yc[nt][2 * r + 1]);
      }
    }
  }
}

inline size_t cb_smem(int N) { return 2ull * kTile * (N + kPad) * 2; }
inline size_t state_smem(int P, int N) {
  return (2ull * kMaxChunk + 4) * 4 + (2ull * kTile * (P + kPad) + 2ull * kTile * (N + kPad)) * 2;
}
inline size_t scan_smem(int P, int N) {
  return (2ull * kScanHeads * kMaxChunk + 2ull * kScanRows * kCbLd) * 4 +
         (static_cast<size_t>(kScanRows + 2 * kScanHeads * P) * (N + kPad) +
          2ull * kScanHeads * kTile * (P + kPad)) * 2;
}

// The scratch of one call, carved from one buffer (256-byte aligned
// parts): C.B^T (B, nc, L, L) and the chunk states (B, nc, nh, P, N) in
// float32, the state entering each chunk as hi + lo bf16 (B, nc, nh, 2, P,
// N), seg (B, nc, nh) and each chunk's cum and dt (B, nc, nh, 2, L).
struct Scratch {
  float* cb;
  float* states;
  __nv_bfloat16* hprev;
  float* seg;
  float* cumdt;
};

inline size_t scratch_layout(int B, int S, int nh, int P, int N, int L, char* base, Scratch* out) {
  const size_t nc = (S + L - 1) / L;
  const size_t bcn = static_cast<size_t>(B) * nc * nh;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base == nullptr ? nullptr : base + off;
    off += (bytes + 255) & ~static_cast<size_t>(255);
    return p;
  };
  char* cb = take(static_cast<size_t>(B) * nc * L * L * 4);
  char* st = take(bcn * P * N * 4);
  char* hp = take(bcn * 2 * P * N * 2);
  char* sg = take(bcn * 4);
  char* cd = take(bcn * 2 * L * 4);
  if (out != nullptr) {
    *out = Scratch{reinterpret_cast<float*>(cb), reinterpret_cast<float*>(st),
                   reinterpret_cast<__nv_bfloat16*>(hp), reinterpret_cast<float*>(sg),
                   reinterpret_cast<float*>(cd)};
  }
  return off;
}

int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           void* y, float* h_out, void* scratch, int B, int S, int nh, int P, int N, int L,
           cudaStream_t stream) {
  const int nc = (S + L - 1) / L;
  const int nb = L / kTile;
  Scratch sc;
  scratch_layout(B, S, nh, P, N, L, static_cast<char*>(scratch), &sc);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* Bb = static_cast<const __nv_bfloat16*>(Bm);
  const auto* Cb = static_cast<const __nv_bfloat16*>(Cm);
  cudaError_t err;
  const size_t s1 = cb_smem(N), s2 = state_smem(P, N), s4 = scan_smem(P, N);
  if ((err = cudaFuncSetAttribute(cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s1))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s2))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s4))) != cudaSuccess) {
    return static_cast<int>(err);
  }
  cb_kernel<<<dim3(nb * (nb + 1) / 2, B * nc), 128, s1, stream>>>(Bb, Cb, sc.cb, S, N, L, nc);
  state_kernel<<<dim3(nh, nc, B), 256, s2, stream>>>(xb, dt, A, Bb, sc.states, sc.seg,
                                                      sc.cumdt, S, nh, P, N, L, nc);
  pass_kernel<<<dim3((P * N / 4 + 255) / 256, nh, B), 256, 0, stream>>>(
      sc.states, sc.seg, sc.hprev, h_out, nh, P * N, nc);
  scan_kernel<<<dim3((nh + kScanHeads - 1) / kScanHeads, (L + kScanRows - 1) / kScanRows,
                     B * nc),
                32 * kScanWarps, s4, stream>>>(
      xb, Cb, sc.cb, sc.hprev, sc.cumdt, static_cast<__nv_bfloat16*>(y), S, nh, P, N, L, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace ssd
}  // namespace repro_torch

// Shared memory one float32 block needs for state width (P, N), in bytes.
extern "C" long long repro_torch_ssd_scan_smem(int P, int N) {
  using repro_torch::ssd::kSub;
  return static_cast<long long>(sizeof(float)) *
         (static_cast<long long>(kSub) * P + 2LL * kSub * (N + 1) + static_cast<long long>(P) * (N + 1) +
          kSub * (kSub + 1) + 3 * kSub);
}

// Bytes of scratch the bfloat16 kernel needs for chunk length L.
extern "C" long long repro_torch_ssd_scan_scratch(int batch, int seq, int heads, int P, int N,
                                                  int L) {
  return static_cast<long long>(
      repro_torch::ssd::tc::scratch_layout(batch, seq, heads, P, N, L, nullptr, nullptr));
}

// x (B, S, nh, P) and Bm/Cm (B, S, N) float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); dt (B, S, nh) and A (nh,) float32; y (B, S, nh, P) in
// x's type; h_out (B, nh, P, N) float32; all contiguous (the wrapper
// checks).  bfloat16 only: chunk L (a multiple of 64, <= 256) and
// repro_torch_ssd_scan_scratch(...) bytes of device scratch (256-byte
// aligned).  Returns cudaGetLastError() after the launches.
extern "C" int repro_torch_ssd_scan(const void* x, const float* dt, const float* A,
                                    const void* Bm, const void* Cm, void* y, float* h_out,
                                    void* scratch, int batch, int seq, int heads, int P, int N,
                                    int chunk, int is_bf16, void* stream) {
  if (batch == 0 || heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (seq == 0) return 0;
    return repro_torch::ssd::tc::launch(x, dt, A, Bm, Cm, y, h_out, scratch, batch, seq, heads,
                                        P, N, chunk, s);
  }
  const size_t smem = static_cast<size_t>(repro_torch_ssd_scan_smem(P, N));
  return repro_torch::ssd::launch<float>(x, dt, A, Bm, Cm, y, h_out, batch, seq, heads, P, N,
                                         smem, s);
}
