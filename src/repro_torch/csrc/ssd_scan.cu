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
// P=64, N=128) the function moves ~78 MB (23 us at 3.35 TB/s) and needs
// 9.15 GFLOP of float32 products at the chunk length that needs fewest
// (16; C.B^T counted once per batch row, as ngroups = 1 shares it across
// heads; 0.137 ms at the 67 TFLOP/s float32 peak), so it is bound by
// operations.  This kernel forms C.B^T once per head, 64 times the
// function's count of that term.
//
// Design: one block of 256 threads per (head, batch) walks the sequence;
// nothing carries over between blocks, so the (P, N) state lives in the
// block's shared memory for the whole walk.  A 256-long chunk's C.B^T
// tile (256 KB in float32) with its B and C rows does not fit a block's
// 227 KB, and y and h do not depend on the chunk length beyond rounding,
// so the kernel walks sub-chunks of kSub = 32 rows with the state carried
// between them: per sub-chunk it stages dt*x, B and C, forms the
// decay-masked 32x32 C.B^T tile, writes y, and updates the state.
// exp(cum_i - cum_j) is only taken for j <= i (above the diagonal it
// would overflow).  Rows past S load as zero with dt = 0, which leaves
// the state unchanged, so any S works.  Float32 FMAs on the CUDA cores;
// tensor cores come later.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {
namespace ssd {

constexpr int kSub = 32;
constexpr int kThreadsS = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

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

}  // namespace ssd
}  // namespace repro_torch

// Shared memory one block needs for state width (P, N), in bytes.
extern "C" long long repro_torch_ssd_scan_smem(int P, int N) {
  using repro_torch::ssd::kSub;
  return static_cast<long long>(sizeof(float)) *
         (static_cast<long long>(kSub) * P + 2LL * kSub * (N + 1) + static_cast<long long>(P) * (N + 1) +
          kSub * (kSub + 1) + 3 * kSub);
}

// x (B, S, nh, P) and Bm/Cm (B, S, N) float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); dt (B, S, nh) and A (nh,) float32; y (B, S, nh, P) in
// x's type; h_out (B, nh, P, N) float32; all contiguous (the wrapper
// checks).  Returns cudaGetLastError() after the launch.
extern "C" int repro_torch_ssd_scan(const void* x, const float* dt, const float* A,
                                    const void* Bm, const void* Cm, void* y, float* h_out,
                                    int batch, int seq, int heads, int P, int N, int is_bf16,
                                    void* stream) {
  if (batch == 0 || heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(repro_torch_ssd_scan_smem(P, N));
  if (is_bf16) {
    return repro_torch::ssd::launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_out, batch, seq,
                                                   heads, P, N, smem, s);
  }
  return repro_torch::ssd::launch<float>(x, dt, A, Bm, Cm, y, h_out, batch, seq, heads, P,
                                         N, smem, s);
}
