// Blockwise (flash) attention forward for Hopper (sm_90a).
//
// K4 repro_torch_flash_attention replaces the Pallas kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention
//   (_flash_kernel, with ops.flash_mha's GQA expansion):
//   softmax(Q K^T / sqrt(hd)) V with the online (m, l, acc) recurrence in
//   float32, key tiles wholly above the causal diagonal skipped, one
//   division by max(l, 1e-20) and one cast to q's type at the end.
//
// Sliding window (window > 0, causal only; the reference's Pallas kernel
// has none, its XLA paths models/layers.py causal_mask and
// blockwise_attention do): key j is valid for query i iff
// i - window < j <= i.  A query tile starting at row q0 begins at key tile
// max(0, q0 - window + 1) / block: key tiles wholly below the window are
// never loaded, as tiles wholly above the diagonal are not, and the
// element mask runs only on the tiles that cross the diagonal, the
// window's lower edge or S.  window >= S gives the bits of window = 0.
//
// Layout: the model's (B, S, H, hd) for q and out, (B, Sk, K, hd) for
// k/v; query head h reads kv head h / (H / K), so the reference's
// jnp.repeat of the kv heads is never materialized.  Any S and Sk: rows
// past S and keys past Sk are masked (the reference asserts S % block ==
// 0).  Sk differs from S only without the causal mask (the encdec
// family's cross-attention: S decoder rows over Sk encoder rows; the
// wrapper refuses a causal call with Sk != S); then every query tile
// walks the ceil(Sk / 64) key tiles.  hd is a multiple of 8 up to 128.
//
// Bound on an H100: at the model's shapes (B=4, S=1024, H=32, K=8,
// hd=128, causal) the function moves ~84 MB (25 us at 3.35 TB/s) and
// does 34.4 GFLOP of products over the causal half (query i sees keys
// 0..i; 34.8 us at the 989 TFLOP/s bf16 tensor-core peak), so it is
// bound by operations, and only the tensor cores can approach it.
//
// bfloat16 inputs (the models' type, the main path) take the tensor-core
// kernel flash_tc_kernel:
//   * persistent CTAs of 384 threads, one per SM, each walking work items
//     (b*h, 128-row query tile) with a stride of the grid, the highest
//     (longest, under the causal mask) query tiles first.  Warpgroup 0 is
//     the producer: one thread issues TMA loads, and the warpgroup gives
//     its registers to the consumers (setmaxnreg 24/240).  Warpgroups 1
//     and 2 each own 64 query rows of the item.
//   * TMA: 4-D tensor maps over (hd, heads, S, B), encoded on the host per
//     call through cudaGetDriverEntryPointByVersion (no libcuda link),
//     passed as __grid_constant__ parameters.  A box is 64 columns (128
//     bytes, the 128-byte swizzle) by 128 query or 64 key rows; hd = 128
//     takes two boxes, hd <= 64 one, and columns past hd and rows past S
//     (Sk for the K and V maps) arrive as zeros.  The 4-D map keeps a tile past S from reading the
//     next batch row.
//   * Q is double-buffered (full and empty mbarriers), so the next item's
//     Q loads while the consumers finish the current one; 64-key tiles of
//     K and V stream through a 2-stage ring in shared memory, each stage
//     with its K-full, V-full and empty mbarriers, so S = Q K^T can start
//     before V has landed.  (Tiles of 128 keys and a softmax overlapped
//     with the previous tile's P V were tried and were no faster.)
//   * S = Q K^T is wgmma m64n64k16 with both operands read from shared
//     memory through 128-byte-swizzle descriptors; the scores stay in
//     float32 registers, where the mask (masked keys give p = 0 exactly;
//     only on a tile that crosses an edge of the mask or S) and the online
//     softmax run, in the log2 domain.  Under a window a warpgroup also
//     waits out and releases the tiles below its own rows' window that
//     the item's first rows need.
//   * P V: P goes to the A fragments of wgmma m64n{64,128}k16 in registers
//     (the float32 accumulator layout of a k16 slice is the A layout), V is
//     read MN-major from shared memory (transpose flag), so V is never
//     transposed in memory.  P is rounded as two bf16 parts, hi = bf16(p)
//     and lo = bf16(p - hi), and each part is one wgmma: a single bf16
//     rounding of P puts outputs near 0 up to 2^-9 |v| off the float32
//     plain version, beyond the card check of one bf16 ulp
//     (tests/test_torch_flash_attention.py emulates both).  The product
//     therefore costs 1.5x the function's operations.
//   * Epilogue: one division by max(l, 1e-20), one cast to bf16.
//   No key is split across CTAs, so every call gives the same bits.
//
// float32 inputs (not on the main path) keep the first form,
// flash_kernel<float>: one block of 256 threads per (b*h, 64-row query
// tile), Q and K-then-V tiles staged in shared memory as float32, scores
// and products as float32 FMAs on the CUDA cores; tiles are zero-padded to
// HDP (16, 32, 64 or 128) columns.
#include <cuda.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace flash {

// ------------------------------------------------------------------ float32

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsF = 256;
constexpr float kNegInf = -1e30f;
static_assert(kThreadsF == 4 * kBlockQ, "four threads per row in the softmax");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float load_f32(const float* p) { return *p; }

// rows [row0, row0 + 64) of a (B, S, heads, hd) tensor at head `head`
// (S: the tensor's own rows, Sk for k and v) -> smem[64][HDP + 1]
// float32, zero past S and past hd
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
                 const T* __restrict__ v, T* __restrict__ out, int S, int Sk,
                 int H, int K, int hd, int causal, int window, float scale) {
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

  const int n_tiles_all = (Sk + kBlockK - 1) / kBlockK;
  const int n_tiles = causal ? min(n_tiles_all, (q0 + kBlockQ - 1) / kBlockK + 1)
                             : n_tiles_all;
  // key tiles wholly below the window of the tile's first row: skipped
  const int t0 = window > 0 ? max(0, q0 - window + 1) / kBlockK : 0;
  for (int t = t0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    load_tile<T, HDP>(kv_s, k, b, k0, kvh, Sk, K, hd);
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
        const bool valid = kpos < Sk && (!causal || kpos <= q0 + r) &&
                           (window <= 0 || kpos > q0 + r - window);
        p_s[r * (kBlockK + 1) + c] = valid ? sc[i][j] * scale : neg_inf();
      }
    }
    __syncthreads();
    // V tile into the shared buffer; row owners run the online softmax
    load_tile<T, HDP>(kv_s, v, b, k0, kvh, Sk, K, hd);
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

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Sk, int H,
           int K, int hd, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(HDP);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<float, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_kernel<float, HDP><<<grid, kThreadsF, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Sk, H, K, hd, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------- bfloat16, tensor cores
namespace tc {

using namespace repro_torch::hopper;

constexpr int kBlockM = 128;  // query rows per CTA, 64 per consumer warpgroup
constexpr int kBlockN = 64;   // keys per tile
constexpr int kStages = 2;
constexpr int kBox = kTmaBox;  // bf16 columns in one 128-byte swizzled row
constexpr int kThreads = 384; // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kRowBytes = kBox * 2;

template <int HDP>
struct Layout {
  static constexpr int kBoxes = HDP / kBox;
  static constexpr int kQBytes = kBlockM * HDP * 2;
  static constexpr int kKVBytes = kBlockN * HDP * 2;  // one K or V tile
  static constexpr int kQ = 0;                          // [2][box][128 rows][128 B]
  static constexpr int kK = kQ + 2 * kQBytes;           // [stage][box][64 rows][128 B]
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBar = kV + kStages * kKVBytes;
  static constexpr int kBars = 4 + 3 * kStages;
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + alignment slack
};

// Work item w of a persistent CTA: (b*h, 128-row query tile), the highest
// query tiles (the longest under the causal mask; under a window every
// tile past the first window is as long) first, with key tiles
// [kt0, n_kt): from the first that holds a key in the window of row q0
// to the last at or below the diagonal of its last row, or without the
// causal mask the last of the Sk keys.  The producer and both consumer
// warpgroups walk this one range, so no tile past Sk is ever issued.
struct Item {
  int q0, b, h, kt0, n_kt;
};

__device__ __forceinline__ Item item_of(int w, int BH, int H, int S, int Sk, int causal,
                                        int window) {
  const int n_qt = (S + kBlockM - 1) / kBlockM;
  const int qt = causal ? n_qt - 1 - w / BH : w / BH;
  const int bh = w - (w / BH) * BH;
  Item it;
  it.q0 = qt * kBlockM;
  it.b = bh / H;
  it.h = bh - it.b * H;
  const int n_kt_all = (Sk + kBlockN - 1) / kBlockN;
  it.n_kt = causal ? min(n_kt_all, (it.q0 + kBlockM - 1) / kBlockN + 1) : n_kt_all;
  it.kt0 = window > 0 ? max(0, it.q0 - window + 1) / kBlockN : 0;
  return it;
}

// Persistent: each CTA walks items blockIdx.x, blockIdx.x + gridDim.x, ...
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                    int B, int S, int Sk, int H, int K, int hd, int causal, int window,
                    float scale_log2) {
  using L = Layout<HDP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBar;
  auto q_full = [&](int qb) { return bars + 8u * qb; };
  auto q_empty = [&](int qb) { return bars + 8u * (2 + qb); };
  auto k_full = [&](int st) { return bars + 8u * (4 + st); };
  auto v_full = [&](int st) { return bars + 8u * (4 + kStages + st); };
  auto empty = [&](int st) { return bars + 8u * (4 + 2 * kStages + st); };
  const int BH = B * H;
  const int n_items = (S + kBlockM - 1) / kBlockM * BH;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
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
    // ---------------- producer: one thread keeps the TMA ring full
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      int kv = 0;  // K/V tiles issued so far: the ring's stage and phase
      for (int n = 0, w = blockIdx.x; w < n_items; ++n, w += gridDim.x) {
        const Item it = item_of(w, BH, H, S, Sk, causal, window);
        const int kvh = it.h / (H / K);
        const int qb = n & 1;
        mbar_wait(q_empty(qb), ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), L::kQBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(base + L::kQ + qb * L::kQBytes + c * kBlockM * kRowBytes, &q_map,
                      q_full(qb), c * kBox, it.h, it.q0, it.b);
        }
        for (int t = it.kt0; t < it.n_kt; ++t, ++kv) {
          const int st = kv % kStages;
          mbar_wait(empty(st), ((kv / kStages) & 1) ^ 1);
          const uint32_t k_dst = base + L::kK + st * L::kKVBytes;
          const uint32_t v_dst = base + L::kV + st * L::kKVBytes;
          mbar_expect_tx(k_full(st), L::kKVBytes);
          for (int c = 0; c < L::kBoxes; ++c) {
            tma_load_4d(k_dst + c * kBlockN * kRowBytes, &k_map, k_full(st), c * kBox, kvh,
                        t * kBlockN, it.b);
          }
          mbar_expect_tx(v_full(st), L::kKVBytes);
          for (int c = 0; c < L::kBoxes; ++c) {
            tma_load_4d(v_dst + c * kBlockN * kRowBytes, &v_map, v_full(st), c * kBox, kvh,
                        t * kBlockN, it.b);
          }
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
    for (int n = 0, w = blockIdx.x; w < n_items; ++n, w += gridDim.x) {
      const Item it = item_of(w, BH, H, S, Sk, causal, window);
      const int qb = n & 1;
      // accumulator element j sits at row r0 + 8 ((j >> 1) & 1), column
      // 8 (j >> 2) + cq + (j & 1) of the warpgroup's 64-row tile
      const int first_row = it.q0 + 64 * cw;
      const int r0 = first_row + 16 * warp + (lane >> 2);
      const int last_row = first_row + 63;
      // key tiles [mine0, n_mine) this warpgroup computes: under the causal
      // mask the item's last tile can lie wholly above its rows, under a
      // window the item's first tile wholly below their window
      const int n_mine = causal ? min(it.n_kt, last_row / kBlockN + 1) : it.n_kt;
      const int mine0 = window > 0 ? max(0, first_row - window + 1) / kBlockN : 0;
      const uint32_t q_tile = base + L::kQ + qb * L::kQBytes + cw * 64 * kRowBytes;
      // the ring position of key tile t of this item
      auto stage = [&](int t) { return (kv + t - it.kt0) % kStages; };
      auto phase = [&](int t) {
        return static_cast<uint32_t>(((kv + t - it.kt0) / kStages) & 1);
      };
      auto release = [&](int t) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(stage(t)));
      };

      float o[HDP / 2];
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) o[j] = 0.f;
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this thread's share of the row sums
      mbar_wait(q_full(qb), (n >> 1) & 1);
      for (int t = it.kt0; t < it.n_kt; ++t) {
        if (t < mine0 || t >= n_mine) {
          // a tile wholly outside the warpgroup's rows' mask: wait for it,
          // release it
          mbar_wait(k_full(stage(t)), phase(t));
          mbar_wait(v_full(stage(t)), phase(t));
          release(t);
          continue;
        }
        const int k0 = t * kBlockN;
        // ---- S = Q K^T on the tensor cores
        mbar_wait(k_full(stage(t)), phase(t));
        const uint32_t k_tile = base + L::kK + stage(t) * L::kKVBytes;
        float s[kBlockN / 2];
#pragma unroll
        for (int j = 0; j < kBlockN / 2; ++j) s[j] = 0.f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HDP / 16; ++kk) {
          const uint32_t kofs = (kk & 3) * 32;
          const uint64_t a = desc_sw128(q_tile + (kk >> 2) * kBlockM * kRowBytes + kofs, 16, 1024);
          const uint64_t b = desc_sw128(k_tile + (kk >> 2) * kBlockN * kRowBytes + kofs, 16, 1024);
          wgmma_ss<kBlockN>(s, a, b, kk > 0 ? 1 : 0);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        // ---- mask (only a tile that crosses the diagonal, the window's
        // lower edge or Sk needs one), online softmax (log2 domain)
        float mx[2] = {m[0], m[1]};
        const bool edge = k0 + kBlockN > Sk || (causal && k0 + kBlockN - 1 > first_row) ||
                          (window > 0 && k0 <= last_row - window);
        auto scale_and_mask = [&](auto masked) {
#pragma unroll
          for (int j = 0; j < kBlockN / 2; ++j) {
            s[j] *= scale_log2;
            if constexpr (decltype(masked)::value) {
              const int key = k0 + 8 * (j >> 2) + cq + (j & 1);
              const int row = r0 + 8 * ((j >> 1) & 1);
              if (!(key < Sk && (!causal || key <= row) && (window <= 0 || key > row - window))) {
                s[j] = neg_inf();
              }
            }
            mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
          }
        };
        if (edge) {
          scale_and_mask(std::true_type{});
        } else {
          scale_and_mask(std::false_type{});
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = exp2f(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
        // P as hi + lo bf16 A fragments: k16 slice kk holds keys
        // 16 kk .. 16 kk + 15, register e of it the pair (8 kk + 2 e, +1)
        uint32_t p_hi[kBlockN / 16][4], p_lo[kBlockN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 8 * kk + 2 * e;
            const int r = e & 1;
            // masked keys contribute exactly 0
            const float p0 = s[j] == neg_inf() ? 0.f : exp2f(s[j] - m[r]);
            const float p1 = s[j + 1] == neg_inf() ? 0.f : exp2f(s[j + 1] - m[r]);
            l[r] += p0 + p1;
            split_bf16x2(p0, p1, p_hi[kk][e], p_lo[kk][e]);
          }
        }
#pragma unroll
        for (int j = 0; j < HDP / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
        // ---- O += P V on the tensor cores
        mbar_wait(v_full(stage(t)), phase(t));
        const uint32_t v_tile = base + L::kV + stage(t) * L::kKVBytes;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          // 16 keys = two 8-row groups (1024 B apart); the second 64-column
          // block of hd lies one box (kBlockN rows) further
          const uint64_t vd = desc_sw128(v_tile + kk * 16 * kRowBytes, kBlockN * kRowBytes, 1024);
          wgmma_rs<HDP>(o, p_hi[kk], vd);
          wgmma_rs<HDP>(o, p_lo[kk], vd);
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(o);
        release(t);
      }
      kv += it.n_kt - it.kt0;
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty(qb));  // Q is no longer read
      // ---- epilogue: one division, one cast
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = fmaxf(l[r], 1e-20f);
      }
#pragma unroll
      for (int j = 0; j < HDP / 2; j += 2) {
        const int r = (j >> 1) & 1;
        const int row = r0 + 8 * r;
        const int col = 8 * (j >> 2) + cq;
        if (row < S && col < hd) {
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((static_cast<int64_t>(it.b) * S + row) * H + it.h) * hd + col) =
              __floats2bfloat162_rn(o[j] / l[r], o[j + 1] / l[r]);
        }
      }
    }
  }
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Sk, int H,
           int K, int hd, int causal, int window, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  CUtensorMap qm, km, vm;
  if (!make_map(encode, &qm, q, B, S, H, hd, kBlockM) ||
      !make_map(encode, &km, k, B, Sk, K, hd, kBlockN) ||
      !make_map(encode, &vm, v, B, Sk, K, hd, kBlockN)) {
    return kErrEncode;
  }
  const int smem = Layout<HDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // one persistent CTA per SM, or one per work item if there are fewer
  const long long n_items = static_cast<long long>((S + kBlockM - 1) / kBlockM) * B * H;
  const int grid = static_cast<int>(n_items < n_sm ? n_items : n_sm);
  flash_tc_kernel<HDP><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), B, S, Sk, H, K, hd, causal, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace flash
}  // namespace repro_torch

// q/out (B, S, H, hd), k/v (B, kv_seq, K, hd), contiguous, float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1); 8 <= hd <= 128, hd % 8 == 0,
// H % K == 0; kv_seq >= 1, and kv_seq == seq under the causal mask; window
// > 0 only with causal (the wrapper checks).  Returns cudaGetLastError()
// after the launch, or a negative code when a TMA map could not be made
// (bf16 only).
extern "C" int repro_torch_flash_attention_kv(const void* q, const void* k, const void* v,
                                              void* out, int batch, int seq, int kv_seq,
                                              int heads, int kv_heads, int head_dim, int causal,
                                              int window, float scale, int is_bf16,
                                              void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  namespace f = repro_torch::flash;
  if (is_bf16) {
    if (head_dim <= 64) {
      return f::tc::launch<64>(q, k, v, out, batch, seq, kv_seq, heads, kv_heads, head_dim,
                               causal, window, scale, s);
    }
    return f::tc::launch<128>(q, k, v, out, batch, seq, kv_seq, heads, kv_heads, head_dim,
                              causal, window, scale, s);
  }
  auto run = [&](auto hdp) {
    return f::launch<decltype(hdp)::value>(q, k, v, out, batch, seq, kv_seq, heads, kv_heads,
                                           head_dim, causal, window, scale, s);
  };
  if (head_dim <= 16) return run(std::integral_constant<int, 16>{});
  if (head_dim <= 32) return run(std::integral_constant<int, 32>{});
  if (head_dim <= 64) return run(std::integral_constant<int, 64>{});
  return run(std::integral_constant<int, 128>{});
}

// The entries with one length for queries and keys (kv_seq = seq), with
// and without a window, as before the key length came, so that
// scripts/time_model_kernels.py --against can time an older checkout and
// today's sources through one call.
extern "C" int repro_torch_flash_attention_windowed(const void* q, const void* k, const void* v,
                                                    void* out, int batch, int seq, int heads,
                                                    int kv_heads, int head_dim, int causal,
                                                    int window, float scale, int is_bf16,
                                                    void* stream) {
  return repro_torch_flash_attention_kv(q, k, v, out, batch, seq, seq, heads, kv_heads, head_dim,
                                        causal, window, scale, is_bf16, stream);
}

extern "C" int repro_torch_flash_attention(const void* q, const void* k, const void* v,
                                           void* out, int batch, int seq, int heads,
                                           int kv_heads, int head_dim, int causal,
                                           float scale, int is_bf16, void* stream) {
  return repro_torch_flash_attention_kv(q, k, v, out, batch, seq, seq, heads, kv_heads, head_dim,
                                        causal, 0, scale, is_bf16, stream);
}
