// Crop + horizontal flip + normalize kernel for Hopper (sm_90a).
//
// K2 repro_torch_augment replaces the Pallas kernel
//   src/repro/kernels/augment/kernel.py::augment (_augment_kernel):
//   (B, H, W, 3) uint8 images + per-sample (top, left, flip) int32 ->
//   (B, ch, cw, 3) float32 or bfloat16: crop window, mirrored columns
//   under flip, /255, per-channel (x - mean) / std.
//
// Bound on an H100 SXM at its 700 W limit (data sheet: 3.35 TB/s): bytes,
// with no reuse and no arithmetic that the function needs beyond a
// lookup.  At the main path's shapes (B=256, 256x256 -> 224x224) it must
// read the 38.5 MB of crop windows and write 154.1 MB of float32 (57 us),
// or 77.1 MB of bfloat16 (34 us).
//
// Design: one warp per output row (common.cuh write_row), a grid of
// (image, tile of 8 rows), so the three scalars and all 64-bit
// arithmetic are per block.  A warp first stages its crop row's
// 3 * crop_w source bytes, which start at any byte offset, into its own
// shared-memory buffer: the 16-byte-aligned chunks inside the span with
// 16-byte loads (neighbouring lanes on neighbouring chunks), the at most
// 15 bytes before and after them one by one, each byte read once.  It
// then writes 16-byte vectors of the output, reading each element's byte
// from the buffer (mirrored under flip) and its normalized value from a
// 768-entry table in shared memory (built by the wrapper; no float
// division on the card).  The TPU kernel staged each whole image in VMEM;
// here a row is all a warp needs, and the loads of many rows are in
// flight at once because many small blocks are.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

// K2's source: the staged crop row; the cursor is an index into the
// warp's buffer, which holds span byte o at lead + o.
struct StagedRow {
  const uint8_t* buf;
  int lead;
  __device__ __forceinline__ uint32_t at(int off) const {
    return static_cast<uint32_t>(lead + off);
  }
  __device__ __forceinline__ uint32_t step(int d) const {
    return static_cast<uint32_t>(d);
  }
  __device__ __forceinline__ uint32_t pixel(uint32_t i) const { return buf[i]; }
};

// Bytes of one warp's row buffer: the span plus up to 15 bytes of lead,
// rounded up to a 16-byte multiple.
__host__ __device__ __forceinline__ int row_buffer_bytes(int crop_w) {
  return (3 * crop_w + 15 + 15) & ~15;
}

__device__ __forceinline__ int lead_of(const uint8_t* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15u);
}

// Stage the span [src, src + n) at buf[lead + o], lead = src % 16.
__device__ __forceinline__ void stage_row(uint8_t* __restrict__ buf,
                                          const uint8_t* __restrict__ src, int n,
                                          int lane) {
  const int lead = lead_of(src);
  const uint8_t* base16 = src - lead;  // only bytes of the span are read
  const int end = lead + n;
  const int first = (lead + 15) >> 4;   // chunks [first, last) lie inside
  const int last = end >> 4;
  for (int q = first + lane; q < last; q += 32) {
    *reinterpret_cast<uint4*>(buf + 16 * q) =
        __ldg(reinterpret_cast<const uint4*>(base16 + 16 * q));
  }
  const int head_end = min(16 * first, end);
  const int tail_start = max(16 * last, head_end);
  if (lane < head_end - lead) buf[lead + lane] = src[lane];
  if (lane >= 16 && lane - 16 < end - tail_start) {
    buf[tail_start + lane - 16] = base16[tail_start + lane - 16];
  }
}

// Grid (batch, tiles of kLoaderWarps rows); warp w stages and writes row
// tile * kLoaderWarps + w of its image.
template <typename Bits>
__global__ void __launch_bounds__(kLoaderWarps * 32)
    augment_kernel(const uint8_t* __restrict__ images,
                   const int32_t* __restrict__ tops,
                   const int32_t* __restrict__ lefts,
                   const int32_t* __restrict__ flips,
                   const Bits* __restrict__ table, Bits* __restrict__ out,
                   int img_h, int img_w, int crop_h, int crop_w) {
  extern __shared__ __align__(16) uint8_t smem[];
  Bits* s_table = reinterpret_cast<Bits*>(smem);
  load_table(s_table, table);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.y * kLoaderWarps + warp;
  if (i >= crop_h) return;
  const int b = blockIdx.x;
  const int row_len = 3 * crop_w;
  const uint8_t* src = images + static_cast<int64_t>(b) * img_h * img_w * 3 +
                       ((tops[b] + i) * img_w + lefts[b]) * 3;
  uint8_t* buf = smem + kTableSize * sizeof(Bits) + warp * row_buffer_bytes(crop_w);
  stage_row(buf, src, row_len, lane);
  __syncwarp();
  Bits* row = out + static_cast<int64_t>(b) * crop_h * row_len + i * row_len;
  write_row(row, crop_w, flips[b] != 0, s_table, StagedRow{buf, lead_of(src)}, lane);
}

template <typename Bits>
int launch(const uint8_t* images, const int32_t* tops, const int32_t* lefts,
           const int32_t* flips, const void* table, void* out, int batch,
           int img_h, int img_w, int crop_h, int crop_w, cudaStream_t s) {
  // a crop too wide for the card's 227 KB of shared memory per block is
  // refused here, and the wrapper raises
  const int smem = kTableSize * sizeof(Bits) + kLoaderWarps * row_buffer_bytes(crop_w);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        augment_kernel<Bits>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(batch, (crop_h + kLoaderWarps - 1) / kLoaderWarps);
  augment_kernel<Bits><<<grid, kLoaderWarps * 32, smem, s>>>(
      images, tops, lefts, flips, static_cast<const Bits*>(table),
      static_cast<Bits*>(out), img_h, img_w, crop_h, crop_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

extern "C" int repro_torch_augment(const uint8_t* images, const int32_t* tops,
                                   const int32_t* lefts, const int32_t* flips,
                                   const void* table, void* out, int batch, int img_h,
                                   int img_w, int crop_h, int crop_w, int out_bf16,
                                   void* stream) {
  using namespace repro_torch;
  if (batch <= 0 || crop_h <= 0 || crop_w <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<uint16_t>(images, tops, lefts, flips, table, out, batch,
                                     img_h, img_w, crop_h, crop_w, s)
                  : launch<uint32_t>(images, tops, lefts, flips, table, out, batch,
                                     img_h, img_w, crop_h, crop_w, s);
}
