// Counter-hash "JPEG decode" kernels for Hopper (sm_90a).
//
// K3 repro_torch_decode replaces the Pallas kernel
//   src/repro/kernels/decode/kernel.py::decode (_decode_kernel):
//   (B,) uint32 base seeds + (B,) int32 header mixes -> (B, h, w, 3) uint8,
//   byte-identical to SyntheticDataset.decode.
// K1 repro_torch_decode_augment replaces the Pallas kernel
//   src/repro/kernels/decode/kernel.py::decode_augment
//   (_decode_augment_kernel): hashes only the crop window's source pixels
//   (a flip mirrors the source column), then (u8 + mix) % 256, /255 and
//   the per-channel normalize -> (B, ch, cw, 3) float32 or bfloat16.
//
// Bound on an H100 SXM at its 700 W limit (data sheet: 3.35 TB/s; 132
// SMs at the 1.98 GHz maximum SM clock): both kernels read nothing but
// five scalars per sample.  Each hashed byte costs three shifts and three
// xors on the ALU pipe (64 lanes per SM, 16.7 T operations/s), plus the
// mask of the table index in K1 (K3's byte store needs none), and beside
// them on the FMA pipe the counter word (one add when the counter steps),
// two multiplies and the mix add: 10 integer operations in K3 and 11 in
// K1, against an issue rate of 128 lanes per SM (33.5 T/s).  The ALU
// pipe's share is the longer.  At the main path's shapes (B=256,
// 256x256 -> 224x224):
//   K3 writes 50.3 MB (15 us) and hashes 50.3 M bytes, 6 ALU operations
//     each (18 us): bound by integer operations;
//   K1 writes 154.1 MB of float32 (46 us) or 77.1 MB of bfloat16 (23 us)
//     and hashes 38.5 M bytes, 7 ALU operations each (16 us): bound by
//     bytes in both.
//
// Design of K1: one warp per output row (common.cuh write_row), a grid of
// (image, tile of 8 rows), so the five scalars and all 64-bit arithmetic
// are per block and every index inside an image is 32-bit.  A lane writes
// 16-byte vectors (4 floats or 8 bfloat16) with one division by 3 per
// vector; per element it steps the counter word by one add, runs the hash
// rounds and reads the normalize from a 768-entry table in shared memory
// (no float division on the card; the table is built by the wrapper).
// Unaligned row ends go element by element.  K3 is the first form: one
// thread per output byte on a flat grid, the byte's offset in its image
// being its counter index.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

__global__ void decode_kernel(const int64_t* __restrict__ bases,
                              const int32_t* __restrict__ mixes,
                              uint8_t* __restrict__ out, int64_t per_image,
                              int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t b = e / per_image;
  const uint32_t idx = static_cast<uint32_t>(e - b * per_image);
  const uint32_t base = static_cast<uint32_t>(bases[b]);
  out[e] = static_cast<uint8_t>(decode_byte(base, mixes[b], idx));
}

// K1's source: the counter hash of the crop row's source pixels; the
// cursor is the counter word base + idx * kHashStep itself, so a step of
// the offset is one add.
struct HashRow {
  uint32_t x_row;  // base + (first source index of the row) * kHashStep
  uint32_t mix;
  __device__ __forceinline__ uint32_t at(int off) const {
    return x_row + static_cast<uint32_t>(off) * kHashStep;
  }
  __device__ __forceinline__ uint32_t step(int d) const {
    return static_cast<uint32_t>(d) * kHashStep;
  }
  __device__ __forceinline__ uint32_t pixel(uint32_t x) const {
    return (hash_rounds(x) + mix) & 0xFFu;
  }
};

// Grid (batch, tiles of kLoaderWarps rows); warp w writes row
// tile * kLoaderWarps + w of its image.
template <typename Bits>
__global__ void __launch_bounds__(kLoaderWarps * 32)
    decode_augment_kernel(const int64_t* __restrict__ bases,
                          const int32_t* __restrict__ mixes,
                          const int32_t* __restrict__ tops,
                          const int32_t* __restrict__ lefts,
                          const int32_t* __restrict__ flips,
                          const Bits* __restrict__ table, Bits* __restrict__ out,
                          int img_w, int crop_h, int crop_w) {
  __shared__ Bits s_table[kTableSize];
  load_table(s_table, table);
  const int b = blockIdx.x;
  const uint32_t base = static_cast<uint32_t>(bases[b]);
  const uint32_t mix = static_cast<uint32_t>(mixes[b]);
  const int top = tops[b], left = lefts[b];
  const bool flip = flips[b] != 0;
  const int i = blockIdx.y * kLoaderWarps + (threadIdx.x >> 5);
  if (i >= crop_h) return;
  const int row_len = 3 * crop_w;
  Bits* row = out + static_cast<int64_t>(b) * crop_h * row_len + i * row_len;
  const uint32_t idx0 = (static_cast<uint32_t>(top + i) * static_cast<uint32_t>(img_w) +
                         static_cast<uint32_t>(left)) * 3u;
  write_row(row, crop_w, flip, s_table, HashRow{base + idx0 * kHashStep, mix},
            threadIdx.x & 31);
}

}  // namespace repro_torch

extern "C" int repro_torch_decode(const int64_t* bases, const int32_t* mixes,
                                  uint8_t* out, int batch, int h, int w,
                                  void* stream) {
  const int64_t per_image = static_cast<int64_t>(h) * w * 3;
  const int64_t total = per_image * batch;
  if (total > 0) {
    repro_torch::decode_kernel<<<repro_torch::grid_for(total), repro_torch::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        bases, mixes, out, per_image, total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_torch_decode_augment(const int64_t* bases, const int32_t* mixes,
                                          const int32_t* tops, const int32_t* lefts,
                                          const int32_t* flips, const void* table,
                                          void* out, int batch, int img_w, int crop_h,
                                          int crop_w, int out_bf16, void* stream) {
  using namespace repro_torch;
  if (batch > 0 && crop_h > 0 && crop_w > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid(batch, (crop_h + kLoaderWarps - 1) / kLoaderWarps);
    if (out_bf16) {
      decode_augment_kernel<uint16_t><<<grid, kLoaderWarps * 32, 0, s>>>(
          bases, mixes, tops, lefts, flips, static_cast<const uint16_t*>(table),
          static_cast<uint16_t*>(out), img_w, crop_h, crop_w);
    } else {
      decode_augment_kernel<uint32_t><<<grid, kLoaderWarps * 32, 0, s>>>(
          bases, mixes, tops, lefts, flips, static_cast<const uint32_t*>(table),
          static_cast<uint32_t*>(out), img_w, crop_h, crop_w);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
