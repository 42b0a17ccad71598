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
// mask of the table index in K1, and beside them on the FMA pipe the
// counter word (one add when the counter steps), two multiplies and the
// mix add: 10 integer operations in K3 and 11 in K1, against an issue
// rate of 128 lanes per SM (33.5 T/s).  The ALU pipe's share is the
// longer.  At the main path's shapes (B=256, 256x256 -> 224x224):
//   K3 writes 50.3 MB (15 us) and hashes 50.3 M bytes, 6 ALU operations
//     each (18 us): bound by integer operations;
//   K1 writes 154.1 MB of float32 (46 us) or 77.1 MB of bfloat16 (23 us)
//     and hashes 38.5 M bytes, 7 ALU operations each (16 us): bound by
//     bytes in both.
// The bounds count the function's work, not a kernel's: K3's packing of
// bytes into words (below) is the price of its 16-byte stores and is not
// in them.
//
// Design of K3: a grid of (chunk of an image's bytes, image), the images
// walked with a stride of gridDim.y, so base, mix and the image's 64-bit
// offset are read and formed once per block and every index inside an
// image is 32-bit (the wrapper refuses h * w * 3 >= 2**31); nothing is
// divided.  A thread writes kDecodeVecs 16-byte vectors, neighbouring
// threads on neighbouring vectors.  Per vector it forms the counter word
// base + k0 * kHashStep once and steps it by one add per byte; it adds
// mix to the whole hashed word, since (x + mix) & 0xFF equals
// ((x & 0xFF) + mix) & 0xFF, and packs the low bytes of four words into
// one with three byte permutes (PRMT); for masks, shifts and ors nvcc
// emits the same permutes (scripts/time_model_kernels.py --loader
// --variants prints both SASS mixes).  Per byte the compiled code issues
// the hash's 3 shifts and 3 xors and 0.75 permutes on the ALU pipe, the
// stores alone take ~0.021 ms on an H100 at the main path's shapes.  Where
// h * w * 3 % 16 != 0 the images start at every offset mod 16: the bytes
// before an image's first 16-byte boundary and after its last (at most
// 30) are written one by one by the block of the image's first chunk.
//
// Design of K1: one warp per output row (common.cuh write_row), a grid of
// (image, tile of 8 rows), so the five scalars and all 64-bit arithmetic
// are per block and every index inside an image is 32-bit.  A lane writes
// 16-byte vectors (4 floats or 8 bfloat16) with one division by 3 per
// vector; per element it steps the counter word by one add, runs the hash
// rounds and reads the normalize from a 768-entry table in shared memory
// (no float division on the card; the table is built by the wrapper).
// Unaligned row ends go element by element.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

constexpr int kDecodeThreads = 256;
constexpr int kDecodeVecs = 4;  // 16-byte vectors per thread: 16 KiB per block

// The low bytes of four words as one word, w0's in its low byte: in
// memory (little-endian) w0's byte comes first.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t w0, uint32_t w1,
                                                   uint32_t w2, uint32_t w3) {
  return __byte_perm(__byte_perm(w0, w1, 0x0040), __byte_perm(w2, w3, 0x0040),
                     0x5410);
}

// Grid (chunks, images): block (c, y) writes vectors
// [c, c + 1) * kDecodeVecs * kDecodeThreads of images y, y + gridDim.y, ...
__global__ void __launch_bounds__(kDecodeThreads)
    decode_kernel(const int64_t* __restrict__ bases,
                  const int32_t* __restrict__ mixes, uint8_t* __restrict__ out,
                  uint32_t per_image, int batch) {
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const uint32_t base = static_cast<uint32_t>(bases[b]);
    const uint32_t mix = static_cast<uint32_t>(mixes[b]);
    uint8_t* img = out + static_cast<int64_t>(b) * per_image;
    const uint32_t head =
        min((16u - (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(img)) & 15u)) & 15u,
            per_image);
    const uint32_t n_vec = (per_image - head) >> 4;
    uint4* vecs = reinterpret_cast<uint4*>(img + head);
    const uint32_t v0 = blockIdx.x * (kDecodeVecs * kDecodeThreads) + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kDecodeVecs; ++i) {
      const uint32_t v = v0 + i * kDecodeThreads;
      if (v >= n_vec) break;
      uint32_t x = base + (head + (v << 4)) * kHashStep;
      uint32_t words[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          h[j] = hash_rounds(x) + mix;
          x += kHashStep;
        }
        words[q] = pack_low_bytes(h[0], h[1], h[2], h[3]);
      }
      vecs[v] = make_uint4(words[0], words[1], words[2], words[3]);
    }
    if (blockIdx.x == 0) {
      const uint32_t tail = head + (n_vec << 4);
      if (threadIdx.x < head + (per_image - tail)) {
        const uint32_t k = threadIdx.x < head ? threadIdx.x : tail + (threadIdx.x - head);
        img[k] = static_cast<uint8_t>(decode_byte(base, mix, k));
      }
    }
  }
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
  using namespace repro_torch;
  const int64_t per_image = static_cast<int64_t>(h) * w * 3;
  if (per_image >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && per_image > 0) {
    constexpr int64_t kVecsPerBlock = kDecodeVecs * kDecodeThreads;
    const int64_t chunks = (per_image / 16 + kVecsPerBlock - 1) / kVecsPerBlock;
    const dim3 grid(static_cast<unsigned int>(chunks > 0 ? chunks : 1),
                    static_cast<unsigned int>(batch < 65535 ? batch : 65535));
    decode_kernel<<<grid, kDecodeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        bases, mixes, out, static_cast<uint32_t>(per_image), batch);
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
