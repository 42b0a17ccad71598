// Shared device helpers of the loader kernels (K1-K3): the counter hash
// of SyntheticDataset.decode, and the row writer that K1 and K2 share.
//
// Bit-exactness rules (the host path SyntheticDataset.decode ->
// augment_np is the anchor, matched bitwise):
//   * every hash step is uint32_t wraparound arithmetic;
//   * the normalize (/255, then per-channel (x - mean) / std) is not
//     computed here at all: K1 and K2 read it from a 768-entry table
//     (entry c * 256 + p is pixel value p of channel c) that the wrappers
//     build once per device and output type with the plain PyTorch
//     version, already rounded to the output type.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace repro_torch {

constexpr uint32_t kHashStep = 0x9E3779B9u;
constexpr uint32_t kHashM1 = 0x7FEB352Du;
constexpr uint32_t kHashM2 = 0x846CA68Bu;

// the xorshift-multiply rounds of the hash on the counter word
// x = base + idx * kHashStep; the low 8 bits are the pixel byte
__device__ __forceinline__ uint32_t hash_rounds(uint32_t x) {
  x ^= x >> 16;
  x *= kHashM1;
  x ^= x >> 15;
  x *= kHashM2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t pixel_hash(uint32_t base, uint32_t idx) {
  return hash_rounds(base + idx * kHashStep) & 0xFFu;
}

// (u8 + mix) % 256 of SyntheticDataset.decode; mix is in [0, 255]
__device__ __forceinline__ uint32_t decode_byte(uint32_t base, uint32_t mix,
                                                uint32_t idx) {
  return (pixel_hash(base, idx) + mix) & 0xFFu;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// K1 and K2: one warp writes one augmented output row at a time.
//
// Output element k of a crop row (k in [0, 3 * crop_w)) is pixel j = k / 3,
// channel c = k % 3, read at offset 3 * src_j + c of the crop row's source
// span, where src_j = flip ? crop_w - 1 - j : j.  From k to k + 1 that
// offset steps by +1, except where c wraps from 2 to 0 under a flip: -5.
// So a lane divides once (by the constant 3) per 16-byte vector and steps
// from there; the value is table[c * 256 + pixel].
constexpr int kLoaderWarps = 8;  // warps, and so rows, per block of K1 and K2
constexpr int kTableSize = 3 * 256;

// The table's and the output's element type as raw bits: uint32_t for
// float32, uint16_t for bfloat16.  kPer elements make one 16-byte store.
template <typename Bits>
struct Vec16 {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(Bits));
};

__device__ __forceinline__ uint4 pack16(const uint32_t (&v)[4]) {
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint4 pack16(const uint16_t (&v)[8]) {
  return make_uint4(v[0] | (static_cast<uint32_t>(v[1]) << 16),
                    v[2] | (static_cast<uint32_t>(v[3]) << 16),
                    v[4] | (static_cast<uint32_t>(v[5]) << 16),
                    v[6] | (static_cast<uint32_t>(v[7]) << 16));
}

// Copy the table into shared memory; the block synchronises after.
template <typename Bits>
__device__ __forceinline__ void load_table(Bits* s_table,
                                           const Bits* __restrict__ table) {
  for (int e = threadIdx.x; e < kTableSize; e += blockDim.x) s_table[e] = table[e];
  __syncthreads();
}

// Writes out[0, 3 * crop_w) of one crop row with the 32 lanes of a warp.
// `Src` maps a source-span offset to a cursor (`at`), an offset step to a
// cursor step (`step`) and a cursor to its pixel value in [0, 255]
// (`pixel`).  Elements before the first 16-byte boundary of `out` and
// after the last are written one by one (at most 2 * (kPer - 1) of them);
// the rest as 16-byte vectors, neighbouring lanes on neighbouring vectors.
template <typename Bits, typename Src>
__device__ __forceinline__ void write_row(Bits* __restrict__ out, int crop_w,
                                          bool flip,
                                          const Bits* __restrict__ s_table,
                                          const Src& src, int lane) {
  constexpr int kPer = Vec16<Bits>::kPer;
  const int row_len = 3 * crop_w;
  const auto addr = reinterpret_cast<uintptr_t>(out);
  const int head = min(static_cast<int>(((16u - (addr & 15u)) & 15u) / sizeof(Bits)),
                       row_len);
  const int n_vec = (row_len - head) / kPer;
  const int tail = head + n_vec * kPer;
  const uint32_t step_same = src.step(1);
  const uint32_t step_wrap = src.step(flip ? -5 : 1);
  for (int v = lane; v < n_vec; v += 32) {
    const int k0 = head + v * kPer;
    const int j = k0 / 3;
    int coff = (k0 - 3 * j) << 8;
    uint32_t cur = src.at(3 * (flip ? crop_w - 1 - j : j) + (coff >> 8));
    Bits vals[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      vals[t] = s_table[coff + src.pixel(cur)];
      const bool wrap = coff == 512;
      cur += wrap ? step_wrap : step_same;
      coff = wrap ? 0 : coff + 256;
    }
    *reinterpret_cast<uint4*>(out + k0) = pack16(vals);
  }
  const int n_scalar = head + (row_len - tail);
  if (lane < n_scalar) {
    const int k = lane < head ? lane : tail + (lane - head);
    const int j = k / 3;
    const int c = k - 3 * j;
    out[k] = s_table[(c << 8) + src.pixel(src.at(3 * (flip ? crop_w - 1 - j : j) + c))];
  }
}

}  // namespace repro_torch
