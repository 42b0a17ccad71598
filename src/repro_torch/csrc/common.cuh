// Shared device helpers of the decode and augment kernels: the counter
// hash of SyntheticDataset.decode and the exact float pipeline of
// augment_np (/255, then per-channel (x - mean) / std).
//
// Bit-exactness rules (the host path SyntheticDataset.decode ->
// augment_np is the anchor, matched bitwise):
//   * every hash step is uint32_t wraparound arithmetic;
//   * every division is a correctly rounded IEEE division (__fdiv_rn),
//     never a multiplication by a reciprocal, and the build never uses
//     --use_fast_math;
//   * the constants are the float32 bit patterns of np.float32(MEAN),
//     np.float32(STD) and 255.0, written as hex so no compiler rounds a
//     decimal literal differently.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace repro_torch {

constexpr uint32_t kHashStep = 0x9E3779B9u;
constexpr uint32_t kHashM1 = 0x7FEB352Du;
constexpr uint32_t kHashM2 = 0x846CA68Bu;

__device__ __forceinline__ uint32_t pixel_hash(uint32_t base, uint32_t idx) {
  uint32_t x = base + idx * kHashStep;
  x ^= x >> 16;
  x *= kHashM1;
  x ^= x >> 15;
  x *= kHashM2;
  x ^= x >> 16;
  return x & 0xFFu;
}

// (u8 + mix) % 256 of SyntheticDataset.decode; mix is in [0, 255]
__device__ __forceinline__ uint32_t decode_byte(uint32_t base, int32_t mix,
                                                uint32_t idx) {
  return (pixel_hash(base, idx) + static_cast<uint32_t>(mix)) & 0xFFu;
}

__device__ __forceinline__ float channel_mean(int c) {
  return __uint_as_float(c == 0 ? 0x3ef851ecu : c == 1 ? 0x3ee978d5u
                                                       : 0x3ecfdf3bu);
}

__device__ __forceinline__ float channel_std(int c) {
  return __uint_as_float(c == 0 ? 0x3e6a7efau : c == 1 ? 0x3e656042u
                                                       : 0x3e666666u);
}

// uint8 pixel of channel c -> normalized float32, bitwise equal to
// (np.float32(p) / 255.0 - MEAN[c]) / STD[c] in numpy
__device__ __forceinline__ float normalize(uint32_t pix, int c) {
  const float x = __fdiv_rn(static_cast<float>(pix), __uint_as_float(0x437f0000u));
  return __fdiv_rn(__fsub_rn(x, channel_mean(c)), channel_std(c));
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

constexpr int kThreads = 256;

inline unsigned int grid_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace repro_torch
