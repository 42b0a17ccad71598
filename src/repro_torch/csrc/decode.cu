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
// Bound on an H100 (3.35 TB/s): both kernels read nothing but five
// scalars per sample, so they are store-bound. At the main path's
// shapes (B=256, 256x256 -> 224x224) K3 writes 50.3 MB (~15 us) and K1
// writes 154.1 MB of float32 (~46 us). The hash is ~10 integer
// operations per byte, far below the integer rate.
//
// Design: one thread per output element on a flat grid. For K3 the
// element's offset inside its image IS the counter index, so neighbour
// threads store neighbour bytes (coalesced). For K1 neighbour threads
// write neighbour floats along cw*3. Nothing is staged in shared
// memory: there is nothing to reuse. Making these faster (wider stores,
// several elements per thread) is later work.
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

template <typename OutT>
__global__ void decode_augment_kernel(
    const int64_t* __restrict__ bases, const int32_t* __restrict__ mixes,
    const int32_t* __restrict__ tops, const int32_t* __restrict__ lefts,
    const int32_t* __restrict__ flips, OutT* __restrict__ out, int img_w,
    int crop_h, int crop_w, int64_t total) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t per_image = static_cast<int64_t>(crop_h) * crop_w * 3;
  const int64_t b = e / per_image;
  const int rem = static_cast<int>(e - b * per_image);
  const int i = rem / (crop_w * 3);
  const int j = (rem / 3) % crop_w;
  const int c = rem % 3;
  const int src_j = flips[b] != 0 ? crop_w - 1 - j : j;
  const uint32_t row = static_cast<uint32_t>(tops[b] + i);
  const uint32_t col = static_cast<uint32_t>(lefts[b] + src_j);
  const uint32_t idx = (row * static_cast<uint32_t>(img_w) + col) * 3u +
                       static_cast<uint32_t>(c);
  const uint32_t pix = decode_byte(static_cast<uint32_t>(bases[b]), mixes[b], idx);
  out[e] = from_float<OutT>(normalize(pix, c));
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
                                          const int32_t* flips, void* out, int batch,
                                          int img_w, int crop_h, int crop_w,
                                          int out_bf16, void* stream) {
  const int64_t total = static_cast<int64_t>(batch) * crop_h * crop_w * 3;
  if (total > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned int grid = repro_torch::grid_for(total);
    if (out_bf16) {
      repro_torch::decode_augment_kernel<__nv_bfloat16>
          <<<grid, repro_torch::kThreads, 0, s>>>(
              bases, mixes, tops, lefts, flips, static_cast<__nv_bfloat16*>(out),
              img_w, crop_h, crop_w, total);
    } else {
      repro_torch::decode_augment_kernel<float><<<grid, repro_torch::kThreads, 0, s>>>(
          bases, mixes, tops, lefts, flips, static_cast<float*>(out), img_w, crop_h,
          crop_w, total);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
