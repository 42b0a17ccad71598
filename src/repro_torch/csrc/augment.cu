// Crop + horizontal flip + normalize kernel for Hopper (sm_90a).
//
// K2 repro_torch_augment replaces the Pallas kernel
//   src/repro/kernels/augment/kernel.py::augment (_augment_kernel):
//   (B, H, W, 3) uint8 images + per-sample (top, left, flip) int32 ->
//   (B, ch, cw, 3) float32 or bfloat16: crop window, mirrored columns
//   under flip, /255, per-channel (x - mean) / std.
//
// Bound on an H100 (3.35 TB/s): store- and load-bound with no reuse.
// At the main path's shapes (B=256, 256x256 -> 224x224) it must read the
// 38.5 MB of crop windows and write 154.1 MB of float32 (~57 us), or
// 77.1 MB of bfloat16 (~34 us).
//
// Design: one thread per output element on a flat grid; neighbour
// threads read neighbour bytes of one image row (mirrored under flip,
// still one contiguous span per warp) and write neighbour outputs.
// The TPU kernel staged each whole image in VMEM; here nothing is
// staged, because each source byte is read once. Vectorized loads and
// stores are later work.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {

template <typename OutT>
__global__ void augment_kernel(const uint8_t* __restrict__ images,
                               const int32_t* __restrict__ tops,
                               const int32_t* __restrict__ lefts,
                               const int32_t* __restrict__ flips,
                               OutT* __restrict__ out, int img_h, int img_w,
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
  const int64_t src = ((b * img_h + tops[b] + i) * img_w + lefts[b] + src_j) * 3 + c;
  out[e] = from_float<OutT>(normalize(images[src], c));
}

}  // namespace repro_torch

extern "C" int repro_torch_augment(const uint8_t* images, const int32_t* tops,
                                   const int32_t* lefts, const int32_t* flips,
                                   void* out, int batch, int img_h, int img_w,
                                   int crop_h, int crop_w, int out_bf16,
                                   void* stream) {
  const int64_t total = static_cast<int64_t>(batch) * crop_h * crop_w * 3;
  if (total > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const unsigned int grid = repro_torch::grid_for(total);
    if (out_bf16) {
      repro_torch::augment_kernel<__nv_bfloat16><<<grid, repro_torch::kThreads, 0, s>>>(
          images, tops, lefts, flips, static_cast<__nv_bfloat16*>(out), img_h, img_w,
          crop_h, crop_w, total);
    } else {
      repro_torch::augment_kernel<float><<<grid, repro_torch::kThreads, 0, s>>>(
          images, tops, lefts, flips, static_cast<float*>(out), img_h, img_w, crop_h,
          crop_w, total);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
