// Sample positions and bilinear samples of the RoI crop (14x14 samples per
// RoI, 2x2 max pool -> 7x7), shared by the forward kernel (roi_pool_taps.cu)
// and its backward (roi_pool_taps_bwd.cu). The backward recomputes the
// forward's samples to find the argmax of each 2x2 window, so both must run
// exactly this arithmetic: one header, both built with -fmad=false.
//
// Semantics: RoI corners (pixels) are scaled onto the real feature grid by
// norm = ((fh-1)/img_h, (fw-1)/img_w); 14 sample positions per axis span each
// RoI inclusively; a sample outside [0, size-1] of the canvas map is 0; a
// sample inside is bilinear over its two y-taps, which are summed in f32 and,
// for a bf16 map, rounded to bf16 before the two x-taps, as the TPU kernel
// rounds its y-interpolated rows. The TPU kernel clamps the low x-tap to
// [0, W-2]; here the high tap is skipped at pos == size-1 instead, on both
// axes, which gives the same value (its weight there is exactly 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace roi_taps {

constexpr int kCrop = 14;
constexpr int kOut = 7;
constexpr int kThreads = 128;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// The y-interpolated value, rounded to the map's type.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// Per sample s along y (index s) and x (index kCrop + s): low tap cell,
// low/high tap weights, and whether the sample lies inside the map. One
// instance per block, in shared memory.
struct Samples {
  int lo_cell[2 * kCrop];
  float w_lo[2 * kCrop];
  float w_hi[2 * kCrop];
  bool inside[2 * kCrop];
};

// Fills `smp` for RoI `roi` of image `b`; threads 0..27 each compute one
// sample position. The caller synchronises the block afterwards.
__device__ __forceinline__ void sample_positions(Samples& smp, const float* __restrict__ rois,
                                                 const float* __restrict__ norm, int roi, int b,
                                                 int h, int w) {
  if (threadIdx.x < 2 * kCrop) {
    const int axis = threadIdx.x / kCrop;  // 0 = y, 1 = x
    const int s = threadIdx.x % kCrop;
    const float scale = norm[2 * b + axis];
    const float lo = rois[4 * roi + axis] * scale;
    const float hi = rois[4 * roi + 2 + axis] * scale;
    const float step = static_cast<float>(s) / static_cast<float>(kCrop - 1);
    const float pos = lo + (hi - lo) * step;
    const int size = axis == 0 ? h : w;
    const float cell = floorf(pos);
    const float frac = pos - cell;
    smp.inside[threadIdx.x] = pos >= 0.0f && pos <= static_cast<float>(size - 1);
    smp.lo_cell[threadIdx.x] = smp.inside[threadIdx.x] ? static_cast<int>(cell) : 0;
    smp.w_lo[threadIdx.x] = 1.0f - frac;
    smp.w_hi[threadIdx.x] = frac;
  }
}

// y-interpolated value of sample row s at map column x, in the map's type.
// `map` points at channel 0 of this thread's channel in image b.
template <typename T>
__device__ __forceinline__ float row(const Samples& smp, const T* map, int s, int x, int h, int w,
                                     int c) {
  const int y = smp.lo_cell[s];
  const T* col = map + static_cast<size_t>(x) * c;
  float v = smp.w_lo[s] * load(col + static_cast<size_t>(y) * w * c);
  if (y + 1 < h) v = v + smp.w_hi[s] * load(col + static_cast<size_t>(y + 1) * w * c);
  return round_to(v, map);
}

// The bilinear sample (s along y, q along x); 0 outside the map.
template <typename T>
__device__ __forceinline__ float sample(const Samples& smp, const T* map, int s, int q, int h,
                                        int w, int c) {
  if (!smp.inside[s] || !smp.inside[kCrop + q]) return 0.0f;
  const int x = smp.lo_cell[kCrop + q];
  float v = smp.w_lo[kCrop + q] * row(smp, map, s, x, h, w, c);
  if (x + 1 < w) v = v + smp.w_hi[kCrop + q] * row(smp, map, s, x + 1, h, w, c);
  return v;
}

}  // namespace roi_taps
