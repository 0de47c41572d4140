// Backward of the RoI crop + 2x2 max pool with respect to the feature map,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel fasterrcnn_tpu/ops/pallas/roi_pallas.py:
// _roi_taps_bwd_kernel (wrapper roi_pool_taps_pallas_bwd). Same semantics:
// each 7x7 output's cotangent is split equally among the samples of its 2x2
// window that equal the window's max (all four counted, samples outside the
// map included), and each tied sample inside the map passes its share, times
// its x-tap weight and then its y-tap weight, to the (up to) four map cells it
// was interpolated from. The RoIs and norm get no cotangent: proposals are
// constants of the train step. The bf16 rounding of the forward's
// y-interpolated rows is passed through as the identity, as on the TPU.
//
// What bounds it on the H100: bytes. At the train shape (fm 4x38x50x512, 128
// RoIs an image) it reads g (4*128*49*512 values, ~3.3x the map) and the map
// once each and writes the f32 cotangent of the map; ~70 flops per output.
// The design mirrors the forward kernel: one block per (RoI, 128-channel
// tile), one channel per thread, so every read and every update is a run of
// consecutive channels across a warp. The forward's samples are recomputed
// with the forward's own code (roi_taps_common.cuh), built with -fmad=false
// like it, so every argmax and tie decision matches the forward's bit for
// bit. The TPU kernel accumulates a whole image's cotangent in VMEM across a
// sequential grid; here the blocks of one image run in parallel, so they add
// into an f32 map in device memory (zeroed by the wrapper) with atomicAdd.
// The order of those additions changes from run to run, and so do the last
// bits of the result. Usually one sample of a window wins, so each output
// costs four atomics, which land in the 50 MB L2 with the f32 map (15.6 MB).

#include "roi_taps_common.cuh"

namespace {

using namespace roi_taps;

// Adds share * w_x * w_y to the up to four cells of sample (s, q).
__device__ __forceinline__ void scatter(const Samples& smp, float* grad, int s, int q, float share,
                                        int h, int w, int c) {
  const int y = smp.lo_cell[s];
  const int x = smp.lo_cell[kCrop + q];
  const float gx_lo = share * smp.w_lo[kCrop + q];
  const float gx_hi = share * smp.w_hi[kCrop + q];
  float* cell = grad + (static_cast<size_t>(y) * w + x) * c;
  atomicAdd(cell, gx_lo * smp.w_lo[s]);
  if (x + 1 < w) atomicAdd(cell + c, gx_hi * smp.w_lo[s]);
  if (y + 1 < h) {
    float* below = cell + static_cast<size_t>(w) * c;
    atomicAdd(below, gx_lo * smp.w_hi[s]);
    if (x + 1 < w) atomicAdd(below + c, gx_hi * smp.w_hi[s]);
  }
}

template <typename T>
__global__ void roi_pool_taps_bwd_kernel(const T* __restrict__ fm, const float* __restrict__ rois,
                                         const float* __restrict__ norm, const T* __restrict__ g,
                                         float* __restrict__ gfm, int h, int w, int c, int p) {
  __shared__ Samples smp;
  const int roi = blockIdx.x;  // b * p + roi index
  const int b = roi / p;
  sample_positions(smp, rois, norm, roi, b, h, w);
  __syncthreads();

  const int ch = blockIdx.y * kThreads + threadIdx.x;
  if (ch >= c) return;
  const size_t image = static_cast<size_t>(b) * h * w * c + ch;
  const T* map = fm + image;
  float* grad = gfm + image;
  const T* gout = g + static_cast<size_t>(roi) * kOut * kOut * c + ch;

  for (int py = 0; py < kOut; ++py) {
    for (int px = 0; px < kOut; ++px) {
      float v[4];
      for (int k = 0; k < 4; ++k) v[k] = sample(smp, map, 2 * py + k / 2, 2 * px + k % 2, h, w, c);
      // The forward's max, in the forward's order.
      const float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
      int ties = 0;
      for (int k = 0; k < 4; ++k) ties += v[k] == m;
      const float share =
          load(gout + static_cast<size_t>(py * kOut + px) * c) / static_cast<float>(ties);
      for (int k = 0; k < 4; ++k) {
        const int s = 2 * py + k / 2;
        const int q = 2 * px + k % 2;
        if (v[k] == m && smp.inside[s] && smp.inside[kCrop + q]) {
          scatter(smp, grad, s, q, share, h, w, c);
        }
      }
    }
  }
}

}  // namespace

// fm (b, h, w, c) f32 or bf16 NHWC, rois (b, p, 4) f32 pixel corners,
// norm (b, 2) f32, g (b, p, 7, 7, c) in fm's type; gfm (b, h, w, c) f32,
// zeroed by the caller, receives the cotangent of fm.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int roi_pool_taps_bwd_launch(const void* fm, const void* rois, const void* norm,
                                        const void* g, void* gfm, int b, int h, int w, int c,
                                        int p, int is_bf16, void* stream) {
  if (b == 0 || p == 0 || c == 0) return 0;
  const dim3 grid(b * p, (c + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const float* n = static_cast<const float*>(norm);
  float* out = static_cast<float*>(gfm);
  if (is_bf16) {
    roi_pool_taps_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(fm), r, n, static_cast<const __nv_bfloat16*>(g), out, h,
        w, c, p);
  } else {
    roi_pool_taps_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(fm), r, n, static_cast<const float*>(g), out, h, w, c, p);
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
