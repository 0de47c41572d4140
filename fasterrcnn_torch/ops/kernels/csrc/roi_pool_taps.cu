// RoI crop + 2x2 max pool (14x14 bilinear samples -> 7x7), for Hopper (sm_90a).
//
// Replaces the TPU kernel fasterrcnn_tpu/ops/pallas/roi_pallas.py:
// _roi_taps_kernel (wrapper roi_pool_taps_pallas, forward only), with the
// same semantics; the samples are computed in roi_taps_common.cuh, which the
// backward kernel shares, and each output is the max of a 2x2 block of them.
//
// What bounds it on the H100: bytes. At the predict shapes (fm 4x38x50x512,
// 300 RoIs an image) the output (4*300*49*512 values) is ~8x the map, and the
// map (15.6 MB in f32) fits the 50 MB L2, so the least time is the output
// write plus one read of the map at 3.35 TB/s; the arithmetic is ~40 flops
// per output value. The design: one block per (RoI, 128-channel tile), one
// channel per thread, so every read of the NHWC map and every write of the
// (P,7,7,C) output is a run of consecutive channels across a warp
// (coalesced). The 28 sample positions of the RoI are computed once per block
// into shared memory. A sample's four taps are read again by neighbouring
// samples; those re-reads hit L1/L2, not device memory. Tensor cores have no
// use here: each output is a 4-tap stencil, not a product.
//
// Build with -fmad=false: the in-range tests are comparisons on positions
// that must round exactly as the plain PyTorch version rounds them, and each
// two-tap sum is round(round(w_lo * a) + round(w_hi * b)), as the plain
// version's split weight sheets give it, so the output equals the plain
// version's bit for bit in f32 and in bf16.

#include "roi_taps_common.cuh"

namespace {

using namespace roi_taps;

template <typename T>
__global__ void roi_pool_taps_kernel(const T* __restrict__ fm, const float* __restrict__ rois,
                                     const float* __restrict__ norm, T* __restrict__ out,
                                     int h, int w, int c, int p) {
  __shared__ Samples smp;
  const int roi = blockIdx.x;  // b * p + roi index
  const int b = roi / p;
  sample_positions(smp, rois, norm, roi, b, h, w);
  __syncthreads();

  const int ch = blockIdx.y * kThreads + threadIdx.x;
  if (ch >= c) return;
  const T* map = fm + static_cast<size_t>(b) * h * w * c + ch;
  T* dst = out + static_cast<size_t>(roi) * kOut * kOut * c + ch;

  for (int py = 0; py < kOut; ++py) {
    for (int px = 0; px < kOut; ++px) {
      const float a = fmaxf(sample(smp, map, 2 * py, 2 * px, h, w, c),
                            sample(smp, map, 2 * py, 2 * px + 1, h, w, c));
      const float z = fmaxf(sample(smp, map, 2 * py + 1, 2 * px, h, w, c),
                            sample(smp, map, 2 * py + 1, 2 * px + 1, h, w, c));
      store(dst + static_cast<size_t>(py * kOut + px) * c, fmaxf(a, z));
    }
  }
}

}  // namespace

// fm (b, h, w, c) f32 or bf16 NHWC, rois (b, p, 4) f32 pixel corners,
// norm (b, 2) f32, out (b, p, 7, 7, c) in fm's type.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int roi_pool_taps_launch(const void* fm, const void* rois, const void* norm, void* out,
                                    int b, int h, int w, int c, int p, int is_bf16,
                                    void* stream) {
  if (b == 0 || p == 0 || c == 0) return 0;
  const dim3 grid(b * p, (c + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const float* n = static_cast<const float*>(norm);
  if (is_bf16) {
    roi_pool_taps_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(fm), r, n, static_cast<__nv_bfloat16*>(out), h, w, c,
        p);
  } else {
    roi_pool_taps_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(fm), r, n, static_cast<float*>(out), h, w, c, p);
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
