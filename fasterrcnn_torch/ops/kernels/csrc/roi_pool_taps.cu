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
// per output value. The design: one thread per lane of V channels (4 f32
// or 8 bf16: every map read and every output write is one 16-byte access,
// consecutive across a warp), one warp per pooled row py of a RoI, and one
// block of 7 warps per (RoI, chunk of 32 lanes): at C=512 that is 4 (f32)
// or 2 (bf16) blocks a RoI. The warps of a block walk neighbouring sample
// rows of one RoI side by side, so a map row that two of them read can
// reach the SM from L2 once. A thread walks its two sample rows once along
// the RoI's tap columns (XWalk, walk_pairs in roi_taps_common.cuh),
// y-interpolating each column once, keeping the last two, and loading the
// next column's taps before it computes the current one; each pooled
// output is stored when its window's last sample completes. The 28 sample
// positions of the RoI are computed by the block into shared memory. bf16
// values are rounded two at a time (one packed conversion). Tensor cores
// have no use here: each output is a 4-tap stencil, not a product.
//
// Build with -fmad=false: the in-range tests are comparisons on positions
// that must round exactly as the plain PyTorch version rounds them, and each
// two-tap sum is round(round(w_lo * a) + round(w_hi * b)), as the plain
// version's split weight sheets give it (in bf16 with the weights, each
// x-tap product and the x-sum rounded to bf16 too, as roi_taps_common.cuh
// says), so the output equals the plain version's bit for bit in f32 and in
// bf16, whatever the lane width.

#include "roi_taps_common.cuh"

namespace {

using namespace roi_taps;

template <typename T, int V>
__global__ void __launch_bounds__(kChunkLanes * kOut) roi_pool_taps_kernel(
    const T* __restrict__ fm, const float* __restrict__ rois, const float* __restrict__ norm,
    T* __restrict__ out, int h, int w, int c, int p) {
  __shared__ Samples smp;
  const int chunks = lane_chunks(c, V);
  const int roi = blockIdx.x / chunks;  // b * p + roi index
  const int b = roi / p;
  sample_positions<T>(smp, rois, norm, roi, b, h, w);
  __syncthreads();
  const int py = threadIdx.y;
  const int lane = (blockIdx.x % chunks) * kChunkLanes + threadIdx.x;
  if (lane * V >= c) return;

  const T* map = fm + static_cast<size_t>(b) * h * w * c + lane * V;
  T* dst = out + (static_cast<size_t>(roi) * kOut + py) * kOut * c + lane * V;
  const XWalk wk(smp, w);
  walk_pairs<T, V>(wk, smp, map, py, h, w, c,
                   [&](int j, const float (&t0)[V], const float (&t1)[V], const float (&b0)[V],
                       const float (&b1)[V]) {
                     float m[V];
#pragma unroll
                     for (int i = 0; i < V; ++i) m[i] = fmaxf(fmaxf(t0[i], t1[i]), fmaxf(b0[i], b1[i]));
                     store_lanes<T, V>(dst + static_cast<size_t>(wk.q(j) / 2) * c, m);
                   });
}

template <typename T, int V>
void launch(const void* fm, const float* rois, const float* norm, void* out, int b, int h, int w,
            int c, int p, cudaStream_t s) {
  roi_pool_taps_kernel<T, V><<<b * p * lane_chunks(c, V), dim3(kChunkLanes, kOut), 0, s>>>(
      static_cast<const T*>(fm), rois, norm, static_cast<T*>(out), h, w, c, p);
}

}  // namespace

// fm (b, h, w, c) f32 or bf16 NHWC, rois (b, p, 4) f32 pixel corners,
// norm (b, 2) f32, out (b, p, 7, 7, c) in fm's type. vec is the lane width:
// 16 / element size (c a multiple of it, fm and out 16-byte aligned) or 1.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int roi_pool_taps_launch(const void* fm, const void* rois, const void* norm, void* out,
                                    int b, int h, int w, int c, int p, int is_bf16, int vec,
                                    void* stream) {
  if (b == 0 || p == 0 || c == 0) return 0;
  if (vec != 1 && (vec != (is_bf16 ? 8 : 4) || c % vec != 0 || !aligned(fm, 16) || !aligned(out, 16))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const float* n = static_cast<const float*>(norm);
  if (is_bf16) {
    if (vec == 1) launch<__nv_bfloat16, 1>(fm, r, n, out, b, h, w, c, p, s);
    else launch<__nv_bfloat16, 8>(fm, r, n, out, b, h, w, c, p, s);
  } else {
    if (vec == 1) launch<float, 1>(fm, r, n, out, b, h, w, c, p, s);
    else launch<float, 4>(fm, r, n, out, b, h, w, c, p, s);
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
