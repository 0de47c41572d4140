// RoI crop + 2x2 max pool (14x14 bilinear samples -> 7x7) with the fused
// kernel's rounding, for Hopper (sm_90a).
//
// Replaces the TPU kernel fasterrcnn_tpu/ops/pallas/roi_pallas.py:
// _roi_kernel (wrapper roi_pool_fused_pallas, forward only). Its function is
// roi_pool_taps.cu's, rounded where the TPU kernel rounds: the y-sum in f32
// rounded to the map's type (:114-120), and the x-sum of the two exact tap
// products in f32, rounded once (:124-133), where the taps kernel rounds each
// x-tap product too. In f32 the two kernels agree bit for bit.
//
// What bounds it on the H100: bytes, as for roi_pool_taps.cu: at the predict
// shapes (fm 4x38x50x512, 300 RoIs an image) the output is ~8x the map, and
// each output takes ~40 flops. The TPU kernel builds a dense (14, H) y-sheet
// and (14, W) x-sheet per RoI and contracts both against the whole map on
// its MXU, where a dense product is the cheap form; on the CUDA cores the
// same sheets cost 14*H*W + 14*14*W multiply-adds per RoI and channel
// (~36,000 at 38x50) for a function that reads ~84 map values, and they
// held the map's width to what fits in shared memory. So the sheets are not
// carried over: this kernel is the taps kernel's design, the shared column
// walk (XWalk, walk_pairs in roi_taps_common.cuh) with K4's rounding policy
// (kRoundTaps = false): a thread a lane of V channels (4 f32 or 8 bf16: one
// 16-byte access, or 1 where C or alignment forbids), a warp a pooled row,
// a block of 7 warps a (RoI, chunk of 32 lanes), each sample row walked
// once over the RoI's tap columns, each pooled output stored when its
// window's last sample completes. Any map width runs.
//
// Contract: a sample reads only its taps. A map holding inf or NaN outside
// a RoI's taps does not spread it into that RoI, as the dense sheets (and
// roi_pool_fused_plain's einsums) do through a zero weight (0 * inf is
// NaN); on finite maps the output equals the plain version's bit for bit.
//
// Build with -fmad=false: the in-range tests are comparisons on positions
// that must round exactly as the plain PyTorch version rounds them, and the
// x-sum w_lo * a + w_hi * b must not fuse into an FMA.

#include "roi_taps_common.cuh"

namespace {

using namespace roi_taps;

template <typename T, int V>
__global__ void __launch_bounds__(kChunkLanes * kOut) roi_pool_fused_kernel(
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
  walk_pairs<T, V, /*kRoundTaps=*/false>(
      wk, smp, map, py, h, w, c,
      [&](int j, const float (&t0)[V], const float (&t1)[V], const float (&b0)[V], const float (&b1)[V]) {
        float m[V];
#pragma unroll
        for (int i = 0; i < V; ++i) m[i] = fmaxf(fmaxf(t0[i], t1[i]), fmaxf(b0[i], b1[i]));
        store_lanes<T, V>(dst + static_cast<size_t>(wk.q(j) / 2) * c, m);
      });
}

template <typename T, int V>
void launch(const void* fm, const float* rois, const float* norm, void* out, int b, int h, int w,
            int c, int p, cudaStream_t s) {
  roi_pool_fused_kernel<T, V><<<b * p * lane_chunks(c, V), dim3(kChunkLanes, kOut), 0, s>>>(
      static_cast<const T*>(fm), rois, norm, static_cast<T*>(out), h, w, c, p);
}

}  // namespace

// fm (b, h, w, c) f32 or bf16 NHWC, rois (b, p, 4) f32 pixel corners,
// norm (b, 2) f32, out (b, p, 7, 7, c) in fm's type. vec is the lane width:
// 16 / element size (c a multiple of it, fm and out 16-byte aligned) or 1.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int roi_pool_fused_launch(const void* fm, const void* rois, const void* norm, void* out,
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
