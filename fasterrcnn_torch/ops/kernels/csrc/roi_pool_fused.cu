// RoI crop + 2x2 max pool as dense weight-sheet contractions, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel fasterrcnn_tpu/ops/pallas/roi_pallas.py:
// _roi_kernel (wrapper roi_pool_fused_pallas, forward only). The same
// function as roi_pool_taps.cu, formulated as the TPU kernel formulates it:
// a (14, H) y-weight sheet and a (14, W) x-weight sheet per RoI, both in the
// map's type; the y-contraction (14, H) @ (H, W, C) summed in f32 and rounded
// to the map's type (:114-120); per x-sample the W-contraction of those rows,
// summed in f32 and rounded once (:124-133); then the 2x2 max (:136-138). In
// bf16 that is one rounding of the x-sum where the taps kernel rounds each
// x-tap product too, so the two differ by a bf16 step on some values; in f32
// they agree bit for bit.
//
// What bounds it on the H100: operations, as the formulation chooses. The
// function is K2's, whose least time is its bytes (map read, output
// written); but the dense sheets make every output a sum over the whole map
// column: 14*H*W multiply-adds per RoI and channel for the rows and
// 14*14*W for the crops, ~36,000 at 38x50, where the taps need ~84. It runs
// on the CUDA cores: the per-RoI products are 14 wide, too narrow for a
// tensor-core tile to pay (on the TPU the same products ran its MXU at ~4%).
// The design: one block per (RoI, 32-channel tile), 8 warps, one channel per
// lane, so every read of the NHWC map and every write of the output is a run
// of 32 consecutive channels (coalesced). The sheets and the (14, W, 32) rows
// live in shared memory (94.6 KB at 38x50; dynamic, above the 48 KB
// default), the y-sheet transposed to (H, 16) so that a warp reads a map
// row's 14 weights as four 16-byte broadcasts; each warp contracts the
// map's columns x = warp, warp+8, ... over all H into 14 row values, then
// the 49 outputs are shared among the warps, each reading two rows and two
// x-weight rows once for its four crop sums.
//
// Build with -fmad=false: each sum is taken in a fixed order with every
// product rounded, and the zero weights add exactly, so each row and crop
// value is round(round(w_lo * a) + round(w_hi * b)) as the plain PyTorch
// version's split sheets give it, and the output equals the plain version's
// bit for bit in f32 and in bf16.

#include "roi_taps_common.cuh"

namespace {

using namespace roi_taps;

constexpr int kChannels = 32;  // channels per block: one per lane
constexpr int kWarps = 8;
constexpr int kFusedThreads = kChannels * kWarps;
constexpr int kPad = 16;  // the y-sheet's 14 samples, padded to 4 float4s

// Dynamic shared memory of one block, in floats: the two sheets and the rows.
__host__ __device__ constexpr int fused_smem_floats(int h, int w) {
  return kPad * h + kCrop * w + kCrop * w * kChannels;
}

template <typename T>
__global__ void __launch_bounds__(kFusedThreads)
    roi_pool_fused_kernel(const T* __restrict__ fm, const float* __restrict__ rois,
                          const float* __restrict__ norm, T* __restrict__ out, int h, int w, int c,
                          int p) {
  extern __shared__ float fused_smem[];
  float* wy = fused_smem;            // (H, 16): transposed, 2 zero pads
  float* wx = wy + kPad * h;         // (14, W)
  float* rows = wx + kCrop * w;      // (14, W, 32)
  const int roi = blockIdx.x;        // b * p + roi index
  const int b = roi / p;
  const int lane = threadIdx.x % kChannels;
  const int warp = threadIdx.x / kChannels;
  const int ch = blockIdx.y * kChannels + lane;
  const bool live = ch < c;

  // Weight sheets: entry (s, cell) of axis a is 1-frac at the low cell and
  // frac at the high one, 0 elsewhere and for a sample outside the map,
  // rounded to the map's type (roi_pallas.py:81-106).
  for (int i = threadIdx.x; i < kCrop * (h + w); i += kFusedThreads) {
    const int axis = i < kCrop * h ? 0 : 1;
    const int size = axis == 0 ? h : w;
    const int j = axis == 0 ? i : i - kCrop * h;
    const int s = j / size;
    const int cell = j % size;
    const float scale = norm[2 * b + axis];
    const float lo = rois[4 * roi + axis] * scale;
    const float hi = rois[4 * roi + 2 + axis] * scale;
    const float step = static_cast<float>(s) / static_cast<float>(kCrop - 1);
    const float pos = lo + (hi - lo) * step;
    const float lo_cell = floorf(pos);
    const float frac = pos - lo_cell;
    const bool inside = pos >= 0.0f && pos <= static_cast<float>(size - 1);
    const float fc = static_cast<float>(cell);
    float v = 0.0f;
    if (inside && fc == lo_cell) v = 1.0f - frac;
    if (inside && fc == lo_cell + 1.0f) v = frac;
    if (axis == 0) {
      wy[cell * kPad + s] = round_to<T>(v);
    } else {
      wx[j] = round_to<T>(v);
    }
  }
  for (int y = threadIdx.x; y < h; y += kFusedThreads) {
    wy[y * kPad + kCrop] = 0.0f;
    wy[y * kPad + kCrop + 1] = 0.0f;
  }
  __syncthreads();

  // Rows: rows[s][x] = sum over y of wy[s][y] * fm[y][x], ascending y.
  const T* map = fm + static_cast<size_t>(b) * h * w * c + (live ? ch : 0);
  for (int x = warp; x < w; x += kWarps) {
    float acc[kPad];
    for (int s = 0; s < kPad; ++s) acc[s] = 0.0f;
    for (int y = 0; y < h; ++y) {
      const float v = live ? load(map + (static_cast<size_t>(y) * w + x) * c) : 0.0f;
      const float4* wrow = reinterpret_cast<const float4*>(wy + y * kPad);
#pragma unroll
      for (int k = 0; k < kPad / 4; ++k) {
        const float4 q = wrow[k];
        acc[4 * k] = acc[4 * k] + q.x * v;
        acc[4 * k + 1] = acc[4 * k + 1] + q.y * v;
        acc[4 * k + 2] = acc[4 * k + 2] + q.z * v;
        acc[4 * k + 3] = acc[4 * k + 3] + q.w * v;
      }
    }
    for (int s = 0; s < kCrop; ++s) rows[(s * w + x) * kChannels + lane] = round_to<T>(acc[s]);
  }
  __syncthreads();

  // Crops and pool: output (py, px) is the max of the four crop values
  // (2py + a, 2px + e), each sum over x of wx[q][x] * rows[s][x], ascending x.
  T* dst = out + static_cast<size_t>(roi) * kOut * kOut * c + ch;
  for (int o = warp; o < kOut * kOut; o += kWarps) {
    const int py = o / kOut;
    const int px = o % kOut;
    const float* wx0 = wx + (2 * px) * w;
    const float* wx1 = wx0 + w;
    const float* row0 = rows + (2 * py) * w * kChannels + lane;
    const float* row1 = row0 + w * kChannels;
    float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;  // a<y-sample><x-sample>
    for (int x = 0; x < w; ++x) {
      const float r0 = row0[x * kChannels];
      const float r1 = row1[x * kChannels];
      a00 = a00 + wx0[x] * r0;
      a01 = a01 + wx1[x] * r0;
      a10 = a10 + wx0[x] * r1;
      a11 = a11 + wx1[x] * r1;
    }
    const float m = fmaxf(fmaxf(round_to<T>(a00), round_to<T>(a01)),
                          fmaxf(round_to<T>(a10), round_to<T>(a11)));
    if (live) store(dst + static_cast<size_t>(o) * c, m);
  }
}

template <typename T>
int launch(const void* fm, const float* rois, const float* norm, void* out, int b, int h, int w,
           int c, int p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(fused_smem_floats(h, w));
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&roi_pool_fused_kernel<T>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * p, (c + kChannels - 1) / kChannels);
  roi_pool_fused_kernel<T><<<grid, kFusedThreads, smem, stream>>>(
      static_cast<const T*>(fm), rois, norm, static_cast<T*>(out), h, w, c, p);
  return cudaGetLastError();
}

}  // namespace

// fm (b, h, w, c) f32 or bf16 NHWC, rois (b, p, 4) f32 pixel corners,
// norm (b, 2) f32, out (b, p, 7, 7, c) in fm's type. A map wider than the
// shared memory allows (W above ~120 in f32) is refused with an error.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int roi_pool_fused_launch(const void* fm, const void* rois, const void* norm, void* out,
                                     int b, int h, int w, int c, int p, int is_bf16,
                                     void* stream) {
  if (b == 0 || p == 0 || c == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const float* n = static_cast<const float*>(norm);
  return is_bf16 ? launch<__nv_bfloat16>(fm, r, n, out, b, h, w, c, p, s)
                 : launch<float>(fm, r, n, out, b, h, w, c, p, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
