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
// y-interpolated rows is passed through as the identity, as on the TPU, and
// for a bf16 map the shares go through the forward's bf16-rounded tap
// weights, held in f32, as the TPU kernel scatters them (roi_pallas.py:387,
// :391, :399).
//
// What bounds it on the H100: bytes. At the train shape (fm 4x38x50x512, 128
// RoIs an image) it reads g (4*128*49*512 values, ~3.3x the map) and the map
// once each and writes the f32 cotangent of the map; ~70 flops per output.
// The design mirrors the forward kernel: one thread per lane of V
// channels, 2 in f32 and 4 in bf16 (8-byte loads of the map and of g; 4 f32
// or 8 bf16 channels cost 140-200 registers a thread and ran slower), one
// warp per pooled row, one block of
// 7 warps per (RoI, chunk of 32 lanes), and the forward's samples
// recomputed by the forward's own walk (walk_pairs in roi_taps_common.cuh),
// built with -fmad=false like it, so every argmax and tie decision matches
// the forward's bit for bit. The TPU kernel sums each sample row's x-taps
// into a row cotangent before its y-taps scatter it (roi_pallas.py:385-392);
// here each of the thread's two sample rows keeps that row cotangent for
// the two columns its walk is on (ColumnSums), in registers, and a column
// leaves, as one vector reduction of the lane's f32 channels
// (red.global.add.v2.f32 or .v4.f32) into each of its two y-tap cells,
// once the walk has passed it. The blocks of one image run in parallel, so
// they add into an f32 map in device memory (zeroed by the wrapper). The
// order of those additions changes from run to run, and so do the last bits
// of the result.

#include "roi_taps_common.cuh"

namespace {

using namespace roi_taps;

// Adds the V lanes of v to the f32 map at p: one vector reduction of V
// channels (p aligned to them), or one scalar atomic.
template <int V>
__device__ __forceinline__ void add_lanes(float* p, const float (&v)[V], float weight) {
  if constexpr (V == 1) {
    atomicAdd(p, v[0] * weight);
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0] * weight, v[1] * weight));
  } else {
    static_assert(V == 4, "reductions of 1, 2 or 4 channels");
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0] * weight, v[1] * weight, v[2] * weight, v[3] * weight));
  }
}

// The row cotangent of one sample row over the (at most) two columns the
// walk is on, keyed by cell: each tied sample adds share * w_x_lo to its low
// column and share * w_x_hi to its high one. A column that the next sample
// does not touch is passed on through the row's y-taps (flush).
template <int V>
struct ColumnSums {
  float* grad;  // channel 0 of the lane, at (0, 0) of the image's cotangent
  int y;
  float wy_lo, wy_hi;
  int key[2];
  float val[2][V];

  __device__ __forceinline__ ColumnSums(const Samples& smp, float* lane_grad, int s)
      : grad(lane_grad), y(smp.lo_cell[s]), wy_lo(smp.w_lo[s]), wy_hi(smp.w_hi[s]), key{-1, -1} {}

  template <int K>
  __device__ __forceinline__ void flush(int h, int w, int c) {
    if (key[K] < 0) return;
    bool any = false;
#pragma unroll
    for (int i = 0; i < V; ++i) any |= val[K][i] != 0.0f;
    if (any) {
      float* cell = grad + (static_cast<size_t>(y) * w + key[K]) * c;
      add_lanes<V>(cell, val[K], wy_lo);
      if (y + 1 < h) add_lanes<V>(cell + static_cast<size_t>(w) * c, val[K], wy_hi);
    }
    key[K] = -1;
  }

  // Adds share * weight to column x: into its entry, or into a free one.
  // (Both entries spelled out: a runtime index into val would put the sums
  // in local memory.)
  __device__ __forceinline__ void add(int x, const float (&share)[V], float weight) {
    if (key[0] == x || (key[1] != x && key[0] < 0)) {
      add_to<0>(x, share, weight);
    } else {
      add_to<1>(x, share, weight);
    }
  }

  template <int K>
  __device__ __forceinline__ void add_to(int x, const float (&share)[V], float weight) {
    const bool fresh = key[K] != x;
    key[K] = x;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float t = share[i] * weight;
      val[K][i] = fresh ? t : val[K][i] + t;
    }
  }

  // Adds a tied sample at low column x (high column x + 1 unless past the
  // map): the columns other than those two leave first.
  __device__ __forceinline__ void sample(int x, float wx_lo, float wx_hi, const float (&share)[V], int h,
                                         int w, int c) {
    const bool has_hi = x + 1 < w;
    const int x_hi = has_hi ? x + 1 : x;
    if (key[0] != x && key[0] != x_hi) flush<0>(h, w, c);
    if (key[1] != x && key[1] != x_hi) flush<1>(h, w, c);
    add(x, share, wx_lo);
    if (has_hi) add(x + 1, share, wx_hi);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kChunkLanes * kOut) roi_pool_taps_bwd_kernel(
    const T* __restrict__ fm, const float* __restrict__ rois, const float* __restrict__ norm,
    const T* __restrict__ g, float* __restrict__ gfm, int h, int w, int c, int p) {
  __shared__ Samples smp;
  const int chunks = lane_chunks(c, V);
  const int roi = blockIdx.x / chunks;  // b * p + roi index
  const int b = roi / p;
  sample_positions<T>(smp, rois, norm, roi, b, h, w);
  __syncthreads();
  const int py = threadIdx.y;
  const int lane = (blockIdx.x % chunks) * kChunkLanes + threadIdx.x;
  if (lane * V >= c) return;

  const size_t image = static_cast<size_t>(b) * h * w * c + lane * V;
  const T* gout = g + (static_cast<size_t>(roi) * kOut + py) * kOut * c + lane * V;
  ColumnSums<V> sums[2] = {ColumnSums<V>(smp, gfm + image, 2 * py), ColumnSums<V>(smp, gfm + image, 2 * py + 1)};
  const XWalk wk(smp, w);
  // The cotangent of the next pooled column in the walk, loaded ahead.
  Packed<T, V> g_next;
  g_next.template load<true>(gout + static_cast<size_t>(wk.q(0) / 2) * c);
  // Adds the shares of the top and bottom samples at walk position j.
  auto scatter = [&](int j, const float (&top)[V], const float (&bottom)[V]) {
    const int q = wk.q(j);
    if (!smp.inside[kCrop + q]) return;
    const int x = smp.lo_cell[kCrop + q];
    const float wx_lo = smp.w_lo[kCrop + q], wx_hi = smp.w_hi[kCrop + q];
    if (smp.inside[2 * py]) sums[0].sample(x, wx_lo, wx_hi, top, h, w, c);
    if (smp.inside[2 * py + 1]) sums[1].sample(x, wx_lo, wx_hi, bottom, h, w, c);
  };
  walk_pairs<T, V>(
      wk, smp, fm + image, py, h, w, c,
      [&](int j, const float (&t0)[V], const float (&t1)[V], const float (&b0)[V], const float (&b1)[V]) {
        float gv[V];
        g_next.unpack(gv);
        if (j + 1 < kCrop) g_next.template load<true>(gout + static_cast<size_t>(wk.q(j + 1) / 2) * c);
        // The window's samples in the forward's order: (top, 2px), (top,
        // 2px+1), (bottom, 2px), (bottom, 2px+1); each sample's share of
        // the cotangent replaces its value.
        float v[4][V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          v[0][i] = t0[i], v[1][i] = t1[i], v[2][i] = b0[i], v[3][i] = b1[i];
          // The forward's max, in the forward's order.
          const float m = fmaxf(fmaxf(v[0][i], v[1][i]), fmaxf(v[2][i], v[3][i]));
          int ties = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) ties += v[k][i] == m;
          const float each = gv[i] / static_cast<float>(ties);
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k][i] = v[k][i] == m ? each : 0.0f;
        }
        // The pair's two samples in walk order (rising columns).
        if (wk.up) {
          scatter(j - 1, v[0], v[2]);
          scatter(j, v[1], v[3]);
        } else {
          scatter(j - 1, v[1], v[3]);
          scatter(j, v[0], v[2]);
        }
      });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sums[r].template flush<0>(h, w, c);
    sums[r].template flush<1>(h, w, c);
  }
}

template <typename T, int V>
void launch(const void* fm, const float* rois, const float* norm, const void* g, float* gfm, int b,
            int h, int w, int c, int p, cudaStream_t s) {
  roi_pool_taps_bwd_kernel<T, V><<<b * p * lane_chunks(c, V), dim3(kChunkLanes, kOut), 0, s>>>(
      static_cast<const T*>(fm), rois, norm, static_cast<const T*>(g), gfm, h, w, c, p);
}

}  // namespace

// fm (b, h, w, c) f32 or bf16 NHWC, rois (b, p, 4) f32 pixel corners,
// norm (b, 2) f32, g (b, p, 7, 7, c) in fm's type; gfm (b, h, w, c) f32,
// zeroed by the caller, receives the cotangent of fm. vec is the lane width:
// 2 (f32) or 4 (bf16), c a multiple of it and each pointer aligned to vec of
// its elements, or 1.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int roi_pool_taps_bwd_launch(const void* fm, const void* rois, const void* norm,
                                        const void* g, void* gfm, int b, int h, int w, int c,
                                        int p, int is_bf16, int vec, void* stream) {
  if (b == 0 || p == 0 || c == 0) return 0;
  const int bytes = vec * (is_bf16 ? 2 : 4);
  if ((vec != 1 && (vec != (is_bf16 ? 4 : 2) || c % vec != 0)) || !aligned(fm, bytes) || !aligned(g, bytes) ||
      !aligned(gfm, 4 * vec)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const float* n = static_cast<const float*>(norm);
  float* out = static_cast<float*>(gfm);
  if (is_bf16) {
    if (vec == 1) launch<__nv_bfloat16, 1>(fm, r, n, g, out, b, h, w, c, p, s);
    else launch<__nv_bfloat16, 4>(fm, r, n, g, out, b, h, w, c, p, s);
  } else {
    if (vec == 1) launch<float, 1>(fm, r, n, g, out, b, h, w, c, p, s);
    else launch<float, 2>(fm, r, n, g, out, b, h, w, c, p, s);
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
