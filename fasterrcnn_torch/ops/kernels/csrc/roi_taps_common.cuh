// Sample positions and bilinear samples of the RoI crop (14x14 samples per
// RoI, 2x2 max pool -> 7x7), shared by the forward kernel (roi_pool_taps.cu)
// and its backward (roi_pool_taps_bwd.cu). The backward recomputes the
// forward's samples to find the argmax of each 2x2 window, so both must run
// exactly this arithmetic: one header, both built with -fmad=false.
//
// Semantics: RoI corners (pixels) are scaled onto the real feature grid by
// norm = ((fh-1)/img_h, (fw-1)/img_w); 14 sample positions per axis span each
// RoI inclusively; a sample outside [0, size-1] of the canvas map is 0; a
// sample inside is bilinear over its two y-taps, which are summed in f32 and
// rounded to the map's type, then over its two x-taps. For a bf16 map the
// rounding follows the TPU kernel (fasterrcnn_tpu/ops/pallas/roi_pallas.py:
// _roi_taps_kernel): both axes' tap weights are rounded to bf16 (:194,
// :219-220); a y-tap product of two bf16 values is exact in f32, so the
// y-sum rounds once in f32 and once to bf16, as its f32-accumulated matmul
// rounds (:196-202); each x-tap product is rounded to bf16 and so is the
// two-tap sum, as its bf16 x-taps compute them (:218-221). For f32 every
// rounding is the f32 operation's own. The TPU kernel clamps the low x-tap
// to [0, W-2]; here the high tap is skipped at pos == size-1 instead, on
// both axes, which gives the same value (its weight there is exactly 0).

#pragma once

#include <cstdint>

#include "typed_io.cuh"

namespace roi_taps {

using namespace typed_io;

constexpr int kCrop = 14;
constexpr int kOut = 7;

// Per sample s along y (index s) and x (index kCrop + s): low tap cell,
// low/high tap weights (rounded to the map's type), and whether the sample
// lies inside the map. One instance per block, in shared memory.
struct Samples {
  int lo_cell[2 * kCrop];
  float w_lo[2 * kCrop];
  float w_hi[2 * kCrop];
  bool inside[2 * kCrop];
};

// Fills `smp` for RoI `roi` of image `b`; threads 0..27 of the block (in
// x-major order) each compute one sample position. The caller synchronises
// the block afterwards.
template <typename T>
__device__ __forceinline__ void sample_positions(Samples& smp, const float* __restrict__ rois,
                                                 const float* __restrict__ norm, int roi, int b,
                                                 int h, int w) {
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (t < 2 * kCrop) {
    const int axis = t / kCrop;  // 0 = y, 1 = x
    const int s = t % kCrop;
    const float scale = norm[2 * b + axis];
    const float lo = rois[4 * roi + axis] * scale;
    const float hi = rois[4 * roi + 2 + axis] * scale;
    const float step = static_cast<float>(s) / static_cast<float>(kCrop - 1);
    const float pos = lo + (hi - lo) * step;
    const int size = axis == 0 ? h : w;
    const float cell = floorf(pos);
    const float frac = pos - cell;
    smp.inside[t] = pos >= 0.0f && pos <= static_cast<float>(size - 1);
    smp.lo_cell[t] = smp.inside[t] ? static_cast<int>(cell) : 0;
    smp.w_lo[t] = round_to<T>(1.0f - frac);
    smp.w_hi[t] = round_to<T>(frac);
  }
}

// --- Lanes: V consecutive channels of one pixel, held in f32 -------------
//
// A thread of K2 or K3 works on V channels: 4 f32 or 8 bf16 in K2 (one
// 16-byte access), 2 f32 or 4 bf16 in K3 (8 bytes), or 1 where C is not a
// multiple of that or a pointer is not aligned (the wrapper picks V). Each
// lane runs the scalar arithmetic above channel by channel, so V changes
// no value.

// V channels as loaded: a vector register (f32) or packed bf16 pairs, kept
// packed until used so that a load in flight holds as few registers as can
// be, and unpacked (exactly: a bf16 is the upper half of its f32) on use.
template <typename T, int V>
struct Packed {
  static constexpr int kWords = sizeof(T) == 4 ? V : (V + 1) / 2;
  unsigned word[kWords];

  // Loads V channels at p; with kStream through L2 as evict-first data
  // (ld.global.cs), for data read once that should not push the map out.
  template <bool kStream = false>
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V == 1) {
      word[0] = __float_as_uint(typed_io::load(p));
    } else if constexpr (kWords == 4) {
      const uint4* q = reinterpret_cast<const uint4*>(p);
      const uint4 t = kStream ? __ldcs(q) : __ldg(q);
      word[0] = t.x, word[1] = t.y, word[2] = t.z, word[3] = t.w;
    } else {
      static_assert(kWords == 2, "lanes of 8 or 16 bytes");
      const uint2* q = reinterpret_cast<const uint2*>(p);
      const uint2 t = kStream ? __ldcs(q) : __ldg(q);
      word[0] = t.x, word[1] = t.y;
    }
  }

  __device__ __forceinline__ void unpack(float (&out)[V]) const {
    if constexpr (V == 1 || sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = __uint_as_float(word[i]);
    } else {
      // The lower half of each word is the lower channel.
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        out[2 * i] = __uint_as_float(word[i] << 16);
        out[2 * i + 1] = __uint_as_float(word[i] & 0xffff0000u);
      }
    }
  }
};

// Each lane rounded to T (round_to), two bf16 lanes to one conversion.
template <typename T, int V>
__device__ __forceinline__ void round_lanes(float (&v)[V]) {
  if constexpr (sizeof(T) == 4) {
    return;
  } else if constexpr (V == 1) {
    v[0] = round_to<T>(v[0]);
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 2) {
      const __nv_bfloat162 r = __floats2bfloat162_rn(v[i], v[i + 1]);
      const unsigned u = *reinterpret_cast<const unsigned*>(&r);
      v[i] = __uint_as_float(u << 16);
      v[i + 1] = __uint_as_float(u & 0xffff0000u);
    }
  }
}

// Stores values that are already of the type T (rounded by round_lanes), so
// the conversion is exact; as evict-first data (st.global.cs), so that the
// output, several times the map, does not push the map out of L2.
template <typename T, int V>
__device__ __forceinline__ void store_lanes(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    store(p, v[0]);
  } else if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    static_assert(V == 8, "bf16 outputs are stored 8 channels at a time");
    unsigned words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      words[i] = (__float_as_uint(v[2 * i]) >> 16) | (__float_as_uint(v[2 * i + 1]) & 0xffff0000u);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(words[0], words[1], words[2], words[3]));
  }
}

// --- The x-walk: a RoI's samples in the order of their tap cells -------
//
// Every sample row of a RoI reads the same x-taps. The sample positions are
// monotone in q, so taken in the order that makes the cells rise (q falling
// for an inverted RoI), the tap cells of the samples inside the map cover
// one range of columns, x0 .. x0 + ncols - 1, in which a sample's high tap
// follows its low one. A thread walks that range once per sample row,
// y-interpolating each column once and keeping the last two (the only two
// a sample can still need), and loads the next column's taps before it
// computes the current one. A sample is complete at its last tap column
// (`at`); the two samples of a pooled column are neighbours in the walk.
// Every thread of the block derives the same walk from Samples. (A range
// cell that no sample reads is loaded all the same. That takes a RoI wider
// than 26 cells, whose samples lie more than 2 cells apart: a walk that
// skipped those cells measured slower on the main paths' RoIs.)
struct XWalk {
  bool up;    // the cells rise with q
  int x0;     // the first column
  int ncols;  // 0 when no sample lies inside the map along x

  __device__ __forceinline__ XWalk(const Samples& smp, int w) : up(true), x0(0), ncols(0) {
    int first = -1, last = -1;
    for (int q = 0; q < kCrop; ++q) {
      if (smp.inside[kCrop + q]) {
        if (first < 0) first = q;
        last = q;
      }
    }
    if (first < 0) return;
    up = smp.lo_cell[kCrop + last] >= smp.lo_cell[kCrop + first];
    x0 = smp.lo_cell[kCrop + (up ? first : last)];
    const int x1 = smp.lo_cell[kCrop + (up ? last : first)];
    ncols = x1 + (x1 + 1 < w ? 2 : 1) - x0;
  }

  // The x-sample at walk position j.
  __device__ __forceinline__ int q(int j) const { return up ? j : kCrop - 1 - j; }

  // The column index at which sample q completes: its high tap's, or its
  // low tap's where it has none; -1 outside the map (its value is 0).
  __device__ __forceinline__ int at(const Samples& smp, int q, int w) const {
    if (!smp.inside[kCrop + q]) return -1;
    const int x = smp.lo_cell[kCrop + q];
    return x - x0 + (x + 1 < w ? 1 : 0);
  }
};

// One sample row of a thread's lane along the walk: its y-taps, the taps
// of the next column (loaded ahead) and the row's values at the last two
// columns, each the two y-taps summed in f32 and rounded to T, as the
// scalar form: v = w_lo * a, then v + w_hi * b.
template <typename T, int V>
struct RowWalk {
  const T* top;  // channel 0 of the lane at (y, 0)
  size_t down;   // elements from (y, x) to (y + 1, x)
  bool inside, has_below;
  float wy_lo, wy_hi;
  Packed<T, V> next_a, next_b;  // the taps of the next column, loaded ahead
  float prev[V], cur[V];

  __device__ __forceinline__ RowWalk(const Samples& smp, const T* lane_map, int s, int h, int w, int c)
      : top(lane_map + static_cast<size_t>(smp.lo_cell[s]) * w * c), down(static_cast<size_t>(w) * c),
        inside(smp.inside[s]), has_below(smp.lo_cell[s] + 1 < h), wy_lo(smp.w_lo[s]), wy_hi(smp.w_hi[s]) {}

  // Starts the loads of column x's two taps.
  __device__ __forceinline__ void fetch(int x, int c) {
    if (!inside) return;
    next_a.load(top + static_cast<size_t>(x) * c);
    if (has_below) next_b.load(top + down + static_cast<size_t>(x) * c);
  }

  // Takes the fetched column as the current one (waits for its loads).
  __device__ __forceinline__ void advance() {
    if (!inside) return;
    float a[V], b[V];
    next_a.unpack(a);
#pragma unroll
    for (int i = 0; i < V; ++i) prev[i] = cur[i];
    if (has_below) {
      next_b.unpack(b);
#pragma unroll
      for (int i = 0; i < V; ++i) cur[i] = wy_lo * a[i] + wy_hi * b[i];
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) cur[i] = wy_lo * a[i];
    }
    round_lanes<T, V>(cur);
  }

  // The bilinear sample that completes at the current column: over the
  // previous and current columns if it has a high tap, else the current
  // one alone; 0 outside the map. round(w_lo * row(x)), then
  // round(that + round(w_hi * row(x + 1))).
  __device__ __forceinline__ void sample(bool x_inside, bool has_hi, float wx_lo, float wx_hi,
                                         float (&v)[V]) const {
    if (!inside || !x_inside) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = 0.0f;
      return;
    }
    float u[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = wx_lo * (has_hi ? prev[i] : cur[i]);
    round_lanes<T, V>(v);
    if (has_hi) {
#pragma unroll
      for (int i = 0; i < V; ++i) u[i] = wx_hi * cur[i];
      round_lanes<T, V>(u);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = v[i] + u[i];
      round_lanes<T, V>(v);
    }
  }
};

// Runs the walk `wk` of one lane's two sample rows (2 py and 2 py + 1) and
// calls done(j, t0, t1, b0, b1) for each pooled column, with j the walk
// position of its second sample (the first is j - 1; the column is
// wk.q(j) / 2) and t0, t1 (top row) and b0, b1 (bottom row) the values of
// its even and odd samples.
template <typename T, int V, typename Done>
__device__ __forceinline__ void walk_pairs(const XWalk& wk, const Samples& smp, const T* lane_map, int py, int h,
                                           int w, int c, Done&& done) {
  RowWalk<T, V> rows[2] = {RowWalk<T, V>(smp, lane_map, 2 * py, h, w, c),
                           RowWalk<T, V>(smp, lane_map, 2 * py + 1, h, w, c)};
  float first[2][V];  // the pair's first sample in the walk, of each row
  auto complete = [&](int j) {
    const int q = wk.q(j);
    const bool inside = smp.inside[kCrop + q];
    const bool has_hi = smp.lo_cell[kCrop + q] + 1 < w;
    const float wx_lo = smp.w_lo[kCrop + q], wx_hi = smp.w_hi[kCrop + q];
    if (j % 2 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) rows[r].sample(inside, has_hi, wx_lo, wx_hi, first[r]);
      return;
    }
    float second[2][V];
#pragma unroll
    for (int r = 0; r < 2; ++r) rows[r].sample(inside, has_hi, wx_lo, wx_hi, second[r]);
    if (wk.up) {  // the even sample came first
      done(j, first[0], second[0], first[1], second[1]);
    } else {
      done(j, second[0], first[0], second[1], first[1]);
    }
  };
  int j = 0;
  while (j < kCrop && wk.at(smp, wk.q(j), w) < 0) complete(j++);
  if (wk.ncols > 0) {
    rows[0].fetch(wk.x0, c);
    rows[1].fetch(wk.x0, c);
  }
#pragma unroll 1
  for (int k = 0; k < wk.ncols; ++k) {
    rows[0].advance();
    rows[1].advance();
    if (k + 1 < wk.ncols) {
      rows[0].fetch(wk.x0 + k + 1, c);
      rows[1].fetch(wk.x0 + k + 1, c);
    }
    // Samples past the map's far edge (at -1) follow the last one inside.
    while (j < kCrop && wk.at(smp, wk.q(j), w) <= k) complete(j++);
  }
}

// The block of K2 and K3: 32 lanes (x) by the 7 pooled rows (y), one warp
// a pooled row, for one RoI and one chunk of 32 lanes. The seven warps walk
// neighbouring sample rows of one RoI side by side, so a map row that two
// of them read comes from L2 once and from L1 after.
constexpr int kChunkLanes = 32;

// Chunks of 32 lanes of vec channels that cover c channels.
__host__ __device__ inline int lane_chunks(int c, int vec) { return (c / vec + kChunkLanes - 1) / kChunkLanes; }

inline bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }


}  // namespace roi_taps
