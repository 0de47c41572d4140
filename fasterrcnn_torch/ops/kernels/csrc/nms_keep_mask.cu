// Greedy-NMS keep-mask over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces the TPU kernel fasterrcnn_tpu/ops/pallas/nms_pallas.py:_nms_kernel
// (wrapper nms_keep_mask_pallas). Same semantics: boxes arrive in descending
// score order; a box suppresses every lower-ranked box whose IoU with it,
// inter / (a1 + a2 - inter + 1e-7), is strictly greater than the threshold;
// invalid boxes neither accept nor suppress; the scan stops after max_keep
// accepts.
//
// Two kernels behind one entry point, split at what bounds each on the H100:
//
// 1. nms_iou_mask_kernel, bound by operations: every IoU test a problem could
//    need, K^2 / 2 of them, at once on all SMs. One block of 64 threads per
//    (problem, row tile, column tile) at or above the diagonal; the column
//    tile's 64 boxes and their areas are staged in shared memory and thread
//    t builds the word of row i = 64 * row_tile + t. The result is a
//    suppression bitmask in device memory, mask[n][i][w] (uint64,
//    ceil(K / 64) words a row): bit b of word w is set iff box i suppresses
//    box j = 64 w + b, which needs j > i. Words below the diagonal tile are
//    never written and never read. A test whose intersection is 0 skips the
//    division: its IoU is 0, -0 or NaN, never above a threshold >= 0, so the
//    bits do not change (dividing anyway made the pass 1.5x slower on the
//    card). The blocks run the last row tiles first, so the first rows,
//    which the scans read most, are the last written and still in L2.
//
// 2. nms_scan_kernel, bound by latency: each accept depends on every accept
//    before it. One block a problem walks the words in order with the
//    suppressed set `removed` (ceil(K / 64) words, starting at ~valid with
//    the bits past K set) in shared memory, so a step covers 64 candidates,
//    not one accept. Warp 0 resolves a word's free candidates in rounds
//    from their diagonal words (mask[64w + b][w]), held two a lane: a
//    candidate that no undecided candidate suppresses is accepted and what
//    it suppresses is rejected, each round a few warp-wide ORs; spread boxes
//    take one or two rounds a word. The diagonal words arrive ahead of time:
//    another warp keeps the next words' diagonals in flight by cp.async in a
//    ring of shared buffers. Then the whole block ORs the rows of the word's
//    accepts into every later word, the (accepted row, later word) pairs
//    spread over its 1024 threads, each with up to 8 loads in flight, so a
//    word costs a round trip to memory or two, not one per accept. A word
//    with no accept does no OR pass; the scan stops at max_keep accepts.
//
// The mask scratch (N * K * ceil(K / 64) * 8 bytes, 72 MB at 4 x 12000) is
// allocated by the wrapper; the kernels allocate nothing.
//
// Build with -fmad=false: the decision is a strict comparison, and an FMA
// contraction of a1 + a2 - inter or of the areas could flip it against the
// plain PyTorch version, which rounds each operation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kTile = 64;            // candidates a mask word covers
constexpr int kScanThreads = 1024;
constexpr int kRing = 4;             // diagonal-word buffers of the scan
constexpr int kLoads = 8;            // OR-pass loads a thread keeps in flight

__device__ __forceinline__ long long tile_row_start(long long row_tile, long long words) {
  return row_tile * words - row_tile * (row_tile - 1) / 2;
}

__global__ void __launch_bounds__(kTile)
nms_iou_mask_kernel(const float4* __restrict__ boxes, u64* __restrict__ mask, int n, int k, int words,
                    float iou_threshold) {
  __shared__ float4 col[kTile];
  __shared__ float col_area[kTile];
  // Blocks take the tiles of all problems interleaved, last row tile first.
  // Row tile r holds column tiles r .. words - 1.
  const long long tiles = static_cast<long long>(words) * (words + 1) / 2;
  const int problem = static_cast<int>(blockIdx.x % n);
  const long long t = tiles - 1 - blockIdx.x / n;
  const long long w2 = 2LL * words + 1;
  long long r = static_cast<long long>((w2 - sqrt(static_cast<double>(w2 * w2 - 8 * t))) / 2);
  while (r > 0 && tile_row_start(r, words) > t) --r;
  while (r + 1 < words && tile_row_start(r + 1, words) <= t) ++r;
  const int row_tile = static_cast<int>(r);
  const int col_tile = row_tile + static_cast<int>(t - tile_row_start(r, words));

  const float4* b = boxes + static_cast<size_t>(problem) * k;
  const int tid = threadIdx.x;
  const int j0 = col_tile * kTile;
  if (j0 + tid < k) {
    const float4 bj = b[j0 + tid];
    col[tid] = bj;
    col_area[tid] = (bj.z - bj.x) * (bj.w - bj.y);
  }
  __syncthreads();
  const int i = row_tile * kTile + tid;
  if (i >= k) return;

  const float4 bi = b[i];  // (y1, x1, y2, x2)
  const float iarea = (bi.z - bi.x) * (bi.w - bi.y);
  const int count = min(kTile, k - j0);
  u64 word = 0;
  for (int c = row_tile == col_tile ? tid + 1 : 0; c < count; ++c) {
    const float4 bc = col[c];
    const float tly = fmaxf(bi.x, bc.x);
    const float tlx = fmaxf(bi.y, bc.y);
    const float bry = fminf(bi.z, bc.z);
    const float brx = fminf(bi.w, bc.w);
    const float inter = (tly < bry && tlx < brx) ? (bry - tly) * (brx - tlx) : 0.0f;
    if (inter == 0.0f && iou_threshold >= 0.0f) continue;
    const float iou = inter / (iarea + col_area[c] - inter + 1e-7f);
    if (iou > iou_threshold) word |= 1ull << c;
  }
  mask[(static_cast<size_t>(problem) * k + i) * words + col_tile] = word;
}

// 8-byte asynchronous copy to shared memory; with `pred` false it writes zeros.
__device__ __forceinline__ void cp_async8(u64* dst, const u64* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(pred ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// The lowest `count` set bits of x.
__device__ __forceinline__ u64 lowest_bits(u64 x, int count) {
  if (count <= 0) return 0;
  while (__popcll(x) > count) x &= ~(1ull << (63 - __clzll(x)));
  return x;
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int k, int words, int max_keep) {
  extern __shared__ u64 scan_smem[];
  u64* removed = scan_smem;           // suppressed or invalid candidates
  u64* accepted = scan_smem + words;  // the keep-mask, a word at a time
  __shared__ u64 diag[kRing][kTile];
  __shared__ u64 word_accepts[2];
  __shared__ int rows[kTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const u64* m = mask + static_cast<size_t>(blockIdx.x) * k * words;
  const uint8_t* v = valid + static_cast<size_t>(blockIdx.x) * k;

  for (int w = warp; w < words; w += kScanThreads / 32) {
    const int j = w * kTile + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, j < k && v[j] != 0);
    const unsigned hi = __ballot_sync(0xffffffffu, j + 32 < k && v[j + 32] != 0);
    if (lane == 0) {
      removed[w] = ~((static_cast<u64>(hi) << 32) | lo);
      accepted[w] = 0;
    }
  }
  // Warp 1 copies word ww's diagonal words into ring buffer ww % kRing, one
  // commit group a word (empty past the last word, so the count holds).
  auto prefetch = [&](int ww) {
    if (ww < words) {
      for (int h = 0; h < 2; ++h) {
        const int row = ww * kTile + lane + 32 * h;
        cp_async8(&diag[ww % kRing][lane + 32 * h], row < k ? m + static_cast<size_t>(row) * words + ww : m,
                  row < k);
      }
    }
    cp_async_commit();
  };
  if (warp == 1) {
    for (int ww = 0; ww < kRing - 1; ++ww) prefetch(ww);
    cp_async_wait<kRing - 2>();  // word 0 has landed
  }
  __syncthreads();

  int kept = 0;
  for (int w = 0; w < words; ++w) {
    if (warp == 0) {
      // Lane l holds the diagonal words of candidates l and l + 32.
      const u64 d0 = diag[w % kRing][lane], d1 = diag[w % kRing][lane + 32];
      auto suppressed_by = [&](u64 set) {  // OR of the diagonal words of `set`
        const u64 h = (((set >> lane) & 1) ? d0 : 0) | (((set >> (lane + 32)) & 1) ? d1 : 0);
        return (static_cast<u64>(__reduce_or_sync(0xffffffffu, static_cast<unsigned>(h >> 32))) << 32) |
               __reduce_or_sync(0xffffffffu, static_cast<unsigned>(h));
      };
      // Greedy over the word in rounds: a candidate that no undecided
      // candidate suppresses is accepted (its earlier suppressors are all
      // rejected), and what it suppresses is rejected. The lowest undecided
      // candidate is decided in every round; spread boxes take one or two.
      u64 undecided = ~removed[w], acc = 0;
      while (undecided != 0) {
        const u64 sure = undecided & ~suppressed_by(undecided);
        acc |= sure;
        undecided &= ~sure & ~suppressed_by(sure);
      }
      // Greedy decides a candidate from the earlier ones alone, so the cut
      // at max_keep keeps the lowest accepts.
      acc = lowest_bits(acc, max_keep - kept);
      for (int h = 0; h < 2; ++h) {
        const int bit = lane + 32 * h;
        if ((acc >> bit) & 1) rows[__popcll(acc & ((1ull << bit) - 1))] = w * kTile + bit;
      }
      if (lane == 0) {
        word_accepts[w & 1] = acc;
        accepted[w] = acc;
      }
    } else if (warp == 1) {
      prefetch(w + kRing - 1);
      cp_async_wait<kRing - 2>();  // word w + 1 has landed
    }
    __syncthreads();
    const u64 acc = word_accepts[w & 1];
    kept += __popcll(acc);
    const int later = words - w - 1;
    if (kept >= max_keep || later == 0) break;
    if (acc == 0) continue;
    // OR the accepted rows into every later word not yet all suppressed.
    const int pairs = __popcll(acc) * later;
    for (int base = tid; base < pairs; base += kScanThreads * kLoads) {
      u64 bits[kLoads];
      int at[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int p = base + u * kScanThreads;
        bits[u] = 0;
        at[u] = 0;
        if (p < pairs) {
          const int a = p / later;
          at[u] = w + 1 + (p - a * later);
          if (removed[at[u]] != ~0ull) bits[u] = m[static_cast<size_t>(rows[a]) * words + at[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (bits[u] != 0) atomicOr(&removed[at[u]], bits[u]);
      }
    }
    __syncthreads();
  }
  if (warp == 1) cp_async_wait<0>();
  __syncthreads();

  uint8_t* out = keep + static_cast<size_t>(blockIdx.x) * k;
  for (int j = tid; j < k; j += kScanThreads) out[j] = (accepted[j / kTile] >> (j % kTile)) & 1;
}

}  // namespace

// boxes (n, k, 4) f32 score-sorted, valid (n, k) u8, keep (n, k) u8 out,
// mask (n, k, ceil(k / 64)) u64 scratch. Returns a cudaError_t; 0 means both
// launches were accepted.
extern "C" int nms_keep_mask_launch(const void* boxes, const void* valid, void* keep, void* mask, int n,
                                    int k, float iou_threshold, int max_keep, void* stream) {
  if (n == 0 || k == 0) return 0;
  const int words = (k + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(words) * (words + 1) / 2 * n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_iou_mask_kernel<<<static_cast<unsigned>(blocks), kTile, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<u64*>(mask), n, k, words, iou_threshold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = 2 * static_cast<size_t>(words) * sizeof(u64);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nms_scan_kernel<<<n, kScanThreads, smem, s>>>(static_cast<const u64*>(mask),
                                                static_cast<const uint8_t*>(valid),
                                                static_cast<uint8_t*>(keep), k, words, max_keep);
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
