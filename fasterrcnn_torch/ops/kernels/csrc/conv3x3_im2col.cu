// 3x3 SAME stride-1 convolution, NHWC, + bias and an optional ReLU, as one
// GEMM over an im2col patch matrix, for Hopper (sm_90a).
//
// Replaces the TPU kernel fasterrcnn_tpu/ops/pallas/conv_pallas.py:
// _im2col_kernel (wrapper conv3x3_im2col_pallas). The same function as
// conv3x3.cu, formulated as the TPU kernel formulates it for the
// low-channel layers (C = 64, 128): the nine taps' channels concatenated
// kx-major into one contraction of depth K = 9C, i.e. out (pixels, Cout) =
// patches (pixels, 9C) @ wk (9C, Cout), where patch column (kx*3 + ky)*C + c
// of pixel (y, x) is x[y + ky - 1, x + kx - 1, c] (0 outside the image), and
// wk is the wrapper's kx-major copy of the weights (_im2col_weights,
// :278-281). f32 accumulation, + bias in f32, optional ReLU, cast to x's type.
//
// What bounds it on the H100: operations, as for conv3x3.cu (2*9*C*Cout
// flops an output pixel; 989 TFLOP/s bf16, 494.7 / 3 TFLOP/s f32 as
// 3xTF32).
//
// The GEMM (conv_wgmma.cuh's core, on the tensor cores): one block per (256
// consecutive output pixels in row-major order, 128 output channels,
// image); the contraction runs in K-tiles of one tap x a chunk of input
// channels, in the patch matrix's kx-major column order. Each K-tile of the
// patch matrix is gathered straight from the NHWC input by 16-byte cp.async
// copies, zero-filled (src-size 0) where the tap falls outside the image;
// each thread keeps its pixels' rows and columns for the whole
// contraction, so no division runs in the loop. The K-tile's weights come
// prepacked in the wgmma B layout, one contiguous block that one TMA bulk
// copy brings in. Bias, ReLU and the one rounding to the output type in the
// epilogue. Each input value is still gathered once per tap (from L2): the
// im2col formulation trades reads for one long contraction.
//
// bf16 (conv3x3_im2col_bf16_kernel): K-tiles of 64 channels, stored as the
// wgmma A layout (one pixel x 8 channels a copy); weights 16 KB a K-tile
// (ops/conv.pack_conv3x3_im2col_weights). Four stages in a ring keep two
// K-tiles of copies in flight; 196,640 bytes of shared memory.
//
// f32 (conv3x3_im2col_f32_kernel, 3xTF32, as conv3x3.cu's f32 kernel):
// K-tiles of 32 channels: the f32 patch tile (256 x 32 x 4 bytes, 32 KB,
// staged as [8-channel group][pixel][8 f32], eight neighbouring threads
// copying one pixel's 128 contiguous bytes) and the TF32 hi and lo weights
// (2 x 32 x 128 x 4 bytes, 32 KB, ops/conv.pack_conv3x3_im2col_weights_f32,
// k order 0, 2, 4, 6 | 1, 3, 5, 7 within each 8 channels), 64 KB a stage.
// Three stages keep one K-tile of copies in flight (196,632 bytes of shared
// memory, one block an SM; 118 registers a thread, ptxas); 16 channels
// would allow six stages at twice the block barriers a K step, and
// measured slower. A k8 step loads each thread's A fragment (two adjacent
// channels of two pixels, two 8-byte shared loads), splits it into TF32 hi
// and lo in registers and issues hi.Bhi, hi.Blo and lo.Bhi as one wgmma
// group.

#include "conv_wgmma.cuh"

namespace {

namespace wg = conv_wgmma;

// ---- bf16 -----------------------------------------------------------------

constexpr int kKC = 64;           // input channels of one tap a K-tile
constexpr int kKG = kKC / 8;      // 16-byte channel groups a K-tile
constexpr int kABytes = kKG * wg::kBM * 16;
constexpr int kBBytes = kKG * wg::kBN * 16;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kStages = 4;
constexpr int kSmem = kStages * (kStageBytes + 8);  // stages, then one mbarrier each
constexpr int kACopiesPerThread = kKG * wg::kBM / wg::kThreads;
static_assert(kKG * wg::kBM % wg::kThreads == 0, "whole copies a thread");

// x (b, h, wd, c) bf16, c a multiple of 8; wp the packed weights (n-tile,
// K-tile, channel group, 128 output channels, 8), K-tile = (kx * 3 + ky) *
// chunks + chunk.
__global__ void __launch_bounds__(wg::kThreads, 1)
    conv3x3_im2col_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                               const __nv_bfloat16* __restrict__ wp,
                               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                               int h, int wd, int c, int cout, int relu, int chunks) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int n = blockIdx.z;
  const int hw = h * wd;
  const int m0 = blockIdx.x * wg::kBM;
  const int co0 = blockIdx.y * wg::kBN;
  const int steps = 9 * chunks;
  const int tid = threadIdx.x;
  const __nv_bfloat16* image = x + static_cast<size_t>(n) * hw * c;
  const __nv_bfloat16* wtile = wp + static_cast<size_t>(blockIdx.y) * steps * (kBBytes / 2);

  // This thread's pixel (the same in every copy it makes) and its first
  // channel group; its other groups are 2, 4 and 6 further.
  static_assert(wg::kThreads == 2 * wg::kBM, "two threads a pixel");
  const int px = tid % wg::kBM;
  const int kg0 = tid / wg::kBM;
  const int m = m0 + px;
  const int py = m / wd;
  const int pxx = m % wd;

  auto load = [&](int s, int buf, uint32_t bar) {
    const int tap = s / chunks;  // kx * 3 + ky
    const int cbase = (s % chunks) * kKC;
    const int y = py + tap % 3 - 1;
    const int xx = pxx + tap / 3 - 1;
    const bool inside = m < hw && y >= 0 && y < h && xx >= 0 && xx < wd;
    const __nv_bfloat16* pixel = image + (static_cast<size_t>(y) * wd + xx) * c;
    const uint32_t a_smem = wg::smem_addr(smem + buf * kStageBytes);
#pragma unroll
    for (int t = 0; t < kACopiesPerThread; ++t) {
      const int kg = kg0 + 2 * t;
      const int ch = cbase + kg * 8;
      const bool valid = inside && ch < c;
      wg::cp_async16(a_smem + (kg * wg::kBM + px) * 16, valid ? pixel + ch : image, valid);
    }
    if (tid == 0) {
      const __nv_bfloat16* wsrc = wtile + static_cast<size_t>(s) * (kBBytes / 2);
      wg::bulk_copy(a_smem + kABytes, wsrc, kBBytes, bar);
    }
  };

  float acc[wg::kAcc];
#pragma unroll
  for (int i = 0; i < wg::kAcc; ++i) acc[i] = 0.0f;
  const int warpgroup = tid / 128;
  auto mma = [&](int buf) {
    const uint32_t a_smem = wg::smem_addr(smem + buf * kStageBytes);
    const uint32_t b_smem = a_smem + kABytes;
    wg::wgmma_group([&] {
#pragma unroll
      for (int kk = 0; kk < kKG / 2; ++kk) {
        const uint64_t da =
            wg::desc(a_smem + ((2 * kk) * wg::kBM + 64 * warpgroup) * 16, wg::kBM * 16, 128);
        const uint64_t db = wg::desc(b_smem + (2 * kk) * wg::kBN * 16, wg::kBN * 16, 128);
        wg::wgmma_m64n128k16(acc, da, db);
      }
    });
  };
  wg::pipeline<kStages>(steps, acc, reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes),
                        load, mma);

  const size_t image_out = static_cast<size_t>(n) * hw;
  wg::epilogue<__nv_bfloat16>(acc, bias, co0, cout, relu, [&](int r) -> __nv_bfloat16* {
    const int q = m0 + 64 * warpgroup + r;
    return q < hw ? out + (image_out + q) * cout : nullptr;
  });
}

// ---- f32 as 3xTF32 ---------------------------------------------------------

constexpr int kKC32 = 32;                         // input channels of one tap a K-tile
constexpr int kSteps32 = kKC32 / 8;               // k8 steps a K-tile
constexpr int kABytes32 = kSteps32 * wg::kBM * 32;  // [8-channel group][pixel][8 f32]
constexpr int kBPart32 = (kKC32 / 4) * wg::kBN * 16;  // hi or lo: [4-channel K-group][co][4]
constexpr int kStageBytes32 = kABytes32 + 2 * kBPart32;
constexpr int kStages32 = 3;
constexpr int kSmem32 = kStages32 * (kStageBytes32 + 8);  // stages, then one mbarrier each
constexpr int kQuads32 = kKC32 / 4;  // 16-byte copies of a pixel
constexpr int kACopiesPerThread32 = wg::kBM * kQuads32 / wg::kThreads;
static_assert(wg::kBM * kQuads32 % wg::kThreads == 0, "whole copies a thread");
static_assert(kSmem32 <= 232448, "one block an SM");

// x (b, h, wd, c) f32, c a multiple of 8; wp the packed weights (n-tile,
// K-tile, part (hi, lo), K-group, 128 output channels, 4), K-tile = (kx * 3
// + ky) * chunks + chunk.
__global__ void __launch_bounds__(wg::kThreads, 1)
    conv3x3_im2col_f32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                              const float* __restrict__ bias, float* __restrict__ out, int h,
                              int wd, int c, int cout, int relu, int chunks) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int n = blockIdx.z;
  const int hw = h * wd;
  const int m0 = blockIdx.x * wg::kBM;
  const int co0 = blockIdx.y * wg::kBN;
  const int steps = 9 * chunks;
  const int tid = threadIdx.x;
  const float* image = x + static_cast<size_t>(n) * hw * c;
  const float* wtile = wp + static_cast<size_t>(blockIdx.y) * steps * (2 * kBPart32 / 4);

  // This thread's copies: channels 4 quad .. 4 quad + 3 of the K-tile for
  // pixels tid / kQuads32 + (512 / kQuads32) t (neighbouring threads read
  // one pixel's contiguous chunk); each pixel's row and column.
  const int quad = tid % kQuads32;
  int a_y[kACopiesPerThread32], a_x[kACopiesPerThread32];
#pragma unroll
  for (int t = 0; t < kACopiesPerThread32; ++t) {
    const int m = m0 + tid / kQuads32 + (wg::kThreads / kQuads32) * t;
    a_y[t] = m < hw ? m / wd : -2;  // a row no tap reaches: past the end
    a_x[t] = m % wd;
  }

  auto load = [&](int s, int buf, uint32_t bar) {
    const int tap = s / chunks;  // kx * 3 + ky
    const int ch = (s % chunks) * kKC32 + 4 * quad;
    const uint32_t a_smem = wg::smem_addr(smem + buf * kStageBytes32);
#pragma unroll
    for (int t = 0; t < kACopiesPerThread32; ++t) {
      const int px = tid / kQuads32 + (wg::kThreads / kQuads32) * t;
      const int y = a_y[t] + tap % 3 - 1;
      const int xx = a_x[t] + tap / 3 - 1;
      const bool valid = y >= 0 && y < h && xx >= 0 && xx < wd && ch < c;
      const float* src = valid ? image + (static_cast<size_t>(y) * wd + xx) * c + ch : image;
      wg::cp_async16(a_smem + ((quad / 2) * wg::kBM + px) * 32 + (quad % 2) * 16, src, valid);
    }
    if (tid == 0) {
      const float* wsrc = wtile + static_cast<size_t>(s) * (2 * kBPart32 / 4);
      wg::bulk_copy(a_smem + kABytes32, wsrc, 2 * kBPart32, bar);
    }
  };

  float acc[wg::kAcc];
#pragma unroll
  for (int i = 0; i < wg::kAcc; ++i) acc[i] = 0.0f;
  const int warpgroup = tid / 128;
  const int lane = tid % 32;
  // The first row of this thread's A fragment (the second is 8 further) and
  // its two channels of each 8 (k = lane % 4 and lane % 4 + 4).
  const int frag_row = 64 * warpgroup + 16 * ((tid / 32) % 4) + lane / 4;
  const int frag_ch = 2 * (lane % 4);
  auto mma = [&](int buf) {
    const float* a_stage = reinterpret_cast<const float*>(smem + buf * kStageBytes32);
    const uint32_t b_smem = wg::smem_addr(a_stage) + kABytes32;
#pragma unroll
    for (int kk = 0; kk < kSteps32; ++kk) {
      const float* a = a_stage + (kk * wg::kBM + frag_row) * 8 + frag_ch;
      const float2 r0 = *reinterpret_cast<const float2*>(a);
      const float2 r8 = *reinterpret_cast<const float2*>(a + 8 * 8);
      uint32_t hi[4], lo[4];
      wg::split_tf32(r0.x, hi[0], lo[0]);
      wg::split_tf32(r8.x, hi[1], lo[1]);
      wg::split_tf32(r0.y, hi[2], lo[2]);
      wg::split_tf32(r8.y, hi[3], lo[3]);
      const uint32_t b_hi = b_smem + (2 * kk) * wg::kBN * 16;
      const uint64_t dhi = wg::desc(b_hi, wg::kBN * 16, 128);
      const uint64_t dlo = wg::desc(b_hi + kBPart32, wg::kBN * 16, 128);
      wg::wgmma_group([&] {
        wg::wgmma_m64n128k8_tf32(acc, hi, dhi);
        wg::wgmma_m64n128k8_tf32(acc, hi, dlo);
        wg::wgmma_m64n128k8_tf32(acc, lo, dhi);
      });
    }
  };
  wg::pipeline<kStages32>(steps, acc,
                          reinterpret_cast<uint64_t*>(smem + kStages32 * kStageBytes32), load, mma);

  const size_t image_out = static_cast<size_t>(n) * hw;
  wg::epilogue<float>(acc, bias, co0, cout, relu, [&](int r) -> float* {
    const int q = m0 + 64 * warpgroup + r;
    return q < hw ? out + (image_out + q) * cout : nullptr;
  });
}

}  // namespace

// x (b, h, w, c) f32 or bf16 NHWC, c a multiple of 8; bias (cout) f32; out
// (b, h, w, cout) in x's type. wk: the packed weights of
// ops/conv.pack_conv3x3_im2col_weights (bf16: chunks of 64 channels) or
// pack_conv3x3_im2col_weights_f32 (f32: TF32 hi and lo, chunks of 32
// channels), for ceil(cout / 128) output tiles.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int conv3x3_im2col_launch(const void* x, const void* wk, const void* bias, void* out,
                                     int b, int h, int w, int c, int cout, int relu, int is_bf16,
                                     void* stream) {
  if (b == 0 || h == 0 || w == 0 || cout == 0) return 0;
  if (c % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  const dim3 grid((h * w + wg::kBM - 1) / wg::kBM, (cout + wg::kBN - 1) / wg::kBN, b);
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_im2col_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    conv3x3_im2col_bf16_kernel<<<grid, wg::kThreads, kSmem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wk), bf,
        static_cast<__nv_bfloat16*>(out), h, w, c, cout, relu, (c + kKC - 1) / kKC);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_im2col_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem32);
    if (err != cudaSuccess) return err;
    conv3x3_im2col_f32_kernel<<<grid, wg::kThreads, kSmem32, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wk), bf, static_cast<float*>(out),
        h, w, c, cout, relu, (c + kKC32 - 1) / kKC32);
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
