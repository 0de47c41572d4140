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
// flops an output pixel).
//
// bf16 (conv3x3_im2col_bf16_kernel, on conv_wgmma.cuh's core): the same GEMM
// on the tensor cores (wgmma). One block per (256 consecutive output pixels
// in row-major order, 128 output channels, image); the contraction runs in
// K-tiles of one tap x 64 input channels, in the patch matrix's kx-major
// column order. Each K-tile of the patch matrix is gathered straight from
// the NHWC input into the wgmma A layout by 16-byte cp.async copies, one
// pixel x 8 channels each, zero-filled (src-size 0) where the tap falls
// outside the image; each thread keeps one pixel's row and column for the
// whole contraction, so no division runs in the loop. The K-tile's weights
// (64 x 128) come prepacked in the wgmma B layout
// (ops/conv.pack_conv3x3_im2col_weights), one contiguous 16 KB block that
// one TMA bulk copy brings in. Four
// stages in a ring keep two K-tiles of copies in flight; bias, ReLU and the
// one rounding to bf16 in the epilogue. Each input value is still gathered
// once per tap (from L2): the im2col formulation trades reads for one long
// contraction.
//
// f32 (conv3x3_im2col_kernel): on the CUDA cores (the tensor cores have no
// f32 mode that keeps f32 parity), a shared-memory-tiled GEMM. One block per
// (image, 128 consecutive output pixels, 64 output channels), 256 threads,
// each accumulating 8 pixels x 4 channels in f32 registers. The contraction
// runs in K-tiles of 16: the block builds the (128, 16) tile of the patch
// matrix in shared memory straight from the NHWC input and stages the (16,
// 64) tile of wk, then each thread takes its 8 x 4 products per k.
// FMA contraction is allowed: no decision depends on the last bit.

#include "conv_wgmma.cuh"
#include "typed_io.cuh"

namespace {

using namespace typed_io;

constexpr int kBM = 128;   // output pixels per block
constexpr int kBN = 64;    // output channels per block
constexpr int kBK = 16;    // depth of a K-tile of the patch matrix
constexpr int kThreads = 256;
constexpr int kPixels = 8;  // output pixels per thread
constexpr int kCouts = 4;   // output channels per thread

__global__ void __launch_bounds__(kThreads)
    conv3x3_im2col_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                          const float* __restrict__ bias, float* __restrict__ out, int h, int wd,
                          int c, int cout, int relu) {
  // Patch tile, k-major; rows padded by one so that the column-wise fill
  // (consecutive threads on consecutive k) spreads over the banks.
  __shared__ float as[kBK][kBM + 1];
  __shared__ __align__(16) float bs[kBK][kBN];
  const int n = blockIdx.z;
  const int hw = h * wd;
  const int m0 = blockIdx.x * kBM;
  const int co0 = blockIdx.y * kBN;
  const int depth = 9 * c;
  const int tn = threadIdx.x % (kBN / kCouts);  // 16 channel groups
  const int tm = threadIdx.x / (kBN / kCouts);  // 16 pixel groups
  const float* image = x + static_cast<size_t>(n) * hw * c;

  float acc[kPixels][kCouts];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
#pragma unroll
    for (int q = 0; q < kCouts; ++q) acc[j][q] = 0.0f;
  }

  for (int k0 = 0; k0 < depth; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int kk = i % kBK;
      const int mm = i / kBK;
      const int k = k0 + kk;
      const int m = m0 + mm;
      float v = 0.0f;
      if (k < depth && m < hw) {
        const int tap = k / c;  // kx * 3 + ky
        const int ch = k - tap * c;
        const int iy = m / wd + tap % 3 - 1;
        const int ix = m % wd + tap / 3 - 1;
        if (iy >= 0 && iy < h && ix >= 0 && ix < wd) {
          v = load(image + (static_cast<size_t>(iy) * wd + ix) * c + ch);
        }
      }
      as[kk][mm] = v;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int nn = i % kBN;
      const int kk = i / kBN;
      const int k = k0 + kk;
      const int co = co0 + nn;
      bs[kk][nn] = k < depth && co < cout ? wk[static_cast<size_t>(k) * cout + co] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][tn * kCouts]);
#pragma unroll
      for (int j = 0; j < kPixels; ++j) {
        const float av = as[kk][tm * kPixels + j];
        acc[j][0] += av * b4.x;
        acc[j][1] += av * b4.y;
        acc[j][2] += av * b4.z;
        acc[j][3] += av * b4.w;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const int m = m0 + tm * kPixels + j;
    if (m >= hw) continue;
    float* dst = out + (static_cast<size_t>(n) * hw + m) * cout;
#pragma unroll
    for (int q = 0; q < kCouts; ++q) {
      const int co = co0 + tn * kCouts + q;
      if (co >= cout) continue;
      float v = acc[j][q] + bias[co];
      if (relu) v = fmaxf(v, 0.0f);
      store(dst + co, v);
    }
  }
}

// ---- bf16: the tensor-core GEMM over the patch matrix --------------------

namespace wg = conv_wgmma;

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
#pragma unroll
    for (int kk = 0; kk < kKG / 2; ++kk) {
      const uint64_t da =
          wg::desc(a_smem + ((2 * kk) * wg::kBM + 64 * warpgroup) * 16, wg::kBM * 16, 128);
      const uint64_t db = wg::desc(b_smem + (2 * kk) * wg::kBN * 16, wg::kBN * 16, 128);
      wg::wgmma_m64n128k16(acc, da, db);
    }
  };
  wg::pipeline<kStages>(steps, acc, reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes),
                        load, mma);

  const size_t image_out = static_cast<size_t>(n) * hw;
  wg::epilogue(acc, bias, co0, cout, relu, [&](int r) -> __nv_bfloat16* {
    const int q = m0 + 64 * warpgroup + r;
    return q < hw ? out + (image_out + q) * cout : nullptr;
  });
}

}  // namespace

// x (b, h, w, c) f32 or bf16 NHWC; bias (cout) f32; out (b, h, w, cout) in
// x's type. f32: wk (9c, cout) f32, row (kx*3 + ky)*c + ci holding
// w[ky, kx, ci, :]. bf16: c a multiple of 8 and wk the packed bf16 weights of
// ops/conv.pack_conv3x3_im2col_weights, for ceil(c / 64) chunks of 64
// channels and ceil(cout / 128) output tiles.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int conv3x3_im2col_launch(const void* x, const void* wk, const void* bias, void* out,
                                     int b, int h, int w, int c, int cout, int relu, int is_bf16,
                                     void* stream) {
  if (b == 0 || h == 0 || w == 0 || cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (is_bf16) {
    if (c % 8 != 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_im2col_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((h * w + wg::kBM - 1) / wg::kBM, (cout + wg::kBN - 1) / wg::kBN, b);
    conv3x3_im2col_bf16_kernel<<<grid, wg::kThreads, kSmem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wk), bf,
        static_cast<__nv_bfloat16*>(out), h, w, c, cout, relu, (c + kKC - 1) / kKC);
  } else {
    const dim3 grid((h * w + kBM - 1) / kBM, (cout + kBN - 1) / kBN, b);
    conv3x3_im2col_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wk), bf, static_cast<float*>(out),
        h, w, c, cout, relu);
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
