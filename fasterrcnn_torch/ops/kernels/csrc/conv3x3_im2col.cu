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
// flops an output pixel). It too runs on the CUDA cores in f32 for both
// input types; tensor cores and TMA are later work.
// The design: a shared-memory-tiled GEMM. One block per (image, 128
// consecutive output pixels in row-major order, 64 output channels), 256
// threads, each accumulating 8 pixels x 4 channels in f32 registers. The
// contraction runs in K-tiles of 16: the block builds the (128, 16) tile of
// the patch matrix in shared memory straight from the NHWC input
// (consecutive threads read consecutive channels of one pixel and tap) and
// stages the (16, 64) tile of wk, then each thread takes its 8 x 4 products
// per k. Unlike conv3x3.cu, which stages an input halo once and reuses it
// across the nine taps, each input value is gathered once per tap here: the
// im2col formulation trades reads for one long contraction.
// FMA contraction is allowed: no decision depends on the last bit.

#include "typed_io.cuh"

namespace {

using namespace typed_io;

constexpr int kBM = 128;   // output pixels per block
constexpr int kBN = 64;    // output channels per block
constexpr int kBK = 16;    // depth of a K-tile of the patch matrix
constexpr int kThreads = 256;
constexpr int kPixels = 8;  // output pixels per thread
constexpr int kCouts = 4;   // output channels per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_im2col_kernel(const T* __restrict__ x, const float* __restrict__ wk,
                          const float* __restrict__ bias, T* __restrict__ out, int h, int wd,
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
  const T* image = x + static_cast<size_t>(n) * hw * c;

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
    T* dst = out + (static_cast<size_t>(n) * hw + m) * cout;
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

}  // namespace

// x (b, h, w, c) f32 or bf16 NHWC; wk (9c, cout) f32, row (kx*3 + ky)*c + ci
// holding w[ky, kx, ci, :]; bias (cout) f32; out (b, h, w, cout) in x's type.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int conv3x3_im2col_launch(const void* x, const void* wk, const void* bias, void* out,
                                     int b, int h, int w, int c, int cout, int relu, int is_bf16,
                                     void* stream) {
  if (b == 0 || h == 0 || w == 0 || cout == 0) return 0;
  const dim3 grid((h * w + kBM - 1) / kBM, (cout + kBN - 1) / kBN, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(wk);
  const float* bf = static_cast<const float*>(bias);
  if (is_bf16) {
    conv3x3_im2col_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf, bf, static_cast<__nv_bfloat16*>(out), h, w, c,
        cout, relu);
  } else {
    conv3x3_im2col_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), wf, bf, static_cast<float*>(out), h, w, c, cout, relu);
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
