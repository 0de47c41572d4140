// 3x3 SAME stride-1 convolution, NHWC, + bias and an optional ReLU, for
// Hopper (sm_90a): a direct convolution on the CUDA cores.
//
// Replaces the TPU kernel fasterrcnn_tpu/ops/pallas/conv_pallas.py:
// _conv_kernel (wrapper conv3x3_pallas). Same function: out = cast(ReLU?(
// sum over taps and input channels of x * w, in f32, + bias in f32)), the
// taps visited kx outer, ky inner, as the TPU kernel's nine shifted matmuls
// visit them. The TPU's row-tile picker, Cout split, W padding to 8 and f32
// round-trip rotates serve its VMEM tiling and sublane rules, and have no
// counterpart here.
//
// What bounds it on the H100: operations. A VGG conv does 2*9*C*Cout flops
// for each output pixel and moves C + Cout values for it, so its least time
// is its flops at the card's rate for the type (989 TFLOP/s in bf16 on the
// tensor cores; 67 TFLOP/s in f32 on the CUDA cores). This first kernel
// runs on the CUDA cores in f32 for both input types (a bf16 product is
// exact in f32):
// tensor cores (mma.sync / wgmma) and TMA are later work, so in bf16 it is
// far from its bound and from cuDNN.
// The design: one block per (image, 8x16 output-pixel tile, 64 output
// channels), 256 threads, each accumulating 8 pixels x 4 channels in f32
// registers. Input channels are taken 8 at a time: the block stages the
// tile's input rows plus a one-pixel halo (10 x 18 x 8 values, zero outside
// the image: the SAME padding) and the nine taps' weights for those
// channels (9 x 8 x 64, from the wrapper's (ky, kx, C, Cout) copy) in shared
// memory, then runs the taps kx outer, ky inner over those 8 channels. Each
// staged input value serves 9 taps x 64 channels; a thread reads its 4
// weights as one 16-byte load and its 8 inputs as broadcasts shared with
// the other 15 threads of its pixel row.
// FMA contraction is allowed: no decision depends on the last bit.

#include "typed_io.cuh"

namespace {

using namespace typed_io;

constexpr int kTH = 8;     // output rows per block
constexpr int kTW = 16;    // output columns per block
constexpr int kBN = 64;    // output channels per block
constexpr int kBK = 8;     // input channels staged per step
constexpr int kThreads = 256;
constexpr int kPixels = 8;  // output pixels per thread: one row, 8 columns
constexpr int kCouts = 4;   // output channels per thread

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out, int h, int wd, int c,
                   int cout, int relu, int tiles_w) {
  __shared__ float xs[kBK][kTH + 2][kTW + 2];
  __shared__ __align__(16) float ws[9][kBK][kBN];
  const int n = blockIdx.z;
  const int y0 = (blockIdx.x / tiles_w) * kTH;
  const int x0 = (blockIdx.x % tiles_w) * kTW;
  const int co0 = blockIdx.y * kBN;
  const int tn = threadIdx.x % (kBN / kCouts);  // 16 channel groups
  const int tm = threadIdx.x / (kBN / kCouts);  // 16 pixel groups
  const int r = tm / (kTW / kPixels);           // the thread's output row in the tile
  const int c0 = (tm % (kTW / kPixels)) * kPixels;
  const T* image = x + static_cast<size_t>(n) * h * wd * c;

  float acc[kPixels][kCouts];
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
#pragma unroll
    for (int q = 0; q < kCouts; ++q) acc[j][q] = 0.0f;
  }

  for (int k0 = 0; k0 < c; k0 += kBK) {
    // Input rows y0-1 .. y0+kTH, columns x0-1 .. x0+kTW, channels k0..k0+7;
    // consecutive threads read consecutive channels of one pixel.
    for (int i = threadIdx.x; i < kBK * (kTH + 2) * (kTW + 2); i += kThreads) {
      const int ci = i % kBK;
      const int px = (i / kBK) % (kTW + 2);
      const int py = i / (kBK * (kTW + 2));
      const int gy = y0 + py - 1;
      const int gx = x0 + px - 1;
      const int gc = k0 + ci;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && gc < c) {
        v = load(image + (static_cast<size_t>(gy) * wd + gx) * c + gc);
      }
      xs[ci][py][px] = v;
    }
    // Weights of the nine taps (tap = ky * 3 + kx) for these channels.
    for (int i = threadIdx.x; i < 9 * kBK * kBN; i += kThreads) {
      const int co = i % kBN;
      const int ci = (i / kBN) % kBK;
      const int tap = i / (kBN * kBK);
      const int gc = k0 + ci;
      const int gco = co0 + co;
      ws[tap][ci][co] =
          gc < c && gco < cout ? w[(static_cast<size_t>(tap) * c + gc) * cout + gco] : 0.0f;
    }
    __syncthreads();
    for (int kx = 0; kx < 3; ++kx) {
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int ci = 0; ci < kBK; ++ci) {
          const float4 b4 = *reinterpret_cast<const float4*>(&ws[ky * 3 + kx][ci][tn * kCouts]);
          const float* a = &xs[ci][r + ky][c0 + kx];
#pragma unroll
          for (int j = 0; j < kPixels; ++j) {
            const float av = a[j];
            acc[j][0] += av * b4.x;
            acc[j][1] += av * b4.y;
            acc[j][2] += av * b4.z;
            acc[j][3] += av * b4.w;
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = y0 + r;
  if (oy >= h) return;
#pragma unroll
  for (int j = 0; j < kPixels; ++j) {
    const int ox = x0 + c0 + j;
    if (ox >= wd) continue;
    T* dst = out + ((static_cast<size_t>(n) * h + oy) * wd + ox) * cout;
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

// x (b, h, w, c) f32 or bf16 NHWC; wt (3, 3, c, cout) f32, (ky, kx, c, co);
// bias (cout) f32; out (b, h, w, cout) in x's type.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int conv3x3_launch(const void* x, const void* wt, const void* bias, void* out, int b,
                              int h, int w, int c, int cout, int relu, int is_bf16, void* stream) {
  if (b == 0 || h == 0 || w == 0 || cout == 0) return 0;
  const int tiles_w = (w + kTW - 1) / kTW;
  const dim3 grid(tiles_w * ((h + kTH - 1) / kTH), (cout + kBN - 1) / kBN, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(wt);
  const float* bf = static_cast<const float*>(bias);
  if (is_bf16) {
    conv3x3_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf, bf, static_cast<__nv_bfloat16*>(out), h, w, c,
        cout, relu, tiles_w);
  } else {
    conv3x3_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), wf, bf,
                                                    static_cast<float*>(out), h, w, c, cout, relu,
                                                    tiles_w);
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
