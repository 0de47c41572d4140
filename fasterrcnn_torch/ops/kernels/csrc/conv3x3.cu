// 3x3 SAME stride-1 convolution, NHWC, + bias and an optional ReLU, for
// Hopper (sm_90a): bf16 as an implicit GEMM on the tensor cores (wgmma), f32
// as a direct convolution on the CUDA cores.
//
// Replaces the TPU kernel fasterrcnn_tpu/ops/pallas/conv_pallas.py:
// _conv_kernel (wrapper conv3x3_pallas). Same function: out = cast(ReLU?(
// sum over taps and input channels of x * w, in f32, + bias in f32)). The
// TPU kernel's idea is kept: stage the input once and take the taps as
// shifted views of it (nine shifted matmuls over a W-padded tile, the pad
// columns sliced off outside). The TPU's row-tile picker, Cout split and f32
// round-trip rotates serve its VMEM tiling and sublane rules, and have no
// counterpart here.
//
// What bounds it on the H100: operations. A VGG conv does 2*9*C*Cout flops
// for each output pixel and moves C + Cout values for it, so its least time
// is its flops at the card's rate for the type (989 TFLOP/s in bf16 on the
// tensor cores; 67 TFLOP/s in f32 on the CUDA cores).
//
// bf16 (conv3x3_bf16_kernel, on conv_wgmma.cuh's core): the GEMM's rows are
// the output positions of the image zero-padded to width WP = W + 2 and
// flattened row-major, q = y * WP + x; its depth is 9 * C, taken as stages of
// (ky, 32 input channels). For output q the tap (ky, kx) reads padded input
// position q + ky * WP + kx, so for one ky the block stages one window of
// input positions q0 + ky * WP .. q0 + ky * WP + 257 (its 256 rows and 2 more)
// with zeros outside the image, and the three kx taps are that window at
// start offsets 0, 1 and 2 rows: three wgmma A descriptors, no copies. Each
// staged input value serves 3 taps x 128 output channels; the two outputs
// of each padded row that fall on the pad columns (x >= W) are computed and
// not stored (2 / (W + 2) of the rows). The stage's weights (3 kx taps x 32
// channels x 128 output channels) come prepacked in the wgmma B layout
// (ops/conv.pack_conv3x3_weights), one contiguous 24 KB block a stage that
// one TMA bulk copy brings in. Five stages in a ring keep three stages of
// copies in flight. The window is gathered by cp.async, not TMA: its
// positions run across padded rows, so it is no box of the NHWC tensor (a
// box of whole padded rows would stage up to 2.6x the window at block 3 and
// cannot span W + 2 > 256). f32 accumulation in
// registers; bias, ReLU and the one rounding to bf16 in the epilogue.
//
// f32 (conv3x3_kernel): the tensor cores have no f32 mode that keeps f32
// parity (TF32 rounds the inputs), so f32 runs on the CUDA cores: one block
// per (image, 8x16 output-pixel tile, 64 output channels), 256 threads, each
// accumulating 8 pixels x 4 channels in f32 registers. Input channels are
// taken 8 at a time: the block stages the tile's input rows plus a
// one-pixel halo (10 x 18 x 8 values, zero outside the image) and the nine
// taps' weights for those channels (9 x 8 x 64, from the wrapper's (ky, kx,
// C, Cout) copy) in shared memory, then runs the taps kx outer, ky inner.
// FMA contraction is allowed: no decision depends on the last bit.

#include "conv_wgmma.cuh"
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

__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int h, int wd, int c,
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
  const float* image = x + static_cast<size_t>(n) * h * wd * c;

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
    float* dst = out + ((static_cast<size_t>(n) * h + oy) * wd + ox) * cout;
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

// ---- bf16: the tensor-core implicit GEMM -------------------------------

namespace wg = conv_wgmma;

constexpr int kKC = 32;                 // input channels a stage
constexpr int kKG = kKC / 8;            // 16-byte channel groups a stage
constexpr int kWin = wg::kBM + 2;       // staged window: 256 rows + the kx = 1, 2 shifts
constexpr int kABytes = kKG * kWin * 16;
constexpr int kBBytes = 3 * kKG * wg::kBN * 16;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kStages = 5;
constexpr int kSmem = kStages * (kStageBytes + 8);  // stages, then one mbarrier each
constexpr int kACopies = kKG * kWin;    // 16-byte copies of a stage's window
constexpr int kACopiesPerThread = (kACopies + wg::kThreads - 1) / wg::kThreads;
static_assert(kABytes % 16 == 0 && kBBytes % 16 == 0, "16-byte copies");

// x (b, h, wd, c) bf16, c a multiple of 8; wp the packed weights (n-tile,
// stage, kx, channel group, 128 output channels, 8), stage = ky * chunks +
// chunk; one block per (256 padded positions, 128 output channels, image).
__global__ void __launch_bounds__(wg::kThreads, 1)
    conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                        const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int h,
                        int wd, int c, int cout, int relu, int chunks) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int n = blockIdx.z;
  const int wpad = wd + 2;
  const int q0 = blockIdx.x * wg::kBM;
  const int co0 = blockIdx.y * wg::kBN;
  const int steps = 3 * chunks;
  const int tid = threadIdx.x;
  const __nv_bfloat16* image = x + static_cast<size_t>(n) * h * wd * c;
  const __nv_bfloat16* wtile = wp + static_cast<size_t>(blockIdx.y) * steps * (kBBytes / 2);

  // This thread's window copies, the same in every stage: channel group,
  // window row, and its input pixel at ky = 0 (row a_y + ky, column a_x).
  int a_dst[kACopiesPerThread], a_y[kACopiesPerThread], a_x[kACopiesPerThread],
      a_c[kACopiesPerThread];
#pragma unroll
  for (int t = 0; t < kACopiesPerThread; ++t) {
    const int i = tid + t * wg::kThreads;
    const int kg = i / kWin;
    const int pos = i % kWin;
    const int p = q0 + pos;  // padded position at ky = 0
    a_dst[t] = i < kACopies ? (kg * kWin + pos) * 16 : -1;
    a_y[t] = p / wpad - 1;
    a_x[t] = p % wpad - 1;
    a_c[t] = kg * 8;
  }

  auto load = [&](int s, int buf, uint32_t bar) {
    const int ky = s / chunks;
    const int cbase = (s % chunks) * kKC;
    const uint32_t a_smem = wg::smem_addr(smem + buf * kStageBytes);
#pragma unroll
    for (int t = 0; t < kACopiesPerThread; ++t) {
      if (a_dst[t] < 0) continue;
      const int y = a_y[t] + ky;
      const int ch = cbase + a_c[t];
      const bool valid = y >= 0 && y < h && a_x[t] >= 0 && a_x[t] < wd && ch < c;
      const __nv_bfloat16* src =
          valid ? image + (static_cast<size_t>(y) * wd + a_x[t]) * c + ch : image;
      wg::cp_async16(a_smem + a_dst[t], src, valid);
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
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int kk = 0; kk < kKG / 2; ++kk) {
        // Tap kx: the window shifted by kx rows; k16 step kk: channel
        // groups 2kk and 2kk + 1, one window (kWin rows) apart.
        const uint64_t da =
            wg::desc(a_smem + ((2 * kk) * kWin + 64 * warpgroup + kx) * 16, kWin * 16, 128);
        const uint64_t db =
            wg::desc(b_smem + (kx * kKG + 2 * kk) * wg::kBN * 16, wg::kBN * 16, 128);
        wg::wgmma_m64n128k16(acc, da, db);
      }
    }
  };
  wg::pipeline<kStages>(steps, acc, reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes),
                        load, mma);

  const size_t image_out = static_cast<size_t>(n) * h * wd;
  wg::epilogue(acc, bias, co0, cout, relu, [&](int r) -> __nv_bfloat16* {
    const int q = q0 + 64 * warpgroup + r;
    const int y = q / wpad;
    const int xx = q % wpad;
    if (y >= h || xx >= wd) return nullptr;  // past the image, or a pad column
    return out + (image_out + static_cast<size_t>(y) * wd + xx) * cout;
  });
}

}  // namespace

// x (b, h, w, c) f32 or bf16 NHWC; bias (cout) f32; out (b, h, w, cout) in
// x's type. f32: wt (3, 3, c, cout) f32, (ky, kx, c, co). bf16: c a multiple
// of 8 and wt the packed bf16 weights of ops/conv.pack_conv3x3_weights, for
// ceil(c / 32) chunks of 32 channels and ceil(cout / 128) output tiles.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int conv3x3_launch(const void* x, const void* wt, const void* bias, void* out, int b,
                              int h, int w, int c, int cout, int relu, int is_bf16, void* stream) {
  if (b == 0 || h == 0 || w == 0 || cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (is_bf16) {
    if (c % 8 != 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((h * (w + 2) + wg::kBM - 1) / wg::kBM, (cout + wg::kBN - 1) / wg::kBN, b);
    conv3x3_bf16_kernel<<<grid, wg::kThreads, kSmem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt), bf,
        static_cast<__nv_bfloat16*>(out), h, w, c, cout, relu, (c + kKC - 1) / kKC);
  } else {
    const int tiles_w = (w + kTW - 1) / kTW;
    const dim3 grid(tiles_w * ((h + kTH - 1) / kTH), (cout + kBN - 1) / kBN, b);
    conv3x3_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(wt), bf,
                                                    static_cast<float*>(out), h, w, c, cout,
                                                    relu, tiles_w);
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
