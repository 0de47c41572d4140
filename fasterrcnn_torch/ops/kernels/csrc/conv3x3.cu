// 3x3 SAME stride-1 convolution, NHWC, + bias and an optional ReLU, for
// Hopper (sm_90a), as an implicit GEMM on the tensor cores (wgmma): bf16
// directly, f32 as 3xTF32.
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
// is its flops at the card's rate for the type: 989 TFLOP/s in bf16 on the
// tensor cores; in f32, 494.7 / 3 TFLOP/s, three TF32 products for each f32
// one (the CUDA cores' 67 TFLOP/s is the slower f32 rate).
//
// The GEMM (conv_wgmma.cuh's core): its rows are the output positions of
// the image zero-padded to width WP = W + 2 and flattened row-major, q = y *
// WP + x; its depth is 9 * C, taken as stages of (ky, a chunk of input
// channels). For output q the tap (ky, kx) reads padded input position q +
// ky * WP + kx, so for one ky the block stages one window of input positions
// q0 + ky * WP .. q0 + ky * WP + 257 (its 256 rows and 2 more) with zeros
// outside the image, and the three kx taps are that window at start offsets
// 0, 1 and 2 rows. Each staged input value serves 3 taps x 128 output
// channels; the two outputs of each padded row that fall on the pad columns
// (x >= W) are computed and not stored (2 / (W + 2) of the rows). The
// stage's weights (3 kx taps x the chunk x 128 output channels) come
// prepacked in the wgmma B layout, one contiguous block a stage that one TMA
// bulk copy brings in. The window is gathered by cp.async, not TMA: its
// positions run across padded rows, so it is no box of the NHWC tensor (a
// box of whole padded rows would stage up to 2.6x the window at block 3 and
// cannot span W + 2 > 256). f32 accumulation in registers; bias, ReLU and
// the one rounding to the output type in the epilogue.
//
// bf16 (conv3x3_bf16_kernel): chunks of 32 channels; the window is stored
// as the wgmma A layout, and the three kx taps are three A descriptors one
// row (16 bytes) apart. Weights 24 KB a stage (ops/conv.
// pack_conv3x3_weights); five stages in a ring keep three stages of copies
// in flight. 205,480 bytes of shared memory, one block an SM.
//
// f32 (conv3x3_f32_kernel, 3xTF32): chunks of 16 channels, so that three
// stages fit: a stage is the f32 window (258 positions x 16 channels, 16.1
// KB) and the TF32 hi and lo weights (2 x 3 kx x 16 x 128 x 4 bytes, 48 KB,
// ops/conv.pack_conv3x3_weights_f32), 64.1 KB; 32 channels would take 129 KB
// and leave room for one stage only, and 8 channels in four to six stages
// measured slower. Three stages keep one stage of copies in flight
// (197,016 bytes of shared memory, one block an SM; 117 registers a thread,
// ptxas). The window is staged as [8-channel group][position][8 f32], and
// the weights' k order within each 8 channels is 0, 2, 4, 6 | 1, 3, 5, 7,
// so that a thread's A fragment (columns t and t + 4 of a k8 step, rows r
// and r + 8) is two adjacent channels of two positions: two 8-byte shared
// loads, which a warp takes without bank conflicts. Each k8 step splits the
// fragment into TF32 hi and lo in registers and issues three wgmmas as one
// group; the group's wait (conv_wgmma::wgmma_group) keeps one group's A
// registers in flight, and ptxas holds them until that wait. The kx taps
// are fragment loads one position apart.

#include "conv_wgmma.cuh"

namespace {

namespace wg = conv_wgmma;

constexpr int kWin = wg::kBM + 2;       // staged window: 256 rows + the kx = 1, 2 shifts

// ---- bf16 -----------------------------------------------------------------

constexpr int kKC = 32;                 // input channels a stage
constexpr int kKG = kKC / 8;            // 16-byte channel groups a stage
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
    wg::wgmma_group([&] {
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
    });
  };
  wg::pipeline<kStages>(steps, acc, reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes),
                        load, mma);

  const size_t image_out = static_cast<size_t>(n) * h * wd;
  wg::epilogue<__nv_bfloat16>(acc, bias, co0, cout, relu, [&](int r) -> __nv_bfloat16* {
    const int q = q0 + 64 * warpgroup + r;
    const int y = q / wpad;
    const int xx = q % wpad;
    if (y >= h || xx >= wd) return nullptr;  // past the image, or a pad column
    return out + (image_out + static_cast<size_t>(y) * wd + xx) * cout;
  });
}

// ---- f32 as 3xTF32 ---------------------------------------------------------

constexpr int kKC32 = 16;                         // input channels a stage
constexpr int kSteps32 = kKC32 / 8;               // k8 steps of one tap a stage
constexpr int kABytes32 = kSteps32 * kWin * 32;   // window: [8-channel group][position][8 f32]
constexpr int kBPart32 = 3 * (kKC32 / 4) * wg::kBN * 16;  // hi or lo: [kx][4-channel K-group][co][4]
constexpr int kStageBytes32 = kABytes32 + 2 * kBPart32;
constexpr int kStages32 = 3;
constexpr int kSmem32 = kStages32 * (kStageBytes32 + 8);  // stages, then one mbarrier each
constexpr int kQuads32 = kKC32 / 4;                       // 16-byte copies of a position
constexpr int kACopiesPerThread32 = (kWin * kQuads32 + wg::kThreads - 1) / wg::kThreads;
static_assert(kABytes32 % 16 == 0 && kStageBytes32 % 16 == 0, "16-byte copies");
static_assert(kSmem32 <= 232448, "one block an SM");

// x (b, h, wd, c) f32, c a multiple of 8; wp the packed weights (n-tile,
// stage, part (hi, lo), kx, K-group, 128 output channels, 4), stage = ky *
// chunks + chunk; one block per (256 padded positions, 128 output channels,
// image).
__global__ void __launch_bounds__(wg::kThreads, 1)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                       const float* __restrict__ bias, float* __restrict__ out, int h, int wd,
                       int c, int cout, int relu, int chunks) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int n = blockIdx.z;
  const int wpad = wd + 2;
  const int q0 = blockIdx.x * wg::kBM;
  const int co0 = blockIdx.y * wg::kBN;
  const int steps = 3 * chunks;
  const int tid = threadIdx.x;
  const float* image = x + static_cast<size_t>(n) * h * wd * c;
  const float* wtile = wp + static_cast<size_t>(blockIdx.y) * steps * (2 * kBPart32 / 4);

  // This thread's window copies: channels 4 quad .. 4 quad + 3 of the chunk
  // at window positions tid / kQuads32 + (512 / kQuads32) t (neighbouring
  // threads read one position's contiguous chunk), and each position's
  // input pixel at ky = 0 (row a_y + ky, column a_x).
  const int quad = tid % kQuads32;
  int a_y[kACopiesPerThread32], a_x[kACopiesPerThread32];
#pragma unroll
  for (int t = 0; t < kACopiesPerThread32; ++t) {
    const int p = q0 + tid / kQuads32 + (wg::kThreads / kQuads32) * t;  // padded position at ky = 0
    a_y[t] = p / wpad - 1;
    a_x[t] = p % wpad - 1;
  }

  auto load = [&](int s, int buf, uint32_t bar) {
    const int ky = s / chunks;
    const int ch = (s % chunks) * kKC32 + 4 * quad;
    const uint32_t a_smem = wg::smem_addr(smem + buf * kStageBytes32);
#pragma unroll
    for (int t = 0; t < kACopiesPerThread32; ++t) {
      const int pos = tid / kQuads32 + (wg::kThreads / kQuads32) * t;
      if (pos >= kWin) continue;
      const int y = a_y[t] + ky;
      const bool valid = y >= 0 && y < h && a_x[t] >= 0 && a_x[t] < wd && ch < c;
      const float* src = valid ? image + (static_cast<size_t>(y) * wd + a_x[t]) * c + ch : image;
      wg::cp_async16(a_smem + ((quad / 2) * kWin + pos) * 32 + (quad % 2) * 16, src, valid);
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
  // its two channels of each 8: 2 (lane % 4) and the next, which the packed
  // weights put at k = lane % 4 and lane % 4 + 4.
  const int frag_row = 64 * warpgroup + 16 * ((tid / 32) % 4) + lane / 4;
  const int frag_ch = 2 * (lane % 4);
  auto mma = [&](int buf) {
    const float* a_stage = reinterpret_cast<const float*>(smem + buf * kStageBytes32);
    const uint32_t b_smem = wg::smem_addr(a_stage) + kABytes32;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int kk = 0; kk < kSteps32; ++kk) {
        // Tap kx: window positions kx further; k8 step kk: 8-channel group kk.
        const float* a = a_stage + (kk * kWin + frag_row + kx) * 8 + frag_ch;
        const float2 r0 = *reinterpret_cast<const float2*>(a);
        const float2 r8 = *reinterpret_cast<const float2*>(a + 8 * 8);
        uint32_t hi[4], lo[4];
        wg::split_tf32(r0.x, hi[0], lo[0]);
        wg::split_tf32(r8.x, hi[1], lo[1]);
        wg::split_tf32(r0.y, hi[2], lo[2]);
        wg::split_tf32(r8.y, hi[3], lo[3]);
        const uint32_t b_hi = b_smem + (kx * (kKC32 / 4) + 2 * kk) * wg::kBN * 16;
        const uint64_t dhi = wg::desc(b_hi, wg::kBN * 16, 128);
        const uint64_t dlo = wg::desc(b_hi + kBPart32, wg::kBN * 16, 128);
        wg::wgmma_group([&] {
          wg::wgmma_m64n128k8_tf32(acc, hi, dhi);
          wg::wgmma_m64n128k8_tf32(acc, hi, dlo);
          wg::wgmma_m64n128k8_tf32(acc, lo, dhi);
        });
      }
    }
  };
  wg::pipeline<kStages32>(steps, acc,
                          reinterpret_cast<uint64_t*>(smem + kStages32 * kStageBytes32), load, mma);

  const size_t image_out = static_cast<size_t>(n) * h * wd;
  wg::epilogue<float>(acc, bias, co0, cout, relu, [&](int r) -> float* {
    const int q = q0 + 64 * warpgroup + r;
    const int y = q / wpad;
    const int xx = q % wpad;
    if (y >= h || xx >= wd) return nullptr;  // past the image, or a pad column
    return out + (image_out + static_cast<size_t>(y) * wd + xx) * cout;
  });
}

}  // namespace

// x (b, h, w, c) f32 or bf16 NHWC, c a multiple of 8; bias (cout) f32; out
// (b, h, w, cout) in x's type. wt: the packed weights of
// ops/conv.pack_conv3x3_weights (bf16: chunks of 32 channels) or
// pack_conv3x3_weights_f32 (f32: TF32 hi and lo, chunks of 16 channels),
// for ceil(cout / 128) output tiles.
// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int conv3x3_launch(const void* x, const void* wt, const void* bias, void* out, int b,
                              int h, int w, int c, int cout, int relu, int is_bf16, void* stream) {
  if (b == 0 || h == 0 || w == 0 || cout == 0) return 0;
  if (c % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  const dim3 grid((h * (w + 2) + wg::kBM - 1) / wg::kBM, (cout + wg::kBN - 1) / wg::kBN, b);
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    conv3x3_bf16_kernel<<<grid, wg::kThreads, kSmem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt), bf,
        static_cast<__nv_bfloat16*>(out), h, w, c, cout, relu, (c + kKC - 1) / kKC);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem32);
    if (err != cudaSuccess) return err;
    conv3x3_f32_kernel<<<grid, wg::kThreads, kSmem32, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), bf, static_cast<float*>(out),
        h, w, c, cout, relu, (c + kKC32 - 1) / kKC32);
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
