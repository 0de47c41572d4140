// The tensor-core core shared by the two 3x3 conv kernels (conv3x3.cu, K5,
// and conv3x3_im2col.cu, K6): an implicit GEMM out (pixels, Cout) =
// A (pixels, K) @ B (K, Cout) on Hopper's warpgroup MMA (`wgmma`, f32
// accumulators in registers), fed through a ring of shared-memory stages:
// the pixel operand by 16-byte `cp.async` copies (each kernel gathers its
// own rows), the prepacked weights of a stage by one TMA bulk copy that
// completes on the stage's `mbarrier`. Two input types:
//
//   * bf16: m64n128k16, both operands read from shared memory by
//     descriptor.
//   * f32 as 3xTF32: m64n128k8 in TF32, A from registers, B from shared
//     memory. Each f32 operand is split into a TF32 high part and a TF32
//     low part, hi = rna(v), lo = rna(v - hi) (`cvt.rna.tf32.f32`; the
//     subtraction is exact), and a k8 step issues hi.Bhi, hi.Blo and
//     lo.Bhi into the same f32 accumulators; the dropped lo.Blo term is
//     below 2^-22 of each product. The weights come split (hi and lo,
//     ops/conv.pack_conv3x3_*weights_f32); each warpgroup loads its A
//     fragment of the staged f32 pixels from shared memory and splits it
//     in registers.
//
// Operand layout in shared memory: the descriptor operands are K-major,
// without swizzle (descriptor layout type 0). A "core matrix" is 8 rows
// (pixels for A, output channels for B) of 16 bytes along K (8 bf16 or 4
// f32 values), stored as 128 contiguous bytes. A stage holds an operand as
// [K-group][row][16 bytes]: rows of one K-group are consecutive 16-byte
// entries, so the descriptor's stride between 8-row groups (SBO) is 128
// bytes, and its stride between the two K-groups of a k16 (bf16) or k8
// (TF32) step (LBO) is the operand's row count x 16 bytes. Any 16-byte-
// aligned start address is a valid operand, so K5 takes the three kx taps
// of one staged input window as three start addresses one row apart, with
// no copy (in f32, as three fragment loads one row apart).
//
// One block: 512 threads, four warpgroups, a BM = 256 x BN = 128 output tile
// (each warpgroup 64 rows, all four sharing each staged B tile); every
// thread also issues copies. Each K-step
// ("stage") is loaded by the kernel's own `load` functor and consumed by its
// `mma` functor; the ring keeps kLookahead stages of copies in flight while
// one group of wgmmas runs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "typed_io.cuh"

namespace conv_wgmma {

constexpr int kBM = 256;       // output rows (pixels) a block
constexpr int kBN = 128;       // output channels a block, the wgmma N
constexpr int kThreads = 512;  // four warpgroups
constexpr int kAcc = kBN / 2;  // f32 accumulators a thread: 64 rows x 128 / 128 threads

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; when `valid` is false nothing is read and the
// 16 bytes are zero-filled (src-size 0): the conv's SAME padding.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// One thread: `bytes` (a multiple of 16, both addresses 16-byte aligned)
// global -> shared by the TMA unit, counted on mbarrier `bar`, which this
// thread's arrival then completes once the bytes have landed.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Wait until the phase of mbarrier `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// Generic-proxy writes (cp.async) made visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor, no swizzle: start address, LBO and SBO in
// 16-byte units (bits 0-13, 16-29, 32-45), layout type 0 (bits 62-63).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving register reads or writes of the
// accumulators across an asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) @ B (16 x 128), both bf16, K-major.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[kAcc], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 8) @ B (8 x 128), both TF32; A from
// registers (a[i] the TF32 bits of this thread's fragment element i), B
// K-major in shared memory. Fragment of thread t of the warpgroup: rows
// 16 (t / 32) + (t % 32) / 4 (a[0], a[2]) and 8 more (a[1], a[3]), columns
// t % 4 (a[0], a[1]) and 4 more (a[2], a[3]).
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[kAcc], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// v = hi + lo + r with hi, lo TF32 values and |r| <= 2^-22 |v|: hi rounded
// to nearest with ties away from zero, lo the exact remainder so rounded.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// One group of wgmmas: the fence that orders this thread's earlier register
// writes (accumulators, A fragments) before them, `issue()`, the commit,
// and a wait until at most this group is in flight, so the previous group's
// shared-memory stage and A registers are free again.
template <typename Issue>
__device__ __forceinline__ void wgmma_group(Issue issue) {
  wgmma_fence();
  issue();
  wgmma_commit();
  wgmma_wait<1>();
}

// The ring: stage s lives in buffer s % kStages, whose weights complete on
// mbarrier bars[s % kStages], for the (s / kStages)-th time. Iteration k
// waits for its own stage's copies and that barrier, makes the copies
// visible to the tensor cores, and after the block barrier (which every
// thread reaches only once the wgmmas of stage k-2 have completed: mma
// issues its wgmmas in `wgmma_group`s, each of which waits for the one
// before it) refills buffer (k-2) % kStages with stage k + kStages - 2.
// load(stage, buffer, bar) issues this thread's copies of a stage (thread 0
// also its weights' bulk copy on `bar`); mma(buffer) issues this
// warpgroup's wgmmas on it. `bars` is kStages mbarriers in shared memory.
template <int kStages, typename Load, typename Mma>
__device__ __forceinline__ void pipeline(int steps, float (&acc)[kAcc], uint64_t* bars, Load load,
                                         Mma mma) {
  constexpr int kLookahead = kStages - 2;
  const uint32_t bar0 = smem_addr(bars);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * i) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kLookahead; ++s) {
    if (s < steps) load(s, s, bar0 + 8 * s);
    cp_async_commit();
  }
  for (int k = 0; k < steps; ++k) {
    cp_async_wait<kLookahead - 1>();
    mbar_wait(bar0 + 8 * (k % kStages), (k / kStages) & 1);
    fence_proxy_async();
    __syncthreads();
    const int next = k + kLookahead;
    if (next < steps) load(next, next % kStages, bar0 + 8 * (next % kStages));
    cp_async_commit();
    fence_acc(acc);
    mma(k % kStages);
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// Epilogue of one warpgroup's 64 x 128 accumulator tile, in registers:
// + bias (f32), optional ReLU, one rounding to the output type T (bf16; f32
// stores the sum as it is), stored to the output row of each of the tile's
// pixels, two adjacent channels a store. Accumulator 4j + i of thread t
// holds row 16 (t / 32) + (t % 32) / 4 (+ 8 for i >= 2) and column
// 8j + 2 (t % 4) (+ 1 for odd i). row_out(r) gives the output row of tile
// row r, or nullptr where the row is padding or past the end.
template <typename T, typename RowOut>
__device__ __forceinline__ void epilogue(const float (&acc)[kAcc], const float* __restrict__ bias,
                                         int co0, int cout, int relu, RowOut row_out) {
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;
  const bool pairs = (cout % 2) == 0;  // a pair is aligned to its own size
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    T* dst = row_out(r0 + 8 * half);
    if (dst == nullptr) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int co = co0 + 8 * j + 2 * (t % 4);
      if (co >= cout) continue;
      float v0 = acc[4 * j + 2 * half] + bias[co];
      if (relu) v0 = fmaxf(v0, 0.0f);
      if (co + 1 < cout) {
        float v1 = acc[4 * j + 2 * half + 1] + bias[co + 1];
        if (relu) v1 = fmaxf(v1, 0.0f);
        if (pairs) {
          store_pair(dst + co, v0, v1);
          continue;
        }
        typed_io::store(dst + co + 1, v1);
      }
      typed_io::store(dst + co, v0);
    }
  }
}

}  // namespace conv_wgmma
