// Tiled flash-attention forward with GQA: the port's prefill attention.
//
// Replaces repro/kernels/flash_attn.py flash_attention_kernel (Pallas, TPU).
// q (B, Sq, KVH, G, hd), k / v (B, Skv, KVH, hd), out like q.  Query
// position i attends key position j where
//   j < kv_len  and  (j <= i if causal)  and  (i - j < window if window),
// with f32 scores s = (q.k) * scale, the online softmax in f32 (NEG_INF =
// -1e30 on masked scores, masked p = 0, l clamped at 1e-30, so a fully
// masked row gives 0) and P.V with p kept at f32 precision, as the Pallas
// body does.  expf (exp2f on the bf16 path) and IEEE division: build
// without --use_fast_math.
//
// Design.  The TPU grid's sequential kv axis becomes a loop inside the CTA
// whose bounds are the Pallas ``relevant`` predicate: it starts at the first
// key tile that meets the window of the CTA's first position and stops at
// the causal diagonal of its last (and at kv_len), so skipped tiles cost
// nothing; edge tiles mask per element.  The running (m, l, acc) live in
// registers and the output is written once, after the last tile.  Two
// kernels:
//
// bf16 (flash_attention_bf16_kernel): Hopper's shape of a fast kernel, 384
// threads in three warpgroups.  Two consumer warpgroups each own 64 query
// rows, 64 / G positions x the G query heads of the group (the Pallas block
// (bq, G, hd)); at G = 5, 6, 7 the rows past (64 / G) * G are idle.  One
// thread of the third warpgroup, the producer, loads each warpgroup's Q once
// and then keeps the K and V tiles (BK key rows: 64, or 32 at hd = 256 so
// that the accumulator fits in registers) in flight with TMA
// (cp.async.bulk.tensor) into a ring of kStages = 3 stages in shared
// memory, each tracked by a "full" mbarrier (the bytes landed) and an
// "empty" one (both consumers are done with it); both consumers read every
// tile, so each K/V row is staged once for 128 query rows.  The tensor maps
// are built on the host per call (cuTensorMapEncodeTiled, fetched through
// cudaGetDriverEntryPoint), 128-byte swizzled: a box is 64 bf16 columns
// wide, so a row takes hd / 64 boxes (at hd = 112 the second box holds 48
// columns and TMA's out-of-bounds fill zeroes the other 16; key rows past
// Skv and positions past Sq are zeros likewise).  setmaxnreg moves
// registers from the producer (24) to the consumers (240).
// A consumer runs, per tile: S = Q K^T as an SS wgmma (m64 n BK k16, both
// operands K-major in shared memory, the first k-step at scale-d 0, so no
// instruction but a wgmma writes S's registers); the softmax in f32 on S's
// accumulator registers (a row's max and sum over the 4 lanes that share
// it), in base 2: the scores are scaled by scale * log2(e) so that each
// exponential is one exp2f, the masks run on edge tiles only, and the
// accumulator is rescaled only when a row's max moved; l sums the f32 p.
// P.V cannot take p as one bf16: rounding p to 8 significant bits moves
// outputs far past one bf16 ulp of the f32 result.  Nor as two: hi + lo
// keeps 16 significant bits, an absolute error of about 2^-18 sum(p|v|)/l,
// some 1e-6, which is several bf16 ulps of an output near 0.  So p is split
// as hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid) (each
// difference exact in f32; the three carry p's 24 bits) and acc += hi.V +
// mid.V + lo.V: three RS wgmmas (m64 n hd k16) per 16 keys into one
// accumulator, the A fragments rebuilt in registers from S's accumulator
// layout and V read N-major (the transpose flag).  The schedule: a consumer
// issues S of tile t together with P.V of tile t - 1, waits for S only, and
// runs tile t's softmax and builds its p parts (in the second of two
// register buffers) on the CUDA cores while P.V of t - 1 runs on the
// tensor cores; the first tile's S runs alone and the last tile's P.V after
// the loop.  The two consumers interleave on the SM.  bf16 x bf16 products
// are exact in f32; the tensor cores fix the order of each sum, and no
// atomics or split over keys are used, so a launch repeats bit for bit.
//
// f32 (flash_attention_kernel): one CTA per (64 query rows, kv head, batch
// row), the two products on the CUDA cores in f32 (TF32 tensor cores would
// keep 10 significant bits of q, k, v and p and miss the f32 tolerance).
// 256 threads as 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3, score
// columns tx + 16jj (jj < 4) and output columns tx + 16c (c < hd/16); Q
// (transposed), one K tile, one V tile and the tile's probabilities live in
// shared memory as f32 (114,944 bytes at hd=128, two CTAs per SM); row max
// and sum are butterfly shuffles over the 16 lanes of a row.  K and V are
// staged with 16-byte loads, a group of them in flight per thread (4, or
// all 7 at hd = 112).  It serves only the f32 gate rows.
//
// What bounds it on an H100: operations.  Causal prefill does 4*hd flops per
// unmasked (query head, key) pair against 2*hd*sizeof(T) bytes per key row
// read once per tile: at gemma3's (4, 2048, 16, 2, 128) some 137 GFLOP per
// global layer against 67 MB of q/k/v/out.  The bound reported beside it is
// those flops at the bf16 tensor-core peak (989 TFLOP/s).  The bf16 kernel
// runs 2 times them on the tensor cores (P.V three times: the price of the
// one-ulp gate), so its own floor is twice the bound.  wgmma is the only
// way to the tensor cores' full rate, TMA spends no consumer registers or
// instructions on the loads, and the ring keeps the next tiles landing
// while a tile is computed.  Measured (PERF.md, kernel 6's rows): about
// twice SDPA's time, so the tensor cores run the doubled work at about
// SDPA's rate; the CUDA cores' share is the softmax and the split, which is
// why the masks, p's split and its second buffer are written as they are.
// Next: a persistent grid, a TMA store of the output.
//
// The row's log-sum-exp.  When ``lse`` is not null the finalize step also
// writes lse (B, Sq, KVH, G) in f32, the row's m + log(l) in natural units
// (the bf16 path's base-2 max times ln 2), NEG_INF for a fully masked row:
// what the backward (flash_attn_bwd.cu) recomputes p from.  It is written
// after ``out`` from the same registers, so ``out`` keeps its bits either
// way; prefill passes null.
//
// C entry point (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_flash_attention(dtype, q, k, v, out, lse, B, Sq, Skv, KVH, G, hd,
//                         causal, window, kv_len, scale, stream) -> cudaError_t
// dtype 0 = float32, 1 = bfloat16 for q / k / v / out; hd in {64, 112, 128, 256};
// 1 <= G <= 64; all contiguous and 16-byte aligned; lse f32 or null.  Every
// hd taken is a multiple of 8, so TMA's global strides (a head, a k/v row
// and a q row: hd, KVH * hd and KVH * G * hd bf16 elements) are multiples of
// 16 bytes, as it requires.
#include <cuda.h>  // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;      // query rows (positions x G heads) of a tile
constexpr int kBK = 64;        // key rows per tile (f32)
constexpr int kThreads = 256;  // f32: 16 x 16
constexpr size_t kMaxSmem = 232448;

// ---- bf16: TMA ring, wgmma warpgroups, a producer warp ----------------------

constexpr int kWgThreads = 128;                           // one warpgroup
constexpr int kConsumers = 2;                             // consumer warpgroups
constexpr int kBf16Threads = (kConsumers + 1) * kWgThreads;  // and the producer's
constexpr int kStages = 3;                                // K/V ring depth
constexpr int kProducerRegs = 24, kConsumerRegs = 240;    // setmaxnreg
constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLn2 = 0.693147180559945309f;

template <int HD>
struct WgTile {
  static constexpr int kBK = HD <= 128 ? 64 : 32;  // key rows per tile
  static constexpr int kBoxes = (HD + 63) / 64;    // 64-column (128-byte) boxes of a row
  static constexpr int kQBytes = kBoxes * kRows * 128;  // one warpgroup's Q tile
  static constexpr int kKVBytes = kBoxes * kBK * 128;   // one K (or V) tile
  // 1024 bytes of slack to align the tiles (128-byte swizzle), then the
  // barriers: full[kStages], empty[kStages], q
  static constexpr size_t kSmem =
      1024 + (size_t)kConsumers * kQBytes + 2 * kStages * kKVBytes + 8 * (2 * kStages + 1);
};

// ---- PTX: mbarriers, TMA, wgmma, setmaxnreg

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One box of a 4-D / 5-D tensor map into shared memory at ``dst``; its
// bytes complete on ``bar``.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at ``addr``
// (1024-byte aligned but for a K offset inside the swizzle row): ``lbo``
// the byte stride between 64-column blocks along M/N (an N-major operand;
// unused for a K-major one), ``sbo`` between groups of 8 rows of 128 bytes.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup run on.
template <int N>
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: no access to
// them moves across this point.  Each product's registers are pinned before
// its fence and after its wait: ptxas runs every wgmma of the function one
// at a time (an arrive and a wait each) once another instruction may write a
// wgmma's registers while it is in flight.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(r[i][x])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32: ``ss`` with A and B in
// shared memory, both K-major (S = Q K^T); ``rs`` with A in registers (the
// mma.sync A-fragment layout, per warp its 16 rows) and B N-major (P.V).
template <int N>
struct Gmma;

template <>
struct Gmma<32> {
  // d (64 x 32) (+)= A (64 x 16, smem) . B (16 x 32, smem), both K-major
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %18, 0; "
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, "
        "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, "
        "1, 0, 0; } "
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Gmma<64> {
  // d (64 x 64) (+)= A (64 x 16, smem) . B (16 x 64, smem), both K-major
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
        "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, "
        "%33, p, 1, 1, 0, 0; } "
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x 64) (+)= A (64 x 16, registers) . B (16 x 64, smem, N-major)
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %37, 0; "
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, "
        "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1; } "
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Gmma<112> {
  // d (64 x 112) (+)= A (64 x 16, registers) . B (16 x 112, smem, N-major)
  __device__ __forceinline__ static void rs(float (&d)[56], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %61, 0; "
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {%0, %1, %2, %3, "
        "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
        "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47, %48, %49, %50, %51, %52, %53, %54, %55}, {%56, %57, %58, %59}, "
        "%60, p, 1, 1, 1; } "
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Gmma<128> {
  // d (64 x 128) (+)= A (64 x 16, registers) . B (16 x 128, smem, N-major)
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %69, 0; "
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, "
        "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
        "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
        "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1; } "
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Gmma<256> {
  // d (64 x 256) (+)= A (64 x 16, registers) . B (16 x 256, smem, N-major)
  __device__ __forceinline__ static void rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{ .reg .pred p; setp.ne.b32 p, %133, 0; "
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, "
        "%4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
        "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
        "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, "
        "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, "
        "%89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, "
        "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "
        "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1; } "
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
          "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
          "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
          "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};


// (lo, hi) rounded to bf16 and packed, lo in the low half: one cvt, as
// __floats2bfloat162_rn(lo, hi) gives it, kept in a plain register
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// (x, y) as three bf16x2 pairs (x in the low halves): hi = bf16(.), mid =
// bf16(. - hi), lo = bf16(. - hi - mid).  x - bf16(x) is exact in f32 and
// keeps at most 16 significant bits, its remainder after mid at most 8, so
// hi + mid + lo is x to its last bit or two.  A bf16 half widens to f32 by
// its bits alone (the low half shifted up, the high half masked).
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  hi = pack_bf16x2(x, y);
  const float rx = __fsub_rn(x, __uint_as_float(hi << 16));
  const float ry = __fsub_rn(y, __uint_as_float(hi & 0xffff0000u));
  mid = pack_bf16x2(rx, ry);
  lo = pack_bf16x2(__fsub_rn(rx, __uint_as_float(mid << 16)),
                   __fsub_rn(ry, __uint_as_float(mid & 0xffff0000u)));
}

// acc += hi.V + mid.V + lo.V over a tile's BK keys at shared address
// ``vt`` (V, N-major), 16 keys a step: three RS wgmmas into one
// accumulator, committed as one group
template <int BK, int HD, int PK>
__device__ __forceinline__ void pv_gmmas(float (&o)[HD / 2], const uint32_t (&hi)[PK][4],
                                         const uint32_t (&mid)[PK][4],
                                         const uint32_t (&lo)[PK][4], uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < PK; ++kk) {
    const uint64_t dv = gmma_desc(vt + kk * 16 * 128, BK * 128, 1024);
    Gmma<HD>::rs(o, hi[kk], dv, 1);
    Gmma<HD>::rs(o, mid[kk], dv, 1);
    Gmma<HD>::rs(o, lo[kk], dv, 1);
  }
  gmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
                            int KVH, int G, int causal, int window, int kv_len,
                            float scale_log2) {
  using Tile = WgTile<HD>;
  constexpr int BK = Tile::kBK, NB = Tile::kBoxes;
  constexpr int NT = BK / 8;   // 8-key column blocks of S
  constexpr int ND = HD / 8;   // 8-dim column blocks of the output
  constexpr int KS = HD / 16;  // 16-dim steps of Q K^T
  constexpr int PK = BK / 16;  // 16-key steps of P.V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;  // (wg, box, 64 rows, 128 B)
  const uint32_t ks = qs + kConsumers * Tile::kQBytes;         // (stage, box, BK, 128 B)
  const uint32_t vs = ks + kStages * Tile::kKVBytes;
  const uint32_t bars = vs + kStages * Tile::kKVBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t qbar = bars + 16u * kStages;

  const int tid = threadIdx.x, wg = tid / kWgThreads;
  const int BQ = kRows / G;  // positions per warpgroup
  // the longest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * (kConsumers * BQ);
  const int kh = blockIdx.y, b = blockIdx.z;
  // the kv tiles that meet any row of this CTA (Pallas ``relevant``)
  const int k_begin = window ? max(0, q0 - window + 1) / BK * BK : 0;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, min(Sq, q0 + kConsumers * BQ));
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * kWgThreads);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring's TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers * kWgThreads) {
      uint32_t qbytes = 0;
      for (int w = 0; w < kConsumers; ++w)
        if (q0 + w * BQ < Sq) qbytes += NB * G * BQ * 128;
      mbar_expect_tx(qbar, qbytes);
      // Q rows (position, head) of each warpgroup that has positions
      for (int w = 0; w < kConsumers; ++w)
        if (q0 + w * BQ < Sq)
          for (int c = 0; c < NB; ++c)
            tma_load_5d(qs + w * Tile::kQBytes + c * kRows * 128, &tq, qbar, c * 64, 0, kh,
                        q0 + w * BQ, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages, k0 = k_begin + t * BK;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * Tile::kKVBytes);
        for (int c = 0; c < NB; ++c) {
          tma_load_4d(ks + s * Tile::kKVBytes + c * BK * 128, &tk, full(s), c * 64, kh, k0, b);
          tma_load_4d(vs + s * Tile::kKVBytes + c * BK * 128, &tv, full(s), c * 64, kh, k0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup ``wg``: 64 rows, BQ positions x G heads
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int lane = tid & 31, warp = (tid >> 5) & 3;
    const int wq0 = q0 + wg * BQ;
    const int nq = max(0, min(BQ, Sq - wq0));  // positions of this warpgroup
    const int rows = nq * G;                   // active rows
    // this warpgroup's own tiles [tb, te) of the CTA's: it waits for and
    // releases every stage, so the ring's phases stay in step
    int tb = 0, te = 0;
    if (nq > 0) {
      const int wb = window ? max(0, wq0 - window + 1) / BK * BK : 0;
      const int we = causal ? min(kv_len, wq0 + nq) : kv_len;
      tb = (wb - k_begin) / BK;
      te = max(tb, min(ntiles, we > k_begin ? (we - k_begin + BK - 1) / BK : 0));
    }
    const int wq_last = wq0 + nq - 1;

    // this thread's rows of the warpgroup's 64 (the accumulator layout): r0
    // and r0 + 8; its columns of an 8-wide block: 2 * (lane % 4) and the next
    const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
    const int qp0 = wq0 + r0 / G, qp1 = wq0 + r1 / G;
    const int col = 2 * (lane & 3);
    float m0 = kNegInf, m1 = kNegInf;
    float l0 = 0.f, l1 = 0.f;  // this thread's share of its rows' sums
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    const uint32_t qw = qs + wg * Tile::kQBytes;
    if (nq > 0) mbar_wait(qbar, 0);
    __syncwarp();

    // tile t's K and V have landed / are consumed by this warpgroup
    auto ready = [&](int t) {
      mbar_wait(full(t % kStages), (t / kStages) & 1);
      __syncwarp();
    };
    auto release = [&](int t) { mbar_arrive(empty(t % kStages)); };

    for (int t = 0; t < tb; ++t) {  // the CTA's tiles before this warpgroup's
      ready(t);
      release(t);
    }
    // S of tile t issued with P.V of tile t - 1; the first tile peeled
    float sc[BK / 2];
    // p's parts, two buffers: tile t's in buffer (t - tb) % 2, built while
    // P.V of tile t - 1 reads the other
    uint32_t hi[2][PK][4], mid[2][PK][4], lo[2][PK][4];
    auto issue_s = [&](int t) {
      const uint32_t kt = ks + (t % kStages) * Tile::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        Gmma<BK>::ss(sc, gmma_desc(qw + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024),
                     gmma_desc(kt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
      gmma_commit();
    };
    float c0 = 1.f, c1 = 1.f;
    auto softmax = [&](int t) {
      const int k0 = k_begin + t * BK;
      const bool whole = k0 + BK <= kv_len && (!causal || k0 + BK - 1 <= wq0) &&
                         (!window || wq_last - k0 < window);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = __fmul_rn(sc[i], scale_log2);
      uint32_t keep[NT];  // bit e of keep[j]: element e of block j unmasked
      if (!whole) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          keep[j] = 0xfu;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + col + (e & 1), qp = e < 2 ? qp0 : qp1;
            if (!(kpos < kv_len && (!causal || kpos <= qp) && (!window || qp - kpos < window))) {
              sc[4 * j + e] = kNegInf;
              keep[j] &= ~(1u << e);
            }
          }
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if ((i & 3) < 2)
          mx0 = fmaxf(mx0, sc[i]);
        else
          mx1 = fmaxf(mx1, sc[i]);
      }
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      c0 = exp2f(__fsub_rn(m0, mn0));
      c1 = exp2f(__fsub_rn(m1, mn1));
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = exp2f(__fsub_rn(sc[i], (i & 3) < 2 ? mn0 : mn1));
      if (!whole) {  // masked p = 0 (a row masked so far has mn = NEG_INF)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!((keep[j] >> e) & 1u)) sc[4 * j + e] = 0.f;
      }
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if ((i & 3) < 2)
          sum0 = __fadd_rn(sum0, sc[i]);
        else
          sum1 = __fadd_rn(sum1, sc[i]);
      }
      l0 = __fadd_rn(__fmul_rn(l0, c0), sum0);
      l1 = __fadd_rn(__fmul_rn(l1, c1), sum1);
    };
    auto rescale = [&]() {
      if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {  // a row's max moved
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          o[4 * d] = __fmul_rn(o[4 * d], c0);
          o[4 * d + 1] = __fmul_rn(o[4 * d + 1], c0);
          o[4 * d + 2] = __fmul_rn(o[4 * d + 2], c1);
          o[4 * d + 3] = __fmul_rn(o[4 * d + 3], c1);
        }
      }
    };
    // p's A fragments into buffer ``b``, built in registers from S's
    // accumulator layout: S's blocks 2kk and 2kk + 1 are (r0, keys 16kk +
    // col..), (r1, ..), (r0, keys 16kk + 8 + col..), (r1, ..)
    auto split = [&](auto b) {
      constexpr int B = decltype(b)::value;
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split3_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1], hi[B][kk][x], mid[B][kk][x],
                      lo[B][kk][x]);
    };
    // tile t: S of t with P.V of t - 1 (p in buffer b), then t's softmax and
    // p (into buffer 1 - b) while P.V runs; o is rescaled once P.V is done
    auto step = [&](int t, auto b) {
      constexpr int B = decltype(b)::value;
      ready(t);
      pin(sc);
      pin(o);
      pin(hi[B]);
      pin(mid[B]);
      pin(lo[B]);
      gmma_fence();
      issue_s(t);
      pv_gmmas<BK, HD>(o, hi[B], mid[B], lo[B], vs + ((t - 1) % kStages) * Tile::kKVBytes);
      gmma_wait<1>();
      pin(sc);
      softmax(t);
      split(std::integral_constant<int, 1 - B>());
      asm volatile("" : "+f"(l0), "+f"(l1));  // the sums too, before the wait
      pin(hi[1 - B]);
      pin(mid[1 - B]);
      pin(lo[1 - B]);
      gmma_wait<0>();
      pin(o);
      pin(hi[B]);
      pin(mid[B]);
      pin(lo[B]);
      release(t - 1);
      rescale();
    };
    auto tail = [&](auto b) {  // P.V of the last tile, its p in buffer b
      constexpr int B = decltype(b)::value;
      pin(o);
      pin(hi[B]);
      pin(mid[B]);
      pin(lo[B]);
      gmma_fence();
      pv_gmmas<BK, HD>(o, hi[B], mid[B], lo[B], vs + ((te - 1) % kStages) * Tile::kKVBytes);
      gmma_wait<0>();
      pin(o);
      release(te - 1);
    };
    using Zero = std::integral_constant<int, 0>;
    using One = std::integral_constant<int, 1>;
    if (tb < te) {
      ready(tb);
      pin(sc);
      gmma_fence();
      issue_s(tb);
      gmma_wait<0>();
      pin(sc);
      softmax(tb);  // o is still 0: nothing to rescale
      split(Zero());
      int t = tb + 1;
      for (; t + 1 < te; t += 2) {
        step(t, Zero());
        step(t + 1, One());
      }
      if (t < te) {
        step(t, Zero());
        tail(One());
      } else {
        tail(Zero());
      }
    }
    for (int t = te; t < ntiles; ++t) {  // the CTA's tiles after this warpgroup's
      ready(t);
      release(t);
    }

    // out = acc / max(l, 1e-30), written once
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, o2));
      l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, o2));
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const size_t qrow = (size_t)KVH * G * HD;  // elements per position
    __nv_bfloat16* ob = out + ((size_t)b * Sq + wq0) * qrow + (size_t)kh * G * HD;
    if (r0 < rows) {
      __nv_bfloat16* orow = ob + (size_t)(r0 / G) * qrow + (r0 % G) * HD + col;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * d], d0), __fdiv_rn(o[4 * d + 1], d0));
    }
    if (r1 < rows) {
      __nv_bfloat16* orow = ob + (size_t)(r1 / G) * qrow + (r1 % G) * HD + col;
#pragma unroll
      for (int d = 0; d < ND; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * d + 2], d1), __fdiv_rn(o[4 * d + 3], d1));
    }
    // lse = m * ln 2 + log(l) (m in base 2), by the first of a row's 4 lanes
    if (lse != nullptr && (lane & 3) == 0) {
      float* lb = lse + ((size_t)b * Sq + wq0) * KVH * G + (size_t)kh * G;
      if (r0 < rows)
        lb[(size_t)(r0 / G) * KVH * G + r0 % G] =
            l0 > 0.f ? __fadd_rn(__fmul_rn(m0, kLn2), logf(l0)) : kNegInf;
      if (r1 < rows)
        lb[(size_t)(r1 / G) * KVH * G + r1 % G] =
            l1 > 0.f ? __fadd_rn(__fmul_rn(m1, kLn2), logf(l1)) : kNegInf;
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map over ``rank`` dims (innermost first; ``strides`` in
// bytes for dims 1..rank-1), boxes of ``box``, 128-byte swizzle, zeros out
// of bounds.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int Sq, int Skv, int KVH, int G, int causal, int window,
                        int kv_len, float scale, cudaStream_t stream) {
  using Tile = WgTile<HD>;
  constexpr size_t bytes = Tile::kSmem;
  static_assert(bytes <= kMaxSmem, "bf16 tiles must fit a block");
  const int BQ = kRows / G;
  const cuuint64_t e = 2;  // bytes per element
  // q (B, Sq, KVH, G, HD): boxes of (64 columns, G heads, 1, BQ positions, 1)
  const cuuint64_t qdims[5] = {(cuuint64_t)HD, (cuuint64_t)G, (cuuint64_t)KVH, (cuuint64_t)Sq,
                               (cuuint64_t)B};
  const cuuint64_t qstr[4] = {HD * e, (cuuint64_t)G * HD * e, (cuuint64_t)KVH * G * HD * e,
                              (cuuint64_t)Sq * KVH * G * HD * e};
  const cuuint32_t qbox[5] = {64, (cuuint32_t)G, 1, (cuuint32_t)BQ, 1};
  // k / v (B, Skv, KVH, HD): boxes of (64 columns, 1, BK keys, 1)
  const cuuint64_t kdims[4] = {(cuuint64_t)HD, (cuuint64_t)KVH, (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t kstr[3] = {HD * e, (cuuint64_t)KVH * HD * e, (cuuint64_t)Skv * KVH * HD * e};
  const cuuint32_t kbox[4] = {64, 1, (cuuint32_t)Tile::kBK, 1};
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map(&tq, q, 5, qdims, qstr, qbox);
  if (err == cudaSuccess) err = tensor_map(&tk, k, 4, kdims, kstr, kbox);
  if (err == cudaSuccess) err = tensor_map(&tv, v, 4, kdims, kstr, kbox);
  if (err != cudaSuccess) return err;
  auto kern = flash_attention_bf16_kernel<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kConsumers * BQ - 1) / (kConsumers * BQ), KVH, B);
  kern<<<grid, kBf16Threads, bytes, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse,
                                              Sq, KVH, G, causal, window, kv_len,
                                              scale * kLog2e);
  return cudaGetLastError();
}

// ---- f32: the CUDA cores ----------------------------------------------------

template <int HD>
constexpr size_t smem_floats() {
  // Qt (HD, 64) + Ks (64, HD + 1) + Vs (64, HD) + Pt (64, 64)
  return (size_t)HD * kRows + (size_t)kBK * (HD + 1) + (size_t)kBK * HD +
         (size_t)kBK * kRows;
}

// Pt is (key, row) with the row's 4-groups XOR-swizzled by the key, so the
// 16 lanes of a row group write distinct banks and a float4 read of rows
// 4ty..4ty+3 stays contiguous.
__device__ __forceinline__ int pt_index(int j, int r) {
  return j * kRows + (r ^ ((j & 15) << 2));
}

__device__ __forceinline__ float row_max16(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Butterfly sum over the 16 lanes of a row: each step adds a pair in both
// orders and IEEE addition is commutative, so every lane gets the same bits.
__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 8; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Skv, int KVH, int G, int causal,
                       int window, int kv_len, float scale) {
  constexpr int kC = HD / 16;                 // output columns per thread
  constexpr int kVec = 4;  // elements per 16-byte load
  constexpr int kIters = kBK * HD / kVec / kThreads;  // 16-byte loads per tensor
  // of them in flight: 4, or all where 4 does not divide them (hd = 112: 7)
  constexpr int kGroup = kIters % 4 == 0 ? 4 : kIters <= 8 ? kIters : 1;
  static_assert(kBK * HD / kVec % kThreads == 0 && kIters % kGroup == 0,
                "tile loads must divide");
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // (HD, kRows)
  float* Ks = Qt + HD * kRows;            // (kBK, HD + 1)
  float* Vs = Ks + kBK * (HD + 1);        // (kBK, HD)
  float* Pt = Vs + kBK * HD;              // (kBK, kRows), swizzled

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int BQ = kRows / G;  // positions per tile
  const int q0 = blockIdx.x * BQ;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, Sq - q0);  // positions of this tile
  const int rows = nq * G;          // active rows
  const size_t qrow = (size_t)KVH * G * HD;  // q elements per position

  // Q tile, transposed: row r = position (r / G) x head (r % G); inactive
  // rows are zeros
  const float* qb = q + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
  for (int e = threadIdx.x; e < kRows * HD; e += kThreads) {
    const int r = e % kRows, h = e / kRows;
    float x = 0.f;
    if (r < rows) x = qb[(size_t)(r / G) * qrow + (r % G) * HD + h];
    Qt[h * kRows + r] = x;
  }

  // the kv tiles that meet any row of this tile (Pallas ``relevant``)
  const int q_last = q0 + nq - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window) k_begin = max(0, q0 - window + 1) / kBK * kBK;

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q0 + (4 * ty + i) / G;
  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  const size_t krow = (size_t)KVH * HD;  // k/v elements per position
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks / Vs / Pt are consumed
    // stage K and V rows k0..k0+63 as f32; rows past Skv are zeros
    for (int u0 = 0; u0 < kIters; u0 += kGroup) {
      uint4 ka[kGroup], va[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int idx = (u0 + u) * kThreads + threadIdx.x;
        const int j = idx / (HD / kVec), c = idx % (HD / kVec);
        if (k0 + j < Skv) {
          const size_t off = ((size_t)b * Skv + k0 + j) * krow + (size_t)kh * HD;
          ka[u] = reinterpret_cast<const uint4*>(k + off)[c];
          va[u] = reinterpret_cast<const uint4*>(v + off)[c];
        } else {
          ka[u] = make_uint4(0, 0, 0, 0);
          va[u] = make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int idx = (u0 + u) * kThreads + threadIdx.x;
        const int j = idx / (HD / kVec), c = idx % (HD / kVec);
        const float* ke = reinterpret_cast<const float*>(&ka[u]);
        const float* ve = reinterpret_cast<const float*>(&va[u]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          Ks[j * (HD + 1) + c * kVec + e] = ke[e];
          Vs[j * HD + c * kVec + e] = ve[e];
        }
      }
    }
    __syncthreads();

    // scores of rows 4ty..4ty+3 x keys tx + 16jj
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int h = 0; h < HD; ++h) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + h * kRows + 4 * ty);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float kv = Ks[(tx + 16 * jj) * (HD + 1) + h];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][jj] = __fmaf_rn(qa[i], kv, s[i][jj]);
      }
    }

    // masks, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        ok[jj] = kpos < kv_len && (!causal || kpos <= qpos[i]) &&
                 (!window || qpos[i] - kpos < window);
        s[i][jj] = ok[jj] ? __fmul_rn(s[i][jj], scale) : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = ok[jj] ? expf(__fsub_rn(s[i][jj], m_new)) : 0.f;
        Pt[pt_index(tx + 16 * jj, 4 * ty + i)] = p;
        sum = __fadd_rn(sum, p);
      }
      const float corr = expf(__fsub_rn(m[i], m_new));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr), row_sum16(sum));
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] = __fmul_rn(acc[i][c], corr);
    }
    __syncthreads();

    // acc += p . v over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + pt_index(j, 4 * ty));
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float vv = Vs[j * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = __fmaf_rn(pa[i], vv, acc[i][c]);
      }
    }
  }

  // out = acc / max(l, 1e-30), written once
  float* ob = out + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* orow = ob + (size_t)(r / G) * qrow + (r % G) * HD;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      orow[tx + 16 * c] = __fdiv_rn(acc[i][c], li);
    // lse = m + log(l), by the first of the row's 16 lanes
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * Sq + q0 + r / G) * KVH * G + (size_t)kh * G + r % G] =
          l[i] > 0.f ? __fadd_rn(m[i], logf(l[i])) : kNegInf;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int Sq, int Skv, int KVH, int G, int causal, int window,
                       int kv_len, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_attention_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int BQ = kRows / G;
  const dim3 grid((Sq + BQ - 1) / BQ, KVH, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Skv, KVH, G, causal,
      window, kv_len, scale);
  return cudaGetLastError();
}

// f(std::integral_constant<int, HD>{}) for the head dim hd in {64, 112,
// 128, 256}
template <typename F>
cudaError_t with_head_dim(int hd, F f) {
  switch (hd) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, void* lse, int B, int Sq,
                                     int Skv, int KVH, int G, int hd, int causal,
                                     int window, int kv_len, float scale,
                                     void* stream) {
  using namespace repro;
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || KVH > 65535 || B > 65535 ||
      G < 1 || G > kRows || window < 0 || kv_len < 0 || kv_len > Skv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  return (int)with_head_dim(hd, [&](auto h) {
    constexpr int HD = decltype(h)::value;
    if (dtype == 0)
      return launch_f32<HD>(q, k, v, out, lse_f, B, Sq, Skv, KVH, G, causal, window, kv_len,
                            scale, st);
    if (dtype == 1)
      return launch_bf16<HD>(q, k, v, out, lse_f, B, Sq, Skv, KVH, G, causal, window, kv_len,
                             scale, st);
    return cudaErrorInvalidValue;
  });
}
