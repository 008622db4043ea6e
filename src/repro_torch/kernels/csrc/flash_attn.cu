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
// Design.  One CTA per (q tile, kv head, batch row): the tile is 64 query
// rows, BQ = 64 / G positions x the G query heads of the group, so each K/V
// tile is staged once for all G heads (the Pallas block (bq, G, hd)).  The
// TPU grid's sequential kv axis becomes a loop inside the CTA whose bounds
// are the Pallas ``relevant`` predicate: it starts at the first key tile
// that meets the window of the tile's first position and stops at the
// causal diagonal of its last (and at kv_len), so skipped tiles cost
// nothing; edge tiles mask per element, and key rows past Skv are staged as
// zeros.  The running (m, l, acc) live in registers and the output is
// written once, after the last tile.  Two kernels:
//
// bf16 (flash_attention_bf16_kernel): both products on the tensor cores,
// mma.sync.m16n8k16 bf16 x bf16 -> f32.  128 threads, each warp owning 16
// query rows (the PTX helpers: mma_common.cuh, shared with the backward).
// Two buffers of one K and one V tile (kBK key rows: 64, or 32
// at hd = 256 so that the accumulator fits in registers) sit in shared
// memory as bf16 rows of 16-byte chunks, XOR-swizzled by the row so that
// ldmatrix reads 8 rows without a bank conflict (a row's stride is its
// chunk count rounded up to 8, so the XOR stays inside the row: at hd = 112
// a row's 14 chunks take 16 slots); the next tile's K and V
// are in flight (cp.async) while this one is computed.  S = Q K^T takes its
// A fragments from Q and its B fragments from K with ldmatrix; at hd <= 128
// Q's fragments stay in registers, Q being staged once in the second
// buffer, so 64 KB of shared memory and 3 CTAs fit an SM at hd = 128.
// bf16 x bf16 products are exact in f32, only the order of the sum
// changes.  The softmax runs in f32 on S's accumulator fragments (a row's
// max and sum over the 4 lanes that share it), in base 2: the scores are
// scaled by scale * log2(e) so that each exponential is one exp2f, and the
// accumulator is rescaled only when a row's max moved; l sums the f32 p.
// P.V cannot take p as one bf16: rounding p to 8 significant bits moves
// outputs far past one bf16 ulp of the f32 result.  Nor as two: hi + lo
// keeps 16 significant bits, an absolute error of about 2^-18 sum(p|v|)/l,
// some 1e-6, which is several bf16 ulps of an output near 0.  So p is split
// as hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid) (each
// difference exact in f32; the three carry p's 24 bits) and acc += hi.V +
// mid.V + lo.V, three MMAs with the A fragments built in registers from S's
// accumulator layout and V's B fragments from ldmatrix.trans.
//
// f32 (flash_attention_kernel): the two products on the CUDA cores in f32
// (TF32 tensor cores would keep 10 significant bits of q, k, v and p and
// miss the f32 tolerance).  256 threads as 16 x 16: thread (ty, tx) owns
// query rows 4ty..4ty+3, score columns tx + 16jj (jj < 4) and output
// columns tx + 16c (c < hd/16); Q (transposed), one K tile, one V tile and
// the tile's probabilities live in shared memory as f32 (114,944 bytes at
// hd=128, two CTAs per SM); row max and sum are butterfly shuffles over the
// 16 lanes of a row.  K and V are staged with 16-byte loads, a group of them
// in flight per thread (4, or all 7 at hd = 112).
//
// What bounds it on an H100: operations.  Causal prefill does 4*hd flops per
// unmasked (query head, key) pair against 2*hd*sizeof(T) bytes per key row
// read once per tile: at gemma3's (4, 2048, 16, 2, 128) some 137 GFLOP per
// global layer against 67 MB of q/k/v/out.  The bound reported beside it is
// those flops at the bf16 tensor-core peak (989 TFLOP/s); the bf16 kernel
// runs 2 times them on the tensor cores (P.V three times), through mma.sync,
// which does not reach wgmma's rate, with one bf16 Q tile of 64 rows per
// CTA: every warp reads the whole K and V tile from shared memory for its
// 16 rows.  wgmma, TMA staging and a persistent schedule are later work.
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
// 1 <= G <= 64; all contiguous and 16-byte aligned; lse f32 or null.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;      // query rows (positions x G heads) per CTA
constexpr int kBK = 64;        // key rows per tile (f32)
constexpr int kThreads = 256;  // f32: 16 x 16
constexpr size_t kMaxSmem = 232448;

// ---- bf16: both products on the tensor cores --------------------------------

constexpr int kMmaThreads = 128;  // 4 warps of 16 query rows
constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLn2 = 0.693147180559945309f;

template <int HD>
struct MmaTile {
  static constexpr int kBK = HD <= 128 ? 64 : 32;  // key rows per tile
  static constexpr int kNch = HD / 8;              // 16-byte chunks of a row
  static constexpr int kStride = (kNch + 7) & ~7;  // chunk slots of a row
  // Q's A fragments live in registers, and Q is staged in the second
  // buffer's K tile (kRows == kBK rows) before the first tile is issued
  static constexpr bool kQRegs = HD <= 128;
  // two buffers of one K and one V tile (and Q apart at hd = 256), bf16
  static constexpr size_t kSmem = (size_t)((kQRegs ? 0 : kRows) + 4 * kBK) * kStride * 16;
  // CTAs per SM the registers must allow: as many as the shared memory does
  static constexpr int kMinBlocks = HD == 64 ? 4 : HD <= 128 ? 3 : 1;
  static_assert(!kQRegs || kRows == kBK, "Q is staged in a K tile");
};

// (x, y) as three bf16x2 pairs (x in the low halves): hi = bf16(.), mid =
// bf16(. - hi), lo = bf16(. - hi - mid).  x - bf16(x) is exact in f32 and
// keeps at most 16 significant bits, its remainder after mid at most 8, so
// hi + mid + lo is x to its last bit or two.
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = __fsub_rn(x, hf.x), ry = __fsub_rn(y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(__fsub_rn(rx, mf.x), __fsub_rn(ry, mf.y)));
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, MmaTile<HD>::kMinBlocks)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
                            int Skv, int KVH, int G, int causal, int window, int kv_len,
                            float scale_log2) {
  using Tile = MmaTile<HD>;
  constexpr int BK = Tile::kBK, NCH = Tile::kNch, STRIDE = Tile::kStride;
  constexpr int NT = BK / 8;   // 8-key column tiles of S
  constexpr int ND = HD / 8;   // 8-dim column tiles of the output
  constexpr int KS = HD / 16;  // 16-dim steps of Q K^T
  extern __shared__ __align__(128) uint4 smem4[];
  uint4* Ks = smem4;                 // (2, BK, STRIDE)
  uint4* Vs = Ks + 2 * BK * STRIDE;  // (2, BK, STRIDE)
  uint4* Qs = Tile::kQRegs ? Ks + BK * STRIDE : Vs + 2 * BK * STRIDE;  // (kRows, STRIDE)
  // chunk c of row r, XOR-swizzled within the row's STRIDE slots (a
  // multiple of 8)
  auto at = [](int r, int c) { return r * STRIDE + (c ^ (r & 7)); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int BQ = kRows / G;  // positions per tile
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal tiles first
  const int kh = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, Sq - q0);  // positions of this tile
  const int rows = nq * G;          // active rows
  const size_t qrow = (size_t)KVH * G * HD;  // q elements per position
  const size_t krow = (size_t)KVH * HD;      // k/v elements per position
  const __nv_bfloat16* qb = q + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * krow + (size_t)kh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * krow + (size_t)kh * HD;

  // Q tile: row r = position (r / G) x head (r % G); inactive rows are zeros
  for (int i = tid; i < kRows * NCH; i += kMmaThreads) {
    const int r = i / NCH, c = i % NCH;
    const bool in = r < rows;
    cp_async16(Qs + at(r, c), in ? qb + (size_t)(r / G) * qrow + (r % G) * HD + c * 8 : q, in);
  }
  cp_async_commit();

  // the kv tiles that meet any row of this tile (Pallas ``relevant``)
  const int q_last = q0 + nq - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window ? max(0, q0 - window + 1) / BK * BK : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // K and V rows k0..k0+BK-1 into buffer ``buf``; rows past Skv are zeros
  auto load_kv = [&](int k0, int buf) {
    uint4* kd = Ks + buf * BK * STRIDE;
    uint4* vd = Vs + buf * BK * STRIDE;
    for (int i = tid; i < BK * NCH; i += kMmaThreads) {
      const int j = i / NCH, c = i % NCH;
      const bool in = k0 + j < Skv;
      const size_t off = in ? (size_t)(k0 + j) * krow + c * 8 : 0;
      cp_async16(kd + at(j, c), kb + off, in);
      cp_async16(vd + at(j, c), vb + off, in);
    }
    cp_async_commit();
  };
  if (ntiles > 0) load_kv(k_begin, 0);

  // this thread's rows of the warp's 16 (the accumulator layout): r0 and
  // r0 + 8; its columns of an 8-wide tile: 2 * (lane % 4) and the next
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int qp0 = q0 + r0 / G, qp1 = q0 + r1 / G;
  const int col = 2 * (lane & 3);
  float m0 = kNegInf, m1 = kNegInf;
  float l0 = 0.f, l1 = 0.f;  // this thread's share of its rows' sums
  float o[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  // A fragments of Q for dims 16kk..16kk+15
  auto q_frag = [&](int kk, uint32_t(&a)[4]) {
    ldsm_x4(a, Qs + at(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
  };
  uint32_t qf[Tile::kQRegs ? KS : 1][4];
  if (ntiles > 0)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();
  if constexpr (Tile::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) q_frag(kk, qf[kk]);
    __syncthreads();  // Q is read before the second buffer is loaded
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = k_begin + t * BK, buf = t & 1;
    if (t + 1 < ntiles) {
      load_kv(k0 + BK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* kt = Ks + buf * BK * STRIDE;
    const uint4* vt = Vs + buf * BK * STRIDE;

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (Tile::kQRegs) {
#pragma unroll
        for (int x = 0; x < 4; ++x) a[x] = qf[kk][x];
      } else {
        q_frag(kk, a);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + at(jp * 16 + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1)));
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // scale (to base 2) and masks (edge tiles only), then the online-softmax
    // update
    const bool full = k0 + BK <= kv_len && (!causal || k0 + BK - 1 <= q0) &&
                      (!window || q_last - k0 < window);
    uint32_t keep = 0xffffffffu;  // bit 4j + e: element e of tile j unmasked
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], scale_log2);
        if (!full) {
          const int kpos = k0 + 8 * j + col + (e & 1), qp = e < 2 ? qp0 : qp1;
          if (!(kpos < kv_len && (!causal || kpos <= qp) && (!window || qp - kpos < window))) {
            x = kNegInf;
            keep &= ~(1u << (4 * j + e));
          }
        }
        s[j][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(__fsub_rn(m0, mn0)), c1 = exp2f(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = (keep >> (4 * j + e)) & 1u
                            ? exp2f(__fsub_rn(s[j][e], e < 2 ? mn0 : mn1)) : 0.f;
        s[j][e] = p;
        if (e < 2)
          sum0 = __fadd_rn(sum0, p);
        else
          sum1 = __fadd_rn(sum1, p);
      }
    }
    l0 = __fadd_rn(__fmul_rn(l0, c0), sum0);
    l1 = __fadd_rn(__fmul_rn(l1, c1), sum1);
    if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {  // a row's max moved
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][0] = __fmul_rn(o[d][0], c0);
        o[d][1] = __fmul_rn(o[d][1], c0);
        o[d][2] = __fmul_rn(o[d][2], c1);
        o[d][3] = __fmul_rn(o[d][3], c1);
      }
    }

    // acc += hi.V + mid.V + lo.V over the tile's keys, 16 at a time
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], mid[4], lo[4];
      split3_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], mid[0], lo[0]);
      split3_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], mid[1], lo[1]);
      split3_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], mid[2], lo[2]);
      split3_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + at(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  2 * dp + (lane >> 4)));
        mma_bf16(o[2 * dp], hi, bv[0], bv[1]);
        mma_bf16(o[2 * dp], mid, bv[0], bv[1]);
        mma_bf16(o[2 * dp], lo, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], hi, bv[2], bv[3]);
        mma_bf16(o[2 * dp + 1], mid, bv[2], bv[3]);
        mma_bf16(o[2 * dp + 1], lo, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this buffer is consumed before the next load refills it
  }

  // out = acc / max(l, 1e-30), written once
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, o2));
    l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, o2));
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
  if (r0 < rows) {
    __nv_bfloat16* orow = ob + (size_t)(r0 / G) * qrow + (r0 % G) * HD + col;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(__fdiv_rn(o[d][0], d0), __fdiv_rn(o[d][1], d0));
  }
  if (r1 < rows) {
    __nv_bfloat16* orow = ob + (size_t)(r1 / G) * qrow + (r1 % G) * HD + col;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(__fdiv_rn(o[d][2], d1), __fdiv_rn(o[d][3], d1));
  }
  // lse = m * ln 2 + log(l) (m in base 2), by the first of a row's 4 lanes
  if (lse != nullptr && (lane & 3) == 0) {
    float* lb = lse + ((size_t)b * Sq + q0) * KVH * G + (size_t)kh * G;
    if (r0 < rows)
      lb[(size_t)(r0 / G) * KVH * G + r0 % G] =
          l0 > 0.f ? __fadd_rn(__fmul_rn(m0, kLn2), logf(l0)) : kNegInf;
    if (r1 < rows)
      lb[(size_t)(r1 / G) * KVH * G + r1 % G] =
          l1 > 0.f ? __fadd_rn(__fmul_rn(m1, kLn2), logf(l1)) : kNegInf;
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse,
                        int B, int Sq, int Skv, int KVH, int G, int causal, int window,
                        int kv_len, float scale, cudaStream_t stream) {
  constexpr size_t bytes = MmaTile<HD>::kSmem;
  static_assert(bytes <= kMaxSmem, "bf16 tiles must fit a block");
  auto kern = flash_attention_bf16_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int BQ = kRows / G;
  const dim3 grid((Sq + BQ - 1) / BQ, KVH, B);
  kern<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Sq, Skv,
      KVH, G, causal, window, kv_len, scale * kLog2e);
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
