// Shared device code of the three paged decode-attention kernels:
//   paged_attn.cu     replaces repro/kernels/paged_attn.py  paged_attention_kernel
//   policy_attn.cu    replaces repro/kernels/policy_attn.py policy_paged_attention_kernel
//   adaptive_attn.cu  replaces repro/kernels/policy_attn.py adaptive_policy_paged_attention_kernel
//
// What bounds them on an H100: bytes.  A decode step reads each resident K/V
// row once, B*P*page*KVH*hd*2*sizeof(T) bytes, against a few flops per byte.
//
// The page step is split in two.  What a page contributes depends only on the
// query and that page: its scores (a __fmaf_rn chain over h in order, then
// __fmul_rn by the scale), its local max m_loc (a warp max), its
// exponentials expf(s - m_loc) and their sum (lane-strided, row j on lane
// j % 32, then warp_sum's butterfly), and its unscaled P.V (for each dim a
// __fmaf_rn chain over the rows in order): split_compute.  Only the fold into
// the running (m, l, acc) is serial, a few float operations per (row, dim)
// per page: fold_slice (fold_l, fold_acc).  The three kernels compute the
// partials with the same code and fold the pages in page order with the same
// code, so their attention output and per-page mass are equal bit for bit on
// equal inputs, and the reference rule (mass >= 1/residents) sees equal
// inputs on the fused and the unfused path.  Every float operation that could
// be contracted or reassociated is written with an explicit round-to-nearest
// intrinsic (__fmaf_rn, __fmul_rn, __fadd_rn, __fdiv_rn), so the result does
// not depend on how the compiler inlines the steps.  Build without
// --use_fast_math: expf and IEEE division are part of the contract.
//
// Each kernel is two launches, so a decode step runs on all SMs.  Launch 1,
// grid (P, KVH, B): one CTA of kSplitThreads per (page, kv head, sequence)
// stages its kv head's slice of the page's valid rows (hd * sizeof(T)
// contiguous bytes a row) into shared memory with 16-byte cp.async, K's
// chunks XOR-swizzled so that the lanes of a quarter warp, one per key row,
// read distinct banks; one page of one kv head is 16 KB of K+V at smollm's
// shape, 32 KB at gemma3's, staged whole, and 8 CTAs fit on an SM at
// smollm's.  The fused kernels (4 and 5) run their page-boundary allocation
// in every CTA of this launch, after the page's loads went out.  It writes
// the page's partials (pv, psum, pmax) to a scratch buffer the wrapper
// allocates; a page with no valid row writes psum 0 and pmax NEG_INF and is
// skipped by the fold.  Launch 2, grid (G * ceil(hd / 64), KVH, B): one CTA
// per (query, 64-dim slice, kv head, sequence) folds the P pages IN PAGE
// ORDER, streaming the slice's partials through shared memory two tiles at a
// time, and writes the slice's output; the last CTA of a sequence
// (__threadfence and an atomic counter it resets to 0) computes the per-page
// mass (and, in kernels 4 and 5, the reference rule, the clock tick and the
// planes; in kernel 5 also the ARC/CAR hit accesses).  The fold is in page
// order, not the textbook per-split combine of flash decoding, so that the
// output does not depend on which CTA folds and the fused kernels equal
// their unfused chains through kernel 3 bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

constexpr float kNegInf = -1e30f;
constexpr int kIntMax = 2147483647;
constexpr int kWarps = 32;  // most warps of a block (policy_common.cuh reductions)
constexpr int kMaxG = 8;  // largest GQA group (queries per KV head)
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's limit on Hopper
// static shared memory of the kernels (policy_common.cuh reductions, the
// adaptive kernel's flag, arrive_last's flag), kept free beside the dynamic
// carve
constexpr size_t kStaticSmem = 1024;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Dims {
  int P;     // pages per sequence
  int page;  // tokens per page
  int KVH;   // KV heads
  int G;     // queries per KV head
  int hd;    // head dim
};

// ---- page math shared by every decode kernel --------------------------------

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Butterfly sum: each step adds a pair in both orders, and IEEE addition is
// commutative, so every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Softmax statistics of one query over a page's scores srow[0, nvalid):
// m_loc = max, the exponentials expf(s - m_loc) written back in place, and
// their sum, lane-strided (row j on lane j % 32) then butterflied.  Called by
// every lane of one warp.
__device__ __forceinline__ void row_stats(float* srow, int nvalid, int lane,
                                          float& m_loc, float& ssum) {
  float mx = kNegInf;
  for (int j = lane; j < nvalid; j += 32) mx = fmaxf(mx, srow[j]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < nvalid; j += 32) {
    const float e = expf(__fsub_rn(srow[j], mx));
    srow[j] = e;
    sum = __fadd_rn(sum, e);
  }
  m_loc = mx;
  ssum = warp_sum(sum);
}

// The fold of one page into one query's running (m, l): m_new = max(m,
// m_loc), corr = exp(m - m_new), sc = exp(m_loc - m_new), l = l*corr +
// ssum*sc.
__device__ __forceinline__ float fold_l(float l, float ssum, float corr, float sc) {
  return __fadd_rn(__fmul_rn(l, corr), __fmul_rn(ssum, sc));
}

// acc = acc*corr + pv*sc
__device__ __forceinline__ float fold_acc(float acc, float pv, float corr, float sc) {
  return __fadd_rn(__fmul_rn(acc, corr), __fmul_rn(pv, sc));
}

// out = acc / max(l, 1e-30)
__device__ __forceinline__ float out_value(float acc, float l) {
  return __fdiv_rn(acc, fmaxf(l, 1e-30f));
}

// One query's term of a page's normalized mass, added to tot:
// psum * exp(pmax - m) / max(l, 1e-30).  Summed over the queries rr = 0..R-1
// in order.
__device__ __forceinline__ float add_mass(float tot, float psum, float pmax, float m,
                                          float l) {
  const float w = __fdiv_rn(expf(__fsub_rn(pmax, m)), fmaxf(l, 1e-30f));
  return __fadd_rn(tot, __fmul_rn(psum, w));
}

// Valid rows of a page: start + row <= cur with start >= 0, a prefix of it.
__device__ __forceinline__ int valid_rows(int start, int cur, int page) {
  return start >= 0 ? max(0, min(cur - start + 1, page)) : 0;
}

// ---- the two launches: partials, then the fold ------------------------------
//
// Launch 1, one CTA per (page, kv head, sequence): the page's partials into
// scratch.  Launch 2, one CTA per (query, 64-dim slice, kv head, sequence):
// the fold of that slice over the pages in page order, then, in the last CTA
// of a sequence, the per-page mass.  The group size G is a template
// parameter of the kernels (with_group), so the per-query loops unroll
// without predication; d.G equals it.

constexpr int kSplitThreads = 128;
constexpr int kSplitBlocks = 8;  // CTAs an SM should hold: at most 64 registers a thread
constexpr int kFoldDims = 64;    // output dims per fold CTA, one thread each
constexpr int kFoldThreads = kFoldDims + 32;  // a warp more for the (m, l) chains
constexpr int kFoldTile = 64;    // pages per buffer of the fold

// 16-byte chunks of one kv head's slice of a row (hd * esize must be a
// multiple of 16: checked by split_launch_bytes)
__host__ __device__ inline int head_chunks(const Dims& d, int esize) {
  return d.hd * esize / 16;
}

// Floats between two queries' rows of scores: the page rounded up to 4, so
// P.V reads four rows' probabilities with one 16-byte load.
__host__ __device__ inline int score_stride(const Dims& d) { return (d.page + 3) & ~3; }

// Bytes of a partials CTA's dynamic shared memory: its kv head's K and V
// rows of the page, the query group as f32, one page of scores.
__host__ __device__ inline size_t split_smem_bytes(const Dims& d, int esize) {
  return 2 * (size_t)d.page * head_chunks(d, esize) * 16 +
         4 * (size_t)d.G * (d.hd + score_stride(d));
}

// Bytes of a fold CTA's dynamic shared memory: two buffers of kFoldTile
// pages' P.V slices, the tile's pmax / psum / corr / sc and flags, the
// sequence's (m, l).
__host__ __device__ inline size_t fold_smem_bytes(const Dims& d) {
  return 4 * (2 * (size_t)kFoldTile * kFoldDims + 5 * (size_t)kFoldTile +
              2 * (size_t)d.KVH * d.G);
}

// Floats of the scratch buffer the wrapper allocates: pv (B, KVH, P, G, hd),
// then psum and pmax (B, P, KVH, G), then (m, l) (B, KVH*G, 2).
__host__ __device__ inline size_t split_scratch_floats(int B, const Dims& d) {
  const size_t R = (size_t)d.KVH * d.G;
  return (size_t)B * d.P * R * d.hd + 2 * (size_t)B * d.P * R + 2 * (size_t)B * R;
}

// Views of the scratch buffer for one launch.
struct SplitScratch {
  float* pv;    // (B, KVH, P, G, hd)
  float* psum;  // (B, P, KVH*G)
  float* pmax;  // (B, P, KVH*G)
  float* ml;    // (B, KVH*G, 2)
};

__device__ inline SplitScratch split_scratch(float* base, int B, const Dims& d) {
  const size_t R = (size_t)d.KVH * d.G, BPR = (size_t)B * d.P * R;
  return SplitScratch{base, base + BPR * d.hd, base + BPR * d.hd + BPR,
                      base + BPR * d.hd + 2 * BPR};
}

struct SplitSmem {
  uint4* kt;  // (page, nch) K rows of this kv head, chunks XOR-swizzled
  uint4* vt;  // (page, nch) V rows
  float* q;   // (G, hd) this kv head's queries as f32
  float* s;   // (G, score_stride) scores, then unnormalized probabilities
};

__device__ inline SplitSmem split_carve(unsigned char* raw, const Dims& d, int esize) {
  const int nch = head_chunks(d, esize);
  SplitSmem sm;
  sm.kt = reinterpret_cast<uint4*>(raw);
  sm.vt = sm.kt + (size_t)d.page * nch;
  sm.q = reinterpret_cast<float*>(sm.vt + (size_t)d.page * nch);
  sm.s = sm.q + d.G * d.hd;
  return sm;
}

struct FoldSmem {
  float* pvb;   // (2, kFoldTile, kFoldDims) P.V slices of two tiles of pages
  float* tmax;  // (kFoldTile) the tile's pmax
  float* tsum;  // (kFoldTile) psum
  float* tcor;  // (kFoldTile) corr
  float* tsc;   // (kFoldTile) sc
  int* tval;    // (kFoldTile) page has a valid row
  float* ml;    // (KVH*G, 2) the sequence's (m, l)
};

__device__ inline FoldSmem fold_carve(unsigned char* raw) {
  FoldSmem sm;
  sm.pvb = reinterpret_cast<float*>(raw);
  sm.tmax = sm.pvb + 2 * kFoldTile * kFoldDims;
  sm.tsum = sm.tmax + kFoldTile;
  sm.tcor = sm.tsum + kFoldTile;
  sm.tsc = sm.tcor + kFoldTile;
  sm.tval = reinterpret_cast<int*>(sm.tsc + kFoldTile);
  sm.ml = reinterpret_cast<float*>(sm.tval + kFoldTile);
  return sm;
}

// Position of chunk c of K row j: XOR-swizzled within whole groups of 8
// chunks, so 8 lanes reading chunk c of 8 consecutive rows hit 8 distinct
// 16-byte bank groups.
__device__ __forceinline__ int swz(int c, int j, int nch) {
  return c < (nch & ~7) ? c ^ (j & 7) : c;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// The 16-byte chunk's elements as f32, in order: a bf16 is the upper half
// of its f32, so the conversion is exact.
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x); f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z); f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// True in the CTA that arrives last at ``counter``, of ``total``; that CTA
// resets the counter to 0.  Every CTA's global writes before the call are
// visible to the last one after it (read them with __ldcg).  Called by
// every thread of the CTA.
__device__ inline bool arrive_last(int* counter, int total) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == total - 1;
    if (last) atomicExch(counter, 0);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Issue the 16-byte cp.async loads of rows row0..row0+n-1 of kv head kh's
// slice of the page (kp / vp: the page's (page, KVH, hd) tile) into kt
// (swizzled) and vt; row ``inj_row`` (-1: none) from inj_k / inj_v (KVH,
// hd).  split_compute waits for them.
template <typename T>
__device__ void split_stage(const SplitSmem& sm, const Dims& d, const T* __restrict__ kp,
                            const T* __restrict__ vp, const T* inj_k, const T* inj_v,
                            int inj_row, int kh, int row0, int n) {
  const int nch = head_chunks(d, sizeof(T));
  const size_t row = (size_t)d.KVH * d.hd;
  auto one = [&](int j, int c) {
    const T* ks = (j == inj_row ? inj_k : kp + j * row) + kh * d.hd;
    const T* vs = (j == inj_row ? inj_v : vp + j * row) + kh * d.hd;
    cp_async16(sm.kt + (size_t)j * nch + swz(c, j, nch),
               reinterpret_cast<const uint4*>(ks) + c);
    cp_async16(sm.vt + (size_t)j * nch + c, reinterpret_cast<const uint4*>(vs) + c);
  };
  if (blockDim.x % nch == 0) {  // each thread keeps one chunk column
    const int step = blockDim.x / nch, c = threadIdx.x % nch;
    for (int j = row0 + threadIdx.x / nch; j < row0 + n; j += step) one(j, c);
  } else {
    for (int i = threadIdx.x; i < n * nch; i += blockDim.x) one(row0 + i / nch, i % nch);
  }
}

// The partials of page p for kv head kh from its nvalid staged rows, into
// scratch, the op sequence of the Pallas body's page-local part: s = q.k *
// scale (one thread per key row, h in order), m_loc = max s, p = exp(s -
// m_loc) and its sum (row_stats, one warp per query), the unscaled P.V (one
// thread per dim, the rows in order), with 16-byte shared-memory loads of K,
// the query and the probabilities.  qb is the sequence's (KVH,
// G, hd) query.  A page with no valid row writes psum 0 and pmax NEG_INF.
// Called by every thread of the CTA; ends with the staged loads complete.
template <typename T, int G>
__device__ void split_compute(const SplitSmem& sm, const Dims& d, const SplitScratch& scr,
                              const T* __restrict__ qb, int b, int kh, int p, int nvalid,
                              float scale) {
  const int hd = d.hd, ss = score_stride(d), R = d.KVH * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t stat = ((size_t)b * d.P + p) * R + (size_t)kh * G;
  if (nvalid == 0) {
    cp_async_wait_all();
    for (int g = tid; g < G; g += blockDim.x) {
      scr.psum[stat + g] = 0.f;
      scr.pmax[stat + g] = kNegInf;
    }
    return;
  }
  const int nch = head_chunks(d, sizeof(T));
  for (int i = tid; i < G * hd; i += blockDim.x)
    sm.q[i] = to_f32<T>(qb[(size_t)kh * G * hd + i]);
  cp_async_wait_all();
  __syncthreads();

  // scores: one thread per key row, all G queries, h in order
  constexpr int kPer = 16 / sizeof(T);  // elements per chunk
  for (int j = tid; j < nvalid; j += blockDim.x) {
    float dot[G];
#pragma unroll
    for (int g = 0; g < G; ++g) dot[g] = 0.f;
    for (int c = 0; c < nch; ++c) {
      float kf[kPer];
      unpack(sm.kt[(size_t)j * nch + swz(c, j, nch)], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4* qv = reinterpret_cast<const float4*>(sm.q + g * hd + c * kPer);
#pragma unroll
        for (int w = 0; w < kPer / 4; ++w) {
          const float4 qq = qv[w];
          dot[g] = __fmaf_rn(qq.x, kf[4 * w], dot[g]);
          dot[g] = __fmaf_rn(qq.y, kf[4 * w + 1], dot[g]);
          dot[g] = __fmaf_rn(qq.z, kf[4 * w + 2], dot[g]);
          dot[g] = __fmaf_rn(qq.w, kf[4 * w + 3], dot[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) sm.s[g * ss + j] = __fmul_rn(dot[g], scale);
  }
  __syncthreads();

  // softmax statistics: one warp per query
  for (int g = warp; g < G; g += nwarps) {
    float mx, sum;
    row_stats(sm.s + (size_t)g * ss, nvalid, lane, mx, sum);
    if (lane == 0) {
      scr.psum[stat + g] = sum;
      scr.pmax[stat + g] = mx;
    }
  }
  __syncthreads();

  // p.v: one thread per dim, all G queries, the rows in order
  float* pv_out = scr.pv + (((size_t)b * d.KVH + kh) * d.P + p) * G * hd;
  const T* vt = reinterpret_cast<const T*>(sm.vt);
  for (int h = tid; h < hd; h += blockDim.x) {
    float pv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) pv[g] = 0.f;
    int j = 0;
    for (; j + 4 <= nvalid; j += 4) {
      float v4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v4[r] = to_f32<T>(vt[(size_t)(j + r) * hd + h]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 s4 = *reinterpret_cast<const float4*>(sm.s + g * ss + j);
        pv[g] = __fmaf_rn(s4.x, v4[0], pv[g]);
        pv[g] = __fmaf_rn(s4.y, v4[1], pv[g]);
        pv[g] = __fmaf_rn(s4.z, v4[2], pv[g]);
        pv[g] = __fmaf_rn(s4.w, v4[3], pv[g]);
      }
    }
    for (; j < nvalid; ++j) {
      const float vv = to_f32<T>(vt[(size_t)j * hd + h]);
#pragma unroll
      for (int g = 0; g < G; ++g) pv[g] = __fmaf_rn(sm.s[g * ss + j], vv, pv[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) pv_out[g * hd + h] = pv[g];
  }
}

// The fold of one (query g of kv head kh, dims h0..h0+kFoldDims-1) slice of
// sequence b over its P pages, in page order, skipping pages with no valid
// row (start_of(p): page p's start): writes the slice of the output row and,
// from the slice at h0 = 0, the query's (m, l) to scratch.  Every thread of
// the fold CTA calls it.  Tile by tile of kFoldTile pages, the P.V slices
// staged with cp.async into two buffers (the next tile's loads in flight
// while this one is folded) and the tile's psum / pmax fetched into
// registers ahead.  fold_l's and fold_acc's operations, split so that only
// the fmax, l and acc chains are serial: the last warp's lane 0 runs the running max
// over the tile, every thread takes corr = exp(m - m_new) and sc = exp(m_loc
// - m_new) of a page, then that lane runs the l chain while thread t <
// kFoldDims runs dim h0 + t's acc chain.  Reads only what launch 1 wrote.
template <typename T, int G, typename StartOf>
__device__ void fold_slice(const FoldSmem& sm, const Dims& d, const SplitScratch& scr,
                           int b, int kh, int g, int h0, int cur, StartOf start_of,
                           T* __restrict__ out_b) {
  const int hd = d.hd, P = d.P, R = d.KVH * G, nel = G * hd;
  const int tid = threadIdx.x, nh = min(kFoldDims, hd - h0);
  const bool chain = tid == kFoldDims;  // runs the (m, l) chains
  const float* pv = scr.pv + ((size_t)b * d.KVH + kh) * P * nel + g * hd + h0;
  const float* pmax = scr.pmax + (size_t)b * P * R + kh * G + g;  // page stride R
  const float* psum = scr.psum + (size_t)b * P * R + kh * G + g;
  float rmax = 0.f, rsum = 0.f;
  int rval = 0;
  auto fetch = [&](int p0) {
    const int n = min(kFoldTile, P - p0), cpr = nh / 4;  // 16-byte chunks a page
    float* dst = sm.pvb + ((p0 / kFoldTile) & 1) * kFoldTile * kFoldDims;
    for (int c = tid; c < n * cpr; c += blockDim.x)
      cp_async16(dst + (c / cpr) * kFoldDims + 4 * (c % cpr),
                 pv + (size_t)(p0 + c / cpr) * nel + 4 * (c % cpr));
    cp_async_commit();
    if (tid < n) {
      rmax = pmax[(size_t)(p0 + tid) * R];
      rsum = psum[(size_t)(p0 + tid) * R];
      rval = valid_rows(start_of(p0 + tid), cur, d.page) > 0;
    }
  };
  float m = kNegInf, l = 0.f, a = 0.f;
  fetch(0);
  for (int p0 = 0; p0 < P; p0 += kFoldTile) {
    const int n = min(kFoldTile, P - p0);
    const float* buf = sm.pvb + ((p0 / kFoldTile) & 1) * kFoldTile * kFoldDims;
    if (tid < n) {
      sm.tmax[tid] = rmax;
      sm.tsum[tid] = rsum;
      sm.tval[tid] = rval;
    }
    if (p0 + kFoldTile < P) {
      fetch(p0 + kFoldTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (chain) {  // the running max: (m before, m after) of each valid page
      for (int u = 0; u < n; ++u) {
        if (!sm.tval[u]) continue;
        const float m_new = fmaxf(m, sm.tmax[u]);
        sm.tcor[u] = m;
        sm.tsc[u] = m_new;
        m = m_new;
      }
    }
    __syncthreads();
    if (tid < n && sm.tval[tid]) {
      const float m_new = sm.tsc[tid];
      sm.tcor[tid] = expf(__fsub_rn(sm.tcor[tid], m_new));
      sm.tsc[tid] = expf(__fsub_rn(sm.tmax[tid], m_new));
    }
    __syncthreads();
    if (chain) {
#pragma unroll 4
      for (int u = 0; u < n; ++u)
        if (sm.tval[u]) l = fold_l(l, sm.tsum[u], sm.tcor[u], sm.tsc[u]);
    } else if (tid < nh) {
#pragma unroll 4
      for (int u = 0; u < n; ++u)
        if (sm.tval[u]) a = fold_acc(a, buf[u * kFoldDims + tid], sm.tcor[u], sm.tsc[u]);
    }
    __syncthreads();
  }
  if (chain) {
    sm.ml[0] = l;
    if (h0 == 0) {
      float* ml = scr.ml + ((size_t)b * R + (size_t)kh * G + g) * 2;
      ml[0] = m;
      ml[1] = l;
    }
  }
  __syncthreads();
  if (tid < nh)
    out_b[((size_t)kh * G + g) * hd + h0 + tid] = from_f32<T>(out_value(a, sm.ml[0]));
}

// Load the sequence's (m, l) of every query into sm.ml, after arrive_last.
// Ends with a barrier.
__device__ inline void load_ml(const FoldSmem& sm, const Dims& d,
                               const SplitScratch& scr, int b) {
  const int R = d.KVH * d.G;
  for (int i = threadIdx.x; i < 2 * R; i += blockDim.x)
    sm.ml[i] = __ldcg(scr.ml + (size_t)b * 2 * R + i);
  __syncthreads();
}

// Normalized mass of page p of sequence b from launch 1's psum / pmax and
// sm.ml (load_ml): the sum over the queries rr in order of psum * exp(pmax -
// m) / max(l, 1e-30) (add_mass).
__device__ inline float split_mass(const FoldSmem& sm, const Dims& d,
                                   const SplitScratch& scr, int b, int p) {
  const int R = d.KVH * d.G;
  const size_t at = ((size_t)b * d.P + p) * R;
  float tot = 0.f;
#pragma unroll 8
  for (int rr = 0; rr < R; ++rr)
    tot = add_mass(tot, scr.psum[at + rr], scr.pmax[at + rr], sm.ml[2 * rr],
                   sm.ml[2 * rr + 1]);
  return tot;
}

// Fold CTAs of a sequence: G queries x ceil(hd / kFoldDims) slices x KVH.
__host__ __device__ inline int fold_slices(const Dims& d) {
  return (d.hd + kFoldDims - 1) / kFoldDims;
}

// Host-side check of a split launch's shapes; returns launch 1's dynamic
// shared memory bytes, 0 if the kernels cannot take them.
inline size_t split_launch_bytes(const Dims& d, int esize) {
  if (d.G < 1 || d.G > kMaxG || d.P < 1 || d.page < 1 || d.KVH < 1 || d.hd < 1)
    return 0;
  if (d.hd * esize % 16) return 0;  // 16-byte chunks of a head's row
  if (d.KVH > 65535) return 0;  // both grids' y dimension
  if (fold_smem_bytes(d) + kStaticSmem > kMaxSmem) return 0;
  const size_t bytes = split_smem_bytes(d, esize);
  return bytes + kStaticSmem <= kMaxSmem ? bytes : 0;
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// f(std::integral_constant<int, G>{}) for the group size G in 1..kMaxG: the
// kernels' template instance for it.
template <typename F>
cudaError_t with_group(int G, F f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro
