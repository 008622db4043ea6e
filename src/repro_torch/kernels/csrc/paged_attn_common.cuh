// Shared device code of the two paged decode-attention kernels:
//   paged_attn.cu   replaces repro/kernels/paged_attn.py  paged_attention_kernel
//   policy_attn.cu  replaces repro/kernels/policy_attn.py policy_paged_attention_kernel
//
// Both kernels run the SAME page step (attend_page) and epilogue (finalize)
// from this header, built in one nvcc invocation with the same flags, so the
// fused kernel's attention output and per-page mass equal the unfused
// kernel's bit for bit and the reference rule (mass >= 1/residents) sees
// equal inputs on both paths.  Every float operation that could be
// contracted or reassociated is written with an explicit round-to-nearest
// intrinsic (__fmaf_rn, __fmul_rn, __fadd_rn, __fdiv_rn), so the result
// does not depend on how the compiler inlines the step into each kernel.
// Build without --use_fast_math: expf and IEEE division are part of the
// contract.
//
// Design (one CTA per sequence).  The TPU kernels ran a (B, P) grid whose
// page axis was sequential on one core, carrying the flash state (m, l, acc)
// in VMEM scratch.  Here one CTA owns one sequence and loops over its P
// pages in order; the flash state, the query, one page of scores and the
// per-page partial sums / maxima (psum, pmax: P x KVH x G floats, 30 KB at
// P=256, KVH*G=15) live in shared memory.  A page's valid K and V rows are
// staged into shared memory with 16-byte loads, all issued before any is
// stored, so a chunk of rows costs one memory round trip instead of one per
// key row.  A chunk is as many rows (a multiple of 16 when less than a page)
// as fit beside the rest of the CTA's state under the 227 KB block limit
// (chunk_rows): the whole page at smollm's shapes (K and V staged together),
// 16 rows at gemma3's global layers, where one (KVH=16, hd=128) bf16 row of
// K and one of V take 8 KB.  When a page takes several chunks, K is staged
// chunk by chunk for the scores, the page's max and exponentials are taken
// over the whole page, and V is staged chunk by chunk in the same row order
// for P.V, its partial sums carried in shared memory (pv) between chunks:
// every float operation runs in the same order whatever the chunk size.
// Staged rows are padded to an odd number of 4-byte words, so the lanes of
// a warp, one per key row, read distinct banks.  Threads split the page x
// KVH x G scores (one lane per key row, no shuffles) and the KVH x hd
// accumulator (one thread per (kv head, dim), all G queries of the group).
//
// What bounds it on an H100: bytes.  A decode step reads each resident K/V
// row once, B*P*page*KVH*hd*2*sizeof(T) bytes, against a few flops per byte.
// One CTA per sequence leaves most of the 132 SMs idle at B=4; splitting the
// page loop across CTAs (split-KV with a combine pass) is later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1e30f;
constexpr int kIntMax = 2147483647;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;  // largest GQA group (queries per KV head)
constexpr int kStage = 8;  // 16-byte chunks in flight per thread and tensor
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's limit on Hopper
// static shared memory of the kernels (policy_common.cuh reductions, the
// adaptive kernel's flag), kept free beside the dynamic carve
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
  int chunk;  // K/V rows staged at a time (chunk_rows), set by the host
};

// Shared-memory carve of one CTA.  Floats first, then the int planes the
// fused kernel keeps (post-allocation F, R, page_start).
struct Smem {
  float* q;      // (R, hd) query as f32, R = KVH*G
  float* acc;    // (R, hd) running numerator
  float* m;      // (R) running max
  float* l;      // (R) running denominator
  float* corr;   // (R) exp(m_prev - m_new) of the current page
  float* scale;  // (R) exp(m_loc - m_new) of the current page
  float* s;      // (R, page) scores, then unnormalized probabilities
  float* psum;   // (P, R) per-page local sums
  float* pmax;   // (P, R) per-page local maxima
  float* mass;   // (P) normalized per-page mass
  float* pv;     // (R, hd) P.V partial sums of the current page's chunks
  int* fa;       // (P) post-allocation F
  int* ra;       // (P) post-allocation R
  int* psa;      // (P) post-allocation page_start
  uint32_t* kt;  // (chunk, row_words) staged K rows of the current page
  uint32_t* vt;  // (chunk, row_words) staged V rows
};

// 4-byte words of one staged (KVH, hd) row, padded to an odd count so that
// consecutive rows start in different banks.  The row must be a whole number
// of 16-byte chunks (checked by the entry points).
__host__ __device__ inline int row_words(const Dims& d, int esize) {
  return (d.KVH * d.hd * esize / 4) | 1;
}

// Bytes of the carve without the staged rows.
__host__ __device__ inline size_t fixed_bytes(const Dims& d, bool planes) {
  const size_t R = (size_t)d.KVH * d.G;
  size_t n = 3 * R * d.hd + 4 * R + R * d.page + 2 * (size_t)d.P * R + d.P;
  if (planes) n += 3 * (size_t)d.P;
  return n * 4;
}

__host__ __device__ inline size_t smem_bytes(const Dims& d, bool planes, int esize) {
  return fixed_bytes(d, planes) + 2 * (size_t)d.chunk * row_words(d, esize) * 4;
}

// Rows per staging chunk: the whole page when it fits, else the most rows,
// rounded down to a multiple of 16, that fit beside the largest carve of
// the three kernels (the fused kernels' planes plus the adaptive kernel's
// directory, 5 planes of L = 2P ints) and the static shared memory.  So the
// three kernels stage a page alike at one shape.  0 when not even one row
// fits.
inline int chunk_rows(const Dims& d, int esize) {
  const size_t fixed = fixed_bytes(d, true) + 5 * 2 * (size_t)d.P * 4 + kStaticSmem;
  if (fixed >= kMaxSmem) return 0;
  const size_t row = 2 * (size_t)row_words(d, esize) * 4;  // one K and one V row
  const size_t fit = (kMaxSmem - fixed) / row;
  if (fit >= (size_t)d.page) return d.page;
  return fit >= 16 ? (int)(fit / 16 * 16) : (int)fit;
}

__device__ inline Smem carve(unsigned char* raw, const Dims& d, bool planes,
                             int esize) {
  const int R = d.KVH * d.G;
  float* f = reinterpret_cast<float*>(raw);
  Smem sm;
  sm.q = f;          f += R * d.hd;
  sm.acc = f;        f += R * d.hd;
  sm.m = f;          f += R;
  sm.l = f;          f += R;
  sm.corr = f;       f += R;
  sm.scale = f;      f += R;
  sm.s = f;          f += R * d.page;
  sm.psum = f;       f += d.P * R;
  sm.pmax = f;       f += d.P * R;
  sm.mass = f;       f += d.P;
  sm.pv = f;         f += R * d.hd;
  int* i = reinterpret_cast<int*>(f);
  sm.fa = planes ? i : nullptr;
  sm.ra = planes ? i + d.P : nullptr;
  sm.psa = planes ? i + 2 * d.P : nullptr;
  if (planes) i += 3 * d.P;
  const int rw = row_words(d, esize);
  sm.kt = reinterpret_cast<uint32_t*>(i);
  sm.vt = sm.kt + (size_t)d.chunk * rw;
  return sm;
}

// Copy rows row0..row0+n-1 of this page's tile ``sa`` into rows 0..n-1 of
// ``da`` and, when ``db`` is not null, of ``sb`` into ``db``; row
// ``inj_row`` comes from inj_a / inj_b instead.  Up to kStage 16-byte loads
// per thread and tensor are issued before the first store.  Ends with a
// barrier.
template <typename T>
__device__ void stage_rows(uint32_t* da, const T* __restrict__ sa, const T* inj_a,
                           uint32_t* db, const T* __restrict__ sb, const T* inj_b,
                           int inj_row, int row0, int n, const Dims& d) {
  const int row_elems = d.KVH * d.hd;
  const int chunks = row_elems * (int)sizeof(T) / 16;  // per row
  const int rw = row_words(d, sizeof(T));
  const int total = n * chunks;
  for (int base = 0; base < total; base += kStage * blockDim.x) {
    uint4 a[kStage], b[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int idx = base + u * blockDim.x + threadIdx.x;
      if (idx < total) {
        const int j = row0 + idx / chunks, c = idx % chunks;
        const T* as = j == inj_row ? inj_a : sa + (size_t)j * row_elems;
        a[u] = reinterpret_cast<const uint4*>(as)[c];
        if (db != nullptr) {
          const T* bs = j == inj_row ? inj_b : sb + (size_t)j * row_elems;
          b[u] = reinterpret_cast<const uint4*>(bs)[c];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int idx = base + u * blockDim.x + threadIdx.x;
      if (idx < total) {
        const int j = idx / chunks, c = idx % chunks;
        uint32_t* dst = da + (size_t)j * rw + 4 * c;
        dst[0] = a[u].x; dst[1] = a[u].y; dst[2] = a[u].z; dst[3] = a[u].w;
        if (db != nullptr) {
          dst = db + (size_t)j * rw + 4 * c;
          dst[0] = b[u].x; dst[1] = b[u].y; dst[2] = b[u].z; dst[3] = b[u].w;
        }
      }
    }
  }
  __syncthreads();
}

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

// Load the query (as f32) and reset the flash state.  Ends with a barrier.
template <typename T>
__device__ void init_state(const Smem& sm, const T* __restrict__ qb, const Dims& d) {
  const int R = d.KVH * d.G;
  for (int i = threadIdx.x; i < R * d.hd; i += blockDim.x) {
    sm.q[i] = to_f32<T>(qb[i]);
    sm.acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    sm.m[i] = kNegInf;
    sm.l[i] = 0.f;
  }
  for (int i = threadIdx.x; i < d.P * R; i += blockDim.x) {
    sm.psum[i] = 0.f;
    sm.pmax[i] = kNegInf;
  }
  __syncthreads();
}

// One page's flash-accumulation step, the op sequence of the Pallas body:
//   s = q.k * scale (valid rows only), m_loc = max s, p = exp(s - m_loc),
//   ssum = sum p, m_new = max(m, m_loc), l = l*corr + ssum*scale',
//   acc = acc*corr + (p.v)*scale', psum[p] = ssum, pmax[p] = m_loc.
// kp / vp point at this page's (page, KVH, hd) tile, staged into shared
// memory d.chunk rows at a time.  Row ``inj_row`` (-1: none) is taken from
// inj_k / inj_v (KVH, hd) instead of the tile: the fused kernel injects the
// new token there and leaves the pool read-only.  Valid rows are
// start + row <= cur with start >= 0, a prefix of the page; rows past it are
// never read, so stale data in a just-allocated page cannot reach the sums.
// A page with no valid row leaves the state unchanged exactly (corr = 1, the
// page adds 0), so it is skipped.  Called by every thread of the CTA with
// block-uniform arguments; ends with a barrier.
template <typename T>
__device__ void attend_page(const Smem& sm, const T* __restrict__ kp,
                            const T* __restrict__ vp, const T* inj_k,
                            const T* inj_v, int inj_row, int start, int cur,
                            int p_idx, float scale, const Dims& d) {
  int nvalid = 0;
  if (start >= 0) nvalid = max(0, min(cur - start + 1, d.page));
  if (nvalid == 0) return;
  const int KVH = d.KVH, G = d.G, hd = d.hd, page = d.page, R = KVH * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rw = row_words(d, sizeof(T));
  const int ch = d.chunk;
  const bool whole = nvalid <= ch;  // one chunk: stage K and V together
  if (whole)
    stage_rows<T>(sm.kt, kp, inj_k, sm.vt, vp, inj_v, inj_row, 0, nvalid, d);

  // scores, chunk by chunk: one lane per (kv head, key row)
  for (int r0 = 0; r0 < nvalid; r0 += ch) {
    const int n = min(ch, nvalid - r0);
    if (!whole)
      stage_rows<T>(sm.kt, kp, inj_k, nullptr, nullptr, nullptr, inj_row, r0, n, d);
    const int jchunks = (n + 31) / 32;
    for (int t = warp; t < KVH * jchunks; t += nwarps) {
      const int kh = t % KVH;
      const int jl = (t / KVH) * 32 + lane;
      if (jl < n) {
        const T* krow = reinterpret_cast<const T*>(sm.kt + (size_t)jl * rw) + kh * hd;
        const float* qh = sm.q + (size_t)kh * G * hd;
        float dot[kMaxG];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
#pragma unroll 8
        for (int h = 0; h < hd; ++h) {
          const float kv = to_f32<T>(krow[h]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) dot[g] = __fmaf_rn(qh[g * hd + h], kv, dot[g]);
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) sm.s[(kh * G + g) * page + r0 + jl] = __fmul_rn(dot[g], scale);
      }
    }
    __syncthreads();
  }

  // softmax statistics and the (m, l) update: one warp per (kv head, group)
  for (int rr = warp; rr < R; rr += nwarps) {
    float* srow = sm.s + (size_t)rr * page;
    float mx = kNegInf;
    for (int j = lane; j < nvalid; j += 32) mx = fmaxf(mx, srow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nvalid; j += 32) {
      const float e = expf(__fsub_rn(srow[j], mx));
      srow[j] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float m_prev = sm.m[rr];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(__fsub_rn(m_prev, m_new));
      const float sc = expf(__fsub_rn(mx, m_new));
      sm.l[rr] = __fadd_rn(__fmul_rn(sm.l[rr], corr), __fmul_rn(sum, sc));
      sm.m[rr] = m_new;
      sm.corr[rr] = corr;
      sm.scale[rr] = sc;
      sm.psum[p_idx * R + rr] = sum;
      sm.pmax[p_idx * R + rr] = mx;
    }
  }
  __syncthreads();

  // p.v over the rows in order, chunk by chunk (partial sums in sm.pv), then
  // acc = acc*corr + (p.v)*scale': one thread per (kv head, dim)
  for (int r0 = 0; r0 < nvalid; r0 += ch) {
    const int n = min(ch, nvalid - r0);
    const bool last = r0 + n == nvalid;
    if (!whole)
      stage_rows<T>(sm.vt, vp, inj_v, nullptr, nullptr, nullptr, inj_row, r0, n, d);
    for (int idx = threadIdx.x; idx < KVH * hd; idx += blockDim.x) {
      const int kh = idx / hd, h = idx % hd;
      float pv[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        pv[g] = (g < G && r0 > 0) ? sm.pv[(size_t)(kh * G + g) * hd + h] : 0.f;
#pragma unroll 8
      for (int jl = 0; jl < n; ++jl) {
        const T* vrow = reinterpret_cast<const T*>(sm.vt + (size_t)jl * rw) + kh * hd;
        const float vv = to_f32<T>(vrow[h]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) pv[g] = __fmaf_rn(sm.s[(kh * G + g) * page + r0 + jl], vv, pv[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const int rr = kh * G + g;
          if (last) {
            float* a = sm.acc + (size_t)rr * hd + h;
            *a = __fadd_rn(__fmul_rn(*a, sm.corr[rr]), __fmul_rn(pv[g], sm.scale[rr]));
          } else {
            sm.pv[(size_t)rr * hd + h] = pv[g];
          }
        }
      }
    }
    __syncthreads();
  }
}

// Epilogue: out = acc / max(l, 1e-30) in T, and the normalized per-page mass
//   mass[p] = sum_{kh,g} psum[p] * exp(pmax[p] - m) / max(l, 1e-30),
// written to mass_out and kept in sm.mass.  Ends with a barrier.
template <typename T>
__device__ void finalize(const Smem& sm, T* __restrict__ out_b,
                         float* __restrict__ mass_b, const Dims& d) {
  const int R = d.KVH * d.G, hd = d.hd;
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    const float l = fmaxf(sm.l[i / hd], 1e-30f);
    out_b[i] = from_f32<T>(__fdiv_rn(sm.acc[i], l));
  }
  for (int p = threadIdx.x; p < d.P; p += blockDim.x) {
    float tot = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      const float l = fmaxf(sm.l[rr], 1e-30f);
      const float w = __fdiv_rn(expf(__fsub_rn(sm.pmax[p * R + rr], sm.m[rr])), l);
      tot = __fadd_rn(tot, __fmul_rn(sm.psum[p * R + rr], w));
    }
    sm.mass[p] = tot;
    mass_b[p] = tot;
  }
  __syncthreads();
}

}  // namespace repro
