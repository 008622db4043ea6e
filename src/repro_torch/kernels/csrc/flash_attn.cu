// Tiled flash-attention forward with GQA: the port's prefill attention.
//
// Replaces repro/kernels/flash_attn.py flash_attention_kernel (Pallas, TPU).
// q (B, Sq, KVH, G, hd), k / v (B, Skv, KVH, hd), out like q.  Query
// position i attends key position j where
//   j < kv_len  and  (j <= i if causal)  and  (i - j < window if window),
// with f32 scores s = (q.k) * scale, the online softmax in f32 (NEG_INF =
// -1e30 on masked scores, masked p = 0, l clamped at 1e-30, so a fully
// masked row gives 0) and P.V with p kept in f32, as the Pallas body does.
// expf and IEEE division: build without --use_fast_math.
//
// Design.  One CTA per (q tile, kv head, batch row): the tile is 64 query
// rows, BQ = 64 / G positions x the G query heads of the group, so each K/V
// tile is staged once for all G heads (the Pallas block (bq, G, hd)).  The
// TPU grid's sequential kv axis becomes a loop inside the CTA whose bounds
// are the Pallas ``relevant`` predicate: it starts at the first 64-key tile
// that meets the window of the tile's first position and stops at the
// causal diagonal of its last (and at kv_len), so skipped tiles cost
// nothing; edge tiles mask per element, and key rows past Skv are staged as
// zeros.  Q (transposed), one K tile, one V tile and the tile's
// probabilities live in shared memory as f32 (114,944 bytes at hd=128, two
// CTAs per SM); the running (m, l, acc) live in registers.  256 threads as
// 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3, score columns tx +
// 16jj (jj < 4) and output columns tx + 16c (c < hd/16); row max and sum are
// butterfly shuffles over the 16 lanes of a row, so every lane holds the
// same (m, l).  The output is written once, after the last tile.
//
// What bounds it on an H100: operations.  Causal prefill does 4*hd flops per
// unmasked (query head, key) pair against 2*hd*sizeof(T) bytes per key row
// read once per tile: at gemma3's (4, 2048, 16, 2, 128) some 137 GFLOP per
// global layer against 67 MB of q/k/v/out.  This first kernel runs the two
// products on the f32 FMA units (67 TFLOP/s peak), not the tensor cores
// (989 TFLOP/s bf16, the bound reported beside it): mma/wgmma tiles, TMA
// staging and a persistent schedule are later work.
//
// C entry point (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_flash_attention(dtype, q, k, v, out, B, Sq, Skv, KVH, G, hd,
//                         causal, window, kv_len, scale, stream) -> cudaError_t
// dtype 0 = float32, 1 = bfloat16 for q / k / v / out; hd in {64, 128, 256};
// 1 <= G <= 64; all contiguous and 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 64;      // query rows (positions x G heads) per CTA
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr size_t kMaxSmem = 232448;

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int KVH, int G, int causal, int window,
                       int kv_len, float scale) {
  constexpr int kC = HD / 16;                 // output columns per thread
  constexpr int kVec = 16 / (int)sizeof(T);   // elements per 16-byte load
  constexpr int kIters = kBK * HD / kVec / kThreads;  // 16-byte loads per tensor
  constexpr int kGroup = kIters < 4 ? kIters : 4;      // of them in flight
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
  const T* qb = q + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
  for (int e = threadIdx.x; e < kRows * HD; e += kThreads) {
    const int r = e % kRows, h = e / kRows;
    float x = 0.f;
    if (r < rows) x = to_f32<T>(qb[(size_t)(r / G) * qrow + (r % G) * HD + h]);
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
        const T* ke = reinterpret_cast<const T*>(&ka[u]);
        const T* ve = reinterpret_cast<const T*>(&va[u]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          Ks[j * (HD + 1) + c * kVec + e] = to_f32<T>(ke[e]);
          Vs[j * HD + c * kVec + e] = to_f32<T>(ve[e]);
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
  T* ob = out + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = ob + (size_t)(r / G) * qrow + (r % G) * HD;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      orow[tx + 16 * c] = from_f32<T>(__fdiv_rn(acc[i][c], li));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int Sq, int Skv, int KVH, int G, int causal, int window,
                   int kv_len, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int BQ = kRows / G;
  const dim3 grid((Sq + BQ - 1) / BQ, KVH, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, KVH, G, causal, window, kv_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v,
                     void* out, int B, int Sq, int Skv, int KVH, int G, int causal,
                     int window, int kv_len, float scale, cudaStream_t st) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, out, B, Sq, Skv, KVH, G, causal, window, kv_len,
                         scale, st);
  if (hd == 128)
    return launch<T, 128>(q, k, v, out, B, Sq, Skv, KVH, G, causal, window, kv_len,
                          scale, st);
  if (hd == 256)
    return launch<T, 256>(q, k, v, out, B, Sq, Skv, KVH, G, causal, window, kv_len,
                          scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Skv, int KVH, int G, int hd, int causal,
                                     int window, int kv_len, float scale,
                                     void* stream) {
  using namespace repro;
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || KVH > 65535 || B > 65535 ||
      G < 1 || G > kRows || window < 0 || kv_len < 0 || kv_len > Skv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(hd, q, k, v, out, B, Sq, Skv, KVH, G, causal, window,
                                kv_len, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Skv, KVH, G, causal,
                                        window, kv_len, scale, st);
  return (int)cudaErrorInvalidValue;
}
