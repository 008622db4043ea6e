// Backward of kernel 6 (csrc/flash_attn.cu): the gradient of the port's
// flash attention, for training.
//
// The reference has no Pallas kernel here: XLA differentiates its jnp
// flash_attention (repro/models/layers.py:100).  This is the gradient of
// the same function.  q (B, S, KVH, G, hd), k / v (B, S, KVH, hd), out and
// dout like q, lse (B, S, KVH, G) f32 from the forward (m + log(l), natural
// units).  Query position i attends key position j where
//   (j <= i if causal)  and  (i - j < window if window),
// self-attention only (Sq == Skv, every key valid): the training path's
// cases.  With s = (q.k) * scale, p = exp(s - lse) and dp = dout.v,
//   D  = rowsum(dout * out)                       (preprocess)
//   ds = p * (dp - D)
//   dv = sum over rows of p * dout                (dK/dV kernel)
//   dk = scale * sum over rows of ds * q          (dK/dV kernel)
//   dq = scale * sum over keys of ds * k          (dQ kernel)
// with the rows of a key the G query heads of its kv head at every query
// position.  Masked pairs give p = ds = 0, so a fully masked row (lse =
// NEG_INF) gives zero gradients, never NaN.
//
// Design: three launches, every sum in f32 and in a fixed order, and no
// atomics, so the gradient repeats bit for bit from launch to launch.
//   (a) preprocess: one warp per (position, head) row, D in f32.
//   (b) dK/dV: one CTA per (64-key tile, kv head, batch row).  K and V of
//       the tile are staged once (transposed, f32); the CTA walks the query
//       tiles the causal and window masks allow (64 rows each: 64 / G
//       positions x the G heads, as the forward's tiles), staging Q, dO,
//       lse and D, recomputing S^T and dP^T for its 64 x 64 (key, row)
//       pairs, writing P and dS to shared memory, then adding P^T.dO and
//       dS^T.Q into the keys' accumulators, which live in registers until
//       the last tile.
//   (c) dQ: one CTA per (64-row query tile, kv head, batch row), the
//       forward's grid; Q, dO, lse and D staged once (transposed); it walks
//       the key tiles in range, staging K and V, recomputes S and dP, writes
//       dS to shared memory and adds dS.K into the rows' accumulators.
// All products run on the CUDA cores in f32 (bf16 inputs are widened as
// they are staged; outputs are rounded once to the inputs' dtype), 256
// threads as 16 x 16 with 4 x 4 score tiles per thread, the f32 forward's
// layout: padded rows (stride hd + 1) where a warp reads down a column,
// transposed tiles where it reads 4 consecutive rows as one float4, and
// the 64 x 64 P / dS tiles XOR-swizzled by the row.  A simple kernel:
// tensor cores (mma.sync / wgmma) are later work.  expf and IEEE division
// (no --use_fast_math).
//
// C entry point (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_flash_attention_bwd(dtype, q, k, v, out, lse, dout, dq, dk, dv, D,
//                             B, S, KVH, G, hd, causal, window, scale,
//                             stream) -> cudaError_t
// dtype 0 = float32, 1 = bfloat16 for q / k / v / out / dout / dq / dk / dv;
// lse and the D scratch (B, S, KVH, G) f32; hd in {64, 112, 128}; 1 <= G <=
// 64; all contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kT = 64;          // rows (positions x G heads) or keys per tile
constexpr int kThreads = 256;   // 16 x 16
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A 64 x 64 tile (outer, inner) with the inner index's 4-groups XOR-swizzled
// by the outer one: the 16 lanes of a score row group write distinct banks,
// and 4 consecutive inner entries stay one aligned float4.
__device__ __forceinline__ int sw(int outer, int inner) {
  return outer * kT + (inner ^ ((outer & 15) << 2));
}

// (a) D[row] = sum_h dout[row, h] * out[row, h], one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                            float* __restrict__ D, long long rows, int hd) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps: a warp owns one row
  const T* o = out + row * hd;
  const T* g = dout + row * hd;
  float acc = 0.f;
  for (int h = lane; h < hd; h += 32) acc = __fadd_rn(acc, __fmul_rn(to_f(o[h]), to_f(g[h])));
  // butterfly: each step adds a pair in both orders, so every lane ends with
  // the same bits
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) D[row] = acc;
}

template <int HD>
struct BwdTile {
  static constexpr int kC = HD / 16;  // output columns per thread
  // dK/dV: Kt, Vt (HD, 64); Qs, dOs (64, HD + 1); P, dS (64, 64); lse, D (64)
  static constexpr size_t kDkdvBytes =
      (2 * (size_t)HD * kT + 2 * (size_t)kT * (HD + 1) + 2 * kT * kT + 2 * kT) * 4;
  // dQ: Qt, dOt (HD, 64); Ks, Vs (64, HD + 1); dS (64, 64); lse, D (64)
  static constexpr size_t kDqBytes =
      (2 * (size_t)HD * kT + 2 * (size_t)kT * (HD + 1) + kT * kT + 2 * kT) * 4;
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
};

// (b) dK, dV of one 64-key tile
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ D,
                      T* __restrict__ dk, T* __restrict__ dv, int S, int KVH, int G,
                      int causal, int window, float scale) {
  constexpr int kC = BwdTile<HD>::kC;
  constexpr int LD = HD + 1;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;              // (HD, 64)
  float* Vt = Kt + HD * kT;      // (HD, 64)
  float* Qs = Vt + HD * kT;      // (64, HD + 1)
  float* dOs = Qs + kT * LD;     // (64, HD + 1)
  float* Ps = dOs + kT * LD;     // (row, key), swizzled
  float* dSs = Ps + kT * kT;     // (row, key), swizzled
  float* lse_s = dSs + kT * kT;  // (64)
  float* D_s = lse_s + kT;       // (64)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kT, kh = blockIdx.y, b = blockIdx.z;
  const int nk = min(kT, S - k0);
  const size_t krow = (size_t)KVH * HD;      // k/v elements per position
  const size_t qrow = (size_t)KVH * G * HD;  // q elements per position
  const size_t lrow = (size_t)KVH * G;       // lse / D entries per position

  // this tile's K and V, transposed; keys past S are zeros
  for (int e = tid; e < kT * HD; e += kThreads) {
    const int j = e / HD, h = e % HD;
    float kx = 0.f, vx = 0.f;
    if (j < nk) {
      const size_t off = ((size_t)b * S + k0 + j) * krow + (size_t)kh * HD + h;
      kx = to_f(k[off]);
      vx = to_f(v[off]);
    }
    Kt[h * kT + j] = kx;
    Vt[h * kT + j] = vx;
  }

  // the query tiles whose positions see a key of this tile
  const int BQ = kT / G;  // positions per query tile
  const int k_last = k0 + nk - 1;
  const int p_begin = causal ? k0 : 0;
  const int p_end = window ? min(S, k_last + window) : S;
  const int t_begin = p_begin / BQ;
  const int t_end = p_end > p_begin ? (p_end + BQ - 1) / BQ : t_begin;

  float acc_k[4][kC], acc_v[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = t * BQ, nq = min(BQ, S - q0), rows = nq * G;
    __syncthreads();  // the previous tile's Qs / dOs / Ps / dSs are consumed
    // Q and dO rows (row r = position q0 + r / G, head r % G); rows past
    // ``rows`` are zeros
    const T* qb = q + ((size_t)b * S + q0) * qrow + (size_t)kh * G * HD;
    const T* gb = dout + ((size_t)b * S + q0) * qrow + (size_t)kh * G * HD;
    for (int e = tid; e < kT * HD; e += kThreads) {
      const int r = e / HD, h = e % HD;
      float qx = 0.f, gx = 0.f;
      if (r < rows) {
        const size_t off = (size_t)(r / G) * qrow + (r % G) * HD + h;
        qx = to_f(qb[off]);
        gx = to_f(gb[off]);
      }
      Qs[r * LD + h] = qx;
      dOs[r * LD + h] = gx;
    }
    if (tid < kT) {
      const int r = tid;
      const size_t off = ((size_t)b * S + q0 + r / G) * lrow + (size_t)kh * G + r % G;
      lse_s[r] = r < rows ? lse[off] : 0.f;
      D_s[r] = r < rows ? D[off] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T of keys 4ty..4ty+3 x rows tx + 16jj
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int h = 0; h < HD; ++h) {
      const float4 kv4 = *reinterpret_cast<const float4*>(Kt + h * kT + 4 * ty);
      const float4 vv4 = *reinterpret_cast<const float4*>(Vt + h * kT + 4 * ty);
      const float ka[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
      const float va[4] = {vv4.x, vv4.y, vv4.z, vv4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float qx = Qs[(tx + 16 * jj) * LD + h];
        const float gx = dOs[(tx + 16 * jj) * LD + h];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][jj] = __fmaf_rn(ka[i], qx, s[i][jj]);
          dp[i][jj] = __fmaf_rn(va[i], gx, dp[i][jj]);
        }
      }
    }

    // p = exp(s * scale - lse), ds = p * (dp - D); masked pairs 0
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int r = tx + 16 * jj;
      const int qp = q0 + r / G;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + 4 * ty + i;
        const bool ok = r < rows && kpos < S && (!causal || kpos <= qp) &&
                        (!window || qp - kpos < window);
        const float p = ok ? expf(__fsub_rn(__fmul_rn(s[i][jj], scale), lse_s[r])) : 0.f;
        const float ds = ok ? __fmul_rn(p, __fsub_rn(dp[i][jj], D_s[r])) : 0.f;
        Ps[sw(r, 4 * ty + i)] = p;
        dSs[sw(r, 4 * ty + i)] = ds;
      }
    }
    __syncthreads();

    // dV += P^T.dO, dK += dS^T.Q over the tile's rows, in row order
    for (int r = 0; r < rows; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + sw(r, 4 * ty));
      const float4 d4 = *reinterpret_cast<const float4*>(dSs + sw(r, 4 * ty));
      const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
      const float da[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float gx = dOs[r * LD + tx + 16 * c];
        const float qx = Qs[r * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][c] = __fmaf_rn(pa[i], gx, acc_v[i][c]);
          acc_k[i][c] = __fmaf_rn(da[i], qx, acc_k[i][c]);
        }
      }
    }
  }

  // dk = scale * acc_k, dv = acc_v, written once
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * ty + i;
    if (j >= nk) continue;
    const size_t off = ((size_t)b * S + k0 + j) * krow + (size_t)kh * HD;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(__fmul_rn(acc_k[i][c], scale));
      dv[off + tx + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

// (c) dQ of one 64-row query tile
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    T* __restrict__ dq, int S, int KVH, int G, int causal, int window,
                    float scale) {
  constexpr int kC = BwdTile<HD>::kC;
  constexpr int LD = HD + 1;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // (HD, 64)
  float* dOt = Qt + HD * kT;     // (HD, 64)
  float* Ks = dOt + HD * kT;     // (64, HD + 1)
  float* Vs = Ks + kT * LD;      // (64, HD + 1)
  float* dSs = Vs + kT * LD;     // (key, row), swizzled
  float* lse_s = dSs + kT * kT;  // (64)
  float* D_s = lse_s + kT;       // (64)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int BQ = kT / G;  // positions per tile
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal tiles first
  const int kh = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, S - q0), rows = nq * G;
  const size_t krow = (size_t)KVH * HD;
  const size_t qrow = (size_t)KVH * G * HD;
  const size_t lrow = (size_t)KVH * G;

  // Q and dO of the tile, transposed; rows past ``rows`` are zeros
  const T* qb = q + ((size_t)b * S + q0) * qrow + (size_t)kh * G * HD;
  const T* gb = dout + ((size_t)b * S + q0) * qrow + (size_t)kh * G * HD;
  for (int e = tid; e < kT * HD; e += kThreads) {
    const int r = e / HD, h = e % HD;
    float qx = 0.f, gx = 0.f;
    if (r < rows) {
      const size_t off = (size_t)(r / G) * qrow + (r % G) * HD + h;
      qx = to_f(qb[off]);
      gx = to_f(gb[off]);
    }
    Qt[h * kT + r] = qx;
    dOt[h * kT + r] = gx;
  }
  if (tid < kT) {
    const int r = tid;
    const size_t off = ((size_t)b * S + q0 + r / G) * lrow + (size_t)kh * G + r % G;
    lse_s[r] = r < rows ? lse[off] : 0.f;
    D_s[r] = r < rows ? D[off] : 0.f;
  }

  // the key tiles that meet any row of this tile (the forward's range)
  const int q_last = q0 + nq - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int k_begin = window ? max(0, q0 - window + 1) / kT * kT : 0;

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q0 + (4 * ty + i) / G;
  float acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kT) {
    __syncthreads();  // the previous tile's Ks / Vs / dSs are consumed
    for (int e = tid; e < kT * HD; e += kThreads) {
      const int j = e / HD, h = e % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < S) {
        const size_t off = ((size_t)b * S + k0 + j) * krow + (size_t)kh * HD + h;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      Ks[j * LD + h] = kx;
      Vs[j * LD + h] = vx;
    }
    __syncthreads();

    // S and dP of rows 4ty..4ty+3 x keys tx + 16jj
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int h = 0; h < HD; ++h) {
      const float4 q4 = *reinterpret_cast<const float4*>(Qt + h * kT + 4 * ty);
      const float4 g4 = *reinterpret_cast<const float4*>(dOt + h * kT + 4 * ty);
      const float qa[4] = {q4.x, q4.y, q4.z, q4.w};
      const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float kx = Ks[(tx + 16 * jj) * LD + h];
        const float vx = Vs[(tx + 16 * jj) * LD + h];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][jj] = __fmaf_rn(qa[i], kx, s[i][jj]);
          dp[i][jj] = __fmaf_rn(ga[i], vx, dp[i][jj]);
        }
      }
    }

    // ds = exp(s * scale - lse) * (dp - D); masked pairs 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        const bool ok = r < rows && kpos < S && (!causal || kpos <= qpos[i]) &&
                        (!window || qpos[i] - kpos < window);
        float ds = 0.f;
        if (ok) {
          const float p = expf(__fsub_rn(__fmul_rn(s[i][jj], scale), lse_s[r]));
          ds = __fmul_rn(p, __fsub_rn(dp[i][jj], D_s[r]));
        }
        dSs[sw(tx + 16 * jj, r)] = ds;
      }
    }
    __syncthreads();

    // dQ += dS.K over the tile's keys, in key order
    const int nk = min(kT, S - k0);
    for (int j = 0; j < nk; ++j) {
      const float4 d4 = *reinterpret_cast<const float4*>(dSs + sw(j, 4 * ty));
      const float da[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float kx = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = __fmaf_rn(da[i], kx, acc[i][c]);
      }
    }
  }

  // dq = scale * acc, written once
  T* ob = dq + ((size_t)b * S + q0) * qrow + (size_t)kh * G * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    T* orow = ob + (size_t)(r / G) * qrow + (r % G) * HD;
#pragma unroll
    for (int c = 0; c < kC; ++c) orow[tx + 16 * c] = from_f<T>(__fmul_rn(acc[i][c], scale));
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* lse, const void* dout, void* dq, void* dk, void* dv,
                       float* D, int B, int S, int KVH, int G, int causal, int window,
                       float scale, cudaStream_t stream) {
  using Tile = BwdTile<HD>;
  static_assert(Tile::kDkdvBytes <= kMaxSmem && Tile::kDqBytes <= kMaxSmem,
                "tiles must fit a block");
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);

  const long long rows = (long long)B * S * KVH * G;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_preprocess_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(out), gt, D, rows, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, HD>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile::kDkdvBytes);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((S + kT - 1) / kT, KVH, B), kThreads, Tile::kDkdvBytes, stream>>>(
      qt, kt, vt, gt, lf, D, static_cast<T*>(dk), static_cast<T*>(dv), S, KVH, G, causal,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile::kDqBytes);
  if (err != cudaSuccess) return err;
  const int BQ = kT / G;
  dqk<<<dim3((S + BQ - 1) / BQ, KVH, B), kThreads, Tile::kDqBytes, stream>>>(
      qt, kt, vt, gt, lf, D, static_cast<T*>(dq), S, KVH, G, causal, window, scale);
  return cudaGetLastError();
}

// f(std::integral_constant<int, HD>{}) for the head dim hd in {64, 112, 128}
template <typename F>
cudaError_t with_head_dim(int hd, F f) {
  switch (hd) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_attention_bwd(int dtype, const void* q, const void* k,
                                         const void* v, const void* out, const void* lse,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* D, int B, int S, int KVH, int G, int hd,
                                         int causal, int window, float scale, void* stream) {
  using namespace repro;
  if (B < 1 || S < 1 || KVH < 1 || KVH > 65535 || B > 65535 || G < 1 || G > kT ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* Df = static_cast<float*>(D);
  return (int)with_head_dim(hd, [&](auto h) {
    constexpr int HD = decltype(h)::value;
    if (dtype == 0)
      return launch_bwd<float, HD>(q, k, v, out, lse, dout, dq, dk, dv, Df, B, S, KVH, G,
                                   causal, window, scale, st);
    if (dtype == 1)
      return launch_bwd<__nv_bfloat16, HD>(q, k, v, out, lse, dout, dq, dk, dv, Df, B, S,
                                           KVH, G, causal, window, scale, st);
    return cudaErrorInvalidValue;
  });
}
