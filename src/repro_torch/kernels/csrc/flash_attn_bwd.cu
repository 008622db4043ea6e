// Backward of kernel 6 (csrc/flash_attn.cu): the gradient of the port's
// flash attention, for training.
//
// The reference has no Pallas kernel here: XLA differentiates its jnp
// flash_attention (repro/models/layers.py:100).  This is the gradient of
// the same function.  q (B, Sq, KVH, G, hd), k / v (B, Skv, KVH, hd), out
// and dout like q, lse (B, Sq, KVH, G) f32 from the forward (m + log(l),
// natural units).  Query position i attends key position j where
//   j < kv_len  and  (j <= i if causal)  and  (i - j < window if window),
// the forward's mask: self-attention (Sq == Skv) and cross-attention (Sq !=
// Skv, whisper's decoder over its encoder) alike, keys at or past kv_len
// masked.  With s = (q.k) * scale, p = exp(s - lse) and dp = dout.v,
//   D  = rowsum(dout * out)                       (preprocess)
//   ds = p * (dp - D)
//   dv = sum over rows of p * dout                (dK/dV kernel)
//   dk = scale * sum over rows of ds * q          (dK/dV kernel)
//   dq = scale * sum over keys of ds * k          (dQ kernel)
// with the rows of a key the G query heads of its kv head at every query
// position.  Masked pairs give p = ds = 0, so a fully masked row (lse =
// NEG_INF) gives zero gradients, never NaN, and a key at or past kv_len
// gets dk = dv = 0 (its K / V rows are never read).
//
// Design: three launches, every sum in f32 and in an order fixed by the
// code, and no atomics, so the gradient repeats bit for bit from launch to
// launch.
//   (a) preprocess: one warp per (query position, head) row of the Sq * G,
//       D in f32.
//   (b) dK/dV: one CTA per (64-key tile of the ceil(Skv / 64), kv head,
//       batch row), the tiles with the most causal work first.  A tile
//       wholly at or past kv_len has no work.  It walks the query tiles
//       whose positions see one of its keys under the causal and window
//       masks (64 rows each: 64 / G positions x the G heads, as the
//       forward's tiles, so the G query heads of a kv head are summed
//       inside the CTA), recomputing S^T and dP^T, and keeps the keys' dK
//       and dV in registers until the last tile.
//   (c) dQ: one CTA per (64-row query tile of the Sq * G rows, kv head,
//       batch row), the forward's grid, the longest causal tiles first.  It
//       walks the key tiles below min(Skv, kv_len) that its rows see,
//       recomputing S and dP, and keeps the rows' dQ in registers.
//
// What bounds it on an H100: operations.  The function needs 10 * hd flops
// per unmasked (query head, key) pair (S, dP, dV, dK, dQ: 2 * hd each), the
// bound reported beside it, at the bf16 tensor-core peak.  The kernel does
// 14 * hd: (c) recomputes S and dP rather than taking dS from (b) through
// device memory (an Sq x Skv matrix per head) or summing dQ with atomics.
//
// bf16: the five products on the tensor cores, mma.sync.m16n8k16 bf16 x
// bf16 -> f32 (mma_common.cuh), 128 threads.  In (b) each warp owns 16
// keys.  S^T = K.Q^T and dP^T = V.dO^T take K's and V's A fragments from
// shared memory and Q's and dO's B fragments with ldmatrix.  p = exp(s *
// scale - lse) and ds = p * (dp - D) are computed in f32 on the accumulator
// fragments (in base 2: one exp2f each), rounded once to bf16 and repacked
// in registers as the A fragments of dV += P^T.dO and dK += dS^T.Q, as the
// forward's P.V builds its A from S; their B fragments come from dO and Q
// with ldmatrix.trans.  At hd 112 / 128 a query tile is taken as two
// sub-tiles of 32 rows, so that S^T and dP^T (16 keys x 32 rows) fit beside
// dK and dV (16 keys x hd each: 128 f32 registers a thread at hd 128).  In
// (c) each warp owns 16 rows: S = Q.K^T and dP = dO.V^T with Q and dO
// staged once, ds as in (b), then dQ += dS.K with K's B fragments from
// ldmatrix.trans.  P and dS never go through shared memory.  Tiles sit in
// shared memory as bf16 rows of 16-byte chunks XOR-swizzled by the row, as
// the forward's (at hd 112 a row's 14 chunks take 16 slots), staged with
// cp.async: the next query tile's Q, dO, lse and D in (b), the next key
// tile's K and V in (c), are in flight while the current one is computed
// (96 KB a CTA at hd 128: two CTAs an SM; three of (c) at hd 64).  Edge
// tiles (keys at or past kv_len, the causal diagonal, the window's edge)
// mask per element before the exponential: a masked pair, a row past the
// tile's last position and a key at or past kv_len give p = ds = 0; such
// keys' rows are staged as zeros.  1500 encoder keys (whisper) end in a
// ragged tile of 28.  Inside a full tile the
// rows past the last position are zeros with lse = D = 0, so they add
// nothing.  Rounding p and
// ds to bf16 moves the gradients by some 2.4e-3 relative L2 of the f32
// closed form, against a gate of 2^-6 (tests/test_torch_flash_bwd.py holds
// a CPU emulation of the scheme to a quarter of the gate): unlike the
// forward's output, held to one bf16 ulp, no product needs p in parts.
//
// f32: the CUDA cores (TF32 tensor cores keep 10 significant bits and
// would miss the f32 gate of 1e-4 of the largest value).  256 threads as
// 16 x 16 with 4 x 4 score tiles per thread, the f32 forward's layout:
// padded rows (stride hd + 1) where a warp reads down a column, transposed
// tiles where it reads 4 consecutive rows as one float4, the 64 x 64 P /
// dS tiles XOR-swizzled by the row.  (b) stages K and V once, recomputes
// S^T and dP^T per query tile, writes P and dS to shared memory and adds
// P^T.dO and dS^T.Q; (c) likewise dS.K.  expf and IEEE division (no
// --use_fast_math).
//
// Between the bf16 kernels and the card's peak: mma.sync issues one 16 x 8
// x 16 product at a time, and every warp reads the whole Q / dO (K / V)
// tile from shared memory for its 16 keys (rows), twice, so shared-memory
// bandwidth and issue slots, not the tensor cores, limit it; the 4 * hd a
// pair that (c) recomputes; (b) at hd 128 holds 255 registers and spills
// 24 bytes.  wgmma over 64 keys a warpgroup with A from
// registers, TMA staging and a persistent schedule over the causal
// triangle are later work.
//
// C entry point (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_flash_attention_bwd(dtype, q, k, v, out, lse, dout, dq, dk, dv, D,
//                             B, Sq, Skv, KVH, G, hd, causal, window,
//                             kv_len, scale, stream) -> cudaError_t
// dtype 0 = float32, 1 = bfloat16 for q / k / v / out / dout / dq / dk / dv;
// lse and the D scratch (B, Sq, KVH, G) f32; hd in {64, 112, 128}; 1 <= G
// <= 64; 0 <= kv_len <= Skv; all contiguous, the bf16 tensors 16-byte
// aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "mma_common.cuh"

namespace repro {
namespace {

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

// (b) f32: dK, dV of one 64-key tile on the CUDA cores
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ D,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int kv_len,
                      int KVH, int G, int causal, int window, float scale) {
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
  const int nk = min(kT, Skv - k0);              // keys of this tile
  const int nvalid = max(0, min(nk, kv_len - k0));  // those below kv_len
  const size_t krow = (size_t)KVH * HD;      // k/v elements per position
  const size_t qrow = (size_t)KVH * G * HD;  // q elements per position
  const size_t lrow = (size_t)KVH * G;       // lse / D entries per position

  // this tile's K and V, transposed; keys at or past kv_len are zeros
  for (int e = tid; e < kT * HD; e += kThreads) {
    const int j = e / HD, h = e % HD;
    float kx = 0.f, vx = 0.f;
    if (j < nvalid) {
      const size_t off = ((size_t)b * Skv + k0 + j) * krow + (size_t)kh * HD + h;
      kx = to_f(k[off]);
      vx = to_f(v[off]);
    }
    Kt[h * kT + j] = kx;
    Vt[h * kT + j] = vx;
  }

  // the query tiles whose positions see a key of this tile below kv_len
  const int BQ = kT / G;  // positions per query tile
  const int k_last = k0 + nvalid - 1;
  const int p_begin = causal ? k0 : 0;
  const int p_end = nvalid == 0 ? 0 : window ? min(Sq, k_last + window) : Sq;
  const int t_begin = p_begin / BQ;
  const int t_end = p_end > p_begin ? (p_end + BQ - 1) / BQ : t_begin;

  float acc_k[4][kC], acc_v[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = t * BQ, nq = min(BQ, Sq - q0), rows = nq * G;
    __syncthreads();  // the previous tile's Qs / dOs / Ps / dSs are consumed
    // Q and dO rows (row r = position q0 + r / G, head r % G); rows past
    // ``rows`` are zeros
    const T* qb = q + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
    const T* gb = dout + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
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
      const size_t off = ((size_t)b * Sq + q0 + r / G) * lrow + (size_t)kh * G + r % G;
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
        const bool ok = r < rows && kpos < kv_len && (!causal || kpos <= qp) &&
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
    const size_t off = ((size_t)b * Skv + k0 + j) * krow + (size_t)kh * HD;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(__fmul_rn(acc_k[i][c], scale));
      dv[off + tx + 16 * c] = from_f<T>(acc_v[i][c]);
    }
  }
}

// (c) f32: dQ of one 64-row query tile on the CUDA cores
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ D,
                    T* __restrict__ dq, int Sq, int Skv, int kv_len, int KVH, int G,
                    int causal, int window, float scale) {
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
  const int nq = min(BQ, Sq - q0), rows = nq * G;
  const size_t krow = (size_t)KVH * HD;
  const size_t qrow = (size_t)KVH * G * HD;
  const size_t lrow = (size_t)KVH * G;

  // Q and dO of the tile, transposed; rows past ``rows`` are zeros
  const T* qb = q + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
  const T* gb = dout + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
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
    const size_t off = ((size_t)b * Sq + q0 + r / G) * lrow + (size_t)kh * G + r % G;
    lse_s[r] = r < rows ? lse[off] : 0.f;
    D_s[r] = r < rows ? D[off] : 0.f;
  }

  // the key tiles below kv_len that meet any row of this tile (the
  // forward's range)
  const int q_last = q0 + nq - 1;
  const int k_end = causal ? min(kv_len, q_last + 1) : kv_len;
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
      if (k0 + j < kv_len) {
        const size_t off = ((size_t)b * Skv + k0 + j) * krow + (size_t)kh * HD + h;
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
        const bool ok = r < rows && kpos < kv_len && (!causal || kpos <= qpos[i]) &&
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

    // dQ += dS.K over the tile's keys below kv_len, in key order
    const int nk = min(kT, kv_len - k0);
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
  T* ob = dq + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    T* orow = ob + (size_t)(r / G) * qrow + (r % G) * HD;
#pragma unroll
    for (int c = 0; c < kC; ++c) orow[tx + 16 * c] = from_f<T>(__fmul_rn(acc[i][c], scale));
  }
}


// ---- bf16: the five products on the tensor cores ----------------------------

constexpr int kMmaThreads = 128;  // 4 warps of 16 keys (dK/dV) or 16 rows (dQ)
constexpr float kLog2e = 1.44269504088896341f;

template <int HD>
struct MmaBwdTile {
  static constexpr int kNch = HD / 8;              // 16-byte chunks of a row
  static constexpr int kStride = (kNch + 7) & ~7;  // chunk slots of a row
  static constexpr int kTile = kT * kStride;       // chunks of a 64-row tile
  // query rows per sub-tile in (b): S^T and dP^T of 16 keys x kSub rows
  // live in registers beside dK and dV
  static constexpr int kSub = HD <= 64 ? 64 : 32;
  // CTAs per SM the registers must allow in (b) and in (c): the shared
  // memory takes two at hd 112 / 128; at hd 64 (c) fits three in 168
  // registers without a spill (some 5 % faster on an H100 at smollm's
  // training shape), and (b) would spill
  static constexpr int kDkdvMinBlocks = 2;
  static constexpr int kDqMinBlocks = HD == 64 ? 3 : 2;
  // (b): K, V, two buffers of Q and dO; two of lse and D; three row tables
  static constexpr size_t kDkdvBytes = (size_t)6 * kTile * 16 + (4 + 3) * kT * 4;
  // (c): Q, dO, two buffers of K and V; lse, D
  static constexpr size_t kDqBytes = (size_t)6 * kTile * 16 + 2 * kT * 4;
};

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return as_u32(__floats2bfloat162_rn(x, y));
}

// (b) bf16: dK, dV of one 64-key tile
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, MmaBwdTile<HD>::kDkdvMinBlocks)
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ D,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int Sq, int Skv, int kv_len, int KVH, int G, int causal,
                           int window, float scale, float scale_log2) {
  using Tile = MmaBwdTile<HD>;
  constexpr int NCH = Tile::kNch, STRIDE = Tile::kStride, TILE = Tile::kTile;
  constexpr int SUB = Tile::kSub;
  constexpr int NT = SUB / 8;  // 8-row column tiles of S^T in a sub-tile
  constexpr int KS = HD / 16;  // 16-dim steps of S^T and dP^T
  constexpr int ND = HD / 8;   // 8-dim column tiles of dK and dV
  extern __shared__ __align__(128) uint4 smem4[];
  uint4* Ks = smem4;          // (64, STRIDE)
  uint4* Vs = Ks + TILE;      // (64, STRIDE)
  uint4* Qs = Vs + TILE;      // (2, 64, STRIDE)
  uint4* Gs = Qs + 2 * TILE;  // dO: (2, 64, STRIDE)
  float* lse_s = reinterpret_cast<float*>(Gs + 2 * TILE);  // (2, 64)
  float* D_s = lse_s + 2 * kT;                             // (2, 64)
  int* roff = reinterpret_cast<int*>(D_s + 2 * kT);  // row r's q / dO offset in a tile
  int* loff = roff + kT;                             // its lse / D offset
  int* rpos = loff + kT;                             // its position in the tile
  // chunk c of row r, XOR-swizzled within the row's STRIDE slots
  auto at = [](int r, int c) { return r * STRIDE + (c ^ (r & 7)); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kT, kh = blockIdx.y, b = blockIdx.z;
  const int nk = min(kT, Skv - k0);                 // keys of this tile
  const int nvalid = max(0, min(nk, kv_len - k0));  // those below kv_len
  const size_t krow = (size_t)KVH * HD;      // k/v elements per position
  const size_t qrow = (size_t)KVH * G * HD;  // q elements per position
  const size_t lrow = (size_t)KVH * G;       // lse / D entries per position
  const int BQ = kT / G;                     // positions per query tile

  // this tile's K and V; keys at or past kv_len are zeros
  const __nv_bfloat16* kb = k + ((size_t)b * Skv + k0) * krow + (size_t)kh * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv + k0) * krow + (size_t)kh * HD;
  for (int i = tid; i < kT * NCH; i += kMmaThreads) {
    const int j = i / NCH, c = i % NCH;
    const bool in = j < nvalid;
    const size_t off = in ? (size_t)j * krow + c * 8 : 0;
    cp_async16(Ks + at(j, c), kb + off, in);
    cp_async16(Vs + at(j, c), vb + off, in);
  }
  cp_async_commit();
  // row r of a query tile = position r / G x head r % G, the same in every tile
  if (tid < kT) {
    const int p = tid / G, h = tid - p * G;
    roff[tid] = p * (int)qrow + h * HD;
    loff[tid] = p * (int)lrow + h;
    rpos[tid] = p;
  }
  __syncthreads();

  // the query tiles whose positions see a key of this tile below kv_len
  const int k_last = k0 + nvalid - 1;
  const int p_begin = causal ? k0 : 0;
  const int p_end = nvalid == 0 ? 0 : window ? min(Sq, k_last + window) : Sq;
  const int t_begin = p_begin / BQ;
  const int t_end = p_end > p_begin ? (p_end + BQ - 1) / BQ : t_begin;

  // Q, dO, lse and D of query tile t into buffer ``buf``; rows past the
  // tile's last position are zeros
  auto load_q = [&](int t, int buf) {
    const int q0 = t * BQ, rows = min(BQ, Sq - q0) * G;
    const __nv_bfloat16* qb = q + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
    const __nv_bfloat16* gb = dout + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
    uint4* qd = Qs + buf * TILE;
    uint4* gd = Gs + buf * TILE;
    for (int i = tid; i < kT * NCH; i += kMmaThreads) {
      const int r = i / NCH, c = i % NCH;
      const bool in = r < rows;
      const size_t off = in ? (size_t)roff[r] + c * 8 : 0;
      cp_async16(qd + at(r, c), qb + off, in);
      cp_async16(gd + at(r, c), gb + off, in);
    }
    if (tid < kT) {
      const bool in = tid < rows;
      const size_t off = in ? ((size_t)b * Sq + q0) * lrow + (size_t)kh * G + loff[tid] : 0;
      cp_async4(lse_s + buf * kT + tid, lse + off, in);
      cp_async4(D_s + buf * kT + tid, D + off, in);
    }
    cp_async_commit();
  };

  // this thread's keys (the accumulator layout): kr and kr + 8 of the CTA's
  // 64; its columns of an 8-wide tile: col and col + 1
  const int kr = warp * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[d][e] = acc_v[d][e] = 0.f;

  const int ntiles = t_end - t_begin;
  if (ntiles > 0) load_q(t_begin, 0);
  for (int n = 0; n < ntiles; ++n) {
    const int t = t_begin + n, buf = n & 1;
    if (n + 1 < ntiles) {
      load_q(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = t * BQ, nq = min(BQ, Sq - q0), rows = nq * G;
    // every (key, position) pair of the tile unmasked: no per-element mask
    const bool full = k0 + kT <= kv_len && (!causal || k0 + kT - 1 <= q0) &&
                      (!window || q0 + nq - 1 - k0 < window);
    const uint4* qt = Qs + buf * TILE;
    const uint4* gt = Gs + buf * TILE;
    const float* lt = lse_s + buf * kT;
    const float* dt = D_s + buf * kT;

#pragma unroll
    for (int sub = 0; sub < kT / SUB; ++sub) {
      const int rb = sub * SUB;  // the sub-tile's first row
      // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x SUB rows
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, Ks + at(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
        ldsm_x4(av, Vs + at(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          const int br = rb + jp * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int bc = 2 * kk + ((lane >> 3) & 1);
          uint32_t bq[4], bg[4];
          ldsm_x4(bq, qt + at(br, bc));
          ldsm_x4(bg, gt + at(br, bc));
          mma_bf16(st[2 * jp], ak, bq[0], bq[1]);
          mma_bf16(st[2 * jp + 1], ak, bq[2], bq[3]);
          mma_bf16(dpt[2 * jp], av, bg[0], bg[1]);
          mma_bf16(dpt[2 * jp + 1], av, bg[2], bg[3]);
        }
      }

      // p = exp(s * scale - lse) into st, ds = p * (dp - D) into dpt;
      // element e of column tile j: key kr + 8 (e / 2), row rb + 8j + col +
      // e % 2; masked pairs 0
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rb + 8 * j + col + (e & 1);
          bool ok = true;
          if (!full) {
            const int kpos = k0 + kr + 8 * (e >> 1), qp = q0 + rpos[r];
            ok = r < rows && kpos < kv_len && (!causal || kpos <= qp) &&
                 (!window || qp - kpos < window);
          }
          const float p =
              ok ? exp2f(__fmaf_rn(st[j][e], scale_log2, -__fmul_rn(lt[r], kLog2e))) : 0.f;
          st[j][e] = p;
          dpt[j][e] = ok ? __fmul_rn(p, __fsub_rn(dpt[j][e], dt[r])) : 0.f;
        }
      }

      // dV += P^T.dO and dK += dS^T.Q over the sub-tile's rows, 16 at a
      // time; A from the accumulators (one bf16 rounding), B by
      // ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < SUB / 16; ++kk) {
        const uint32_t ap[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        const uint32_t ad[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                                pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                                pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
        const int br = rb + kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t bg[4], bq[4];
          ldsm_x4_trans(bg, gt + at(br, 2 * dp + (lane >> 4)));
          ldsm_x4_trans(bq, qt + at(br, 2 * dp + (lane >> 4)));
          mma_bf16(acc_v[2 * dp], ap, bg[0], bg[1]);
          mma_bf16(acc_v[2 * dp + 1], ap, bg[2], bg[3]);
          mma_bf16(acc_k[2 * dp], ad, bq[0], bq[1]);
          mma_bf16(acc_k[2 * dp + 1], ad, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // this buffer is consumed before the next load refills it
  }

  // dk = scale * acc_k, dv = acc_v, rounded once to bf16 and written once
  __nv_bfloat16* dkb = dk + ((size_t)b * Skv + k0) * krow + (size_t)kh * HD + col;
  __nv_bfloat16* dvb = dv + ((size_t)b * Skv + k0) * krow + (size_t)kh * HD + col;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = kr + 8 * half;
    if (j >= nk) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)j * krow + 8 * d) =
          __floats2bfloat162_rn(__fmul_rn(acc_k[d][2 * half], scale),
                                __fmul_rn(acc_k[d][2 * half + 1], scale));
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)j * krow + 8 * d) =
          __floats2bfloat162_rn(acc_v[d][2 * half], acc_v[d][2 * half + 1]);
    }
  }
}

// (c) bf16: dQ of one 64-row query tile
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, MmaBwdTile<HD>::kDqMinBlocks)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ D,
                         __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int kv_len,
                         int KVH, int G, int causal, int window, float scale,
                         float scale_log2) {
  using Tile = MmaBwdTile<HD>;
  constexpr int NCH = Tile::kNch, STRIDE = Tile::kStride, TILE = Tile::kTile;
  constexpr int NT = kT / 8;   // 8-key column tiles of S
  constexpr int KS = HD / 16;  // 16-dim steps of S and dP
  constexpr int ND = HD / 8;   // 8-dim column tiles of dQ
  extern __shared__ __align__(128) uint4 smem4[];
  uint4* Qs = smem4;          // (64, STRIDE)
  uint4* Gs = Qs + TILE;      // dO: (64, STRIDE)
  uint4* Ks = Gs + TILE;      // (2, 64, STRIDE)
  uint4* Vs = Ks + 2 * TILE;  // (2, 64, STRIDE)
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * TILE);  // (64)
  float* D_s = lse_s + kT;                                 // (64)
  auto at = [](int r, int c) { return r * STRIDE + (c ^ (r & 7)); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int BQ = kT / G;  // positions per tile
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal tiles first
  const int kh = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, Sq - q0), rows = nq * G;
  const size_t krow = (size_t)KVH * HD;
  const size_t qrow = (size_t)KVH * G * HD;
  const size_t lrow = (size_t)KVH * G;

  // Q, dO, lse and D of the tile; rows past ``rows`` are zeros
  const __nv_bfloat16* qb = q + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
  const __nv_bfloat16* gb = dout + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD;
  for (int i = tid; i < kT * NCH; i += kMmaThreads) {
    const int r = i / NCH, c = i % NCH;
    const bool in = r < rows;
    const size_t off = in ? (size_t)(r / G) * qrow + (r % G) * HD + c * 8 : 0;
    cp_async16(Qs + at(r, c), qb + off, in);
    cp_async16(Gs + at(r, c), gb + off, in);
  }
  if (tid < kT) {
    const bool in = tid < rows;
    const size_t off =
        in ? ((size_t)b * Sq + q0 + tid / G) * lrow + (size_t)kh * G + tid % G : 0;
    cp_async4(lse_s + tid, lse + off, in);
    cp_async4(D_s + tid, D + off, in);
  }
  cp_async_commit();

  // the key tiles below kv_len that meet any row of this tile (the
  // forward's range)
  const int q_last = q0 + nq - 1;
  const int k_end = causal ? min(kv_len, q_last + 1) : kv_len;
  const int k_begin = window ? max(0, q0 - window + 1) / kT * kT : 0;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kT - 1) / kT : 0;

  // K and V rows k0..k0+63 into buffer ``buf``; rows at or past kv_len are
  // zeros
  const __nv_bfloat16* kb = k + (size_t)b * Skv * krow + (size_t)kh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * krow + (size_t)kh * HD;
  auto load_kv = [&](int k0, int buf) {
    uint4* kd = Ks + buf * TILE;
    uint4* vd = Vs + buf * TILE;
    for (int i = tid; i < kT * NCH; i += kMmaThreads) {
      const int j = i / NCH, c = i % NCH;
      const bool in = k0 + j < kv_len;
      const size_t off = in ? (size_t)(k0 + j) * krow + c * 8 : 0;
      cp_async16(kd + at(j, c), kb + off, in);
      cp_async16(vd + at(j, c), vb + off, in);
    }
    cp_async_commit();
  };
  if (ntiles > 0) load_kv(k_begin, 0);

  // this thread's rows of the warp's 16 (the accumulator layout): r0 and
  // r0 + 8; its columns of an 8-wide tile: col and col + 1
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int qp0 = q0 + r0 / G, qp1 = q0 + r1 / G;
  const int col = 2 * (lane & 3);
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  if (ntiles > 0)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();
  const float l0 = __fmul_rn(lse_s[r0], kLog2e), l1 = __fmul_rn(lse_s[r1], kLog2e);
  const float D0 = D_s[r0], D1 = D_s[r1];

  for (int n = 0; n < ntiles; ++n) {
    const int k0 = k_begin + n * kT, buf = n & 1;
    if (n + 1 < ntiles) {
      load_kv(k0 + kT, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint4* kt = Ks + buf * TILE;
    const uint4* vt = Vs + buf * TILE;

    // S = Q.K^T and dP = dO.V^T: 16 rows x 64 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ag[4];
      ldsm_x4(aq, Qs + at(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
      ldsm_x4(ag, Gs + at(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        const int br = jp * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int bc = 2 * kk + ((lane >> 3) & 1);
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, kt + at(br, bc));
        ldsm_x4(bv, vt + at(br, bc));
        mma_bf16(s[2 * jp], aq, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * jp], ag, bv[0], bv[1]);
        mma_bf16(dp[2 * jp + 1], ag, bv[2], bv[3]);
      }
    }

    // ds = exp(s * scale - lse) * (dp - D) into s; element e of column
    // tile j: row r0 (e < 2) or r1, key k0 + 8j + col + e % 2; masked pairs 0
    const bool full = k0 + kT <= kv_len && (!causal || k0 + kT - 1 <= q0) &&
                      (!window || q_last - k0 < window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? r0 : r1, qp = e < 2 ? qp0 : qp1;
        bool ok = true;
        if (!full) {
          const int kpos = k0 + 8 * j + col + (e & 1);
          ok = r < rows && kpos < kv_len && (!causal || kpos <= qp) &&
               (!window || qp - kpos < window);
        }
        const float p = ok ? exp2f(__fmaf_rn(s[j][e], scale_log2, -(e < 2 ? l0 : l1))) : 0.f;
        s[j][e] = ok ? __fmul_rn(p, __fsub_rn(dp[j][e], e < 2 ? D0 : D1)) : 0.f;
      }
    }

    // dQ += dS.K over the tile's keys, 16 at a time; A from the
    // accumulators (one bf16 rounding), B by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int br = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dpair = 0; dpair < ND / 2; ++dpair) {
        uint32_t bk[4];
        ldsm_x4_trans(bk, kt + at(br, 2 * dpair + (lane >> 4)));
        mma_bf16(acc[2 * dpair], a, bk[0], bk[1]);
        mma_bf16(acc[2 * dpair + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this buffer is consumed before the next load refills it
  }

  // dq = scale * acc, rounded once to bf16 and written once
  __nv_bfloat16* ob = dq + ((size_t)b * Sq + q0) * qrow + (size_t)kh * G * HD + col;
  if (r0 < rows) {
    __nv_bfloat16* orow = ob + (size_t)(r0 / G) * qrow + (r0 % G) * HD;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(__fmul_rn(acc[d][0], scale), __fmul_rn(acc[d][1], scale));
  }
  if (r1 < rows) {
    __nv_bfloat16* orow = ob + (size_t)(r1 / G) * qrow + (r1 % G) * HD;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * d) =
          __floats2bfloat162_rn(__fmul_rn(acc[d][2], scale), __fmul_rn(acc[d][3], scale));
  }
}

// launch a kernel with ``bytes`` of dynamic shared memory
template <typename K, typename... Args>
cudaError_t launch_with_smem(K kern, dim3 grid, int threads, size_t bytes, cudaStream_t stream,
                             Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* lse, const void* dout, void* dq, void* dk, void* dv,
                       float* D, int B, int Sq, int Skv, int KVH, int G, int causal,
                       int window, int kv_len, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);

  const long long rows = (long long)B * Sq * KVH * G;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_preprocess_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(out), gt, D, rows, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 key_grid((Skv + kT - 1) / kT, KVH, B);
  const dim3 query_grid((Sq + kT / G - 1) / (kT / G), KVH, B);
  if constexpr (std::is_same<T, float>::value) {
    using Tile = BwdTile<HD>;
    static_assert(Tile::kDkdvBytes <= kMaxSmem && Tile::kDqBytes <= kMaxSmem,
                  "tiles must fit a block");
    err = launch_with_smem(flash_bwd_dkdv_kernel<T, HD>, key_grid, kThreads,
                           Tile::kDkdvBytes, stream, qt, kt, vt, gt, lf, (const float*)D,
                           static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, kv_len, KVH,
                           G, causal, window, scale);
    if (err != cudaSuccess) return err;
    return launch_with_smem(flash_bwd_dq_kernel<T, HD>, query_grid, kThreads,
                            Tile::kDqBytes, stream, qt, kt, vt, gt, lf, (const float*)D,
                            static_cast<T*>(dq), Sq, Skv, kv_len, KVH, G, causal, window,
                            scale);
  } else {
    using Tile = MmaBwdTile<HD>;
    static_assert(Tile::kDkdvBytes <= kMaxSmem && Tile::kDqBytes <= kMaxSmem,
                  "tiles must fit a block");
    err = launch_with_smem(flash_bwd_dkdv_bf16_kernel<HD>, key_grid, kMmaThreads,
                           Tile::kDkdvBytes, stream, qt, kt, vt, gt, lf, (const float*)D,
                           static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, kv_len, KVH,
                           G, causal, window, scale, scale * kLog2e);
    if (err != cudaSuccess) return err;
    return launch_with_smem(flash_bwd_dq_bf16_kernel<HD>, query_grid, kMmaThreads,
                            Tile::kDqBytes, stream, qt, kt, vt, gt, lf, (const float*)D,
                            static_cast<T*>(dq), Sq, Skv, kv_len, KVH, G, causal, window,
                            scale, scale * kLog2e);
  }
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
                                         void* D, int B, int Sq, int Skv, int KVH, int G,
                                         int hd, int causal, int window, int kv_len,
                                         float scale, void* stream) {
  using namespace repro;
  // a query tile's row offsets (64 positions x KVH * G * hd) must fit an int
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || KVH > 65535 || B > 65535 || G < 1 ||
      G > kT || window < 0 || kv_len < 0 || kv_len > Skv ||
      (long long)kT * KVH * G * hd > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* Df = static_cast<float*>(D);
  return (int)with_head_dim(hd, [&](auto h) {
    constexpr int HD = decltype(h)::value;
    if (dtype == 0)
      return launch_bwd<float, HD>(q, k, v, out, lse, dout, dq, dk, dv, Df, B, Sq, Skv, KVH,
                                   G, causal, window, kv_len, scale, st);
    if (dtype == 1)
      return launch_bwd<__nv_bfloat16, HD>(q, k, v, out, lse, dout, dq, dk, dv, Df, B, Sq,
                                           Skv, KVH, G, causal, window, kv_len, scale, st);
    return cudaErrorInvalidValue;
  });
}
