// Block-wide integer reductions of the fused decode kernels (policy_attn.cu,
// adaptive_attn.cu): the first-index minimum of (key, lane) and the sum,
// the block-level counterparts of repro_torch/core/policy_core.py first_min.
// Every thread of the CTA calls them with its own candidate; each ends with a
// barrier.
#pragma once

#include "paged_attn_common.cuh"

namespace repro {

// First index of the block minimum of (key, idx), lexicographic; every
// thread passes its own best candidate and gets the block's idx.
static __device__ int block_first_min(int key, int idx) {
  __shared__ int red_key[kWarps];
  __shared__ int red_idx[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const int k2 = __shfl_xor_sync(0xffffffffu, key, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
    if (k2 < key || (k2 == key && i2 < idx)) { key = k2; idx = i2; }
  }
  if (lane == 0) { red_key[warp] = key; red_idx[warp] = idx; }
  __syncthreads();
  if (warp == 0) {
    key = lane < nwarps ? red_key[lane] : kIntMax;
    idx = lane < nwarps ? red_idx[lane] : kIntMax;
    for (int o = 16; o > 0; o >>= 1) {
      const int k2 = __shfl_xor_sync(0xffffffffu, key, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
      if (k2 < key || (k2 == key && i2 < idx)) { key = k2; idx = i2; }
    }
    if (lane == 0) red_idx[0] = idx;
  }
  __syncthreads();
  const int res = red_idx[0];
  __syncthreads();
  return res;
}

static __device__ int block_sum(int v) {
  __shared__ int red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int tot = 0;
  for (int w = 0; w < nwarps; ++w) tot += red[w];
  __syncthreads();
  return tot;
}

// first_min over the P lanes of a per-lane key function
template <typename KeyFn>
static __device__ int lanes_first_min(int P, KeyFn key_of) {
  int key = kIntMax, idx = kIntMax;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int k = key_of(p);
    // lanes ascend, so strict < keeps the first index; a thread's first
    // lane is always taken (an all-INT_MAX row still yields lane 0)
    if (k < key || idx == kIntMax) { key = k; idx = p; }
  }
  return block_first_min(key, idx);
}

}  // namespace repro
