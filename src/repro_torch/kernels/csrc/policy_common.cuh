// Shared code of the fused decode kernels (policy_attn.cu, adaptive_attn.cu):
// block-wide integer reductions, the first-index minimum of (key, lane) and
// the sum, the block-level counterparts of repro_torch/core/policy_core.py
// first_min (every thread of the CTA calls them with its own candidate; each
// ends with a barrier), and the score update of the fold's last CTA.
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

// The last fold CTA of sequence b (kernels 4 and 5, after arrive_last and
// load_ml): the per-page mass, the reference rule (a resident page with mass
// >= 1/residents is referenced: F += 1, R = N + 1) over the post-allocation
// planes (the slot allocated at a page boundary has F = 1, R = N and start
// pos: start_of), the clock tick, and F, R, page_start, clock and open_slot
// written out.  With ``hit_page`` (shared memory, P ints) not null,
// hit_page[p] is referenced page p's page id (start / page), else -1.  Every
// thread of the CTA calls it; ends with a barrier.
template <typename StartOf>
__device__ void score_update_last(const FoldSmem& sm, const Dims& d,
                                  const SplitScratch& scr, int b, int slot,
                                  bool need_alloc, StartOf start_of,
                                  const int* __restrict__ f, const int* __restrict__ r,
                                  const int* __restrict__ clock,
                                  const int* __restrict__ open_slot,
                                  float* __restrict__ mass, int* __restrict__ f_out,
                                  int* __restrict__ r_out, int* __restrict__ ps_out,
                                  int* __restrict__ clock_out, int* __restrict__ open_out,
                                  int* hit_page) {
  const int P = d.P;
  const size_t boff = (size_t)b * P;
  int res = 0;
  for (int pp = threadIdx.x; pp < P; pp += blockDim.x) res += start_of(pp) >= 0;
  const int resident = block_sum(res);
  const float tau = __fdiv_rn(1.0f, fmaxf((float)resident, 1.0f));
  const int clock_b = clock[b], clock_new = clock_b + 1;
  for (int pp = threadIdx.x; pp < P; pp += blockDim.x) {
    const float m = split_mass(sm, d, scr, b, pp);
    const bool alloc = need_alloc && pp == slot;
    const int fa = alloc ? 1 : f[boff + pp], ra = alloc ? clock_b : r[boff + pp];
    const int psa = start_of(pp);
    const bool referenced = m >= tau && psa >= 0;
    mass[boff + pp] = m;
    f_out[boff + pp] = referenced ? fa + 1 : fa;
    r_out[boff + pp] = referenced ? clock_new : ra;
    ps_out[boff + pp] = psa;
    if (hit_page != nullptr) hit_page[pp] = referenced ? psa / d.page : -1;
  }
  if (threadIdx.x == 0) {
    clock_out[b] = clock_new;
    open_out[b] = need_alloc ? slot : open_slot[b];
  }
  __syncthreads();
}

}  // namespace repro
