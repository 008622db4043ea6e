// Fused flat-policy decode step: page allocation and victim selection, paged
// attention with the new token injected in-tile, and the AWRP score update.
//
// Replaces repro/kernels/policy_attn.py policy_paged_attention_kernel
// (Pallas, TPU).  Bound: bytes (each valid K/V row read once).  The token
// index pos is read from device memory (one int32), as the Pallas kernel
// reads pos_ref[0]: no launch argument depends on its value, so a captured
// CUDA graph replays the step at every position.  The two launches of
// paged_attn.cu:
//   1. policy_partials_kernel, one CTA per (page, kv head, sequence): the
//      CTA issues its page's loads, then, at a page boundary (pos % page ==
//      0), runs the allocation over the read-only input planes: the first
//      free slot, else the policy's victim among resident pages with the
//      open slot pinned (paper eq. (1) W = F / max(N - R, 1) for awrp); the
//      chosen slot gets F = 1, R = N, page_start = pos.  Every CTA runs the
//      same deterministic chain, so every CTA reaches the same slot and knows
//      the post-allocation start of its page; the CTA of page 0 and kv head 0
//      writes the slot.  Then the page's partials (split_compute), with the
//      new K/V row read from new_k / new_v at (slot, pos % page): the pool
//      K/V stay read-only and the caller scatters the row afterwards;
//   2. policy_fold_kernel, one CTA per (query, 64-dim slice, kv head,
//      sequence): the fold in page order and that slice of the output; the
//      last CTA of a sequence writes the mass and runs the reference rule (a
//      resident page with mass >= 1/residents is referenced: F += 1, R = N +
//      1), ticks the clock and writes F, R, page_start, clock and open_slot.
// Victim selection is a chain of block-wide first-index min reductions over
// (key, lane), the same chain as repro_torch/core/kv_policy.py page_victim,
// so decisions are bit-identical to the unfused path.  AWRP keys are the
// int32 bit patterns of IEEE-divided float weights (W >= 0, so bit order is
// float order), INT_MAX on invalid or pinned lanes.  Shared code and design:
// paged_attn_common.cuh.
//
// C entry point (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_policy_paged_attention(dtype, q, k, v, new_k, new_v, pos, f, r,
//       page_start, clock, open_slot, out, mass, slot, f_out, r_out, ps_out,
//       clock_out, open_out, scratch, counters, B, P, page, KVH, G, hd, scale,
//       policy, stream)
// dtype 0 = float32, 1 = bfloat16 for q / k / v / new_k / new_v / out; every
// plane int32, mass float32; pos points to the token index shared by the
// batch (one int32 >= 0 in device memory);
// policy: 0 awrp, 1 lru, 2 fifo, 3 lfu, 4 arc, 5 car; scratch and counters
// as in paged_attn.cu.  All contiguous.
#include "paged_attn_common.cuh"
#include "policy_common.cuh"

namespace repro {

enum Policy { kAwrp = 0, kLru = 1, kFifo = 2, kLfu = 3, kArc = 4, kCar = 5 };

// repro_torch/core/kv_policy.py page_victim at rows=1 over one sequence's
// input planes
__device__ int page_victim(int policy, const int* __restrict__ f,
                           const int* __restrict__ r, const int* __restrict__ ps,
                           int clock, int open_slot, int P) {
  auto valid = [&](int p) { return ps[p] >= 0 && p != open_slot; };
  if (policy == kAwrp) {
    return lanes_first_min(P, [&](int p) {
      if (!valid(p)) return kIntMax;
      const float dt = (float)max(clock - r[p], 1);
      return __float_as_int(__fdiv_rn((float)f[p], dt));
    });
  }
  if (policy == kLru)
    return lanes_first_min(P, [&](int p) { return valid(p) ? r[p] : kIntMax; });
  if (policy == kFifo)
    return lanes_first_min(P, [&](int p) { return valid(p) ? ps[p] : kIntMax; });
  // lfu / arc / car: masked tiebreak on (primary, secondary)
  auto primary = [&](int p) {
    if (!valid(p)) return kIntMax;
    return policy == kLfu ? f[p] : (f[p] > 1 ? 1 : 0);
  };
  const int m = primary(lanes_first_min(P, primary));
  return lanes_first_min(P, [&](int p) {
    if (primary(p) != m) return kIntMax;
    return policy == kCar ? ps[p] : r[p];
  });
}

template <typename T, int G>
__global__ void __launch_bounds__(kSplitThreads, kSplitBlocks)
policy_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ new_k,
                       const T* __restrict__ new_v, const int* __restrict__ pos_in,
                       const int* __restrict__ f, const int* __restrict__ r,
                       const int* __restrict__ page_start, const int* __restrict__ clock,
                       const int* __restrict__ open_slot, int* __restrict__ slot_out,
                       float* scratch, Dims d, float scale, int policy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pos = *pos_in;
  const SplitSmem sm = split_carve(smem_raw, d, sizeof(T));
  const int p = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, P = d.P;
  const SplitScratch scr = split_scratch(scratch, gridDim.z, d);
  const size_t row = (size_t)d.KVH * d.hd;
  const size_t boff = (size_t)b * P;
  const int* psb = page_start + boff;
  const int open_b = open_slot[b];
  const int within = pos % d.page;
  const bool need_alloc = within == 0;

  // the page's loads go out before the allocation: they need only the
  // input planes, except on the page the allocation takes
  const size_t off = (boff + p) * d.page * row;
  const T* nk = new_k + b * row;
  const T* nv = new_v + b * row;
  split_stage<T>(sm, d, k + off, v + off, nk, nv, !need_alloc && p == open_b ? within : -1,
                 kh, 0, valid_rows(psb[p], pos, d.page));
  int slot = open_b;
  if (need_alloc) {
    const int first_free = lanes_first_min(P, [&](int pp) { return psb[pp] < 0 ? 0 : 1; });
    const bool has_free = psb[first_free] < 0;
    const int victim = page_victim(policy, f + boff, r + boff, psb, clock[b], open_b, P);
    slot = has_free ? first_free : victim;
  }
  if (p == 0 && kh == 0 && threadIdx.x == 0) slot_out[b] = slot;
  int start = psb[p];
  if (need_alloc && p == slot) {  // a new page: its one valid row is the new token
    cp_async_wait_all();
    __syncthreads();
    split_stage<T>(sm, d, k + off, v + off, nk, nv, 0, kh, 0, 1);
    start = pos;
  }
  split_compute<T, G>(sm, d, scr, q + b * row * G, b, kh, p, valid_rows(start, pos, d.page),
                      scale);
}

template <typename T, int G>
__global__ void __launch_bounds__(kFoldThreads)
policy_fold_kernel(const int* __restrict__ pos_in, const int* __restrict__ f,
                   const int* __restrict__ r,
                   const int* __restrict__ page_start, const int* __restrict__ clock,
                   const int* __restrict__ open_slot, T* __restrict__ out,
                   float* __restrict__ mass, const int* __restrict__ slot_in,
                   int* __restrict__ f_out, int* __restrict__ r_out,
                   int* __restrict__ ps_out, int* __restrict__ clock_out,
                   int* __restrict__ open_out, float* scratch, int* counters, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FoldSmem sm = fold_carve(smem_raw);
  const int pos = *pos_in;
  const int ns = fold_slices(d), P = d.P;
  const int g = blockIdx.x / ns, h0 = (blockIdx.x % ns) * kFoldDims;
  const int kh = blockIdx.y, b = blockIdx.z;
  const SplitScratch scr = split_scratch(scratch, gridDim.z, d);
  const size_t boff = (size_t)b * P;
  const int* psb = page_start + boff;
  const bool need_alloc = pos % d.page == 0;
  const int slot = slot_in[b];  // launch 1's allocation
  // post-allocation page_start
  auto start_of = [&](int pp) { return need_alloc && pp == slot ? pos : psb[pp]; };
  fold_slice<T, G>(sm, d, scr, b, kh, g, h0, pos, start_of,
                   out + b * (size_t)d.KVH * G * d.hd);
  if (!arrive_last(counters + b, gridDim.x * gridDim.y)) return;

  load_ml(sm, d, scr, b);
  score_update_last(sm, d, scr, b, slot, need_alloc, start_of, f, r, clock, open_slot,
                    mass, f_out, r_out, ps_out, clock_out, open_out, nullptr);
}

template <typename T>
static cudaError_t launch_policy(const void* const* ptrs, const int* pos, int B,
                                 const Dims& d, float scale, int policy,
                                 cudaStream_t stream) {
  const size_t bytes = split_launch_bytes(d, sizeof(T));
  if (bytes == 0) return cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const T*>(ptrs[i]); };
  auto ci = [&](int i) { return static_cast<const int*>(ptrs[i]); };
  auto oi = [&](int i) { return static_cast<int*>(const_cast<void*>(ptrs[i])); };
  float* scratch = static_cast<float*>(const_cast<void*>(ptrs[18]));
  return with_group(d.G, [&](auto group) {
    constexpr int G = decltype(group)::value;
    auto partials = policy_partials_kernel<T, G>;
    auto fold = policy_fold_kernel<T, G>;
    cudaError_t err = allow_smem(partials, bytes);
    if (err == cudaSuccess) err = allow_smem(fold, fold_smem_bytes(d));
    if (err != cudaSuccess) return err;
    partials<<<dim3(d.P, d.KVH, B), kSplitThreads, bytes, stream>>>(
        in(0), in(1), in(2), in(3), in(4), pos, ci(5), ci(6), ci(7), ci(8), ci(9), oi(12),
        scratch, d, scale, policy);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fold<<<dim3(G * fold_slices(d), d.KVH, B), kFoldThreads, fold_smem_bytes(d), stream>>>(
        pos, ci(5), ci(6), ci(7), ci(8), ci(9), static_cast<T*>(const_cast<void*>(ptrs[10])),
        static_cast<float*>(const_cast<void*>(ptrs[11])), ci(12), oi(13), oi(14), oi(15),
        oi(16), oi(17), scratch, oi(19), d);
    return cudaGetLastError();
  });
}

}  // namespace repro

extern "C" int repro_policy_paged_attention(
    int dtype, const void* q, const void* k, const void* v, const void* new_k,
    const void* new_v, const void* pos, const void* f, const void* r,
    const void* page_start, const void* clock, const void* open_slot, void* out,
    void* mass, void* slot, void* f_out, void* r_out, void* ps_out,
    void* clock_out, void* open_out, void* scratch, void* counters, int B, int P,
    int page, int KVH, int G, int hd, float scale, int policy, void* stream) {
  using namespace repro;
  if (B < 1 || B > 65535 || policy < kAwrp || policy > kCar)
    return (int)cudaErrorInvalidValue;
  const Dims d{P, page, KVH, G, hd};
  const void* ptrs[20] = {q, k, v, new_k, new_v, f, r, page_start, clock,
                          open_slot, out, mass, slot, f_out, r_out, ps_out,
                          clock_out, open_out, scratch, counters};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos_in = static_cast<const int*>(pos);
  if (dtype == 0) return (int)launch_policy<float>(ptrs, pos_in, B, d, scale, policy, st);
  if (dtype == 1)
    return (int)launch_policy<__nv_bfloat16>(ptrs, pos_in, B, d, scale, policy, st);
  return (int)cudaErrorInvalidValue;
}
