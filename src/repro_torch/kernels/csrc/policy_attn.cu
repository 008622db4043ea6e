// Fused flat-policy decode step: page allocation and victim selection, paged
// attention with the new token injected in-tile, and the AWRP score update,
// in one launch.
//
// Replaces repro/kernels/policy_attn.py policy_paged_attention_kernel
// (Pallas, TPU).  One CTA per sequence:
//   1. at a page boundary (pos % page == 0) the CTA allocates: the first
//      free slot, else the policy's victim among resident pages with the
//      open slot pinned (paper eq. (1) W = F / max(N - R, 1) for awrp); the
//      chosen slot gets F = 1, R = N, page_start = pos;
//   2. the page loop of paged_attn.cu (the same attend_page), with the new
//      K/V row read from new_k / new_v at (slot, pos % page): the pool K/V
//      stay read-only and the caller scatters the row afterwards;
//   3. finalize (the same epilogue), then the reference rule: a resident
//      page with mass >= 1/residents is referenced (F += 1, R = N + 1), and
//      the clock N ticks once.
// Victim selection is a chain of block-wide first-index min reductions over
// (key, lane), the same chain as repro_torch/core/kv_policy.py page_victim,
// so decisions are bit-identical to the unfused path.  AWRP keys are the
// int32 bit patterns of IEEE-divided float weights (W >= 0, so bit order is
// float order), INT_MAX on invalid or pinned lanes.  Shared code, design and
// bound: paged_attn_common.cuh.
//
// C entry point (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_policy_paged_attention(dtype, q, k, v, new_k, new_v, pos, f, r,
//       page_start, clock, open_slot, out, mass, slot, f_out, r_out, ps_out,
//       clock_out, open_out, B, P, page, KVH, G, hd, scale, policy, stream)
// dtype 0 = float32, 1 = bfloat16 for q / k / v / new_k / new_v / out; every
// plane int32, mass float32; pos is the token index shared by the batch;
// policy: 0 awrp, 1 lru, 2 fifo, 3 lfu, 4 arc, 5 car.  All contiguous.
#include "paged_attn_common.cuh"
#include "policy_common.cuh"

namespace repro {

enum Policy { kAwrp = 0, kLru = 1, kFifo = 2, kLfu = 3, kArc = 4, kCar = 5 };

// repro_torch/core/kv_policy.py page_victim at rows=1 over the smem planes
__device__ int page_victim(int policy, const Smem& sm, int clock, int open_slot,
                           int P) {
  const int* f = sm.fa;
  const int* r = sm.ra;
  const int* ps = sm.psa;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
policy_paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ new_k, const T* __restrict__ new_v, int pos,
    const int* __restrict__ f, const int* __restrict__ r,
    const int* __restrict__ page_start, const int* __restrict__ clock,
    const int* __restrict__ open_slot, T* __restrict__ out,
    float* __restrict__ mass, int* __restrict__ slot_out,
    int* __restrict__ f_out, int* __restrict__ r_out, int* __restrict__ ps_out,
    int* __restrict__ clock_out, int* __restrict__ open_out, Dims d, float scale,
    int policy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, d, true, sizeof(T));
  const int b = blockIdx.x, P = d.P;
  const size_t qsize = (size_t)d.KVH * d.G * d.hd;
  const size_t row = (size_t)d.KVH * d.hd;
  const size_t page_elems = (size_t)d.page * row;
  const size_t boff = (size_t)b * P;
  const int clock_b = clock[b], open_b = open_slot[b];
  const int within = pos % d.page;
  const bool need_alloc = within == 0;

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    sm.fa[p] = f[boff + p];
    sm.ra[p] = r[boff + p];
    sm.psa[p] = page_start[boff + p];
  }
  init_state<T>(sm, q + b * qsize, d);  // ends with a barrier

  int slot = open_b;
  if (need_alloc) {
    const int first_free =
        lanes_first_min(P, [&](int p) { return sm.psa[p] < 0 ? 0 : 1; });
    const bool has_free = sm.psa[first_free] < 0;
    const int victim = page_victim(policy, sm, clock_b, open_b, P);
    slot = has_free ? first_free : victim;
    if (threadIdx.x == 0) {
      sm.fa[slot] = 1;
      sm.ra[slot] = clock_b;
      sm.psa[slot] = pos;
    }
    __syncthreads();
  }

  const T* nk = new_k + b * row;
  const T* nv = new_v + b * row;
  for (int p = 0; p < P; ++p) {
    const size_t off = (boff + p) * page_elems;
    attend_page<T>(sm, k + off, v + off, nk, nv, p == slot ? within : -1,
                   sm.psa[p], pos, p, scale, d);
  }
  finalize<T>(sm, out + b * qsize, mass + boff, d);  // ends with a barrier

  int res = 0;
  for (int p = threadIdx.x; p < P; p += blockDim.x) res += sm.psa[p] >= 0;
  const int resident = block_sum(res);
  const float tau = __fdiv_rn(1.0f, fmaxf((float)resident, 1.0f));
  const int clock_new = clock_b + 1;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const bool referenced = sm.mass[p] >= tau && sm.psa[p] >= 0;
    f_out[boff + p] = referenced ? sm.fa[p] + 1 : sm.fa[p];
    r_out[boff + p] = referenced ? clock_new : sm.ra[p];
    ps_out[boff + p] = sm.psa[p];
  }
  if (threadIdx.x == 0) {
    slot_out[b] = slot;
    clock_out[b] = clock_new;
    open_out[b] = need_alloc ? slot : open_b;
  }
}

template <typename T>
static cudaError_t launch_policy(const void* const* ptrs, int pos, int B,
                                 const Dims& d, float scale, int policy,
                                 cudaStream_t stream) {
  const size_t bytes = smem_bytes(d, true, sizeof(T));
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = policy_paged_attention_kernel<T>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kern<<<B, kThreads, bytes, stream>>>(
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<const T*>(ptrs[3]),
      static_cast<const T*>(ptrs[4]), pos, static_cast<const int*>(ptrs[5]),
      static_cast<const int*>(ptrs[6]), static_cast<const int*>(ptrs[7]),
      static_cast<const int*>(ptrs[8]), static_cast<const int*>(ptrs[9]),
      static_cast<T*>(const_cast<void*>(ptrs[10])),
      static_cast<float*>(const_cast<void*>(ptrs[11])),
      static_cast<int*>(const_cast<void*>(ptrs[12])),
      static_cast<int*>(const_cast<void*>(ptrs[13])),
      static_cast<int*>(const_cast<void*>(ptrs[14])),
      static_cast<int*>(const_cast<void*>(ptrs[15])),
      static_cast<int*>(const_cast<void*>(ptrs[16])),
      static_cast<int*>(const_cast<void*>(ptrs[17])), d, scale, policy);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_policy_paged_attention(
    int dtype, const void* q, const void* k, const void* v, const void* new_k,
    const void* new_v, int pos, const void* f, const void* r,
    const void* page_start, const void* clock, const void* open_slot, void* out,
    void* mass, void* slot, void* f_out, void* r_out, void* ps_out,
    void* clock_out, void* open_out, int B, int P, int page, int KVH, int G,
    int hd, float scale, int policy, void* stream) {
  using namespace repro;
  if (G < 1 || G > kMaxG || B < 1 || P < 1 || page < 1 || pos < 0 ||
      policy < kAwrp || policy > kCar)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  if (KVH * hd * esize % 16) return (int)cudaErrorInvalidValue;  // 16 B row chunks
  Dims d{P, page, KVH, G, hd, 0};
  d.chunk = chunk_rows(d, esize);
  if (d.chunk < 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[18] = {q, k, v, new_k, new_v, f, r, page_start, clock,
                          open_slot, out, mass, slot, f_out, r_out, ps_out,
                          clock_out, open_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_policy<float>(ptrs, pos, B, d, scale, policy, st);
  if (dtype == 1)
    return (int)launch_policy<__nv_bfloat16>(ptrs, pos, B, d, scale, policy, st);
  return (int)cudaErrorInvalidValue;
}
