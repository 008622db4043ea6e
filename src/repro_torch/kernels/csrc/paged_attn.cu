// Decode attention over a paged KV pool, with the per-page attention mass.
//
// Replaces repro/kernels/paged_attn.py paged_attention_kernel (Pallas, TPU).
// One new query token per sequence (grouped as (KVH, G, hd)) attends to the
// P pages of its pool (page tokens each, (page, KVH, hd) per page); rows
// are valid where page_start >= 0 and page_start + row <= cur_pos.  The
// flash recurrence runs page by page in one CTA per sequence and keeps each
// page's local sum and max, so the normalized per-page mass the AWRP scorer
// reads costs no second pass over the pool.  Shared code, design and bound:
// paged_attn_common.cuh.
//
// C entry point (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_paged_attention(dtype, q, k, v, page_start, cur_pos, out, mass,
//                         B, P, page, KVH, G, hd, scale, stream) -> cudaError_t
// dtype 0 = float32, 1 = bfloat16 for q / k / v / out; page_start (B, P) and
// cur_pos (B,) are int32, mass (B, P) float32.  All contiguous.
#include "paged_attn_common.cuh"

namespace repro {

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ page_start,
                       const int* __restrict__ cur_pos, T* __restrict__ out,
                       float* __restrict__ mass, Dims d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, d, false, sizeof(T));
  const int b = blockIdx.x;
  const size_t qsize = (size_t)d.KVH * d.G * d.hd;
  const size_t page_elems = (size_t)d.page * d.KVH * d.hd;
  init_state<T>(sm, q + b * qsize, d);
  const int cur = cur_pos[b];
  for (int p = 0; p < d.P; ++p) {
    const size_t off = ((size_t)b * d.P + p) * page_elems;
    attend_page<T>(sm, k + off, v + off, nullptr, nullptr, -1,
                   page_start[(size_t)b * d.P + p], cur, p, scale, d);
  }
  finalize<T>(sm, out + b * qsize, mass + (size_t)b * d.P, d);
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* page_start, const void* cur_pos, void* out,
                          void* mass, int B, const Dims& d, float scale,
                          cudaStream_t stream) {
  const size_t bytes = smem_bytes(d, false, sizeof(T));
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = paged_attention_kernel<T>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kern<<<B, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(page_start), static_cast<const int*>(cur_pos),
      static_cast<T*>(out), static_cast<float*>(mass), d, scale);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_paged_attention(int dtype, const void* q, const void* k,
                                     const void* v, const void* page_start,
                                     const void* cur_pos, void* out, void* mass,
                                     int B, int P, int page, int KVH, int G,
                                     int hd, float scale, void* stream) {
  using namespace repro;
  if (G < 1 || G > kMaxG || B < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  if (KVH * hd * esize % 16) return (int)cudaErrorInvalidValue;  // 16 B row chunks
  Dims d{P, page, KVH, G, hd, 0};
  d.chunk = chunk_rows(d, esize);
  if (d.chunk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, page_start, cur_pos, out, mass, B, d, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, page_start, cur_pos, out, mass, B, d,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}

// Message of a cudaError_t returned by the entry points above.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
