// Decode attention over a paged KV pool, with the per-page attention mass.
//
// Replaces repro/kernels/paged_attn.py paged_attention_kernel (Pallas, TPU).
// One new query token per sequence (grouped as (KVH, G, hd)) attends to the
// P pages of its pool (page tokens each, (page, KVH, hd) per page); rows
// are valid where page_start >= 0 and page_start + row <= cur_pos.  The
// flash recurrence keeps each page's local sum and max, so the normalized
// per-page mass the AWRP scorer reads costs no second pass over the pool.
//
// Bound: bytes (each valid K/V row read once).  Two launches on the stream:
//   1. paged_partials_kernel, grid (P, KVH, B), one CTA of kSplitThreads per
//      (page, kv head, sequence): the page's partials into the scratch
//      buffer;
//   2. paged_fold_kernel, grid (G * ceil(hd / 64), KVH, B), one CTA of
//      kFoldThreads per (query, 64-dim slice, kv head, sequence): the fold
//      of the pages in page order and that slice of the output; the last CTA
//      of a sequence (an atomic counter) writes the mass.
// The fold is in page order so that the result does not depend on which
// CTA folds, and the fused kernels 4 and 5, whose fused == unfused gates run
// through this kernel, fold with the same code.
// Shared code and design: paged_attn_common.cuh.
//
// C entry point (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_paged_attention(dtype, q, k, v, page_start, cur_pos, out, mass,
//                         scratch, counters, B, P, page, KVH, G, hd, scale,
//                         stream) -> cudaError_t
// dtype 0 = float32, 1 = bfloat16 for q / k / v / out; page_start (B, P) and
// cur_pos (B,) are int32, mass (B, P) float32; scratch holds
// split_scratch_floats floats; counters B int32, all 0 (the kernel leaves
// them 0).  All contiguous.
#include "paged_attn_common.cuh"

namespace repro {

template <typename T, int G>
__global__ void __launch_bounds__(kSplitThreads, kSplitBlocks)
paged_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ page_start,
                      const int* __restrict__ cur_pos, float* scratch, Dims d,
                      float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SplitSmem sm = split_carve(smem_raw, d, sizeof(T));
  const int p = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const SplitScratch scr = split_scratch(scratch, gridDim.z, d);
  const size_t off = ((size_t)b * d.P + p) * d.page * d.KVH * d.hd;
  const int nvalid = valid_rows(page_start[(size_t)b * d.P + p], cur_pos[b], d.page);
  split_stage<T>(sm, d, k + off, v + off, nullptr, nullptr, -1, kh, 0, nvalid);
  split_compute<T, G>(sm, d, scr, q + b * (size_t)d.KVH * G * d.hd, b, kh, p, nvalid,
                      scale);
}

template <typename T, int G>
__global__ void __launch_bounds__(kFoldThreads)
paged_fold_kernel(const int* __restrict__ page_start, const int* __restrict__ cur_pos,
                  T* __restrict__ out, float* __restrict__ mass, float* scratch,
                  int* counters, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FoldSmem sm = fold_carve(smem_raw);
  const int ns = fold_slices(d);
  const int g = blockIdx.x / ns, h0 = (blockIdx.x % ns) * kFoldDims;
  const int kh = blockIdx.y, b = blockIdx.z;
  const SplitScratch scr = split_scratch(scratch, gridDim.z, d);
  const int* starts = page_start + (size_t)b * d.P;
  fold_slice<T, G>(sm, d, scr, b, kh, g, h0, cur_pos[b], [&](int pp) { return starts[pp]; },
                   out + b * (size_t)d.KVH * G * d.hd);
  if (!arrive_last(counters + b, gridDim.x * gridDim.y)) return;
  load_ml(sm, d, scr, b);
  for (int pp = threadIdx.x; pp < d.P; pp += blockDim.x)
    mass[(size_t)b * d.P + pp] = split_mass(sm, d, scr, b, pp);
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const void* page_start, const void* cur_pos, void* out,
                          void* mass, void* scratch, void* counters, int B,
                          const Dims& d, float scale, cudaStream_t stream) {
  const size_t bytes = split_launch_bytes(d, sizeof(T));
  if (bytes == 0) return cudaErrorInvalidValue;
  return with_group(d.G, [&](auto group) {
    constexpr int G = decltype(group)::value;
    auto partials = paged_partials_kernel<T, G>;
    auto fold = paged_fold_kernel<T, G>;
    cudaError_t err = allow_smem(partials, bytes);
    if (err == cudaSuccess) err = allow_smem(fold, fold_smem_bytes(d));
    if (err != cudaSuccess) return err;
    partials<<<dim3(d.P, d.KVH, B), kSplitThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int*>(page_start), static_cast<const int*>(cur_pos),
        static_cast<float*>(scratch), d, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fold<<<dim3(G * fold_slices(d), d.KVH, B), kFoldThreads, fold_smem_bytes(d), stream>>>(
        static_cast<const int*>(page_start), static_cast<const int*>(cur_pos),
        static_cast<T*>(out), static_cast<float*>(mass), static_cast<float*>(scratch),
        static_cast<int*>(counters), d);
    return cudaGetLastError();
  });
}

}  // namespace repro

extern "C" int repro_paged_attention(int dtype, const void* q, const void* k,
                                     const void* v, const void* page_start,
                                     const void* cur_pos, void* out, void* mass,
                                     void* scratch, void* counters, int B, int P,
                                     int page, int KVH, int G, int hd, float scale,
                                     void* stream) {
  using namespace repro;
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const Dims d{P, page, KVH, G, hd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, page_start, cur_pos, out, mass, scratch,
                              counters, B, d, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, page_start, cur_pos, out, mass,
                                      scratch, counters, B, d, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Message of a cudaError_t returned by the entry points above.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
