// Fused true-adaptive (ARC / CAR) decode step: the page allocation as one
// ARC/CAR complete-miss access, paged attention with the new token injected
// in-tile, the F/R/clock score update and one ARC/CAR hit access per
// referenced page.
//
// Replaces repro/kernels/policy_attn.py adaptive_policy_paged_attention_kernel
// (_adaptive_kernel; Pallas, TPU).  Two launches, the schedule of kernels 3
// and 4 (paged_attn_common.cuh):
//   1. adaptive_partials_kernel, one CTA of kSplitThreads per (page, kv
//      head, sequence): the CTA issues its page's loads, then, at a page
//      boundary (pos % page == 0), copies its sequence's directory into its
//      own shared memory and runs, on warp 0, the renormalization check and
//      the miss access of page id pos / page; the page the policy moved out
//      of the cache (resident before, not after; the largest id) gives up its
//      pool slot, else the first free slot is taken; the slot gets F = 1,
//      R = N, page_start = pos.  The chain is deterministic, so every CTA
//      reaches the same slot; the CTA of page 0 and kv head 0 writes the slot
//      and the post-miss directory, p and ctr to the output planes.  Then the
//      page's partials (split_compute), the new row read from new_k / new_v
//      at (slot, pos % page).  Between page boundaries no CTA touches the
//      directory; the launch carves its shared memory all the same (5 L
//      ints: 640 B at P = 16, 10 KB at P = 256), since pos is read on the
//      device and one launch configuration serves every position;
//   2. adaptive_fold_kernel, one CTA per (query, 64-dim slice, kv head,
//      sequence): the fold in page order (fold_slice) and that slice of the
//      output; the last CTA of a sequence writes the mass, runs the
//      reference rule (mass >= 1/residents: F += 1, R = N + 1), ticks the
//      clock (score_update_last, as kernel 4), then one warp takes the
//      directory (the post-miss one launch 1 wrote at a page boundary, else
//      the input, whose opening renormalization check it runs first) and
//      runs P masked hit accesses in slot order, each after its own
//      renormalization check (repro_torch/core/policy_core.py on_access runs
//      _renorm_stamps before its active mask), and writes the directory.
// Out and mass come from the same split_compute / fold_slice as kernel 3, so
// kernel 5 equals its unfused chain (adaptive_insert_token + kernel 3 +
// adaptive_score_update) bit for bit on every output and plane.
// The ARC/CAR step is the one-warp directory machine of adaptive_common.cuh
// (repro_torch/core/policy_core.py _arc_step / _car_step at rows = 1); the
// directory (5 x L int32, 10 KB at P = 256) lives in shared memory.
// In the fold's last CTA the directory and the hit flags reuse the P.V
// buffers, free once the fold is done.  What bounds it on an H100: bytes,
// as paged_attn_common.cuh says; the policy part is a serial chain of warp
// reductions (about 20 per access): at a page boundary one miss in every
// partials CTA, after its loads went out, and P masked hit accesses in one
// warp per sequence after the fold.  Build without --use_fast_math.
//
// C entry point (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_adaptive_policy_paged_attention(dtype, q, k, v, new_k, new_v, pos,
//       f, r, page_start, clock, open_slot, blocks, tag, stamp, ref, p, ctr,
//       out, mass, slot, f_out, r_out, ps_out, clock_out, open_out,
//       blocks_out, tag_out, stamp_out, ref_out, p_out, ctr_out, scratch,
//       counters, B, P, page, KVH, G, hd, L, scale, kind, renorm_at, stream)
// dtype 0 = float32, 1 = bfloat16 for q / k / v / new_k / new_v / out; the
// pool planes (B, P) and clock / open_slot (B,) int32; the directory planes
// (B, L) int32 with 2P <= L <= 1024; p (B,) float32, ctr (B,) int32;
// kind 0 = arc, 1 = car; the policy's capacity is P; pos points to the
// token index shared by the batch (one int32 >= 0 in device memory, read
// by both launches, as the Pallas kernel reads pos_ref[0]); scratch and
// counters as in paged_attn.cu.  All contiguous.
#include "adaptive_common.cuh"
#include "paged_attn_common.cuh"
#include "policy_common.cuh"

namespace repro {
namespace {

// The page-boundary allocation on the policy warp: the renormalization
// check, the miss access of page id x, and the page id the policy moved out
// of the cache (resident before, not after; the largest), -1 if none.
__device__ int miss_access(const Dir& dir, int kind, int x, int renorm_at, float& p,
                           int& ctr) {
  renorm_stamps(dir, renorm_at, ctr);
  for (int j = 0; j < dir.nj; ++j) {  // resident page ids before the miss
    const int l = (j << 5) + lane_id();
    if (l < dir.L) {
      const int t = dir.tag[l];
      dir.tmp[l] = (t == kT1 || t == kT2) ? dir.blocks[l] : kIntMin;
    }
  }
  dir_access(dir, kind, x, p, ctr);
  int m = -1;
  for (int j = 0; j < dir.nj; ++j) {
    const int l = (j << 5) + lane_id();
    if (l < dir.L && dir.tmp[l] != kIntMin && dir.tag[l] != kT1 && dir.tag[l] != kT2)
      m = max(m, dir.tmp[l]);
  }
  return __reduce_max_sync(kFull, m);
}

template <typename T, int G>
__global__ void __launch_bounds__(kSplitThreads, kSplitBlocks)
adaptive_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ new_k,
                         const T* __restrict__ new_v, const int* __restrict__ pos_in,
                         const int* __restrict__ page_start,
                         const int* __restrict__ open_slot, const int* __restrict__ blocks,
                         const int* __restrict__ tag, const int* __restrict__ stamp,
                         const int* __restrict__ ref, const float* __restrict__ p_in,
                         const int* __restrict__ ctr_in, int* __restrict__ slot_out,
                         int* __restrict__ blocks_out, int* __restrict__ tag_out,
                         int* __restrict__ stamp_out, int* __restrict__ ref_out,
                         float* __restrict__ p_out, int* __restrict__ ctr_out,
                         float* scratch, Dims d, int L, float scale, int kind,
                         int renorm_at) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int ev_shared;
  const int pos = *pos_in;
  const SplitSmem sm = split_carve(smem_raw, d, sizeof(T));
  const int p = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, P = d.P;
  const SplitScratch scr = split_scratch(scratch, gridDim.z, d);
  const size_t row = (size_t)d.KVH * d.hd;
  const size_t boff = (size_t)b * P, loff = (size_t)b * L;
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
    // the directory sits past the split carve: the launch sized for it
    const Dir dir = dir_at(reinterpret_cast<int*>(smem_raw + split_smem_bytes(d, sizeof(T))),
                           L, P);
    load_dir(dir, blocks + loff, tag + loff, stamp + loff, ref + loff);
    if (threadIdx.x < 32) {
      float p_b = p_in[b];
      int ctr_b = ctr_in[b];
      const int ev = miss_access(dir, kind, pos / d.page, renorm_at, p_b, ctr_b);
      if (threadIdx.x == 0) ev_shared = ev;
      if (p == 0 && kh == 0) {  // the post-miss directory, for the fold's hit pass
        store_dir(dir, blocks_out + loff, tag_out + loff, stamp_out + loff, ref_out + loff);
        if (threadIdx.x == 0) {
          p_out[b] = p_b;
          ctr_out[b] = ctr_b;
        }
      }
    }
    __syncthreads();
    const int ev_id = ev_shared;
    const int first_free = lanes_first_min(P, [&](int pp) { return psb[pp] < 0 ? 0 : 1; });
    const int victim = lanes_first_min(P, [&](int pp) {
      const int ps = psb[pp];
      return (ps >= 0 ? ps / d.page : -2) == ev_id ? 0 : 1;
    });
    slot = ev_id >= 0 ? victim : first_free;
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

// The directory planes are read and written by the same last CTA (at a page
// boundary it reads the outputs launch 1 wrote), so they carry no
// __restrict__.
template <typename T, int G>
__global__ void __launch_bounds__(kFoldThreads)
adaptive_fold_kernel(const int* __restrict__ pos_in, const int* __restrict__ f,
                     const int* __restrict__ r,
                     const int* __restrict__ page_start, const int* __restrict__ clock,
                     const int* __restrict__ open_slot, const int* blocks, const int* tag,
                     const int* stamp, const int* ref, const float* p_in,
                     const int* ctr_in, T* __restrict__ out, float* __restrict__ mass,
                     const int* __restrict__ slot_in, int* __restrict__ f_out,
                     int* __restrict__ r_out, int* __restrict__ ps_out,
                     int* __restrict__ clock_out, int* __restrict__ open_out,
                     int* blocks_out, int* tag_out, int* stamp_out, int* ref_out,
                     float* p_out, int* ctr_out, float* scratch, int* counters, Dims d,
                     int L, int kind, int renorm_at) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FoldSmem sm = fold_carve(smem_raw);
  const int pos = *pos_in;
  const int ns = fold_slices(d), P = d.P;
  const int g = blockIdx.x / ns, h0 = (blockIdx.x % ns) * kFoldDims;
  const int kh = blockIdx.y, b = blockIdx.z;
  const SplitScratch scr = split_scratch(scratch, gridDim.z, d);
  const int* psb = page_start + (size_t)b * P;
  const bool need_alloc = pos % d.page == 0;
  const int slot = slot_in[b];  // launch 1's allocation
  // post-allocation page_start
  auto start_of = [&](int pp) { return need_alloc && pp == slot ? pos : psb[pp]; };
  fold_slice<T, G>(sm, d, scr, b, kh, g, h0, pos, start_of,
                   out + b * (size_t)d.KVH * G * d.hd);
  if (!arrive_last(counters + b, gridDim.x * gridDim.y)) return;

  load_ml(sm, d, scr, b);
  // the fold is done: its P.V buffers hold the hit pages and the directory
  int* hit_page = reinterpret_cast<int*>(sm.pvb);
  score_update_last(sm, d, scr, b, slot, need_alloc, start_of, f, r, clock, open_slot,
                    mass, f_out, r_out, ps_out, clock_out, open_out, hit_page);
  const size_t loff = (size_t)b * L;
  const Dir dir = dir_at(hit_page + P, L, P);
  if (need_alloc)  // launch 1 ran the step's opening check and the miss
    load_dir(dir, blocks_out + loff, tag_out + loff, stamp_out + loff, ref_out + loff);
  else
    load_dir(dir, blocks + loff, tag + loff, stamp + loff, ref + loff);
  if (threadIdx.x >= 32) return;
  float p_b = need_alloc ? p_out[b] : p_in[b];
  int ctr_b = need_alloc ? ctr_out[b] : ctr_in[b];
  if (!need_alloc) renorm_stamps(dir, renorm_at, ctr_b);
  // the hit pass: P masked accesses in slot order
  for (int s = 0; s < P; ++s) {
    renorm_stamps(dir, renorm_at, ctr_b);
    if (hit_page[s] >= 0) dir_access(dir, kind, hit_page[s], p_b, ctr_b);
  }
  store_dir(dir, blocks_out + loff, tag_out + loff, stamp_out + loff, ref_out + loff);
  if (threadIdx.x == 0) {
    p_out[b] = p_b;
    ctr_out[b] = ctr_b;
  }
}

template <typename T>
cudaError_t launch(const void* const* ptrs, const int* pos, int B, const Dims& d, int L,
                   float scale, int kind, int renorm_at, cudaStream_t stream) {
  const size_t split = split_launch_bytes(d, sizeof(T));
  // the fold's last CTA keeps the hit pages and the directory in its P.V
  // buffers (2 * kFoldTile * kFoldDims floats; P + 5L <= 5632 ints at L = 1024)
  if (split == 0 || (size_t)d.P + 5 * (size_t)L > 2 * (size_t)kFoldTile * kFoldDims)
    return cudaErrorInvalidValue;
  // launch 1 carves the directory whatever pos is (only the device knows it)
  const size_t bytes = split + 5 * (size_t)L * sizeof(int);
  if (bytes + kStaticSmem > kMaxSmem) return cudaErrorInvalidValue;
  auto in = [&](int i) { return static_cast<const T*>(ptrs[i]); };
  auto ci = [&](int i) { return static_cast<const int*>(ptrs[i]); };
  auto oi = [&](int i) { return static_cast<int*>(const_cast<void*>(ptrs[i])); };
  auto of = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  const float* p_in = static_cast<const float*>(ptrs[14]);
  return with_group(d.G, [&](auto group) {
    constexpr int G = decltype(group)::value;
    auto partials = adaptive_partials_kernel<T, G>;
    auto fold = adaptive_fold_kernel<T, G>;
    cudaError_t err = allow_smem(partials, bytes);
    if (err == cudaSuccess) err = allow_smem(fold, fold_smem_bytes(d));
    if (err != cudaSuccess) return err;
    partials<<<dim3(d.P, d.KVH, B), kSplitThreads, bytes, stream>>>(
        in(0), in(1), in(2), in(3), in(4), pos, ci(7), ci(9), ci(10), ci(11), ci(12), ci(13),
        p_in, ci(15), oi(18), oi(24), oi(25), oi(26), oi(27), of(28), oi(29), of(30), d, L,
        scale, kind, renorm_at);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    fold<<<dim3(G * fold_slices(d), d.KVH, B), kFoldThreads, fold_smem_bytes(d), stream>>>(
        pos, ci(5), ci(6), ci(7), ci(8), ci(9), ci(10), ci(11), ci(12), ci(13), p_in, ci(15),
        static_cast<T*>(const_cast<void*>(ptrs[16])), of(17), ci(18), oi(19), oi(20), oi(21),
        oi(22), oi(23), oi(24), oi(25), oi(26), oi(27), of(28), oi(29), of(30), oi(31), d, L,
        kind, renorm_at);
    return cudaGetLastError();
  });
}

}  // namespace

// The bfloat16 instantiations are a translation unit of their own: the build
// compiles this file a second time with REPRO_ADAPTIVE_BF16 (_build.py
// UNITS), so the two dtypes' kernels for G = 1..8 compile in parallel.
cudaError_t adaptive_launch_bf16(const void* const* ptrs, const int* pos, int B,
                                 const Dims& d, int L, float scale, int kind,
                                 int renorm_at, cudaStream_t stream);

#ifdef REPRO_ADAPTIVE_BF16
cudaError_t adaptive_launch_bf16(const void* const* ptrs, const int* pos, int B,
                                 const Dims& d, int L, float scale, int kind,
                                 int renorm_at, cudaStream_t stream) {
  return launch<__nv_bfloat16>(ptrs, pos, B, d, L, scale, kind, renorm_at, stream);
}
#endif

}  // namespace repro

#ifndef REPRO_ADAPTIVE_BF16
extern "C" int repro_adaptive_policy_paged_attention(
    int dtype, const void* q, const void* k, const void* v, const void* new_k,
    const void* new_v, const void* pos, const void* f, const void* r,
    const void* page_start, const void* clock, const void* open_slot,
    const void* blocks, const void* tag, const void* stamp, const void* ref,
    const void* p, const void* ctr, void* out, void* mass, void* slot,
    void* f_out, void* r_out, void* ps_out, void* clock_out, void* open_out,
    void* blocks_out, void* tag_out, void* stamp_out, void* ref_out,
    void* p_out, void* ctr_out, void* scratch, void* counters, int B, int P,
    int page, int KVH, int G, int hd, int L, float scale, int kind, int renorm_at,
    void* stream) {
  using namespace repro;
  if (B < 1 || B > 65535 || L < 2 * P || L > kMaxLanes ||
      (kind != kKindArc && kind != kKindCar))
    return (int)cudaErrorInvalidValue;
  const Dims d{P, page, KVH, G, hd};
  const void* ptrs[32] = {q, k, v, new_k, new_v, f, r, page_start, clock,
                          open_slot, blocks, tag, stamp, ref, p, ctr, out, mass,
                          slot, f_out, r_out, ps_out, clock_out, open_out,
                          blocks_out, tag_out, stamp_out, ref_out, p_out, ctr_out,
                          scratch, counters};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pos_in = static_cast<const int*>(pos);
  if (dtype == 0)
    return (int)launch<float>(ptrs, pos_in, B, d, L, scale, kind, renorm_at, st);
  if (dtype == 1)
    return (int)adaptive_launch_bf16(ptrs, pos_in, B, d, L, scale, kind, renorm_at, st);
  return (int)cudaErrorInvalidValue;
}
#endif
