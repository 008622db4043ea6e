// Fused true-adaptive (ARC / CAR) decode step: the page allocation as one
// ARC/CAR complete-miss access, paged attention with the new token injected
// in-tile, the F/R/clock score update and one ARC/CAR hit access per
// referenced page, in one launch.
//
// Replaces repro/kernels/policy_attn.py adaptive_policy_paged_attention_kernel
// (_adaptive_kernel; Pallas, TPU).  One CTA per sequence of kThreads threads:
//   1. the renormalization check, then (at a page boundary, pos % page == 0)
//      the miss access of page id pos / page; the page the policy moved out
//      of the cache (resident before, not after; the largest id) gives up
//      its pool slot, else the first free slot is taken; the slot gets F = 1,
//      R = N, page_start = pos;
//   2. the page loop of paged_attn_common.cuh (page_partials, then
//      page_fold, page by page) and its epilogue, so out and mass are
//      bitwise those of the unfused kernel 3 (paged_attn.cu, which computes
//      the same partials in parallel and folds them in page order) on the
//      same pool;
//   3. the reference rule (mass >= 1/residents: F += 1, R = N + 1, N ticks);
//   4. P masked hit accesses in slot order, each after its own
//      renormalization check (repro_torch/core/policy_core.py on_access runs
//      _renorm_stamps before its active mask).
// The ARC/CAR step is repro_torch/core/policy_core.py _arc_step / _car_step
// at rows = 1, operation for operation: list sizes, list heads as the lanes
// holding the smallest stamp of a list, the first free lane for an insert,
// float32 p arithmetic with IEEE division (__fdiv_rn; no products, so
// nothing contracts into an FMA), int(p) truncating (__float2int_rz), ARC's
// p update before REPLACE, CAR's after its clock-hand sweep (at most c + 1
// trips, a warp-uniform loop), ARC granting ctr 2 per access, CAR 1 per
// trip and 1 per miss or ghost hit.  The rank of a renormalization runs over
// all L lanes, free lanes' stale stamps included.
//
// Design.  The directory (blocks, tag, stamp, ref: 4 x L int32, plus one L
// scratch plane; 10 KB at P = 256) lives in shared memory and ONE warp runs
// the policy: thread t owns lanes t, t + 32, ...; a list size is a
// __ballot_sync / __popc sum, a head a __reduce_min_sync of the stamp, and
// each thread reads and writes only its own lanes, so the warp needs no
// barrier except around a renormalization (every lane reads every stamp).
// The other warps wait at one barrier after the miss and skip the hit pass.
// What bounds it on an H100: bytes, as paged_attn_common.cuh says; the
// policy part is a serial chain of warp reductions (about 20 per access),
// small next to the page loop, which still runs in one CTA per sequence.
// Build without --use_fast_math.
//
// C entry point (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_adaptive_policy_paged_attention(dtype, q, k, v, new_k, new_v, pos,
//       f, r, page_start, clock, open_slot, blocks, tag, stamp, ref, p, ctr,
//       out, mass, slot, f_out, r_out, ps_out, clock_out, open_out,
//       blocks_out, tag_out, stamp_out, ref_out, p_out, ctr_out,
//       B, P, page, KVH, G, hd, L, scale, kind, renorm_at, stream)
// dtype 0 = float32, 1 = bfloat16 for q / k / v / new_k / new_v / out; the
// pool planes (B, P) and clock / open_slot (B,) int32; the directory planes
// (B, L) int32 with 2P <= L <= 1024; p (B,) float32, ctr (B,) int32;
// kind 0 = arc, 1 = car; the policy's capacity is P.  All contiguous.
#include "paged_attn_common.cuh"
#include "policy_common.cuh"

namespace repro {
namespace {

constexpr int kFree = 0, kT1 = 1, kT2 = 2, kB1 = 3, kB2 = 4;  // list tags
constexpr int kKindArc = 0, kKindCar = 1;
constexpr int kMaxLanes = 1024;  // lane groups of one thread fit a 32-bit mask
constexpr int kIntMin = -2147483647 - 1;
constexpr unsigned kFull = 0xffffffffu;

// One sequence's ARC/CAR directory in shared memory, worked on by one warp.
struct Dir {
  int* blocks;  // (L) page id, -1 on a free lane
  int* tag;     // (L) kFree / kT1 / kT2 / kB1 / kB2
  int* stamp;   // (L) order within a list
  int* ref;     // (L) CAR reference bits
  int* tmp;     // (L) scratch
  int L;        // lanes
  int nj;       // lane groups of 32
  int cap;      // capacity c
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Sizes of T1, T2, B1, B2.
__device__ void list_sizes(const Dir& d, int n[4]) {
  n[0] = n[1] = n[2] = n[3] = 0;
  for (int j = 0; j < d.nj; ++j) {
    const int l = (j << 5) + lane_id();
    const int t = l < d.L ? d.tag[l] : kFree;
    for (int c = 0; c < 4; ++c) n[c] += __popc(__ballot_sync(kFull, t == kT1 + c));
  }
}

// Warp minimum of key(l) over the lanes (INT_MAX with none).
template <typename Key>
__device__ int dir_min(const Dir& d, Key key) {
  int m = kIntMax;
  for (int j = 0; j < d.nj; ++j) {
    const int l = (j << 5) + lane_id();
    if (l < d.L) m = min(m, key(l));
  }
  return __reduce_min_sync(kFull, m);
}

// Smallest stamp in list ``want`` (INT_MAX when empty or want < 0).  The
// list's head is every lane with tag == want and that stamp
// (policy_core._keyed_head).
__device__ int head_stamp(const Dir& d, int want) {
  if (want < 0) return kIntMax;
  return dir_min(d, [&](int l) { return d.tag[l] == want ? d.stamp[l] : kIntMax; });
}

// Tag of the lane holding page x (0 if none) and the lane groups, as bits,
// where this thread holds it.
__device__ int find_page(const Dir& d, int x, unsigned& pres) {
  int tag_x = 0;
  pres = 0;
  for (int j = 0; j < d.nj; ++j) {
    const int l = (j << 5) + lane_id();
    if (l < d.L && d.tag[l] != kFree && d.blocks[l] == x) {
      pres |= 1u << j;
      tag_x = max(tag_x, d.tag[l]);
    }
  }
  return __reduce_max_sync(kFull, tag_x);
}

// First free lane (L with none).
__device__ int first_free_lane(const Dir& d) {
  return dir_min(d, [&](int l) { return d.tag[l] == kFree ? l : d.L; });
}

// policy_core._ghost_p: a B1 hit moves p up, a B2 hit down, in float32.
__device__ float ghost_p(float p, int cap, int n_b1, int n_b2, bool in_b1,
                         bool in_b2) {
  const float capf = (float)cap, b1f = (float)n_b1, b2f = (float)n_b2;
  if (in_b1)
    return fminf(capf, __fadd_rn(p, fmaxf(__fdiv_rn(b2f, fmaxf(b1f, 1.f)), 1.f)));
  if (in_b2)
    return fmaxf(__fsub_rn(p, fmaxf(__fdiv_rn(b1f, fmaxf(b2f, 1.f)), 1.f)), 0.f);
  return p;
}

// policy_core._renorm_stamps: when ctr >= renorm_at every lane's stamp
// becomes the number of lanes with a smaller stamp, and ctr becomes L.
__device__ void renorm_stamps(const Dir& d, int renorm_at, int& ctr) {
  if (ctr < renorm_at) return;
  __syncwarp();
  for (int j = 0; j < d.nj; ++j) {
    const int l = (j << 5) + lane_id();
    if (l < d.L) {
      const int s = d.stamp[l];
      int rank = 0;
      for (int m = 0; m < d.L; ++m) rank += d.stamp[m] < s;
      d.tmp[l] = rank;
    }
  }
  __syncwarp();
  for (int j = 0; j < d.nj; ++j) {
    const int l = (j << 5) + lane_id();
    if (l < d.L) d.stamp[l] = d.tmp[l];
  }
  __syncwarp();
  ctr = d.L;
}

// policy_core._arc_step for one row.
__device__ void arc_access(const Dir& d, int x, float& p, int& ctr) {
  unsigned pres;
  const int tag_x = find_page(d, x, pres);
  int n[4];
  list_sizes(d, n);
  const int n1 = n[0], n2 = n[1], n3 = n[2], n4 = n[3], cap = d.cap;
  const bool hit = tag_x == kT1 || tag_x == kT2;
  const bool in_b1 = tag_x == kB1, in_b2 = tag_x == kB2, miss_new = tag_x == 0;
  // ghost-hit adaptation before REPLACE (B1 / B2 still hold x)
  const float p_new = ghost_p(p, cap, n3, n4, in_b1, in_b2);
  const int l1 = n1 + n3, total = n1 + n2 + n3 + n4;
  const bool cm1a = miss_new && l1 == cap && n1 < cap;   // pop B1's LRU
  const bool cm1b = miss_new && l1 == cap && n1 == cap;  // discard T1's LRU
  const bool cm2 = miss_new && l1 != cap;
  const bool do_repl = in_b1 || in_b2 || cm1a || (cm2 && total >= cap);
  const bool pop_b2 = cm2 && total == 2 * cap;
  const int pop_want = cm1a ? kB1 : pop_b2 ? kB2 : cm1b ? kT1 : -1;
  // REPLACE on the pre-pop planes: T1's LRU to B1 when |T1| > int(p) (or x
  // in B2 and |T1| == int(p)), else T2's LRU to B2
  const int ip = __float2int_rz(p_new);
  const bool cond_t1 = n1 >= 1 && ((in_b2 && n1 == ip) || n1 > ip);
  const bool dem_t1 = do_repl && cond_t1;
  const bool dem_t2 = do_repl && !cond_t1 && n2 >= 1;
  const int dem_want = dem_t1 ? kT1 : dem_t2 ? kT2 : -1;
  const int m_pop = head_stamp(d, pop_want), m_dem = head_stamp(d, dem_want);
  const int stamp_dem = ctr + 1, stamp_x = ctr + 2;
  const bool to_t2 = tag_x == kT1 || in_b1 || in_b2;
  const bool restamp_x = hit || in_b1 || in_b2;
  for (int j = 0; j < d.nj; ++j) {
    const int l = (j << 5) + lane_id();
    if (l >= d.L) continue;
    const int t = d.tag[l], s = d.stamp[l];
    const bool pop = t == pop_want && s == m_pop;
    const bool dem = t == dem_want && s == m_dem;
    const bool present = (pres >> j) & 1u;
    int nt = pop ? kFree : t, ns = s;
    if (pop) d.blocks[l] = -1;
    if (dem) {
      nt = dem_t1 ? kB1 : kB2;
      ns = stamp_dem;
    }
    if (present && to_t2) nt = kT2;  // T1 hit and ghost hits: T2's MRU
    if (present && restamp_x) ns = stamp_x;
    d.tag[l] = nt;
    d.stamp[l] = ns;
  }
  if (miss_new) {  // insert at T1's MRU in the first free lane
    const int ins = first_free_lane(d);
    if (ins < d.L && (ins & 31) == lane_id()) {
      d.tag[ins] = kT1;
      d.blocks[ins] = x;
      d.stamp[ins] = stamp_x;
    }
  }
  p = p_new;
  ctr += 2;
}

// policy_core._car_step for one row.
__device__ void car_access(const Dir& d, int x, float& p, int& ctr) {
  unsigned pres;
  const int tag_x = find_page(d, x, pres);
  int n[4];
  list_sizes(d, n);
  const int cap = d.cap;
  const bool hit = tag_x == kT1 || tag_x == kT2;
  const bool in_b1 = tag_x == kB1, in_b2 = tag_x == kB2, miss_new = tag_x == 0;
  const bool full = n[0] + n[1] == cap;
  for (int j = 0; j < d.nj; ++j) {  // a hit sets the reference bit
    const int l = (j << 5) + lane_id();
    if (hit && ((pres >> j) & 1u)) d.ref[l] = 1;
  }
  // REPLACE when full: the clock-hand sweep, at most c + 1 trips; each trip
  // evicts the hand's page to its ghost list (ref 0) and ends the sweep, or
  // promotes T1's hand to T2's tail / rotates T2's (ref 1)
  bool live = !hit && full;
  const int ip = max(__float2int_rz(p), 1);
  for (int it = 0; it < cap + 1 && live; ++it) {
    int nc[4];
    list_sizes(d, nc);
    const bool use_t1 = nc[0] >= ip;
    const int want = use_t1 ? kT1 : kT2;
    const int m = head_stamp(d, want);
    int href = 0;
    for (int j = 0; j < d.nj; ++j) {
      const int l = (j << 5) + lane_id();
      if (l < d.L && d.tag[l] == want && d.stamp[l] == m) href = max(href, d.ref[l]);
    }
    const bool evict = __reduce_max_sync(kFull, href) == 0;
    const int snew = ctr + 1;
    for (int j = 0; j < d.nj; ++j) {
      const int l = (j << 5) + lane_id();
      if (l < d.L && d.tag[l] == want && d.stamp[l] == m) {
        d.tag[l] = evict ? (use_t1 ? kB1 : kB2) : kT2;
        d.ref[l] = 0;
        d.stamp[l] = snew;
      }
    }
    ctr += 1;
    live = !evict;
  }
  // complete-miss directory discards, from the post-sweep list sizes
  int np[4];
  list_sizes(d, np);
  const bool guard = miss_new && full;
  const bool popb1 = guard && np[0] + np[2] == cap + 1;
  const bool popb2 =
      guard && np[0] + np[2] != cap + 1 && np[0] + np[1] + np[2] + np[3] >= 2 * cap;
  const int pop_want = popb1 ? kB1 : popb2 ? kB2 : -1;
  const int m_pop = head_stamp(d, pop_want);
  // ghost-hit adaptation after REPLACE, from the post-sweep sizes
  p = ghost_p(p, cap, np[2], np[3], in_b1, in_b2);
  const int stamp_x = ctr + 1;
  for (int j = 0; j < d.nj; ++j) {
    const int l = (j << 5) + lane_id();
    if (l >= d.L) continue;
    if (d.tag[l] == pop_want && d.stamp[l] == m_pop) {
      d.tag[l] = kFree;
      d.blocks[l] = -1;
    }
    if (((pres >> j) & 1u) && (in_b1 || in_b2)) {  // ghost hit: T2's tail
      d.tag[l] = kT2;
      d.stamp[l] = stamp_x;
      d.ref[l] = 0;
    }
  }
  if (miss_new) {  // insert at T1's tail in the first free lane
    const int ins = first_free_lane(d);
    if (ins < d.L && (ins & 31) == lane_id()) {
      d.tag[ins] = kT1;
      d.blocks[ins] = x;
      d.stamp[ins] = stamp_x;
      d.ref[ins] = 0;
    }
  }
  if (!hit) ctr += 1;
}

__device__ __forceinline__ void dir_access(const Dir& d, int kind, int x, float& p,
                                       int& ctr) {
  if (kind == kKindArc)
    arc_access(d, x, p, ctr);
  else
    car_access(d, x, p, ctr);
}

template <typename T>
struct Args {
  const T* q; const T* k; const T* v; const T* new_k; const T* new_v;
  const int* f; const int* r; const int* page_start; const int* clock;
  const int* open_slot;
  const int* blocks; const int* tag; const int* stamp; const int* ref;
  const float* p; const int* ctr;
  T* out; float* mass; int* slot; int* f_out; int* r_out; int* ps_out;
  int* clock_out; int* open_out;
  int* blocks_out; int* tag_out; int* stamp_out; int* ref_out; float* p_out;
  int* ctr_out;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
adaptive_paged_attention_kernel(Args<T> a, int pos, Dims d, int L, float scale,
                                int kind, int renorm_at) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve(smem_raw, d, sizeof(T));
  int* dir_base = reinterpret_cast<int*>(smem_raw + smem_bytes(d, sizeof(T)));
  const Dir dir{dir_base, dir_base + L, dir_base + 2 * L, dir_base + 3 * L,
                dir_base + 4 * L, L, (L + 31) / 32, d.P};
  __shared__ int ev_shared;
  const int b = blockIdx.x, P = d.P;
  const size_t qsize = (size_t)d.KVH * d.G * d.hd;
  const size_t row = (size_t)d.KVH * d.hd;
  const size_t page_elems = (size_t)d.page * row;
  const size_t boff = (size_t)b * P, loff = (size_t)b * L;
  const int clock_b = a.clock[b], open_b = a.open_slot[b];
  const int within = pos % d.page;
  const bool need_alloc = within == 0;
  const bool policy_warp = threadIdx.x < 32;

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    sm.fa[p] = a.f[boff + p];
    sm.ra[p] = a.r[boff + p];
    sm.psa[p] = a.page_start[boff + p];
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    dir.blocks[l] = a.blocks[loff + l];
    dir.tag[l] = a.tag[loff + l];
    dir.stamp[l] = a.stamp[loff + l];
    dir.ref[l] = a.ref[loff + l];
  }
  init_state<T>(sm, a.q + b * qsize, d);  // ends with a barrier

  float p_b = a.p[b];
  int ctr_b = a.ctr[b];
  if (policy_warp) {
    renorm_stamps(dir, renorm_at, ctr_b);
    int ev = -1;
    if (need_alloc) {
      for (int j = 0; j < dir.nj; ++j) {  // resident page ids before the miss
        const int l = (j << 5) + lane_id();
        if (l < L) {
          const int t = dir.tag[l];
          dir.tmp[l] = (t == kT1 || t == kT2) ? dir.blocks[l] : kIntMin;
        }
      }
      dir_access(dir, kind, pos / d.page, p_b, ctr_b);
      int m = -1;
      for (int j = 0; j < dir.nj; ++j) {
        const int l = (j << 5) + lane_id();
        if (l < L && dir.tmp[l] != kIntMin && dir.tag[l] != kT1 && dir.tag[l] != kT2)
          m = max(m, dir.tmp[l]);
      }
      ev = __reduce_max_sync(kFull, m);
    }
    if (threadIdx.x == 0) ev_shared = ev;
  }
  __syncthreads();

  int slot = open_b;
  if (need_alloc) {
    const int ev_id = ev_shared;
    const int first_free =
        lanes_first_min(P, [&](int p) { return sm.psa[p] < 0 ? 0 : 1; });
    const int victim = lanes_first_min(P, [&](int p) {
      const int ps = sm.psa[p];
      return (ps >= 0 ? ps / d.page : -2) == ev_id ? 0 : 1;
    });
    slot = ev_id >= 0 ? victim : first_free;
    if (threadIdx.x == 0) {
      sm.fa[slot] = 1;
      sm.ra[slot] = clock_b;
      sm.psa[slot] = pos;
    }
    __syncthreads();
  }

  const T* nk = a.new_k + b * row;
  const T* nv = a.new_v + b * row;
  for (int p = 0; p < P; ++p) {
    const size_t off = (boff + p) * page_elems;
    if (page_partials<T>(sm, a.k + off, a.v + off, nk, nv, p == slot ? within : -1,
                         sm.psa[p], pos, p, scale, d))
      page_fold(sm, p, d);
  }
  finalize<T>(sm, a.out + b * qsize, a.mass + boff, d);  // ends with a barrier

  int res = 0;
  for (int p = threadIdx.x; p < P; p += blockDim.x) res += sm.psa[p] >= 0;
  const int resident = block_sum(res);
  const float tau = __fdiv_rn(1.0f, fmaxf((float)resident, 1.0f));
  const int clock_new = clock_b + 1;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const bool referenced = sm.mass[p] >= tau && sm.psa[p] >= 0;
    a.f_out[boff + p] = referenced ? sm.fa[p] + 1 : sm.fa[p];
    a.r_out[boff + p] = referenced ? clock_new : sm.ra[p];
    a.ps_out[boff + p] = sm.psa[p];
  }
  if (threadIdx.x == 0) {
    a.slot[b] = slot;
    a.clock_out[b] = clock_new;
    a.open_out[b] = need_alloc ? slot : open_b;
  }
  if (!policy_warp) return;

  // the hit pass: P masked accesses in slot order
  for (int s = 0; s < P; ++s) {
    renorm_stamps(dir, renorm_at, ctr_b);
    if (sm.mass[s] >= tau && sm.psa[s] >= 0)
      dir_access(dir, kind, sm.psa[s] / d.page, p_b, ctr_b);
  }
  for (int j = 0; j < dir.nj; ++j) {
    const int l = (j << 5) + lane_id();
    if (l < L) {
      a.blocks_out[loff + l] = dir.blocks[l];
      a.tag_out[loff + l] = dir.tag[l];
      a.stamp_out[loff + l] = dir.stamp[l];
      a.ref_out[loff + l] = dir.ref[l];
    }
  }
  if (threadIdx.x == 0) {
    a.p_out[b] = p_b;
    a.ctr_out[b] = ctr_b;
  }
}

template <typename T>
cudaError_t launch(const void* const* ptrs, int pos, int B, const Dims& d, int L,
                   float scale, int kind, int renorm_at, cudaStream_t stream) {
  const size_t bytes = smem_bytes(d, sizeof(T)) + 5 * (size_t)L * sizeof(int);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = adaptive_paged_attention_kernel<T>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  auto in = [&](int i) { return static_cast<const T*>(ptrs[i]); };
  auto ci = [&](int i) { return static_cast<const int*>(ptrs[i]); };
  auto oi = [&](int i) { return static_cast<int*>(const_cast<void*>(ptrs[i])); };
  Args<T> a;
  a.q = in(0); a.k = in(1); a.v = in(2); a.new_k = in(3); a.new_v = in(4);
  a.f = ci(5); a.r = ci(6); a.page_start = ci(7); a.clock = ci(8);
  a.open_slot = ci(9);
  a.blocks = ci(10); a.tag = ci(11); a.stamp = ci(12); a.ref = ci(13);
  a.p = static_cast<const float*>(ptrs[14]); a.ctr = ci(15);
  a.out = static_cast<T*>(const_cast<void*>(ptrs[16]));
  a.mass = static_cast<float*>(const_cast<void*>(ptrs[17]));
  a.slot = oi(18); a.f_out = oi(19); a.r_out = oi(20); a.ps_out = oi(21);
  a.clock_out = oi(22); a.open_out = oi(23);
  a.blocks_out = oi(24); a.tag_out = oi(25); a.stamp_out = oi(26);
  a.ref_out = oi(27);
  a.p_out = static_cast<float*>(const_cast<void*>(ptrs[28]));
  a.ctr_out = oi(29);
  kern<<<B, kThreads, bytes, stream>>>(a, pos, d, L, scale, kind, renorm_at);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

extern "C" int repro_adaptive_policy_paged_attention(
    int dtype, const void* q, const void* k, const void* v, const void* new_k,
    const void* new_v, int pos, const void* f, const void* r,
    const void* page_start, const void* clock, const void* open_slot,
    const void* blocks, const void* tag, const void* stamp, const void* ref,
    const void* p, const void* ctr, void* out, void* mass, void* slot,
    void* f_out, void* r_out, void* ps_out, void* clock_out, void* open_out,
    void* blocks_out, void* tag_out, void* stamp_out, void* ref_out,
    void* p_out, void* ctr_out, int B, int P, int page, int KVH, int G, int hd,
    int L, float scale, int kind, int renorm_at, void* stream) {
  using namespace repro;
  if (G < 1 || G > kMaxG || B < 1 || P < 1 || page < 1 || pos < 0 ||
      L < 2 * P || L > kMaxLanes || (kind != kKindArc && kind != kKindCar))
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2;
  if (KVH * hd * esize % 16) return (int)cudaErrorInvalidValue;  // 16 B row chunks
  Dims d{P, page, KVH, G, hd, 0};
  d.chunk = chunk_rows(d, esize);
  if (d.chunk < 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[30] = {q, k, v, new_k, new_v, f, r, page_start, clock,
                          open_slot, blocks, tag, stamp, ref, p, ctr, out, mass,
                          slot, f_out, r_out, ps_out, clock_out, open_out,
                          blocks_out, tag_out, stamp_out, ref_out, p_out, ctr_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(ptrs, pos, B, d, L, scale, kind, renorm_at, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(ptrs, pos, B, d, L, scale, kind, renorm_at, st);
  return (int)cudaErrorInvalidValue;
}
