// The ARC / CAR directory state machine on one warp, shared by
//   adaptive_attn.cu  kernel 5, the fused true-adaptive decode step
//   sweep.cu          adaptive_sweep_kernel, an ARC/CAR row group's whole trace
//
// repro_torch/core/policy_core.py _arc_step / _car_step at rows = 1,
// operation for operation: list sizes, list heads as the lanes holding the
// smallest stamp of a list, the first free lane for an insert, float32 p
// arithmetic with IEEE division (__fdiv_rn; no products, so nothing
// contracts into an FMA), int(p) truncating (__float2int_rz), ARC's p update
// before REPLACE, CAR's after its clock-hand sweep (at most c + 1 trips, a
// warp-uniform loop), ARC granting ctr 2 per access, CAR 1 per trip and 1
// per miss or ghost hit.  The rank of a renormalization runs over all L
// lanes, free lanes' stale stamps included.
//
// The directory (blocks, tag, stamp, ref: 4 x L int32, plus one L scratch
// plane) lives in shared memory and ONE warp runs the policy: thread t owns
// lanes t, t + 32, ...; a list size is a __ballot_sync / __popc sum, a head a
// __reduce_min_sync of the stamp, and each thread reads and writes only its
// own lanes, so the warp needs no barrier except around a renormalization
// (every lane reads every stamp).  An access returns whether x was resident
// (in T1 or T2) before it: the hit.  Build without --use_fast_math.
#pragma once

#include "paged_attn_common.cuh"

namespace repro {

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
__device__ inline void list_sizes(const Dir& d, int n[4]) {
  n[0] = n[1] = n[2] = n[3] = 0;
  for (int j = 0; j < d.nj; ++j) {
    const int l = (j << 5) + lane_id();
    const int t = l < d.L ? d.tag[l] : kFree;
    for (int c = 0; c < 4; ++c) n[c] += __popc(__ballot_sync(kFull, t == kT1 + c));
  }
}

// Warp minimum of key(l) over the lanes (INT_MAX with none).
template <typename Key>
__device__ inline int dir_min(const Dir& d, Key key) {
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
__device__ inline int head_stamp(const Dir& d, int want) {
  if (want < 0) return kIntMax;
  return dir_min(d, [&](int l) { return d.tag[l] == want ? d.stamp[l] : kIntMax; });
}

// Tag of the lane holding page x (0 if none) and the lane groups, as bits,
// where this thread holds it.
__device__ inline int find_page(const Dir& d, int x, unsigned& pres) {
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
__device__ inline int first_free_lane(const Dir& d) {
  return dir_min(d, [&](int l) { return d.tag[l] == kFree ? l : d.L; });
}

// policy_core._ghost_p: a B1 hit moves p up, a B2 hit down, in float32.
__device__ inline float ghost_p(float p, int cap, int n_b1, int n_b2, bool in_b1,
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
__device__ inline void renorm_stamps(const Dir& d, int renorm_at, int& ctr) {
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

// policy_core._arc_step for one row; returns the hit.
__device__ inline bool arc_access(const Dir& d, int x, float& p, int& ctr) {
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
  return hit;
}

// policy_core._car_step for one row; returns the hit.
__device__ inline bool car_access(const Dir& d, int x, float& p, int& ctr) {
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
  return hit;
}

__device__ __forceinline__ bool dir_access(const Dir& d, int kind, int x, float& p,
                                           int& ctr) {
  if (kind == kKindArc) return arc_access(d, x, p, ctr);
  return car_access(d, x, p, ctr);
}

// The directory carved at ``base``: 5 planes of L ints.
__device__ __forceinline__ Dir dir_at(int* base, int L, int cap) {
  return Dir{base, base + L, base + 2 * L, base + 3 * L, base + 4 * L, L, (L + 31) / 32, cap};
}

// Copy one sequence's directory planes into ``dir``.  Called by every thread
// of the CTA; ends with a barrier.
__device__ inline void load_dir(const Dir& dir, const int* blocks, const int* tag,
                                const int* stamp, const int* ref) {
  for (int l = threadIdx.x; l < dir.L; l += blockDim.x) {
    dir.blocks[l] = blocks[l];
    dir.tag[l] = tag[l];
    dir.stamp[l] = stamp[l];
    dir.ref[l] = ref[l];
  }
  __syncthreads();
}

// Write ``dir``'s planes: called by the policy warp, each thread its own lanes.
__device__ inline void store_dir(const Dir& dir, int* blocks, int* tag, int* stamp, int* ref) {
  for (int j = 0; j < dir.nj; ++j) {
    const int l = (j << 5) + lane_id();
    if (l < dir.L) {
      blocks[l] = dir.blocks[l];
      tag[l] = dir.tag[l];
      stamp[l] = dir.stamp[l];
      ref[l] = dir.ref[l];
    }
  }
}

}  // namespace repro
