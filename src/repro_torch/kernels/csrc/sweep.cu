// Persistent trace kernels of the batched sweep engine: one launch runs a
// row group's whole trace, every row's policy state on the chip from the
// first access to the last.
//
//   flat_sweep_kernel      kernel 2 redesigned.  Replaces the per-step victim
//                          search of repro/kernels/awrp_select.py
//                          awrp_select_rows_kernel (Pallas, TPU), called once
//                          per trace step inside the reference's jitted
//                          lax.scan (repro/core/jax_policies.py
//                          simulate_trace_batched), together with the step
//                          around it: repro_torch/core/policy_core.py
//                          FlatCore.on_access for awrp / lru / fifo / lfu rows
//                          with mixed ways (dead lanes) and any num_sets.
//   adaptive_sweep_kernel  the same for one ARC or CAR row group:
//                          AdaptiveCore.on_access at every step, on the
//                          one-warp directory machine of adaptive_common.cuh.
//   flat_stream_kernel,    the stream mode of the two, for the tenancy manager
//   adaptive_stream_kernel (repro_torch/serve/tenancy.py access_stream and
//                          access): one interleaved stream of (row, key)
//                          accesses over one row per tenant, num_sets = 1,
//                          from a given state and given counters; access t
//                          acts on row stream[t].row only, as the reference's
//                          lax.scan of masked on_access_counted steps
//                          (repro/serve/tenancy.py _jit_stream).
//
// Layout.  One warp per (row, set), kSweepWarps of them per CTA, consecutive
// units u = row * S + set.  A flat warp keeps its set's W lanes of blocks /
// F / R (and the victim key) in registers, thread t owning lanes t, t + 32,
// ... (W <= 256; shared memory above that), and its clock in a register; an
// adaptive warp keeps its directory (5 x L int32, 9.6 KB at L = 480) in
// shared memory and p / ctr in registers.  The traces are read as they are,
// (N, T) int32, with a (rows,) row -> trace map: each warp's trace ids go
// through shared memory in double-buffered chunks of kChunk (4-byte
// cp.async), and warps of one trace read the buffer of the first of them,
// which alone copies (the engine orders rows by trace, so a CTA's chunk
// usually serves all of its warps).  At step t only the warp whose set is
// id % S acts; lane 0 writes the hit.  At the end every warp writes its final
// planes.  Nothing is written back to an input.
//
// The flat step (policy_core._row_step / _flat_victim) with kernel 2's
// arithmetic (awrp_select.cu): the hit lane is the first lane holding the id
// (a warp min); on a miss the victim is the first-index min of the primary
// key (AWRP: the int32 bit pattern of __fdiv_rn(__int2float_rn(F),
// __int2float_rn(max(clock - R, 1))), the clock difference wrapping as
// int32; LRU / FIFO: R; LFU: F), INT_MAX on dead lanes, ties broken by R for
// LFU and by lane otherwise; an empty lane's F = R = 0 fills first.  The slot
// gets F + 1 (hit) or 1, R = the clock (FIFO keeps R on a hit), the id.
//
// The adaptive step runs the renormalization check in EVERY (row, set) warp
// at every step of its row, as the eager core checks every set of the row
// before every access (policy_core.on_access -> _renorm_stamps), so the final
// planes match too; then the set's warp runs dir_access.  CAR's clock-hand
// sweep is car_access's warp-uniform loop of at most c + 1 trips: no host
// round trip.
//
// The stream mode runs the same step functions and the same chunk pipeline:
// every warp (one per row) reads the whole (T, 2) stream, the CTA's first
// warp staging it, and acts only where the access's row is its own.  It
// starts from the planes and counters it is given and writes new ones.  On
// its own accesses a warp also counts the hit, the miss and the structural
// eviction (occupancy before + 1 - occupancy after, live lanes only: on a
// flat row only the slot's lane changes) and folds the eviction into the
// pressure EWMA as the reference's jitted step rounds it, one fused
// multiply-add: __fmaf_rn(__fsub_rn(1, a), p, __fmul_rn(a, e)), written out
// so that nvcc's -fmad choice does not pick the form.  An ARC/CAR warp runs
// the renormalization check at every access of the stream, its own or not
// (the reference renormalizes every row before the masked select keeps
// inactive rows), so a stream that ends before a row's next access leaves
// the same planes.  An inactive flat row does not tick its clock.
//
// The ring variant of the stream mode (template kRing; the ring-off
// instantiations are the kernels above, unchanged) also writes the
// decision-trace ring of repro_torch/obs/decision_trace.py, as the
// reference's masked on_access_counted(ring=...) pushes it: one access event
// per access, access t in slot (c0 + t) mod cap, c0 the ring's count read
// from device memory.  Only the accesses t >= T - cap write theirs: exactly
// those survive the reference's sequential overwrite, so no two warps write
// one slot and no atomics are needed; the owning warp's lane 0 writes the
// event into ring_buf, which the wrapper fills with a copy of the ring it
// was given (a device-to-device copy at the copy rate, so a launch of T = 1
// does not copy the ring on one CTA), and thread 0 of CTA 0 writes the new
// count c0 + T into its own tensor: the inputs are never written.  A flat
// event carries the victim the miss path would pick
// from the pre-access lanes at clock + 1 (computed on a hit too) and that
// lane's AWRP weight bits; an ARC/CAR event the probe victim of
// AdaptiveCore.victim (dir_access of the never-seen id INT_MAX on a copy of
// the warp's directory, p and ctr in 4 more planes of shared memory; the
// first lane resident before and not after, or -1) and p before and after
// the access.
//
// What bounds it on an H100: neither bytes nor operations.  A Table-1 trace
// moves about 4 KB of ids in and 1 byte of hit per row and step out, a few
// microseconds of HBM traffic; what takes the time is each row's serial
// chain of steps, a few dependent warp reductions each (flat: the hit and
// key minima, then the tie-break minima on a miss; ARC/CAR: about 20 over
// L / 32 lane groups, plus CAR's trips).  The design keeps every step's
// state on the SM, so no global access sits in the chain, and puts all rows
// in one launch, so the chains of a grid run side by side (2048 flat warps
// are one wave on 132 SMs).  Build without --use_fast_math.
//
// C entry points (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_flat_sweep(traces, row_trace, pid, ways, hits, blocks, f, r, clock,
//                    rows, T, S, W, stream)
//   repro_adaptive_sweep(traces, row_trace, caps, hits, blocks, tag, stamp,
//                        ref, p, ctr, rows, T, S, L, kind, renorm, renorm_at,
//                        stream)
//   repro_flat_stream(acc, pid, ways, blocks_in, f_in, r_in, clock_in,
//                     counters_in[4], hits, blocks, f, r, clock, counters[4],
//                     rows, T, W, alpha, stream, ring_count_in, ring_buf,
//                     ring_count, ring_cap)
//   repro_adaptive_stream(acc, caps, blocks_in, tag_in, stamp_in, ref_in, p_in,
//                         ctr_in, counters_in[4], hits, blocks, tag, stamp, ref,
//                         p, ctr, counters[4], rows, T, L, kind, renorm,
//                         renorm_at, alpha, stream, ring_count_in, ring_buf,
//                         ring_count, ring_cap)
// traces (N, T) int32; row_trace, pid, ways, caps (rows,) int32 (row_trace in
// [0, N), pid a flat POLICY_IDS value, 1 <= ways <= W <= kMaxFlatLanes,
// 1 <= caps, 2 * caps <= L <= kMaxLanes); hits (rows, T) bool; flat planes
// (rows, S, W) and clock (rows, S) int32; adaptive planes (rows, S, L) int32,
// p (rows, S) float32, ctr (rows, S) int32; kind 0 = arc, 1 = car; renorm 0
// skips the renormalization check; ring_buf (ring_cap + 1, kRingFields)
// int32, written in place, and ring_count_in / ring_count one int32, all
// null (and ring_cap 0) for the ring-off kernels.  All contiguous.  Each returns
// cudaGetLastError() after its launch.
#include <type_traits>

#include "adaptive_common.cuh"
#include "paged_attn_common.cuh"

namespace repro {
namespace {

constexpr int kSweepWarps = 4;  // (row, set) units per CTA
constexpr int kSweepThreads = 32 * kSweepWarps;
constexpr int kChunk = 256;  // trace ids per staged chunk
constexpr int kMaxRegGroups = 8;  // flat lanes in registers up to W = 256
constexpr int kMaxFlatLanes = 2048;  // flat lanes in shared memory above that
constexpr int kPolAwrp = 0, kPolLru = 1, kPolFifo = 2, kPolLfu = 3;  // POLICY_IDS

// The CTA's trace-id buffers, and each warp's trace (-1 for a warp past the
// last unit).
struct IdStage {
  int ids[kSweepWarps][2][kChunk];
  int trace[kSweepWarps];
};

// Opt the kernel in to ``bytes`` of dynamic shared memory beside its static
// IdStage (the default allows 48 KB of both together).
template <typename K>
cudaError_t allow_dynamic_smem(K kern, size_t bytes) {
  if (bytes == 0) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

// Calls step(rec, t) for t = 0 .. T-1 in order, rec = the t-th access of
// record n (kWidth consecutive ints: a trace's block id, or a stream's
// (row, key)), on every lane of the calling warp when n >= 0.  Every thread
// of the CTA calls it (it holds the barriers of the chunk pipeline).
template <int kWidth, typename Step>
__device__ __forceinline__ void for_each_access(IdStage& st, const int* __restrict__ traces,
                                                int n, int T, Step step) {
  static_assert(kChunk % kWidth == 0, "a chunk holds whole accesses");
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) st.trace[warp] = n;
  __syncthreads();
  int lead = warp;  // the first warp of the CTA on this record
  for (int w = 0; w < warp; ++w) {
    if (st.trace[w] == n) {
      lead = w;
      break;
    }
  }
  const bool copies = n >= 0 && lead == warp;
  const int total = T * kWidth;
  const int* src = traces + (size_t)(n < 0 ? 0 : n) * total;
  const int chunks = (total + kChunk - 1) / kChunk;
  // every thread commits one group per chunk (empty unless it copies), so
  // wait_group 1 leaves only the newest chunk in flight
  auto stage_chunk = [&](int c) {
    if (copies && c < chunks) {
      const int base = c * kChunk, cnt = min(kChunk, total - base);
      int* dst = st.ids[warp][c & 1];
      for (int i = threadIdx.x & 31; i < cnt; i += 32) cp_async4(dst + i, src + base + i);
    }
    cp_async_commit();
  };
  stage_chunk(0);
  for (int c = 0; c < chunks; ++c) {
    stage_chunk(c + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (n >= 0) {
      const int* ids = st.ids[lead][c & 1];
      const int base = c * kChunk, cnt = min(kChunk, total - base);
      for (int i = 0; i < cnt; i += kWidth) step(ids + i, (base + i) / kWidth);
    }
    __syncthreads();  // the buffer is refilled two chunks on
  }
}

// ---- flat rows (awrp / lru / fifo / lfu) -------------------------------------

// A warp's lanes in registers: group j holds lane j * 32 + t on thread t.
template <int NJ>
struct RegLanes {
  int b[NJ], f[NJ], r[NJ], k[NJ];  // blocks, F, R, this step's victim key
  __device__ __forceinline__ int nj() const { return NJ; }
  __device__ __forceinline__ int& blk(int j) { return b[j]; }
  __device__ __forceinline__ int& frq(int j) { return f[j]; }
  __device__ __forceinline__ int& rec(int j) { return r[j]; }
  __device__ __forceinline__ int& key(int j) { return k[j]; }
};

// The same in shared memory (W > 256): four planes of nj * 32 ints, the
// pointers already offset to this thread's lane.
struct SmemLanes {
  int *b, *f, *r, *k;
  int n;
  __device__ __forceinline__ int nj() const { return n; }
  __device__ __forceinline__ int& blk(int j) { return b[j << 5]; }
  __device__ __forceinline__ int& frq(int j) { return f[j << 5]; }
  __device__ __forceinline__ int& rec(int j) { return r[j << 5]; }
  __device__ __forceinline__ int& key(int j) { return k[j << 5]; }
};

// The victim's primary key of one lane at clock clk (policy_core._flat_victim
// stage 1; AWRP as kernel 2 computes it).
__device__ __forceinline__ int flat_key(int f, int r, int clk, int pol, bool live) {
  if (!live) return kIntMax;
  if (pol == kPolLru || pol == kPolFifo) return r;
  if (pol == kPolLfu) return f;
  const int diff = (int)((unsigned)clk - (unsigned)r);
  const int dt = diff > 1 ? diff : 1;
  return __float_as_int(__fdiv_rn(__int2float_rn(f), __int2float_rn(dt)));
}

// One access of block id to the warp's set (policy_core._row_step); returns
// the hit.  With occ_delta, also the change of the set's occupancy (live
// lanes holding a block): only the slot's lane changes.  kTrace (the ring
// variant) also gives, hit or miss, the victim lane the miss path picks and
// the bits of its AWRP weight at the access's clock (FlatCore._trace_cols).
template <bool kTrace = false, class Lanes>
__device__ __forceinline__ bool flat_access(Lanes& s, int& clock, int id, int pol, int ways,
                                            int W, int* occ_delta = nullptr,
                                            int* victim = nullptr, int* weight = nullptr) {
  const int lane = threadIdx.x & 31;
  const int clk = (int)((unsigned)clock + 1u);
  int hit_l = W, m1 = kIntMax;
#pragma unroll
  for (int j = 0; j < s.nj(); ++j) {
    const int l = (j << 5) + lane;
    if (l < W && s.blk(j) == id) hit_l = min(hit_l, l);
    s.key(j) = flat_key(s.frq(j), s.rec(j), clk, pol, l < ways);
    m1 = min(m1, s.key(j));
  }
  hit_l = __reduce_min_sync(kFull, hit_l);
  const bool hit = hit_l < W;
  int slot = hit_l;
  if (!hit || kTrace) {
    m1 = __reduce_min_sync(kFull, m1);
    // stage 2: the tie-break key among the lanes at m1 (R for LFU, the lane
    // otherwise); stage 3: the first lane at (m1, m2)
    int m2 = kIntMax;
#pragma unroll
    for (int j = 0; j < s.nj(); ++j) {
      const int l = (j << 5) + lane;
      if (s.key(j) == m1) m2 = min(m2, pol == kPolLfu ? s.rec(j) : l);
    }
    m2 = __reduce_min_sync(kFull, m2);
    if (pol == kPolLfu) {
      int v = W;
#pragma unroll
      for (int j = 0; j < s.nj(); ++j) {
        const int l = (j << 5) + lane;
        if (s.key(j) == m1 && s.rec(j) == m2) v = min(v, l);
      }
      slot = __reduce_min_sync(kFull, v);
    } else {
      slot = m2;
    }
    if constexpr (kTrace) {
      int w = 0;
#pragma unroll
      for (int j = 0; j < s.nj(); ++j) {
        if ((j << 5) + lane == slot) w = flat_key(s.frq(j), s.rec(j), clk, kPolAwrp, true);
      }
      *victim = slot;
      *weight = __shfl_sync(kFull, w, slot & 31);
      if (hit) slot = hit_l;
    }
  }
  int delta = 0;
#pragma unroll
  for (int j = 0; j < s.nj(); ++j) {
    if ((j << 5) + lane == slot) {
      if (slot < ways) delta = (int)(id >= 0) - (int)(s.blk(j) >= 0);
      s.frq(j) = hit ? s.frq(j) + 1 : 1;
      if (!(hit && pol == kPolFifo)) s.rec(j) = clk;  // FIFO keeps its insertion clock
      s.blk(j) = id;
    }
  }
  if (occ_delta) *occ_delta = __shfl_sync(kFull, delta, slot & 31);
  clock = clk;
  return hit;
}

struct FlatArgs {
  const int* traces;
  const int* row_trace;
  const int* pid;
  const int* ways;
  bool* hits;
  int* blocks;
  int* f;
  int* r;
  int* clock;
  int units;  // rows * S
  int T, S, W;
};

template <class Lanes>
__device__ __forceinline__ void flat_run(const FlatArgs& a, IdStage& st, Lanes& s) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kSweepWarps + (threadIdx.x >> 5);
  const bool active = u < a.units;
  const int row = active ? u / a.S : 0, set = active ? u % a.S : 0;
  const int pol = active ? a.pid[row] : 0, ways = active ? a.ways[row] : 0;
#pragma unroll
  for (int j = 0; j < s.nj(); ++j) {
    s.blk(j) = -1;
    s.frq(j) = 0;
    s.rec(j) = 0;
  }
  int clock = 0;
  bool* hits = a.hits + (size_t)row * a.T;
  for_each_access<1>(st, a.traces, active ? a.row_trace[row] : -1, a.T,
                     [&](const int* acc, int t) {
                       const int id = acc[0];
                       if (id % a.S != set) return;
                       const bool h = flat_access(s, clock, id, pol, ways, a.W);
                       if (lane == 0) hits[t] = h;
                     });
  if (!active) return;
  const size_t off = (size_t)u * a.W;
#pragma unroll
  for (int j = 0; j < s.nj(); ++j) {
    const int l = (j << 5) + lane;
    if (l < a.W) {
      a.blocks[off + l] = s.blk(j);
      a.f[off + l] = s.frq(j);
      a.r[off + l] = s.rec(j);
    }
  }
  if (lane == 0) a.clock[u] = clock;
}

// The warp's lanes in dynamic shared memory (W > 256): per warp 4 planes of
// (W + 31) / 32 * 32 ints.
__device__ __forceinline__ SmemLanes smem_lanes(int W) {
  extern __shared__ int lane_smem[];
  const int nj = (W + 31) / 32;
  int* base = lane_smem + (size_t)(threadIdx.x >> 5) * 4 * nj * 32 + (threadIdx.x & 31);
  return SmemLanes{base, base + nj * 32, base + 2 * nj * 32, base + 3 * nj * 32, nj};
}

// NJ > 0: lanes in registers, NJ groups of 32; NJ == 0: in shared memory.
template <int NJ>
__global__ void __launch_bounds__(kSweepThreads) flat_sweep_kernel(FlatArgs a) {
  __shared__ IdStage st;
  if constexpr (NJ > 0) {
    RegLanes<NJ> s;
    flat_run(a, st, s);
  } else {
    SmemLanes s = smem_lanes(a.W);
    flat_run(a, st, s);
  }
}

// The stream mode's per-row accounting: planes in, counters in, and out.
struct Counters {
  int* hits;
  int* misses;
  int* evictions;
  float* pressure;
};

struct CountersIn {
  const int* hits;
  const int* misses;
  const int* evictions;
  const float* pressure;
};

// One row's counters in registers; count() folds one own access.
struct RowCount {
  int hits, misses, evictions;
  float pressure;
  __device__ __forceinline__ void load(const CountersIn& c, int row) {
    hits = c.hits[row];
    misses = c.misses[row];
    evictions = c.evictions[row];
    pressure = c.pressure[row];
  }
  // the reference's EWMA, rounded once: fma(1 - a, p, a * e)
  __device__ __forceinline__ void count(bool hit, int evicted, float alpha) {
    hits += hit;
    misses += !hit;
    evictions += evicted;
    pressure = __fmaf_rn(__fsub_rn(1.f, alpha), pressure,
                         __fmul_rn(alpha, __int2float_rn(evicted)));
  }
  __device__ __forceinline__ void store(const Counters& c, int row) const {
    c.hits[row] = hits;
    c.misses[row] = misses;
    c.evictions[row] = evictions;
    c.pressure[row] = pressure;
  }
};

// The decision-trace ring of the stream mode's ring variant: the count
// given (read only) and the new ring.  kRingFields int32 per event, in
// obs/decision_trace.py FIELDS order; float fields as their bits.
constexpr int kRingFields = 10;

struct RingArgs {
  const int* count_in;  // events ever recorded
  int* buf;  // (cap + 1, kRingFields), lane cap the scratch lane: a copy of the given ring
  int* count;
  int cap;
};

// CTA 0's thread 0: the new count c0 + T (int32, wrapping as the reference's).
__device__ inline void ring_count(const RingArgs& g, int T) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *g.count = (int)((unsigned)*g.count_in + (unsigned)T);
}

// Access t's event (kind access, set 0, no admission code) into its slot, if
// it survives the launch (t >= T - cap).  Called by one thread.
__device__ inline void ring_event(const RingArgs& g, int t, int T, int row, int key, bool hit,
                                  int victim, int weight, int p_before, int p_after) {
  if (t < T - g.cap) return;
  int slot = (int)((unsigned)*g.count_in + (unsigned)t) % g.cap;
  if (slot < 0) slot += g.cap;
  int* e = g.buf + (size_t)slot * kRingFields;
  e[0] = 0;  // KIND_ACCESS
  e[1] = row;
  e[2] = key;
  e[3] = hit;
  e[4] = 0;  // set
  e[5] = victim;
  e[6] = weight;
  e[7] = p_before;
  e[8] = p_after;
  e[9] = -1;  // admit
}

struct FlatStreamArgs {
  const int* acc;  // (T, 2): row, key
  const int* pid;
  const int* ways;
  const int* blocks_in;
  const int* f_in;
  const int* r_in;
  const int* clock_in;
  CountersIn ctr_in;
  bool* hits;  // (T,)
  int* blocks;
  int* f;
  int* r;
  int* clock;
  Counters ctr;
  int rows, T, W;
  float alpha;
  RingArgs ring;  // the ring variant's
};

template <bool kRing, class Lanes>
__device__ __forceinline__ void flat_stream_run(const FlatStreamArgs& a, IdStage& st,
                                                Lanes& s) {
  if constexpr (kRing) ring_count(a.ring, a.T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kSweepWarps + (threadIdx.x >> 5);
  const bool active = row < a.rows;
  const int pol = active ? a.pid[row] : 0, ways = active ? a.ways[row] : 0;
  const size_t off = (size_t)(active ? row : 0) * a.W;
#pragma unroll
  for (int j = 0; j < s.nj(); ++j) {
    const int l = (j << 5) + lane;
    const bool in = active && l < a.W;
    s.blk(j) = in ? a.blocks_in[off + l] : -1;
    s.frq(j) = in ? a.f_in[off + l] : 0;
    s.rec(j) = in ? a.r_in[off + l] : 0;
  }
  int clock = active ? a.clock_in[row] : 0;
  RowCount c{0, 0, 0, 0.f};
  if (active) c.load(a.ctr_in, row);
  for_each_access<2>(st, a.acc, active ? 0 : -1, a.T, [&](const int* acc, int t) {
    if (acc[0] != row) return;  // another row's access: no clock tick
    int delta, victim, weight;
    const bool h = flat_access<kRing>(s, clock, acc[1], pol, ways, a.W, &delta, &victim, &weight);
    c.count(h, h ? 0 : 1 - delta, a.alpha);
    if (lane == 0) {
      a.hits[t] = h;
      if constexpr (kRing) ring_event(a.ring, t, a.T, row, acc[1], h, victim, weight, 0, 0);
    }
  });
  if (!active) return;
#pragma unroll
  for (int j = 0; j < s.nj(); ++j) {
    const int l = (j << 5) + lane;
    if (l < a.W) {
      a.blocks[off + l] = s.blk(j);
      a.f[off + l] = s.frq(j);
      a.r[off + l] = s.rec(j);
    }
  }
  if (lane == 0) {
    a.clock[row] = clock;
    c.store(a.ctr, row);
  }
}

template <int NJ, bool kRing>
__global__ void __launch_bounds__(kSweepThreads) flat_stream_kernel(FlatStreamArgs a) {
  __shared__ IdStage st;
  if constexpr (NJ > 0) {
    RegLanes<NJ> s;
    flat_stream_run<kRing>(a, st, s);
  } else {
    SmemLanes s = smem_lanes(a.W);
    flat_stream_run<kRing>(a, st, s);
  }
}

template <int NJ, class Args>
cudaError_t launch_flat(void (*kern)(Args), const Args& a, int units, int W,
                        cudaStream_t stream) {
  const size_t bytes = NJ > 0 ? 0 : (size_t)kSweepWarps * 4 * ((W + 31) / 32) * 32 * sizeof(int);
  const cudaError_t err = allow_dynamic_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  const int grid = (units + kSweepWarps - 1) / kSweepWarps;
  kern<<<grid, kSweepThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// Calls launch(std::integral_constant<int, NJ>) with W's lane groups NJ
// (lanes in registers up to 8 groups, 0: in shared memory).
template <class Launch>
cudaError_t by_lane_groups(int W, Launch launch) {
  switch ((W + 31) / 32) {
    case 1: return launch(std::integral_constant<int, 1>{});
    case 2: return launch(std::integral_constant<int, 2>{});
    case 3: return launch(std::integral_constant<int, 3>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    case 5: return launch(std::integral_constant<int, 5>{});
    case 6: return launch(std::integral_constant<int, 6>{});
    case 7: return launch(std::integral_constant<int, 7>{});
    case 8: return launch(std::integral_constant<int, kMaxRegGroups>{});
    default: return launch(std::integral_constant<int, 0>{});
  }
}

// ---- adaptive rows (arc / car) -------------------------------------------------

__global__ void __launch_bounds__(kSweepThreads)
adaptive_sweep_kernel(const int* __restrict__ traces, const int* __restrict__ row_trace,
                      const int* __restrict__ caps, bool* __restrict__ hits,
                      int* __restrict__ blocks_out, int* __restrict__ tag_out,
                      int* __restrict__ stamp_out, int* __restrict__ ref_out,
                      float* __restrict__ p_out, int* __restrict__ ctr_out, int units, int T,
                      int S, int L, int kind, int renorm, int renorm_at) {
  __shared__ IdStage st;
  extern __shared__ int dir_smem[];  // per warp the directory, 5 planes of L ints
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * kSweepWarps + warp;
  const bool active = u < units;
  const int row = active ? u / S : 0, set = active ? u % S : 0;
  const Dir d = dir_at(dir_smem + (size_t)warp * 5 * L, L, active ? caps[row] : 1);
  for (int l = lane; l < L; l += 32) {
    d.blocks[l] = -1;
    d.tag[l] = kFree;
    d.stamp[l] = 0;
    d.ref[l] = 0;
  }
  __syncwarp();
  float p = 0.f;
  int ctr = 0;
  bool* row_hits = hits + (size_t)row * T;
  for_each_access<1>(st, traces, active ? row_trace[row] : -1, T, [&](const int* acc, int t) {
    const int id = acc[0];
    if (renorm) renorm_stamps(d, renorm_at, ctr);  // every set, every step
    if (id % S != set) return;
    const bool h = dir_access(d, kind, id, p, ctr);
    if (lane == 0) row_hits[t] = h;
  });
  if (!active) return;
  const size_t off = (size_t)u * L;
  store_dir(d, blocks_out + off, tag_out + off, stamp_out + off, ref_out + off);
  if (lane == 0) {
    p_out[u] = p;
    ctr_out[u] = ctr;
  }
}

struct AdaptiveStreamArgs {
  const int* acc;  // (T, 2): row, key
  const int* caps;
  const int* blocks_in;
  const int* tag_in;
  const int* stamp_in;
  const int* ref_in;
  const float* p_in;
  const int* ctr_in;
  CountersIn cnt_in;
  bool* hits;  // (T,)
  int* blocks;
  int* tag;
  int* stamp;
  int* ref;
  float* p;
  int* ctr;
  Counters cnt;
  int rows, T, L, kind, renorm, renorm_at;
  float alpha;
  RingArgs ring;  // the ring variant's
};

// Residents (T1 and T2) of the warp's directory: AdaptiveCore.occupancy.
__device__ __forceinline__ int resident_count(const Dir& d) {
  int n = 0;
  for (int j = 0; j < d.nj; ++j) {
    const int l = (j << 5) + lane_id();
    const int t = l < d.L ? d.tag[l] : kFree;
    n += __popc(__ballot_sync(kFull, t == kT1 || t == kT2));
  }
  return n;
}

// AdaptiveCore.victim for the warp's directory d: dir_access of INT_MAX (an
// id no access uses) on ``probe``, a copy of d's blocks / tag / stamp / ref,
// with copies of p and ctr; the first lane resident (T1 or T2) in d and not
// in the probe, or -1.  d, p and ctr are not touched.  Each thread copies
// and reads only its own lanes, as dir_access does: no barrier.
__device__ inline int probe_victim(const Dir& d, const Dir& probe, int kind, float p, int ctr) {
  for (int j = 0; j < d.nj; ++j) {
    const int l = (j << 5) + lane_id();
    if (l < d.L) {
      probe.blocks[l] = d.blocks[l];
      probe.tag[l] = d.tag[l];
      probe.stamp[l] = d.stamp[l];
      probe.ref[l] = d.ref[l];
    }
  }
  dir_access(probe, kind, kIntMax, p, ctr);
  const int v = dir_min(d, [&](int l) {
    const bool before = d.tag[l] == kT1 || d.tag[l] == kT2;
    const bool after = probe.tag[l] == kT1 || probe.tag[l] == kT2;
    return before && !after ? l : d.L;
  });
  return v < d.L ? v : -1;
}

// Shared-memory planes per warp: the directory (5 x L), and in the ring
// variant the probe's copy (4 x L; its scratch plane is the directory's).
template <bool kRing>
constexpr int kDirPlanes = kRing ? 9 : 5;

template <bool kRing>
__global__ void __launch_bounds__(kSweepThreads) adaptive_stream_kernel(AdaptiveStreamArgs a) {
  __shared__ IdStage st;
  extern __shared__ int dir_smem[];  // per warp the directory (and the probe's copy)
  if constexpr (kRing) ring_count(a.ring, a.T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kSweepWarps + warp;
  const bool active = row < a.rows;
  int* const base = dir_smem + (size_t)warp * kDirPlanes<kRing> * a.L;
  const Dir d = dir_at(base, a.L, active ? a.caps[row] : 1);
  const size_t off = (size_t)(active ? row : 0) * a.L;
  for (int l = lane; l < a.L; l += 32) {
    d.blocks[l] = active ? a.blocks_in[off + l] : -1;
    d.tag[l] = active ? a.tag_in[off + l] : kFree;
    d.stamp[l] = active ? a.stamp_in[off + l] : 0;
    d.ref[l] = active ? a.ref_in[off + l] : 0;
  }
  __syncwarp();
  float p = active ? a.p_in[row] : 0.f;
  int ctr = active ? a.ctr_in[row] : 0;
  RowCount c{0, 0, 0, 0.f};
  if (active) c.load(a.cnt_in, row);
  for_each_access<2>(st, a.acc, active ? 0 : -1, a.T, [&](const int* acc, int t) {
    if (a.renorm) renorm_stamps(d, a.renorm_at, ctr);  // every row, every access
    if (acc[0] != row) return;
    const int occ_b = resident_count(d);
    int victim = -1;
    if constexpr (kRing) {
      // the probe only for an event that survives the launch
      if (t >= a.T - a.ring.cap) {
        const Dir probe{base + 5 * a.L, base + 6 * a.L, base + 7 * a.L, base + 8 * a.L,
                        d.tmp, d.L, d.nj, d.cap};
        victim = probe_victim(d, probe, a.kind, p, ctr);
      }
    }
    const float p_before = p;
    const bool h = dir_access(d, a.kind, acc[1], p, ctr);
    c.count(h, h ? 0 : occ_b + 1 - resident_count(d), a.alpha);
    if (lane == 0) {
      a.hits[t] = h;
      if constexpr (kRing)
        ring_event(a.ring, t, a.T, row, acc[1], h, victim, 0, __float_as_int(p_before),
                   __float_as_int(p));
    }
  });
  if (!active) return;
  store_dir(d, a.blocks + off, a.tag + off, a.stamp + off, a.ref + off);
  if (lane == 0) {
    a.p[row] = p;
    a.ctr[row] = ctr;
    c.store(a.cnt, row);
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_flat_sweep(const void* traces, const void* row_trace, const void* pid,
                                const void* ways, void* hits, void* blocks, void* f, void* r,
                                void* clock, int rows, int T, int S, int W, void* stream) {
  using namespace repro;
  if (rows < 1 || T < 0 || S < 1 || W < 1 || W > kMaxFlatLanes ||
      (long long)rows * S > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const FlatArgs a{static_cast<const int*>(traces), static_cast<const int*>(row_trace),
                   static_cast<const int*>(pid),    static_cast<const int*>(ways),
                   static_cast<bool*>(hits),        static_cast<int*>(blocks),
                   static_cast<int*>(f),            static_cast<int*>(r),
                   static_cast<int*>(clock),        rows * S,
                   T,                               S,
                   W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_lane_groups(W, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    return launch_flat<NJ>(flat_sweep_kernel<NJ>, a, rows * S, W, st);
  });
}

extern "C" int repro_adaptive_sweep(const void* traces, const void* row_trace, const void* caps,
                                    void* hits, void* blocks, void* tag, void* stamp, void* ref,
                                    void* p, void* ctr, int rows, int T, int S, int L, int kind,
                                    int renorm, int renorm_at, void* stream) {
  using namespace repro;
  if (rows < 1 || T < 0 || S < 1 || L < 2 || L > kMaxLanes ||
      (long long)rows * S > 2147483647LL || (kind != kKindArc && kind != kKindCar))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)kSweepWarps * 5 * L * sizeof(int);
  const cudaError_t err = allow_dynamic_smem(adaptive_sweep_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int units = rows * S;
  adaptive_sweep_kernel<<<(units + kSweepWarps - 1) / kSweepWarps, kSweepThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(traces), static_cast<const int*>(row_trace),
      static_cast<const int*>(caps), static_cast<bool*>(hits), static_cast<int*>(blocks),
      static_cast<int*>(tag), static_cast<int*>(stamp), static_cast<int*>(ref),
      static_cast<float*>(p), static_cast<int*>(ctr), units, T, S, L, kind, renorm, renorm_at);
  return (int)cudaGetLastError();
}

namespace {

repro::CountersIn counters_in(const void* const* c) {
  return {static_cast<const int*>(c[0]), static_cast<const int*>(c[1]),
          static_cast<const int*>(c[2]), static_cast<const float*>(c[3])};
}

repro::Counters counters_out(void* const* c) {
  return {static_cast<int*>(c[0]), static_cast<int*>(c[1]), static_cast<int*>(c[2]),
          static_cast<float*>(c[3])};
}

repro::RingArgs ring_args(const void* count_in, void* buf, void* count, int cap) {
  return {static_cast<const int*>(count_in), static_cast<int*>(buf), static_cast<int*>(count),
          cap};
}

}  // namespace

extern "C" int repro_flat_stream(const void* acc, const void* pid, const void* ways,
                                 const void* blocks_in, const void* f_in, const void* r_in,
                                 const void* clock_in, const void* const* ctr_in, void* hits,
                                 void* blocks, void* f, void* r, void* clock,
                                 void* const* ctr, int rows, int T, int W, float alpha,
                                 void* stream, const void* ring_count_in, void* ring_buf,
                                 void* ring_count, int ring_cap) {
  using namespace repro;
  const bool ring = ring_buf != nullptr;
  if (rows < 1 || T < 0 || T > (1 << 29) || W < 1 || W > kMaxFlatLanes ||
      (ring && (ring_cap < 1 || ring_cap > (1 << 27) || !ring_count_in || !ring_count)))
    return (int)cudaErrorInvalidValue;
  const FlatStreamArgs a{static_cast<const int*>(acc),      static_cast<const int*>(pid),
                         static_cast<const int*>(ways),     static_cast<const int*>(blocks_in),
                         static_cast<const int*>(f_in),     static_cast<const int*>(r_in),
                         static_cast<const int*>(clock_in), counters_in(ctr_in),
                         static_cast<bool*>(hits),          static_cast<int*>(blocks),
                         static_cast<int*>(f),              static_cast<int*>(r),
                         static_cast<int*>(clock),          counters_out(ctr),
                         rows,                              T,
                         W,                                 alpha,
                         ring_args(ring_count_in, ring_buf, ring_count, ring_cap)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_lane_groups(W, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    return ring ? launch_flat<NJ>(flat_stream_kernel<NJ, true>, a, rows, W, st)
                : launch_flat<NJ>(flat_stream_kernel<NJ, false>, a, rows, W, st);
  });
}

extern "C" int repro_adaptive_stream(const void* acc, const void* caps, const void* blocks_in,
                                     const void* tag_in, const void* stamp_in,
                                     const void* ref_in, const void* p_in, const void* ctr_in,
                                     const void* const* cnt_in, void* hits, void* blocks,
                                     void* tag, void* stamp, void* ref, void* p, void* ctr,
                                     void* const* cnt, int rows, int T, int L, int kind,
                                     int renorm, int renorm_at, float alpha, void* stream,
                                     const void* ring_count_in, void* ring_buf,
                                     void* ring_count, int ring_cap) {
  using namespace repro;
  const bool ring = ring_buf != nullptr;
  if (rows < 1 || T < 0 || T > (1 << 29) || L < 2 || L > kMaxLanes ||
      (kind != kKindArc && kind != kKindCar) ||
      (ring && (ring_cap < 1 || ring_cap > (1 << 27) || !ring_count_in || !ring_count)))
    return (int)cudaErrorInvalidValue;
  const AdaptiveStreamArgs a{static_cast<const int*>(acc),      static_cast<const int*>(caps),
                             static_cast<const int*>(blocks_in), static_cast<const int*>(tag_in),
                             static_cast<const int*>(stamp_in), static_cast<const int*>(ref_in),
                             static_cast<const float*>(p_in),   static_cast<const int*>(ctr_in),
                             counters_in(cnt_in),               static_cast<bool*>(hits),
                             static_cast<int*>(blocks),         static_cast<int*>(tag),
                             static_cast<int*>(stamp),          static_cast<int*>(ref),
                             static_cast<float*>(p),            static_cast<int*>(ctr),
                             counters_out(cnt),                 rows,
                             T,                                 L,
                             kind,                              renorm,
                             renorm_at,                         alpha,
                             ring_args(ring_count_in, ring_buf, ring_count, ring_cap)};
  auto launch = [&](auto kern, int planes) {
    const size_t bytes = (size_t)kSweepWarps * planes * L * sizeof(int);
    const cudaError_t err = allow_dynamic_smem(kern, bytes);
    if (err != cudaSuccess) return err;
    kern<<<(rows + kSweepWarps - 1) / kSweepWarps, kSweepThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(a);
    return cudaGetLastError();
  };
  return (int)(ring ? launch(adaptive_stream_kernel<true>, kDirPlanes<true>)
                    : launch(adaptive_stream_kernel<false>, kDirPlanes<false>));
}
