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
// traces (N, T) int32; row_trace, pid, ways, caps (rows,) int32 (row_trace in
// [0, N), pid a flat POLICY_IDS value, 1 <= ways <= W <= kMaxFlatLanes,
// 1 <= caps, 2 * caps <= L <= kMaxLanes); hits (rows, T) bool; flat planes
// (rows, S, W) and clock (rows, S) int32; adaptive planes (rows, S, L) int32,
// p (rows, S) float32, ctr (rows, S) int32; kind 0 = arc, 1 = car; renorm 0
// skips the renormalization check.  All contiguous.  Each returns
// cudaGetLastError() after its launch.
#include "adaptive_common.cuh"
#include "paged_attn_common.cuh"

namespace repro {
namespace {

constexpr int kSweepWarps = 4;  // (row, set) units per CTA
constexpr int kSweepThreads = 32 * kSweepWarps;
constexpr int kChunk = 256;  // trace ids per staged chunk
constexpr int kMaxRegGroups = 8;  // flat lanes in registers up to W = 256
constexpr int kMaxFlatLanes = 2048;  // flat lanes in shared memory above that
constexpr int kPolLru = 1, kPolFifo = 2, kPolLfu = 3;  // POLICY_IDS (0 = awrp)

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

// Calls step(id, t) for t = 0 .. T-1 in order, id = trace n's t-th block, on
// every lane of the calling warp when n >= 0.  Every thread of the CTA calls
// it (it holds the barriers of the chunk pipeline).
template <typename Step>
__device__ __forceinline__ void for_each_access(IdStage& st, const int* __restrict__ traces,
                                                int n, int T, Step step) {
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) st.trace[warp] = n;
  __syncthreads();
  int lead = warp;  // the first warp of the CTA on this trace
  for (int w = 0; w < warp; ++w) {
    if (st.trace[w] == n) {
      lead = w;
      break;
    }
  }
  const bool copies = n >= 0 && lead == warp;
  const int* src = traces + (size_t)(n < 0 ? 0 : n) * T;
  const int chunks = (T + kChunk - 1) / kChunk;
  // every thread commits one group per chunk (empty unless it copies), so
  // wait_group 1 leaves only the newest chunk in flight
  auto stage_chunk = [&](int c) {
    if (copies && c < chunks) {
      const int base = c * kChunk, cnt = min(kChunk, T - base);
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
      const int base = c * kChunk, cnt = min(kChunk, T - base);
      for (int i = 0; i < cnt; ++i) step(ids[i], base + i);
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
// the hit.
template <class Lanes>
__device__ __forceinline__ bool flat_access(Lanes& s, int& clock, int id, int pol, int ways,
                                            int W) {
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
  if (!hit) {
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
  }
#pragma unroll
  for (int j = 0; j < s.nj(); ++j) {
    if ((j << 5) + lane == slot) {
      s.frq(j) = hit ? s.frq(j) + 1 : 1;
      if (!(hit && pol == kPolFifo)) s.rec(j) = clk;  // FIFO keeps its insertion clock
      s.blk(j) = id;
    }
  }
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
  for_each_access(st, a.traces, active ? a.row_trace[row] : -1, a.T, [&](int id, int t) {
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

// NJ > 0: lanes in registers, NJ groups of 32; NJ == 0: in shared memory.
template <int NJ>
__global__ void __launch_bounds__(kSweepThreads) flat_sweep_kernel(FlatArgs a) {
  __shared__ IdStage st;
  if constexpr (NJ > 0) {
    RegLanes<NJ> s;
    flat_run(a, st, s);
  } else {
    extern __shared__ int lane_smem[];  // per warp 4 planes of nj * 32 ints
    const int nj = (a.W + 31) / 32;
    int* base = lane_smem + (size_t)(threadIdx.x >> 5) * 4 * nj * 32 + (threadIdx.x & 31);
    SmemLanes s{base, base + nj * 32, base + 2 * nj * 32, base + 3 * nj * 32, nj};
    flat_run(a, st, s);
  }
}

template <int NJ>
cudaError_t launch_flat(const FlatArgs& a, cudaStream_t stream) {
  const size_t bytes =
      NJ > 0 ? 0 : (size_t)kSweepWarps * 4 * ((a.W + 31) / 32) * 32 * sizeof(int);
  const cudaError_t err = allow_dynamic_smem(flat_sweep_kernel<NJ>, bytes);
  if (err != cudaSuccess) return err;
  const int grid = (a.units + kSweepWarps - 1) / kSweepWarps;
  flat_sweep_kernel<NJ><<<grid, kSweepThreads, bytes, stream>>>(a);
  return cudaGetLastError();
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
  for_each_access(st, traces, active ? row_trace[row] : -1, T, [&](int id, int t) {
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
  switch ((W + 31) / 32) {
    case 1: return (int)launch_flat<1>(a, st);
    case 2: return (int)launch_flat<2>(a, st);
    case 3: return (int)launch_flat<3>(a, st);
    case 4: return (int)launch_flat<4>(a, st);
    case 5: return (int)launch_flat<5>(a, st);
    case 6: return (int)launch_flat<6>(a, st);
    case 7: return (int)launch_flat<7>(a, st);
    case 8: return (int)launch_flat<kMaxRegGroups>(a, st);
    default: return (int)launch_flat<0>(a, st);
  }
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
