// AWRP victim selection: the paper's eq. (1) weight and its first-index min.
//
// Replaces two Pallas TPU kernels of repro/kernels/awrp_select.py:
//   awrp_select_kernel       (kernel 1, one program per row, with `pinned`)
//   awrp_select_rows_kernel  (kernel 2, all rows in one program, no `pinned`)
// Both computed `_masked_weight_first_min`: per row b and lane p,
//   w   = f32(F[b,p]) / f32(max(N[b] - R[b,p], 1))        (IEEE, round-to-nearest)
//   key = (valid && !pinned) ? bit pattern of w as int32 : INT_MAX
// and the victim is the first lane achieving the row minimum of the keys.
// w >= 0, so the int32 order of the keys is the float order; keys are compared
// as ints, never as floats, exactly as the reference does.  A row whose lanes
// are all masked returns lane 0, as the reference's min over (key, lane) does.
//
// Design: one warp per row, 8 rows per 256-thread block, grid ceil(B / 8).  A
// thread strides over the lanes p = lane_id, lane_id + 32, ... (coalesced
// int32 loads) and keeps the lexicographic minimum of (key, p); the warp then
// reduces that pair with __shfl_xor_sync (smaller key wins, equal keys go to
// the smaller lane).  No shared memory.  The pair (INT_MAX, INT_MAX) is the
// identity, so threads past P and fully masked rows need no special case.
//
// What bounds it: bytes.  Each call reads F, R, valid (and pinned) once,
// B*P*(12|16) bytes, plus the clock and the victim, 8*B bytes.  The sweep's
// Table-1 grid (B = 32 AWRP rows of 240 lanes, ~92 KB) is a few hundred
// nanoseconds of memory traffic, so one call is bound by launch latency; the
// sweep engine calls kernel 2 once per trace step.
//
// Arithmetic that must match the plain version and the reference bit for
// bit: the clock difference wraps as int32 (as jnp and torch int32 do), the
// int -> float conversions and the division round to nearest
// (__int2float_rn, __fdiv_rn; the build has no --use_fast_math).
//
// C entry points (loaded with ctypes by repro_torch/kernels/_build.py):
//   repro_awrp_select(f, r, clock, valid, pinned, out, B, P, stream)
//   repro_awrp_select_rows(f, r, clock, valid, out, B, P, stream)
// f, r, valid, pinned (B, P) int32; clock and out (B,) int32; all contiguous.
// Each returns cudaGetLastError() after its launch.
#include <climits>
#include <cuda_runtime.h>

namespace repro {

constexpr int kSelWarp = 32;
constexpr int kSelRowsPerBlock = 8;
constexpr int kSelThreads = kSelWarp * kSelRowsPerBlock;

// The victim of one row, computed by one full warp; every lane of the warp
// returns it.  `pinned` may be null (kernel 2).
__device__ __forceinline__ int awrp_row_victim(const int* __restrict__ f,
                                               const int* __restrict__ r,
                                               int clock,
                                               const int* __restrict__ valid,
                                               const int* __restrict__ pinned,
                                               int P, int lane_id) {
  int best_key = INT_MAX;
  int best_lane = INT_MAX;
  for (int p = lane_id; p < P; p += kSelWarp) {
    int key = INT_MAX;
    if (valid[p] != 0 && (pinned == nullptr || pinned[p] == 0)) {
      const int diff = (int)((unsigned)clock - (unsigned)r[p]);
      const int dt = diff > 1 ? diff : 1;
      key = __float_as_int(__fdiv_rn(__int2float_rn(f[p]), __int2float_rn(dt)));
    }
    // lanes visit p in increasing order: on equal keys keep the first
    if (key < best_key || (key == best_key && p < best_lane)) {
      best_key = key;
      best_lane = p;
    }
  }
#pragma unroll
  for (int off = kSelWarp / 2; off > 0; off >>= 1) {
    const int k = __shfl_xor_sync(0xffffffffu, best_key, off);
    const int l = __shfl_xor_sync(0xffffffffu, best_lane, off);
    if (k < best_key || (k == best_key && l < best_lane)) {
      best_key = k;
      best_lane = l;
    }
  }
  return best_lane;
}

__global__ void __launch_bounds__(kSelThreads)
awrp_select_kernel(const int* __restrict__ f, const int* __restrict__ r,
                   const int* __restrict__ clock, const int* __restrict__ valid,
                   const int* __restrict__ pinned, int* __restrict__ out, int B,
                   int P) {
  const int warp = threadIdx.x / kSelWarp;
  const int lane_id = threadIdx.x % kSelWarp;
  const int row = blockIdx.x * kSelRowsPerBlock + warp;
  if (row >= B) return;  // the whole warp leaves together
  const size_t off = (size_t)row * P;
  const int victim = awrp_row_victim(f + off, r + off, clock[row], valid + off,
                                     pinned == nullptr ? nullptr : pinned + off,
                                     P, lane_id);
  if (lane_id == 0) out[row] = victim;
}

static int launch_select(const void* f, const void* r, const void* clock,
                         const void* valid, const void* pinned, void* out, int B,
                         int P, void* stream) {
  if (B < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kSelRowsPerBlock - 1) / kSelRowsPerBlock;
  awrp_select_kernel<<<blocks, kSelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(f), static_cast<const int*>(r),
      static_cast<const int*>(clock), static_cast<const int*>(valid),
      static_cast<const int*>(pinned), static_cast<int*>(out), B, P);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_awrp_select(const void* f, const void* r, const void* clock,
                                 const void* valid, const void* pinned, void* out,
                                 int B, int P, void* stream) {
  if (pinned == nullptr) return (int)cudaErrorInvalidValue;
  return repro::launch_select(f, r, clock, valid, pinned, out, B, P, stream);
}

extern "C" int repro_awrp_select_rows(const void* f, const void* r,
                                      const void* clock, const void* valid,
                                      void* out, int B, int P, void* stream) {
  return repro::launch_select(f, r, clock, valid, nullptr, out, B, P, stream);
}
