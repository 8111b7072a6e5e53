// Pieces every kernel library shares: the uint8 register max, the stream
// loader, the shared block scan, the work-unit plan and the segment gather
// of the tiled kernels, the dynamic shared-memory opt-in, and the plain C
// error interface the ctypes bindings read.
#pragma once

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace repro {

// Raise one uint8 register to `value` (1..255).  CUDA has no 8-bit
// atomicMax, so the byte is updated by compare-and-swap on the 32-bit word
// that holds it; works on shared and global memory alike.  A read that
// already sees a byte >= value costs no atomic -- the common case once a
// sketch has filled, and for repeated items.  Registers only grow, so a
// stale first read can only be low, and the CAS then corrects it.
__device__ __forceinline__ void byte_max(uint32_t* words, uint64_t cell,
                                         uint32_t value) {
  uint32_t* word = words + (cell >> 2);
  const uint32_t shift = static_cast<uint32_t>(cell & 3u) * 8u;
  uint32_t old = *reinterpret_cast<volatile uint32_t*>(word);
  while (((old >> shift) & 0xFFu) < value) {
    const uint32_t want = (old & ~(0xFFu << shift)) | (value << shift);
    const uint32_t seen = atomicCAS(word, old, want);
    if (seen == old) break;
    old = seen;
  }
}

// Exclusive scan of a[0 .. len) in shared memory, in place, by the whole
// block, after every thread's writes to it; returns the total.  `spare`
// holds 32 words of shared memory.  T is int32_t, or uint32_t where a total
// may pass 2^31 (its sums wrap mod 2^32).
template <typename T>
__device__ __forceinline__ T block_scan(T* a, int len, T* spare) {
  __syncthreads();
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int lo = min(len, static_cast<int>(threadIdx.x) * per), hi = min(len, lo + per);
  T sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  T x = sum;  // inclusive over the warp
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) spare[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < warps ? spare[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    spare[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  T run = x - sum + (warp > 0 ? spare[warp - 1] : 0);
  const T total = spare[warps - 1];
  for (int i = lo; i < hi; ++i) {
    const T v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

namespace detail {
__device__ __forceinline__ int32_t lane_of(const int4& q, int c) {
  return c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w;
}
template <typename F>
__device__ __forceinline__ void apply(F& f, const int32_t (&v)[1]) { f(v[0]); }
template <typename F>
__device__ __forceinline__ void apply(F& f, const int32_t (&v)[2]) { f(v[0], v[1]); }
template <typename F>
__device__ __forceinline__ void apply(F& f, const int32_t (&v)[3]) { f(v[0], v[1], v[2]); }
}  // namespace detail

// Apply f(src[0][i], .., src[K - 1][i]) to every i of [lo, hi) (lo a
// multiple of 4) of K int32 arrays, of which only the first `loaded` are
// read: the others, and every array past the end, give none[k].  The whole
// block takes the same number of turns, so a warp's lanes stay together
// for a warp match in f.  Where every array is 16-byte aligned (vec) a
// thread loads kQuads quads of each at once, so 4 * kQuads items are in
// flight: a pass that waits on one 4-byte load a turn is latency-bound.
template <int K, int kQuads = 2, typename F>
__device__ __forceinline__ void for_each_quad(const int32_t* const* src, const int32_t* none, int loaded,
                                              long long lo, long long hi, bool vec, F&& f) {
  long long tail = lo;
  if (vec) {
    const long long q_lo = lo / 4, q_hi = hi / 4;
    for (long long q0 = q_lo; q0 < q_hi; q0 += kQuads * blockDim.x) {
      int4 x[kQuads][K];
#pragma unroll
      for (int h = 0; h < kQuads; ++h) {
        const long long q = q0 + threadIdx.x + h * blockDim.x;
#pragma unroll
        for (int k = 0; k < K; ++k)
          x[h][k] = k < loaded && q < q_hi ? __ldg(reinterpret_cast<const int4*>(src[k]) + q)
                                          : make_int4(none[k], none[k], none[k], none[k]);
      }
#pragma unroll
      for (int h = 0; h < kQuads; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int32_t v[K];
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] = detail::lane_of(x[h][k], c);
          detail::apply(f, v);
        }
    }
    tail = q_hi * 4 > lo ? q_hi * 4 : lo;
  }
  for (long long i0 = tail; i0 < hi; i0 += blockDim.x) {
    const long long i = i0 + threadIdx.x;
    int32_t v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = k < loaded && i < hi ? src[k][i] : none[k];
    detail::apply(f, v);
  }
}

// The work units of a tile with `total` items: one per unit_items, at least
// one, at most one a slice.  Unit j of u takes the slices
// [j * slices / u, (j + 1) * slices / u).
__device__ __forceinline__ int unit_count(int total, int slices, int unit_items) {
  const int u = (total + unit_items - 1) / unit_items;
  return u < 1 ? 1 : (u > slices ? slices : u);
}

// The plan pass of a tiled scatter, by one whole block: extra_start[t] = the
// exclusive scan over tiles of (units of tile t) - 1, extra_start[tiles] =
// the extra units in all.  `extra` is tiles + 1 ints of shared memory.
__device__ __forceinline__ void plan_extra_units(const int32_t* __restrict__ tile_total, int tiles, int slices,
                                                 int unit_items, int32_t* __restrict__ extra_start,
                                                 int32_t* extra, int32_t* spare) {
  for (int t = threadIdx.x; t <= tiles; t += blockDim.x)
    extra[t] = t < tiles ? unit_count(tile_total[t], slices, unit_items) - 1 : 0;
  block_scan(extra, tiles + 1, spare);  // syncs
  for (int t = threadIdx.x; t <= tiles; t += blockDim.x) extra_start[t] = extra[t];
}

// The e-th extra unit of a tiled scatter: its tile t and unit j >= 1 in
// the tile, found in extra_start (plan_extra_units); false where e is past
// the last.
__device__ __forceinline__ bool extra_unit(const int32_t* __restrict__ extra_start, int tiles, int e, int* t,
                                           int* j) {
  if (e >= extra_start[tiles]) return false;
  int a = 0, c = tiles;  // the tile with extra_start[t] <= e < extra_start[t + 1]
  while (c - a > 1) {
    const int mid = (a + c) >> 1;
    if (extra_start[mid] <= e) a = mid;
    else c = mid;
  }
  *t = a;
  *j = e - extra_start[a] + 1;
  return true;
}

// A tile block's gather of its tile's segment of every slice of its group
// [s0, s0 + group): seg_lo[s] where the segment starts in its slice's
// region, seg_pre[0 .. group] where it starts in the gather (exclusive
// scan; group + 1 and group ints of shared memory).  Returns the entries in
// all; syncs.
__device__ __forceinline__ int load_segments(const int32_t* __restrict__ offsets, int tiles, int t, int s0,
                                             int group, int32_t* seg_pre, int32_t* seg_lo, int32_t* spare) {
  for (int s = threadIdx.x; s < group; s += blockDim.x) {
    const int32_t* o = offsets + static_cast<long long>(s0 + s) * (tiles + 1) + t;
    seg_lo[s] = o[0];
    seg_pre[s] = o[1] - o[0];
  }
  const int entries = block_scan(seg_pre, group, spare);  // syncs
  if (threadIdx.x == 0) seg_pre[group] = entries;
  __syncthreads();
  return entries;
}

// Apply f(word) to every gathered entry (load_segments) of a tile, slice
// s's region starting at word s * per of `words`.  A warp takes 32 *
// kPerLane consecutive entries, kPerLane a lane: one binary search for the
// first one's segment, then each lane walks on to its own (segments are
// mostly longer than 32) and loads its kPerLane words before f sees any.
// With kAllLanes, f(word, valid) runs on every lane of the warp together,
// so that f may match across the warp: lanes past the end get a zero word
// and valid false.
template <int kPerLane = 4, bool kAllLanes = false, typename Word, typename F>
__device__ __forceinline__ void for_each_entry(const Word* __restrict__ words, int per, int s0, int group,
                                               const int32_t* seg_pre, const int32_t* seg_lo, int entries,
                                               F&& f) {
  const int lane = threadIdx.x & 31;
  for (int first = (threadIdx.x - lane) * kPerLane; first < entries; first += blockDim.x * kPerLane) {
    int a = 0, c = group;  // the segment with seg_pre[a] <= first < seg_pre[a + 1]
    while (c - a > 1) {
      const int mid = (a + c) >> 1;
      if (seg_pre[mid] <= first) a = mid;
      else c = mid;
    }
    Word x[kPerLane];
    if constexpr (kAllLanes) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) x[k] = 0;
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int e = first + lane + 32 * k;
      if (e >= entries) break;
      while (seg_pre[a + 1] <= e) ++a;
      x[k] = words[static_cast<long long>(s0 + a) * per + seg_lo[a] + e - seg_pre[a]];
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const bool valid = first + lane + 32 * k < entries;
      if constexpr (kAllLanes) {
        f(x[k], valid);
      } else {
        if (!valid) break;
        f(x[k]);
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// Let `kernel` launch with `bytes` of dynamic shared memory on the current
// device.  Past 48 KiB that needs the kernel's limit raised, which the card
// keeps per kernel and device; `allowed` (the caller's record of that limit,
// an entry a device, for this kernel alone: a record shared by two kernels
// would skip a raise one of them needs) skips the call where the limit is
// already high enough, so a launcher does not pay it on every launch.  A
// size the card does not have is refused here, and the launcher returns
// that error.
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, long long bytes, int (&allowed)[kMaxDevices]) {
  if (bytes < 0 || bytes > INT_MAX) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool kept = device >= 0 && device < kMaxDevices;
  if (kept && allowed[device] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess && kept) allowed[device] = static_cast<int>(bytes);
  return err;
}

inline int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

}  // namespace repro

// Every library exports this beside its launchers, so a wrapper can name
// the error a launcher returned.
extern "C" const char* repro_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}
