// Pieces every kernel library shares: the uint8 register max, the stream
// loader and the shared block scan of the tiled kernels, the dynamic
// shared-memory opt-in, and the plain C error interface the ctypes
// bindings read.
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
// holds 32 ints of shared memory.
__device__ __forceinline__ int block_scan(int32_t* a, int len, int32_t* spare) {
  __syncthreads();
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int lo = min(len, static_cast<int>(threadIdx.x) * per), hi = min(len, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int x = sum;  // inclusive over the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) spare[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? spare[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    spare[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? spare[warp - 1] : 0);
  const int total = spare[warps - 1];
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
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
__device__ __forceinline__ void apply(F& f, const int32_t (&v)[2]) { f(v[0], v[1]); }
template <typename F>
__device__ __forceinline__ void apply(F& f, const int32_t (&v)[3]) { f(v[0], v[1], v[2]); }
}  // namespace detail

// Apply f(src[0][i], .., src[K - 1][i]) to every i of [lo, hi) (lo a
// multiple of 4) of K int32 arrays, of which only the first `loaded` are
// read: the others, and every array past the end, give none[k].  The whole
// block takes the same number of turns, so a warp's lanes stay together
// for a warp match in f.  Where every array is 16-byte aligned (vec) a
// thread loads two quads of each at once, so eight items are in flight: a
// pass that waits on one 4-byte load a turn is latency-bound.
template <int K, typename F>
__device__ __forceinline__ void for_each_quad(const int32_t* const* src, const int32_t* none, int loaded,
                                              long long lo, long long hi, bool vec, F&& f) {
  long long tail = lo;
  if (vec) {
    const long long q_lo = lo / 4, q_hi = hi / 4;
    for (long long q0 = q_lo; q0 < q_hi; q0 += 2 * blockDim.x) {
      int4 x[2][K];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long q = q0 + threadIdx.x + h * blockDim.x;
#pragma unroll
        for (int k = 0; k < K; ++k)
          x[h][k] = k < loaded && q < q_hi ? __ldg(reinterpret_cast<const int4*>(src[k]) + q)
                                          : make_int4(none[k], none[k], none[k], none[k]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
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
