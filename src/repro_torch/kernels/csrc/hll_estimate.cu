// hll_estimate: the register histogram of a (B, m) uint8 bank and, for the
// "original" estimator, each row's estimate, in one launch.
//
// The reference has no Pallas kernel here: it histograms with jnp.bincount
// (repro/sketch/estimators.py, register_histogram) and finalizes in plain
// JAX (_original_device).  This kernel reads each register once, writes
// either the (B, K) int32 counts or the (B,) float32 estimates, and reads
// nothing back to the host.
//
//   plan      a group of `group` threads reads a row, 16 bytes a load
//             (hll_estimate.py's estimate_plan): one block a row from m =
//             4096 up, several rows a block below it, m = 65536 one block
//             of 512 threads with 8 loads a thread.
//   count     shared atomics into a sub-histogram of K int32 bins for each
//             warp of a row (a row of fewer than 32 threads: one for the
//             row), so that a value's adds meet only its own warp's.
//             Register values crowd a few bins (an empty row all in bin
//             0), and the card resolves a warp's adds to one address
//             together: on an H100 this took 6.0 us for the 1024-row
//             fleet bank's histogram, against 10.7 us for byte counters
//             owned by each thread (a read-modify-write a register, then
//             a warp shuffle reduction) and 18.6 us for __match_any_sync
//             aggregation (PERF.md §6).  Values outside [0, K) count
//             nowhere (DESIGN.md §9).
//   sum       a thread a (row, bin) adds the row's sub-histograms.
//   finalize  ("original") f = min(32, group) lanes a row sum
//             C[k] 2^-k over k = lane (mod f) in float64 (each term
//             exact: 2^-k made from its exponent bits), a butterfly over
//             the f lanes, rounded once to
//             float32; then estimators._original_device's float32 steps
//             one for one: E = float32(alpha m^2) / S, LinearCounting
//             m log(m / V) where E <= 2.5 m and V > 0, and for H = 32 the
//             large-range correction above 2^32 / 30 (+inf from 2^32).
//
// Bound on the H100: the bank read once and the output written once, at
// 3.35 TB/s (4 MiB, 1.25 us, for the 1024-row p = 12 fleet bank); at that
// size the launch and the atomics set the time.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxBins = 62;  // K = H - p + 2
constexpr int kLoads = 2;     // 16-byte loads a thread has in flight (4 took 0.4 us more, in registers)
constexpr float kTwo32 = 4294967296.0f;
// torch compares a float32 tensor with a Python float in float32
constexpr float kLargeFrom = static_cast<float>(4294967296.0 / 30.0);

__device__ __forceinline__ void count(int32_t* sub, int bins, uint32_t v) {
  if (v < static_cast<uint32_t>(bins)) atomicAdd(sub + v, 1);
}

// The "original" estimate from the harmonic sum S and V = C[0] (see the top).
__device__ float original_estimate(float harm, int v, int m, float alpha_m2, int hash_bits) {
  const float e_raw = alpha_m2 / harm;
  const float mf = static_cast<float>(m);
  float out = e_raw;
  if (e_raw <= 2.5f * mf && v > 0) out = mf * logf(mf / static_cast<float>(v));
  if (hash_bits == 32 && e_raw > kLargeFrom)
    out = e_raw >= kTwo32 ? INFINITY : -kTwo32 * log1pf(-(e_raw * (1.0f / kTwo32)));
  return out;
}

// Block b takes rows [b * rows_per_block, ...), a group of `group` threads
// a row; `estimate` writes (B,) float32 estimates, else (B, K) int32 counts.
// 32 registers a thread, so that 8 blocks of 256 threads fit an SM and the
// fleet bank's 1024 rows run in one wave.
__global__ void __launch_bounds__(kMaxThreads, 4)
hll_estimate_kernel(const uint8_t* __restrict__ regs, long long rows, int m, int bins, int group,
                    int rows_per_block, bool estimate, float alpha_m2, int hash_bits, void* __restrict__ out) {
  extern __shared__ int32_t sub[];  // rows_per_block x per_row sub-histograms of bins
  const int threads = blockDim.x, tid = threadIdx.x, r = tid / group, g = tid - r * group;
  const int per_row = group >= 32 ? group >> 5 : 1;
  for (int i = tid; i < rows_per_block * per_row * bins; i += threads) sub[i] = 0;
  __syncthreads();
  int32_t* mine = sub + (r * per_row + (g >> 5)) * bins;
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_block;
  if (first + r < rows) {
    const int per = (m >> 4) / group;  // 16-byte loads a thread, the same for every thread
    const uint4* src = reinterpret_cast<const uint4*>(regs + (first + r) * m);
    for (int h0 = 0; h0 < per; h0 += kLoads) {
      uint4 x[kLoads];
#pragma unroll
      for (int h = 0; h < kLoads; ++h)
        if (h0 + h < per) x[h] = __ldg(src + g + (h0 + h) * group);
#pragma unroll
      for (int h = 0; h < kLoads; ++h)
        if (h0 + h < per) {
          const uint32_t w[4] = {x[h].x, x[h].y, x[h].z, x[h].w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int b = 0; b < 4; ++b) count(mine, bins, (w[c] >> (8 * b)) & 0xFFu);
        }
    }
  }
  __syncthreads();
  // the row's first sub-histogram becomes its counts
  for (int o = tid; o < rows_per_block * bins; o += threads) {
    const int rr = o / bins, k = o - rr * bins;
    if (first + rr >= rows) continue;
    int32_t* c = sub + rr * per_row * bins;
    int total = c[k];
    for (int s = 1; s < per_row; ++s) total += c[s * bins + k];
    if (estimate) c[k] = total;
    else static_cast<int32_t*>(out)[(first + rr) * bins + k] = total;
  }
  if (!estimate) return;
  __syncthreads();
  const int f = min(32, group), rr = tid / f, lane = tid - rr * f;
  if (rr >= rows_per_block) return;  // whole warps: rows_per_block * f is threads or a multiple of 32
  const bool live = first + rr < rows;
  const int32_t* c = sub + rr * per_row * bins;
  double s = 0.0;
  if (live)
    for (int k = lane; k < bins; k += f)
      s += static_cast<double>(c[k]) * __longlong_as_double(static_cast<long long>(1023 - k) << 52);
  for (int off = f >> 1; off >= 1; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (live && lane == 0)
    static_cast<float*>(out)[first + rr] = original_estimate(static_cast<float>(s), c[0], m, alpha_m2, hash_bits);
}

}  // namespace

// regs: (rows, m) uint8, row-major, on a 16-byte boundary (the wrapper
// copies a bank that is not); m a power of two in [16, 65536]; bins = K <=
// 62.  The plan is the wrapper's (hll_estimate.py::estimate_plan):
// `group` threads a row (a power of two dividing m / 16), `rows_per_block`
// rows a block of group * rows_per_block threads.  `estimate`: out is
// (rows,) float32 "original" estimates, with alpha_m2 = float32(alpha m^2)
// and hash_bits H; else (rows, bins) int32.
extern "C" int hll_estimate_launch(const void* regs, long long rows, int m, int bins, int group, int rows_per_block,
                                   int estimate, float alpha_m2, int hash_bits, void* out, void* stream) {
  const int threads = group * rows_per_block;
  const long long blocks = rows > 0 && rows_per_block > 0 ? (rows + rows_per_block - 1) / rows_per_block : 0;
  if (rows <= 0 || m < 16 || m > 65536 || (m & (m - 1)) || bins < 1 || bins > kMaxBins || group < 1 ||
      (group & (group - 1)) || (m >> 4) % group || rows_per_block < 1 || (reinterpret_cast<uintptr_t>(regs) & 15u) ||
      threads > kMaxThreads || threads % 32 || (group < 32 && 32 % group) || blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(int32_t) * static_cast<size_t>(rows_per_block) * (group >= 32 ? group >> 5 : 1) * bins;
  hll_estimate_kernel<<<static_cast<unsigned>(blocks), threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(regs), rows, m, bins, group, rows_per_block, estimate != 0, alpha_m2, hash_bits,
      out);
  return static_cast<int>(cudaGetLastError());
}
