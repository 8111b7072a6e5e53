// bucket_fold: element-wise max of k pipeline partials, (k, m) -> (m,).
//
// Replaces the TPU kernel repro/kernels/bucket_fold.py::bucket_fold
// (_fold_kernel), the paper's "Merge buckets" module.  A column reduction:
// each thread owns one column of 16 bytes (a uint4: 16 uint8 registers or 4
// int32 partials) where every row starts on a 16-byte boundary (m bytes a
// multiple of 16, pointers aligned), else of 4 bytes (a word: 4 uint8
// registers or one int32), and walks the k rows; a warp reads neighbouring
// columns of one row (coalesced along m).  It issues the loads of 8 rows at
// once before it folds them (all k rows where k <= 8), so a thread waits on
// memory once per 8 rows, not once a row.  uint8 registers fold four to a
// word with the per-byte max __vmaxu4, int32 partials with max.
//
// Bound by memory: k*m register bytes read once, m written once -- at the
// main path's (8, 65536) uint8, 0.18 us at 3.35 TB/s, far under the time
// of a launch.  So the design's other aim is the launch itself: blocks of
// at most 256 threads, few enough that the grid spreads over every SM (a
// warp a block where the columns are few: 128 blocks at (8, 65536)).
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRowsInFlight = 8;

__device__ __forceinline__ uint32_t fold_word(uint32_t a, uint32_t b, bool bytes) {
  return bytes ? __vmaxu4(a, b)
               : static_cast<uint32_t>(max(static_cast<int32_t>(a), static_cast<int32_t>(b)));
}

__device__ __forceinline__ uint4 fold_word(uint4 a, uint4 b, bool bytes) {
  return make_uint4(fold_word(a.x, b.x, bytes), fold_word(a.y, b.y, bytes), fold_word(a.z, b.z, bytes),
                    fold_word(a.w, b.w, bytes));
}

// V: uint4 or uint32_t; `columns` V-columns a row, `bytes`: uint8 registers
// (else int32 partials).
template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
bucket_fold_kernel(const V* __restrict__ partials, V* __restrict__ out, int k, long long columns, bool bytes) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= columns) return;
  V acc = partials[c];
  for (int j0 = 1; j0 < k; j0 += kRowsInFlight) {
    V x[kRowsInFlight];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (j0 + j < k) x[j] = __ldg(partials + static_cast<long long>(j0 + j) * columns + c);
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (j0 + j < k) acc = fold_word(acc, x[j], bytes);
  }
  out[c] = acc;
}

}  // namespace

// partials: (k, m) elements of element_bytes each (1: uint8, m a multiple
// of 4; 4: int32); out: (m,).  sms: the card's SMs (the grid's spread).
extern "C" int bucket_fold_launch(const void* partials, void* out, int k, long long m, int element_bytes,
                                  int sms, void* stream) {
  if (k < 1 || m < 1 || (element_bytes != 1 && element_bytes != 4) || m * element_bytes % 4 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long row_bytes = m * element_bytes;
  const bool wide = row_bytes % 16 == 0 &&
                    ((reinterpret_cast<uintptr_t>(partials) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const long long columns = row_bytes / (wide ? 16 : 4);
  // the fewest threads a block (a multiple of 32, at most 256) that leave
  // no SM without a block
  long long threads = (columns + sms - 1) / sms;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : (threads + 31) / 32 * 32);
  const long long grid = (columns + threads - 1) / threads;
  const bool bytes = element_bytes == 1;
  if (wide) {
    bucket_fold_kernel<uint4><<<static_cast<unsigned>(grid), static_cast<unsigned>(threads), 0, s>>>(
        static_cast<const uint4*>(partials), static_cast<uint4*>(out), k, columns, bytes);
  } else {
    bucket_fold_kernel<uint32_t><<<static_cast<unsigned>(grid), static_cast<unsigned>(threads), 0, s>>>(
        static_cast<const uint32_t*>(partials), static_cast<uint32_t*>(out), k, columns, bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
