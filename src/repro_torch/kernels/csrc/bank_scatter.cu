// bank_scatter: keyed scatter-max of a (key, bucket, rank) stream into a
// (B, m) bank of uint8 registers.
//
// Replaces the TPU kernel repro/kernels/bank_scatter.py::bank_scatter_max
// (_bank_kernel).  The TPU kernel tiles the bank over row blocks held in
// VMEM and merges items by a one-hot compare-reduce over a block's cells,
// which caps row_block * m at 4096 cells.  Hopper has global atomics, so
// each item raises its cell (key * m + bucket) in place, and any B and
// p <= 16 work.
//
// The bank stays uint8 and each update is a CAS on the 32-bit word that
// holds the cell (repro::byte_max): CUDA has no 8-bit atomicMax, and an
// int32 copy of a B = 1024, p = 16 bank would be 256 MiB against the bank's
// own 64 MiB, read and written once more on every call.  Two items collide
// only when they hit the same 4-byte word at the same moment, which is
// rare among 64 Mi cells; a cell already >= the rank costs a read and no
// atomic.  The kernel checks the key range itself, so the §9 drop rule
// (keys outside [0, B) are dropped, never clamped) does not depend on the
// wrapper; buckets outside [0, m) and ranks outside [1, 255] (padding) are
// no-ops too.  Bound: 12 B of stream per item plus one random byte
// read-modify-write in the bank.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void bank_scatter_kernel(uint32_t* bank, const int32_t* __restrict__ keys,
                                    const int32_t* __restrict__ idx,
                                    const int32_t* __restrict__ rank, long long n,
                                    int rows, int m) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int key = keys[i];
    const int bucket = idx[i];
    const int r = rank[i];
    if (key < 0 || key >= rows || bucket < 0 || bucket >= m || r < 1 || r > 255)
      continue;
    const uint64_t cell = static_cast<uint64_t>(key) * static_cast<uint64_t>(m) +
                          static_cast<uint64_t>(bucket);
    repro::byte_max(bank, cell, static_cast<uint32_t>(r));
  }
}

}  // namespace

extern "C" int bank_scatter_launch(void* bank, const void* keys, const void* idx,
                                   const void* rank, long long n, int rows, int m,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long wanted = (n + kThreads - 1) / kThreads;
  const long long cap = 16LL * repro::sm_count();
  const int grid = static_cast<int>(wanted < cap ? wanted : cap);
  bank_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(bank), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(idx), static_cast<const int32_t*>(rank), n, rows,
      m);
  return static_cast<int>(cudaGetLastError());
}
