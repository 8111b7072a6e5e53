// hash_rank: Murmur3 + split + rank of a flat item stream.
//
// Replaces the TPU kernel repro/kernels/hash_rank.py::hash_rank
// (_hash_rank_kernel).  Elementwise: one item per thread over a grid-stride
// loop, neighbouring threads on neighbouring items so loads and stores
// coalesce; the loop bound masks the ragged tail, so the stream needs no
// padding to the TPU's (rows, 128) tiles.  It moves 4 B in and 8 B out per
// item, and the 64-bit hash costs a few tens of integer instructions per
// item on top.
#include "common.cuh"
#include "murmur3.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void hash_rank_kernel(const uint32_t* __restrict__ items,
                                 int32_t* __restrict__ idx,
                                 int32_t* __restrict__ rank, long long n,
                                 int p, int hash_bits,
                                 unsigned long long seed) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int b, r;
    repro::index_rank(items[i], p, hash_bits, seed, b, r);
    idx[i] = b;
    rank[i] = r;
  }
}

}  // namespace

extern "C" int hash_rank_launch(const void* items, void* idx, void* rank,
                                long long n, int p, int hash_bits,
                                unsigned long long seed, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long wanted = (n + kThreads - 1) / kThreads;
  const long long cap = 16LL * repro::sm_count();
  const int grid = static_cast<int>(wanted < cap ? wanted : cap);
  hash_rank_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(items), static_cast<int32_t*>(idx),
      static_cast<int32_t*>(rank), n, p, hash_bits, seed);
  return static_cast<int>(cudaGetLastError());
}
