// sparse_scatter: dedup of a (row, bucket, rank) triple stream into
// zero-initialised (rows, m) int32 max-rank cells, plus the (rows,) int32
// count of distinct buckets per row.
//
// Replaces the TPU kernel repro/kernels/sparse_scatter.py::sparse_scatter_coo
// (_sparse_kernel), the scatter phase of HybridBank compaction.  The TPU
// kernel keeps a row block's cells in VMEM and merges by a chunked one-hot
// compare-reduce, which caps a block at 4096 cells (p <= 12); it counts the
// distinct buckets with a popcount over the block at the end.  Hopper has
// native 32-bit atomics, so one thread per triple raises its cell with
// atomicMax, and the thread that sees the old value 0 (the first rank > 0
// to land there) adds one to its row's count: exact first-touch counting in
// the same pass, no popcount, no cap on rows or p.
//
// Entries with a row outside [0, rows), a bucket outside [0, m) or a rank
// <= 0 change nothing (padding and foreign rows).  The wrapper zeroes the
// outputs.  Bound: 12 B of stream read per triple plus the cells written
// once (4 B each, the zeroing pass); the atomics land in L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sparse_scatter_kernel(const int32_t* __restrict__ row,
                                      const int32_t* __restrict__ bucket,
                                      const int32_t* __restrict__ rank,
                                      long long n, int rows, int m,
                                      int32_t* cells, int32_t* distinct) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int r = row[i];
    const int b = bucket[i];
    const int k = rank[i];
    if (r < 0 || r >= rows || b < 0 || b >= m || k <= 0) continue;
    const long long cell = static_cast<long long>(r) * m + b;
    if (atomicMax(cells + cell, k) == 0) atomicAdd(distinct + r, 1);
  }
}

}  // namespace

extern "C" int sparse_scatter_launch(const void* row, const void* bucket,
                                     const void* rank, long long n, int rows,
                                     int m, void* cells, void* distinct,
                                     void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long wanted = (n + kThreads - 1) / kThreads;
  const long long cap = 16LL * repro::sm_count();
  const int grid = static_cast<int>(wanted < cap ? wanted : cap);
  sparse_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row), static_cast<const int32_t*>(bucket),
      static_cast<const int32_t*>(rank), n, rows, m,
      static_cast<int32_t*>(cells), static_cast<int32_t*>(distinct));
  return static_cast<int>(cudaGetLastError());
}
