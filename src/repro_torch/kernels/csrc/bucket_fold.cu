// bucket_fold: element-wise max of k pipeline partials, (k, m) -> (m,).
//
// Replaces the TPU kernel repro/kernels/bucket_fold.py::bucket_fold
// (_fold_kernel), the paper's "Merge buckets" module.  A column reduction:
// each thread owns one column and walks the k rows, so a warp reads 32
// neighbouring columns of one row at a time (coalesced along m).  For the
// uint8 registers a column is one 32-bit word of 4 registers folded with
// the per-byte max __vmaxu4; int32 partials fold one register per thread.
// Bound by memory: k*m register bytes read once, m written once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void bucket_fold_u8_kernel(const uint32_t* __restrict__ partials,
                                      uint32_t* __restrict__ out, int k,
                                      long long words) {
  const long long w = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= words) return;
  uint32_t acc = partials[w];
  for (int j = 1; j < k; ++j) acc = __vmaxu4(acc, partials[j * words + w]);
  out[w] = acc;
}

__global__ void bucket_fold_i32_kernel(const int32_t* __restrict__ partials,
                                       int32_t* __restrict__ out, int k,
                                       long long m) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int32_t acc = partials[i];
  for (int j = 1; j < k; ++j) acc = max(acc, partials[j * m + i]);
  out[i] = acc;
}

}  // namespace

// element_bytes is 1 (uint8, m a multiple of 4) or 4 (int32).
extern "C" int bucket_fold_launch(const void* partials, void* out, int k,
                                  long long m, int element_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long columns = element_bytes == 1 ? m / 4 : m;
  const int grid = static_cast<int>((columns + kThreads - 1) / kThreads);
  if (element_bytes == 1) {
    bucket_fold_u8_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(partials), static_cast<uint32_t*>(out), k,
        columns);
  } else {
    bucket_fold_i32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(partials), static_cast<int32_t*>(out), k,
        columns);
  }
  return static_cast<int>(cudaGetLastError());
}
