// hll_fused: hash, rank and register max of a whole stream in one launch.
//
// Replaces the TPU kernel repro/kernels/hll_fused.py::hll_update_fused
// (_fused_kernel).  The TPU kernel has no read-modify-write port, so it
// merges each chunk of items by a one-hot compare-reduce over all m buckets
// and caps p at 12 to keep that O(items * m) work and its VMEM scratch
// small.  Hopper has shared-memory atomics instead, so here:
//
//  * each block keeps a private copy of the m uint8 registers in shared
//    memory (m bytes: 64 KiB at p = 16, which fits a block's 227 KB where
//    m int32 words would not), zeroed at the start;
//  * it grid-strides over its share of the stream, hashes each item and
//    raises the item's register byte with repro::byte_max (a CAS on the
//    containing 32-bit word, since CUDA has no 8-bit atomicMax; a register
//    already >= the rank costs one shared read and no atomic);
//  * at the end it folds its registers into the global ones once, four at
//    a time, with a per-byte max (__vmaxu4) in a CAS loop.
//
// The result is bit-identical whatever order the atomics land in, because
// max is order-free.  Items at positions >= n_valid are never read.  What
// bounds it: the stream is 4 B per item, but the 64-bit hash costs tens of
// integer instructions per item, and Zipf traffic that repeats a bucket
// makes CAS retries on one word (time, not correctness); each block's final
// fold also moves m bytes through L2 atomics.
#include "common.cuh"
#include "murmur3.cuh"

namespace {

constexpr int kThreads = 512;

__global__ void hll_fused_kernel(const uint32_t* __restrict__ items,
                                 long long n_valid, uint32_t* regs, int p,
                                 int hash_bits, unsigned long long seed) {
  extern __shared__ uint32_t local_regs[];  // m uint8 registers, 4 per word
  const int words = (1 << p) >> 2;
  for (int w = threadIdx.x; w < words; w += blockDim.x) local_regs[w] = 0u;
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_valid; i += stride) {
    int b, r;
    repro::index_rank(items[i], p, hash_bits, seed, b, r);
    repro::byte_max(local_regs, static_cast<uint64_t>(b), static_cast<uint32_t>(r));
  }
  __syncthreads();

  // each block starts its fold at its own offset, so blocks that finish
  // together do not all contend for the same global words at once
  const int offset = static_cast<int>(static_cast<long long>(blockIdx.x) * words / gridDim.x);
  for (int j = threadIdx.x; j < words; j += blockDim.x) {
    const int w = j + offset < words ? j + offset : j + offset - words;
    const uint32_t mine = local_regs[w];
    if (mine != 0u) repro::word_max(regs + w, mine);
  }
}

}  // namespace

extern "C" int hll_fused_launch(void* regs, const void* items, long long n_valid,
                                int p, int hash_bits, unsigned long long seed,
                                void* stream) {
  if (n_valid <= 0) return static_cast<int>(cudaSuccess);
  const int smem = 1 << p;  // m bytes
  cudaError_t err = cudaFuncSetAttribute(
      hll_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hll_fused_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  // every block pays an m-byte fold at the end, so a block should see at
  // least a few items per thread before another block is worth starting
  const long long wanted = (n_valid + 8LL * kThreads - 1) / (8LL * kThreads);
  const long long cap = static_cast<long long>(per_sm) * repro::sm_count();
  const int grid = static_cast<int>(wanted < 1 ? 1 : (wanted < cap ? wanted : cap));
  hll_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(items), n_valid, static_cast<uint32_t*>(regs),
      p, hash_bits, seed);
  return static_cast<int>(cudaGetLastError());
}
