// hll_fused: hash, rank and register max of a whole stream.
//
// Replaces the TPU kernel repro/kernels/hll_fused.py::hll_update_fused
// (_fused_kernel).  The TPU kernel has no read-modify-write port, so it
// merges each chunk of items by a one-hot compare-reduce over all m buckets
// and caps p at 12 to keep that O(items * m) work and its VMEM scratch
// small.  Hopper has shared-memory atomics instead, so here, in two passes:
//
//  1. G blocks of 1024 threads, two an SM (the wrapper picks G from n and
//     p: hll_fused.py::hll_partials), each keep a private copy of the m
//     uint8 registers in shared memory (m bytes: 64 KiB at p = 16, which
//     fits a block's 227 KB where m int32 words would not), zeroed at the
//     start.  A thread takes four items a turn with one 16-byte load,
//     hashes all four, then raises each item's register byte by CAS on the
//     containing 32-bit word (CUDA has no 8-bit atomicMax).  The first CAS
//     expects the word all zero, as most words of a fresh file are, so a
//     first hit costs one atomic and no read; it returns the word when not,
//     and the loop goes on from there (on the H100 this is faster than
//     reading the word first, as repro::byte_max does; PERF.md).  At
//     the end the block writes its file to row b of a (G, m) scratch with
//     plain 16-byte stores.
//  2. A column max over the G files and the input registers, written once
//     to `out`: a warp takes 32 16-byte columns (512 registers), the block's
//     warps split the G files between them and meet in shared memory; four
//     registers fold at a time with the per-byte max __vmaxu4.
//
// No global atomic runs: folding each file into the global registers by CAS
// instead costs every word one round trip a block, about 190 of them at
// 2^22 items with three files an SM.
//
// The result is bit-identical whatever order the items land in, because
// max is order-free.  Items at positions >= n_valid are never read.  What
// bounds it: the stream is 4 B per item, but the 64-bit hash costs tens of
// integer instructions per item; the G files (17.3 MB at p = 16 and G =
// 264) are written and read back through the 50 MB L2.
#include "common.cuh"
#include "murmur3.cuh"

namespace {

constexpr int kFileThreads = 1024;
constexpr int kMergeThreads = 512;

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y), __vmaxu4(a.z, b.z), __vmaxu4(a.w, b.w));
}

// 1. block b aggregates its share of items[0 .. n) into files[b] (m bytes).
// `head` items (0..3) come before the first 16-byte boundary of `items`.
__global__ void __launch_bounds__(kFileThreads)
hll_file_kernel(const uint32_t* __restrict__ items, long long n, int head, int p, int hash_bits,
                unsigned long long seed, uint4* __restrict__ files) {
  extern __shared__ uint32_t regs[];  // m uint8 registers, 4 per word
  const int vectors = (1 << p) >> 4;  // 16 registers each
  uint4* regs4 = reinterpret_cast<uint4*>(regs);
  for (int v = threadIdx.x; v < vectors; v += blockDim.x) regs4[v] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // raise register b to r: a CAS that expects the word still all zero, as
  // most words of a fresh file are (one atomic, no read), then the usual
  // loop from the value it returned
  auto raise = [&](int b, int r) {
    uint32_t* word = regs + (b >> 2);
    const uint32_t shift = static_cast<uint32_t>(b & 3) * 8u;
    const uint32_t value = static_cast<uint32_t>(r);
    uint32_t old = atomicCAS(word, 0u, value << shift);
    while (old != 0u && ((old >> shift) & 0xFFu) < value) {
      const uint32_t seen = atomicCAS(word, old, (old & ~(0xFFu << shift)) | (value << shift));
      if (seen == old) break;
      old = seen;
    }
  };
  auto put = [&](uint32_t item) {
    int b, r;
    repro::index_rank(item, p, hash_bits, seed, b, r);
    raise(b, r);
  };
  if (gid < head) put(items[gid]);
  const uint4* body = reinterpret_cast<const uint4*>(items + head);
  const long long quads = (n - head) / 4;
  for (long long q = gid; q < quads; q += stride) {
    const uint4 x = __ldg(body + q);
    int b[4], r[4];
    repro::index_rank(x.x, p, hash_bits, seed, b[0], r[0]);
    repro::index_rank(x.y, p, hash_bits, seed, b[1], r[1]);
    repro::index_rank(x.z, p, hash_bits, seed, b[2], r[2]);
    repro::index_rank(x.w, p, hash_bits, seed, b[3], r[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) raise(b[k], r[k]);
  }
  const long long tail = head + 4 * quads;  // at most 3 items after the last quad
  if (tail + gid < n) put(items[tail + gid]);
  __syncthreads();

  uint4* file = files + static_cast<long long>(blockIdx.x) * vectors;
  for (int v = threadIdx.x; v < vectors; v += blockDim.x) file[v] = regs4[v];
}

// 2. out = the column max of the `count` files and the input registers.
__global__ void __launch_bounds__(kMergeThreads)
hll_merge_kernel(const uint4* __restrict__ files, int count, const uint4* __restrict__ registers,
                 uint4* __restrict__ out, int vectors) {
  __shared__ uint4 part[kMergeThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int v = blockIdx.x * 32 + lane;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  if (v < vectors)
#pragma unroll 4
    for (int f = warp; f < count; f += warps) acc = vmax4(acc, files[static_cast<long long>(f) * vectors + v]);
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && v < vectors) {
    acc = registers[v];
    for (int w = 0; w < warps; ++w) acc = vmax4(acc, part[w][lane]);
    out[v] = acc;
  }
}

}  // namespace

// registers: the (m,) input registers, out: the (m,) result, both 16-byte
// aligned; items: n_valid uint32 items, 4-byte aligned; files: a (count, m)
// uint8 scratch, 16-byte aligned, count >= 1 (one file a block).
extern "C" int hll_fused_launch(void* out, const void* registers, const void* items, long long n_valid,
                                int p, int hash_bits, unsigned long long seed, void* files, int count,
                                void* stream) {
  if (n_valid <= 0 || count < 1 || p < 4 || p > 16 ||
      ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(registers) |
        reinterpret_cast<uintptr_t>(files)) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = 1 << p;  // m bytes
  static int allowed[repro::kMaxDevices];
  cudaError_t err = repro::allow_shared(hll_file_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* x = static_cast<const uint32_t*>(items);
  const long long misaligned = (reinterpret_cast<uintptr_t>(x) & 15u) / 4;  // items past the last boundary
  const long long head_ll = misaligned ? 4 - misaligned : 0;
  const int head = static_cast<int>(head_ll < n_valid ? head_ll : n_valid);
  hll_file_kernel<<<count, kFileThreads, smem, st>>>(x, n_valid, head, p, hash_bits, seed,
                                                     static_cast<uint4*>(files));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int vectors = (1 << p) >> 4;
  hll_merge_kernel<<<(vectors + 31) / 32, kMergeThreads, 0, st>>>(
      static_cast<const uint4*>(files), count, static_cast<const uint4*>(registers), static_cast<uint4*>(out),
      vectors);
  return static_cast<int>(cudaGetLastError());
}
