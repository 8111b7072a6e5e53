// cm_scatter: count-min ingest and count-min ring fold on the card.
//
// Replaces two TPU kernels of repro/kernels/cm_scatter.py:
//   cm_scatter_add       (_cm_kernel) the keyed scatter-add of a count-min
//                        ingest: item i of key b adds 1 to d counters of
//                        row b, one per depth row r, at column
//                        (h.lo + r * h.hi) mod w of the item's murmur3_64
//                        hash (Kirsch-Mitzenmacher double hashing in uint32);
//   cm_window_fold_sum   (_cm_fold_kernel) the masked sum of the W slices
//                        of a (W, B, d * w) counter ring.
// Counters are uint32 and wrap mod 2^32; the port carries them as int32
// bits, and both kernels add as unsigned, which is the same bits.
//
// The TPU kernel takes a d-expanded (key, cell, hit) stream tiled to
// (rows, 128) and sums it into row blocks of at most 4096 cells held in
// VMEM with a one-hot compare-reduce: the TPU has no read-modify-write
// port.  Hopper has global atomics, so here one thread takes one item
// (grid-stride), hashes it itself (murmur3.cuh, the same h1 as the HLL
// kernels) and lands its d hits with atomicAdd on unsigned int at
// key * d * w + r * w + col.  Any CMConfig (d <= 16, w <= 2^24) works with
// B * d * w < 2^31 (the wrapper checks).  Keys outside [0, B) add nothing
// (the §9 drop rule), checked here.  Bound: 8 B of stream per item, plus
// the counters read and written once (the functional copy); the hits are
// random read-modify-writes that stay in the 50 MB L2 for a 16 MiB bank.
//
// The fold is window_fold.cu's max fold with + in place of max: each
// thread owns 16 bytes (4 counters) of the (B * d * w) plane, walks the W
// slices with one 16-byte load each and skips a slice whose mask byte (read
// on the card) is 0.  Where the plane is not a multiple of 4 counters, the
// slices do not start on 16-byte boundaries, and a scalar kernel of one
// counter per thread runs instead.  Bound: the live slices read once and
// the plane written once, at the HBM rate.
#include "common.cuh"
#include "murmur3.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void cm_scatter_kernel(uint32_t* counters, const int32_t* __restrict__ keys,
                                  const uint32_t* __restrict__ items, long long n,
                                  int rows, int depth, uint32_t width, uint64_t seed) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long cells = static_cast<long long>(depth) * width;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int key = keys[i];
    if (key < 0 || key >= rows) continue;
    const uint64_t h = repro::murmur3_64(items[i], seed);
    const uint32_t lo = static_cast<uint32_t>(h);
    const uint32_t hi = static_cast<uint32_t>(h >> 32);
    uint32_t* row = counters + key * cells;
    for (int r = 0; r < depth; ++r) {
      const uint32_t col = (lo + static_cast<uint32_t>(r) * hi) % width;
      atomicAdd(row + static_cast<long long>(r) * width + col, 1u);
    }
  }
}

__global__ void cm_fold_vec_kernel(const uint4* __restrict__ ring,
                                   const uint8_t* __restrict__ mask, int window,
                                   long long vectors, uint4* __restrict__ out) {
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= vectors) return;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int w = 0; w < window; ++w) {
    if (mask[w] == 0) continue;
    const uint4 x = ring[static_cast<long long>(w) * vectors + v];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  out[v] = acc;
}

__global__ void cm_fold_scalar_kernel(const uint32_t* __restrict__ ring,
                                      const uint8_t* __restrict__ mask, int window,
                                      long long plane, uint32_t* __restrict__ out) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= plane) return;
  uint32_t acc = 0u;
  for (int w = 0; w < window; ++w) {
    if (mask[w] == 0) continue;
    acc += ring[static_cast<long long>(w) * plane + c];
  }
  out[c] = acc;
}

}  // namespace

// cm_scatter_add: counters is the (B, d, w) bank to add into, in place
// (the wrapper passes a copy); keys int32 and items uint32 bits, n of each.
extern "C" int cm_scatter_launch(void* counters, const void* keys, const void* items,
                                 long long n, int rows, int depth, int width,
                                 unsigned long long seed, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const long long wanted = (n + kThreads - 1) / kThreads;
  const long long cap = 16LL * repro::sm_count();
  const int grid = static_cast<int>(wanted < cap ? wanted : cap);
  cm_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(counters), static_cast<const int32_t*>(keys),
      static_cast<const uint32_t*>(items), n, rows, depth,
      static_cast<uint32_t>(width), static_cast<uint64_t>(seed));
  return static_cast<int>(cudaGetLastError());
}

// cm_window_fold_sum: ring is (W, plane) counters, mask a (W,) bool/uint8
// tensor on the card, out the (plane,) sum.  The vector kernel needs plane
// % 4 == 0 and 16-byte aligned pointers; the wrapper aligns the pointers.
extern "C" int cm_fold_launch(const void* ring, const void* mask, int window,
                              long long plane, void* out, void* stream) {
  if (plane <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (plane % 4 == 0) {
    const long long vectors = plane / 4;
    const long long grid = (vectors + kThreads - 1) / kThreads;
    cm_fold_vec_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const uint4*>(ring), m, window, vectors, static_cast<uint4*>(out));
  } else {
    const long long grid = (plane + kThreads - 1) / kThreads;
    cm_fold_scalar_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(ring), m, window, plane, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
