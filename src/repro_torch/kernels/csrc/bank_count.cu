// bank_count: the exact per-row counters of a keyed tick.
//
// One read of the keys, then the new (B, 2) int64 (hi, lo) limbs written,
// with nothing read back to the host.  Three launches: a memset of a
// (rows,) uint64 scratch, the count, and the limb add.
//
//   count   shared path (rows <= bank_count.py's SHARED_ROWS): a block per
//           slice of the keys (16-byte loads, common.cuh's for_each_quad)
//           counts them into a shared uint32 histogram of `rows` bins with
//           plain shared atomics, then adds its non-zero bins into the
//           scratch with 64-bit atomics.  Plain shared atomics beat
//           aggregating a warp's equal keys first (__match_any_sync) on a
//           Zipf hot row (PERF.md).
//           global path (more rows than a block's shared memory holds with
//           room for several blocks an SM): a block tallies its keys in a
//           shared table of kSlots (key, uint32 count) slots, open
//           addressing from a multiplicative hash, kProbes probes; a key
//           whose probes find neither it nor a free slot adds 1 straight
//           into the scratch.  A hot key appears early in every slice, so
//           it takes a slot while the table is empty and its adds stay in
//           shared memory; cold keys, once the table is full, spread their
//           64-bit atomics over many rows.  The block then adds its slots
//           into the scratch.  Slots are claimed with atomicCAS and never
//           freed, so a key holds at most one slot a block.
//   limbs   a second launch over the rows adds the scratch into the limbs.
//
// Keys outside [0, rows) count nowhere (DESIGN.md §9).  The limb add is
// u64.add's, step for step in 64-bit two's complement: lo = a_lo + c_lo,
// hi = (a_hi + c_hi + (lo >> 32)) & 0xFFFFFFFF, lo &= 0xFFFFFFFF, so the
// result is bit-identical to the plain version and wraps at 2^64.  A bin
// or slot of one block counts at most that block's slice of the keys,
// below 2^32 at any length a card holds.  Bound: 4 B a key read once, and
// 16 B a row read and written.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kQuads = 4;  // 16-byte loads a thread has in flight
// The global path's table (bank_count.py's TALLY_SLOTS, TALLY_PROBES,
// TALLY_HASH): 8192 slots of an int32 key and a uint32 count, 64 KiB.
constexpr int kSlotBits = 13;
constexpr int kSlots = 1 << kSlotBits;
constexpr int kProbes = 4;
constexpr unsigned kHash = 0x9E3779B1u;
constexpr int kFree = -1;  // no valid key is negative

// The shared path: block b counts keys [b * per, min(n, (b + 1) * per)).
__global__ void __launch_bounds__(kThreads)
row_count_shared_kernel(const int32_t* __restrict__ keys, long long n, int rows, long long per, bool vec,
                        unsigned long long* __restrict__ counts) {
  extern __shared__ uint32_t bins[];  // rows
  for (int r = threadIdx.x; r < rows; r += blockDim.x) bins[r] = 0;
  __syncthreads();
  const long long lo = per * blockIdx.x;
  const long long hi = lo + per < n ? lo + per : n;
  const int32_t* src[1] = {keys};
  const int32_t none[1] = {-1};
  repro::for_each_quad<1, kQuads>(src, none, 1, lo, hi, vec, [&](int key) {
    if (static_cast<unsigned>(key) < static_cast<unsigned>(rows)) atomicAdd(bins + key, 1u);
  });
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    if (bins[r]) atomicAdd(counts + r, static_cast<unsigned long long>(bins[r]));
}

// The global path: block b tallies keys [b * per, min(n, (b + 1) * per))
// in its table (see the top), the keys it cannot place straight into counts.
__global__ void __launch_bounds__(kThreads)
row_count_global_kernel(const int32_t* __restrict__ keys, long long n, int rows, long long per, bool vec,
                        unsigned long long* __restrict__ counts) {
  extern __shared__ int32_t table[];  // kSlots keys, then kSlots counts
  int32_t* slot_key = table;
  uint32_t* slot_count = reinterpret_cast<uint32_t*>(table + kSlots);
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x) {
    slot_key[s] = kFree;
    slot_count[s] = 0;
  }
  __syncthreads();
  const long long lo = per * blockIdx.x;
  const long long hi = lo + per < n ? lo + per : n;
  const int32_t* src[1] = {keys};
  const int32_t none[1] = {-1};
  volatile int32_t* seen = slot_key;  // another thread may claim a slot meanwhile
  repro::for_each_quad<1, kQuads>(src, none, 1, lo, hi, vec, [&](int key) {
    if (static_cast<unsigned>(key) >= static_cast<unsigned>(rows)) return;
    unsigned s = (static_cast<unsigned>(key) * kHash) >> (32 - kSlotBits);
    for (int p = 0; p < kProbes; ++p, s = (s + 1) & (kSlots - 1)) {
      int held = seen[s];
      if (held == kFree) {
        held = atomicCAS(slot_key + s, kFree, key);
        if (held == kFree) held = key;
      }
      if (held == key) {
        atomicAdd(slot_count + s, 1u);
        return;
      }
    }
    atomicAdd(counts + key, 1ull);
  });
  __syncthreads();
  for (int s = threadIdx.x; s < kSlots; s += blockDim.x)
    if (slot_count[s]) atomicAdd(counts + slot_key[s], static_cast<unsigned long long>(slot_count[s]));
}

// out[r] = limbs[r] + counts[r], u64.add's steps (see the top).
__global__ void add_limbs_kernel(const long long* __restrict__ limbs, long long* __restrict__ out,
                                 const unsigned long long* __restrict__ counts, int rows) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < rows; r += gridDim.x * blockDim.x) {
    const unsigned long long c = counts[r];
    const unsigned long long a_hi = static_cast<unsigned long long>(limbs[2 * r]);
    const unsigned long long a_lo = static_cast<unsigned long long>(limbs[2 * r + 1]);
    const long long lo = static_cast<long long>(a_lo + (c & 0xFFFFFFFFull));
    const unsigned long long hi = a_hi + (c >> 32) + static_cast<unsigned long long>(lo >> 32);
    out[2 * r] = static_cast<long long>(hi & 0xFFFFFFFFull);
    out[2 * r + 1] = lo & 0xFFFFFFFFll;
  }
}

}  // namespace

// keys: (n,) int32; limbs: the (rows, 2) int64 (hi, lo) counters, read
// only; out: the new counters, uninitialised; scratch: rows uint64, 8-byte
// aligned (zeroed here).  The plan is the wrapper's
// (bank_count.py::count_split, bank_count_path): `blocks` blocks of `per`
// keys (a multiple of 4), the shared path where `shared`.
extern "C" int bank_count_launch(const void* keys, long long n, int rows, long long per, int blocks, int shared,
                                 const void* limbs, void* out, void* scratch, void* stream) {
  if (n <= 0 || rows <= 0 || per <= 0 || per % 4 || blocks <= 0 || per * blocks < n ||
      (reinterpret_cast<uintptr_t>(scratch) & 7u))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* counts = static_cast<unsigned long long*>(scratch);
  auto* k = static_cast<const int32_t*>(keys);
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15u) == 0;
  cudaError_t err = cudaMemsetAsync(scratch, 0, rows * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared) {
    const long long bytes = static_cast<long long>(rows) * sizeof(uint32_t);
    static int allowed[repro::kMaxDevices];
    if ((err = repro::allow_shared(row_count_shared_kernel, bytes, allowed)) != cudaSuccess)
      return static_cast<int>(err);
    row_count_shared_kernel<<<blocks, kThreads, bytes, st>>>(k, n, rows, per, vec, counts);
  } else {
    const long long bytes = 2LL * kSlots * sizeof(int32_t);
    static int allowed[repro::kMaxDevices];
    if ((err = repro::allow_shared(row_count_global_kernel, bytes, allowed)) != cudaSuccess)
      return static_cast<int>(err);
    row_count_global_kernel<<<blocks, kThreads, bytes, st>>>(k, n, rows, per, vec, counts);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const long long wanted = (rows + threads - 1) / threads, cap = 4LL * repro::sm_count();
  add_limbs_kernel<<<static_cast<unsigned>(wanted < cap ? wanted : cap), threads, 0, st>>>(
      static_cast<const long long*>(limbs), static_cast<long long*>(out), counts, rows);
  return static_cast<int>(cudaGetLastError());
}
