// bank_scatter: keyed scatter-max of a (key, bucket, rank) stream into a
// (B, m) bank of uint8 registers.
//
// Replaces the TPU kernel repro/kernels/bank_scatter.py::bank_scatter_max
// (_bank_kernel).  The TPU kernel tiles the bank over row blocks held in
// VMEM and merges items by a one-hot compare-reduce over a block's cells,
// which caps row_block * m at 4096 cells.  This design keeps what that
// kernel keeps on chip -- a block-resident tile of registers, written once --
// and reaches it by partitioning the stream by tile first, as
// sparse_scatter.cu and cm_scatter.cu do:
//
//   tile plan  the bank is cut into tiles of whole rows, a power of two of
//              them, at most 2^16 register bytes (64 KiB of shared memory):
//              one row at p = 16, 16 at p = 12.  The wrapper computes it
//              (bank_scatter.py::bank_tile_plan) and the stream's split into
//              slices (sparse_scatter.py::stream_split).
//   partition  a block per slice reads its keys and counts the entries of
//              valid keys per tile with shared atomics (on this card faster
//              than a warp-aggregated count by __match_any_sync, even with a
//              hot tile), adds the counts into the per-tile totals, scans
//              them into the slice's tile offsets, reads the slice's keys,
//              buckets and ranks and sorts it by tile into shared memory,
//              each entry packed in 32 bits as (cell in tile << 8 | rank) --
//              0, a no-op, where its bucket or rank drops it -- then writes
//              the sorted slice to its own region, coalesced.
//   plan       one block turns the per-tile totals into work units (as
//              cm_scatter.cu): ceil(total / unit_items), at least one, at
//              most one a slice, each over a group of slices; and lists the
//              split tiles, those with more than one unit.
//   tiles      a block per unit, in one launch, gathers its tile's segment
//              of each slice of its group and lands the entries with a
//              shared byte max (read first, CAS the 32-bit word only when
//              raising: repro::byte_max).  Every tile's first unit starts
//              from the tile of the input registers, copied into shared
//              memory with 16-byte cp.async copies in flight while it
//              gathers the segments, and stores the whole tile to `out`
//              with 16-byte stores -- the only write of a tile that is not
//              split, so the wrapper allocates `out` with torch.empty and no
//              bank copy runs.  The extra units of a hot tile (Zipf keys:
//              key 0 takes ~18 % of a tick) start from zero and store their
//              partial tiles to scratch; they come first in the launch, so
//              that their gathers overlap the first units' streaming.
//   fold       every split tile's `out` raised to the max of its partials
//              (__vmaxu4), 64 16-byte columns a work item.  Raising `out`
//              in place from the extra units instead, by a read and a CAS a
//              word, measured slower on the card: those reads of the hot
//              tile from every SM at once were the cost (PERF.md).
// Max is idempotent and order-free, so the result is bit-identical to the
// plain version; the input registers are never written.
//
// The global path (the previous design, taken where the wrapper's
// bank_scatter_path says so: a plan or stream past the tiled limits, or a
// shape where it measured faster): one thread per entry raises its cell of
// a copy of the bank in place with a byte CAS on the containing 32-bit word.
//
// Drop rule (DESIGN.md §9), checked by the kernels themselves: keys outside
// [0, B), buckets outside [0, m) and ranks outside [1, 255] change nothing
// -- never clamped into a neighbouring row.  Bound: 12 B of stream per entry
// plus the bank read and written once; the tiled path also reads the keys a
// second time, writes and reads 4 B an entry of a valid key, and writes and
// reads the extra units' partial tiles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // the global path
constexpr int kTileThreads = 512;   // the partition and tile passes
constexpr int kTileBytes = 1 << 16; // register bytes a tile holds
constexpr int kRankBits = 8;        // packed entry: cell in tile << 8 | rank
// loads in flight a thread: 4 quads of each array in the partition, 8
// packed entries in the gather (each measured ~2 us faster a call than
// common.cuh's 2 and 4 at the bank tick)
constexpr int kQuads = 4;
constexpr int kPerLane = 8;

struct BankPlan {
  int rows, m;
  int tile_shift;  // a tile holds 2^tile_shift whole rows
  int tiles;
};

__device__ __forceinline__ bool valid(const BankPlan& p, int key, int bucket, int r) {
  return key >= 0 && key < p.rows && bucket >= 0 && bucket < p.m && r >= 1 && r <= 255;
}

// 16-byte copy global -> shared that does not wait for the data
// (cp.async.cg: cached in L2 only); cp_async_wait_all waits for this
// thread's copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y), __vmaxu4(a.z, b.z), __vmaxu4(a.w, b.w));
}

// The global path: one thread per entry raises its cell of the bank copy it
// is given.
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

// 1. partition: slice s = [s * per, (s + 1) * per) of the stream, sorted by
// tile into its region of `packed` (per words from s * per);
// offsets[s][0 .. tiles] its exclusive tile offsets; tile_total[t] += its
// entries on tile t.
__global__ void __launch_bounds__(kTileThreads)
bank_partition_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ rank, long long n, int per, bool vec, BankPlan p,
                      int32_t* __restrict__ offsets, int32_t* __restrict__ tile_total,
                      uint32_t* __restrict__ packed) {
  extern __shared__ int32_t sh[];
  int32_t* cursor = sh;                                                    // tiles + 1
  uint32_t* stage = reinterpret_cast<uint32_t*>(sh + ((p.tiles + 4) & ~3));  // per
  __shared__ int32_t spare[32];
  const long long lo = static_cast<long long>(per) * blockIdx.x;
  const long long hi = lo + per < n ? lo + per : n;
  for (int i = threadIdx.x; i <= p.tiles; i += blockDim.x) cursor[i] = 0;
  __syncthreads();
  // the first pass reads the keys alone: an entry of a valid key keeps its
  // slot even where its bucket or rank drops it, as a no-op entry
  const int32_t* src[3] = {keys, idx, rank};
  const int32_t none[3] = {-1, 0, 0};
  repro::for_each_quad<3, kQuads>(src, none, 1, lo, hi, vec, [&](int key, int, int) {
    if (key >= 0 && key < p.rows) atomicAdd(cursor + (key >> p.tile_shift), 1);
  });
  __syncthreads();
  for (int t = threadIdx.x; t < p.tiles; t += blockDim.x)
    if (cursor[t]) atomicAdd(tile_total + t, cursor[t]);
  const int total = repro::block_scan(cursor, p.tiles + 1, spare);  // syncs
  int32_t* mine = offsets + static_cast<long long>(blockIdx.x) * (p.tiles + 1);
  for (int t = threadIdx.x; t <= p.tiles; t += blockDim.x) mine[t] = cursor[t];
  __syncthreads();
  const int row_mask = (1 << p.tile_shift) - 1;
  repro::for_each_quad<3, kQuads>(src, none, 3, lo, hi, vec, [&](int key, int b, int r) {
    if (key < 0 || key >= p.rows) return;
    const int at = atomicAdd(cursor + (key >> p.tile_shift), 1);
    // a no-op entry raises the tile's first byte to 0
    stage[at] = valid(p, key, b, r)
                    ? static_cast<uint32_t>((key & row_mask) * p.m + b) << kRankBits | static_cast<uint32_t>(r)
                    : 0u;
  });
  __syncthreads();
  uint32_t* region = packed + static_cast<long long>(per) * blockIdx.x;
  for (int i = threadIdx.x; i < total; i += blockDim.x) region[i] = stage[i];
}

// 2. plan, one block: extra_start as common.cuh's plan_extra_units makes
// it, then the split tiles (those with extra units) listed in order:
// split[0 .. splits) and splits in split[tiles].
__global__ void __launch_bounds__(1024)
bank_plan_kernel(const int32_t* __restrict__ tile_total, int tiles, int slices, int unit_items,
                 int32_t* __restrict__ extra_start, int32_t* __restrict__ split) {
  extern __shared__ int32_t extra[];  // 2 * (tiles + 1)
  int32_t* index = extra + tiles + 1;
  __shared__ int32_t spare[32];
  repro::plan_extra_units(tile_total, tiles, slices, unit_items, extra_start, extra, spare);  // syncs
  for (int t = threadIdx.x; t <= tiles; t += blockDim.x) index[t] = t < tiles && extra[t + 1] > extra[t];
  const int splits = repro::block_scan(index, tiles + 1, spare);  // syncs
  for (int t = threadIdx.x; t < tiles; t += blockDim.x)
    if (extra[t + 1] > extra[t]) split[index[t]] = t;
  if (threadIdx.x == 0) split[tiles] = splits;
}

// 3. one block per unit, one launch: block b < extra_blocks is the b-th
// extra unit (common.cuh's extra_unit), which starts from zero and stores
// its partial tile to partials[b]; block extra_blocks + t is unit 0 of tile
// t, which starts from the tile's registers and stores the tile to `out`.
// The extra units come first, so that a hot tile's units, which wait on
// their gathers, start while the first units stream the bank.
__global__ void __launch_bounds__(kTileThreads)
bank_tile_kernel(const uint8_t* __restrict__ registers, uint8_t* __restrict__ out, BankPlan p, int slices,
                 int per, int unit_items, int extra_blocks, const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ tile_total, const int32_t* __restrict__ extra_start,
                 const uint32_t* __restrict__ packed, uint4* __restrict__ partials) {
  extern __shared__ uint4 tile4[];  // kTileBytes at most
  uint32_t* tile = reinterpret_cast<uint32_t*>(tile4);
  int32_t* seg_pre = reinterpret_cast<int32_t*>(tile4 + (kTileBytes >> 4));  // group + 1
  int32_t* seg_lo = seg_pre + slices + 1;                                      // group
  __shared__ int32_t spare[32];
  const bool extra = static_cast<int>(blockIdx.x) < extra_blocks;
  int t, j;
  if (!extra) {
    t = blockIdx.x - extra_blocks;
    j = 0;
  } else if (!repro::extra_unit(extra_start, p.tiles, blockIdx.x, &t, &j)) {
    return;
  }
  const int units = repro::unit_count(tile_total[t], slices, unit_items);
  const int s0 = static_cast<int>(static_cast<long long>(j) * slices / units);
  const int group = static_cast<int>(static_cast<long long>(j + 1) * slices / units) - s0;
  const int first_row = t << p.tile_shift;
  const int vectors = (min(1 << p.tile_shift, p.rows - first_row) * p.m) >> 4;  // m % 16 == 0
  const long long base = static_cast<long long>(first_row) * p.m;
  if (!extra) {
    // the tile's registers, all in flight while the segments are gathered
    const uint4* src = reinterpret_cast<const uint4*>(registers + base);
    for (int i = threadIdx.x; i < vectors; i += blockDim.x) cp_async16(tile4 + i, src + i);
  } else {
    for (int i = threadIdx.x; i < vectors; i += blockDim.x) tile4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  const int entries = repro::load_segments(offsets, p.tiles, t, s0, group, seg_pre, seg_lo, spare);  // syncs
  if (!extra) {
    cp_async_wait_all();
    __syncthreads();
  }
  repro::for_each_entry<kPerLane>(packed, per, s0, group, seg_pre, seg_lo, entries, [&](uint32_t x) {
    repro::byte_max(tile, x >> kRankBits, x & ((1u << kRankBits) - 1u));
  });
  __syncthreads();
  uint4* dst = extra ? partials + static_cast<long long>(blockIdx.x) * (kTileBytes >> 4)
                     : reinterpret_cast<uint4*>(out + base);
  for (int i = threadIdx.x; i < vectors; i += blockDim.x) dst[i] = tile4[i];
}

// 4. fold: `out` of every split tile raised to the max of its extra units'
// partials (__vmaxu4 a word).  A work item is kColumns 16-byte columns of
// one split tile; a block of kFoldThreads takes one at a time (grid-stride),
// kGroups threads a column, each over every kGroups-th partial with
// kInFlight loads in flight, met in shared memory.
constexpr int kFoldThreads = 256;

__global__ void __launch_bounds__(kFoldThreads)
bank_fold_kernel(uint8_t* __restrict__ out, BankPlan p, const int32_t* __restrict__ extra_start,
                 const int32_t* __restrict__ split, const uint4* __restrict__ partials) {
  constexpr int kColumns = 64, kGroups = kFoldThreads / kColumns, kInFlight = 8;
  constexpr int kChunks = (kTileBytes >> 4) / kColumns;  // work items a tile
  __shared__ uint4 part[kGroups][kColumns];
  const int c = threadIdx.x % kColumns, g = threadIdx.x / kColumns;
  const int items = split[p.tiles] * kChunks;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int t = split[w / kChunks];
    const int v = (w % kChunks) * kColumns + c;  // the column, in 16-byte vectors of the tile
    const int first_row = t << p.tile_shift;
    const int vectors = (min(1 << p.tile_shift, p.rows - first_row) * p.m) >> 4;
    const int e0 = extra_start[t], extras = extra_start[t + 1] - e0;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    if (v < vectors) {
      for (int u0 = g; u0 < extras; u0 += kGroups * kInFlight) {
        uint4 x[kInFlight];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          const int u = u0 + k * kGroups;
          x[k] = u < extras ? partials[static_cast<long long>(e0 + u) * (kTileBytes >> 4) + v]
                            : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) acc = vmax4(acc, x[k]);
      }
    }
    part[g][c] = acc;
    __syncthreads();
    if (g == 0 && v < vectors) {
      uint4* dst = reinterpret_cast<uint4*>(out + static_cast<long long>(first_row) * p.m) + v;
      acc = *dst;
      for (int h = 0; h < kGroups; ++h) acc = vmax4(acc, part[h][c]);
      *dst = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// The global path: bank is the (B, m) uint8 bank to raise in place (the
// wrapper passes a copy), 4-byte aligned; keys, idx, rank (n,) int32.
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

// The tiled path.  registers: the (B, m) bank, read only; out: the result,
// uninitialised; both 16-byte aligned, m a multiple of 16.  keys, idx, rank:
// (n,) int32.  The plan and its limits are the wrapper's
// (bank_scatter.py::bank_tile_plan, bank_scatter_path): tiles of
// rows_per_tile whole rows (a power of two, at most 2^16 bytes); slices of
// per entries; unit_items entries a unit; sms the card's SMs.  This checks that they are
// consistent, and the card refuses shared sizes it does not have.  scratch:
// scratch_words int32 words, 16-byte aligned, in one allocation: offsets
// (slices * (tiles + 1)), tile_total (tiles, zeroed here), extra_start
// (tiles + 1), split (tiles + 1), then from a 16-byte boundary the packed
// entries (per * slices), then from a 16-byte boundary the partial tiles
// of the extra units, 2^16 bytes each, n / unit_items of them (a tile of T
// entries has ceil(T / unit_items) - 1 <= T / unit_items extra units).
extern "C" int bank_scatter_tiled_launch(const void* registers, void* out, const void* keys, const void* idx,
                                         const void* rank, long long n, int rows, int m, int rows_per_tile,
                                         int tiles, int per, int slices, int unit_items, int sms,
                                         void* scratch, long long scratch_words, void* stream) {
  if (n <= 0 || rows <= 0 || m <= 0 || m % 16 || tiles <= 0 || rows_per_tile < 1 ||
      (rows_per_tile & (rows_per_tile - 1)) || static_cast<long long>(rows_per_tile) * m > kTileBytes ||
      static_cast<long long>(tiles) * rows_per_tile < rows ||
      static_cast<long long>(tiles - 1) * rows_per_tile >= rows || per <= 0 || slices <= 0 ||
      static_cast<long long>(per) * slices < n || unit_items < 1 || n / unit_items > INT_MAX - tiles || sms < 1 ||
      ((reinterpret_cast<uintptr_t>(registers) | reinterpret_cast<uintptr_t>(out) |
        reinterpret_cast<uintptr_t>(scratch)) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  const int extra_blocks = static_cast<int>(n / unit_items);
  const long long head = static_cast<long long>(slices) * (tiles + 1) + 3LL * tiles + 2;
  const long long packed_at = (head + 3) / 4 * 4;
  const long long partials_at = (packed_at + static_cast<long long>(per) * slices + 3) / 4 * 4;
  if (partials_at + static_cast<long long>(extra_blocks) * (kTileBytes / 4) > scratch_words)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int tile_shift = 0;
  while ((1 << tile_shift) < rows_per_tile) ++tile_shift;
  const BankPlan p{rows, m, tile_shift, tiles};
  constexpr long long kWord = sizeof(int32_t);
  const long long part_bytes = ((tiles + 4LL) / 4 * 4 + per) * kWord;
  const long long plan_bytes = 2 * (tiles + 1LL) * kWord;
  const long long tile_bytes = kTileBytes + (2LL * slices + 1) * kWord;
  // what each kernel was allowed, per device: one record a kernel
  static int allowed_partition[repro::kMaxDevices], allowed_plan[repro::kMaxDevices],
      allowed_tile[repro::kMaxDevices];
  cudaError_t err;
  if ((err = repro::allow_shared(bank_partition_kernel, part_bytes, allowed_partition)) != cudaSuccess ||
      (err = repro::allow_shared(bank_plan_kernel, plan_bytes, allowed_plan)) != cudaSuccess ||
      (err = repro::allow_shared(bank_tile_kernel, tile_bytes, allowed_tile)) != cudaSuccess)
    return static_cast<int>(err);
  auto* o = static_cast<int32_t*>(scratch);
  auto* tt = o + static_cast<long long>(slices) * (tiles + 1);
  auto* es = tt + tiles;
  auto* split = es + tiles + 1;
  auto* pk = reinterpret_cast<uint32_t*>(o + packed_at);
  auto* partials = reinterpret_cast<uint4*>(o + partials_at);
  if ((err = cudaMemsetAsync(tt, 0, tiles * sizeof(int32_t), st)) != cudaSuccess) return static_cast<int>(err);
  const bool vec = ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(idx) |
                     reinterpret_cast<uintptr_t>(rank)) & 15u) == 0;
  bank_partition_kernel<<<slices, kTileThreads, part_bytes, st>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(idx), static_cast<const int32_t*>(rank), n,
      per, vec, p, o, tt, pk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bank_plan_kernel<<<1, 1024, plan_bytes, st>>>(tt, tiles, slices, unit_items, es, split);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  auto* dst = static_cast<uint8_t*>(out);
  bank_tile_kernel<<<extra_blocks + tiles, kTileThreads, tile_bytes, st>>>(
      static_cast<const uint8_t*>(registers), dst, p, slices, per, unit_items, extra_blocks, o, tt, es, pk,
      partials);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (extra_blocks > 0) {
    // work items: 64 a split tile, at most one split tile an extra unit
    const long long items = 64LL * extra_blocks, cap = 8LL * sms;
    bank_fold_kernel<<<static_cast<unsigned>(items < cap ? items : cap), kFoldThreads, 0, st>>>(dst, p, es, split,
                                                                                            partials);
  }
  return static_cast<int>(cudaGetLastError());
}
