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
// port.  On Hopper the hits could land as global atomics, but count-min
// traffic is skewed: with Zipf keys and Zipf items a few counters take a
// large share of all hits (about 120 K adds on each of one pair's four
// counters at 2^22 items into 1024 x 4 x 1024), and the L2 serialises adds
// to one address.  So the hot counters are kept on chip, the way
// sparse_scatter.cu keeps its cells:
//
//   tile plan  the bank is cut into tiles of whole (d, w) rows, the most
//              that fit 2^14 counters (64 KB of shared memory) rounded down
//              to a power of two, so that a key's tile is a shift: 4 rows
//              at CMConfig(4, 1024), 256 tiles at B = 1024.  The wrapper
//              computes it (cm_scatter.py::cm_tile_plan) and the stream's
//              split into slices (sparse_scatter.py::stream_split).
//   partition  a block per slice of the stream counts its valid items per
//              tile in shared memory (warp-aggregated: the lanes on one
//              tile, found with __match_any_sync, add once), adds the counts into the per-tile totals, scans
//              them into the slice's tile offsets (a (slices, tiles + 1)
//              matrix), re-reads the slice, hashes each item and sorts it
//              by tile into shared memory, then writes the sorted slice to
//              its own region of the scratch, coalesced.  An item is stored
//              as (row in tile, h.hi mod w, h.lo mod w) in 32 bits where w
//              is a power of two (the column (lo + r * hi) mod w needs only
//              the low log2(w) bits of each), else as (row in tile, item)
//              in 64 bits, hashed again by the tile pass.
//   plan       one block turns the per-tile totals into work units: a tile
//              gets ceil(total / unit_items) units (at least 1, at most one
//              a slice), each over a contiguous group of slices, and the
//              exclusive scan of the units past the first places the split
//              tiles' extra units.
//   tiles      a block per unit gathers its tile's segment of each slice of
//              its group and lands the d hits of every item with shared
//              atomicAdd on unsigned.  Every tile's first unit starts from
//              the tile's counters and writes every counter of the tile to
//              `out` with coalesced stores -- the only write of the tiles
//              that are not split, so the wrapper allocates `out` with
//              torch.empty and the bank copy folds into this pass.  The
//              extra units of a split tile start from zero and add their
//              nonzero partials to `out` with global atomicAdd, in a second
//              launch of the same kernel: the stream orders it after the
//              first, so every counter is initialised once before any
//              partial lands on it.
// Adds mod 2^32 do not depend on order, so the result is bit-identical to
// the plain version in any order.
//
// A row larger than a tile (d * w > 2^14), a plan of more tiles than a
// shared histogram holds (2^14), or a stream of more slices than a tile
// block gathers from (4096) takes the global path (the wrapper's
// cm_scatter_path holds these limits), the previous design: one
// thread per item (grid-stride) hashes it and lands its d hits with global
// atomicAdd into a copy of the bank.
//
// Any CMConfig (d <= 16, w <= 2^24) works with B * d * w < 2^31 (the
// wrapper checks).  Keys outside [0, B) add nothing (the §9 drop rule).
// Bound: 8 B of stream per item, plus the counters read and written once;
// the tiled path also reads the stream a second time (from L2) and writes
// and reads the packed items once.
//
// The fold is window_fold.cu's max fold with + in place of max: each
// thread owns 16 bytes (4 counters) of the (B * d * w) plane, walks the W
// slices with one 16-byte load each and skips a slice whose mask byte (read
// on the card) is 0.  Where the plane is not a multiple of 4 counters, the
// slices do not start on 16-byte boundaries, and a scalar kernel of one
// counter per thread runs instead.  Bound: the live slices read once and
// the plane written once, at the HBM rate.
#include <type_traits>

#include "common.cuh"
#include "murmur3.cuh"

namespace {

constexpr int kThreads = 256;       // the global path and the fold
constexpr int kTileThreads = 512;   // the partition and tile passes

struct CmPlan {
  int rows, depth, cells;
  uint32_t width;
  int tile_shift;     // a tile holds 2^tile_shift whole (d, w) rows
  int tiles;
  int tile_words;     // shared words of a tile: 2^tile_shift * cells, rounded up to 4
  int log2_width;     // >= 0: w is a power of two, items pack into 32 bits
  uint64_t seed;
};

__device__ __forceinline__ uint32_t lane_mask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Apply f(key, item) to every item of [lo, hi) (lo a multiple of 4; common.cuh's
// loader, two quads of each array in flight where vec), item 0 where kItems
// is false.  Lanes past the end see key -1, and the whole block takes the
// same number of turns, so a warp's lanes stay together for the match in f.
template <bool kItems, typename F>
__device__ __forceinline__ void for_each_item(const int32_t* __restrict__ keys, const uint32_t* __restrict__ items,
                                              long long lo, long long hi, bool vec, F&& f) {
  const int32_t* src[2] = {keys, reinterpret_cast<const int32_t*>(items)};
  const int32_t none[2] = {-1, 0};
  repro::for_each_quad<2>(src, none, kItems ? 2 : 1, lo, hi, vec, f);
}

// The global path: one thread per item lands d hits on the bank copy it is
// given.
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

// 1. partition: slice s = [s * per, (s + 1) * per) of the stream, sorted by
// tile into its region of `packed` (per words from s * per, two words an
// item where kWide); offsets[s][0 .. tiles] its exclusive tile offsets;
// tile_total[t] += its items on tile t.
template <bool kWide>
__global__ void __launch_bounds__(kTileThreads)
cm_partition_kernel(const int32_t* __restrict__ keys, const uint32_t* __restrict__ items, long long n,
                    int per, bool vec, CmPlan p, int32_t* __restrict__ offsets, int32_t* __restrict__ tile_total,
                    uint32_t* __restrict__ packed) {
  extern __shared__ int32_t sh[];
  int32_t* cursor = sh;                                                    // tiles + 1
  uint32_t* stage = reinterpret_cast<uint32_t*>(sh + ((p.tiles + 4) & ~3));  // per (x2 where kWide)
  __shared__ int32_t spare[32];
  const long long lo = static_cast<long long>(per) * blockIdx.x;
  const long long hi = lo + per < n ? lo + per : n;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i <= p.tiles; i += blockDim.x) cursor[i] = 0;
  __syncthreads();
  for_each_item<false>(keys, items, lo, hi, vec, [&](int key, uint32_t) {
    const int t = key >= 0 && key < p.rows ? key >> p.tile_shift : p.tiles;  // tiles: dropped
    const uint32_t peers = __match_any_sync(0xffffffffu, t);
    if (t < p.tiles && (peers & lane_mask_lt()) == 0) atomicAdd(cursor + t, __popc(peers));
  });
  __syncthreads();
  for (int t = threadIdx.x; t < p.tiles; t += blockDim.x)
    if (cursor[t]) atomicAdd(tile_total + t, cursor[t]);
  const int total = repro::block_scan(cursor, p.tiles + 1, spare);  // syncs
  int32_t* mine = offsets + static_cast<long long>(blockIdx.x) * (p.tiles + 1);
  for (int t = threadIdx.x; t <= p.tiles; t += blockDim.x) mine[t] = cursor[t];
  __syncthreads();
  const uint32_t low = p.log2_width >= 0 ? p.width - 1u : 0u;
  for_each_item<true>(keys, items, lo, hi, vec, [&](int key, uint32_t item) {
    const int t = key >= 0 && key < p.rows ? key >> p.tile_shift : p.tiles;
    const uint32_t peers = __match_any_sync(0xffffffffu, t);
    const int leader = __ffs(peers) - 1;
    int at = 0;
    if (t < p.tiles && lane == leader) at = atomicAdd(cursor + t, __popc(peers));
    at = __shfl_sync(0xffffffffu, at, leader) + __popc(peers & lane_mask_lt());
    if (t == p.tiles) return;
    const uint32_t row = static_cast<uint32_t>(key) & ((1u << p.tile_shift) - 1u);
    if (kWide) {
      reinterpret_cast<uint64_t*>(stage)[at] = (static_cast<uint64_t>(row) << 32) | item;
    } else {
      const uint64_t h = repro::murmur3_64(item, p.seed);
      const uint32_t k = static_cast<uint32_t>(p.log2_width);
      stage[at] = (row << (2 * k)) | ((static_cast<uint32_t>(h >> 32) & low) << k) |
                  (static_cast<uint32_t>(h) & low);
    }
  });
  __syncthreads();
  if (kWide) {
    uint64_t* region = reinterpret_cast<uint64_t*>(packed) + static_cast<long long>(per) * blockIdx.x;
    for (int i = threadIdx.x; i < total; i += blockDim.x) region[i] = reinterpret_cast<uint64_t*>(stage)[i];
  } else {
    uint32_t* region = packed + static_cast<long long>(per) * blockIdx.x;
    for (int i = threadIdx.x; i < total; i += blockDim.x) region[i] = stage[i];
  }
}

// 2. plan, one block: extra_start[t] = the exclusive scan over tiles of
// (units of tile t) - 1; extra_start[tiles] = the extra units in all.
__global__ void __launch_bounds__(1024)
cm_plan_kernel(const int32_t* __restrict__ tile_total, int tiles, int slices, int unit_items,
               int32_t* __restrict__ extra_start) {
  extern __shared__ int32_t extra[];  // tiles + 1
  __shared__ int32_t spare[32];
  repro::plan_extra_units(tile_total, tiles, slices, unit_items, extra_start, extra, spare);
}

// 3. one block per unit (tile t, unit j, the group of slices
// [j * slices / units, (j + 1) * slices / units)).  First launch (kExtra
// false): block t is unit 0 of tile t, starts from the tile's counters and
// stores every counter of the tile.  Second launch: block b is the b-th
// extra unit, starts from zero and adds its nonzero partials.
template <bool kWide, bool kExtra>
__global__ void __launch_bounds__(kTileThreads)
cm_tile_kernel(const uint32_t* __restrict__ counters, uint32_t* out, CmPlan p, int slices, int per,
               int unit_items, bool vec, const int32_t* __restrict__ offsets,
               const int32_t* __restrict__ tile_total, const int32_t* __restrict__ extra_start,
               const uint32_t* __restrict__ packed) {
  extern __shared__ uint32_t tile[];
  int32_t* seg_pre = reinterpret_cast<int32_t*>(tile + p.tile_words);  // group + 1: where each segment starts
  int32_t* seg_lo = seg_pre + slices + 1;  // group: where it starts in its slice's region
  __shared__ int32_t spare[32];
  int t, j;
  if (!kExtra) {
    t = blockIdx.x;
    j = 0;
  } else if (!repro::extra_unit(extra_start, p.tiles, blockIdx.x, &t, &j)) {
    return;
  }
  const int units = repro::unit_count(tile_total[t], slices, unit_items);
  const int s0 = static_cast<int>(static_cast<long long>(j) * slices / units);
  const int group = static_cast<int>(static_cast<long long>(j + 1) * slices / units) - s0;
  const int first_row = t << p.tile_shift;
  const int count = min(1 << p.tile_shift, p.rows - first_row) * p.cells;
  const long long base = static_cast<long long>(first_row) * p.cells;
  if (!kExtra) {
    if (vec) {
      const uint4* src = reinterpret_cast<const uint4*>(counters + base);
      for (int i = threadIdx.x; i < count / 4; i += blockDim.x) reinterpret_cast<uint4*>(tile)[i] = src[i];
    } else {
      for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = counters[base + i];
    }
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = 0u;
  }
  const int entries = repro::load_segments(offsets, p.tiles, t, s0, group, seg_pre, seg_lo, spare);  // syncs
  const uint32_t w = p.width;
  // each item's d hits, four items a lane loaded at once (common.cuh)
  using Word = typename std::conditional<kWide, uint64_t, uint32_t>::type;
  repro::for_each_entry(reinterpret_cast<const Word*>(packed), per, s0, group, seg_pre, seg_lo, entries,
                        [&](Word x) {
    uint32_t row, lo, hi;
    if (kWide) {
      row = static_cast<uint32_t>(static_cast<uint64_t>(x) >> 32);
      const uint64_t h = repro::murmur3_64(static_cast<uint32_t>(x), p.seed);
      lo = static_cast<uint32_t>(h);
      hi = static_cast<uint32_t>(h >> 32);
    } else {
      const uint32_t v = static_cast<uint32_t>(x);
      const uint32_t kb = static_cast<uint32_t>(p.log2_width);
      row = v >> (2 * kb);
      hi = (v >> kb) & (w - 1u);
      lo = v & (w - 1u);
    }
    uint32_t* cell = tile + row * static_cast<uint32_t>(p.cells);  // row < 2^tile_shift
    for (int r = 0; r < p.depth; ++r) {
      const uint32_t mixed = lo + static_cast<uint32_t>(r) * hi;
      atomicAdd(cell + r * w + (kWide ? mixed % w : mixed & (w - 1u)), 1u);
    }
  });
  __syncthreads();
  if (!kExtra) {
    if (vec) {
      uint4* dst = reinterpret_cast<uint4*>(out + base);
      for (int i = threadIdx.x; i < count / 4; i += blockDim.x) dst[i] = reinterpret_cast<const uint4*>(tile)[i];
    } else {
      for (int i = threadIdx.x; i < count; i += blockDim.x) out[base + i] = tile[i];
    }
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x)
      if (tile[i]) atomicAdd(out + base + i, tile[i]);
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

// The global path: counters is the (B, d, w) bank to add into, in place
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

// The tiled path.  counters: the (B, d, w) bank, read only; out: the
// result, uninitialised; keys, items: (n,) int32.  The plan and its limits
// are the wrapper's (cm_scatter.py::cm_tile_plan, cm_scatter_path): tiles
// of rows_per_tile whole rows (a power of two), log2_width >= 0 where w is
// a power of two, else -1; slices of per items; unit_items items a unit.
// This checks that they are consistent, and the card refuses shared sizes
// it does not have.  scratch: scratch_words int32 words, 16-byte aligned,
// in one allocation: offsets (slices * (tiles + 1)), tile_total (tiles,
// zeroed here), extra_start (tiles + 1), then from a 16-byte boundary the
// packed items (per * slices, twice that where log2_width < 0).
extern "C" int cm_scatter_tiled_launch(const void* counters, void* out, const void* keys, const void* items,
                                       long long n, int rows, int depth, int width, unsigned long long seed,
                                       int rows_per_tile, int tiles, int log2_width, int per, int slices,
                                       int unit_items, void* scratch, long long scratch_words, void* stream) {
  const long long cells = static_cast<long long>(depth) * width;
  const long long tile_cells = rows_per_tile * cells;
  if (n <= 0 || rows <= 0 || depth <= 0 || width <= 0 || tiles <= 0 || rows_per_tile < 1 ||
      (rows_per_tile & (rows_per_tile - 1)) || tile_cells > INT_MAX / 2 ||
      static_cast<long long>(tiles) * rows_per_tile < rows ||
      static_cast<long long>(tiles - 1) * rows_per_tile >= rows || per <= 0 || slices <= 0 ||
      static_cast<long long>(per) * slices < n || unit_items < 1 ||
      (log2_width >= 0 && (1LL << log2_width) != width) || (reinterpret_cast<uintptr_t>(scratch) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = log2_width < 0;
  const long long head = static_cast<long long>(slices) * (tiles + 1) + 2LL * tiles + 1;
  if ((head + 3) / 4 * 4 + (wide ? 2LL : 1LL) * per * slices > scratch_words)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int tile_shift = 0;
  while ((1 << tile_shift) < rows_per_tile) ++tile_shift;
  const int tile_words = static_cast<int>((tile_cells + 3) & ~3LL);
  const CmPlan p{rows, depth, static_cast<int>(cells), static_cast<uint32_t>(width), tile_shift, tiles, tile_words,
                 log2_width, static_cast<uint64_t>(seed)};
  const bool vec = cells % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(counters) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  constexpr long long kWord = sizeof(int32_t);
  const long long part_bytes = ((tiles + 4LL) / 4 * 4 + (wide ? 2LL : 1LL) * per) * kWord;
  const long long plan_bytes = (tiles + 1LL) * kWord;
  const long long tile_bytes = (tile_words + 2LL * slices + 1) * kWord;
  auto partition = wide ? cm_partition_kernel<true> : cm_partition_kernel<false>;
  auto tile_pass = wide ? cm_tile_kernel<true, false> : cm_tile_kernel<false, false>;
  auto extra_pass = wide ? cm_tile_kernel<true, true> : cm_tile_kernel<false, true>;
  // what each kernel was allowed, per device: one record a kernel (the
  // partition and tile kernels come narrow and wide, the plan kernel once)
  static int allowed_partition[2][repro::kMaxDevices], allowed_tile[2][repro::kMaxDevices],
      allowed_extra[2][repro::kMaxDevices], allowed_plan[repro::kMaxDevices];
  cudaError_t err;
  if ((err = repro::allow_shared(partition, part_bytes, allowed_partition[wide])) != cudaSuccess ||
      (err = repro::allow_shared(cm_plan_kernel, plan_bytes, allowed_plan)) != cudaSuccess ||
      (err = repro::allow_shared(tile_pass, tile_bytes, allowed_tile[wide])) != cudaSuccess ||
      (err = repro::allow_shared(extra_pass, tile_bytes, allowed_extra[wide])) != cudaSuccess)
    return static_cast<int>(err);
  auto* o = static_cast<int32_t*>(scratch);
  auto* tt = o + static_cast<long long>(slices) * (tiles + 1);
  auto* es = tt + tiles;
  auto* pk = reinterpret_cast<uint32_t*>(o + (head + 3) / 4 * 4);
  if ((err = cudaMemsetAsync(tt, 0, tiles * sizeof(int32_t), st)) != cudaSuccess) return static_cast<int>(err);
  const bool vec_items = ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(items)) & 15u) == 0;
  partition<<<slices, kTileThreads, part_bytes, st>>>(static_cast<const int32_t*>(keys),
                                                     static_cast<const uint32_t*>(items), n, per, vec_items, p, o,
                                                     tt, pk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  cm_plan_kernel<<<1, 1024, plan_bytes, st>>>(tt, tiles, slices, unit_items, es);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const auto* c = static_cast<const uint32_t*>(counters);
  auto* dst = static_cast<uint32_t*>(out);
  tile_pass<<<tiles, kTileThreads, tile_bytes, st>>>(c, dst, p, slices, per, unit_items, vec, o, tt, es, pk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // the extra units number at most n / unit_items (a tile of T items has
  // ceil(T / unit_items) - 1 <= T / unit_items of them)
  const long long extra_grid = n / unit_items;
  if (extra_grid > 0) {
    extra_pass<<<static_cast<unsigned>(extra_grid), kTileThreads, tile_bytes, st>>>(c, dst, p, slices, per,
                                                                                   unit_items, vec, o, tt, es, pk);
  }
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
