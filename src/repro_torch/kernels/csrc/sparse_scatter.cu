// sparse_scatter: dedup of a (row, bucket, rank) triple stream into (rows, m)
// int32 max-rank cells (0 = empty), plus the (rows,) int32 count of distinct
// buckets per row.
//
// Replaces the TPU kernel repro/kernels/sparse_scatter.py::sparse_scatter_coo
// (_sparse_kernel), the scatter phase of HybridBank compaction.  The TPU
// kernel keeps a row block's cells in VMEM, merges the stream into them by
// a chunked one-hot compare-reduce, counts each row's distinct buckets by a
// popcount over the block and writes the block once.  This design keeps
// what that kernel keeps on chip -- a block-resident tile of cells, written
// once and counted in place -- and reaches it by partitioning the stream
// first instead of sweeping it once per block:
//
//   tile plan  the flat rows * m cell space is cut into tiles of at most
//              2^14 int32 cells (64 KB of shared memory): whole rows where
//              m <= 2^14 (4 rows at p = 12, 1024 at p = 4), else a row
//              spans m / 2^14 tiles (4 at p = 16).  The wrapper computes
//              the plan (sparse_scatter.py::tile_plan) and the stream's
//              split into slices, and passes both in.
//   partition  a block per slice of the stream counts its valid triples per
//              tile in shared memory, scans the counts into the slice's
//              tile offsets (written out: a (slices, tiles + 1) matrix),
//              re-reads the slice and sorts it by tile into shared memory,
//              each triple packed as (offset in tile, rank) -- 32 bits where
//              the slice's ranks are < 2^18, else 64 -- and writes the
//              sorted slice to its own region of the scratch, coalesced:
//              4-byte writes scattered over every tile's range would be
//              partial 32-byte sectors, which the card's ECC memory reads
//              before it writes.
//   tiles      a block per tile gathers the tile's segment of every slice,
//              zeroes the tile in shared memory, applies the triples with
//              shared atomicMax, writes every cell to global memory
//              coalesced -- the only write of the cells, so the wrapper
//              allocates them with torch.empty -- and counts each row's
//              nonzero cells, stored where the tile holds the row, added
//              (atomicAdd) where a row spans tiles.
// Max and count do not depend on order, so the result is bit-identical to
// the plain version, and no global atomic touches a cell.  A hot tile
// costs its own block more shared atomics, spread over many blocks an SM.
//
// A plan with more tiles than a shared histogram holds (2^14), or more
// slices than a tile block's gather holds (4096), takes the global path:
// one thread per triple raises its cell in zeroed global cells with
// atomicMax, and the thread that sees the old value 0 counts the row's
// bucket.
//
// Entries with a row outside [0, rows), a bucket outside [0, m) or a rank
// <= 0 change nothing (padding and foreign rows).  Bound: 12 B of stream
// read per triple plus the cells and counts written once; the tiled path
// also reads the stream a second time (from L2) and writes and reads the
// packed triples once.
#include "common.cuh"

namespace {

constexpr int kTileCells = 1 << 14;
constexpr int kTileShift = 14;
constexpr int kMaxTileRows = 1024;
constexpr int kHistTiles = 1 << 14;
constexpr int kMaxSlice = 1 << 14;   // triples a slice holds in shared memory
constexpr int kMaxSlices = 4096;     // slices a tile block gathers from
constexpr int kThreads = 512;
constexpr int kNarrowRankBits = 18;  // 32-bit packing: 14 bits of offset, 18 of rank

struct Plan {
  int rows, m;
  int rows_per_tile;  // whole rows a tile holds (tiles_per_row == 1)
  int tiles_per_row;  // > 1: a row spans this many tiles of 2^14 cells
  int tiles;
};

// The tile of a valid triple and its cell's offset in that tile.
__device__ __forceinline__ int tile_of(const Plan& p, int r, int b, int* off) {
  if (p.tiles_per_row == 1) {
    const int t = r / p.rows_per_tile;
    *off = (r - t * p.rows_per_tile) * p.m + b;
    return t;
  }
  *off = b & (kTileCells - 1);
  return r * p.tiles_per_row + (b >> kTileShift);
}

__device__ __forceinline__ bool valid(const Plan& p, int r, int b, int k) {
  return r >= 0 && r < p.rows && b >= 0 && b < p.m && k > 0;
}

// Apply f(row, bucket, rank) to every triple of [lo, hi) (lo a multiple of
// 4; common.cuh's loader, two quads of each array in flight where vec).
// Lanes past the end see rank 0, which is dropped.
template <typename F>
__device__ __forceinline__ void for_each_triple(const int32_t* __restrict__ row,
                                                const int32_t* __restrict__ bucket,
                                                const int32_t* __restrict__ rank, long long lo,
                                                long long hi, bool vec, F&& f) {
  const int32_t* src[3] = {row, bucket, rank};
  const int32_t none[3] = {0, 0, 0};
  repro::for_each_quad<3>(src, none, 3, lo, hi, vec, f);
}

// 1. partition: slice s = [s * per, (s + 1) * per) of the stream, sorted by
// tile into its region of `packed` (2 * per int32 words from s * 2 * per);
// offsets[s][0 .. tiles] its exclusive tile offsets; wide[s] its packing.
__global__ void __launch_bounds__(kThreads)
partition_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ bucket,
                 const int32_t* __restrict__ rank, long long n, int per, bool vec, Plan p,
                 int32_t* __restrict__ offsets, int32_t* __restrict__ wide, uint32_t* __restrict__ packed) {
  extern __shared__ int32_t sh[];
  int32_t* cursor = sh;                                           // tiles + 1
  uint32_t* stage = reinterpret_cast<uint32_t*>(sh + ((p.tiles + 4) & ~3));  // per
  __shared__ int32_t spare[32];
  __shared__ int block_top;
  const long long lo = static_cast<long long>(per) * blockIdx.x;
  const long long hi = lo + per < n ? lo + per : n;
  for (int i = threadIdx.x; i <= p.tiles; i += blockDim.x) cursor[i] = 0;
  if (threadIdx.x == 0) block_top = 0;
  __syncthreads();
  int top = 0;
  for_each_triple(row, bucket, rank, lo, hi, vec, [&](int r, int b, int k) {
    if (!valid(p, r, b, k)) return;
    int off;
    atomicAdd(cursor + tile_of(p, r, b, &off), 1);
    top = k > top ? k : top;
  });
  top = __reduce_max_sync(0xffffffffu, top);
  if ((threadIdx.x & 31) == 0) atomicMax(&block_top, top);
  const int total = repro::block_scan(cursor, p.tiles + 1, spare);  // syncs
  const bool w = block_top >= (1 << kNarrowRankBits);
  int32_t* mine = offsets + static_cast<long long>(blockIdx.x) * (p.tiles + 1);
  for (int i = threadIdx.x; i <= p.tiles; i += blockDim.x) mine[i] = cursor[i];
  if (threadIdx.x == 0) wide[blockIdx.x] = w;
  __syncthreads();
  uint32_t* region = packed + 2LL * per * blockIdx.x;
  for_each_triple(row, bucket, rank, lo, hi, vec, [&](int r, int b, int k) {
    if (!valid(p, r, b, k)) return;
    int off;
    const int at = atomicAdd(cursor + tile_of(p, r, b, &off), 1);
    if (w)  // ranks past 18 bits: straight to the region, 64 bits each
      reinterpret_cast<uint64_t*>(region)[at] = (static_cast<uint64_t>(off) << 32) | static_cast<uint32_t>(k);
    else
      stage[at] = (static_cast<uint32_t>(off) << kNarrowRankBits) | static_cast<uint32_t>(k);
  });
  __syncthreads();
  if (!w)
    for (int i = threadIdx.x; i < total; i += blockDim.x) region[i] = stage[i];
}

// 2. one block per tile: gather the tile's segment of every slice, max in
// shared memory, every cell written, rows counted
__global__ void __launch_bounds__(kThreads)
tile_kernel(Plan p, int slices, int per, const int32_t* __restrict__ offsets, const int32_t* __restrict__ wide,
            const uint32_t* __restrict__ packed, int32_t* __restrict__ cells, int32_t* __restrict__ distinct) {
  extern __shared__ int32_t tile[];
  int32_t* row_count = tile + kTileCells;          // kMaxTileRows
  int32_t* seg_pre = row_count + kMaxTileRows;  // slices + 1: where each segment starts in the gather
  int32_t* seg_lo = seg_pre + slices + 1;       // slices: where it starts in its slice's region
  __shared__ int32_t spare[32];
  const int t = blockIdx.x;
  long long base;
  int count, first_row, tile_rows;
  if (p.tiles_per_row == 1) {
    first_row = t * p.rows_per_tile;
    tile_rows = min(p.rows_per_tile, p.rows - first_row);
    base = static_cast<long long>(first_row) * p.m;
    count = tile_rows * p.m;
  } else {
    first_row = t / p.tiles_per_row;
    tile_rows = 1;
    const int chunk = t % p.tiles_per_row;
    base = static_cast<long long>(first_row) * p.m + static_cast<long long>(chunk) * kTileCells;
    count = min(kTileCells, p.m - chunk * kTileCells);
  }
  for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = 0;
  for (int i = threadIdx.x; i < tile_rows; i += blockDim.x) row_count[i] = 0;
  for (int s = threadIdx.x; s < slices; s += blockDim.x) {
    const int32_t* o = offsets + static_cast<long long>(s) * (p.tiles + 1) + t;
    seg_lo[s] = o[0];
    seg_pre[s] = o[1] - o[0];
  }
  const int entries = repro::block_scan(seg_pre, slices, spare);  // syncs
  if (threadIdx.x == 0) seg_pre[slices] = entries;
  __syncthreads();
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    int a = 0, b = slices;  // the slice s with seg_pre[s] <= e < seg_pre[s + 1]
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if (seg_pre[mid] <= e) a = mid;
      else b = mid;
    }
    const uint32_t* region = packed + 2LL * per * a;
    const int at = seg_lo[a] + e - seg_pre[a];
    if (wide[a]) {
      const uint64_t x = reinterpret_cast<const uint64_t*>(region)[at];
      atomicMax(tile + static_cast<int>(x >> 32), static_cast<int>(x & 0xFFFFFFFFu));
    } else {
      const uint32_t x = region[at];
      atomicMax(tile + static_cast<int>(x >> kNarrowRankBits), static_cast<int>(x & ((1u << kNarrowRankBits) - 1)));
    }
  }
  __syncthreads();
  const int span = p.tiles_per_row == 1 ? p.m : count;  // cells of one row in the tile
  if (p.m % 128 == 0) {
    // 4 cells a thread, a warp's 128 cells in one row; base and count are
    // multiples of 128 cells
    int4* dst = reinterpret_cast<int4*>(cells + base);
    const int4* src = reinterpret_cast<const int4*>(tile);
    for (int i = threadIdx.x; i < count / 4; i += blockDim.x) {
      const int4 x = src[i];
      dst[i] = x;
      const int c = (x.x != 0) + (x.y != 0) + (x.z != 0) + (x.w != 0);
      const int sum = __reduce_add_sync(0xffffffffu, c);
      if ((threadIdx.x & 31) == 0 && sum) atomicAdd(row_count + 4 * i / span, sum);
    }
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int x = tile[i];
      cells[base + i] = x;
      if (x) atomicAdd(row_count + i / span, 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < tile_rows; i += blockDim.x) {
    if (p.tiles_per_row == 1) distinct[first_row + i] = row_count[i];
    else if (row_count[i]) atomicAdd(distinct + first_row, row_count[i]);
  }
}

// the global path: first-touch counting with value-returning atomics on
// zeroed cells and counts
__global__ void atomic_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ bucket,
                              const int32_t* __restrict__ rank, long long n, int rows, int m,
                              int32_t* cells, int32_t* distinct) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int r = row[i], b = bucket[i], k = rank[i];
    if (r < 0 || r >= rows || b < 0 || b >= m || k <= 0) continue;
    if (atomicMax(cells + static_cast<long long>(r) * m + b, k) == 0) atomicAdd(distinct + r, 1);
  }
}

}  // namespace

// The tiled path.  row, bucket, rank: (n,) int32; cells: (rows, m) int32,
// uninitialised; distinct: (rows,) int32, zeroed where rows span tiles
// (tiles_per_row > 1), else uninitialised.  The plan (rows_per_tile,
// tiles_per_row, tiles <= 2^14) and the split (slices of per <= 2^14
// triples, per a multiple of 4, at most 4096 slices) come from the wrapper.
// Scratch, all int32: offsets (slices * (tiles + 1)), wide (slices),
// packed (2 * per * slices).
extern "C" int sparse_scatter_tiled_launch(const void* row, const void* bucket, const void* rank,
                                           long long n, int rows, int m, int rows_per_tile,
                                           int tiles_per_row, int tiles, int per, int slices, void* cells,
                                           void* distinct, void* offsets, void* wide, void* packed,
                                           void* stream) {
  if (n <= 0 || rows <= 0 || tiles <= 0 || tiles > kHistTiles || per <= 0 || per > kMaxSlice || per % 4 ||
      slices <= 0 || slices > kMaxSlices || static_cast<long long>(per) * slices < n ||
      (tiles_per_row == 1 && (rows_per_tile < 1 || rows_per_tile > kMaxTileRows ||
                              static_cast<long long>(rows_per_tile) * m > kTileCells)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const Plan p{rows, m, rows_per_tile, tiles_per_row, tiles};
  const bool vec = ((reinterpret_cast<uintptr_t>(row) | reinterpret_cast<uintptr_t>(bucket) |
                     reinterpret_cast<uintptr_t>(rank)) & 15u) == 0;
  const int part_bytes = (((tiles + 4) & ~3) + per) * static_cast<int>(sizeof(int32_t));
  const int max_part_bytes = (kHistTiles + 4 + kMaxSlice) * static_cast<int>(sizeof(int32_t));
  const int tile_bytes = (kTileCells + kMaxTileRows + 2 * slices + 1) * static_cast<int>(sizeof(int32_t));
  const int max_tile_bytes = (kTileCells + kMaxTileRows + 2 * kMaxSlices + 1) * static_cast<int>(sizeof(int32_t));
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(partition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  max_part_bytes)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_tile_bytes)) !=
          cudaSuccess)
    return static_cast<int>(err);
  auto* o = static_cast<int32_t*>(offsets);
  auto* w = static_cast<int32_t*>(wide);
  auto* pk = static_cast<uint32_t*>(packed);
  partition_kernel<<<slices, kThreads, part_bytes, st>>>(static_cast<const int32_t*>(row),
                                                         static_cast<const int32_t*>(bucket),
                                                         static_cast<const int32_t*>(rank), n, per, vec, p, o, w, pk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  tile_kernel<<<tiles, kThreads, tile_bytes, st>>>(p, slices, per, o, w, pk, static_cast<int32_t*>(cells),
                                                   static_cast<int32_t*>(distinct));
  return static_cast<int>(cudaGetLastError());
}

// The global path.  cells and distinct zeroed by the wrapper.
extern "C" int sparse_scatter_launch(const void* row, const void* bucket, const void* rank, long long n,
                                     int rows, int m, void* cells, void* distinct, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  constexpr int threads = 256;
  const long long grid = (n + threads - 1) / threads;
  atomic_kernel<<<static_cast<unsigned>(grid < 0x7FFFFFFF ? grid : 0x7FFFFFFF), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row), static_cast<const int32_t*>(bucket),
      static_cast<const int32_t*>(rank), n, rows, m, static_cast<int32_t*>(cells),
      static_cast<int32_t*>(distinct));
  return static_cast<int>(cudaGetLastError());
}
