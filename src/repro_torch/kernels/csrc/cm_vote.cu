// cm_vote: the batch-canonical Topkapi vote of a count-min tick on the card.
//
// No Pallas kernel: the reference votes in plain JAX
// (repro/sketch/countmin.py, _label_update: a lexsort of (value, cell), run
// lengths and two segment_max).  Per cell of a (B, d, w) bank, over one
// batch: the winner x* is the item of highest multiplicity mc among the
// cell's hits (ties to the larger signed int32 value), its surplus is
// s = 2 mc - total, and the stored (label, count) pair absorbs (x*, s) by the
// rule of sketch/countmin.py's _label_update, in int32 arithmetic that wraps.
// A cell with no valid hit keeps its pair.  Nothing is read back to the host.
//
// The plain version sorts 4n int64 keys.  Here nothing is sorted: the hits
// are counted and placed by cell, the counting sort's way, and each cell
// elects its winner from its own bucket.  Three launches:
//
//   partition  as csrc/cm_scatter.cu's: a block per slice of the stream
//              counts its valid entries per tile (a tile: 2^tile_shift whole
//              (d, w) rows; warp-aggregated with __match_any_sync where
//              neighbouring lanes share a tile, as under skewed keys), scans
//              them into the slice's tile offsets (a (slices, tiles + 1)
//              matrix), sorts the slice by tile in shared memory and writes
//              it, coalesced, to its own region of `packed` (pack_entry: the
//              item alone, 4 bytes, where a tile is one row, as in the
//              tick's bank).  Keys outside [0, B) are dropped here.  Block 0
//              zeroes the device counters (`head`).
//   tiles      a block per tile gathers its entries from every slice and
//              counts the d hits of each per cell: in shared memory where
//              the tile's cells fit (cm_vote.py's TILE_CELLS), else in a
//              global (B * d * w) scratch.  A warp whose neighbouring lanes
//              hold one entry adds equal entries once (__match_any_sync), so
//              one item repeated 2^20 times does not serialise its atomics;
//              other warps add lane by lane.  An exclusive scan turns the
//              counts into bucket offsets, the tile claims its span of the
//              bucket array with one 64-bit atomicAdd, and a second gather
//              places each hit's item at its cell's cursor: in shared memory
//              where the tile's hits fit kSharedHits (a row of the tick's
//              bank, 16 Ki hits), else in the span (a hot row under skewed
//              keys: one block takes all of it).  Then a thread per cell
//              elects a cell of at most kThreadHits hits: where no value is
//              seen twice by a two-word Bloom filter, the values are
//              distinct and the largest wins with multiplicity 1, else each
//              value's multiplicity is counted.  A longer cell goes on one of
//              two lists for the next launch (its hits copied to the span
//              from shared memory).  Every cell of the tile is written here,
//              so the copy of the tables folds into this pass; a listed cell
//              is written again by the next launch.
//   cooperative  a grid of two blocks an SM claims the listed cells with
//              atomic counters: first the cells of more than kWarpHits hits,
//              a whole block each, then the others, a warp each.  Each counts
//              its bucket's values in a shared open-addressing table of
//              (value, count) slots, twice as many as the hits (at most
//              kBlockSlots), and takes the largest (count, value).  A bucket
//              with more distinct values than half of kBlockSlots is counted
//              in passes over ranges of a bijective hash of the value,
//              halving a range whose values overflow the table: bounded
//              shared memory, exact at any length, one read of the bucket a
//              pass.  On uniform traffic this launch finds a few cells; it
//              serves skewed items (a heavy item's cells) and hot rows.
//
// The plain version's wrapping int32 arithmetic is reproduced with uint32
// operations.  Any CMConfig (d <= 16, w <= 2^24) works with B * d * w < 2^31,
// fewer than 2^31 entries and fewer than 2^32 hits (the wrapper checks);
// bucket spans and list offsets are 64-bit.  Bound: the (key, item) stream
// read once and the two tables read and written once, at the HBM rate; the
// packed stream is written once and read twice more, mostly in L2.
#include "common.cuh"
#include "murmur3.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kThreadHits = 16;                 // cm_vote.py's THREAD_HITS
constexpr int kWarpHits = 256;                  // WARP_HITS
constexpr int kWarpSlots = 2 * kWarpHits;       // a warp's table
constexpr int kBlockSlots = 1 << 13;            // BLOCK_SLOTS: a block's table, 96 KiB with its counts
constexpr int kSegChunk = 512;                  // slices a tile block gathers from at once
constexpr int kSharedHits = 20480;              // SHARED_HITS: a tile's buckets in shared memory
constexpr uint32_t kSlotHash = 0x9E3779B1u;     // a value's first slot
constexpr uint32_t kBloom1 = 0x2545F491u;       // the thread path's two Bloom bits of a value
constexpr uint32_t kBloom2 = 0x9E3779B1u;
constexpr uint32_t kRangeHash = 0x85EBCA6Bu;    // odd: a bijection of the 32-bit values
constexpr unsigned long long kNone = ~0ull;     // a lane with no entry, in a match
constexpr unsigned long long kRange = 1ull << 32;
constexpr unsigned kFull = 0xffffffffu;

// head: the device counters, 64-bit words.
enum { kCursor = 0, kWarpCells = 1, kBlockCells = 2, kWarpClaim = 3, kBlockClaim = 4, kHeadWords = 8 };

struct VotePlan {
  int rows, depth, cells;
  uint32_t width;
  int log2_width;  // >= 0 where w is a power of two
  int tile_shift;  // a tile holds 2^tile_shift whole (d, w) rows
  int tiles;
  uint64_t seed;
};

// A cell that takes the cooperative path (cm_vote.py's LIST_BYTES a record).
struct Listed {
  long long start;  // its first hit in the bucket array
  int cell;         // flat index into the (B * d * w) tables
  int len;          // its hits
};

__device__ __forceinline__ uint32_t lane_mask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// (multiplicity, value) as one key whose unsigned order is the vote's:
// more hits first, then the larger signed value.
__device__ __forceinline__ unsigned long long ballot_key(uint32_t mult, uint32_t value) {
  return (static_cast<unsigned long long>(mult) << 32) | (value ^ 0x80000000u);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, x, d);
    x = y > x ? y : x;
  }
  return x;
}

// The stored (l, lc) pair absorbs the winner of `best` (ballot_key) with
// `total` hits: _label_update's rule, int32 arithmetic wrapping.
__device__ __forceinline__ void absorb(int32_t l, int32_t lc, unsigned long long best, uint32_t total,
                                       int32_t* out_l, int32_t* out_c) {
  const int32_t winner = static_cast<int32_t>(static_cast<uint32_t>(best) ^ 0x80000000u);
  const uint32_t mc = static_cast<uint32_t>(best >> 32);
  const int32_t s = static_cast<int32_t>(2u * mc - total);
  if (lc == 0) {
    *out_l = winner;
    *out_c = s > 0 ? s : 0;
  } else if (winner == l) {
    const int32_t u = static_cast<int32_t>(static_cast<uint32_t>(lc) + static_cast<uint32_t>(s));
    *out_l = l;
    *out_c = u > 0 ? u : 0;
  } else {
    const int32_t t = static_cast<int32_t>(static_cast<uint32_t>(s) - static_cast<uint32_t>(lc));
    *out_l = t > 0 ? winner : t < 0 ? l : max(l, winner);
    *out_c = t < 0 ? static_cast<int32_t>(0u - static_cast<uint32_t>(t)) : t;  // |t|, INT32_MIN stays
  }
}

// An entry of the partitioned slices (`packed`): where a tile is one row,
// its item, 4 bytes; else the row in its tile, then the item, 8 bytes.
template <typename Word>
__device__ __forceinline__ Word pack_entry(uint32_t row, uint32_t item) {
  return sizeof(Word) == 4 ? static_cast<Word>(item) : static_cast<Word>((static_cast<uint64_t>(row) << 32) | item);
}

// The row in its tile and the columns of an entry's d cells:
// (h.lo + r * h.hi) mod w over the item's murmur3_64, in uint32.
template <typename Word>
struct Entry {
  uint32_t row, lo, hi;
  __device__ __forceinline__ Entry(Word x, const VotePlan& p) {
    row = sizeof(Word) == 4 ? 0u : static_cast<uint32_t>(static_cast<uint64_t>(x) >> 32);
    const uint64_t h = repro::murmur3_64(static_cast<uint32_t>(x), p.seed);
    lo = static_cast<uint32_t>(h);
    hi = static_cast<uint32_t>(h >> 32);
  }
  __device__ __forceinline__ uint32_t col(int r, const VotePlan& p) const {
    const uint32_t mixed = lo + static_cast<uint32_t>(r) * hi;
    return p.log2_width >= 0 ? mixed & (p.width - 1u) : mixed % p.width;
  }
};

// Whether a warp's entries look repeated (two neighbouring lanes hold the
// same one), so that its equal entries should add once (__match_any_sync)
// rather than serialise their atomics on one address: one item repeated all
// through a tile does, distinct items (where a match only costs) do not.
__device__ __forceinline__ bool repeats(unsigned long long key, int lane) {
  const unsigned long long next = __shfl_down_sync(kFull, key, 1);
  return __any_sync(kFull, key != kNone && lane < 31 && next == key);
}

// Apply f(word, valid) to every entry of tile t, every lane of a warp
// together (common.cuh's for_each_entry), kSegChunk slices at a time
// (load_segments into seg_pre and seg_lo, the chunk's entries into
// `entries`); the first chunk is loaded already, and is not loaded again
// where it is the only one.  Syncs after each chunk.
template <typename Word, typename F>
__device__ __forceinline__ void gather_tile(const int32_t* __restrict__ offsets, const Word* __restrict__ packed,
                                            int tiles, int per, int t, int slices, int32_t* seg_pre,
                                            int32_t* seg_lo, int32_t* spare, int& entries, F&& f) {
  for (int s0 = 0; s0 < slices; s0 += kSegChunk) {
    const int group = min(kSegChunk, slices - s0);
    if (slices > kSegChunk)
      entries = repro::load_segments(offsets, tiles, t, s0, group, seg_pre, seg_lo, spare);  // syncs
    repro::for_each_entry<4, true>(packed, per, s0, group, seg_pre, seg_lo, entries, f);
    __syncthreads();
  }
}

// Count the d hits of a gathered entry into its tile's cells `cnt`, every
// lane of the warp together.
template <typename Word>
__device__ __forceinline__ void count_entry(uint32_t* cnt, Word x, bool valid, int lane, const VotePlan& p) {
  const unsigned long long key = valid ? static_cast<unsigned long long>(x) : kNone;
  const uint32_t peers = repeats(key, lane) ? __match_any_sync(kFull, key) : 1u << lane;
  if (!valid || (peers & lane_mask_lt()) != 0) return;
  const Entry<Word> e(x, p);
  uint32_t* c = cnt + e.row * static_cast<uint32_t>(p.cells);
  const uint32_t add = __popc(peers);
  for (int r = 0; r < p.depth; ++r) atomicAdd(c + r * p.width + e.col(r, p), add);
}

// Place the d hits of a gathered entry, every lane of the warp together:
// the hit on the tile's cell c goes to mine[at(c, k)], where at(c, k) moves
// c's cursor on by k and returns where it was.
template <typename Word, typename At>
__device__ __forceinline__ void place_entry(uint32_t* mine, Word x, bool valid, int lane, const VotePlan& p,
                                            At&& at) {
  const Entry<Word> e(x, p);
  const uint32_t row = e.row * static_cast<uint32_t>(p.cells);
  const unsigned long long key = valid ? static_cast<unsigned long long>(x) : kNone;
  if (!repeats(key, lane)) {
    if (valid)
      for (int r = 0; r < p.depth; ++r) mine[at(row + r * p.width + e.col(r, p), 1u)] = static_cast<uint32_t>(x);
    return;
  }
  const uint32_t peers = __match_any_sync(kFull, key);
  const int leader = __ffs(peers) - 1;
  const uint32_t rank = __popc(peers & lane_mask_lt());
  const uint32_t add = __popc(peers);
  for (int r = 0; r < p.depth; ++r) {
    uint32_t slot = 0;
    if (valid && lane == leader) slot = at(row + r * p.width + e.col(r, p), add);
    slot = __shfl_sync(kFull, slot, leader) + rank;
    if (valid) mine[slot] = static_cast<uint32_t>(x);
  }
}

// The winner (ballot_key) of a bucket of len <= kThreadHits hits, its value
// i read by v(i): where no value is seen twice by a two-word Bloom filter,
// the values are distinct and the largest wins once; else each value's
// multiplicity is counted.
template <typename V>
__device__ __forceinline__ unsigned long long thread_best(uint32_t len, V&& v) {
  unsigned long long seen1 = 0ull, seen2 = 0ull;
  uint32_t top = 0u;
  bool repeat = false;
  for (uint32_t i = 0; i < len; ++i) {
    const uint32_t x = v(i);
    const unsigned long long b1 = 1ull << ((x * kBloom1) >> 26), b2 = 1ull << ((x * kBloom2) >> 26);
    repeat |= (seen1 & b1) && (seen2 & b2);
    seen1 |= b1;
    seen2 |= b2;
    top = max(top, x ^ 0x80000000u);
  }
  unsigned long long best = ballot_key(1u, top ^ 0x80000000u);
  if (repeat) {
    for (uint32_t i = 0; i < len; ++i) {
      const uint32_t x = v(i);
      uint32_t m = 0;
      for (uint32_t j = 0; j < len; ++j) m += v(j) == x;
      const unsigned long long k = ballot_key(m, x);
      best = k > best ? k : best;
    }
  }
  return best;
}

// Put a cell of more than kThreadHits hits on the cooperative launch's lists.
__device__ __forceinline__ void list_cell(unsigned long long* head, Listed* warp_list, Listed* block_list,
                                          long long start, long long cell, uint32_t len) {
  const bool by_warp = len <= kWarpHits;
  const unsigned long long i = atomicAdd(head + (by_warp ? kWarpCells : kBlockCells), 1ull);
  (by_warp ? warp_list : block_list)[i] = Listed{start, static_cast<int>(cell), static_cast<int>(len)};
}

// 1. partition: slice s = [s * per, (s + 1) * per) of the stream, sorted by
// tile into its region of `packed` (per words from s * per); offsets[s][0 ..
// tiles] its exclusive tile offsets (pack_entry's words).
template <typename Word>
__global__ void __launch_bounds__(kThreads)
vote_partition_kernel(const int32_t* __restrict__ keys, const uint32_t* __restrict__ items, long long n, int per,
                      bool vec, VotePlan p, int32_t* __restrict__ offsets, Word* __restrict__ packed,
                      unsigned long long* __restrict__ head) {
  extern __shared__ int32_t sh[];
  int32_t* cursor = sh;                                            // tiles + 1
  auto* stage = reinterpret_cast<Word*>(sh + ((p.tiles + 4) & ~3));  // per
  __shared__ int32_t spare[32];
  if (blockIdx.x == 0 && threadIdx.x < kHeadWords) head[threadIdx.x] = 0ull;
  const long long lo = static_cast<long long>(per) * blockIdx.x;
  const long long hi = lo + per < n ? lo + per : n;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i <= p.tiles; i += blockDim.x) cursor[i] = 0;
  __syncthreads();
  const int32_t* src[2] = {keys, reinterpret_cast<const int32_t*>(items)};
  const int32_t none[2] = {-1, 0};
  // a warp's entries of one tile add once where neighbouring lanes share a
  // tile (skewed keys, repeats() below); else lane by lane
  repro::for_each_quad<2>(src, none, 1, lo, hi, vec, [&](int key, int) {
    const int t = key >= 0 && key < p.rows ? key >> p.tile_shift : p.tiles;  // tiles: dropped
    const uint32_t peers = repeats(t < p.tiles ? t : kNone, lane) ? __match_any_sync(kFull, t) : 1u << lane;
    if (t < p.tiles && (peers & lane_mask_lt()) == 0) atomicAdd(cursor + t, __popc(peers));
  });
  const int total = repro::block_scan(cursor, p.tiles + 1, spare);  // syncs
  int32_t* mine = offsets + static_cast<long long>(blockIdx.x) * (p.tiles + 1);
  for (int t = threadIdx.x; t <= p.tiles; t += blockDim.x) mine[t] = cursor[t];
  __syncthreads();
  repro::for_each_quad<2>(src, none, 2, lo, hi, vec, [&](int key, int item) {
    const int t = key >= 0 && key < p.rows ? key >> p.tile_shift : p.tiles;
    int at = 0;
    if (repeats(t < p.tiles ? t : kNone, lane)) {
      const uint32_t peers = __match_any_sync(kFull, t);
      const int leader = __ffs(peers) - 1;
      if (t < p.tiles && lane == leader) at = atomicAdd(cursor + t, __popc(peers));
      at = __shfl_sync(kFull, at, leader) + __popc(peers & lane_mask_lt());
    } else if (t < p.tiles) {
      at = atomicAdd(cursor + t, 1);
    }
    if (t == p.tiles) return;
    const uint32_t row = static_cast<uint32_t>(key) & ((1u << p.tile_shift) - 1u);
    stage[at] = pack_entry<Word>(row, static_cast<uint32_t>(item));
  });
  __syncthreads();
  Word* region = packed + static_cast<long long>(per) * blockIdx.x;
  for (int i = threadIdx.x; i < total; i += blockDim.x) region[i] = stage[i];
}

// 2. a block per tile: count, scan, place, elect (see the top).  kShared:
// the tile's counts and buckets in shared memory (a tile of more than
// kSharedHits hits keeps its buckets in the card's memory); else both in the
// card's memory.
template <bool kShared, typename Word>
__global__ void __launch_bounds__(kThreads)
vote_tile_kernel(VotePlan p, int slices, int per, const int32_t* __restrict__ offsets,
                 const Word* __restrict__ packed, uint32_t* __restrict__ global_counts,
                 uint32_t* __restrict__ bucket, const int32_t* __restrict__ labels,
                 const int32_t* __restrict__ votes, int32_t* __restrict__ out_l, int32_t* __restrict__ out_c,
                 Listed* __restrict__ warp_list, Listed* __restrict__ block_list,
                 unsigned long long* __restrict__ head) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t spare[32];
  __shared__ unsigned long long span;
  __shared__ int listed;
  const int t = blockIdx.x;
  const int first_row = t << p.tile_shift;
  const int rows_here = min(1 << p.tile_shift, p.rows - first_row);
  const int count = rows_here * p.cells;  // the tile's cells
  const long long first_cell = static_cast<long long>(first_row) * p.cells;
  const int tile_words = kShared ? ((p.cells << p.tile_shift) + 3) & ~3 : 0;
  uint32_t* cnt = kShared ? smem : global_counts + first_cell;
  int32_t* seg_pre = reinterpret_cast<int32_t*>(smem + tile_words);  // kSegChunk + 1
  int32_t* seg_lo = seg_pre + kSegChunk + 1;                          // kSegChunk
  uint32_t* shared_bucket = smem + tile_words + 2 * kSegChunk + 4;    // kSharedHits, where kShared
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) listed = 0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) cnt[i] = 0u;
  // the first chunk of segments
  int entries = repro::load_segments(offsets, p.tiles, t, 0, min(kSegChunk, slices), seg_pre, seg_lo,
                                     reinterpret_cast<int32_t*>(spare));  // syncs
  gather_tile(offsets, packed, p.tiles, per, t, slices, seg_pre, seg_lo, reinterpret_cast<int32_t*>(spare), entries,
              [&](Word x, bool valid) { count_entry(cnt, x, valid, lane, p); });
  const uint32_t hits = repro::block_scan(cnt, count, spare);  // syncs
  if (threadIdx.x == 0) span = atomicAdd(head + kCursor, static_cast<unsigned long long>(hits));
  __syncthreads();
  const bool in_shared = kShared && hits <= kSharedHits;
  // cnt[c] becomes the end of cell c's bucket, and so the start of c + 1's
  auto place = [&](uint32_t* mine) {
    gather_tile(offsets, packed, p.tiles, per, t, slices, seg_pre, seg_lo, reinterpret_cast<int32_t*>(spare),
                entries, [&](Word x, bool valid) {
                  place_entry(mine, x, valid, lane, p, [&](uint32_t c, uint32_t k) { return atomicAdd(cnt + c, k); });
                });
  };
  // every cell of the tile, the tables read and written whole: (l, lc)
  // becomes a cell's new pair, or a long bucket is listed for the
  // cooperative launch, which writes the cell after this pass
  auto elect = [&](const uint32_t* mine) {
    for (int c = threadIdx.x; c < count; c += blockDim.x) {
      const uint32_t end = cnt[c], start = c > 0 ? cnt[c - 1] : 0u, len = end - start;
      int32_t l = labels[first_cell + c], lc = votes[first_cell + c];
      if (len > kThreadHits) {
        list_cell(head, warp_list, block_list, static_cast<long long>(span + start), first_cell + c, len);
        listed = 1;
      } else if (len > 0) {
        absorb(l, lc, thread_best(len, [&](uint32_t i) { return mine[start + i]; }), len, &l, &lc);
      }
      out_l[first_cell + c] = l;
      out_c[first_cell + c] = lc;
    }
  };
  if (in_shared) {
    place(shared_bucket);
    elect(shared_bucket);
  } else {
    place(bucket + span);
    elect(bucket + span);
  }
  // the listed cells' hits, for the cooperative launch
  __syncthreads();
  if (in_shared && listed)
    for (uint32_t i = threadIdx.x; i < hits; i += blockDim.x) bucket[span + i] = shared_bucket[i];
}

// Count `v` (`add` times) in an open-addressing table of mask + 1 slots
// (keys: (1 << 32) | value, 0 free).  With `fill`, a claim past
// `fill_limit` slots sets *overflow, and no new slot is claimed after it.
__device__ __forceinline__ void tally(unsigned long long* keys, uint32_t* counts, uint32_t mask, int bits,
                                      uint32_t v, uint32_t add, int* fill, int fill_limit, volatile int* overflow) {
  const unsigned long long tag = (1ull << 32) | v;
  uint32_t s = (v * kSlotHash) >> (32 - bits);
  for (;;) {
    unsigned long long k = *reinterpret_cast<volatile unsigned long long*>(keys + s);
    if (k == 0ull) {
      if (fill != nullptr && *overflow) return;
      k = atomicCAS(keys + s, 0ull, tag);
      if (k == 0ull) {
        k = tag;
        if (fill != nullptr && atomicAdd(fill, 1) >= fill_limit) *overflow = 1;
      }
    }
    if (k == tag) {
      atomicAdd(counts + s, add);
      return;
    }
    s = (s + 1u) & mask;
  }
}

// The best (count, value) key of a table's slots [lo, hi) in steps of `step`.
__device__ __forceinline__ unsigned long long table_best(const unsigned long long* keys, const uint32_t* counts,
                                                         int lo, int hi, int step) {
  unsigned long long best = 0ull;
  for (int s = lo; s < hi; s += step) {
    const unsigned long long k = keys[s];
    if (k != 0ull) {
      const unsigned long long b = ballot_key(counts[s], static_cast<uint32_t>(k));
      best = b > best ? b : best;
    }
  }
  return best;
}

// The table's slots for a bucket of `len` hits: twice as many, a power of
// two in [64, cap]; returns log2 of them.
__device__ __forceinline__ int slot_bits(int len, int cap) {
  int bits = 6;
  while ((1 << bits) < 2 * len && (1 << bits) < cap) ++bits;
  return bits;
}

// 3. the listed cells (see the top): block_list a block each, then
// warp_list a warp each.
__global__ void __launch_bounds__(kThreads)
vote_cooperative_kernel(const uint32_t* __restrict__ bucket, const int32_t* __restrict__ labels,
                        const int32_t* __restrict__ votes, int32_t* __restrict__ out_l, int32_t* __restrict__ out_c,
                        const Listed* __restrict__ warp_list, const Listed* __restrict__ block_list,
                        unsigned long long* __restrict__ head) {
  extern __shared__ unsigned long long table[];  // 8 + 4 bytes a slot: kBlockSlots, or kWarpSlots a warp
  __shared__ unsigned long long claim, best;
  __shared__ int fill, overflow;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long block_cells = head[kBlockCells], warp_cells = head[kWarpCells];
  for (;;) {
    if (threadIdx.x == 0) claim = atomicAdd(head + kBlockClaim, 1ull);
    __syncthreads();
    const unsigned long long i = claim;
    if (i >= block_cells) break;
    const Listed cell = block_list[i];
    const int bits = slot_bits(cell.len, kBlockSlots);
    const int slots = 1 << bits;
    unsigned long long* keys = table;
    uint32_t* counts = reinterpret_cast<uint32_t*>(table + slots);
    if (threadIdx.x == 0) best = 0ull;
    unsigned long long lo = 0ull, width = kRange;
    while (lo < kRange) {
      for (int s = threadIdx.x; s < slots; s += blockDim.x) {
        keys[s] = 0ull;
        counts[s] = 0u;
      }
      if (threadIdx.x == 0) fill = overflow = 0;
      __syncthreads();
      for (long long j0 = 0; j0 < cell.len; j0 += blockDim.x) {
        const long long j = j0 + threadIdx.x;
        const uint32_t v = j < cell.len ? bucket[cell.start + j] : 0u;
        const bool in = j < cell.len && static_cast<unsigned long long>(v * kRangeHash) - lo < width;
        const uint32_t peers = __match_any_sync(kFull, in ? static_cast<unsigned long long>(v) : kNone);
        if (in && (peers & lane_mask_lt()) == 0)
          tally(keys, counts, slots - 1, bits, v, __popc(peers), &fill, slots / 2, &overflow);
      }
      __syncthreads();
      const bool over = overflow;
      if (!over) {
        const unsigned long long b = warp_max(table_best(keys, counts, threadIdx.x, slots, blockDim.x));
        if (lane == 0) atomicMax(&best, b);
      }
      __syncthreads();
      if (over) {
        width >>= 1;  // a range of one hash value holds one value
      } else {
        lo += width;
        width = width << 1 < kRange ? width << 1 : kRange;
      }
    }
    if (threadIdx.x == 0)
      absorb(labels[cell.cell], votes[cell.cell], best, static_cast<uint32_t>(cell.len), out_l + cell.cell,
             out_c + cell.cell);
    __syncthreads();
  }
  unsigned long long* keys = table + warp * kWarpSlots;
  uint32_t* counts = reinterpret_cast<uint32_t*>(table + kWarps * kWarpSlots) + warp * kWarpSlots;
  for (;;) {
    unsigned long long i = 0ull;
    if (lane == 0) i = atomicAdd(head + kWarpClaim, 1ull);
    i = __shfl_sync(kFull, i, 0);
    if (i >= warp_cells) break;
    const Listed cell = warp_list[i];
    const int bits = slot_bits(cell.len, kWarpSlots);
    const int slots = 1 << bits;
    for (int s = lane; s < slots; s += 32) {
      keys[s] = 0ull;
      counts[s] = 0u;
    }
    __syncwarp();
    for (int j0 = 0; j0 < cell.len; j0 += 32) {
      const int j = j0 + lane;
      const uint32_t v = j < cell.len ? bucket[cell.start + j] : 0u;
      const uint32_t peers = __match_any_sync(kFull, j < cell.len ? static_cast<unsigned long long>(v) : kNone);
      if (j < cell.len && (peers & lane_mask_lt()) == 0)
        tally(keys, counts, slots - 1, bits, v, __popc(peers), nullptr, 0, nullptr);
    }
    __syncwarp();
    const unsigned long long b = warp_max(table_best(keys, counts, lane, slots, 32));
    if (lane == 0)
      absorb(labels[cell.cell], votes[cell.cell], b, static_cast<uint32_t>(cell.len), out_l + cell.cell,
             out_c + cell.cell);
    __syncwarp();
  }
}

// The first two launches, for entries of type Word: the partition and the
// tile pass.
template <typename Word>
cudaError_t launch_passes(const void* keys, const void* items, long long n, int per, int slices, int tiles,
                          bool shared, const VotePlan& p, void* offsets, void* packed, void* bucket,
                          void* global_counts, const void* labels, const void* votes, void* out_l, void* out_c,
                          void* warp_list, void* block_list, void* head, long long part_bytes, long long tile_bytes,
                          cudaStream_t st) {
  auto tile_pass = shared ? vote_tile_kernel<true, Word> : vote_tile_kernel<false, Word>;
  static int allowed_partition[repro::kMaxDevices], allowed_tile[2][repro::kMaxDevices];
  cudaError_t err;
  if ((err = repro::allow_shared(vote_partition_kernel<Word>, part_bytes, allowed_partition)) != cudaSuccess ||
      (err = repro::allow_shared(tile_pass, tile_bytes, allowed_tile[shared])) != cudaSuccess)
    return err;
  auto* o = static_cast<int32_t*>(offsets);
  auto* words = static_cast<Word*>(packed);
  auto* hd = static_cast<unsigned long long*>(head);
  const bool vec = ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(items)) & 15u) == 0;
  vote_partition_kernel<Word><<<slices, kThreads, part_bytes, st>>>(static_cast<const int32_t*>(keys),
                                                                    static_cast<const uint32_t*>(items), n, per, vec,
                                                                    p, o, words, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tile_pass<<<tiles, kThreads, tile_bytes, st>>>(
      p, slices, per, o, words, static_cast<uint32_t*>(global_counts), static_cast<uint32_t*>(bucket),
      static_cast<const int32_t*>(labels), static_cast<const int32_t*>(votes), static_cast<int32_t*>(out_l),
      static_cast<int32_t*>(out_c), static_cast<Listed*>(warp_list), static_cast<Listed*>(block_list), hd);
  return cudaGetLastError();
}

}  // namespace

// labels, votes: the (B, d, w) int32 tables, read only; out_l, out_c: the
// new tables, uninitialised; keys, items: (n,) int32.  The plan is the
// wrapper's (cm_vote.py::vote_plan): tiles of 2^tile_shift whole rows,
// counted in shared memory where `shared`; slices of `per` entries (a
// multiple of 4); `blocks` blocks for the cooperative launch.  Scratch
// (cm_vote.py::vote_layout), each region from a 16-byte boundary: offsets
// (slices * (tiles + 1) int32), packed (per * slices uint64), bucket (n * d
// uint32), the two lists (Listed records; at most n * d / (kThreadHits + 1)
// and n * d / (kWarpHits + 1) cells), global_counts (B * d * w uint32, where
// not `shared`); head: kHeadWords uint64, zeroed on the card.
extern "C" int cm_vote_launch(const void* labels, const void* votes, void* out_l, void* out_c, const void* keys,
                              const void* items, long long n, int rows, int depth, int width,
                              unsigned long long seed, int log2_width, int tile_shift, int tiles, int shared, int per,
                              int slices, int blocks, void* offsets, void* packed, void* bucket, void* warp_list,
                              void* block_list, void* global_counts, void* head, void* stream) {
  const long long cells = static_cast<long long>(depth) * width;
  const long long tile_cells = cells << tile_shift;
  if (n <= 0 || rows <= 0 || depth <= 0 || width <= 0 || tiles <= 0 || tile_shift < 0 || tile_shift > 30 ||
      static_cast<long long>(tiles) << tile_shift < rows || static_cast<long long>(tiles - 1) << tile_shift >= rows ||
      rows * cells >= (1LL << 31) || n >= (1LL << 31) || n * depth >= (1LL << 32) || per <= 0 || per % 4 ||
      slices <= 0 || static_cast<long long>(per) * slices < n || blocks <= 0 ||
      (log2_width >= 0 && (1LL << log2_width) != width) || (!shared && global_counts == nullptr) ||
      ((reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(warp_list) |
        reinterpret_cast<uintptr_t>(block_list) | reinterpret_cast<uintptr_t>(head)) &
       15u))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const VotePlan p{rows, depth, static_cast<int>(cells), static_cast<uint32_t>(width), log2_width, tile_shift,
                   tiles, static_cast<uint64_t>(seed)};
  constexpr long long kWord = sizeof(int32_t);
  // an entry: the item alone where a tile is one row, else the row too
  const bool wide = tile_shift > 0;
  const long long part_bytes = (tiles + 4LL) / 4 * 4 * kWord + per * (wide ? 8LL : 4LL);
  const long long tile_bytes =
      ((shared ? (tile_cells + 3) / 4 * 4 + kSharedHits : 0) + 2LL * kSegChunk + 4) * kWord;
  const long long coop_bytes = 12LL * kBlockSlots;
  static_assert(12LL * kBlockSlots == 12LL * kWarps * kWarpSlots, "the block's table is the warps' tables");
  static int allowed_coop[repro::kMaxDevices];
  cudaError_t err = repro::allow_shared(vote_cooperative_kernel, coop_bytes, allowed_coop);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = wide ? launch_passes<unsigned long long>(keys, items, n, per, slices, tiles, shared != 0, p, offsets, packed,
                                                 bucket, global_counts, labels, votes, out_l, out_c, warp_list,
                                                 block_list, head, part_bytes, tile_bytes, st)
             : launch_passes<uint32_t>(keys, items, n, per, slices, tiles, shared != 0, p, offsets, packed, bucket,
                                       global_counts, labels, votes, out_l, out_c, warp_list, block_list, head,
                                       part_bytes, tile_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* b = static_cast<uint32_t*>(bucket);
  const auto* l = static_cast<const int32_t*>(labels);
  const auto* c = static_cast<const int32_t*>(votes);
  auto* nl = static_cast<int32_t*>(out_l);
  auto* nc = static_cast<int32_t*>(out_c);
  auto* wl = static_cast<Listed*>(warp_list);
  auto* bl = static_cast<Listed*>(block_list);
  auto* hd = static_cast<unsigned long long*>(head);
  vote_cooperative_kernel<<<blocks, kThreads, coop_bytes, st>>>(b, l, c, nl, nc, wl, bl, hd);
  return static_cast<int>(cudaGetLastError());
}
