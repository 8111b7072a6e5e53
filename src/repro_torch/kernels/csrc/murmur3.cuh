// Murmur3 of one 32-bit item, split into (bucket index, rank), on the card.
//
// Shared by hash_rank.cu and hll_fused.cu so both kernels hash identically.
// Bit-exact with repro/sketch/murmur3.py and repro/sketch/hll.py's
// hash_index_rank: Murmur3_x86_32 with the seed truncated to 32 bits, or h1
// of Murmur3_x64_128 with both h1 and h2 seeded by the full 64-bit seed.
// Hopper has native 64-bit integers, so the reference's uint32-limb
// arithmetic (a TPU workaround) becomes plain uint64_t math: a uint64_t
// multiply wraps modulo 2^64, and __clz/__clzll count leading zeros.
#pragma once

#include <cstdint>

namespace repro {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDull;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ull;
  return k ^ (k >> 33);
}

// Murmur3_x86_32 of a 4-byte little-endian key.
__device__ __forceinline__ uint32_t murmur3_32(uint32_t key, uint32_t seed) {
  uint32_t k = key * 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  uint32_t h = seed ^ k;
  h = rotl32(h, 13);
  h = h * 5u + 0xE6546B64u;
  return fmix32(h ^ 4u);  // no tail; finalize with len = 4
}

// h1 of Murmur3_x64_128 of a 4-byte key (the tail path, len = 4).
__device__ __forceinline__ uint64_t murmur3_64(uint32_t key, uint64_t seed) {
  uint64_t k1 = static_cast<uint64_t>(key) * 0x87C37B91114253D5ull;
  k1 = rotl64(k1, 31);
  k1 *= 0x4CF5AD432745937Full;
  uint64_t h1 = (seed ^ k1) ^ 4ull;
  uint64_t h2 = seed ^ 4ull;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  return h1 + h2;
}

// idx = the top p bits of the hash; rank = leading zeros of the remaining
// H - p bits, plus 1, capped at H - p + 1 when they are all zero.
// p is in [4, 16], so no shift here reaches the word width.
__device__ __forceinline__ void index_rank(uint32_t item, int p, int hash_bits,
                                           uint64_t seed, int& idx, int& rank) {
  if (hash_bits == 32) {
    const uint32_t h = murmur3_32(item, static_cast<uint32_t>(seed));
    idx = static_cast<int>(h >> (32 - p));
    rank = min(__clz(static_cast<int>(h << p)), 32 - p) + 1;  // __clz(0) = 32
  } else {
    const uint64_t h = murmur3_64(item, seed);
    idx = static_cast<int>(h >> (64 - p));
    rank = min(__clzll(static_cast<long long>(h << p)), 64 - p) + 1;
  }
}

}  // namespace repro
