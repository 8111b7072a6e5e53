// rwkv_intra: RWKV6's intra-chunk quadratic form, one block per cell, with
// two-level chunking.
//
// Replaces the TPU kernel repro/kernels/rwkv_intra.py::rwkv_intra
// (_intra_kernel).  For each of the G = B * NC * H cells (one chunk of one
// head of one sequence) it takes five (C, N) float32 tiles r, k, v, Lex, L
// and the head's (N,) bonus u, and writes the (C, N) float32 output
//
//   A[t,s]  = sum_n r[t,n] k[s,n] exp(Lex[t,n] - L[s,n])     (s < t)
//   diag[t] = sum_n r[t,n] u[n] k[t,n]
//   y[t,n]  = sum_{s<t} A[t,s] v[s,n] + diag[t] v[t,n]
//
// Domain: log-decays <= 0 (rwkv6's log_w = -exp(.)), so L does not increase
// along the chunk and Lex[t] = L[t-1] (up to rounding).  Every caller in
// the port meets it.
//
// Two-level chunking (Yang et al., "Gated Linear Attention Transformers
// with Hardware-Efficient Training", arXiv:2312.06635, sec. 4): the C rows
// split into sub-chunks of S = 8: the diagonal blocks' pairwise exps grow
// with S (a 16-row block takes 2.1x those of two 8-row ones).
//   * A diagonal S x S sub-block keeps the pairwise exp(Lex[t] - L[s]).
//   * An off-diagonal sub-block (i > j) factors through e = the last row
//     of sub-chunk j and b = S*i - 1, the row before sub-chunk i (b = e
//     when i = j + 1):
//       exp(Lex[t] - L[s]) = exp(Lex[t] - L[b]) * exp(L[b] - L[e]) * exp(L[e] - L[s])
//     so A[t,s] = sum_n r'[t,n] D_ij[n] k'[s,n] with
//       r'[t,n]  = r[t,n] exp(Lex[t,n] - L[b,n])   (t in sub-chunk i),
//       k'[s,n]  = k[s,n] exp(L[e,n] - L[s,n])     (s in sub-chunk j),
//       D_ij[n]  = exp(L[b,n] - L[e,n]),
//     each formed once, in place, and the sub-block is a small dense
//     product.  t > b >= e >= s, so all three exponents are <= 0: no factor
//     exceeds 1, none overflows even at decay scale 50, and where one
//     underflows the true product is smaller still.  The pairwise exp is
//     never factored across the whole chunk (exp(-L) alone overflows).
// At C = N = 64 this takes 23,296 exps a cell against 129 K pairwise.
//
// Work is assigned to the lower triangle only:
//   0. cp.async copies r, k, Lex, L and u into shared memory (16-byte
//      copies where rows are 16-byte aligned).  A row is N rounded up to
//      32 floats, its 16-byte chunks XOR-swizzled by the row's low 3 bits,
//      so 16-byte loads of 8 lanes at 8 rows hit distinct banks; padding
//      rows and columns are 0.
//   1. the strict lower triangles of the diagonal sub-blocks: the rows of
//      a block fold in pairs, (1, 7), (2, 6), (3, 5), and the row-4 halves
//      of two blocks, into 28 tasks of 8 pairs, each on 8 lanes that split
//      n and add by shuffles, so every exp taken is needed.  The bonus at
//      s = t is a separate, exp-free sum.  The sums wait in registers.
//   2. r', k' and D in place.  Then v is copied into L's place, under
//      phase 3.
//   3. the sums of 1 and the off-diagonal sub-blocks, 2 x 4 register tiles
//      of a dense product, go to A^T, which takes Lex's place.
//   4. y = A v: a thread owns 4 columns of rows {2a, 2a+1, CP-2-2a,
//      CP-1-2a} (CP = C rounded up to 8), so every thread runs the same
//      number of multiply-adds over the triangle; stores are coalesced.
// Everything is float32: the tensor cores' TF32 keeps ~3 digits and would
// miss rtol 1e-5.
//
// Bound on the H100, at the serve shape (G = 5120, C = N = 64): bytes --
// 5 inputs and the output of G*C*N*4 bytes and u, 504.6 MB, 0.151 ms at
// 3.35 TB/s -- above the float32 operations (~4.1 GFLOP, 0.061 ms at
// 67 TFLOP/s).  Shared memory at C = N = 64 is 72,960 bytes, so three
// blocks (24 warps) share an SM.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;
constexpr int kMaxN = 64;
constexpr int S = 8;  // sub-chunk rows
constexpr int G = S / 4;  // 4-column groups of a sub-block row

struct Dims {
  int c, n;     // the cell's rows and columns
  int cp;       // c rounded up to S
  int n4;       // n rounded up to 4, in float4 units
  int np;       // row stride of the tiles, floats: n rounded up to 32
  int ats;      // row stride of A^T, floats
  int lex_rows; // floats of the Lex / A^T region
  int pairs;    // off-diagonal sub-block pairs
};

__host__ __device__ inline Dims dims(int c, int n) {
  Dims d;
  d.c = c;
  d.n = n;
  d.cp = (c + S - 1) / S * S;
  d.n4 = (n + 3) / 4;
  d.np = (n + 31) / 32 * 32;
  d.ats = d.cp;
  const int ns = d.cp / S;
  d.pairs = ns * (ns - 1) / 2;
  d.lex_rows = d.cp * (d.np > d.ats ? d.np : d.ats);
  return d;
}

__host__ __device__ inline size_t shared_floats(const Dims& d) {
  return static_cast<size_t>(3 * d.cp * d.np + d.lex_rows + d.pairs * 4 * d.n4 + 4 * d.n4);
}

// Float offset of chunk j (4 floats) of a tile row: chunks XOR-swizzled by
// the row's low 3 bits (np is a multiple of 8 chunks).
__device__ __forceinline__ int at4(const Dims& d, int row, int j) { return row * d.np + 4 * (j ^ (row & 7)); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Copy a (c, n) tile at src into swizzled shared rows, zeroing the padding
// columns [n, 4 n4) and rows [c, cp).
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, const Dims& d,
                                          bool vec) {
  if (vec) {
    const int q = d.n / 4;  // n % 4 == 0 here
    for (int i = threadIdx.x; i < d.c * q; i += kThreads) cp_async16(dst + at4(d, i / q, i % q), src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < d.c * d.n; i += kThreads) {
      const int row = i / d.n, col = i % d.n;
      cp_async4(dst + at4(d, row, col / 4) + col % 4, src + i);
    }
  }
  const int w = 4 * d.n4;
  for (int i = threadIdx.x; i < d.cp * w; i += kThreads) {
    const int row = i / w, col = i % w;
    if (row >= d.c || col >= d.n) dst[at4(d, row, col / 4) + col % 4] = 0.0f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// sum over the 4 components of r * k * exp(lex - l)
__device__ __forceinline__ float pair4(float4 r, float4 k, float4 lex, float4 l, float acc) {
  acc = fmaf(r.x * k.x, __expf(lex.x - l.x), acc);
  acc = fmaf(r.y * k.y, __expf(lex.y - l.y), acc);
  acc = fmaf(r.z * k.z, __expf(lex.z - l.z), acc);
  return fmaf(r.w * k.w, __expf(lex.w - l.w), acc);
}

__device__ __forceinline__ float4 exp_scale(float4 x, float4 a, float4 b) {
  return make_float4(x.x * __expf(a.x - b.x), x.y * __expf(a.y - b.y), x.z * __expf(a.z - b.z),
                     x.w * __expf(a.w - b.w));
}

__global__ void __launch_bounds__(kThreads, 3)
rwkv_intra_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ lex,
                  const float* __restrict__ lcum, const float* __restrict__ u,
                  float* __restrict__ y, int c, int n, bool vec) {
  const Dims d = dims(c, n);
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;
  float* sk = sr + d.cp * d.np;
  float* sl = sk + d.cp * d.np;    // L, then v
  float* slex = sl + d.cp * d.np;  // Lex, then A^T: at[s * ats + t] = A[t, s]
  float* sd = slex + d.lex_rows;   // D_ij, pair p = i (i - 1) / 2 + j
  float* su = sd + d.pairs * 4 * d.n4;
  float* at = slex;

  const long long cell = blockIdx.x;
  const long long base = cell * c * n;
  // 0. copies of what phases 1 and 2 read
  load_tile(sr, r + base, d, vec);
  load_tile(sk, k + base, d, vec);
  load_tile(slex, lex + base, d, vec);
  load_tile(sl, lcum + base, d, vec);
  for (int i = threadIdx.x; i < 4 * d.n4; i += kThreads) {
    if (i < n) cp_async4(su + i, u + cell * n + i);
    else su[i] = 0.0f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 1. the strict lower triangles of the diagonal sub-blocks, exps
  // pairwise.  The rows of a block fold into 8 pairs each, (1, 7), (2, 6)
  // and (3, 5), and the row-4 halves of blocks 2i and 2i + 1 into one
  // more: 28 tasks of 8 pairs cover the 8 blocks x 28 = 224 pairs.  A
  // task's slot q < split is (rowA, sA + q), the others (rowB, sB + q - split).
  const int ns = d.cp / S;
  constexpr int kSlots = 8;
  constexpr int kParts = 8;  // lanes sharing a task, each a slice of n
  const int task = threadIdx.x / kParts, part = threadIdx.x % kParts;
  int rowA = 0, rowB = 0, sA = 0, sB = 0, split = 4;
  bool okA = false, okB = false;
  if (task < 24) {
    const int blk = task / 3, f = task % 3 + 1;
    rowA = blk * 8 + f, rowB = blk * 8 + 8 - f, sA = sB = blk * 8, split = f;
    okA = okB = blk < ns;
  } else if (task < 28) {
    const int blk = 2 * (task - 24);
    rowA = blk * 8 + 4, sA = blk * 8, rowB = rowA + 8, sB = sA + 8;
    okA = blk < ns, okB = blk + 1 < ns;
  }
  if (!okB) rowB = rowA, sB = sA;  // reads stay in the tile; nothing is written
  float acc[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) acc[q] = 0.0f;
  if (okA || okB) {
    for (int j = part; j < d.n4; j += kParts) {
      const float4 ra = ld4(sr + at4(d, rowA, j)), xa = ld4(slex + at4(d, rowA, j));
      const float4 rb = ld4(sr + at4(d, rowB, j)), xb = ld4(slex + at4(d, rowB, j));
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const bool first = q < split;
        const int s = first ? sA + q : sB + q - split;
        acc[q] = pair4(first ? ra : rb, ld4(sk + at4(d, s, j)), first ? xa : xb, ld4(sl + at4(d, s, j)), acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kSlots; ++q)
    for (int m = 1; m < kParts; m <<= 1) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], m);
  // the diagonal, exp-free: bonus[t] = sum_n r[t,n] u[n] k[t,n], 4 lanes a row
  const int bt = threadIdx.x / 4, bp = threadIdx.x % 4;
  float bonus = 0.0f;
  if (bt < c) {
    for (int j = bp; j < d.n4; j += 4) {
      const float4 rv = ld4(sr + at4(d, bt, j)), kv = ld4(sk + at4(d, bt, j)), uv = ld4(su + 4 * j);
      bonus = dot4(make_float4(rv.x * uv.x, rv.y * uv.y, rv.z * uv.z, rv.w * uv.w), kv, bonus);
    }
  }
  bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
  bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
  __syncthreads();

  // 2. r', k' and D in place (rows past c stay 0)
  for (int i = threadIdx.x; i < (c - S > 0 ? c - S : 0) * d.n4; i += kThreads) {
    const int row = S + i / d.n4, j = i % d.n4;
    const int b = row / S * S - 1;
    float* p = sr + at4(d, row, j);
    *reinterpret_cast<float4*>(p) = exp_scale(ld4(p), ld4(slex + at4(d, row, j)), ld4(sl + at4(d, b, j)));
  }
  for (int i = threadIdx.x; i < (ns - 1) * S * d.n4; i += kThreads) {
    const int row = i / d.n4, j = i % d.n4;
    const int e = row / S * S + S - 1;
    float* p = sk + at4(d, row, j);
    *reinterpret_cast<float4*>(p) = exp_scale(ld4(p), ld4(sl + at4(d, e, j)), ld4(sl + at4(d, row, j)));
  }
  for (int i = threadIdx.x; i < d.pairs * d.n4; i += kThreads) {
    const int pr = i / d.n4, j = i % d.n4;
    int bi = 1;
    while ((bi + 1) * bi / 2 <= pr) ++bi;
    const int bj = pr - bi * (bi - 1) / 2;
    const float4 one = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    *reinterpret_cast<float4*>(sd + 4 * i) =
        exp_scale(one, ld4(sl + at4(d, bi * S - 1, j)), ld4(sl + at4(d, bj * S + S - 1, j)));
  }
  __syncthreads();
  load_tile(sl, v + base, d, vec);  // L is spent: v, under phase 3
  cp_async_commit();

  // 3. A^T: the sums of 1 -- the strict lower triangles, the diagonal and,
  // for phase 4, zeros just above it -- then the off-diagonal products
  if (part == 0) {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const bool first = q < split;
      const int t = first ? rowA : rowB, s = first ? sA + q : sB + q - split;
      if ((first ? okA : okB) && s < t) at[s * d.ats + t] = t < c ? acc[q] : 0.0f;
    }
  }
  if (bp == 0 && bt < d.cp) {
    at[bt * d.ats + bt] = bonus;
    if (bt + 1 < d.cp) at[(bt + 1) * d.ats + bt] = 0.0f;
  }
  constexpr int kTiles = (S / 2) * G;  // 2 x 4 tiles of a sub-block
  for (int task = threadIdx.x; task < d.pairs * kTiles; task += kThreads) {
    const int pr = task / kTiles, mt = task % kTiles;
    int bi = 1;
    while ((bi + 1) * bi / 2 <= pr) ++bi;
    const int bj = pr - bi * (bi - 1) / 2;
    const int t0 = bi * S + 2 * (mt / G);
    const int u0 = bj * S + 4 * (mt % G);
    float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    const float* dp = sd + pr * 4 * d.n4;
    for (int j = 0; j < d.n4; ++j) {
      const float4 dv = ld4(dp + 4 * j);
      float4 a0 = ld4(sr + at4(d, t0, j)), a1 = ld4(sr + at4(d, t0 + 1, j));
      a0 = make_float4(a0.x * dv.x, a0.y * dv.y, a0.z * dv.z, a0.w * dv.w);
      a1 = make_float4(a1.x * dv.x, a1.y * dv.y, a1.z * dv.z, a1.w * dv.w);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b = ld4(sk + at4(d, u0 + q, j));
        o[0][q] = dot4(a0, b, o[0][q]);
        o[1][q] = dot4(a1, b, o[1][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      at[(u0 + q) * d.ats + t0] = o[0][q];
      at[(u0 + q) * d.ats + t0 + 1] = o[1][q];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. y = A v over s <= t: rows {2a, 2a+1} and {cp-2-2a, cp-1-2a}, columns 4 ng ..
  const int a = threadIdx.x / 16, ng = threadIdx.x % 16;
  if (a < d.cp / 4 && ng < d.n4) {
    const int lo = 2 * a, hi = d.cp - 2 - 2 * a;
    float4 y0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), y1 = y0, y2 = y0, y3 = y0;
    const int end1 = min(lo + 2, c), end2 = min(hi + 2, c);
    int s = 0;
    for (; s < end1; ++s) {
      const float4 vv = ld4(sl + at4(d, s, ng));
      const float2 al = *reinterpret_cast<const float2*>(at + s * d.ats + lo);
      const float2 ah = *reinterpret_cast<const float2*>(at + s * d.ats + hi);
      y0 = make_float4(fmaf(al.x, vv.x, y0.x), fmaf(al.x, vv.y, y0.y), fmaf(al.x, vv.z, y0.z), fmaf(al.x, vv.w, y0.w));
      y1 = make_float4(fmaf(al.y, vv.x, y1.x), fmaf(al.y, vv.y, y1.y), fmaf(al.y, vv.z, y1.z), fmaf(al.y, vv.w, y1.w));
      y2 = make_float4(fmaf(ah.x, vv.x, y2.x), fmaf(ah.x, vv.y, y2.y), fmaf(ah.x, vv.z, y2.z), fmaf(ah.x, vv.w, y2.w));
      y3 = make_float4(fmaf(ah.y, vv.x, y3.x), fmaf(ah.y, vv.y, y3.y), fmaf(ah.y, vv.z, y3.z), fmaf(ah.y, vv.w, y3.w));
    }
    for (; s < end2; ++s) {
      const float4 vv = ld4(sl + at4(d, s, ng));
      const float2 ah = *reinterpret_cast<const float2*>(at + s * d.ats + hi);
      y2 = make_float4(fmaf(ah.x, vv.x, y2.x), fmaf(ah.x, vv.y, y2.y), fmaf(ah.x, vv.z, y2.z), fmaf(ah.x, vv.w, y2.w));
      y3 = make_float4(fmaf(ah.y, vv.x, y3.x), fmaf(ah.y, vv.y, y3.y), fmaf(ah.y, vv.z, y3.z), fmaf(ah.y, vv.w, y3.w));
    }
    const int rows[4] = {lo, lo + 1, hi, hi + 1};
    const float4 out[4] = {y0, y1, y2, y3};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (rows[q] >= c) continue;
      float* dst = y + base + static_cast<long long>(rows[q]) * n + 4 * ng;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = out[q];
      } else {
        const float o4[4] = {out[q].x, out[q].y, out[q].z, out[q].w};
        for (int j = 0; j < 4 && 4 * ng + j < n; ++j) dst[j] = o4[j];
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// r, k, v, lex, lcum, y: (G, C, N) float32, contiguous; u: (G, N) float32.
// 1 <= C <= 64 and 1 <= N <= 64 (the wrapper checks both).
extern "C" int rwkv_intra_launch(const void* r, const void* k, const void* v,
                                 const void* lex, const void* lcum, const void* u,
                                 void* y, long long g, int c, int n, void* stream) {
  if (c < 1 || c > kMaxC || n < 1 || n > kMaxN || g < 0 || g > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g == 0) return static_cast<int>(cudaSuccess);
  const bool vec = n % 4 == 0 && aligned16(r) && aligned16(k) && aligned16(v) && aligned16(lex) &&
                   aligned16(lcum) && aligned16(u) && aligned16(y);
  const size_t bytes = shared_floats(dims(c, n)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rwkv_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared_floats(dims(kMaxC, kMaxN)) * sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv_intra_kernel<<<static_cast<unsigned>(g), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(lex), static_cast<const float*>(lcum), static_cast<const float*>(u),
      static_cast<float*>(y), c, n, vec);
  return static_cast<int>(cudaGetLastError());
}
