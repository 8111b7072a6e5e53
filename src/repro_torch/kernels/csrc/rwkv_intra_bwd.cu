// rwkv_intra_bwd: the gradient of RWKV6's intra-chunk quadratic form, one
// block per cell, with two-level chunking.
//
// The reference has no Pallas backward: its RWKV6 differentiates the inline
// chunk math of repro/models/rwkv6.py::time_mix_chunked with jax.grad.  The
// port's forward is the rwkv_intra kernel (rwkv_intra.cu), so its gradient
// is this kernel.  For each of the G cells (one chunk of one head of one
// sequence), given the forward's (C, N) float32 tiles r, k, v, Lex, L, the
// (N,) bonus u and the output's gradient dy, with
// E[t,s,n] = exp(Lex[t,n] - L[s,n]) for s < t:
//
//   A[t,s]    = sum_n r[t,n] k[s,n] E[t,s,n]           (s < t; recomputed)
//   diag[t]   = sum_n r[t,n] u[n] k[t,n]
//   dA[t,s]   = sum_j dy[t,j] v[s,j]                   (s < t)
//   ddiag[t]  = sum_j dy[t,j] v[t,j]
//   dv[s,j]   = sum_{t>s} A[t,s] dy[t,j] + diag[s] dy[s,j]
//   P[t,n]    = sum_{s<t} dA[t,s] k[s,n] E[t,s,n]
//   Q[s,n]    = sum_{t>s} dA[t,s] r[t,n] E[t,s,n]
//   dr[t,n]   = P[t,n] + ddiag[t] u[n] k[t,n]
//   dk[s,n]   = Q[s,n] + ddiag[s] u[n] r[s,n]
//   dLex[t,n] = r[t,n] P[t,n]
//   dL[s,n]   = -k[s,n] Q[s,n]
//   du[n]     = sum_t ddiag[t] r[t,n] k[t,n]          (per cell)
//
// du is written once per cell: the caller's bonus is one (N,) vector per
// head, expanded over the cells, and autograd sums the cells' du over that
// expansion -- no float atomics, so the result is deterministic.  Domain:
// the forward's, 1 <= C, N <= 64 and log-decays <= 0.
//
// Two-level chunking, as the forward (GLA, arXiv:2312.06635, sec. 4): the C
// rows split into sub-chunks of S = 8.  Diagonal sub-blocks keep the
// pairwise exp; an off-diagonal one (i > j) factors it through e, the last
// row of sub-chunk j, and b = S*i - 1, the row before sub-chunk i:
//   E[t,s,n] = alpha[t,n] D_ij[n] beta[s,n],
//   alpha[t,n] = exp(Lex[t,n] - L[b,n]), beta[s,n] = exp(L[e,n] - L[s,n]),
//   D_ij[n]    = exp(L[b,n] - L[e,n]),
// every exponent <= 0 (t > b >= e >= s), so no factor overflows however
// strong the decay, and where one underflows the true product is smaller
// still.  (Lex = L - log_w is rounded once, so a Lex-side exponent may sit
// one ulp of |Lex| above 0: its exp is 1 to float32 precision.)  With
// r' = r alpha and k' = k beta:
//   A_ij = r'_i D_ij k'_j^T
//   P_i  = P_i,diag + alpha_i sum_{j<i} dA_ij (k'_j D_ij)
//   Q_j  = Q_j,diag + beta_j  sum_{i>j} dA_ij^T (r'_i D_ij)
// where k'[s] D_ij = k[s] exp(L[b] - L[s]) and r'[t] D_ij = r[t]
// exp(Lex[t] - L[e]) are each one exp, taken where P and Q use them, while
// Lex and L are still whole.  The exp is never factored across the whole
// chunk: exp(-L) alone overflows.  At C = N = 64 a cell takes 60 K exps
// (14,336 for the diagonal blocks, each feeding A, P and Q; 2 x 14,336 for
// the P and Q factors; 17,152 for alpha, beta, r', k' and D) against the
// first design's 387 K.
//
// The phases, a block of 256 threads a cell:
//   0. cp.async 16-byte copies (4-byte ones where N % 4 != 0 or a pointer
//      is off 16 bytes) in two groups: v and dy, then r, k, Lex, L and u.
//      Each tile is 64 x 64 in shared memory whatever C and N are (so that
//      every offset is a constant), its rows' 16-byte chunks XOR-swizzled
//      by the row's low 3 bits; past row C and column N it is 0.
//   1. (group 1 only; group 2 lands meanwhile) dA = dy v^T over the
//      sub-blocks i >= j, 4 x 4 register tiles, into a table packed by
//      sub-block (8 x 8 floats each, i (i + 1) / 2 + j), ddiag on its
//      diagonal.  v is spent.
//   2. a warp a sub-chunk i, a lane two columns: the 28 pairs of the
//      diagonal block, each exp used for A, P and Q at once; P and Q wait
//      in registers, A's sums over n and the bonus go through a butterfly
//      of shuffles into the A table (in v's place), zeros above its
//      diagonal; D_ij into a table beside it; du's partial sums.
//   3. the same warps and lanes: P and Q of the off-diagonal blocks (dA
//      rows as broadcast float4s), then dr, dLex, dk and dL, stored
//      coalesced, 16 bytes a lane after a lane-pair exchange of shuffles.
//   4. r' over Lex and k' over L, each lane its own elements; du.
//   5. A of the off-diagonal blocks, 4 x 4 register tiles over n.
//   6. dv = A^T dy: a thread owns 4 columns of rows {2a, 2a+1, CP-2-2a,
//      CP-1-2a} (CP = C rounded up to 8), so every thread runs the same
//      number of multiply-adds over the triangle; 16-byte stores.
// No pairwise index needs a square root: the tasks of phases 1 and 5 walk
// at most 8 sub-block rows to find theirs.  Everything is float32 on the
// CUDA cores: TF32 keeps ~3 digits and would miss the gradients' 1e-5
// bound.  The kernel is templated on the 16-byte path, so that the one the
// card runs carries no scalar code.
//
// Bound on the H100 at the training shape (G = 2 * 16 * 40 cells of
// 64 x 64): bytes -- 6 tiles in and 5 out of G * C * N * 4 bytes and two
// (G, N) vectors, 231.3 MB, 0.0691 ms at 3.35 TB/s -- above the float32
// operations (~1.8 GFLOP of this design's products, 0.027 ms at
// 67 TFLOP/s).  Shared memory is 109,824 bytes a block (5 tiles, the v / A +
// D region, the packed dA table, u and du's partial sums), so two blocks
// (16 warps) share an SM; ptxas: 128 registers, no spills, no stack
// (sm_90a, CUDA 12.8).  What holds it at ~2.1x the bound (NVIDIA H100 80GB
// HBM3, 700 W; tools/intra_bwd_probe.py): the shared-memory loads of the
// products.  A warp's 128-bit load of distinct addresses takes 4 of the
// SM's shared-memory cycles and a broadcast one ~2.4; counted from the
// code, a cell makes ~17 K such cycles, and the arithmetic alone, without
// global traffic, takes ~80 % of the kernel's time.  Split-TF32 mma.sync
// for the dense phases 1, 5 and 6 (one m16n8k8 step as three TF32
// products) kept every gradient within 8e-7 but ran slower, 0.17 ms: three
// dependent products a step on two or three tiles a warp, and spills.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;
constexpr int kMaxN = 64;
constexpr int S = 8;               // sub-chunk rows
constexpr int kNS = kMaxC / S;     // sub-chunks of a full cell
constexpr int kRow = kMaxN;        // floats of a tile row, whatever N is
constexpr int kChunks = kRow / 4;  // 16-byte chunks of a tile row
constexpr int kTile = kMaxC * kRow;
constexpr int kPack = kNS * (kNS + 1) / 2 * S * S;  // a table packed by sub-block i >= j
constexpr int kPairs = kNS * (kNS - 1) / 2;         // off-diagonal sub-blocks i > j
constexpr unsigned kFull = 0xffffffffu;
// The shared layout, floats: r, k, Lex (then r'), L (then k'), dy, v (then
// A packed and D), dA packed, u, du's partial sums a sub-chunk.
constexpr int kR = 0, kK = kTile, kLex = 2 * kTile, kL = 3 * kTile, kDy = 4 * kTile, kV = 5 * kTile;
constexpr int kA = kV, kD = kV + kPack, kDA = kV + kTile, kU = kDA + kPack, kDu = kU + kRow;
constexpr int kShared = kDu + kNS * kRow;
static_assert(kD + kPairs * kRow <= kV + kTile, "A and D fit in v's place");

// sub-block (i, j), j <= i, of a packed table
__device__ __forceinline__ int block_at(int i, int j) { return (i * (i + 1) / 2 + j) * S * S; }

// D_ij, j < i, of the D table
__device__ __forceinline__ int d_at(int i, int j) { return (i * (i - 1) / 2 + j) * kRow; }

// Float offset of chunk j (4 floats) of a tile row: chunks XOR-swizzled by
// the row's low 3 bits.
__device__ __forceinline__ int at4(int row, int j) { return row * kRow + 4 * (j ^ (row & 7)); }

// Float offset of a lane's columns (2 lane, 2 lane + 1) of a tile row.
__device__ __forceinline__ int at2(int row, int lane) {
  return row * kRow + 4 * ((lane >> 1) ^ (row & 7)) + 2 * (lane & 1);
}

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

// Copy a (c, n) tile at src into the swizzled 64 x 64 shared tile, zeros
// past row c and column n: 16-byte copies where kVec (n % 4 == 0 and every
// pointer 16-byte aligned), else 4-byte ones.
template <bool kVec>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int c, int n) {
  if (kVec) {
    for (int i = threadIdx.x; i < kMaxC * kChunks; i += kThreads) {
      const int row = i / kChunks, j = i % kChunks;
      float* p = dst + at4(row, j);
      if (row < c && 4 * j < n) cp_async16(p, src + row * n + 4 * j);
      else *reinterpret_cast<float4*>(p) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int row = i / kRow, col = i % kRow;
      float* p = dst + at4(row, col / 4) + col % 4;
      if (row < c && col < n) cp_async4(p, src + row * n + col);
      else *p = 0.0f;
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// a lane's two columns of a tile row
__device__ __forceinline__ float2 lane2(const float* tile, int row, int lane) { return ld2(tile + at2(row, lane)); }

// c ? a : b on two values already in registers.  Opaque to the compiler,
// which would otherwise load through a selected address and so keep the
// butterfly's array in local memory.
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\tselp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<int>(c)));
  return r;
}

// One step of a butterfly over the lanes: lanes with bit W keep values
// [W, 2W) and the others [0, W), each added to its partner's; after the
// steps 16, 8, 4, 2, 1 lane q holds the sum over the warp of v[q].
template <int W>
__device__ __forceinline__ void fold(float (&v)[36], int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const float lo = v[q], hi = v[q + W];
    v[q] = pick(up, hi, lo) + __shfl_xor_sync(kFull, pick(up, lo, hi), W);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

// Store columns col .. col + 3 of a row of a (c, n) output: one 16-byte
// store where kVec, else the columns below n.
template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ out, int c, int n, int row, int col, float4 q) {
  if (row >= c || col >= n) return;
  float* dst = out + row * n + col;
  if (kVec) {
    *reinterpret_cast<float4*>(dst) = q;
  } else {
    dst[0] = q.x;
    if (col + 1 < n) dst[1] = q.y;
    if (col + 2 < n) dst[2] = q.z;
    if (col + 3 < n) dst[3] = q.w;
  }
}

// Lanes 2m and 2m + 1 hold columns (4m, 4m + 1) and (4m + 2, 4m + 3) of rows
// `row` (a) and `row` + 1 (b): after one exchange the even lane stores the
// first row's 4 columns and the odd lane the second's, 16 bytes each.
template <bool kVec>
__device__ __forceinline__ void store_rows(float* __restrict__ out, int c, int n, int lane, int row, float2 a,
                                           float2 b) {
  const bool odd = lane & 1;
  const float2 send = odd ? a : b;
  const float gx = __shfl_xor_sync(kFull, send.x, 1), gy = __shfl_xor_sync(kFull, send.y, 1);
  const float4 q = odd ? make_float4(gx, gy, b.x, b.y) : make_float4(a.x, a.y, gx, gy);
  store4<kVec>(out, c, n, row + (odd ? 1 : 0), 4 * (lane >> 1), q);
}

// the sub-block row i and column j of a packed table's p-th block (j <= i)
__device__ __forceinline__ void block_of(int p, int& i, int& j) {
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= p) ++i;
  j = p - i * (i + 1) / 2;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
rwkv_intra_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ lex,
                      const float* __restrict__ lcum, const float* __restrict__ u,
                      const float* __restrict__ dy, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dlex, float* __restrict__ dlcum,
                      float* __restrict__ du, int c, int n) {
  extern __shared__ __align__(16) float smem[];
  float* sr = smem + kR;
  float* sk = smem + kK;
  float* sx = smem + kLex;  // Lex, then r'
  float* sl = smem + kL;    // L, then k'
  float* sdy = smem + kDy;
  float* sv = smem + kV;    // v, then A (packed) and D
  float* sa = smem + kA;
  float* sd = smem + kD;
  float* sda = smem + kDA;  // dA (packed), ddiag on its diagonal
  float* su = smem + kU;
  float* sdu = smem + kDu;  // du's partial sums, a row a sub-chunk
  const int ns = (c + S - 1) / S, cp = ns * S;

  const int cell = blockIdx.x;
  const long long base = static_cast<long long>(cell) * c * n;
  r += base, k += base, v += base, lex += base, lcum += base, dy += base;
  dr += base, dk += base, dv += base, dlex += base, dlcum += base;
  // 0. two copy groups: what phase 1 reads, then the rest
  load_tile<kVec>(sv, v, c, n);
  load_tile<kVec>(sdy, dy, c, n);
  cp_async_commit();
  load_tile<kVec>(sr, r, c, n);
  load_tile<kVec>(sk, k, c, n);
  load_tile<kVec>(sx, lex, c, n);
  load_tile<kVec>(sl, lcum, c, n);
  for (int i = threadIdx.x; i < kRow; i += kThreads) {
    if (i < n) cp_async4(su + i, u + static_cast<long long>(cell) * n + i);
    else su[i] = 0.0f;
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // 1. dA = dy v^T over the sub-blocks i >= j, 4 x 4 tiles; the chunk a
  // task starts at turns with its block, against bank conflicts
  for (int task = threadIdx.x; task < ns * (ns + 1) / 2 * 4; task += kThreads) {
    const int p = task >> 2, q = task & 3;
    int bi, bj;
    block_of(p, bi, bj);
    const int t0 = bi * S + 4 * (q >> 1), s0 = bj * S + 4 * (q & 1);
    float o[4][4] = {};
#pragma unroll 2
    for (int it = 0; it < kChunks; ++it) {
      const int j = (p + it) % kChunks;
      float4 a[4], b[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        a[x] = ld4(sdy + at4(t0 + x, j));
        b[x] = ld4(sv + at4(s0 + x, j));
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) o[x][y] = dot4(a[x], b[y], o[x][y]);
    }
    float* dst = sda + p * S * S + (t0 & 7) * S + (s0 & 7);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4*>(dst + x * S) = make_float4(o[x][0], o[x][1], o[x][2], o[x][3]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // Phases 2-4: warp bi owns sub-chunk bi, lane the columns 2 lane, 2 lane + 1.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bi = warp;
  // Warps past the cell's sub-chunks run along on the zero padding rows (so
  // that every shuffle has the whole block) and write nothing.
  const bool active = bi < ns;  // warp-uniform
  const float2 zero2 = make_float2(0.0f, 0.0f);
  {
    const float* dab = sda + block_at(bi, bi);
    const float2 uu = ld2(su + 2 * lane);
    float pd[S][2], qd[S][2];
#pragma unroll
    for (int t = 0; t < S; ++t) pd[t][0] = pd[t][1] = qd[t][0] = qd[t][1] = 0.0f;

    // 2. the diagonal block, pairwise: each exp feeds A, P and Q
    {
      // ap[t (t - 1) / 2 + s]: A[t, s] of pair s < t; ap[28 + t]: diag[t]
      float ap[36];
      float2 dup = zero2;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int row = bi * S + t;
        const float2 rt = lane2(sr, row, lane), kt = lane2(sk, row, lane);
        const float ddt = dab[t * (S + 1)];
        ap[28 + t] = fmaf(rt.x * uu.x, kt.x, rt.y * uu.y * kt.y);
        dup.x = fmaf(ddt * rt.x, kt.x, dup.x);
        dup.y = fmaf(ddt * rt.y, kt.y, dup.y);
        const float2 xt = lane2(sx, row, lane);
#pragma unroll
        for (int s = 0; s < t; ++s) {
          float a = 0.0f;
          if (row < c) {  // a padding row would take exp(0 - L[s]), which can overflow
            const float2 ks = lane2(sk, bi * S + s, lane), ls = lane2(sl, bi * S + s, lane);
            const float e0 = __expf(xt.x - ls.x), e1 = __expf(xt.y - ls.y);
            const float da = dab[t * S + s];
            const float k0 = ks.x * e0, k1 = ks.y * e1;
            a = fmaf(rt.x, k0, rt.y * k1);
            pd[t][0] = fmaf(da, k0, pd[t][0]);
            pd[t][1] = fmaf(da, k1, pd[t][1]);
            qd[s][0] = fmaf(da * rt.x, e0, qd[s][0]);
            qd[s][1] = fmaf(da * rt.y, e1, qd[s][1]);
          }
          ap[t * (t - 1) / 2 + s] = a;
        }
      }
      // sums over the lanes: a butterfly leaves lane q the total of ap[q],
      // q < 32; diag[4 .. 7] (ap[32 .. 35]) by plain reductions
      fold<16>(ap, lane);
      fold<8>(ap, lane);
      fold<4>(ap, lane);
      fold<2>(ap, lane);
      fold<1>(ap, lane);
#pragma unroll
      for (int q = 32; q < 36; ++q)
#pragma unroll
        for (int step = 0; step < 5; ++step) ap[q] += __shfl_xor_sync(kFull, ap[q], 16 >> step);
      float* adb = sa + block_at(bi, bi);
      if (active && lane < 28) {
        int t = 1;
        while (t * (t + 1) / 2 <= lane) ++t;
        const int s = lane - t * (t - 1) / 2;
        adb[t * S + s] = ap[0];
        adb[s * S + t] = 0.0f;  // above the diagonal: phase 6 reads zeros there
      } else if (active) {
        const int t = lane - 28;
        const float hi = pick(t == 0, ap[32], pick(t == 1, ap[33], pick(t == 2, ap[34], ap[35])));
        adb[t * (S + 1)] = ap[0];
        adb[(t + 4) * (S + 1)] = hi;
      }
      if (active) *reinterpret_cast<float2*>(sdu + bi * kRow + 2 * lane) = dup;
      // D_{bi, j} of phase 5
      if (active && bi > 0) {
        const float2 lb = ld2(sl + at2(bi * S - 1, lane));
        for (int j = 0; j < bi; ++j) {
          const float2 le = ld2(sl + at2(j * S + S - 1, lane));
          *reinterpret_cast<float2*>(sd + d_at(bi, j) + 2 * lane) =
              make_float2(__expf(lb.x - le.x), __expf(lb.y - le.y));
        }
      }
    }

    // 3. P and Q of the off-diagonal blocks, their factors taken here from
    // Lex and L (both still whole): for s in sub-chunk j < bi, k'[s] D_{bi,j}
    // = k[s] exp(L[b] - L[s]) and P = P_diag + alpha X; for t in sub-chunk
    // i > bi, r'[t] D_{i,bi} = r[t] exp(Lex[t] - L[e]) and Q = Q_diag + beta Y.
    // Then dr, dLex, dk, dL.
    {
      float x[S][2];
#pragma unroll
      for (int t = 0; t < S; ++t) x[t][0] = x[t][1] = 0.0f;
      const float2 lb = bi > 0 ? lane2(sl, bi * S - 1, lane) : zero2;
      for (int j = 0; j < (active ? bi : 0); ++j) {
        const float* blk = sda + block_at(bi, j);
#pragma unroll
        for (int h = 0; h < S; h += 4) {
          float2 kd[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = j * S + h + q;
            const float2 kq = lane2(sk, row, lane), lq = lane2(sl, row, lane);
            kd[q] = make_float2(kq.x * __expf(lb.x - lq.x), kq.y * __expf(lb.y - lq.y));
          }
#pragma unroll
          for (int t = 0; t < S; ++t) {
            const float4 a = ld4(blk + t * S + h);
            x[t][0] = fmaf(a.x, kd[0].x, fmaf(a.y, kd[1].x, fmaf(a.z, kd[2].x, fmaf(a.w, kd[3].x, x[t][0]))));
            x[t][1] = fmaf(a.x, kd[0].y, fmaf(a.y, kd[1].y, fmaf(a.z, kd[2].y, fmaf(a.w, kd[3].y, x[t][1]))));
          }
        }
      }
#pragma unroll
      for (int t = 0; t < S; t += 2) {
        float2 drv[2], dxv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = bi * S + t + h;
          const float2 rt = lane2(sr, row, lane), kt = lane2(sk, row, lane);
          const float2 xt = lane2(sx, row, lane);
          // alpha: 0 in sub-chunk 0 (no X) and on a padding row
          const bool scaled = bi > 0 && row < c;
          const float a0 = scaled ? __expf(xt.x - lb.x) : 0.0f, a1 = scaled ? __expf(xt.y - lb.y) : 0.0f;
          const float p0 = fmaf(a0, x[t + h][0], pd[t + h][0]);
          const float p1 = fmaf(a1, x[t + h][1], pd[t + h][1]);
          const float ddt = dab[(t + h) * (S + 1)];
          drv[h] = make_float2(fmaf(ddt * uu.x, kt.x, p0), fmaf(ddt * uu.y, kt.y, p1));
          dxv[h] = make_float2(rt.x * p0, rt.y * p1);
        }
        store_rows<kVec>(dr, c, n, lane, bi * S + t, drv[0], drv[1]);
        store_rows<kVec>(dlex, c, n, lane, bi * S + t, dxv[0], dxv[1]);
      }
    }
    {
      float y[S][2];
#pragma unroll
      for (int s = 0; s < S; ++s) y[s][0] = y[s][1] = 0.0f;
      const bool last = bi == ns - 1;
      const float2 le = last ? zero2 : lane2(sl, bi * S + S - 1, lane);
      for (int i2 = bi + 1; i2 < ns; ++i2) {
        const float* blk = sda + block_at(i2, bi);
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const int row = i2 * S + t;
          const float2 rq = lane2(sr, row, lane), xq = lane2(sx, row, lane);
          // a padding row would take exp(0 - L[e]), which can overflow
          const float2 rd = row < c ? make_float2(rq.x * __expf(xq.x - le.x), rq.y * __expf(xq.y - le.y)) : zero2;
          const float4 a0 = ld4(blk + t * S), a1 = ld4(blk + t * S + 4);
          const float as[S] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int s = 0; s < S; ++s) {
            y[s][0] = fmaf(as[s], rd.x, y[s][0]);
            y[s][1] = fmaf(as[s], rd.y, y[s][1]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < S; s += 2) {
        float2 dkv[2], dlv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = bi * S + s + h;
          const float2 rt = lane2(sr, row, lane), kt = lane2(sk, row, lane);
          const float2 ls = lane2(sl, row, lane);
          // beta: 0 in the last sub-chunk (no Y)
          const float b0 = last ? 0.0f : __expf(le.x - ls.x), b1 = last ? 0.0f : __expf(le.y - ls.y);
          const float q0 = fmaf(b0, y[s + h][0], qd[s + h][0]);
          const float q1 = fmaf(b1, y[s + h][1], qd[s + h][1]);
          const float ddt = dab[(s + h) * (S + 1)];
          dkv[h] = make_float2(fmaf(ddt * uu.x, rt.x, q0), fmaf(ddt * uu.y, rt.y, q1));
          dlv[h] = make_float2(-(kt.x * q0), -(kt.y * q1));
        }
        store_rows<kVec>(dk, c, n, lane, bi * S + s, dkv[0], dkv[1]);
        store_rows<kVec>(dlcum, c, n, lane, bi * S + s, dlv[0], dlv[1]);
      }
    }
  }

  // 4. r' = r alpha over Lex (sub-chunks >= 1) and k' = k beta over L
  // (sub-chunks < ns - 1), a lane its own elements, once every warp has
  // read Lex and L; du
  {
    float2 rk[2][S];
    const float2 lb = lane2(sl, bi > 0 ? bi * S - 1 : 0, lane), le = lane2(sl, bi * S + S - 1, lane);
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int row = bi * S + t;
      const float2 rt = lane2(sr, row, lane), kt = lane2(sk, row, lane);
      const float2 xt = lane2(sx, row, lane), lt = lane2(sl, row, lane);
      const bool real = row < c;  // alpha is 0 on a padding row
      rk[0][t] = real ? make_float2(rt.x * __expf(xt.x - lb.x), rt.y * __expf(xt.y - lb.y)) : zero2;
      rk[1][t] = make_float2(kt.x * __expf(le.x - lt.x), kt.y * __expf(le.y - lt.y));
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const int at = at2(bi * S + t, lane);
        if (bi > 0) *reinterpret_cast<float2*>(sx + at) = rk[0][t];
        if (bi < ns - 1) *reinterpret_cast<float2*>(sl + at) = rk[1][t];
      }
    }
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float acc = 0.0f;
    for (int i = 0; i < ns; ++i) acc += sdu[i * kRow + j];
    du[static_cast<long long>(cell) * n + j] = acc;
  }
  __syncthreads();

  // 5. A of the off-diagonal blocks: r'_i D_ij k'_j^T, 4 x 4 tiles
  for (int task = threadIdx.x; task < ns * (ns - 1) / 2 * 4; task += kThreads) {
    const int pr = task >> 2, q = task & 3;
    int i2, bj;
    block_of(pr, i2, bj);  // pr = i2' (i2' + 1) / 2 + bj with i2' = i2 - 1
    i2 += 1;
    const int t0 = i2 * S + 4 * (q >> 1), s0 = bj * S + 4 * (q & 1);
    const float* dp = sd + pr * kRow;
    float o[4][4] = {};
#pragma unroll 2
    for (int it = 0; it < kChunks; ++it) {
      const int j = (pr + it) % kChunks;
      const float4 dq = ld4(dp + 4 * j);
      float4 a[4], b[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        a[x] = mul4(ld4(sx + at4(t0 + x, j)), dq);
        b[x] = ld4(sl + at4(s0 + x, j));
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) o[x][y] = dot4(a[x], b[y], o[x][y]);
    }
    float* dst = sa + block_at(i2, bj) + (t0 & 7) * S + (s0 & 7);
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4*>(dst + x * S) = make_float4(o[x][0], o[x][1], o[x][2], o[x][3]);
  }
  __syncthreads();

  // 6. dv = A^T dy: rows {lo, lo+1} = {2a, 2a+1} and {hi, hi+1} = {cp-2-2a,
  // cp-1-2a}, columns 4 ng .., a sub-block of t at a time from the row's
  // own: above the diagonal A is 0, and dy's padding rows are 0
  const int a = threadIdx.x / 16, ng = threadIdx.x % 16;
  if (a < cp / 4) {
    const int lo = 2 * a, hi = cp - 2 - 2 * a;
    float4 y0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), y1 = y0, y2 = y0, y3 = y0;
    // sub-blocks of t that reach rows lo, lo + 1 only, then those that reach all four
    for (int tb = lo / S; tb < hi / S; ++tb) {
      const float* alo = sa + block_at(tb, lo / S) + lo % S;
#pragma unroll
      for (int x = 0; x < S; ++x) {
        const float4 g = ld4(sdy + at4(tb * S + x, ng));
        const float2 al2 = ld2(alo + x * S);
        y0 = axpy4(al2.x, g, y0);
        y1 = axpy4(al2.y, g, y1);
      }
    }
    for (int tb = hi / S; tb < ns; ++tb) {
      const float* alo = sa + block_at(tb, lo / S) + lo % S;
      const float* ahi = sa + block_at(tb, hi / S) + hi % S;
#pragma unroll
      for (int x = 0; x < S; ++x) {
        const float4 g = ld4(sdy + at4(tb * S + x, ng));
        const float2 al2 = ld2(alo + x * S), ah2 = ld2(ahi + x * S);
        y0 = axpy4(al2.x, g, y0);
        y1 = axpy4(al2.y, g, y1);
        y2 = axpy4(ah2.x, g, y2);
        y3 = axpy4(ah2.y, g, y3);
      }
    }
    store4<kVec>(dv, c, n, lo, 4 * ng, y0);
    store4<kVec>(dv, c, n, lo + 1, 4 * ng, y1);
    store4<kVec>(dv, c, n, hi, 4 * ng, y2);
    store4<kVec>(dv, c, n, hi + 1, 4 * ng, y3);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int allowed[2][repro::kMaxDevices] = {};

// Raise a kernel's shared-memory limit to kShared floats, asking on the
// first call a device for the largest shared-memory carveout, so that two
// blocks fit an SM.
template <bool kVec>
cudaError_t prepare() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < repro::kMaxDevices && allowed[kVec][device] == 0) {
    err = cudaFuncSetAttribute(rwkv_intra_bwd_kernel<kVec>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  return repro::allow_shared(rwkv_intra_bwd_kernel<kVec>, kShared * sizeof(float), allowed[kVec]);
}

template <bool kVec>
cudaError_t launch(const void* const* in, void* const* out, long long g, int c, int n, cudaStream_t stream) {
  const cudaError_t err = prepare<kVec>();
  if (err != cudaSuccess) return err;
  rwkv_intra_bwd_kernel<kVec><<<static_cast<unsigned>(g), kThreads, kShared * sizeof(float), stream>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]), static_cast<const float*>(in[2]),
      static_cast<const float*>(in[3]), static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<float*>(out[0]), static_cast<float*>(out[1]),
      static_cast<float*>(out[2]), static_cast<float*>(out[3]), static_cast<float*>(out[4]),
      static_cast<float*>(out[5]), c, n);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, lex, lcum, dy and the outputs dr, dk, dv, dlex, dlcum: (G, C, N)
// float32, contiguous; u and du: (G, N) float32.  1 <= C <= 64 and
// 1 <= N <= 64 (the wrapper checks both).
extern "C" int rwkv_intra_bwd_launch(const void* r, const void* k, const void* v, const void* lex,
                                     const void* lcum, const void* u, const void* dy, void* dr, void* dk,
                                     void* dv, void* dlex, void* dlcum, void* du, long long g, int c, int n,
                                     void* stream) {
  if (c < 1 || c > kMaxC || n < 1 || n > kMaxN || g < 0 || g > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g == 0) return static_cast<int>(cudaSuccess);
  const void* const in[] = {r, k, v, lex, lcum, u, dy};
  void* const out[] = {dr, dk, dv, dlex, dlcum, du};
  bool vec = n % 4 == 0;
  for (const void* p : in) vec = vec && aligned16(p);
  for (const void* p : out) vec = vec && aligned16(p);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch<true>(in, out, g, c, n, s) : launch<false>(in, out, g, c, n, s));
}

// The blocks of the kernel's 16-byte path that one SM holds at once (the
// occupancy calculator's answer), or minus a CUDA error; the dynamic shared
// bytes of a block go to *shared_bytes.
extern "C" int rwkv_intra_bwd_occupancy(int* shared_bytes) {
  *shared_bytes = static_cast<int>(kShared * sizeof(float));
  cudaError_t err = prepare<true>();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rwkv_intra_bwd_kernel<true>, kThreads,
                                                        kShared * sizeof(float));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
