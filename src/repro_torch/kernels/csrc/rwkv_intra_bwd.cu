// rwkv_intra_bwd: the gradient of RWKV6's intra-chunk quadratic form, one
// block per cell.
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
// expansion -- no float atomics, so the result is deterministic.
//
// The design is the simple one: the seven tiles in dynamic shared memory
// (rows padded to N + 1 floats, so a warp reading one column of many rows
// hits distinct banks), A and dA as (C, C + 1) tables with diag and ddiag
// on their diagonals, and the pairwise exponent taken where it is used, as
// the reference's jnp math does:
//   1. a thread per pair s <= t: A[t,s] and dA[t,s] (diag, ddiag at s = t);
//   2. a thread per (s, j): dv; a thread per (t, n): P, dr, dLex; a thread
//      per (s, n): Q, dk, dL; a thread per n: du.
// Pairwise means three C (C - 1) / 2 x N exps a cell (A, P, Q).  Domain: the
// forward's, 1 <= C, N <= 64 and log-decays <= 0.  The exponents are
// relative decays: Lex[t] - L[s] <= 0 for s < t up to the rounding of
// Lex = L - log_w, which can leave it one ulp of |Lex| above 0 (ROADMAP C,
// "Kernels") -- exp of that is 1 to float32 precision, so no factor
// overflows however strong the decay.  The forward's __expf is used here
// too.
//
// Bound on the H100 at the training shape (G = 2 * 16 * 40 cells of
// 64 x 64): bytes -- 6 tiles in and 5 out of G * C * N * 4 bytes and two
// (G, N) vectors, 231.3 MB, 0.0691 ms at 3.35 TB/s -- above the float32
// operations (~3.0 GFLOP, the exps not counted, 0.045 ms at 67 TFLOP/s).
// At 150 KB of shared memory a block, one block runs on an SM at a time;
// the pairwise exps (3 x 2016 x 64 a cell) and the shared-memory reads of
// the triangular loops, not the bytes, are what this first design spends
// its time on.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxC = 64;
constexpr int kMaxN = 64;

__host__ __device__ inline size_t shared_floats(int c, int n) {
  return static_cast<size_t>(7) * c * (n + 1) + 2 * static_cast<size_t>(c) * (c + 1) + n;
}

// The t-th row, s-th column of the lower triangle s <= t, from its index p.
__device__ __forceinline__ void pair_of(int p, int& t, int& s) {
  t = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  while (t * (t + 1) / 2 > p) --t;
  s = p - t * (t + 1) / 2;
}

__global__ void __launch_bounds__(kThreads)
rwkv_intra_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ lex,
                      const float* __restrict__ lcum, const float* __restrict__ u,
                      const float* __restrict__ dy, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dlex, float* __restrict__ dlcum,
                      float* __restrict__ du, int c, int n) {
  extern __shared__ __align__(16) float smem[];
  const int sn = n + 1, sc = c + 1;
  float* sr = smem;
  float* sk = sr + c * sn;
  float* sv = sk + c * sn;
  float* sx = sv + c * sn;  // Lex
  float* sl = sx + c * sn;  // L
  float* sdy = sl + c * sn;
  float* su = sdy + c * sn;
  float* sa = su + n;       // A[t * sc + s], diag on the diagonal
  float* sda = sa + c * sc; // dA[t * sc + s], ddiag on the diagonal

  const long long base = static_cast<long long>(blockIdx.x) * c * n;
  for (int i = threadIdx.x; i < c * n; i += kThreads) {
    const int row = i / n, col = i % n, at = row * sn + col;
    sr[at] = r[base + i];
    sk[at] = k[base + i];
    sv[at] = v[base + i];
    sx[at] = lex[base + i];
    sl[at] = lcum[base + i];
    sdy[at] = dy[base + i];
  }
  for (int i = threadIdx.x; i < n; i += kThreads) su[i] = u[static_cast<long long>(blockIdx.x) * n + i];
  __syncthreads();

  // 1. A and dA over the lower triangle s <= t
  for (int p = threadIdx.x; p < c * (c + 1) / 2; p += kThreads) {
    int t, s;
    pair_of(p, t, s);
    const float* rt = sr + t * sn;
    const float* ks = sk + s * sn;
    const float* dyt = sdy + t * sn;
    const float* vs = sv + s * sn;
    float a = 0.0f, da = 0.0f;
    if (s < t) {
      const float* xt = sx + t * sn;
      const float* ls = sl + s * sn;
      for (int j = 0; j < n; ++j) {
        a = fmaf(rt[j] * ks[j], __expf(xt[j] - ls[j]), a);
        da = fmaf(dyt[j], vs[j], da);
      }
    } else {
      for (int j = 0; j < n; ++j) {
        a = fmaf(rt[j] * su[j], ks[j], a);
        da = fmaf(dyt[j], vs[j], da);
      }
    }
    sa[t * sc + s] = a;
    sda[t * sc + s] = da;
  }
  __syncthreads();

  // 2a. dv[s, j] = sum_{t >= s} A[t, s] dy[t, j]
  for (int i = threadIdx.x; i < c * n; i += kThreads) {
    const int s = i / n, j = i % n;
    float acc = 0.0f;
    for (int t = s; t < c; ++t) acc = fmaf(sa[t * sc + s], sdy[t * sn + j], acc);
    dv[base + i] = acc;
  }
  // 2b. P, dr and dLex of row t
  for (int i = threadIdx.x; i < c * n; i += kThreads) {
    const int t = i / n, j = i % n;
    const float xt = sx[t * sn + j];
    float pt = 0.0f;
    for (int s = 0; s < t; ++s) pt = fmaf(sda[t * sc + s] * sk[s * sn + j], __expf(xt - sl[s * sn + j]), pt);
    const float rt = sr[t * sn + j];
    dr[base + i] = fmaf(sda[t * sc + t] * su[j], sk[t * sn + j], pt);
    dlex[base + i] = rt * pt;
  }
  // 2c. Q, dk and dL of row s
  for (int i = threadIdx.x; i < c * n; i += kThreads) {
    const int s = i / n, j = i % n;
    const float ls = sl[s * sn + j];
    float q = 0.0f;
    for (int t = s + 1; t < c; ++t) q = fmaf(sda[t * sc + s] * sr[t * sn + j], __expf(sx[t * sn + j] - ls), q);
    const float ks = sk[s * sn + j];
    dk[base + i] = fmaf(sda[s * sc + s] * su[j], sr[s * sn + j], q);
    dlcum[base + i] = -(ks * q);
  }
  // 2d. du[n] = sum_t ddiag[t] r[t, n] k[t, n]
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float acc = 0.0f;
    for (int t = 0; t < c; ++t) acc = fmaf(sda[t * sc + t] * sr[t * sn + j], sk[t * sn + j], acc);
    du[static_cast<long long>(blockIdx.x) * n + j] = acc;
  }
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
  cudaError_t err = cudaFuncSetAttribute(rwkv_intra_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shared_floats(kMaxC, kMaxN) * sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv_intra_bwd_kernel<<<static_cast<unsigned>(g), kThreads, shared_floats(c, n) * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(lex), static_cast<const float*>(lcum), static_cast<const float*>(u),
      static_cast<const float*>(dy), static_cast<float*>(dr), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dlex), static_cast<float*>(dlcum), static_cast<float*>(du), c, n);
  return static_cast<int>(cudaGetLastError());
}
