// rwkv_intra: RWKV6's intra-chunk quadratic form, one block per cell.
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
// The TPU kernel keeps the whole (C, C, N) pairwise transient in VMEM.
// Here a block holds the five tiles and u in shared memory (rows padded to
// N + 1 floats, so that the lanes of a warp reading column n of rows s,
// s + 1, ... hit distinct banks), then:
//   1. threads over the (t, s) pairs with s <= t sum A[t,s] over n,
//      computing exp(Lex[t,n] - L[s,n]) pairwise -- never factored into
//      exp(Lex) * exp(-L), since exp(-L) alone overflows under strong
//      decay; the exponent is a relative decay <= 0.  The diagonal s = t
//      holds diag[t], so that step 2 is one product;
//   2. A goes to shared memory, and threads over (t, n) form
//      y[t,n] = sum_{s<=t} A[t,s] v[s,n], written coalesced.
// Everything is float32, as on the TPU.  Shared memory at C = N = 64 is
// 5 * 64 * 65 * 4 + 64 * 64 * 4 + 64 * 4 = 99,840 bytes, above the static
// 48 KB, so it is dynamic and the launcher raises the kernel's limit first.
//
// Bound on the H100, at the serve shape (G = 5120, C = N = 64): bytes --
// 5 inputs and the output of G*C*N*4 bytes and u, 504.6 MB, 0.151 ms at
// 3.35 TB/s -- above the float32 operations (~4.1 GFLOP, 0.061 ms at
// 67 TFLOP/s outside the tensor cores, with the 660.6 M exps not counted).
// This design reads every byte once; what it leaves on the table is the
// exps' issue rate and the scalar A*v product, for which tensor cores,
// exps kept in registers and cp.async loads are the next steps.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;
constexpr int kMaxN = 64;

__host__ __device__ inline size_t shared_floats(int c, int n) {
  return static_cast<size_t>(5 * c * (n + 1) + c * c + n);
}

__global__ void __launch_bounds__(kThreads)
rwkv_intra_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ lex,
                  const float* __restrict__ lcum, const float* __restrict__ u,
                  float* __restrict__ y, int c, int n) {
  extern __shared__ float smem[];
  const int stride = n + 1;
  const int tile = c * stride;
  float* sr = smem;
  float* sk = sr + tile;
  float* sv = sk + tile;
  float* slex = sv + tile;
  float* sl = slex + tile;
  float* sa = sl + tile;  // (C, C) scores, diag on the diagonal
  float* su = sa + c * c;

  const long long cell = blockIdx.x;
  const long long base = cell * c * n;
  for (int i = threadIdx.x; i < c * n; i += blockDim.x) {
    const int at = (i / n) * stride + i % n;
    sr[at] = r[base + i];
    sk[at] = k[base + i];
    sv[at] = v[base + i];
    slex[at] = lex[base + i];
    sl[at] = lcum[base + i];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) su[i] = u[cell * n + i];
  __syncthreads();

  // 1. scores: one (t, s) pair per thread and step, s <= t
  for (int p = threadIdx.x; p < c * c; p += blockDim.x) {
    const int t = p / c;
    const int s = p % c;
    float acc = 0.0f;
    const float* rt = sr + t * stride;
    if (s < t) {
      const float* ks = sk + s * stride;
      const float* lext = slex + t * stride;
      const float* ls = sl + s * stride;
      for (int j = 0; j < n; ++j) acc += rt[j] * ks[j] * expf(lext[j] - ls[j]);
    } else if (s == t) {
      const float* kt = sk + t * stride;
      for (int j = 0; j < n; ++j) acc += rt[j] * su[j] * kt[j];
    }
    sa[p] = acc;
  }
  __syncthreads();

  // 2. y = A v over the lower triangle, diagonal included
  for (int q = threadIdx.x; q < c * n; q += blockDim.x) {
    const int t = q / n;
    const int j = q % n;
    const float* at = sa + t * c;
    float acc = 0.0f;
    for (int s = 0; s <= t; ++s) acc += at[s] * sv[s * stride + j];
    y[base + q] = acc;
  }
}

}  // namespace

// r, k, v, lex, lcum, y: (G, C, N) float32, contiguous; u: (G, N) float32.
// 1 <= C <= 64 and 1 <= N <= 64 (the wrapper checks both).
extern "C" int rwkv_intra_launch(const void* r, const void* k, const void* v,
                                 const void* lex, const void* lcum, const void* u,
                                 void* y, long long g, int c, int n, void* stream) {
  if (c < 1 || c > kMaxC || n < 1 || n > kMaxN || g < 0 || g > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (g == 0) return static_cast<int>(cudaSuccess);
  const size_t bytes = shared_floats(c, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared_floats(kMaxC, kMaxN) * sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv_intra_kernel<<<static_cast<unsigned>(g), kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lex),
      static_cast<const float*>(lcum), static_cast<const float*>(u),
      static_cast<float*>(y), c, n);
  return static_cast<int>(cudaGetLastError());
}
