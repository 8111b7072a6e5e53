// window_fold: bucket-wise max over the slices of a (W, B, m) uint8 ring.
//
// Replaces two TPU kernels of repro/kernels/window_fold.py:
//   window_fold_max   the masked ring fold of a sliding-window read: live
//                     slices (mask[w] != 0) fold, dead ones contribute 0;
//   window_merge_max  the same fold with every slice live, over the K = 3
//                     fragments of the incremental read (DESIGN.md §14).
// The TPU kernels tile the ring over row blocks of at most 4096 cells held
// in VMEM, in int32 (the wrapper upcasts the uint8 ring).  Here the ring
// stays uint8 and is one (W, N) plane with N = B * m: each thread owns 16
// neighbouring bytes of the plane, walks the W slices with one 16-byte load
// each (a warp reads 512 contiguous bytes of a slice), and folds with the
// per-byte max __vmaxu4.  The mask is read on the card, so a read needs no
// device-to-host copy; a dead slice is skipped without being read.
// Bound: the live slices' bytes read once and N bytes written, at the HBM
// rate.  N must be a multiple of 16 (m = 2^p >= 16) and both pointers
// 16-byte aligned; the wrapper checks both.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void window_fold_kernel(const uint4* __restrict__ ring,
                                   const uint8_t* __restrict__ mask, int window,
                                   long long vectors, uint4* __restrict__ out) {
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= vectors) return;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int w = 0; w < window; ++w) {
    if (mask != nullptr && mask[w] == 0) continue;
    const uint4 x = ring[static_cast<long long>(w) * vectors + v];
    acc.x = __vmaxu4(acc.x, x.x);
    acc.y = __vmaxu4(acc.y, x.y);
    acc.z = __vmaxu4(acc.z, x.z);
    acc.w = __vmaxu4(acc.w, x.w);
  }
  out[v] = acc;
}

int launch(const void* ring, const void* mask, int window, long long plane_bytes,
           void* out, void* stream) {
  const long long vectors = plane_bytes / 16;
  if (vectors <= 0) return static_cast<int>(cudaSuccess);
  const long long grid = (vectors + kThreads - 1) / kThreads;
  window_fold_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ring), static_cast<const uint8_t*>(mask), window,
      vectors, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window_fold_max: mask is a (W,) bool/uint8 tensor on the card.
extern "C" int window_fold_launch(const void* ring, const void* mask, int window,
                                  long long plane_bytes, void* out, void* stream) {
  return launch(ring, mask, window, plane_bytes, out, stream);
}

// window_merge_max: every one of the K slices is live.
extern "C" int window_merge_launch(const void* parts, int k, long long plane_bytes,
                                   void* out, void* stream) {
  return launch(parts, nullptr, k, plane_bytes, out, stream);
}
