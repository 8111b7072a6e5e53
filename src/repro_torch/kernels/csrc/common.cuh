// Pieces every kernel library shares: the uint8 register max and the
// plain C error interface the ctypes bindings read.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro {

// Raise one uint8 register to `value` (1..255).  CUDA has no 8-bit
// atomicMax, so the byte is updated by compare-and-swap on the 32-bit word
// that holds it; works on shared and global memory alike.  A read that
// already sees a byte >= value costs no atomic -- the common case once a
// sketch has filled, and for repeated items.  Registers only grow, so a
// stale first read can only be low, and the CAS then corrects it.
__device__ __forceinline__ void byte_max(uint32_t* words, uint64_t cell,
                                         uint32_t value) {
  uint32_t* word = words + (cell >> 2);
  const uint32_t shift = static_cast<uint32_t>(cell & 3u) * 8u;
  uint32_t old = *reinterpret_cast<volatile uint32_t*>(word);
  while (((old >> shift) & 0xFFu) < value) {
    const uint32_t want = (old & ~(0xFFu << shift)) | (value << shift);
    const uint32_t seen = atomicCAS(word, old, want);
    if (seen == old) break;
    old = seen;
  }
}

// Fold 4 packed uint8 registers into a global word by per-byte max.
__device__ __forceinline__ void word_max(uint32_t* word, uint32_t mine) {
  uint32_t old = *reinterpret_cast<volatile uint32_t*>(word);
  for (;;) {
    const uint32_t want = __vmaxu4(old, mine);
    if (want == old) return;
    const uint32_t seen = atomicCAS(word, old, want);
    if (seen == old) return;
    old = seen;
  }
}

inline int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

}  // namespace repro

// Every library exports this beside its launchers, so a wrapper can name
// the error a launcher returned.
extern "C" const char* repro_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}
