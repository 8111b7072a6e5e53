#!/usr/bin/env python3
"""Where rwkv_intra_bwd's time goes on the card (no ncu there).

    python3 tools/intra_bwd_probe.py

Run from the repo root on a machine with a CUDA card and the CUDA toolkit.
Three readings, each printed as one JSON line:

* ``phases``: device ms at the training grid (G, C, N) = (1280, 64, 64) of
  copies of ``src/repro_torch/kernels/csrc/rwkv_intra_bwd.cu`` with phases
  switched off by a mask argument (the copies are written and built under
  ``build/intra_bwd_probe/``): everything, each of phases 1, 2, 3, 5 and 6
  left out, the copies alone, the arithmetic alone (no global loads or
  stores), the arithmetic and stores, and everything but the stores.  A
  phase switched off leaves its outputs unwritten, so only the times mean
  anything.
* ``shared_loads``: SM clocks a warp's shared-memory load takes, by width
  and by how many addresses the lanes read, 2 blocks of 8 warps an SM
  loading back to back (``clock64`` around the loop).
* ``sass``: the kernel's SASS instructions by opcode (``cuobjdump``).
"""

from __future__ import annotations

import collections
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.kernels import _build  # noqa: E402

OUT = REPO / "build" / "intra_bwd_probe"
SOURCE = _build.CSRC / "rwkv_intra_bwd.cu"
G, C, N = 1280, 64, 64
ALL = 0x3FF
# bit: 2 phase 1, 4 phase 2, 16 phase 3, 32 phase 5, 64 phase 6, 512 the
# global stores, 2048 the global loads off
MASKS = {
    "all": ALL, "no phase 1": ALL & ~2, "no phase 2": ALL & ~4, "no phase 3": ALL & ~16,
    "no phase 5": ALL & ~32, "no phase 6": ALL & ~64, "copies alone": 1,
    "arithmetic alone": (ALL & ~512) | 2048, "arithmetic and stores": ALL | 2048, "no stores": ALL & ~512,
}


def _masked_source(src: str) -> str:
    """The kernel with an ``int mask`` argument switching phases off, and a
    ``probe_launch`` entry point for the 16-byte path."""
    def rep(old: str, new: str, count: int = 1) -> None:
        nonlocal src
        if src.count(old) != count:
            raise RuntimeError(f"the kernel source changed: {old!r} found {src.count(old)} times")
        src = src.replace(old, new)

    rep("float* __restrict__ du, int c, int n) {", "float* __restrict__ du, int c, int n, int mask) {")
    rep("  load_tile<kVec>(sv, v, c, n);", "  if (!(mask & 2048)) {\n  load_tile<kVec>(sv, v, c, n);")
    rep("  cp_async_commit();\n  cp_async_wait<1>();", "  cp_async_commit();\n  }\n  cp_async_wait<1>();")
    rep("  for (int task = threadIdx.x; task < ns * (ns + 1) / 2 * 4;",
        "  if (mask & 2) for (int task = threadIdx.x; task < ns * (ns + 1) / 2 * 4;")
    rep("    // 2. the diagonal block, pairwise: each exp feeds A, P and Q\n    {", "    if (mask & 4) {")
    rep("    {\n      float x[S][2];", "    if (mask & 16) {\n      float x[S][2];")
    rep("    {\n      float y[S][2];", "    if (mask & 16) {\n      float y[S][2];")
    rep("        store_rows<kVec>(", "        if (mask & 512) store_rows<kVec>(", 4)
    rep("    store4<kVec>(dv,", "    if (mask & 512) store4<kVec>(dv,", 4)
    rep("  for (int task = threadIdx.x; task < ns * (ns - 1) / 2 * 4;",
        "  if (mask & 32) for (int task = threadIdx.x; task < ns * (ns - 1) / 2 * 4;")
    rep("  if (a < cp / 4) {", "  if (a < cp / 4 && (mask & 64)) {")
    rep("static_cast<float*>(out[5]), c, n);", "static_cast<float*>(out[5]), c, n, 0x3FF);")
    return src + '''
extern "C" int probe_launch(const void* const* in, void* const* out, long long g, int c, int n, int mask,
                            void* stream) {
  const cudaError_t err = prepare<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv_intra_bwd_kernel<true><<<static_cast<unsigned>(g), kThreads, kShared * sizeof(float),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in[0]), static_cast<const float*>(in[1]), static_cast<const float*>(in[2]),
      static_cast<const float*>(in[3]), static_cast<const float*>(in[4]), static_cast<const float*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<float*>(out[0]), static_cast<float*>(out[1]),
      static_cast<float*>(out[2]), static_cast<float*>(out[3]), static_cast<float*>(out[4]),
      static_cast<float*>(out[5]), c, n, mask);
  return static_cast<int>(cudaGetLastError());
}
'''


SHARED_LOADS = r'''
#include <cuda_runtime.h>
// MODE: 0 128-bit, one address; 1 32-bit, one address; 2 128-bit, 32
// addresses (512 B); 3 64-bit, 32 addresses (256 B); 4 64-bit, one address;
// 5 128-bit, 16 addresses (256 B)
template <int MODE>
__global__ void __launch_bounds__(256, 2) loads(float* out, long long* clocks, int iters) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < 8192; i += 256) sm[i] = i * 1e-3f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  float4 acc = make_float4(0, 0, 0, 0);
  int off = (threadIdx.x >> 5) * 64;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int base = (off + u * 256) & 4095;
      if (MODE == 0 || MODE == 2 || MODE == 5) {
        const int at = MODE == 0 ? base : MODE == 2 ? base + 4 * lane : base + 4 * (lane & 15);
        const float4 v = *reinterpret_cast<const float4*>(sm + at);
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      } else if (MODE == 1) {
        acc.x += sm[base];
      } else {
        const float2 v = *reinterpret_cast<const float2*>(sm + (MODE == 3 ? base + 2 * lane : base));
        acc.x += v.x; acc.y += v.y;
      }
    }
    off += 4 * (it & 7);
  }
  __syncthreads();
  if (threadIdx.x == 0) clocks[blockIdx.x] = clock64() - t0;
  out[blockIdx.x * 256 + threadIdx.x] = acc.x + acc.y + acc.z + acc.w;
}
// mean clocks a block took, over `blocks` blocks (2 an SM)
extern "C" double run(int mode, int blocks, int iters) {
  float* out; long long* clocks;
  cudaMalloc(&out, blocks * 256 * sizeof(float));
  cudaMalloc(&clocks, blocks * sizeof(long long));
  void (*k)(float*, long long*, int) = mode == 0 ? loads<0> : mode == 1 ? loads<1> : mode == 2 ? loads<2>
                                      : mode == 3 ? loads<3> : mode == 4 ? loads<4> : loads<5>;
  k<<<blocks, 256, 32768>>>(out, clocks, iters);
  long long* host = new long long[blocks];
  cudaMemcpy(host, clocks, blocks * sizeof(long long), cudaMemcpyDeviceToHost);
  double sum = 0;
  for (int b = 0; b < blocks; ++b) sum += host[b];
  delete[] host;
  cudaFree(out);
  cudaFree(clocks);
  return sum / blocks;
}
'''


def _nvcc(src: Path, lib: Path, *extra: str) -> None:
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)


def _time_ms(fn, iters: int = 100) -> float:
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phases(dev: torch.device) -> dict:
    src = OUT / "masked.cu"
    src.write_text(_masked_source(SOURCE.read_text()))
    lib_path = OUT / "masked.so"
    _nvcc(src, lib_path, "-I", str(_build.CSRC))
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(0)
    r, k, v, dy = (torch.randn((G, C, N), generator=gen, device=dev) for _ in range(4))
    lw = -(0.01 + 0.99 * torch.rand((G, C, N), generator=gen, device=dev))
    lcum = torch.cumsum(lw, 1)
    u = 0.3 * torch.randn((G, N), generator=gen, device=dev)
    ins = [r, k, v, lcum - lw, lcum, u, dy]
    outs = [torch.empty_like(r) for _ in range(5)] + [torch.empty_like(u)]
    in_ptrs = (ctypes.c_void_p * 7)(*(t.data_ptr() for t in ins))
    out_ptrs = (ctypes.c_void_p * 6)(*(t.data_ptr() for t in outs))
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}
    for name, mask in MASKS.items():
        def call():
            err = fn(in_ptrs, out_ptrs, G, C, N, mask, stream)
            if err:
                raise RuntimeError(f"probe_launch: CUDA error {err}")
        times[name] = _time_ms(call)
    return times


def shared_loads() -> dict:
    src = OUT / "shared_loads.cu"
    src.write_text(SHARED_LOADS)
    lib_path = OUT / "shared_loads.so"
    _nvcc(src, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.restype = ctypes.c_double
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4000
    names = ("128-bit, one address", "32-bit, one address", "128-bit, 32 addresses (512 B)",
             "64-bit, 32 addresses (256 B)", "64-bit, one address", "128-bit, 16 addresses (256 B)")
    # a block's clocks cover its SM's 16 warps' loads, 16 a turn
    return {name: lib.run(mode, blocks, iters) / (16 * iters * 16) for mode, name in enumerate(names)}


def sass() -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    dump = subprocess.run([tool, "-sass", str(_build.library_path("rwkv_intra_bwd"))], capture_output=True,
                          text=True).stdout
    ops = collections.Counter()
    for line in dump.splitlines():
        if line.strip().startswith("/*") and "*/" in line and ";" in line:
            words = [w for w in line.split("*/", 1)[1].split(";")[0].split() if not w.startswith("@")]
            if words:
                ops[words[0].split(".")[0]] += 1
    return {"instructions": sum(ops.values()), "by_opcode": dict(ops.most_common(12))}


def main() -> int:
    if not torch.cuda.is_available():
        print("intra_bwd_probe.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    _build.build_all(["rwkv_intra_bwd"])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "phases_ms": phases(dev)}))
    print(json.dumps({"shared_load_sm_clocks_a_warp_load": shared_loads()}))
    print(json.dumps({"sass": sass()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
