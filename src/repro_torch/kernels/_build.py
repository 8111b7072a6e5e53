"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <name>-<digest>.so csrc/<name>.cu

into ``build/repro_torch_kernels/`` at the repo root.  The digest covers
every source in ``csrc/`` and the flags, so an edited source builds anew
and an unchanged one loads the library already there.  Nothing builds at
import: a kernel's library builds at its first launch, and ``build_all``
starts one nvcc per source at once.  The ptxas report (registers, shared
memory, spills per kernel) is kept beside each library (``build_log``).

Every launch goes through ``launch``: it calls the C launcher on PyTorch's
current stream, raises on a refused launch, declares the kernel's FLOPs and
bytes to ``repro_torch.obs.costs`` and counts the launch under the kernel's
name (``repro_torch.kernels.launch_counts``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

from repro_torch.obs import costs

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = tuple(sorted(path.stem for path in CSRC.glob("*.cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}
LAUNCHES: Dict[str, int] = {}  # kernel name -> its launches since the last reset


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_log(name: str) -> str:
    """The nvcc/ptxas report of ``name``'s last build."""
    return library_path(name).with_suffix(".log").read_text()


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build every missing library, one nvcc per source, all at once.

    Returns {name: seconds its nvcc ran} (0.0 for a library already built).
    Raises RuntimeError with nvcc's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, seconds = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out = library_path(name)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def function(lib: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C launcher ``symbol`` of library ``lib``, building it if needed.

    Every launcher returns the cudaError_t of its launch as an int.
    """
    key = (lib, symbol)
    if key not in _FUNCS:
        if lib not in _LIBS:
            path = library_path(lib)
            if not path.exists():
                build_all([lib])
            _LIBS[lib] = ctypes.CDLL(str(path))
            _LIBS[lib].repro_error_string.argtypes = [ctypes.c_int]
            _LIBS[lib].repro_error_string.restype = ctypes.c_char_p
        fn = getattr(_LIBS[lib], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return _FUNCS[key]


def check(lib: str, error: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs)."""
    if error != 0:
        text = _LIBS[lib].repro_error_string(error).decode()
        raise RuntimeError(f"{what}: CUDA error {error} ({text})")


def launch(kernel: str, lib: str, symbol: str, argtypes: Sequence, device: torch.device, args: Sequence,
           flops: int, nbytes: int) -> None:
    """Launch ``kernel`` through the C launcher ``symbol`` of library ``lib``
    on ``device``, with ``args`` and PyTorch's current stream; raise if the
    launch was refused, else declare its ``flops`` and ``nbytes``
    (``repro_torch.obs.costs``) and count it in ``LAUNCHES``."""
    fn = function(lib, symbol, argtypes)
    with torch.cuda.device(device):
        error = fn(*args, stream(device))
    check(lib, error, kernel)
    costs.kernel(kernel, flops, nbytes)
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def on_meta(*tensors: torch.Tensor) -> bool:
    """Whether a wrapper was given ``meta`` tensors (shapes, no data), as the
    op analysis and the dry-run give them: the wrapper then returns empty
    outputs of its kernel's shapes and declares its kernel's cost
    (``repro_torch.obs.costs``), running neither the kernel nor its plain
    version."""
    return any(t.device.type == "meta" for t in tensors)


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on; raise otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type != "cuda":
        raise ValueError(f"a CUDA kernel needs CUDA tensors, got {device}")
    return device


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of ``device`` (a launch plan's input)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the pointer a launcher takes."""
    return torch.cuda.current_stream(device).cuda_stream
