"""Op analysis: the roofline quantities of a callable, measured as it runs.

Port of ``repro/launch/hlo_analysis.py``, under its name so a reader finds
the counterpart.  The reference parses the optimized HLO text of a jitted
program and multiplies its while-loop bodies by their trip counts; the
port runs eagerly, so it measures a *callable* instead:
``analyze(fn, *args)`` runs ``fn`` once -- on ``meta`` tensors (shapes,
no data, nothing allocated) or on real ones -- and returns the same
``Analysis`` fields:

  * flops            -- ``torch.utils.flop_counter.FlopCounterMode``'s
                        count of the aten ops (matmuls, convolutions,
                        attention), plus the FLOPs each hand-written kernel
                        declares at its launch (``repro_torch.obs.costs``)
  * bytes            -- every aten op's operand and output bytes, summed by
                        a ``TorchDispatchMode`` (views and allocations move
                        nothing), plus each kernel's declared bytes.  Nothing
                        is fused in eager PyTorch's accounting, so this is
                        an upper bound of the traffic a fused program needs
  * collective bytes -- the bytes the device-list placement rules move
                        between mesh positions (the gathers of
                        ``optim/compress.py`` and ``sketch/dispatch.py``),
                        as they declare them, bucketed by kind

The kernels launch through ``ctypes``, which no dispatch mode sees: that
is why each wrapper declares its cost, counted as PERF.md's bound column
counts it, and does so on ``meta`` tensors too, where it returns empty
outputs of the right shapes and runs neither the kernel nor its plain
version.  Python loops run every trip, so every trip is counted:
``n_while_loops`` is 0 and ``trip_counts`` is {}.

The analysis also follows the live bytes of the storages the callable
allocates (each op's fresh outputs, freed when the last tensor on them,
views included, dies): ``peak_live_bytes`` is the most that were alive at once, the
dry-run's temp estimate, and ``peak_live_by_site`` the most at an op of
each site: a line of the port's code (``file:line``, the innermost port
frame that dispatched it) and, in a backward pass, the autograd node that
ran it.  The dry-run extrapolates the peak in depth site by site: the site
where the peak falls can change with the depth.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.obs import costs

_aten = torch.ops.aten
# allocations: they write nothing the op analysis should charge
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
}


def _site() -> str:
    """``file:line`` of the innermost frame of the port's code that led to
    the op being dispatched (the line whose op this is, or the line that
    started the backward pass it belongs to), and in a backward pass the
    autograd node that runs it."""
    node = torch._C._current_autograd_node()
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename
        if f"{os.sep}repro_torch{os.sep}" in path and not path.endswith("hlo_analysis.py"):
            break
        frame = frame.f_back
    where = "?" if frame is None else f"{os.path.relpath(frame.f_code.co_filename, _PACKAGE_ROOT)}:{frame.f_lineno}"
    return where if node is None else f"{where} {node.name()}"


_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _writes(func) -> bool:
    """Whether ``func`` writes into one of its inputs (an in-place or out= op)."""
    return any(a.alias_info is not None and a.alias_info.is_write for a in func._schema.arguments)


def _storage(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its StorageImpl), shared by its views."""
    return t.untyped_storage()._cdata


class _Counter(TorchDispatchMode):
    """Operand and output bytes of every aten op, the live bytes of what the
    ops allocate, and the declarations of kernels and placement rules."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak_live = 0
        self.site_peaks: Dict[str, int] = {}
        self.kernel_flops = 0
        self.kernels: Dict[str, dict] = {}
        self.collectives: Dict[str, float] = {}
        # storage -> [tensors alive on it, its bytes], for the storages the ops
        # allocated: a view keeps its storage alive after its base is gone
        # (under inference mode a view holds no reference to its base)
        self._storages: Dict[int, list] = {}

    def _hold(self, t: torch.Tensor, key: int) -> None:
        self._storages[key][0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages[key]
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._storages[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_storages = {_storage(t) for t in ins}
        fresh = False
        for t in outs:
            key = _storage(t)
            if key in self._storages:  # a view of (or a write into) what the ops allocated
                self._hold(t, key)
            elif key not in in_storages:  # a new allocation ("may alias" ops too, where they did not)
                self._storages[key] = [0, t.untyped_storage().nbytes()]
                self.live += self._storages[key][1]
                self._hold(t, key)
                fresh = True
        if (fresh or _writes(func)) and func not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if fresh:
            self.peak_live = max(self.peak_live, self.live)
            site = _site()
            self.site_peaks[site] = max(self.site_peaks.get(site, 0), self.live)
        return out

    def on_kernel(self, name: str, flops: int, nbytes: int) -> None:
        row = self.kernels.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0})
        row["launches"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.kernel_flops += flops
        self.bytes += nbytes

    def on_collective(self, kind: str, nbytes: int) -> None:
        self.collectives[kind] = self.collectives.get(kind, 0.0) + nbytes


@dataclasses.dataclass
class Analysis:
    flops: float
    bytes: float
    collective_bytes: float
    collectives_by_kind: Dict[str, float]
    n_while_loops: int
    trip_counts: Dict[str, int]
    # the port's own: the kernels' declarations, and the live-bytes peak of
    # what the callable allocated
    kernels: Dict[str, dict] = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0
    peak_live_by_site: Dict[str, int] = dataclasses.field(default_factory=dict)
    result: object = None


def analyze(fn, *args, **kwargs) -> Analysis:
    """Run ``fn(*args, **kwargs)`` once under the counters; its return value
    is ``result``."""
    counter = _Counter()
    flop_mode = FlopCounterMode(display=False)
    with costs.collecting(counter), flop_mode, counter:
        result = fn(*args, **kwargs)
    return Analysis(
        flops=float(flop_mode.get_total_flops() + counter.kernel_flops),
        bytes=float(counter.bytes),
        collective_bytes=float(sum(counter.collectives.values())),
        collectives_by_kind=dict(counter.collectives),
        n_while_loops=0,
        trip_counts={},
        kernels=counter.kernels,
        peak_live_bytes=counter.peak_live,
        peak_live_by_site=counter.site_peaks,
        result=result,
    )


# ----------------------------------------------------------------------------
# roofline terms: NVIDIA's published H100 SXM figures
# ----------------------------------------------------------------------------

# NVIDIA H100 SXM data sheet, at its 700 W power limit (a card set below it
# runs slower under load): dense bf16 tensor-core rate, HBM3 bandwidth, and
# NVLink 4 (900 GB/s a card in all, 450 GB/s each way)
PEAK_FLOPS_BF16 = 989e12  # per card
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_BW = 450e9  # bytes/s per card, each way


def roofline_terms(analysis: Analysis, n_chips: int, model_flops: Optional[float] = None) -> dict:
    """The three roofline terms (seconds) + dominant + usefulness ratio.

    The analysis's quantities are whole-program (every position); the
    per-card roofline divides them by the card count.  Across cards the
    collective term runs over NVLink; on one card (``n_chips`` 1) the
    positions share the card, and their moves are HBM traffic.
    """
    compute_s = analysis.flops / (n_chips * PEAK_FLOPS_BF16)
    memory_s = analysis.bytes / (n_chips * HBM_BW)
    link = NVLINK_BW if n_chips > 1 else HBM_BW
    collective_s = analysis.collective_bytes / (n_chips * link)
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dominant = max(terms, key=terms.get)
    out = {
        **terms,
        "dominant": dominant,
        "bound_s": terms[dominant],
        "collectives_by_kind": analysis.collectives_by_kind,
        "hlo_flops": analysis.flops,
        "hlo_bytes": analysis.bytes,
        "collective_bytes": analysis.collective_bytes,
    }
    if model_flops is not None:
        out["model_flops"] = model_flops
        out["useful_flop_ratio"] = model_flops / analysis.flops if analysis.flops else float("nan")
        # fraction of the roofline achieved if the dominant term were the
        # runtime: useful work time / bound time
        ideal_s = model_flops / (n_chips * PEAK_FLOPS_BF16)
        out["roofline_fraction"] = ideal_s / terms[dominant] if terms[dominant] else 0.0
    return out
