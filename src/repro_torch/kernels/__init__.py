"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

One module per TPU kernel of the reference (``repro/kernels``):

  hash_rank.hash_rank               <- hash_rank.py::hash_rank
  hll_fused.hll_update_fused        <- hll_fused.py::hll_update_fused
  bucket_fold.bucket_fold           <- bucket_fold.py::bucket_fold
  bank_scatter.bank_scatter_max     <- bank_scatter.py::bank_scatter_max
  sparse_scatter.sparse_scatter_coo <- sparse_scatter.py::sparse_scatter_coo
  window_fold.window_fold_max       <- window_fold.py::window_fold_max
  window_fold.window_merge_max      <- window_fold.py::window_merge_max
  cm_scatter.cm_scatter_add         <- cm_scatter.py::cm_scatter_add
  cm_scatter.cm_window_fold_sum     <- cm_scatter.py::cm_window_fold_sum
  rwkv_intra.rwkv_intra             <- rwkv_intra.py::rwkv_intra
  rwkv_intra.rwkv_intra_bwd         <- jax.grad of the reference's inline
                                       chunk math (no Pallas backward)
  bank_count.bank_row_count         <- jnp.bincount of the bank's exact row
                                       counters (no Pallas kernel)
  cm_vote.cm_vote                   <- the count-min tick's Topkapi vote,
                                       plain JAX in sketch/countmin.py's
                                       _label_update (no Pallas kernel)

A wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises; for ``meta`` tensors (the op analysis and
the dry-run) it returns empty outputs of its kernel's shapes.  Each wrapper
counts its launches in a plain integer attribute, ``launches``, and
declares its kernel's FLOPs and bytes at each launch, and on ``meta``
tensors, to ``repro_torch.obs.costs``.  Sources live in ``csrc/`` and build with
nvcc at first launch (``_build.py``), so importing this package needs
neither nvcc nor a card.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

# kernel name -> (module, wrapper) under repro_torch.kernels
KERNELS = {
    "hash_rank": ("hash_rank", "hash_rank"),
    "hll_update_fused": ("hll_fused", "hll_update_fused"),
    "bucket_fold": ("bucket_fold", "bucket_fold"),
    "bank_scatter_max": ("bank_scatter", "bank_scatter_max"),
    "sparse_scatter_coo": ("sparse_scatter", "sparse_scatter_coo"),
    "window_fold_max": ("window_fold", "window_fold_max"),
    "window_merge_max": ("window_fold", "window_merge_max"),
    "cm_scatter_add": ("cm_scatter", "cm_scatter_add"),
    "cm_window_fold_sum": ("cm_scatter", "cm_window_fold_sum"),
    "rwkv_intra": ("rwkv_intra", "rwkv_intra"),
    "rwkv_intra_bwd": ("rwkv_intra", "rwkv_intra_bwd"),
    "bank_row_count": ("bank_count", "bank_row_count"),
    "cm_vote": ("cm_vote", "cm_vote"),
}


def wrappers() -> Dict[str, Callable]:
    """{kernel name: its wrapper}; imports the kernel modules on first call."""
    return {
        name: getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), fn)
        for name, (mod, fn) in KERNELS.items()
    }


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}
