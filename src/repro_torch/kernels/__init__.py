"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

One module per TPU kernel of the reference (``repro/kernels``); ``KERNELS``
lists every kernel with its wrapper, its CUDA source and what it replaces.
A wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches its kernel through ``_build.launch``, which counts the launch
(``launch_counts``) and declares its kernel's FLOPs and bytes to
``repro_torch.obs.costs``, or raises; for ``meta`` tensors (the op analysis
and the dry-run) it returns empty outputs of its kernel's shapes and
declares the same cost.  Sources live in ``csrc/`` and build with nvcc at
first launch (``_build.py``), so importing this package needs neither nvcc
nor a card.  A new kernel adds its ``csrc/<source>.cu``, its wrapper module
and one ``KERNELS`` entry.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, NamedTuple

from repro_torch.kernels import _build


class Kernel(NamedTuple):
    module: str  # its wrapper's module under repro_torch.kernels
    wrapper: str  # its wrapper's name there
    source: str  # the stem of its csrc/<source>.cu
    replaces: str  # the reference's code it stands for


KERNELS = {
    "hash_rank": Kernel("hash_rank", "hash_rank", "hash_rank", "src/repro/kernels/hash_rank.py:44"),
    "hll_update_fused": Kernel("hll_fused", "hll_update_fused", "hll_fused", "src/repro/kernels/hll_fused.py:91"),
    "bucket_fold": Kernel("bucket_fold", "bucket_fold", "bucket_fold", "src/repro/kernels/bucket_fold.py:26"),
    "bank_scatter_max": Kernel("bank_scatter", "bank_scatter_max", "bank_scatter",
                               "src/repro/kernels/bank_scatter.py:92"),
    "sparse_scatter_coo": Kernel("sparse_scatter", "sparse_scatter_coo", "sparse_scatter",
                                 "src/repro/kernels/sparse_scatter.py:99"),
    "window_fold_max": Kernel("window_fold", "window_fold_max", "window_fold", "src/repro/kernels/window_fold.py:51"),
    "window_merge_max": Kernel("window_fold", "window_merge_max", "window_fold",
                               "src/repro/kernels/window_fold.py:102"),
    "cm_scatter_add": Kernel("cm_scatter", "cm_scatter_add", "cm_scatter", "src/repro/kernels/cm_scatter.py:94"),
    "cm_window_fold_sum": Kernel("cm_scatter", "cm_window_fold_sum", "cm_scatter",
                                 "src/repro/kernels/cm_scatter.py:186"),
    "rwkv_intra": Kernel("rwkv_intra", "rwkv_intra", "rwkv_intra", "src/repro/kernels/rwkv_intra.py:54"),
    # no Pallas backward: the reference differentiates its inline chunk math
    # (time_mix_chunked) with jax.grad
    "rwkv_intra_bwd": Kernel("rwkv_intra", "rwkv_intra_bwd", "rwkv_intra_bwd",
                             "src/repro/models/rwkv6.py:159 (jax.grad of time_mix_chunked's chunk math)"),
    # no Pallas kernel: the reference counts a tick's keys with jnp.bincount
    "bank_row_count": Kernel("bank_count", "bank_row_count", "bank_count",
                             "src/repro/sketch/bank.py:277 (jnp.bincount of the exact row counters)"),
    # no Pallas kernel: the reference votes in plain JAX (a lexsort, run
    # lengths and two segment_max)
    "cm_vote": Kernel("cm_vote", "cm_vote", "cm_vote",
                      "src/repro/sketch/countmin.py:211 (_label_update, the Topkapi vote)"),
    # no Pallas kernel: the reference histograms with jnp.bincount and
    # finalizes in plain JAX
    "hll_estimate": Kernel("hll_estimate", "hll_estimate", "hll_estimate",
                           "src/repro/sketch/estimators.py:84 (jnp.bincount register histogram) and :209 "
                           "(_original_device)"),
}


def wrappers() -> Dict[str, Callable]:
    """{kernel name: its wrapper}; imports the kernel modules on first call."""
    return {
        name: getattr(importlib.import_module(f"repro_torch.kernels.{kernel.module}"), kernel.wrapper)
        for name, kernel in KERNELS.items()
    }


def reset_launches() -> None:
    _build.LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    """{kernel name: its launches since the last ``reset_launches``}."""
    return {name: _build.LAUNCHES.get(name, 0) for name in KERNELS}
