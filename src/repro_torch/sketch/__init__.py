"""repro_torch.sketch -- the public API of the HLL engine on PyTorch.

The port of ``repro.sketch``: single sketches, keyed ``SketchBank``s,
sparse/dense ``HybridBank``s, the windowed rings and the count-min family,
each ingested through an ``ExecutionPlan`` and finalized by the estimator
registry.

    from repro_torch.sketch import HyperLogLog, HLLConfig, ExecutionPlan

    sk = HyperLogLog.empty(HLLConfig(p=16, hash_bits=64))   # on the card
    sk = sk.update(items)                                   # "cuda" kernel
    sk = sk.update(items, ExecutionPlan(backend="cuda_pipelined"))
    est = sk.estimate()
    blob = sk.to_bytes(); back = HyperLogLog.from_bytes(blob)

    bank = SketchBank.empty(1024, HLLConfig())
    bank = bank.update_many(keys, items)                    # hash + scatter kernels
    ests = bank.estimate_many()

    hyb = HybridBank.empty(16384, HLLConfig(p=12))          # sparse rows, promoted
    hyb = hyb.update_many(keys, items)                      # at m // 4 buckets
    win = WindowedBank.empty(64, 1024, HLLConfig(p=12))     # (W, B, m) ring
    win = win.observe(keys, items).advance()
    ests = win.estimate_window(last_k=16)                   # window_fold kernel

    cm = CountMinBank.empty(1024, CMConfig(depth=4, width=1024))
    cm = cm.update_many(keys, items)                        # cm_scatter_add kernel
    est = cm.query(probes); values, counts = cm.topk(10)    # heavy hitters
    cmw = WindowedCountMinBank.empty(64, 1024, CMConfig())  # (W, B, d, w) ring
    top = cmw.observe(keys, items).topk_window(10)          # cm_window_fold_sum

Pass ``device="cpu"`` to run the plain PyTorch versions on the CPU.  Every
plan gives bit-identical registers on the same stream (DESIGN.md §3).
"""

from repro_torch.sketch.hll import (  # noqa: F401
    HLLConfig,
    REGISTER_DTYPE,
    alpha,
    cardinality,
    estimate,
    estimate_device,
    hash_index_rank,
    init_registers,
    merge,
    standard_error,
    update,
)
from repro_torch.sketch.estimators import (  # noqa: F401
    DEFAULT_ESTIMATOR,
    Estimator,
    available_estimators,
    estimate_from_histogram,
    estimate_many,
    get_estimator,
    histogram_size,
    register_estimator,
    register_histogram,
    validate_registers,
)
from repro_torch.sketch.plan import (  # noqa: F401
    DEFAULT_PIPELINES,
    DEFAULT_PLAN,
    ExecutionPlan,
    CMBackend,
    available_backends,
    available_bank_backends,
    available_cm_backends,
    available_cm_window_backends,
    example_plans,
    SparseDedup,
    available_sparse_backends,
    available_window_backends,
    available_window_merge_backends,
    get_backend,
    get_bank_backend,
    get_cm_backend,
    get_cm_window_backend,
    get_sparse_backend,
    get_window_backend,
    get_window_merge_backend,
    reference_plan,
    register_backend,
    register_bank_backend,
    register_cm_backend,
    register_cm_window_backend,
    register_sparse_backend,
    register_window_backend,
    register_window_merge_backend,
)

# importing backends registers the built-in "torch"/"cuda"/"cuda_pipelined"
# entries; it must come after .plan (registry) and .hll (primitives).
from repro_torch.sketch import backends  # noqa: F401  (registration side effect)
from repro_torch.sketch.dispatch import datapath_tap, dedup_pairs, update_registers  # noqa: F401
from repro_torch.sketch.carrier import HyperLogLog  # noqa: F401
from repro_torch.sketch.bank import (  # noqa: F401
    SketchBank,
    update_bank_registers,
    update_many,
)
from repro_torch.sketch.sparse import HybridBank, default_threshold  # noqa: F401
from repro_torch.sketch.window import (  # noqa: F401
    HybridWindowedBank,
    MultiResWindowedBank,
    WindowedBank,
)
from repro_torch.sketch.countmin import (  # noqa: F401
    CMConfig,
    CountMinBank,
    WindowedCountMinBank,
    cm_update_many,
    query_cm_counters,
    update_cm_counters,
)
from repro_torch.sketch.setops import (  # noqa: F401
    difference_estimate,
    intersection_estimate,
    jaccard_estimate,
    union_estimate,
)
