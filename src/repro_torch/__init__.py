"""repro_torch -- the sketch engine on PyTorch and CUDA for Hopper.

A port of the JAX package ``repro``, which stays beside it as the
reference.  The layout mirrors ``repro`` one module per module
(``repro_torch/sketch/hll.py`` <-> ``repro/sketch/hll.py``); the TPU's
Pallas kernels become hand-written CUDA kernels in
``repro_torch/kernels`` that build with nvcc at their first launch.
Beside the sketches: ``configs``, the attention and RWKV6 families of
``models``, the ``serve`` engine (prefill + decode, the int8 KV cache,
continuous batching) that the telemetry rides in and its coalescing ingest
path (``serve.coalesce``), the observability layer (``obs``: the metrics
registry, span tracing and the report-line format), device meshes for the
mesh and row-sharded placements (``launch.mesh``) and the serve launcher
(``launch.serve``, run as ``python -m repro_torch.launch.serve``).
Nothing here imports ``jax`` or ``repro``.
"""

from repro_torch.sketch import (  # noqa: F401
    CMConfig,
    CountMinBank,
    DEFAULT_PLAN,
    ExecutionPlan,
    HLLConfig,
    HybridBank,
    HybridWindowedBank,
    HyperLogLog,
    MultiResWindowedBank,
    SketchBank,
    WindowedBank,
    WindowedCountMinBank,
    cm_update_many,
    estimate_many,
    reference_plan,
    update_many,
    update_registers,
)
