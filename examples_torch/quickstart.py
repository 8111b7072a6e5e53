"""Quickstart: the HLL sketch API in five minutes, on the card.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The port of ``examples/quickstart.py``.  Everything goes through
``repro_torch.sketch``: one ``HyperLogLog`` carrier, one ``update()`` entry
point, and an ``ExecutionPlan`` that picks the backend (the eager "torch"
scatter or the hand-written CUDA kernels), placement, and pipeline count.
"""

import argparse

import numpy as np
import torch

from repro_torch.sketch import (
    CMConfig,
    CountMinBank,
    ExecutionPlan,
    HLLConfig,
    HyperLogLog,
    WindowedBank,
    available_estimators,
    standard_error,
)
from repro_torch.sketch.hll import resolve_device

# Where the reference writes backend "jnp", this file writes
# "cuda_pipelined": k launches of the hll_update_fused kernel folded by the
# bucket_fold kernel (the paper's Fig. 3).  Calls with no plan take
# DEFAULT_PLAN, backend "cuda": the fused kernel, the hash_rank +
# bank_scatter_max pair, the window_fold kernels and cm_scatter_add.  Every
# backend gives bit-identical registers (DESIGN.md §3), so the printed
# numbers do not change; on a CPU tensor each kernel wrapper runs its plain
# version.
BACKEND = "cuda_pipelined"


def tour(n_items: int = 5_000_000, device=None) -> dict:
    """The tour over a stream of ``n_items`` items (a multiple of 10)."""
    device = resolve_device(device)
    # the paper's production configuration: p=16, 64-bit Murmur3
    cfg = HLLConfig(p=16, hash_bits=64)
    print(f"sketch: m=2^{cfg.p} buckets, H={cfg.hash_bits}-bit hash, "
          f"{cfg.memory_footprint_bits // 8 // 1024} KiB packed, "
          f"expected stderr {standard_error(cfg):.2%}")

    # 1) one-shot cardinality of a 5M-item stream with ~3.3M distinct values
    rng = np.random.default_rng(0)
    items = torch.from_numpy(rng.integers(0, 2**22, n_items, dtype=np.int32)).to(device)
    sk = HyperLogLog.of(items, cfg)
    exact = int(torch.unique(items).numel())
    est = sk.estimate()
    print(f"\n{n_items / 1e6:g}M items: exact={exact:,} estimate={est:,.0f} "
          f"error={abs(est - exact) / exact:.3%}")

    # 2) incremental streaming through k pipelines (the paper's Fig. 3 fold);
    #    chunk sizes need not divide the pipeline count -- padding is uniform
    plan = ExecutionPlan(backend=BACKEND, pipelines=8)
    streamed = HyperLogLog.empty(cfg, device)
    for chunk in torch.chunk(items, 5):
        streamed = streamed.update(chunk, plan)
    print(f"streamed in 5 chunks x 8 pipelines: {streamed.estimate():,.0f} "
          f"({streamed.count:,} items counted exactly)")

    # 3) sketches merge losslessly: union of two disjoint streams
    half = n_items // 2
    a = HyperLogLog.of(items[:half], cfg)
    b = HyperLogLog.of(items[half:], cfg)
    merged = a | b
    jaccard = a.jaccard(b)
    print(f"(a | b) estimate:            {merged.estimate():,.0f}")
    print(f"jaccard(a, b):               {jaccard:.3f}")
    print("(bit-identical to sketching the union -- see tests/test_torch_sketch.py)")

    # 4) sketches serialize densely: checkpoint, ship, resume anywhere
    blob = merged.to_bytes()
    back = HyperLogLog.from_bytes(blob, device)
    assert back.estimate() == merged.estimate()
    print(f"serialized sketch: {len(blob):,} bytes, survives round-trip")

    # 5) finalization is pluggable: every estimator reads the same register
    #    histogram (one device bincount), so switching costs nothing
    print("\nestimators on the same sketch "
          f"(exact distinct = {exact:,}):")
    estimates = {}
    for name in available_estimators():
        e = estimates[name] = sk.estimate(estimator=name)
        print(f"  {name:14s} {e:12,.0f}  ({(e - exact) / exact:+.3%})")

    # 6) sliding windows: "distinct in the last k epochs", not all time.
    #    A WindowedBank rings W time buckets; observe() fills the current
    #    bucket, advance() slides the window, and estimate_window(k) is one
    #    fused ring fold + one batched finalization (DESIGN.md §11)
    wcfg = HLLConfig(p=12, hash_bits=64)
    win = WindowedBank.empty(4, 1, wcfg, device)   # W=4 epochs, one tenant row
    for epoch in range(6):
        if epoch:
            win = win.advance()            # epoch - 4 slides out
        lo = epoch * 50_000                # each epoch sees a fresh range
        chunk = torch.arange(lo, lo + 80_000, dtype=torch.int32, device=device)
        win = win.observe(torch.zeros_like(chunk), chunk)
    rolling = float(win.estimate_window()[0])    # last 4 epochs
    newest = float(win.estimate_window(1)[0])    # current epoch only
    print(f"\nwindowed (epoch {win.epoch}): last-4-epochs distinct"
          f"~{rolling:,.0f}, current-epoch~{newest:,.0f} "
          f"(epochs 0-1 expired)")

    # 7) heavy hitters: "WHICH items dominate", not just how many distinct.
    #    A CountMinBank rides the same plan/backend spine -- one fused
    #    d-hash scatter-add per update_many, query() for point frequency
    #    upper bounds, topk(k) for Topkapi label recovery (DESIGN.md §13)
    hcfg = CMConfig(depth=4, width=1024)
    hot = np.repeat(np.arange(8, dtype=np.int32), 5_000)      # 8 heavy ids
    tail = rng.integers(1_000, 2**20, 60_000).astype(np.int32)
    stream = np.concatenate([hot, tail])
    rng.shuffle(stream)
    hh = CountMinBank.empty(1, hcfg, device)                   # one tenant row
    hh = hh.update_many(np.zeros(stream.shape, np.int32), stream)
    vals, cnts = hh.topk(8)
    print(f"\nheavy hitters (d={hcfg.depth}, w={hcfg.width}, "
          f"{hh.nbytes // 1024} KiB bank): "
          + ", ".join(f"{v}x{c}" for v, c in zip(vals[0], cnts[0])))
    point = hh.query(torch.arange(8, dtype=torch.int32, device=device)).cpu().numpy()[0]
    print(f"point queries for ids 0-7 (true 5,000 each, CM upper bounds): "
          f"{point.tolist()}")
    return {"items": items, "exact": exact, "sketch": sk, "streamed": streamed, "merged": merged,
            "jaccard": jaccard, "blob": blob, "estimates": estimates, "window": win,
            "rolling": rolling, "newest": newest, "heavy": hh, "topk": (vals, cnts), "query": point}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs every "
                         "kernel's plain PyTorch version)")
    args = ap.parse_args(argv)
    return tour(device=args.device)


if __name__ == "__main__":
    main()
