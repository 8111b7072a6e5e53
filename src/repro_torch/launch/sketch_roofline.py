"""Roofline of the paper's own pipeline: the HLL sketch update on the card.

Port of ``repro/launch/sketch_roofline.py``.  The paper's Fig. 4 measures
sketch throughput against an I/O bound.  On the card the bound is HBM: a
perfect sketch engine reads the token stream once (4 bytes an item) and
touches nothing else, so the ideal memory time is N * 4 / 3.35 TB/s
(NVIDIA's H100 SXM figure, ``hlo_analysis.HBM_BW``): 0.3205 ms for the
2^28 items here.  The reference lowers the sharded update on its
production mesh and reads the compiled program's terms; the port runs
each variant on one card through ``update_registers``, times it with CUDA
events (the median of rounds), and reports the measured time beside the op
analysis's terms (``launch/hlo_analysis.py``: the kernels' declared bytes
and the aten ops around them) and ``roofline_fraction`` = ideal / measured:

    PYTHONPATH=src python -m repro_torch.launch.sketch_roofline

Variants:
  scatter          one fused pass (backend ``cuda``: ``hll_update_fused``)
  pipelined4/8/16  k sub-sketches + max-fold (paper Fig. 3; backend
                   ``cuda_pipelined``: k ``hll_update_fused`` launches and
                   ``bucket_fold``)
  hash32           32-bit hash (paper Fig. 4b), backend ``cuda``

The result needs a card: without one, ``main`` raises.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
from typing import List, Optional

import torch

from repro_torch.launch import hlo_analysis
from repro_torch.sketch import ExecutionPlan, HLLConfig, hll, update_registers

N_ITEMS = 1 << 28  # 268M tokens (a 1 GiB int32 stream)
VARIANTS = (
    ("scatter", HLLConfig(p=16, hash_bits=64), "cuda", 1),
    ("pipelined4", HLLConfig(p=16, hash_bits=64), "cuda_pipelined", 4),
    ("pipelined8", HLLConfig(p=16, hash_bits=64), "cuda_pipelined", 8),
    ("pipelined16", HLLConfig(p=16, hash_bits=64), "cuda_pipelined", 16),
    ("hash32", HLLConfig(p=16, hash_bits=32), "cuda", 1),
)


def ideal_memory_s(n_items: int = N_ITEMS) -> float:
    """The stream read once at the card's HBM rate."""
    return n_items * 4 / hlo_analysis.HBM_BW


def _median_ms(fn, rounds: int, iters: int) -> List[float]:
    """Per-call device ms of ``fn``, one mean over ``iters`` calls a round."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop) / iters)
    return out


def measure_variant(name: str, cfg: HLLConfig, backend: str, pipelines: int, items: torch.Tensor,
                    rounds: int = 5, iters: int = 10) -> dict:
    """One variant's record: its op analysis (one traced call) and its
    measured device time on ``items`` (a flat int32 stream on the card)."""
    regs = hll.init_registers(cfg, items.device)
    plan = ExecutionPlan(backend=backend, placement="local", pipelines=pipelines)

    def call():
        return update_registers(regs, items, cfg, plan)

    an = hlo_analysis.analyze(call)
    terms = hlo_analysis.roofline_terms(an, n_chips=1)
    times = _median_ms(call, rounds, iters)
    measured_ms = statistics.median(times)
    n = items.numel()
    ideal = ideal_memory_s(n)
    return {
        "variant": name,
        "pipelines": pipelines,
        "hash_bits": cfg.hash_bits,
        "backend": backend,
        "compute_s": terms["compute_s"],
        "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"],
        "dominant": terms["dominant"],
        "ideal_memory_s": ideal,
        "measured_ms": measured_ms,
        "measured_rounds_ms": times,
        "roofline_fraction": ideal / (measured_ms / 1e3),
        "collectives_by_kind": terms["collectives_by_kind"],
        "hlo_bytes_per_item_per_chip": an.bytes / n,
        "kernels": an.kernels,
        "registers": an.result,
    }


def make_stream(n_items: int = N_ITEMS, device=None, seed: int = 0) -> torch.Tensor:
    """A seeded flat int32 stream of ``n_items`` uniform items on ``device``
    (the card by default)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (n_items,), dtype=torch.int64, device=device,
                         generator=gen).to(torch.int32)


def run(items: torch.Tensor, variants=VARIANTS, rounds: int = 5) -> list:
    """Every variant's record over ``items``, a stream on the card."""
    if items.device.type != "cuda":
        raise RuntimeError("the sketch roofline measures the card: it needs a CUDA device")
    return [measure_variant(name, cfg, backend, k, items, rounds) for name, cfg, backend, k in variants]


def main(argv: Optional[list] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/sketch_roofline.json")
    ap.add_argument("--items", type=int, default=N_ITEMS)
    args = ap.parse_args(argv)
    results = run(make_stream(args.items))
    for r in results:
        r.pop("registers")
        print(
            f"[sketch] {r['variant']:12s} measured={r['measured_ms']:.4f}ms "
            f"ideal={r['ideal_memory_s'] * 1e3:.4f}ms frac={r['roofline_fraction']:.3f} "
            f"dominant={r['dominant']:12s} bound={r[r['dominant']]:.6f}s "
            f"bytes/item={r['hlo_bytes_per_item_per_chip']:.1f}",
            flush=True,
        )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
