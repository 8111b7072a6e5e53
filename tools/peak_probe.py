#!/usr/bin/env python3
"""Where the card's peak allocation of a dry-run cell falls.

    python3 tools/peak_probe.py

Run from the repo root on a machine with a CUDA card.  For each cell that
``chip_smoke.py``'s dryrun phase measures at full width (``DRYRUN_MEASURED``:
smollm-360m and TinyLlama-1.1B train 8 x 1024, RWKV6-3B train 4 x 1024 in 2
micro-batches, RWKV6-3B and TinyLlama-1.1B prefill 8 x 1024), it runs one
step of the same callable under ``torch.cuda.memory._record_memory_history``,
replays the allocator's trace to its peak, and prints the peak and the blocks
alive there, summed by their two innermost frames in the port's code (the
autograd engine's allocations have none).  Set against the dry-run's
prediction (``repro_torch.launch.dryrun``), it shows which tensors the fake
run's count missed.
"""

from __future__ import annotations

import collections
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402


def probe(arch_id: str, kind: str, batch: int, seq: int, accum: int, top: int = 14) -> None:
    torch.cuda.memory._record_memory_history(max_entries=2_000_000)
    peak = chip_smoke._measured_peak(torch.device("cuda"), get_arch(arch_id), kind, batch, seq, accum)
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, best, best_live = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > best:
                best, best_live = cur, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
    print(f"[probe] {arch_id} {kind} {batch} x {seq}: measured peak {peak} bytes, traced peak {best}")
    by_site = collections.Counter()
    for ev in best_live.values():
        frames = [f for f in ev.get("frames", []) if "repro_torch" in f["filename"]]
        by_site[" <- ".join(f"{f['filename'].split('src/')[-1]}:{f['line']}" for f in frames[:2])] += ev["size"]
    for site, size in by_site.most_common(top):
        print(f"[probe]   {size / 1e9:.3f} GB  {site or '(no frame of the port: the autograd engine)'}")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("tools/peak_probe.py needs a CUDA card")
    print(chip_smoke.nvidia_smi())
    for cell in chip_smoke.DRYRUN_MEASURED:
        probe(*cell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
