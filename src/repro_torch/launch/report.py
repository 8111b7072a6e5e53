"""Tables of the dry-run's JSON records.

Port of ``repro/launch/report.py``, reading the records
``repro_torch.launch.dryrun`` writes:

    PYTHONPATH=src python -m repro_torch.launch.report --dir build/dryrun
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List


def load(dir_: str) -> List[dict]:
    records = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            records.append(json.load(f))
    return records


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    return f"{b / 2**30:.2f}GiB"


def roofline_table(recs: List[dict], mesh: str = "pod16x16") -> str:
    rows = [
        "| arch | shape | status | compute_s | memory_s | collective_s | "
        "dominant | MODEL/OPS | roofline frac | bytes/pos | fits/pos |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['status']} | - | - | - | - | - | - | - | - |")
            continue
        rf = r["roofline"]
        mem = r.get("memory_analysis", {}).get("peak_bytes_per_device_est")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['status']} "
            f"| {rf['compute_s']:.4f} | {rf['memory_s']:.4f} "
            f"| {rf['collective_s']:.4f} | {rf['dominant'].replace('_s', '')} "
            f"| {rf.get('useful_flop_ratio', float('nan')):.3f} "
            f"| {rf.get('roofline_fraction', float('nan')):.4f} "
            f"| {fmt_bytes(mem)} | {r['fits_per_position']} |"
        )
    return "\n".join(rows)


def dryrun_table(recs: List[dict]) -> str:
    rows = [
        "| arch | shape | 16x16 | 2x16x16 | fits one card | fake-run s (single/multi) |",
        "|---|---|---|---|---|---|",
    ]
    by_key = {}
    for r in recs:
        by_key.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    for (a, s), pair in sorted(by_key.items()):
        s1 = pair.get("pod16x16", {})
        s2 = pair.get("pod2x16x16", {})
        one = s1.get("fits_one_card", s2.get("fits_one_card", "-"))
        rows.append(
            f"| {a} | {s} | {s1.get('status', '-')} | {s2.get('status', '-')} | {one} "
            f"| {s1.get('compile_s', '-')}/{s2.get('compile_s', '-')} |"
        )
    return "\n".join(rows)


def interesting_cells(recs: List[dict], mesh: str = "pod16x16") -> dict:
    """Pick hillclimb candidates: worst roofline frac, most collective-bound."""
    ok = [r for r in recs if r["status"] == "ok" and r["mesh"] == mesh]
    worst = min(ok, key=lambda r: r["roofline"].get("roofline_fraction", 1))
    coll = max(
        ok,
        key=lambda r: r["roofline"]["collective_s"] / max(r["roofline"]["bound_s"], 1e-12),
    )
    return {"worst_fraction": worst, "most_collective": coll}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("## Dry-run status (both meshes)\n")
    print(dryrun_table(recs))
    print(f"\n## Roofline ({args.mesh})\n")
    print(roofline_table(recs, args.mesh))
    picks = interesting_cells(recs, args.mesh)
    print("\n## Hillclimb candidates")
    for k, r in picks.items():
        print(f"- {k}: {r['arch']} {r['shape']} "
              f"(frac={r['roofline'].get('roofline_fraction'):.4f}, "
              f"dominant={r['roofline']['dominant']})")


if __name__ == "__main__":
    main()
