"""The readings that set each limit of ``correct``: the program and the control.

    python3 -m perfbench.calibrate --workload <name> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--seconds <s>] [--out <file.jsonl>]

Runs the cell once a seed in one process (set-up, a window of ``--seconds``
at the cell's own load, the check) and prints, a line a seed, every number
compared as the program gives it and, for the control seeds, as the control
gives it: the reference put in the program's place, one precision below
the configuration (a 32-bit hash, 32-bit counters and bfloat16 estimates
where the configuration states 64, 64 and float32).  The last line is the
lower reading of each number (the largest over the program's seeds) and
its upper reading (the smallest over the control's).  Benchmark runs never
compute the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program's runs")
    ap.add_argument("--control-seeds", default="", help="seeds (among --seeds) that also read the control")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper, lines = {}, {}, []
    for seed in seeds:
        cell = harness.load_cell(args.workload)
        result = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda"), time.perf_counter(),
                                  control=seed in controls)
        program = {name: c["value"] for name, c in result["checks"].items()}
        line = {"workload": args.workload, "seed": seed, "correct": result["correct"], "program": program,
                "control": result.get("control"), "metrics": result["metrics"], "calls": result["attempted"]}
        for name, value in program.items():
            lower[name] = max(lower.get(name, value), value)
        for name, value in (result.get("control") or {}).items():
            upper[name] = min(upper.get(name, value), value)
        lines.append(line)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "seeds": len(seeds), "control_seeds": len(controls),
               "lower": lower, "upper": upper, "device": torch.cuda.get_device_name(0)}
    lines.append(summary)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
