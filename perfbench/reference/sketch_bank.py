"""Reference of the ``sketch_bank`` system: a bank of tenant rows fed keyed ticks.

``expected`` works the outputs out again from the pool alone: the bank's
registers (entry i lands in row keys[i]; a key outside [0, rows) is
dropped) and each row's exact count, for the state the window ended in
(the first ticks of a pass, into an empty bank) and for the last whole pass
before it, and, where the window read the estimates after each tick, the
estimates of every state the bank passed through.  ``compare`` gives the
numbers that decide ``correct``.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import hll

U32 = 1 << 32


def expected(config: dict, pool: list, calls: int, reads: int = 0, precision: str = "exact") -> dict:
    """{"now": ..., "pass": ... where a whole pass came first, "reads": ...
    if ``reads``}: registers and counts of a bank fed ticks 0, 1, ... of the
    pool, and the estimates after each tick (read j after tick j % ticks of
    its pass).

    ``precision="low"`` is the control: a 32-bit hash, 32-bit counters and
    bfloat16 estimates where the configuration states 64, 64 and float32.
    """
    if config["estimator"] != "original":
        raise ValueError(f"the reference has the 'original' estimator only, not {config['estimator']!r}")
    rows, p, seed = int(config["rows"]), int(config["p"]), int(config["hash_seed"])
    hash_bits = hll.hash_bits_of(config, precision)
    m = 1 << p
    now_calls, whole = hll.pass_calls(len(pool), calls)
    device = pool[0]["items"].device
    registers = torch.zeros(rows * m, dtype=torch.int32, device=device)
    counts = torch.zeros(rows, dtype=torch.int64, device=device)
    states, out = [], {}
    for b, batch in enumerate(pool[: len(pool) if whole else now_calls]):
        for keys, items in zip(batch["keys"].split(hll.BLOCK), batch["items"].split(hll.BLOCK)):
            idx, rank = hll.index_rank(items, p, hash_bits, seed)
            keys = keys.to(torch.int64)
            valid = (keys >= 0) & (keys < rows)
            registers.scatter_reduce_(0, (keys * m + idx)[valid], rank[valid], "amax")
            counts += torch.bincount(keys[valid], minlength=rows)
        if reads:
            states.append(hll.estimates(registers.view(rows, m), p, hash_bits, precision).double().cpu().numpy())
        if b + 1 == now_calls:
            out["now"] = _state(registers, counts, rows, m, precision)
    if whole:
        out["pass"] = _state(registers, counts, rows, m, precision)
    if reads:
        out["reads"] = np.stack([states[j % len(pool)] for j in range(reads)])
    return out


def _state(registers: torch.Tensor, counts: torch.Tensor, rows: int, m: int, precision: str) -> dict:
    host_counts = counts.cpu().numpy().astype(np.uint64)
    return {"registers": registers.view(rows, m).clone(),
            "counts": host_counts % U32 if precision == "low" else host_counts}


def compare(got: dict, want: dict) -> dict:
    """Registers and counters that differ, summed over the states compared;
    with reads, the widest gap of an estimate from the reference's, relative
    to the reference's (or to 1 where the reference reads 0)."""
    numbers = {"registers_differ": 0, "counter_rows_differ": 0}
    for name in ("now", "pass"):
        if name not in want:
            continue
        g, w = got[name], want[name]
        numbers["registers_differ"] += int((g["registers"].to(torch.int32) != w["registers"].to(torch.int32)).sum())
        numbers["counter_rows_differ"] += int((np.asarray(g["counts"], dtype=np.uint64) != w["counts"]).sum())
    if "reads" in want:
        have = np.asarray(got["reads"], dtype=np.float64)
        ref = want["reads"]
        if have.shape != ref.shape:
            raise ValueError(f"reads {have.shape} against the reference's {ref.shape}")
        gap = np.abs(have - ref) / np.maximum(np.abs(ref), 1.0)
        numbers["estimate_rel_gap"] = float(np.nan_to_num(gap, nan=np.inf).max())
    return numbers
