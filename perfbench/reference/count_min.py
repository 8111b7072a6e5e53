"""Reference of the ``count_min`` system: count-min rows with Topkapi labels fed keyed ticks.

Written for the benchmark from DESIGN.md §13's definitions, independent of
the program:

* counters: an entry (key b, item x) adds 1 to the cell ``(b, r, idx_r(x))``
  of each depth row r, where ``idx_r(x) = ((lo + r hi) mod 2^32) mod w``
  over the low and high 32-bit limbs of x's 64-bit Murmur3 (Kirsch and
  Mitzenmacher's double hashing; Cormode and Muthukrishnan's count-min);
  a counter is 32 bits and wraps;
* labels and votes: the batch-canonical Topkapi vote (Mandal et al.), one
  tick a batch.  In each cell the tick hits, the winner x* is the value
  with the most hits there (on a tie, the larger value), with surplus
  ``s = 2 mult(x*) - hits``; the cell's stored (label l, votes c) then
  absorbs (x*, s): where c = 0, (x*, max(s, 0)); where x* = l,
  (l, max(c + s, 0)); otherwise t = s - c gives (x*, t) for t > 0,
  (l, -t) for t < 0 and (max(l, x*), 0) for t = 0.  A cell the tick
  does not hit keeps its pair;
* each row's count of the entries with its key, exact to 2^64;
* an entry whose key lies outside [0, rows) is dropped everywhere.

``expected`` works the outputs out again from the pool alone, for the state
the window ended in (the first ticks of a pass, into an empty bank) and for
the last whole pass before it; ``compare`` gives the numbers that decide
``correct``.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import hll, murmur3

M32 = 0xFFFFFFFF
U32 = 1 << 32
OFFSET = 1 << 31  # a signed 32-bit value plus OFFSET orders as the value does, in [0, 2^32)


def limbs(items: torch.Tensor, seed: int, precision: str = "exact"):
    """(lo, hi) int64 of each item: the 64-bit Murmur3's two 32-bit limbs;
    for the control (``precision="low"``) the two 16-bit halves of the
    32-bit Murmur3 where the configuration states 64 bits."""
    if precision == "low":
        h = murmur3.hash32(items, seed)
        return h & 0xFFFF, h >> 16
    if precision != "exact":
        raise ValueError(f"precision is 'exact' or 'low', got {precision!r}")
    h = murmur3.hash64(items, seed)
    return h & M32, murmur3.lsr64(h, 32)


def hits(keys: torch.Tensor, items: torch.Tensor, config: dict, precision: str = "exact"):
    """(cells, values, rows): the flat cell ``(b d + r) w + idx_r`` of each
    landed entry's d hits and the item value of each hit (int64), and each
    kept entry's row."""
    rows, depth, width = int(config["rows"]), int(config["depth"]), int(config["width"])
    keys = keys.to(torch.int64)
    kept = (keys >= 0) & (keys < rows)
    keys, items = keys[kept], items[kept].to(torch.int64)
    lo, hi = limbs(items, int(config["cm_seed"]), precision)
    r = torch.arange(depth, dtype=torch.int64, device=keys.device)[:, None]
    column = ((lo[None, :] + r * hi[None, :]) & M32) % width
    cells = (keys[None, :] * depth + r) * width + column
    return cells.reshape(-1), items.expand(depth, -1).reshape(-1), keys


def vote(labels: torch.Tensor, votes: torch.Tensor, cells: torch.Tensor, values: torch.Tensor):
    """The (labels, votes) of flat int64 tables after one tick's hits
    (``cells``, ``values``): each hit cell's winner and surplus absorbed by
    the rule above."""
    n = labels.numel()
    pairs, mult = torch.unique((cells << 32) | (values + OFFSET), return_counts=True)
    # the winner a cell: the most hits, then the larger value, as one max
    best = torch.full((n,), -1, dtype=torch.int64, device=labels.device)
    best.scatter_reduce_(0, pairs >> 32, (mult << 32) | (pairs & M32), "amax")
    total = torch.bincount(cells, minlength=n)
    winner = (best & M32) - OFFSET
    s = 2 * (best >> 32) - total
    t = s - votes
    vacant, same = votes == 0, winner == labels
    new_labels = torch.where(vacant | (~same & (t > 0)), winner,
                             torch.where(same | (t < 0), labels, torch.maximum(labels, winner)))
    new_votes = torch.where(vacant, s.clamp(min=0), torch.where(same, (votes + s).clamp(min=0), t.abs()))
    hit = total > 0
    return torch.where(hit, new_labels, labels), torch.where(hit, new_votes, votes)


def expected(config: dict, pool: list, calls: int, reads: int = 0, precision: str = "exact") -> dict:
    """{"now": ..., "pass": ... where a whole pass came first}: counters,
    labels, votes and row counts of a bank fed ticks 0, 1, ... of the pool.

    ``precision="low"`` is the control: the 32-bit Murmur3 and 32-bit row
    counters where the configuration states 64 bits.
    """
    if reads:
        raise ValueError("the count_min system has no per-call read")
    rows, depth, width = int(config["rows"]), int(config["depth"]), int(config["width"])
    n = rows * depth * width
    now_calls, whole = hll.pass_calls(len(pool), calls)
    device = pool[0]["items"].device
    counters = torch.zeros(n, dtype=torch.int64, device=device)
    labels = torch.zeros(n, dtype=torch.int64, device=device)
    votes = torch.zeros(n, dtype=torch.int64, device=device)
    counts = torch.zeros(rows, dtype=torch.int64, device=device)
    out = {}
    for b, batch in enumerate(pool[: len(pool) if whole else now_calls]):
        cells, values, kept = hits(batch["keys"], batch["items"], config, precision)
        counters = (counters + torch.bincount(cells, minlength=n)) & M32
        labels, votes = vote(labels, votes, cells, values)
        counts += torch.bincount(kept, minlength=rows)
        if b + 1 == now_calls:
            out["now"] = _state(counters, labels, votes, counts, precision)
    if whole:
        out["pass"] = _state(counters, labels, votes, counts, precision)
    return out


def _state(counters, labels, votes, counts, precision: str) -> dict:
    host_counts = counts.cpu().numpy().astype(np.uint64)
    return {"counters": counters.clone(), "labels": labels.clone(), "label_counts": votes.clone(),
            "counts": host_counts % U32 if precision == "low" else host_counts}


def _flat(table: torch.Tensor) -> torch.Tensor:
    return table.reshape(-1).to(torch.int64)


def compare(got: dict, want: dict) -> dict:
    """Cells whose counter differs (as uint32), cells whose (label, votes)
    pair differs, and rows whose count differs, summed over the states
    compared."""
    numbers = {"counters_differ": 0, "labels_differ": 0, "counter_rows_differ": 0}
    for name in ("now", "pass"):
        if name not in want:
            continue
        g, w = got[name], want[name]
        numbers["counters_differ"] += int(((_flat(g["counters"]) & M32) != (_flat(w["counters"]) & M32)).sum())
        numbers["labels_differ"] += int(((_flat(g["labels"]) != _flat(w["labels"]))
                                         | (_flat(g["label_counts"]) != _flat(w["label_counts"]))).sum())
        numbers["counter_rows_differ"] += int((np.asarray(g["counts"], dtype=np.uint64) != w["counts"]).sum())
    return numbers
