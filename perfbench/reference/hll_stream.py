"""Reference of the ``hll_stream`` system: one sketch fed the pool's chunks.

``expected`` works the outputs out again from the pool alone: the registers
and the exact item count of the state the window ended in (the first
chunks of a pass, into an empty sketch) and of the last whole pass before
it.  ``compare`` gives the numbers that decide ``correct``.  Imports
nothing of the program.
"""

from __future__ import annotations

import torch

from perfbench.reference import hll

U32 = 1 << 32


def expected(config: dict, pool: list, calls: int, reads: int = 0, precision: str = "exact") -> dict:
    """{"now": ..., "pass": ... where a whole pass came first}, each the
    registers and count of a sketch fed chunks 0, 1, ... of the pool.
    ``precision="low"`` is the control: a 32-bit hash and a 32-bit counter
    where the configuration states 64."""
    p, seed = int(config["p"]), int(config["hash_seed"])
    hash_bits = hll.hash_bits_of(config, precision)
    now_calls, whole = hll.pass_calls(len(pool), calls)
    registers = torch.zeros(1 << p, dtype=torch.int32, device=pool[0]["items"].device)
    items, out = 0, {}
    for b, batch in enumerate(pool[: len(pool) if whole else now_calls]):
        for block in batch["items"].split(hll.BLOCK):
            idx, rank = hll.index_rank(block, p, hash_bits, seed)
            registers.scatter_reduce_(0, idx, rank, "amax")
        items += batch["items"].numel()
        if b + 1 == now_calls:
            out["now"] = _state(registers, items, precision)
    if whole:
        out["pass"] = _state(registers, items, precision)
    return out


def _state(registers: torch.Tensor, items: int, precision: str) -> dict:
    return {"registers": registers.clone(), "count": items % U32 if precision == "low" else items}


def compare(got: dict, want: dict) -> dict:
    """Registers that differ, and the gap between the counts, summed over
    the states compared."""
    differ = gap = 0
    for name in want:
        g, w = got[name], want[name]
        differ += int((g["registers"].to(torch.int32) != w["registers"].to(torch.int32)).sum())
        gap += abs(int(g["count"]) - int(w["count"]))
    return {"registers_differ": differ, "count_gap": gap}
