"""The one traffic generator: a traffic file's parameters -> a pool on the device.

A traffic file (``traffic/<config>.<mix>.json``) holds:

* ``pool_items``: items in the pool, made once during set-up;
* ``call_items``: items a call takes; the pool is cut into
  ``pool_items / call_items`` batches, and call i takes batch i % batches;
  each pass over the pool is one data set, landed into a state opened
  empty at the pass's first call;
* ``keys``: absent or null for unkeyed items; ``{"dist": "zipf", "a": a}``
  for keys ``(zipf(a) - 1) mod rows``, as ``benchmarks/bench_serve.py``
  draws tenants; ``{"dist": "uniform"}`` for keys uniform over the rows;
  ``{"dist": "hot", "frac": f, "share": s}`` for the first
  ``max(1, int(f rows))`` rows drawing a share s of the entries, uniform
  among them, and the other rows the rest, uniform among them, as
  ``benchmarks/bench_sparse.py`` draws its hot/cold mix (``rows`` from the
  configuration);
* ``read_each_call``: whether each call is followed by a read of every
  estimate to the host, timed as one closed-loop iteration.

Items are uniform 32-bit words.  Everything is drawn on ``device`` from one
``torch.Generator`` seeded with the run's seed, in a few large calls (the
items first, then the keys), so the same seed gives the same pool, and every
seed the same sizes.
"""

from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1
KEY_BLOCK = 1 << 24  # skewed draws made at a time: 128 MiB of float64 uniforms


def zipf_mod_cdf(a: float, rows: int) -> torch.Tensor:
    """(rows,) float64 CDF of (zipf(a) - 1) mod rows.

    P(k) is proportional to sum_j (k + 1 + j rows)^-a = rows^-a zeta(a, (k + 1) / rows),
    the Hurwitz zeta function; the common factors cancel in the normalisation.
    """
    q = torch.arange(1, rows + 1, dtype=torch.float64) / rows
    weights = torch.special.zeta(torch.tensor(a, dtype=torch.float64), q)
    cdf = torch.cumsum(weights, 0) / weights.sum()
    cdf[-1] = 1.0
    return cdf


def batches_of(traffic: dict) -> int:
    pool_items, call_items = int(traffic["pool_items"]), int(traffic["call_items"])
    if call_items < 1 or pool_items % call_items:
        raise ValueError(f"pool_items {pool_items} is not a whole number of calls of {call_items}")
    return pool_items // call_items


def _hot_keys(spec: dict, rows: int, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n,) int32 keys: the first ``frac`` of the rows draw ``share`` of them."""
    frac, share = float(spec["frac"]), float(spec["share"])
    if not (0.0 < frac <= 1.0 and 0.0 <= share <= 1.0):
        raise ValueError(f"hot keys need 0 < frac <= 1 and 0 <= share <= 1, got {frac}, {share}")
    hot = max(1, int(rows * frac))
    keys = torch.empty(n, dtype=torch.int32, device=device)
    for block in keys.split(KEY_BLOCK):
        u = torch.rand(block.numel(), dtype=torch.float64, generator=gen, device=device)
        hot_keys = torch.randint(0, hot, (block.numel(),), dtype=torch.int32, generator=gen, device=device)
        cold_keys = (torch.randint(hot, rows, (block.numel(),), dtype=torch.int32, generator=gen, device=device)
                     if rows > hot else hot_keys)
        block.copy_(torch.where(u < share, hot_keys, cold_keys))
    return keys


def make(config: dict, traffic: dict, seed: int, device: torch.device) -> list:
    """[{"items": (call_items,) int32, "keys": (call_items,) int32 if keyed}, ...]."""
    batches, call_items = batches_of(traffic), int(traffic["call_items"])
    n = batches * call_items
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & MASK64)
    if traffic.get("items"):
        raise ValueError(f"items are uniform 32-bit words; no other draw is defined: {traffic['items']!r}")
    items = torch.randint(-(1 << 31), 1 << 31, (batches, call_items), dtype=torch.int32,
                          generator=gen, device=device)
    keys_spec = traffic.get("keys")
    if not keys_spec:
        return [{"items": items[b]} for b in range(batches)]
    rows = int(config["rows"])
    if keys_spec["dist"] == "uniform":
        keys = torch.randint(0, rows, (batches, call_items), dtype=torch.int32, generator=gen, device=device)
    elif keys_spec["dist"] == "zipf":
        cdf = zipf_mod_cdf(float(keys_spec["a"]), rows).to(device)
        keys = torch.empty(n, dtype=torch.int32, device=device)
        for block in keys.split(KEY_BLOCK):
            u = torch.rand(block.numel(), dtype=torch.float64, generator=gen, device=device)
            block.copy_(torch.searchsorted(cdf, u, right=True).clamp_(max=rows - 1))
        keys = keys.view(batches, call_items)
    elif keys_spec["dist"] == "hot":
        keys = _hot_keys(keys_spec, rows, n, gen, device).view(batches, call_items)
    else:
        raise ValueError(f"unknown key distribution {keys_spec['dist']!r}")
    return [{"items": items[b], "keys": keys[b]} for b in range(batches)]
