"""cm_vote: the count-min tick's batch-canonical Topkapi vote.

On the CPU the wrapper runs its plain version (``sketch.countmin.
_label_update``).  These tests check the wrapper's arguments, its launch
plan and scratch layout at their boundaries and the ``meta`` path; and hold
a plain model of the kernel's decomposition (slices sorted by tile, each
tile's hits counted and placed by cell, each cell's winner elected from its
own bucket by the thread, warp or block path, the block path in passes over
ranges of a hash of the value, the absorb rule in wrapping int32) to the
plain version and to the reference's vote (``repro.sketch.countmin.
_label_update``, JAX) on dropped keys, ties, edge values and preset label
state reaching every branch of the rule.

The ``gpu`` tests hold the kernel to the plain version on the card, bit for
bit, at the tick's shape, over depths and widths, on a hot cell, Zipf keys,
ties at the int32 limits, ragged and tiny streams and every branch of the
rule, alone and through ``CountMinBank.update_many``, and check that it
reads nothing back to the host; and hold it to the reference's vote, run by
JAX on the host, on the tick's shape, the hot cell, Zipf keys, the ties,
the dropped keys and the smallest streams.
"""

from __future__ import annotations

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sketch.countmin import CMConfig as RefCMConfig
from repro.sketch.countmin import _label_update as ref_label_update
from repro_torch.kernels import launch_counts
from repro_torch.kernels.cm_vote import (
    BLOCK_SLOTS,
    HIST_TILES,
    MAX_SLICE,
    MIN_SLICE,
    SHARED_HITS,
    THREAD_HITS,
    TILE_CELLS,
    WARP_HITS,
    cm_vote,
    vote_layout,
    vote_plan,
)
from repro_torch.obs import costs
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sketch.countmin import CMConfig, CountMinBank, _label_update, cm_hash_index
from repro_torch.sketch.murmur3 import murmur3_64_py

M32 = (1 << 32) - 1
I32_MIN, I32_MAX = -(2**31), 2**31 - 1
RANGE_HASH = 0x85EBCA6B  # csrc/cm_vote.cu's kRangeHash


def _i32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def _absorb(l: int, lc: int, mc: int, winner: int, total: int):
    """_label_update's rule for one cell in wrapping int32, as the kernel has it."""
    s = _i32(2 * mc - total)
    if lc == 0:
        return winner, max(s, 0)
    if winner == l:
        return l, max(_i32(lc + s), 0)
    t = _i32(s - lc)
    if t > 0:
        return winner, t
    if t < 0:
        return l, _i32(-t)
    return max(l, winner), 0


def _slot_bits(length: int, cap: int) -> int:
    bits = 6
    while (1 << bits) < 2 * length and (1 << bits) < cap:
        bits += 1
    return bits


def _block_elect(values, block_slots: int):
    """The block path: passes over ranges of v * RANGE_HASH mod 2^32; a range
    whose distinct values overflow half the table is halved; returns
    (multiplicity, value) of the winner and the passes that overflowed."""
    limit = (1 << _slot_bits(len(values), block_slots)) // 2
    hashed = [((v & M32) * RANGE_HASH) & M32 for v in values]
    lo, width, best, overflowed = 0, 1 << 32, (0, 0), 0
    while lo < 1 << 32:
        tally = collections.Counter(v for v, h in zip(values, hashed) if 0 <= h - lo < width)
        if len(tally) > limit:
            width >>= 1
            overflowed += 1
            continue
        best = max([best] + [(c, v) for v, c in tally.items()])
        lo += width
        width = min(width << 1, 1 << 32)
    return best, overflowed


def _model(labels, label_counts, keys, items, cfg: CMConfig, sms: int, block_slots: int = BLOCK_SLOTS):
    """csrc/cm_vote.cu's steps in Python: returns the new tables and the
    cells each path elected."""
    rows, depth, width = labels.shape
    n = keys.size
    plan = vote_plan(rows, depth, width, n, sms)
    assert plan.per % 4 == 0 and plan.per * plan.slices >= n > (plan.slices - 1) * plan.per
    # partition: each slice's valid entries by tile, (row in tile, item)
    slices = []
    for s in range(plan.slices):
        part = collections.defaultdict(list)
        for key, item in zip(keys[s * plan.per: (s + 1) * plan.per].tolist(),
                             items[s * plan.per: (s + 1) * plan.per].tolist()):
            if 0 <= key < rows:
                part[key >> plan.tile_shift].append((key & (plan.rows_per_tile - 1), item))
        slices.append(part)
    out_l, out_c = labels.reshape(-1).tolist(), label_counts.reshape(-1).tolist()
    paths = collections.Counter()
    for t in range(plan.tiles):
        hits = depth * sum(len(slices[s].get(t, [])) for s in range(plan.slices))
        if plan.shared and hits > SHARED_HITS:  # counts in shared memory, buckets in the card's
            paths["hot tiles"] += 1
        buckets = collections.defaultdict(list)
        for s in reversed(range(plan.slices)):  # any placement order gives the same buckets' multisets
            for row, item in slices[s].get(t, []):
                h = murmur3_64_py(item & M32, cfg.seed)
                lo, hi = h & M32, h >> 32
                for r in range(depth):
                    col = ((lo + r * hi) & M32) % width
                    buckets[((t << plan.tile_shift) + row) * plan.cells + r * width + col].append(item)
        for cell, values in buckets.items():
            if len(values) <= THREAD_HITS:
                paths["thread"] += 1
                best = max((values.count(v), v) for v in values)
            elif len(values) <= WARP_HITS:
                paths["warp"] += 1
                best = max((c, v) for v, c in collections.Counter(values).items())
            else:
                paths["block"] += 1
                best, over = _block_elect(values, block_slots)
                paths["overflowed passes"] += over
            out_l[cell], out_c[cell] = _absorb(out_l[cell], out_c[cell], best[0], best[1], len(values))
    shape = labels.shape
    return (torch.tensor(out_l, dtype=torch.int32).reshape(shape),
            torch.tensor(out_c, dtype=torch.int32).reshape(shape), paths)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & M32) - (1 << 31)


def _winners(keys, items, rows: int, cfg: CMConfig):
    """(cell, winner, multiplicity, total) int64 tensors of the cells one
    batch touches, from torch.unique on the stream's device."""
    keys, items = torch.as_tensor(keys), torch.as_tensor(items)
    valid = (keys >= 0) & (keys < rows)
    k, x = keys[valid].to(torch.int64), items[valid]
    lane = torch.arange(cfg.depth, device=k.device)[:, None] * cfg.width
    cell = (k[None, :] * cfg.cells + lane + cm_hash_index(x, cfg).to(torch.int64)).reshape(-1)
    val = x.to(torch.int64).expand(cfg.depth, -1).reshape(-1)
    pairs, mult = torch.unique((cell << 32) | (val + (1 << 31)), return_counts=True)
    pc, pv = pairs >> 32, (pairs & M32) - (1 << 31)
    cells, at = torch.unique_consecutive(pc, return_inverse=True)
    total = torch.zeros_like(cells).index_add_(0, at, mult)
    rank = (mult << 32) | (pv + (1 << 31))
    best = torch.full_like(cells, -1).scatter_reduce_(0, at, rank, "amax")
    return cells, (best & M32) - (1 << 31), best >> 32, total


def _preset(keys, items, rows: int, cfg: CMConfig, seed: int, device="cpu"):
    """Label and vote tables on which the batch reaches every branch of the
    absorb rule: the touched cells, by turns, vacant, holding the winner
    (once with a vote of 2^31 - 1, so that lc + s wraps), and t = s - lc
    > 0, < 0 and == 0 (where s != 0), and once with a vote of -2^31, so
    that s - lc wraps; the cells the batch misses hold random int32 state."""
    rng = np.random.default_rng(seed)
    shape = (rows, cfg.depth, cfg.width)
    labels, votes = (torch.from_numpy(rng.integers(I32_MIN, I32_MAX, shape, dtype=np.int64, endpoint=True)
                                      .astype(np.int32)).to(device) for _ in range(2))
    cell, winner, mc, total = _winners(torch.as_tensor(keys).to(device), torch.as_tensor(items).to(device), rows,
                                       cfg)
    s = _wrap32(2 * mc - total)
    branch = torch.arange(cell.numel(), device=cell.device) % 7
    lc = torch.stack([
        torch.zeros_like(s),  # vacant
        1 + branch % 13,  # the winner's label
        torch.full_like(s, I32_MAX),  # the winner's label, lc + s wraps where s > 0
        torch.where(s == 1, 1, _wrap32(s - 1)),  # t = 1
        torch.where(s == -3, 2, _wrap32(s + 3)),  # t = -3
        torch.where(s == 0, 7, s),  # t = 0
        torch.full_like(s, I32_MIN),  # s - lc wraps where s >= 0
    ]).gather(0, branch[None, :])[0]
    label = torch.where((branch == 1) | (branch == 2), winner, winner ^ 1)
    labels.view(-1)[cell] = label.to(torch.int32)
    votes.view(-1)[cell] = lc.to(torch.int32)
    return labels, votes


def _tie_stream(rows: int, values, per_value: int, seed: int):
    """Every key sends every value ``per_value`` times, shuffled: each cell's
    values tie on multiplicity, so the larger signed value must win."""
    rng = np.random.default_rng(seed)
    keys = np.repeat(np.arange(rows, dtype=np.int32), len(values) * per_value)
    items = np.tile(np.repeat(np.asarray(values, dtype=np.int64), per_value), rows).astype(np.int32)
    order = rng.permutation(keys.size)
    return keys[order], items[order]


def _random_stream(n: int, rows: int, seed: int, ids: int = 0):
    """Keys uniform over [-1, rows] (so -1 and B drop), items uniform int32
    or, with ``ids``, Zipf(1.2) over ``ids`` values with the int32 limits
    among them."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1, rows + 1, n, dtype=np.int64).astype(np.int32)
    if ids:
        ranks = (rng.zipf(1.2, n) - 1) % ids
        table = rng.integers(I32_MIN, I32_MAX, ids, dtype=np.int64, endpoint=True)
        table[:4] = [I32_MIN, I32_MAX, -1, 0][: min(ids, 4)]
        items = table[ranks].astype(np.int32)
    else:
        items = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64, endpoint=True).astype(np.int32)
    return keys, items


def _hot_stream(n: int, rows: int, seed: int):
    """Row 0 takes every entry but a few: one tile of more than SHARED_HITS
    hits, Zipf(1.2) items over 2000 values."""
    rng = np.random.default_rng(seed)
    keys = np.where(rng.random(n) < 0.995, 0, rng.integers(-1, rows + 1, n)).astype(np.int32)
    items = ((rng.zipf(1.2, n) - 1) % 2000).astype(np.int32) - 1000
    return keys, items


MODEL_CASES = {
    # name: (rows, cfg, stream, sms, block slots of the model)
    "uniform keys and items": (37, CMConfig(3, 64, seed=9), lambda: _random_stream(3001, 37, 1), 3, BLOCK_SLOTS),
    "zipf items, ties at the limits": (5, CMConfig(2, 16, seed=2**64 - 1), lambda: _random_stream(4099, 5, 2, 40),
                                       1, BLOCK_SLOTS),
    "exact ties": (4, CMConfig(2, 8), lambda: _tie_stream(4, [I32_MIN, -7, -1, 0, 5, I32_MAX], 30, 3), 2,
                   BLOCK_SLOTS),
    "one cell, passes over hash ranges": (1, CMConfig(1, 1), lambda: _random_stream(1500, 1, 4), 1, 64),
    "rows wider than a tile": (3, CMConfig(3, TILE_CELLS // 2 + 5), lambda: _random_stream(2000, 3, 5, 300), 2,
                               BLOCK_SLOTS),
    "one entry": (3, CMConfig(4, 1000), lambda: (np.array([1], np.int32), np.array([I32_MIN], np.int32)), 132,
                  BLOCK_SLOTS),
    "a hot tile, buckets in the card's memory": (2, CMConfig(4, 64), lambda: _hot_stream(SHARED_HITS + 300, 2, 7), 1,
                                                 BLOCK_SLOTS),
    "every key dropped": (3, CMConfig(2, 32), lambda: (np.array([-1, 3, 7, -5, 3], np.int32),
                                                        np.arange(5, dtype=np.int32)), 1, BLOCK_SLOTS),
}


def _reference_vote(labels, votes, keys, items, cfg: CMConfig):
    """The reference's vote (JAX, on the host) -> its two tables as host int32
    tensors."""
    host = [jnp.asarray(torch.as_tensor(t).cpu().numpy()) for t in (labels, votes, keys, items)]
    out = ref_label_update(*host, RefCMConfig(cfg.depth, cfg.width, cfg.seed))
    return tuple(torch.from_numpy(np.array(o)) for o in out)


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_kernel_decomposition_matches_plain(name):
    rows, cfg, stream, sms, block_slots = MODEL_CASES[name]
    keys, items = stream()
    labels, votes = _preset(keys, items, rows, cfg, seed=len(name))
    want_l, want_c = _label_update(labels, votes, torch.from_numpy(keys), torch.from_numpy(items), cfg)
    got_l, got_c, paths = _model(labels, votes, keys, items, cfg, sms, block_slots)
    assert torch.equal(got_l, want_l) and torch.equal(got_c, want_c)
    ref_l, ref_c = _reference_vote(labels, votes, keys, items, cfg)
    assert torch.equal(got_l, ref_l) and torch.equal(got_c, ref_c)
    if name == "one cell, passes over hash ranges":
        assert paths["block"] == 1 and paths["overflowed passes"] > 0
    if name in ("zipf items, ties at the limits", "exact ties"):
        assert paths["warp"] + paths["block"] > 0
    assert (paths["hot tiles"] > 0) == (name == "a hot tile, buckets in the card's memory")


def test_preset_reaches_every_branch_of_the_rule():
    """The preset tables put the batch on each branch of the rule, the
    wrapping ones included, and the vote then changes some labels and
    keeps others."""
    rows, cfg = 37, CMConfig(3, 64, seed=9)
    keys, items = _random_stream(3001, rows, 1, 50)
    labels, votes = _preset(keys, items, rows, cfg, seed=1)
    seen = collections.Counter()
    for cell, winner, mc, total in zip(*(t.tolist() for t in _winners(keys, items, rows, cfg))):
        l, lc = int(labels.view(-1)[cell]), int(votes.view(-1)[cell])
        s = _i32(2 * mc - total)
        t = _i32(s - lc)
        seen["vacant" if lc == 0 else "same" if winner == l else "t>0" if t > 0 else "t<0" if t < 0 else "t=0"] += 1
        seen["wraps"] += lc != 0 and ((winner == l and lc + s != _i32(lc + s)) or (winner != l and s - lc != t))
    assert all(seen[b] > 0 for b in ("vacant", "same", "t>0", "t<0", "t=0", "wraps")), seen
    new_l, _ = _label_update(labels, votes, torch.from_numpy(keys), torch.from_numpy(items), cfg)
    assert 0 < int((new_l != labels).sum()) < labels.numel()


def test_vote_plan_at_its_boundaries():
    # the tick's shape: a row a tile, counts and buckets in shared memory, two slices an SM
    plan = vote_plan(1024, 4, 1024, 1 << 22, 132)
    assert (plan.rows_per_tile, plan.tiles, plan.shared, plan.per, plan.slices) == (1, 1024, True, 15_888, 264)
    assert plan.tile_shift == 0 and plan.cells == TILE_CELLS
    assert 4 * (1 << 22) // 1024 < SHARED_HITS  # a row's hits at uniform keys
    # a row of TILE_CELLS cells fills a tile; one cell more sends the counts to the card's memory
    full = vote_plan(8, 1, TILE_CELLS, 100, 132)
    assert (full.rows_per_tile, full.tiles, full.shared) == (1, 8, True)
    wide = vote_plan(8, 1, TILE_CELLS + 1, 100, 132)
    assert (wide.rows_per_tile, wide.tiles, wide.shared) == (1, 8, False)
    # tiny rows: many rows a tile (a power of two), the last tile fewer, as
    # many as keep the tile's expected hits within half of SHARED_HITS
    tiny = vote_plan(1000, 1, 1, 10, 132)
    assert (tiny.rows_per_tile, tiny.tiles, tiny.shared) == (TILE_CELLS, 1, True)
    assert vote_plan(TILE_CELLS + 1, 1, 1, 10, 132).tiles == 2
    busy = vote_plan(1024, 1, 16, 1 << 22, 132)
    assert busy.rows_per_tile == 2 and 2 * (1 << 22) // 1024 <= SHARED_HITS // 2 < 4 * (1 << 22) // 1024
    assert vote_plan(1024, 1, 16, 0, 132).rows_per_tile == TILE_CELLS // 16
    # no more tiles than a slice's histogram holds: larger tiles, counted on the card's memory
    many = vote_plan(HIST_TILES * 2 + 1, 1, TILE_CELLS, 10, 132)
    assert many.tiles <= HIST_TILES and many.rows_per_tile == 4 and not many.shared
    assert vote_plan(HIST_TILES, 1, TILE_CELLS, 10, 132).tiles == HIST_TILES
    # slices: at least MIN_SLICE entries, at most MAX_SLICE (half that where
    # a tile holds several rows: 8-byte entries), a multiple of 4
    for n, sms, per in ((1, 132, MIN_SLICE), (5, 1, MIN_SLICE), (1 << 20, 132, 3972), (1 << 25, 132, MAX_SLICE),
                        (1 << 25, 1, MAX_SLICE)):
        plan = vote_plan(16, 4, 64, n, sms)
        assert plan.per == per and plan.per % 4 == 0 and plan.slices == -(-n // per)
    many_rows = vote_plan(1 << 20, 1, 16, 1 << 25, 132)
    assert many_rows.rows_per_tile > 1 and many_rows.per == MAX_SLICE // 2


def test_vote_layout_regions_are_aligned_disjoint_and_fit_the_tick():
    n, depth = (1 << 22) + 3, 4
    plan = vote_plan(1024, depth, 1024, n, 132)
    layout = vote_layout(plan, n, depth)
    spans = sorted(layout.values())
    assert all(at % 16 == 0 for at, _ in spans)
    assert all(a + size <= b for (a, size), (b, _) in zip(spans, spans[1:]))
    assert layout["global_counts"][1] == 0
    assert layout["bucket"][1] == 4 * n * depth and layout["packed"][1] == 4 * plan.per * plan.slices
    assert vote_layout(vote_plan(1 << 20, 1, 16, n, 132), n, 1)["packed"][1] % 8 == 0
    # the lists hold every cell that can have more than THREAD_HITS (WARP_HITS) hits
    assert layout["warp_list"][1] >= 16 * (n * depth // (THREAD_HITS + 1))
    assert layout["block_list"][1] >= 16 * (n * depth // (WARP_HITS + 1))
    total = max(at + size for at, size in spans)
    assert total < 110 * 2**20
    # the regions in the order the launcher takes them
    assert list(layout) == ["offsets", "packed", "bucket", "warp_list", "block_list", "global_counts"]
    # rows wider than a tile count on the card's memory, a uint32 a cell
    wide = vote_plan(3, 16, 1024, 1000, 132)
    assert vote_layout(wide, 1000, 16)["global_counts"][1] == 4 * 3 * 16 * 1024


def test_meta_path_returns_empty_tables_and_declares_its_cost():
    class Collector:
        def __init__(self):
            self.kernels = []

        def on_kernel(self, name, flops, nbytes):
            self.kernels.append((name, flops, nbytes))

        def on_collective(self, kind, nbytes):
            raise AssertionError(kind)

    cfg = CMConfig(4, 1024)
    tables = [torch.empty((1024, 4, 1024), dtype=torch.int32, device="meta") for _ in range(2)]
    keys = torch.empty(1 << 22, dtype=torch.int32, device="meta")
    launches = launch_counts()["cm_vote"]
    with costs.collecting(Collector()) as seen:
        out_l, out_c = cm_vote(*tables, keys, keys, cfg)
    for out in (out_l, out_c):
        assert out.device.type == "meta" and out.shape == (1024, 4, 1024) and out.dtype == torch.int32
    assert seen.kernels == [("cm_vote", 0, 8 * (1 << 22) + 16 * 1024 * 4 * 1024)]
    assert launch_counts()["cm_vote"] == launches


def test_wrapper_checks_its_inputs():
    cfg = CMConfig(2, 8)
    t = torch.zeros((3, 2, 8), dtype=torch.int32, device="meta")
    k = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError):
        cm_vote(t, t, k.to(torch.int64), k, cfg)
    with pytest.raises(TypeError):
        cm_vote(t, t.to(torch.int64), k, k, cfg)
    with pytest.raises(ValueError):
        cm_vote(t, t, k, k[:4], cfg)
    with pytest.raises(ValueError):
        cm_vote(t[:, :1], t, k, k, cfg)
    with pytest.raises(ValueError):
        cm_vote(t, t, k, k, CMConfig(2, 9))
    big = torch.zeros((1 << 17, 1, 1 << 14), dtype=torch.int32, device="meta")  # B * d * w = 2^31
    with pytest.raises(ValueError):
        cm_vote(big, big, k, k, CMConfig(1, 1 << 14))
    # uint32 items are their int32 bits
    out_l, _ = cm_vote(t, t, k, k.view(torch.uint32), cfg)
    assert out_l.shape == t.shape


def test_cpu_path_is_the_plain_vote():
    rows, cfg = 7, CMConfig(3, 32, seed=4)
    keys, items = _random_stream(2000, rows, 6, 30)
    labels, votes = _preset(keys, items, rows, cfg, seed=6)
    before = (labels.clone(), votes.clone())
    launches = launch_counts()["cm_vote"]
    got = cm_vote(labels, votes, torch.from_numpy(keys), torch.from_numpy(items), cfg)
    want = _label_update(labels, votes, torch.from_numpy(keys), torch.from_numpy(items), cfg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(labels, before[0]) and torch.equal(votes, before[1])
    assert launch_counts()["cm_vote"] == launches
    # update_many votes through it: a bank's tick equals the plain vote
    bank = CountMinBank(torch.zeros_like(labels), labels, votes, torch.zeros((rows, 2), dtype=torch.int64), cfg)
    after = bank.update_many(keys, items)
    assert torch.equal(after.labels, want[0]) and torch.equal(after.label_counts, want[1])


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _on_card(labels, votes, keys, items, cfg):
    """The kernel on the card against the plain vote on the card, with no
    read to the host; returns the cells that took the warp and block paths."""
    dev = torch.device("cuda")
    labels, votes = labels.to(dev), votes.to(dev)
    keys, items = torch.as_tensor(keys).to(dev), torch.as_tensor(items).to(dev)
    before = (labels.clone(), votes.clone())
    cm_vote(labels[:1], votes[:1], keys[:1], items[:1], cfg)  # built and loaded before the check below
    launches = launch_counts()["cm_vote"]
    torch.cuda.synchronize()
    obs_metrics.enable()
    obs_metrics.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cm_vote(labels, votes, keys, items, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        seen = {p for p in ("shared", "global") if obs_metrics.counter_value(f"cm.vote.{p}")}
        obs_metrics.disable()
        obs_metrics.reset()
    want = _label_update(labels, votes, keys, items, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(labels, before[0]) and torch.equal(votes, before[1])
    assert launch_counts()["cm_vote"] == launches + 1
    plan = vote_plan(labels.shape[0], cfg.depth, cfg.width, keys.numel(), torch.cuda.get_device_properties(dev)
                     .multi_processor_count)
    assert seen == {"shared" if plan.shared else "global"}
    return cm_vote.cooperative.tolist()


def _card_case(name: str):
    """(labels, votes, keys, items, cfg) of a named case, on the host."""
    if name == "tick shape, 2^22 + 3 entries":
        rows, cfg = 1024, CMConfig(4, 1024)
        keys, items = _random_stream((1 << 22) + 3, rows, 11)
    elif name.startswith("d="):
        depth, width = (int(part.split("=")[1]) for part in name.split())
        rows, cfg = 64, CMConfig(depth, width, seed=depth * width)
        keys, items = _random_stream((1 << 16) + 3, rows, depth + width, 500)
    elif name == "hot cell: one item 2^20 times among noise":
        rows, cfg = 1024, CMConfig(4, 1024)
        keys, items = _random_stream(1 << 20, rows, 12)
        rng = np.random.default_rng(13)
        at = rng.choice(keys.size + (1 << 20), 1 << 20, replace=False)
        mask = np.zeros(keys.size + (1 << 20), bool)
        mask[at] = True
        k, x = np.empty(mask.size, np.int32), np.empty(mask.size, np.int32)
        k[mask], x[mask] = 7, -123456
        k[~mask], x[~mask] = keys, items
        keys, items = k, x
    elif name == "zipf(1.2) keys":
        rows, cfg = 1024, CMConfig(4, 1024)
        rng = np.random.default_rng(14)
        keys = ((rng.zipf(1.2, 1 << 22) - 1) % rows).astype(np.int32)
        items = rng.integers(I32_MIN, I32_MAX, keys.size, dtype=np.int64, endpoint=True).astype(np.int32)
    elif name == "exact ties at the int32 limits":
        rows, cfg = 256, CMConfig(4, 64)
        keys, items = _tie_stream(rows, [I32_MIN, I32_MIN + 1, -2, -1, 0, 1, I32_MAX - 1, I32_MAX], 37, 15)
    elif name == "one cell of 2^18 distinct items":
        rows, cfg = 1, CMConfig(1, 1)
        keys, items = _random_stream(1 << 18, rows, 16)
        keys[:] = 0
    elif name == "w=2^16":
        rows, cfg = 7, CMConfig(2, 1 << 16, seed=11)
        keys, items = _random_stream(1 << 18, rows, 19, 3000)
    elif name == "2^23 + 5 entries in 1025 slices: segments gathered in chunks":
        rows, cfg = 4096, CMConfig(1, 16, seed=12)
        keys, items = _random_stream((1 << 23) + 5, rows, 20, 1 << 16)
    elif name == "rows of 2^20 cells":
        rows, cfg = 3, CMConfig(2, 1 << 19, seed=3)
        keys, items = _random_stream(1 << 20, rows, 17, 5000)
    elif name == "one entry":
        rows, cfg = 5, CMConfig(4, 1024)
        keys, items = np.array([4], np.int32), np.array([I32_MAX], np.int32)
    elif name == "1027 entries, keys dropped":
        rows, cfg = 5, CMConfig(4, 1000)
        keys, items = _random_stream(1027, rows, 18, 20)
    else:
        assert name == "every key dropped"
        rows, cfg = 5, CMConfig(4, 1024)
        keys = np.array([-1, 5, 9, I32_MIN, I32_MAX], np.int32)
        items = np.arange(5, dtype=np.int32)
    dev = torch.device("cuda")
    labels, votes = _preset(keys, items, rows, cfg, seed=len(name), device=dev)
    return labels, votes, torch.from_numpy(keys).to(dev), torch.from_numpy(items).to(dev), cfg


CARD_CASES = (
    ["tick shape, 2^22 + 3 entries"]
    + [f"d={d} w={w}" for d in (1, 4, 16) for w in (1, 1000, 1024)]
    + ["hot cell: one item 2^20 times among noise", "zipf(1.2) keys", "exact ties at the int32 limits",
       "one cell of 2^18 distinct items", "w=2^16", "2^23 + 5 entries in 1025 slices: segments gathered in chunks",
       "rows of 2^20 cells", "one entry", "1027 entries, keys dropped", "every key dropped"]
)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CARD_CASES)
def test_vote_on_card_matches_plain(name):
    _need_card()
    warp_cells, block_cells = _on_card(*_card_case(name))
    if name in ("hot cell: one item 2^20 times among noise", "zipf(1.2) keys", "one cell of 2^18 distinct items"):
        assert block_cells > 0
    if name in ("one entry", "every key dropped"):
        assert warp_cells == block_cells == 0


REFERENCE_CASES = (
    "tick shape, 2^22 + 3 entries", "d=16 w=1000", "hot cell: one item 2^20 times among noise", "zipf(1.2) keys",
    "exact ties at the int32 limits", "one cell of 2^18 distinct items", "one entry", "1027 entries, keys dropped",
    "every key dropped",
)


@pytest.mark.gpu
@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_vote_on_card_matches_the_reference(name):
    """The kernel on the card against the reference's vote, JAX on the host."""
    _need_card()
    labels, votes, keys, items, cfg = _card_case(name)
    launches = launch_counts()["cm_vote"]
    got_l, got_c = cm_vote(labels, votes, keys, items, cfg)
    assert launch_counts()["cm_vote"] == launches + 1
    want_l, want_c = _reference_vote(labels, votes, keys, items, cfg)
    assert torch.equal(got_l.cpu(), want_l) and torch.equal(got_c.cpu(), want_c)


@pytest.mark.gpu
def test_bank_ticks_on_card_vote_like_the_plain_vote():
    _need_card()
    dev = torch.device("cuda")
    rows, cfg = 1024, CMConfig(4, 1024)
    bank = CountMinBank.empty(rows, cfg, dev)
    labels, votes = bank.labels, bank.label_counts
    launches = launch_counts()["cm_vote"]
    for tick in range(3):
        keys, items = _random_stream(1 << 20, rows, 40 + tick, 5000)
        k, x = torch.from_numpy(keys).to(dev), torch.from_numpy(items).to(dev)
        bank = bank.update_many(k, x)
        labels, votes = _label_update(labels, votes, k, x, cfg)
        assert torch.equal(bank.labels, labels) and torch.equal(bank.label_counts, votes)
    assert launch_counts()["cm_vote"] == launches + 3
