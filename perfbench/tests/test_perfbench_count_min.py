"""The ``count_min`` system: its reference against a sequential statement of
the vote, each branch of the vote by hand, the port's CPU path, its pool,
its work bytes and the readers of its spans."""

import hashlib
from collections import Counter

import numpy as np
import pytest
import torch

from perfbench import harness, trace
from perfbench import pool as poollib
from perfbench.metrics import work_bytes
from perfbench.metrics.work.count_min import heavy_call
from perfbench.reference import count_min as ref
from perfbench.reference import murmur3
from perfbench.tests.conftest import small_cell

CPU = torch.device("cpu")
CELL = "heavy_hitters.ingest"
M32 = 0xFFFFFFFF


def _sequential(config: dict, pool: list, ticks: int) -> dict:
    """DESIGN.md §13 stated cell by cell in Python integers: each tick's hits
    listed per cell, the winner by (multiplicity, value), then the absorb
    rule; counters mod 2^32 and row counts as Python integers."""
    rows, depth, width, seed = config["rows"], config["depth"], config["width"], config["cm_seed"]
    counters, labels, votes, counts = Counter(), {}, {}, Counter()
    for batch in pool[:ticks]:
        keys, items = batch["keys"].tolist(), batch["items"].tolist()
        h = [int(v) & ((1 << 64) - 1) for v in murmur3.hash64(torch.tensor(items, dtype=torch.int32), seed)]
        tick = {}
        for key, item, hv in zip(keys, items, h):
            if not 0 <= key < rows:
                continue
            counts[key] += 1
            lo, hi = hv & M32, hv >> 32
            for r in range(depth):
                cell = (key, r, ((lo + r * hi) & M32) % width)
                counters[cell] = (counters[cell] + 1) & M32
                tick.setdefault(cell, []).append(item)
        for cell, values in tick.items():
            mult = Counter(values)
            winner = max(mult, key=lambda v: (mult[v], v))
            s = 2 * mult[winner] - len(values)
            label, vote = labels.get(cell, 0), votes.get(cell, 0)
            if vote == 0:
                label, vote = winner, max(s, 0)
            elif winner == label:
                vote = max(vote + s, 0)
            else:
                t = s - vote
                label, vote = (winner, t) if t > 0 else (label, -t) if t < 0 else (max(label, winner), 0)
            labels[cell], votes[cell] = label, vote
    return {"counters": counters, "labels": labels, "votes": votes, "counts": counts}


def _tables(sequential: dict, config: dict):
    shape = (config["rows"], config["depth"], config["width"])
    out = [np.zeros(shape, dtype=np.int64) for _ in range(3)]
    for table, name in zip(out, ("counters", "labels", "votes")):
        for cell, value in sequential[name].items():
            table[cell] = value
    return [t.reshape(-1) for t in out]


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_the_reference_vote_is_the_sequential_statement(seed):
    config = {"rows": 3, "depth": 4, "width": 8, "cm_seed": 0}
    # few distinct items, so that cells see repeats, ties and every branch
    gen = torch.Generator().manual_seed(seed & 0xFFFF)
    pool = [{"keys": torch.randint(-1, 4, (200,), generator=gen, dtype=torch.int32),
             "items": torch.randint(-6, 6, (200,), generator=gen, dtype=torch.int32)} for _ in range(5)]
    want = ref.expected(config, pool, len(pool))["now"]
    sequential = _sequential(config, pool, len(pool))
    counters, labels, votes = _tables(sequential, config)
    assert np.array_equal(want["counters"].numpy(), counters)
    assert np.array_equal(want["labels"].numpy(), labels)
    assert np.array_equal(want["label_counts"].numpy(), votes)
    assert want["counts"].tolist() == [sequential["counts"][b] for b in range(config["rows"])]
    assert int((torch.as_tensor(votes) > 0).sum()) > 0


def _one_cell(label: int, votes: int, values: list):
    """(label, votes) of one cell holding (label, votes) after a tick that hits it with ``values``."""
    cells = torch.zeros(len(values), dtype=torch.int64)
    new_l, new_v = ref.vote(torch.tensor([label, 7]), torch.tensor([votes, 9]), cells,
                            torch.tensor(values, dtype=torch.int64))
    assert (int(new_l[1]), int(new_v[1])) == (7, 9)  # a cell the tick does not hit keeps its pair
    return int(new_l[0]), int(new_v[0])


def test_each_branch_of_the_vote_by_hand():
    # vacant (votes 0): the winner takes the cell with max(s, 0); 5 twice of 3: s = 1
    assert _one_cell(-4, 0, [5, 5, 2]) == (5, 1)
    # vacant, no majority: the larger value of a tie wins, s = 0; s < 0 is kept at 0
    assert _one_cell(-4, 0, [-3, 2]) == (2, 0)
    assert _one_cell(-4, 0, [1, 2, 3, -2 ** 31]) == (3, 0)
    # the stored label wins again: votes add, s = 2 * 2 - 3 = 1
    assert _one_cell(6, 4, [6, 6, 1]) == (6, 5)
    assert _one_cell(6, 1, [6, 1, 2]) == (6, 0)  # same label, s = -1: max(1 - 1, 0)
    # another winner, t = s - votes
    assert _one_cell(6, 2, [9, 9, 9, 9]) == (9, 2)  # s = 4, t = 2 > 0: the winner takes it with t
    assert _one_cell(6, 5, [9, 9, 1]) == (6, 4)  # s = 1, t = -4 < 0: the label stays with -t
    assert _one_cell(6, 3, [9, 9, 9]) == (9, 0)  # s = 3, t = 0: the larger label, no votes
    assert _one_cell(12, 3, [9, 9, 9]) == (12, 0)
    assert _one_cell(-2 ** 31, 2, [2 ** 31 - 1] * 2) == (2 ** 31 - 1, 0)


@pytest.mark.parametrize("dropped", [False, True])
def test_the_reference_agrees_with_the_port_cpu_path(dropped):
    from repro_torch.sketch import CMConfig, CountMinBank

    from perfbench.systems import count_min as system

    cell = small_cell(CELL)
    config = cell.config
    batches = poollib.make(config, cell.traffic, 12, CPU)
    if dropped:  # keys -1 and rows are dropped
        gen = torch.Generator().manual_seed(4)
        batches = [{**b, "keys": torch.randint(-1, config["rows"] + 1, b["keys"].shape, generator=gen,
                                               dtype=torch.int32)} for b in batches]
    n, calls, got = len(batches), len(batches) + 3, {}
    cfg = CMConfig(depth=config["depth"], width=config["width"], seed=config["cm_seed"])
    for i in range(calls):
        if i % n == 0:
            if i:
                got["pass"] = bank
            bank = CountMinBank.empty(config["rows"], cfg, CPU)
        bank = bank.update_many(batches[i % n]["keys"], batches[i % n]["items"])
    got["now"] = bank
    want = ref.expected(config, batches, calls)
    assert ref.compare({k: system.outputs(v) for k, v in got.items()}, want) == {
        "counters_differ": 0, "labels_differ": 0, "counter_rows_differ": 0}
    assert int((want["now"]["label_counts"] > 0).sum()) > 0


def test_the_control_hashes_with_32_bits_and_differs():
    cell = small_cell(CELL)
    batches = poollib.make(cell.config, cell.traffic, 13, CPU)
    items = batches[0]["items"]
    lo, hi = ref.limbs(items, 0, "low")
    h = murmur3.hash32(items, 0)
    assert torch.equal(lo | (hi << 16), h) and int(hi.max()) < 1 << 16
    exact = ref.expected(cell.config, batches, 2 * len(batches))
    low = ref.expected(cell.config, batches, 2 * len(batches), precision="low")
    numbers = ref.compare(low, exact)
    assert numbers["counters_differ"] > 0 and numbers["labels_differ"] > 0
    assert numbers["counter_rows_differ"] == 0  # a pass is far below 2^32 entries
    with pytest.raises(ValueError, match="no per-call read"):
        ref.expected(cell.config, batches, 1, reads=1)


# sha256 of the new cell's small pool on the CPU (batches in order, each
# batch's tensors by name)
POOL_DIGESTS = {7: "c03d6c55d5e08b902cebaadbb2ec55f3", 2**31 + 977: "9cb4c9ee79cd2de639cc1a0d68dff4c0"}


def _digest(batches) -> str:
    h = hashlib.sha256()
    for batch in batches:
        for name in sorted(batch):
            h.update(name.encode())
            h.update(batch[name].contiguous().numpy().tobytes())
    return h.hexdigest()[:32]


@pytest.mark.parametrize("seed", sorted(POOL_DIGESTS))
def test_the_cell_pool_is_pinned(seed):
    cell = small_cell(CELL)
    assert _digest(poollib.make(cell.config, cell.traffic, seed, CPU)) == POOL_DIGESTS[seed]


def test_work_bytes_of_a_tick():
    # a 2^10-entry tick into (8, 4, 64): 4096 hits reach 2048 cells
    assert heavy_call(1 << 10, 8, 4, 64) == 8 * 1024 + 24 * 2048 + 16 * 8
    # the cell's tick: 2^24 hits, at most the bank's 2^22 cells
    assert heavy_call(1 << 22, 1024, 4, 1024) == 134_234_112
    cell = harness.load_cell(CELL)
    assert work_bytes.call_bytes(cell.config, cell.traffic) == 134_234_112


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _cm_ticks(spans: bool):
    """Two count-min ticks: the scatter's kernel, the vote's sort and its
    copy to the host with a synchronize, the counters' kernel; with
    ``spans`` inside the port's ranges, without them as a program lacking
    them leaves its trace."""
    note = lambda name, t0, t1: _x("user_annotation", name, t0, t1 - t0)  # noqa: E731
    launch = lambda ts, corr: _x("cuda_runtime", "cudaLaunchKernel", ts, 4.0, corr)  # noqa: E731
    events = [note(trace.WINDOW, 0.0, 2000.0)]
    for i, t in enumerate((0.0, 1000.0)):
        c = 10 * i
        events += [note("perfbench.call", t, t + 900.0), note("cm_update[cuda]", t + 15, t + 60)]
        if spans:
            events += [note("sketch.cm.update_many", t + 5, t + 890.0), note("sketch.cm.scatter", t + 10, t + 70),
                       note("sketch.cm.vote", t + 80, t + 800), note("sketch.cm.counters", t + 810, t + 880)]
        events += [launch(t + 20, c + 1), _x("kernel", "cm_scatter_kernel", t + 30, 100.0 + i, c + 1),
                   launch(t + 100, c + 2), _x("kernel", "radixSort", t + 140, 400.0 + 10 * i, c + 2),
                   _x("cuda_runtime", "cudaMemcpyAsync", t + 200, 300.0, c + 3),
                   _x("gpu_memcpy", "Memcpy DtoH", t + 540, 2.0, c + 3),
                   _x("cuda_runtime", "cudaStreamSynchronize", t + 600, 5.0),
                   launch(t + 820, c + 4), _x("kernel", "row_count_shared_kernel", t + 830, 50.0, c + 4)]
    return events


def test_readers_of_the_count_min_spans():
    cell = small_cell(CELL)
    rec = harness.Record(cell.config, cell.traffic, trace.summarize(_cm_ticks(spans=True)))
    read = lambda name: harness.metric_reader(name)(rec)  # noqa: E731
    assert read("vote_us.heavy") == pytest.approx(407.0)  # the sort and the copy: 402 and 412 us
    assert read("scatter_us.heavy") == pytest.approx(100.5)
    assert read("launches.heavy") == 4 and read("syncs.heavy") == 1.0
    assert read("kernel_roofline.heavy") == pytest.approx(
        100 * 2 * heavy_call(1024, 8, 4, 64) / work_bytes.HBM_BYTES_PER_S / 1115e-6)


def test_readers_of_the_new_spans_read_nothing_in_a_program_without_them():
    cell = small_cell(CELL)
    rec = harness.Record(cell.config, cell.traffic, trace.summarize(_cm_ticks(spans=False)))
    for name in ("vote_us.heavy", "scatter_us.heavy", "launches.heavy", "syncs.heavy"):
        assert harness.metric_reader(name)(rec) is None, name
    # the harness's own spans read as in any cell
    assert harness.metric_reader("host_us.heavy")(rec) == pytest.approx(900.0 - 305.0)
    assert harness.metric_reader("kernel_roofline.heavy")(rec) > 0
