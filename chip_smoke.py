#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's HLL main path on one NVIDIA card.

    python3 chip_smoke.py

Run from a checkout of the repo on a machine with a CUDA card and the CUDA
toolkit; it needs no arguments and no network.  Phases, each of which
raises (exit code 1) when it fails:

  build    compile the four kernels from src/repro_torch/kernels/csrc with
           nvcc, one process per source, all at once; print the seconds
           and ptxas's register and shared-memory report.
  kernels  each kernel against its plain PyTorch version on the card,
           bit for bit, at the main path's shapes and at ragged lengths,
           with the edge items 0, 0xFFFFFFFF and negative int32, and keys
           -1 and B for the bank; hash/rank also against the pure-python
           Murmur3 oracles.
  stream   the paper's NIC deployment (Tab. IV), lengthened: 2^26 uint32
           items in 16 chunks of 2^22 through ``update_registers`` under
           "cuda" and "cuda_pipelined" (k = 8), for (p, H) in
           {14, 16} x {32, 64}; registers bit-identical to the "torch"
           backend on the card, estimate within 4 standard errors of the
           exact distinct count.
  bank     a 1024-tenant p = 16, H = 64 SketchBank (64 MiB of uint8
           registers): 8 ticks of 2^22 items with Zipf(1.2) tenant keys
           through ``update_many`` under "cuda", bit-identical to "torch";
           ``estimate_many`` against each row's exact distinct count; the
           RHLB bytes round-trip.
  timing   each kernel's device time (CUDA events over warm launches
           queued back to back) and host time per call, its bound (bytes
           over 3.35 TB/s), its plain version's time and, where one
           PyTorch call computes the same function, that call's time.
  profile  torch.profiler over a few stream chunks and bank ticks: wall
           and device-busy time per step, idle share, top device entries.

The launch counters are zeroed just before the stream and bank phases (the
main path) and read just after; every kernel must have launched there.
Before the last line it prints the kernels' JSON record and the card's
name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
With no card it raises before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.kernels import _build, launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.bank_scatter import bank_scatter_max, bank_scatter_max_plain  # noqa: E402
from repro_torch.kernels.bucket_fold import bucket_fold, bucket_fold_plain  # noqa: E402
from repro_torch.kernels.hash_rank import hash_rank, hash_rank_plain  # noqa: E402
from repro_torch.kernels.hll_fused import hll_update_fused, hll_update_fused_plain  # noqa: E402
from repro_torch.sketch import (  # noqa: E402
    ExecutionPlan,
    HLLConfig,
    HyperLogLog,
    SketchBank,
    reference_plan,
)
from repro_torch.sketch.murmur3 import murmur3_32_py, murmur3_64_py  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
STREAM_CONFIGS = ((14, 32), (14, 64), (16, 32), (16, 64))
STREAM_CHUNKS = 16
STREAM_CHUNK_ITEMS = 1 << 22
PIPELINES = 8
BANK_ROWS = 1024
BANK_TICKS = 8
BANK_TICK_ITEMS = 1 << 22
ZIPF_A = 1.2  # tenant skew of benchmarks/bench_serve.py
EDGE_ITEMS = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1], dtype=np.uint32)

KERNEL_SOURCES = {
    "hash_rank": ("src/repro_torch/kernels/csrc/hash_rank.cu", "src/repro/kernels/hash_rank.py:44"),
    "hll_update_fused": ("src/repro_torch/kernels/csrc/hll_fused.cu", "src/repro/kernels/hll_fused.py:91"),
    "bucket_fold": ("src/repro_torch/kernels/csrc/bucket_fold.cu", "src/repro/kernels/bucket_fold.py:26"),
    "bank_scatter_max": ("src/repro_torch/kernels/csrc/bank_scatter.cu", "src/repro/kernels/bank_scatter.py:92"),
}


def _items_tensor(values: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(values.astype(np.uint32).view(np.int32)).to(device)


def _max_abs_err(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Max |a - b|; raises unless the two are bit-identical."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    err = float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0.0
    if err != 0.0:
        raise AssertionError(f"{what}: kernel and plain version differ (max abs err {err})")
    return err


def _stream_items(n: int, rng: np.random.Generator) -> np.ndarray:
    """n uint32 items with the edge values at the front."""
    values = rng.integers(0, 2**32, n, dtype=np.uint32)
    values[: min(n, EDGE_ITEMS.size)] = EDGE_ITEMS[: min(n, EDGE_ITEMS.size)]
    return values


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------


def phase_build() -> dict:
    t0 = time.perf_counter()
    seconds = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s wall, nvcc seconds {seconds}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print("[build] hll_fused: dynamic shared memory m bytes per block (65536 at p = 16); "
          "the other kernels use none")
    return seconds


def phase_kernels(device, n: int = 1 << 22, rows: int = BANK_ROWS, configs=STREAM_CONFIGS) -> dict:
    """Every kernel against its plain version at main-path and ragged sizes."""
    rng = np.random.default_rng(SEED)
    errs = {name: 0.0 for name in KERNEL_SOURCES}
    lengths = (n, n + 3, 1, 127, 1000)
    for p, hash_bits in tuple(configs) + ((4, 64), (8, 32)):
        for seed in (0, 2**64 - 1):
            cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
            for length in lengths:
                values = _stream_items(length, rng)
                x = _items_tensor(values, device)
                idx, rank = hash_rank(x, cfg)
                pidx, prank = hash_rank_plain(x, cfg)
                errs["hash_rank"] = max(
                    errs["hash_rank"],
                    _max_abs_err(idx, pidx, f"hash_rank idx {cfg} n={length}"),
                    _max_abs_err(rank, prank, f"hash_rank rank {cfg} n={length}"),
                )
                # the pure-python Murmur3 oracle on the edge items
                for j, v in enumerate(values[: EDGE_ITEMS.size].tolist()):
                    if hash_bits == 32:
                        h, width = murmur3_32_py(v, seed), 32
                    else:
                        h, width = murmur3_64_py(v, seed), 64
                    rest = h & ((1 << (width - p)) - 1)
                    want = (h >> (width - p), (width - p) - rest.bit_length() + 1)
                    got = (int(idx[j]), int(rank[j]))
                    if got != want:
                        raise AssertionError(f"hash_rank {cfg} item {v:#x}: {got} != oracle {want}")
                # accumulation onto existing registers, and n_valid padding
                regs = torch.from_numpy(
                    rng.integers(0, cfg.max_rank + 1, cfg.m, dtype=np.uint8)
                ).to(device)
                regs[: cfg.m // 2] = 0
                for n_valid in (length, length // 2):
                    errs["hll_update_fused"] = max(
                        errs["hll_update_fused"],
                        _max_abs_err(
                            hll_update_fused(regs, x, n_valid, cfg),
                            hll_update_fused_plain(regs, x, n_valid, cfg),
                            f"hll_update_fused {cfg} n={length} n_valid={n_valid}",
                        ),
                    )
    for k, m, dtype in ((PIPELINES, 1 << 16, torch.uint8), (PIPELINES, 1 << 14, torch.uint8),
                        (3, 20, torch.uint8), (1, 16, torch.uint8), (5, 1001, torch.int32)):
        hi = 62 if dtype == torch.uint8 else 2**31 - 1
        partials = torch.from_numpy(
            rng.integers(0, hi, (k, m)).astype(np.uint8 if dtype == torch.uint8 else np.int32)
        ).to(device)
        errs["bucket_fold"] = max(
            errs["bucket_fold"],
            _max_abs_err(bucket_fold(partials), bucket_fold_plain(partials), f"bucket_fold ({k}, {m}) {dtype}"),
        )
    cfg = HLLConfig(p=16, hash_bits=64)
    bank = torch.from_numpy(rng.integers(0, 20, (rows, cfg.m), dtype=np.uint8)).to(device)
    for length in (n, n + 3, 1, 1000):
        keys = rng.integers(-1, rows + 1, length, dtype=np.int32)  # -1 and B are dropped
        keys[: min(length, 2)] = [-1, rows][: min(length, 2)]
        x = _items_tensor(_stream_items(length, rng), device)
        idx, rank = hash_rank_plain(x, cfg)
        rank[:: 7] = 0  # padding ranks are no-ops
        k_t = torch.from_numpy(keys).to(device)
        errs["bank_scatter_max"] = max(
            errs["bank_scatter_max"],
            _max_abs_err(
                bank_scatter_max(bank, k_t, idx, rank),
                bank_scatter_max_plain(bank, k_t, idx, rank),
                f"bank_scatter_max B={rows} n={length}",
            ),
        )
    print(f"[kernels] bit-identical to their plain versions: max_abs_err {errs}")
    return errs


def phase_stream(device, chunks: int = STREAM_CHUNKS, chunk_items: int = STREAM_CHUNK_ITEMS,
                 configs=STREAM_CONFIGS, pipelines: int = PIPELINES) -> dict:
    """The Tab. IV stream through the kernel backends, held to "torch"."""
    rng = np.random.default_rng(SEED)
    values = rng.integers(0, 2**32, chunks * chunk_items, dtype=np.uint32)
    exact = int(np.unique(values).size)
    x = _items_tensor(values, device)
    plans = {
        "cuda": ExecutionPlan(backend="cuda"),
        "cuda_pipelined": ExecutionPlan(backend="cuda_pipelined", pipelines=pipelines),
        "torch": reference_plan(),
    }
    result = {"items": int(values.size), "exact_distinct": exact, "configs": []}
    for p, hash_bits in configs:
        cfg = HLLConfig(p=p, hash_bits=hash_bits)
        sketches, seconds = {}, {}
        for name, plan in plans.items():
            sk = HyperLogLog.empty(cfg, device)
            _sync(device)
            t0 = time.perf_counter()
            for c in range(chunks):
                sk = sk.update(x[c * chunk_items : (c + 1) * chunk_items], plan)
            _sync(device)
            seconds[name] = time.perf_counter() - t0
            sketches[name] = sk
        for name in ("cuda", "cuda_pipelined"):
            _max_abs_err(sketches[name].registers, sketches["torch"].registers, f"stream {name} {cfg}")
            if sketches[name].count != values.size:
                raise AssertionError(f"stream {name} {cfg}: count {sketches[name].count} != {values.size}")
        est = sketches["cuda"].estimate()
        sigma = sketches["cuda"].standard_error
        # a 32-bit hash maps distinct items together: expected lost distinct
        # values n^2 / 2^33, which the estimator cannot see
        collisions = exact * exact / 2.0**33 if hash_bits == 32 else 0.0
        bound = 4 * sigma * exact + collisions
        if not abs(est - exact) <= bound:
            raise AssertionError(f"stream {cfg}: estimate {est} vs exact {exact}, bound {bound}")
        row = {
            "p": p, "hash_bits": hash_bits, "estimate": est, "rel_err": (est - exact) / exact,
            "bound_rel": bound / exact,
            "items_per_s": {name: values.size / s for name, s in seconds.items()},
        }
        result["configs"].append(row)
        print(f"[stream] {json.dumps(row)}")
    return result


def _zipf_keyed(rows: int, n: int, rng: np.random.Generator):
    """Zipf-popular tenant keys and uniform tokens, as benchmarks/bench_serve.py."""
    keys = ((rng.zipf(ZIPF_A, n) - 1) % rows).astype(np.int32)
    items = rng.integers(0, 2**31, n, dtype=np.int32)
    return keys, items


def phase_bank(device, rows: int = BANK_ROWS, ticks: int = BANK_TICKS,
               tick_items: int = BANK_TICK_ITEMS, p: int = 16, hash_bits: int = 64) -> dict:
    """The multi-tenant serve bank through "cuda", held to "torch"."""
    rng = np.random.default_rng(SEED + 1)
    keys, items = _zipf_keyed(rows, ticks * tick_items, rng)
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    k_t = torch.from_numpy(keys).to(device)
    x_t = torch.from_numpy(items).to(device)
    bank = SketchBank.empty(rows, cfg, device)
    ref = SketchBank.empty(rows, cfg, device)
    cuda_plan, torch_plan = ExecutionPlan(backend="cuda"), reference_plan()
    seconds = 0.0
    for t in range(ticks):
        span = slice(t * tick_items, (t + 1) * tick_items)
        _sync(device)
        t0 = time.perf_counter()
        bank = bank.update_many(k_t[span], x_t[span], cuda_plan)
        _sync(device)
        seconds += time.perf_counter() - t0
        ref = ref.update_many(k_t[span], x_t[span], torch_plan)
    _max_abs_err(bank.registers, ref.registers, "bank registers cuda vs torch")
    if not np.array_equal(bank.counts, ref.counts):
        raise AssertionError("bank counters differ between cuda and torch")
    if not np.array_equal(bank.counts, np.bincount(keys, minlength=rows).astype(np.uint64)):
        raise AssertionError("bank counters are not the exact per-row counts")

    est = bank.estimate_many()
    if est.shape != (rows,) or not bool(torch.isfinite(est).all()):
        raise AssertionError(f"estimate_many: shape {tuple(est.shape)}, finite {bool(torch.isfinite(est).all())}")
    pairs = np.unique((keys.astype(np.int64) << 32) | items.astype(np.int64))
    exact = np.bincount((pairs >> 32).astype(np.int64), minlength=rows)
    sigma = 1.04 / np.sqrt(cfg.m)
    err = np.abs(est.cpu().numpy().astype(np.float64) - exact)
    bound = 6 * sigma * exact + 3
    if not (err <= bound).all():
        worst = int(np.argmax(err / bound))
        raise AssertionError(f"bank row {worst}: estimate {float(est[worst])} vs exact {exact[worst]}")

    blob = bank.to_bytes()
    back = SketchBank.from_bytes(blob, device)
    _max_abs_err(back.registers, bank.registers, "RHLB round trip registers")
    if not np.array_equal(back.counts, bank.counts) or back.to_bytes() != blob:
        raise AssertionError("RHLB round trip changed the bank")
    result = {
        "rows": rows, "items": int(keys.size), "bank_mib": bank.registers.numel() / 2**20,
        "ingest_items_per_s": keys.size / seconds, "max_rel_err": float((err / np.maximum(exact, 1)).max()),
        "rhlb_bytes": len(blob),
    }
    print(f"[bank] {json.dumps(result)}")
    return result


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, args_list, iters: int = 50, warmup: int = 3) -> tuple:
    """(device ms, host ms) per call, each a mean over ``iters`` warm calls.

    Device time: CUDA events around the calls, enqueued behind a sleeping
    kernel so the card runs them back to back and the events time the card,
    not the Python that launches them; the sleep doubles until the host
    finishes enqueuing before the card reaches the first call.  Host time:
    the wall clock of the same calls, synchronized, launch overhead
    included.  ``args_list`` rotates the inputs, so repeated calls do not
    find them all in the 50 MB L2 where the real caller would not.
    """
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(8):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            break
        cycles *= 2
    else:
        raise RuntimeError("the host could not enqueue the timed calls ahead of the card")
    device_ms = start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    return device_ms, (time.perf_counter() - t0) * 1e3 / iters


def phase_timing(device, n: int = 1 << 22, rows: int = BANK_ROWS) -> dict:
    """Kernel, plain and library times at the main path's shapes."""
    rng = np.random.default_rng(SEED + 2)
    cfg = HLLConfig(p=16, hash_bits=64)
    m = cfg.m
    streams = [(_items_tensor(rng.integers(0, 2**32, n, dtype=np.uint32), device),) for _ in range(4)]
    regs = torch.zeros(m, dtype=torch.uint8, device=device)
    partials = torch.from_numpy(rng.integers(0, 50, (PIPELINES, m), dtype=np.uint8)).to(device)
    keys, items = _zipf_keyed(rows, n, rng)
    bank = torch.from_numpy(rng.integers(0, 20, (rows, m), dtype=np.uint8)).to(device)
    k_t = torch.from_numpy(keys).to(device)
    idx, rank = hash_rank(_items_tensor(items.view(np.uint32), device), cfg)
    cells = k_t.to(torch.int64) * m + idx
    rank8 = rank.to(torch.uint8)
    flat = bank.reshape(-1)
    calls = {
        "hash_rank": (
            (lambda x: hash_rank(x, cfg), streams),
            (lambda x: hash_rank_plain(x, cfg), streams),
            None,
            n * (4 + 8),
        ),
        "hll_update_fused": (
            (lambda x: hll_update_fused(regs, x, None, cfg), streams),
            (lambda x: hll_update_fused_plain(regs, x, None, cfg), streams),
            None,
            n * 4 + 2 * m,
        ),
        "bucket_fold": (
            (bucket_fold, [(partials,)]),
            (bucket_fold_plain, [(partials,)]),
            (lambda t: torch.amax(t, 0), [(partials,)]),
            partials.numel() + m,
        ),
        "bank_scatter_max": (
            (bank_scatter_max, [(bank, k_t, idx, rank)]),
            (bank_scatter_max_plain, [(bank, k_t, idx, rank)]),
            (lambda: flat.scatter_reduce(0, cells, rank8, "amax"), [()]),
            2 * bank.numel() + 12 * n,
        ),
    }
    out = {}
    for name, (kernel, plain, library, nbytes) in calls.items():
        ms, host_ms = _time_ms(*kernel)
        plain_ms, plain_host_ms = _time_ms(*plain, iters=3)
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": _time_ms(*library, iters=10)[0] if library else None,
            "host_ms": host_ms, "plain_host_ms": plain_host_ms,
        }
    for name, row in out.items():
        print(f"[timing] {name}: {json.dumps(row)}")
    return out


def phase_profile(device, steps: int = 4, n: int = 1 << 22, rows: int = BANK_ROWS) -> dict:
    """Where the main path's time goes: torch.profiler over a few steps.

    One step is one ``HyperLogLog.update`` of an n-item chunk under "cuda"
    (p = 16, H = 64), or one ``SketchBank.update_many`` tick of n Zipf-keyed
    items.  Prints the wall time per step (without the profiler), the
    card's busy time per step (the sum of its kernel and copy times, from
    the profiler) and the idle share, and the top device entries by self
    time.  Informational: an empty device trace
    is reported, not raised.
    """
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 3)
    cfg = HLLConfig(p=16, hash_bits=64)
    plan = ExecutionPlan(backend="cuda")
    chunk = _items_tensor(rng.integers(0, 2**32, n, dtype=np.uint32), device)
    keys, items = _zipf_keyed(rows, n, rng)
    k_t, x_t = torch.from_numpy(keys).to(device), torch.from_numpy(items).to(device)
    # the carriers are functional, so every step redoes one update of the
    # same filled state
    sk = HyperLogLog.empty(cfg, device).update(chunk, plan)
    bank = SketchBank.empty(rows, cfg, device).update_many(k_t, x_t, plan)
    steps_fn = {
        "stream": lambda: sk.update(chunk, plan),
        "bank": lambda: bank.update_many(k_t, x_t, plan),
    }
    result = {}
    for name, step in steps_fn.items():
        # wall time without the profiler, whose own host cost would add idle
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        rows_ = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in rows_) / 1e3 / steps
        result[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                        "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None}
        print(f"[profile] {name} step: {json.dumps(result[name])}")
        for e in sorted(rows_, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[profile] {name}:   {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
                  f"x{e.count / steps:g}  {e.key[:90]}")
    return result


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    device = torch.device("cuda")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    phase_build()
    errs = phase_kernels(device)

    reset_launches()
    stream = phase_stream(device)
    bank = phase_bank(device)
    launches = launch_counts()
    print(f"[main path] launches {launches}")
    missing = [name for name, count in launches.items() if count == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    timing = phase_timing(device)
    phase_profile(device)
    best = max(stream["configs"], key=lambda r: r["items_per_s"]["cuda"])
    print(f"[timing] stream end to end, cuda: {best['items_per_s']['cuda']:.4g} items/s "
          f"at p={best['p']} H={best['hash_bits']}; bank ingest {bank['ingest_items_per_s']:.4g} items/s")
    kernels = [
        {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
            "bound_ms": timing[name]["bound_ms"], "bound_by": "bytes",
            "library_ms": timing[name]["library_ms"],
        }
        for name, (src, replaces) in KERNEL_SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
