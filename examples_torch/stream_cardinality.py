"""End-to-end streaming cardinality service -- the paper's deployment, on the card.

The port of ``examples/stream_cardinality.py``.  A data stream (synthetic,
counter-addressed -- think NIC packets / storage scan) flows through k
sketch pipelines per device and across all available devices; partial
sketches fold by max (Fig. 3) and the exact host-side finalization reports
the distinct count with its error.  This is the paper-kind end-to-end
deployment: throughput-oriented stream processing with constant-memory state.

    PYTHONPATH=src python examples_torch/stream_cardinality.py --chunks 16 --pipelines 8

``--tenants B`` switches to the multi-tenant SketchBank mode (DESIGN.md §9):
each item is routed to one of B per-tenant sketches by key (item mod B)
and every chunk lands in the whole bank with ONE keyed update_many
dispatch; finalization is one batched estimate_many over the (B, m) bank.

    PYTHONPATH=src python examples_torch/stream_cardinality.py --tenants 64

``--window W`` switches to the sliding-window mode (DESIGN.md §11): the
keyed stream lands in the current bucket of a W-bucket ``WindowedBank``
ring, ``--advance-every N`` opens a new epoch every N chunks, and the
rolling per-tenant distinct count is one fused ring fold + one batched
estimate_many.

    PYTHONPATH=src python examples_torch/stream_cardinality.py \\
        --tenants 16 --window 8 --advance-every 2

The stream is made on the device (``--device``, the card by default;
``cpu`` runs every kernel's plain PyTorch version).
"""

import argparse
import time

import torch

from repro_torch.data.pipeline import DataConfig, batch_at_step
from repro_torch.launch.mesh import local_devices, make_auto_mesh
from repro_torch.sketch import (
    ExecutionPlan, HLLConfig, MultiResWindowedBank, SketchBank, WindowedBank,
    available_estimators, hll, update_registers,
)
from repro_torch.sketch.hll import resolve_device

# Where the reference writes backend "jnp", this file writes
# "cuda_pipelined": k launches of the hll_update_fused kernel folded by the
# bucket_fold kernel (the paper's Fig. 3), and the hash_rank +
# bank_scatter_max and window_fold kernels for the banks and rings.  Every
# backend gives bit-identical registers (DESIGN.md §3), so the printed
# numbers do not change; on a CPU tensor each kernel wrapper runs its plain
# version.
BACKEND = "cuda_pipelined"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_bank(args, cfg, data, device, backend=BACKEND) -> dict:
    """Multi-tenant mode: route the stream into a B-row SketchBank."""
    tenants = args.tenants
    plan = ExecutionPlan(backend=backend, pipelines=args.pipelines,
                         estimator=args.estimator)
    bank = SketchBank.empty(tenants, cfg, device)
    warm = batch_at_step(data, 0, device)["tokens"].reshape(-1)
    # synthetic flow routing: key = item mod B (per-user / per-flow split)
    bank.update_many(warm % tenants, warm, plan)
    _sync(device)

    t0 = time.perf_counter()
    n = 0
    for step in range(args.chunks):
        flat = batch_at_step(data, step, device)["tokens"].reshape(-1)
        bank = bank.update_many(flat % tenants, flat, plan)
        n += flat.numel()
    _sync(device)
    dt = time.perf_counter() - t0

    t1 = time.perf_counter()
    ests = bank.estimate_many(args.estimator).cpu().numpy()
    fin = time.perf_counter() - t1
    total = float(ests.sum())  # keys partition the stream: tenants are disjoint

    print(f"\nsustained: {n * 4 / dt / 1e9:.3f} GB/s  ({n / dt:,.0f} items/s) "
          f"across {tenants} tenants (one update_many per chunk)")
    print(f"batched finalization of {tenants} sketches: {fin * 1e6:.0f} us")
    print(f"per-tenant distinct: min={ests.min():,.0f} "
          f"mean={ests.mean():,.0f} max={ests.max():,.0f}")
    print(f"summed distinct: {total:,.0f} of {n:,} streamed")
    return {"mode": "bank", "streamed": n, "items_per_s": n / dt, "finalize_us": fin * 1e6,
            "estimates": ests, "summed": total, "bank": bank}


def stream_window(args, cfg, data, device, backend=BACKEND) -> dict:
    """Sliding-window mode: a W-bucket ring over the keyed stream."""
    if args.advance_every < 1:
        raise SystemExit("--advance-every must be >= 1")
    rows = max(1, args.tenants)
    plan = ExecutionPlan(backend=backend, pipelines=args.pipelines,
                         estimator=args.estimator)
    if args.window_levels > 0:
        # multi-res ring (DESIGN.md §14): same observe/advance/estimate
        # surface, horizon stretched to W*(2**L - 1) epochs
        win = MultiResWindowedBank.empty(
            args.window, rows, cfg, levels=args.window_levels, device=device
        )
    else:
        win = WindowedBank.empty(args.window, rows, cfg, device)
    warm = batch_at_step(data, 0, device)["tokens"].reshape(-1)
    win.observe(warm % rows, warm, plan)
    _sync(device)

    t0 = time.perf_counter()
    n = 0
    for step in range(args.chunks):
        if step and step % args.advance_every == 0:
            win = win.advance()  # one epoch slides out of the window
        flat = batch_at_step(data, step, device)["tokens"].reshape(-1)
        win = win.observe(flat % rows, flat, plan)
        n += flat.numel()
    _sync(device)
    dt = time.perf_counter() - t0

    t1 = time.perf_counter()
    rolling = win.estimate_window(plan=plan).cpu().numpy()   # last W epochs
    newest = win.estimate_window(1, plan).cpu().numpy()      # current epoch
    fin = time.perf_counter() - t1

    print(f"\nsustained: {n * 4 / dt / 1e9:.3f} GB/s  ({n / dt:,.0f} items/s) "
          f"across {rows} tenants x {args.window} epoch buckets "
          f"(epoch {win.epoch}, advance every {args.advance_every} chunks)")
    print(f"two windowed readings (fused ring fold + estimate_many): "
          f"{fin * 1e6:.0f} us")
    if args.window_levels > 0:
        d = win.density()
        print(f"multi-res ring: {d['slots']} slots over a {d['horizon']}-"
              f"epoch horizon ({d['reduction']:.1f}x smaller than dense)")
    print(f"rolling distinct (last {win.window} epochs): "
          f"min={rolling.min():,.0f} mean={rolling.mean():,.0f} "
          f"max={rolling.max():,.0f}")
    print(f"current-epoch distinct:            "
          f"min={newest.min():,.0f} mean={newest.mean():,.0f} "
          f"max={newest.max():,.0f}")
    return {"mode": "window", "streamed": n, "items_per_s": n / dt, "finalize_us": fin * 1e6,
            "rolling": rolling, "newest": newest, "window": win}


def stream_single(args, cfg, data, device, backend=BACKEND) -> dict:
    """One sketch over the whole stream, k pipelines per device."""
    devices = local_devices(device)
    mesh = make_auto_mesh((len(devices),), ("data",), devices)
    print(f"streaming {args.chunks} x {args.chunk_items:,} items "
          f"({args.distribution}) through {args.pipelines} pipelines "
          f"x {len(devices)} device(s)")

    local_plan = ExecutionPlan(backend=backend, pipelines=args.pipelines)
    sharded_plan = ExecutionPlan(
        backend=backend, placement="mesh", mesh=mesh,
        pipelines=args.pipelines,
    )
    regs = hll.init_registers(cfg, device)
    update = lambda r, x: update_registers(r, x, cfg, local_plan)
    # warm-up off the clock (the paper measures steady-state line rate); on
    # the card it also builds the kernels
    update(regs, batch_at_step(data, 0, device)["tokens"])
    _sync(device)

    t0 = time.perf_counter()
    n = 0
    for step in range(args.chunks):
        tokens = batch_at_step(data, step, device)["tokens"]
        if len(devices) > 1:
            regs = update_registers(regs, tokens, cfg, sharded_plan)
        else:
            regs = update(regs, tokens)
        n += tokens.numel()
    _sync(device)
    dt = time.perf_counter() - t0

    t1 = time.perf_counter()
    # volume-independent finalization (paper: 203us): histogram + O(H-p) sum
    est = hll.estimate(regs, cfg, estimator=args.estimator)
    fin = time.perf_counter() - t1

    print(f"\nsustained: {n * 4 / dt / 1e9:.3f} GB/s  ({n / dt:,.0f} items/s)")
    print(f"finalization: {fin * 1e6:.0f} us (volume-independent)")
    print(f"estimated distinct: {est:,.0f} of {n:,} streamed")
    if args.distribution == "unique":
        print(f"true distinct = {n:,}; error = {abs(est - n) / n:.3%} "
              f"(expected sigma {hll.standard_error(cfg):.3%})")
    return {"mode": "single", "streamed": n, "items_per_s": n / dt, "finalize_us": fin * 1e6,
            "estimate": est, "registers": regs, "devices": len(devices)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--chunk-items", type=int, default=1 << 20)
    ap.add_argument("--pipelines", type=int, default=8)
    ap.add_argument("--p", type=int, default=16)
    ap.add_argument("--tenants", type=int, default=1,
                    help=">1 switches to the keyed SketchBank mode")
    ap.add_argument("--window", type=int, default=0,
                    help=">0 switches to the sliding WindowedBank mode "
                         "with this many ring buckets")
    ap.add_argument("--advance-every", type=int, default=4,
                    help="window mode: open a new epoch every N chunks")
    ap.add_argument("--window-levels", type=int, default=0,
                    help="window mode: >0 uses the multi-resolution "
                         "exponential-histogram ring (DESIGN.md §14) with "
                         "this many levels")
    ap.add_argument("--distribution", default="zipf",
                    choices=["zipf", "uniform", "unique"])
    ap.add_argument("--estimator", default="original",
                    choices=available_estimators(),
                    help="phase-4 finalizer (see repro_torch/sketch/estimators.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs every "
                         "kernel's plain PyTorch version)")
    return ap.parse_args(argv)


def data_config(args) -> DataConfig:
    """The stream: 1024 x (chunk_items / 1024) tokens a chunk over the
    int32 range."""
    return DataConfig(
        vocab_size=2**31 - 1, global_batch=1024,
        seq_len=args.chunk_items // 1024, distribution=args.distribution,
    )


def run(args, backend=BACKEND) -> dict:
    """The mode ``args`` selects, through ``backend``'s kernels."""
    device = resolve_device(args.device)
    cfg = HLLConfig(p=args.p, hash_bits=64)
    data = data_config(args)
    if args.window > 0:
        return stream_window(args, cfg, data, device, backend)
    if args.tenants > 1:
        return stream_bank(args, cfg, data, device, backend)
    return stream_single(args, cfg, data, device, backend)


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
