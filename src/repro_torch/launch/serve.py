"""Serving launcher: --arch selection, prefill + batched decode + telemetry.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch tinyllama-1.1b] \\
        --requests 8 --prompt-len 64 --gen-len 32 [--reduced | --full-config] \\
        [--placement sharded] [--device cpu] [--metrics-out metrics.json]

Port of ``repro/launch/serve.py``: the same flags, defaults, printed lines,
spans, gauges and snapshot file.  The model runs on ``--device`` (the card
by default; ``cpu`` runs every kernel's plain PyTorch version).  Every
``--arch`` serves: the attention families (dense, vlm, audio; the default
``--arch tinyllama-1.1b``), MoE (mixtral-8x7b, olmoe-1b-7b), the RG-LRU
hybrid (recurrentgemma-9b) and RWKV6.

The sketch-telemetry ingest runs the production serve path (DESIGN.md
§16): every request SUBMITS its token stream to a coalescing queue and the
merged batch lands as ONE ``update_many`` per tick
(repro_torch/serve/coalesce.py); ``--placement sharded`` splits the banks'
tenant-row axis over the process's devices (every visible card, or the one
CPU) with block-local key routing, bit-identical to local placement.  The
sliding-window ring is shared across requests through ``SharedWindowRing``
so the §14 incremental fold state amortizes across the fleet instead of
rebuilding per request.

``--metrics-out`` turns on the repro_torch.obs metrics registry for the run
(DESIGN.md §15): per-request read latency histograms (p50/p99), items/s
and density gauges, dispatch counts per registry axis/backend, sparse
compaction counters, coalescer tick sizes, and window-cache hit rates land
in one snapshot JSON, with a periodic ``[metrics]`` report line every
``--report-every`` requests (0 = no periodic lines, snapshot at exit only).
Without it the registry stays in its no-op default.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch.mesh import Mesh, local_devices, make_auto_mesh
from repro_torch.models import transformer
from repro_torch.obs import metrics, tracing
from repro_torch.obs.format import (
    fmt_bytes,
    fmt_count,
    fmt_float,
    fmt_pct,
    fmt_rate,
    kv_line,
    metrics_report_line,
    per_second,
    truncated_note,
)
from repro_torch.serve import engine
from repro_torch.serve.coalesce import CoalescingQueue, SharedWindowRing
from repro_torch.sketch import (
    CMConfig,
    CountMinBank,
    ExecutionPlan,
    HLLConfig,
    HybridBank,
    MultiResWindowedBank,
    WindowedBank,
)
from repro_torch.sketch.estimators import DEFAULT_ESTIMATOR, available_estimators
from repro_torch.sketch.hll import resolve_device
from repro_torch.telemetry.sketchboard import StreamSketch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--estimator", default=DEFAULT_ESTIMATOR,
                    choices=available_estimators(),
                    help="phase-4 finalizer for the telemetry board")
    ap.add_argument("--window-epochs", type=int, default=4,
                    help="ring buckets for the sliding request window")
    ap.add_argument("--window-levels", type=int, default=0,
                    help=">0 swaps the dense window ring for the "
                         "multi-resolution exponential histogram "
                         "(DESIGN.md §14): --window-epochs full-resolution "
                         "buckets per level, horizon stretched to "
                         "W*(2**L - 1) epochs")
    ap.add_argument("--sparse-threshold", type=int, default=None,
                    help="distinct-bucket promotion threshold for the "
                         "hybrid per-request bank (default: m // 4)")
    ap.add_argument("--topk", type=int, default=5,
                    help="heavy-hitter tokens to report per request stream "
                         "(0 disables the count-min telemetry)")
    ap.add_argument("--cm-depth", type=int, default=4,
                    help="count-min depth rows for --topk tracking")
    ap.add_argument("--cm-width", type=int, default=1024,
                    help="count-min counters per depth row for --topk")
    ap.add_argument("--placement", default="local",
                    choices=("local", "sharded"),
                    help="'sharded' splits the telemetry banks' tenant-row "
                         "axis over this process's devices with block-local "
                         "key routing (DESIGN.md §16); bit-identical to "
                         "'local'")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable the metrics registry (DESIGN.md §15) and "
                         "write the snapshot JSON here at exit")
    ap.add_argument("--report-every", type=int, default=4,
                    help="print a [metrics] line every N requests (needs "
                         "--metrics-out); 0 disables the periodic lines and "
                         "only the exit snapshot is written")
    ap.add_argument("--device", default=None,
                    help="torch device for the model and the sketches "
                         "(default: the card; 'cpu' runs every kernel's "
                         "plain PyTorch version)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    return ap


def _model(args, arch, device) -> transformer.Model:
    """The model's weights, drawn from ``--seed`` on ``device``."""
    return transformer.init_params(arch, torch.Generator(device=device).manual_seed(args.seed), device)


def _prompts(args, arch, device) -> torch.Tensor:
    """(requests, prompt_len) int32 prompt tokens, drawn from ``--seed`` + 1."""
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    return torch.randint(0, arch.vocab_size, (args.requests, args.prompt_len), generator=gen,
                         device=device, dtype=torch.int32)


def _data_mesh(device: torch.device) -> Mesh:
    """A ("data",) mesh over the process's devices of ``device``'s kind:
    every visible card, or the one CPU."""
    devices = local_devices(device)
    return make_auto_mesh((len(devices),), ("data",), devices)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)

    if args.metrics_out:
        metrics.enable()
        metrics.reset()

    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    model = _model(args, arch, device)
    # the plan's estimator rides to board.report(), which finalizes all
    # streams with one batched estimate_many dispatch; --topk adds the
    # count-min twin so the same flush also tracks heavy-hitter tokens
    cm_cfg = (
        CMConfig(depth=args.cm_depth, width=args.cm_width, seed=args.seed)
        if args.topk > 0
        else None
    )
    board = StreamSketch(
        HLLConfig(p=12, hash_bits=64),
        plan=ExecutionPlan(
            estimator=args.estimator, sparse_threshold=args.sparse_threshold
        ),
        track_topk=cm_cfg,
        device=device,
    )
    # the board's single-sketch streams have no row axis; the multi-tenant
    # banks below ingest and finalize under the serve placement (§16)
    ingest_plan = board.plan
    if args.placement == "sharded":
        ingest_plan = board.plan.with_sharding(_data_mesh(device))

    B, S, T = args.requests, args.prompt_len, args.gen_len
    prompts = _prompts(args, arch, device)
    batch = {"tokens": prompts}
    if arch.mrope:
        batch["positions"] = transformer.default_positions(arch, B, S, device)
    if arch.frontend_stub_len:
        gen = torch.Generator(device=device).manual_seed(args.seed + 2)
        batch["frontend_embeds"] = torch.randn(
            (B, arch.frontend_stub_len, arch.d_model), generator=gen, device=device
        ).to(torch.bfloat16) * 0.02

    # each span ends with a device synchronize, so that the printed tok/s
    # are the card's: PyTorch returns before the card has finished
    with tracing.span("serve.prefill", metric="serve.prefill.seconds") as pre:
        logits, cache = engine.prefill(model, batch, arch, kv_len=S + T + 1)
        first = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        _sync(device)

    with tracing.span("serve.decode", metric="serve.decode.seconds") as dec:
        out, _ = engine.decode_loop(model, cache, first, S, arch, steps=T)
        _sync(device)

    board.observe("prompt_tokens", prompts)
    board.observe("generated_tokens", out)
    # per_second guards the zero/near-zero elapsed a --smoke-sized run can
    # produce: "inf tok/s" on a report line instead of ZeroDivisionError
    print(
        f"{args.arch}: "
        f"prefill {fmt_rate(per_second(B * S, pre.elapsed_s), 'tok')}, "
        f"decode {fmt_rate(per_second(B * T, dec.elapsed_s), 'tok')}"
    )
    metrics.gauge(
        "serve.items_per_s",
        per_second(B * (S + T), pre.elapsed_s + dec.elapsed_s),
    )
    report = board.report(
        density=True, topk=args.topk if args.topk > 0 else None
    )
    for name, row in report.items():
        print(kv_line(f"sketch[{name}]", [
            ("distinct~", fmt_count(row["estimate"])),
            ("seen", fmt_count(row["items_seen"])),
            ("dup", fmt_float(row["duplication"], 2)),
            ("occ", fmt_pct(row["register_occupancy"])),
        ]))
        if args.topk > 0:
            hits = ", ".join(f"{v}x{c}" for v, c in row["topk"])
            print(f"    top-{args.topk} tokens: {hits}")
    bd = board.density()
    metrics.gauge("serve.board.occupancy_mean", bd["occupancy_mean"])
    print(kv_line("board density", [
        ("sparse-eligible", f"{bd['sparse_eligible']}/{bd['streams']}"),
        ("occupancy", fmt_pct(bd["occupancy_mean"])),
        ("hybrid~", fmt_bytes(bd["hybrid_nbytes_estimate"])),
        ("dense", fmt_bytes(bd["dense_nbytes"])),
    ]))

    # per-request distinct-token telemetry: one HybridBank row per request.
    # Each request SUBMITS its (prompt + generated) stream to the
    # coalescing queue -- cheap host appends -- and the whole fleet lands as
    # ONE hybrid-routed update_many tick (DESIGN.md §9, §12, §16); requests
    # with few distinct tokens stay in the sparse COO layout and the bank
    # reports its own storage win.  Sparse-destined pairs ride the deferred
    # append log until estimate_many()/density() below settle the bank --
    # the first read IS the flush seam, no explicit compact() call needed.
    # The bank shares the board's config so both readings stay comparable.
    bank = HybridBank.empty(
        B, board.cfg, threshold=board.plan.sparse_threshold, device=device
    )
    rows = torch.arange(B, dtype=torch.int32, device=device)[:, None]
    req_keys = rows.expand(prompts.shape)
    gen_keys = rows.expand(out.shape)
    queue = CoalescingQueue(device=device)
    prompts_np, out_np = prompts.cpu().numpy(), out.cpu().numpy()
    for r in range(B):
        queue.submit_row(r, np.concatenate([prompts_np[r], out_np[r]]))
    bank = queue.flush_into(bank, ingest_plan)
    per_req = bank.estimate_many(args.estimator, plan=ingest_plan).cpu().numpy()
    bank_d = bank.density()
    metrics.gauge("serve.bank.density_reduction", bank_d["reduction"])
    print(kv_line(f"bank[{B} requests] distinct tokens/request", [
        ("min", fmt_count(per_req.min())),
        ("mean", fmt_count(per_req.mean())),
        ("max", fmt_count(per_req.max())),
    ]) + " (one hybrid update_many pass)")
    print(kv_line("bank density", [
        ("promoted", f"{bank_d['dense_rows']}/{bank_d['rows']}"),
        ("occupancy", fmt_pct(bank_d["occupancy_mean"])),
        ("reduction", f"{fmt_float(bank_d['reduction'], 1)}x"),
    ]))

    # per-request heavy hitters (DESIGN.md §13): one CountMinBank row per
    # request stream, every (prompt + generated) token routed by request
    # index with ONE fused d-hash scatter-add, then a single batched
    # Topkapi recovery answers "top-k tokens per request stream" -- the
    # frequency twin of the distinct-count bank above.
    if args.topk > 0:
        hh = CountMinBank.empty(B, cm_cfg, device=device)
        hh = hh.update_many(
            torch.cat([req_keys.reshape(-1), gen_keys.reshape(-1)]),
            torch.cat([prompts.reshape(-1), out.reshape(-1)]),
            board.plan,
        )
        vals, cnts = hh.topk(args.topk)
        shown = min(B, 4)
        print(kv_line(f"heavy[{B} requests] top-{args.topk} tokens/request", [
            ("d", args.cm_depth),
            ("w", args.cm_width),
            ("bank", fmt_bytes(hh.nbytes)),
        ]))
        for r in range(shown):
            hits = ", ".join(
                f"{v}x{c}" for v, c in zip(vals[r], cnts[r]) if c > 0
            )
            print(f"    request {r}: {hits}")
        if B > shown:
            print(truncated_note(shown, B, "requests"))

    # sliding-window telemetry (DESIGN.md §11): a WindowedBank ring over
    # decode time -- the prompt lands in epoch 0, each decode slice opens a
    # new epoch, and the rolling per-request distinct count is ONE fused
    # ring fold + one batched estimate_many per reading.  With W buckets
    # the prompt epoch slides out once --window-epochs slices have landed.
    W = args.window_epochs
    # the device joins the reference's key: a ring lives on one device
    ring_key = ("serve", args.window_levels, W, B, board.cfg, device)
    if args.window_levels > 0:
        # multi-res mode (DESIGN.md §14): same carrier surface, but the
        # horizon stretches to W*(2**L - 1) epochs at O(W*L) slots -- the
        # prompt epoch coarsens into merged buckets instead of expiring
        win = SharedWindowRing.get_or_create(
            ring_key,
            lambda: MultiResWindowedBank.empty(
                W, B, board.cfg, levels=args.window_levels, device=device
            ),
        )
    else:
        win = SharedWindowRing.get_or_create(
            ring_key, lambda: WindowedBank.empty(W, B, board.cfg, device=device)
        )
    win = win.observe(req_keys, prompts, ingest_plan)
    # torch.tensor_split sizes its sections as np.array_split does
    for chunk in torch.tensor_split(out, W, dim=1):
        if chunk.shape[1] == 0:
            # --gen-len < --window-epochs: the split pads the tail with
            # token-less slices.  Rotating on them would expire the prompt
            # epoch after fewer than W REAL decode slices (and coarsen
            # empty multi-res buckets), so empty slices do not advance.
            continue
        win = win.advance()
        win = win.observe(rows.expand(chunk.shape), chunk, ingest_plan)
    # publish the advanced ring so later requests (and re-entries in this
    # process) share the §14 decomposed fold state instead of refolding
    win = SharedWindowRing.swap(ring_key, win)
    rolling = win.estimate_window(plan=ingest_plan, estimator=args.estimator).cpu().numpy()
    newest = win.estimate_window(1, ingest_plan, args.estimator).cpu().numpy()
    span = win.window  # horizon for the EH carrier, W for the dense ring
    print(kv_line(f"window[{span} epochs] rolling distinct/request", [
        ("min", fmt_count(rolling.min())),
        ("mean", fmt_count(rolling.mean())),
        ("max", fmt_count(rolling.max())),
        ("newest-mean", fmt_count(newest.mean())),
    ]))
    if args.window_levels > 0:
        d = win.density()
        print(kv_line("multi-res ring", [
            ("slots", d["slots"]),
            ("horizon", f"{d['horizon']} epochs"),
            ("reduction", f"{fmt_float(d['reduction'], 1)}x"),
        ]))

    # per-request read-path latency (DESIGN.md §15): each request's
    # dashboard read -- rolling window estimate + its distinct count --
    # timed into the serve.request.seconds histogram.  Repeated window
    # reads hit the per-instance fold cache, which is exactly what the
    # window.fold_cache hit/miss counters in the snapshot make visible.
    for r in range(B):
        with tracing.span(
            "serve.request", metric="serve.request.seconds", request=r
        ):
            est = win.estimate_window(plan=ingest_plan,
                                      estimator=args.estimator)
            _reading = (float(est[r]), float(per_req[r]))
        if (
            metrics.enabled()
            and args.report_every > 0
            and (r + 1) % args.report_every == 0
        ):
            print(metrics_report_line(metrics.snapshot()))

    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(metrics.to_json())
        print(f"  metrics snapshot written to {args.metrics_out}")


if __name__ == "__main__":
    main()
