"""Dry-run: does each (arch x shape) cell fit, on one card and per position?

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell on 512 placeholder devices and reads XLA's memory and cost analyses.
The port has no compiler to ask, so it runs each cell's step -- the train
step, the prefill or one decode step -- once on ``meta`` tensors (shapes,
no data, no device memory), under the op analysis
(``launch/hlo_analysis.py``), and asks "does it fit": first the whole
program on one card (the (1, 1) mesh), then each position of the
production 16x16 or 2x16x16 mesh under ``sharding/specs.py``'s rules.
Importing this module touches no device, so it needs no ``XLA_FLAGS``
line: ``make_production_mesh`` is given ``meta`` positions.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun

Per cell it writes a JSON record (``run_cell``) with:
  * argument bytes, exact: every leaf of the state, batch or cache, over
    its sharding's shard factor for a position
  * temp bytes: the most the fake run held alive at once of what it
    allocated (outputs included), over the positions for a position (an
    even split: activations shard over batch and heads, grads as params)
  * ``fits_one_card`` and ``fits_per_position`` against the card's memory
    (``torch.cuda.get_device_properties(0).total_memory``, or the
    ``capacity_bytes`` a caller passes)
  * the op analysis's roofline terms, per card, and ``model_flops_global``

Depth is cut to keep the fake runs short, and put back by extrapolation:
every layer of a stage costs the same, and every micro-batch of a step, so
the runs at one and two repeats of the first stage (and, past three
micro-batches, at two and three) determine the cell's counts exactly; the
temp peak grows with the layers and not with the micro-batches.  The fake
run is one process on one device: the collectives an SPMD partitioner would
insert are not in it, so the collective term counts only the port's own
placement rules (none run in these steps).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_arch, is_cell_supported, skip_reason
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import Mesh, make_production_mesh, n_chips
from repro_torch.models import common, registry, transformer
from repro_torch.serve import engine
from repro_torch.sharding import ctx as shardctx
from repro_torch.sharding import specs as shardspecs
from repro_torch.sharding.specs import P, NamedSharding
from repro_torch.train.step import TrainConfig, init_train_state, train_step

META = torch.device("meta")


# ----------------------------------------------------------------------------
# input specs (meta tensors; no device allocation)
# ----------------------------------------------------------------------------


def input_specs(arch: ArchConfig, shape: ShapeConfig, batch_size: Optional[int] = None) -> dict:
    """The cell's step inputs as ``meta`` tensors (``batch_size`` sequences,
    the shape's global batch by default)."""
    b, s = batch_size or shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": torch.empty((b, s), dtype=i32, device=META)}
        if shape.kind == "train":
            batch["targets"] = torch.empty((b, s), dtype=i32, device=META)
        if arch.mrope:
            batch["positions"] = torch.empty((3, b, s), dtype=i32, device=META)
        if arch.frontend_stub_len:
            batch["frontend_embeds"] = torch.empty((b, arch.frontend_stub_len, arch.d_model),
                                                   dtype=common.ACT_DTYPE, device=META)
        return batch
    # decode: one new token against a kv_len cache
    return {
        "token": torch.empty((b,), dtype=i32, device=META),
        "pos": torch.empty((), dtype=i32, device=META),
        "cache": engine.init_cache(arch, b, s, device=META),
    }


def _param_tree(arch: ArchConfig) -> dict:
    """The reference-shaped float32 parameter tree at full depth, as ``meta``
    tensors, from the shape tables alone."""
    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return torch.empty(tree, dtype=common.PARAM_DTYPE, device=META)

    return tensors(transformer.param_shapes(arch))


def state_shardings(state_tree, arch: ArchConfig, mesh: Mesh) -> dict:
    """The training state's shardings on ``mesh``: the parameters and AdamW's
    moments by ``param_specs``, the scalars and the sketch replicated."""
    param_specs = shardspecs.param_specs(
        state_tree["params"], arch,
        data_size=mesh.shape.get("data", 1),
        model_size=mesh.shape.get("model", 1),
    )
    named = shardspecs.named(param_specs, mesh)
    return {
        "params": named,
        "opt": {"mu": named, "nu": named, "count": NamedSharding(mesh, P()), "ef": None},
        "step": NamedSharding(mesh, P()),
        "sketch": NamedSharding(mesh, P()),
    }


def batch_shardings(batch, arch: ArchConfig, mesh: Mesh, global_batch: int) -> dict:
    return {k: NamedSharding(mesh, shardspecs.batch_spec(arch, mesh, global_batch, k)) for k in batch}


def _state_tree(arch: ArchConfig, cfg: TrainConfig) -> dict:
    """The reference-shaped training state at full depth, as ``meta`` tensors."""
    params = _param_tree(arch)
    scalar = torch.empty((), dtype=torch.int32, device=META)
    return {
        "params": params,
        "opt": {"mu": params, "nu": params, "count": scalar,
                "ef": params if cfg.optimizer.compress_grads else None},
        "step": scalar,
        "sketch": torch.empty((cfg.sketch.m,), dtype=torch.uint8, device=META),
    }


def _arguments(arch: ArchConfig, shape: ShapeConfig, cfg: TrainConfig, mesh: Mesh) -> Tuple[dict, dict]:
    """(the step's arguments at full depth as ``meta`` trees, their shardings
    on ``mesh``), each sharding checked against its leaf as jit's
    ``in_shardings`` are."""
    ins = input_specs(arch, shape)
    if shape.kind == "decode":
        params = _param_tree(arch)
        args = {"params": params, "cache": ins["cache"], "token": ins["token"], "pos": ins["pos"]}
        shardings = {
            "params": shardspecs.named(shardspecs.param_specs(
                params, arch, data_size=mesh.shape.get("data", 1), model_size=mesh.shape.get("model", 1)), mesh),
            "cache": shardspecs.named(shardspecs.cache_specs(ins["cache"], arch, mesh, shape.global_batch), mesh),
            "token": NamedSharding(mesh, shardspecs.batch_spec(arch, mesh, shape.global_batch, "token")),
            "pos": NamedSharding(mesh, P()),
        }
    else:
        state = _state_tree(arch, cfg) if shape.kind == "train" else {"params": _param_tree(arch)}
        state_sh = state_shardings(state, arch, mesh)
        if shape.kind == "prefill":
            state_sh = {"params": state_sh["params"]}
        args = {"state": state, "batch": ins}
        shardings = {"state": state_sh, "batch": batch_shardings(ins, arch, mesh, shape.global_batch)}
    shardspecs.check_tree(args, shardings)
    return args, shardings


# ----------------------------------------------------------------------------
# per-cell analysis
# ----------------------------------------------------------------------------


def pick_grad_accum(arch: ArchConfig, shape: ShapeConfig, n_dp: int) -> int:
    """Smallest power-of-two microbatching that bounds layer-boundary
    residuals to ~3 GB a position."""
    if shape.kind != "train":
        return 1
    b_loc = max(1, shape.global_batch // n_dp)
    resid = arch.n_layers * b_loc * shape.seq_len * arch.d_model * 2  # bf16
    mu = 1
    while (
        resid / mu > 3e9
        and mu * 2 <= b_loc
        and shape.global_batch % (mu * 2) == 0
        and (shape.global_batch // (mu * 2)) % n_dp == 0
    ):
        mu *= 2
    return mu


def _stage_repeats(arch: ArchConfig) -> int:
    return transformer.layer_stages(arch)[0][1]


def _with_repeats(arch: ArchConfig, repeats: int) -> ArchConfig:
    """``arch`` with its first stage cut to ``repeats`` repeats (a hybrid's
    trailing mini-stage kept)."""
    if arch.block_pattern is None:
        return dataclasses.replace(arch, n_layers=repeats)
    pat = len(arch.block_pattern)
    return dataclasses.replace(arch, n_layers=pat * repeats + arch.n_layers % pat)


def prefill_fn(model, batch, arch: ArchConfig):
    """The prefill cell's step: the last position's logits and the states."""
    logits, _, states = transformer.forward(model, batch, arch, collect_state=True)
    return logits[:, -1, :], states


def _fake_run(arch: ArchConfig, shape: ShapeConfig, cfg: TrainConfig, batch_size: int) -> dict:
    """One run of the cell's step on ``meta`` tensors under the op analysis;
    its counts as a flat dict of numbers."""
    gen = torch.Generator().manual_seed(0)  # draws nothing on meta
    ins = input_specs(arch, shape, batch_size)
    if shape.kind == "train":
        state = init_train_state(gen, arch, cfg, device=META)
        an = hlo_analysis.analyze(train_step, state, ins, arch, cfg)
    else:
        model = transformer.init_params(arch, gen, META)
        with torch.inference_mode():
            if shape.kind == "prefill":
                an = hlo_analysis.analyze(prefill_fn, model, ins, arch)
            else:
                an = hlo_analysis.analyze(engine.decode_step, model, ins["cache"], ins["token"], ins["pos"], arch)
    counts = {"flops": an.flops, "bytes": an.bytes, "collective_bytes": an.collective_bytes}
    counts.update({f"peak/{site}": v for site, v in an.peak_live_by_site.items()})
    counts.update({f"collectives_by_kind/{k}": v for k, v in an.collectives_by_kind.items()})
    for name, row in an.kernels.items():
        counts.update({f"kernels/{name}/{field}": v for field, v in row.items()})
    return counts


def _line(points: Dict[int, float], at: int) -> float:
    """The line through one or two points, at ``at``."""
    xs = sorted(points)
    if len(xs) == 1:
        return points[xs[0]]
    a, b = xs
    return points[a] + (at - a) * (points[b] - points[a])


def _extrapolate(runs: Dict[Tuple[int, int], dict], repeats: int, micro: int) -> dict:
    """The cell's counts at ``repeats`` repeats of the first stage and
    ``micro`` micro-batches from the runs at (repeats, micro-batches) points:
    bilinear, except the temp peak.  Each site (a line of the code, and in
    a backward pass the autograd node) keeps its own peak (``peak/<site>``),
    the line over the repeats at the micro-batch point where it is highest;
    the cell's peak is the largest of them (the site where it falls can
    change with the depth: at two layers the backward pass's activations,
    at thirty the gradients' accumulation)."""
    rs = sorted({r for r, _ in runs})
    ns = sorted({n for _, n in runs})
    keys = sorted({k for counts in runs.values() for k in counts})
    out = {"peak_live_bytes": 0.0}
    for key in keys:
        def over_r(n):
            return _line({r: runs[r, n].get(key, 0.0) for r in rs}, repeats)

        if key.startswith("peak/"):
            out["peak_live_bytes"] = max(out["peak_live_bytes"], max(over_r(n) for n in ns))
        else:
            out[key] = _line({n: over_r(n) for n in ns}, micro)
    return out


def _analysis(counts: dict) -> hlo_analysis.Analysis:
    kernels: Dict[str, dict] = {}
    by_kind = {}
    for key, v in counts.items():
        if key.startswith("kernels/"):
            _, name, field = key.split("/")
            kernels.setdefault(name, {})[field] = int(round(v))
        elif key.startswith("collectives_by_kind/"):
            by_kind[key.split("/", 1)[1]] = v
    return hlo_analysis.Analysis(
        flops=counts["flops"], bytes=counts["bytes"], collective_bytes=counts["collective_bytes"],
        collectives_by_kind=by_kind, n_while_loops=0, trip_counts={}, kernels=kernels,
        peak_live_bytes=int(round(counts["peak_live_bytes"])),
    )


def _shape_of(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def analyze_cell(arch_id: str, shape, multi_pod: bool = False, overrides: Optional[dict] = None,
                 tp: int = 16, grad_accum: int = 0, mesh: Optional[Mesh] = None):
    """Fake-run one cell (``shape``: a name of ``SHAPES`` or a ``ShapeConfig``)
    on the production mesh (or ``mesh``).  Returns (the op analysis of the
    whole step at full depth, meta: chips, kind, the argument bytes for a
    position and whole, the runs made)."""
    arch = get_arch(arch_id)
    if overrides:
        arch = dataclasses.replace(arch, **overrides)
    shape = _shape_of(shape)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, tp=tp, devices=[META] * (512 if multi_pod else 256))
    chips = n_chips(mesh)

    dp = shardspecs.data_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    cfg = TrainConfig(grad_accum=grad_accum or pick_grad_accum(arch, shape, n_dp))
    hints = shardctx.ActivationHints(
        batch_axes=dp if shape.global_batch % n_dp == 0 else (),
        model_axis="model",
        seq_parallel=bool(int(os.environ.get("REPRO_SEQ_PARALLEL", "0"))),
    )
    args, shardings = _arguments(arch, shape, cfg, mesh)

    repeats = _stage_repeats(arch)
    micro = cfg.grad_accum if shape.kind == "train" else 1
    r_points = (1, 2) if repeats > 1 else (repeats,)
    n_points = (2, 3) if micro > 3 else (micro,)
    per_micro = shape.global_batch // micro
    runs = {}
    with shardctx.use_hints(hints):
        for r in r_points:
            for n in n_points:
                run_cfg = dataclasses.replace(cfg, grad_accum=n)
                runs[r, n] = _fake_run(_with_repeats(arch, r), shape, run_cfg, per_micro * n)
    analysis = _analysis(_extrapolate(runs, repeats, micro))
    meta = {
        "chips": chips, "kind": shape.kind, "grad_accum": cfg.grad_accum,
        "argument_bytes": shardspecs.sharded_bytes(args, shardings),
        "argument_bytes_whole": shardspecs.sharded_bytes(args),
        "runs": [list(k) for k in runs],
        "stage_repeats": repeats,
    }
    return analysis, meta


def card_capacity() -> int:
    """Bytes of the card's memory (raises without a card)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass capacity_bytes")
    return torch.cuda.get_device_properties(0).total_memory


def _memory_dict(analysis: hlo_analysis.Analysis, meta: dict, capacity: int) -> dict:
    chips = meta["chips"]
    temp = analysis.peak_live_bytes
    out = {
        "temp_size_in_bytes": temp // chips,
        "argument_size_in_bytes": meta["argument_bytes"],
        "output_size_in_bytes": 0,  # the outputs are in temp: the fake run allocates them
        "peak_bytes_per_device_est": meta["argument_bytes"] + temp // chips,
        "one_card": {
            "temp_size_in_bytes": temp,
            "argument_size_in_bytes": meta["argument_bytes_whole"],
            "peak_bytes_est": meta["argument_bytes_whole"] + temp,
        },
        "capacity_bytes": capacity,
    }
    return out


def run_cell(
    arch_id: str, shape_name, multi_pod: bool, out_dir: Optional[str],
    overrides: Optional[dict] = None, tag: str = "", tp: int = 16,
    grad_accum: int = 0, capacity_bytes: Optional[int] = None, mesh: Optional[Mesh] = None,
) -> dict:
    """One cell's record, written to ``out_dir`` when given.  ``mesh``
    replaces the production mesh (the (1, 1) mesh asks about one card);
    ``capacity_bytes`` replaces the card's memory (the CPU tests pass it)."""
    arch = get_arch(arch_id)
    shape = _shape_of(shape_name)
    mesh_tag = ("pod2x16x16" if multi_pod else "pod16x16") if mesh is None else (
        "x".join(map(str, mesh.axis_sizes)))
    record = {
        "arch": arch_id, "shape": shape.name, "mesh": mesh_tag + tag,
        "kind": shape.kind, "status": "ok", "overrides": overrides or {},
    }
    if not is_cell_supported(arch, shape):
        record["status"] = "skipped"
        record["skip_reason"] = skip_reason(arch, shape)
        _write(record, out_dir)
        return record

    try:
        capacity = card_capacity() if capacity_bytes is None else capacity_bytes
        t0 = time.perf_counter()
        analysis, meta = analyze_cell(arch_id, shape, multi_pod, overrides, tp, grad_accum, mesh)
        chips = meta["chips"]
        # the reference's lower + compile time; here the fake runs'
        record["compile_s"] = round(time.perf_counter() - t0, 1)
        record["memory_analysis"] = mem = _memory_dict(analysis, meta, capacity)
        record["fits_one_card"] = mem["one_card"]["peak_bytes_est"] <= capacity
        record["fits_per_position"] = mem["peak_bytes_per_device_est"] <= capacity
        record["cost_analysis_raw"] = {"unavailable": True}  # no compiler to ask
        model_flops = registry.model_flops_per_token(arch, shape.kind) * (
            shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        )
        terms = hlo_analysis.roofline_terms(analysis, n_chips=chips, model_flops=model_flops)
        record["roofline"] = {k: (float(v) if isinstance(v, float) else v) for k, v in terms.items()}
        record["hlo"] = {
            "n_while_loops": analysis.n_while_loops,
            "trip_counts": analysis.trip_counts,
            "kernels": analysis.kernels,
            "extrapolated_from": {"stage_repeats": meta["stage_repeats"], "grad_accum": meta["grad_accum"],
                                  "runs": meta["runs"]},
        }
        record["model_flops_global"] = model_flops
        record["chips"] = chips
    except Exception as e:  # a failing cell is a bug -- record it loudly
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    _write(record, out_dir)
    return record


def run_cells(cells, multi_pod: bool, out_dir: Optional[str], jobs: int = 1, **kwargs) -> list:
    """``run_cell`` over (arch, shape) ``cells``, in ``jobs`` worker
    processes (spawned: each imports the port afresh) when more than one;
    the records in the cells' order."""
    if jobs <= 1:
        return [run_cell(a, s, multi_pod, out_dir, **kwargs) for a, s in cells]
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(run_cell, a, s, multi_pod, out_dir, **kwargs) for a, s in cells]
        return [f.result() for f in futures]


def _write(record: dict, out_dir: Optional[str]):
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=2, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="arch field override key=value (int/float/str)")
    ap.add_argument("--tag", default="", help="suffix for the artifact name")
    ap.add_argument("--tp", type=int, default=16,
                    help="TP degree (256//tp becomes DP)")
    ap.add_argument("--grad-accum", type=int, default=0,
                    help="override microbatch count (0 = auto)")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes for the cells")
    ap.add_argument("--capacity-bytes", type=int, default=None,
                    help="a card's memory (default: the card's own; needed without a card)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    records = []
    for mp in meshes:
        tag = ("pod2x16x16" if mp else "pod16x16") + args.tag
        todo = []
        for a, s in cells:
            if args.skip_existing and os.path.exists(os.path.join(args.out, f"{a}__{s}__{tag}.json")):
                print(f"[dryrun] skip existing {a} {s} {tag}")
            else:
                todo.append((a, s))
        recs = run_cells(todo, mp, args.out, args.jobs, overrides=overrides or None, tag=args.tag, tp=args.tp,
                         grad_accum=args.grad_accum, capacity_bytes=args.capacity_bytes)
        for (a, s), rec in zip(todo, recs):
            print(f"[dryrun] {a:18s} {s:12s} {tag:10s} {rec['status']}{_summary(rec)}", flush=True)
        records += recs
    return records


def _summary(rec: dict) -> str:
    if rec["status"] == "ok":
        r, mem = rec["roofline"], rec["memory_analysis"]
        return (
            f" dominant={r['dominant']} bound={r['bound_s']:.4f}s "
            f"useful={r.get('useful_flop_ratio', 0):.3f} "
            f"peak/pos={mem['peak_bytes_per_device_est'] / 2**30:.2f}GiB "
            f"fits_one_card={rec['fits_one_card']} fits_per_position={rec['fits_per_position']}"
        )
    if rec["status"] == "error":
        return " " + rec["error"][:160]
    return ""


if __name__ == "__main__":
    main()
