"""The port's analysis launchers: the op analysis, the kernels' declared
costs, the dry-run, its report and the sketch roofline.

* ``hlo_analysis.analyze`` on a callable: exactly 2 * 64 * 128 * 32 FLOPs for
  the plain matmul (``meta`` and CPU tensors), 8x one product for an eager
  loop of 8, 20x for nested loops of 5 and 4; no while loops, no trip counts.
* On the reduced prefill cell (``dryrun.prefill_fn``: the last position's
  logits and the states; 1024 tokens, two key blocks of the blocked
  attention) of three dense archs and the RG-LRU hybrid its FLOPs equal the
  reference's HLO ``analyze()`` FLOPs of the same cell exactly
  (``DENSE_FLOPS_RTOL`` = 0; measured equal).  Not the MoE family: the
  reference dispatches tokens to experts by one-hot products, which its
  analyzer counts as dots (3.4x the port's FLOPs at olmoe's reduced
  size); the port dispatches by index.
* A reduced RWKV6 prefill: the FLOPs are its GEMMs, counted here from the
  shapes, plus ``rwkv_intra``'s declared cost, one launch a layer.
* Each wrapper on ``meta`` tensors returns its kernel's output shapes and
  declares the FLOPs and bytes of ``chip_smoke.py``'s bound column.
* The dry-run: ok and skipped records for reduced archs and for one
  full-width arch, every tensor of the fake runs on ``meta``; its depth
  extrapolation exact against a deeper run; ``report`` renders the records.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as ref_get_arch
from repro.launch import hlo_analysis as ref_hlo
from repro.models import transformer as ref_transformer

from repro_torch.configs import ARCH_IDS, SHAPES, get_arch, is_cell_supported
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.kernels import launch_counts
from repro_torch.kernels import (bank_scatter, bucket_fold, cm_scatter, hash_rank, hll_fused, rwkv_intra,
                                 sparse_scatter, window_fold)
from repro_torch.launch import dryrun, hlo_analysis, report, sketch_roofline
from repro_torch.launch.mesh import Mesh, make_test_mesh
from repro_torch.models import transformer
from repro_torch.obs import costs
from repro_torch.optim import compress
from repro_torch.sketch import CMConfig, ExecutionPlan, HLLConfig, update_registers
from repro_torch.train import step

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

META = torch.device("meta")
DENSE_FLOPS_RTOL = 0.0
CAPACITY = 80 * 10**9
CARD_PEAK_BAND = (0.98, 1.05)  # the card's peak over the dry-run's (test_dryrun_peak_against_the_card)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ----------------------------------------------------------------------------
# the op analysis
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_plain_matmul_exact(device):
    a, b = torch.ones(64, 128, device=device), torch.ones(128, 32, device=device)
    an = hlo_analysis.analyze(lambda x, y: x @ y, a, b)
    assert an.flops == 2 * 64 * 128 * 32
    assert an.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert an.n_while_loops == 0 and an.trip_counts == {}
    assert an.peak_live_bytes == 4 * 64 * 32


def test_eager_loop_counts_every_trip():
    def loop(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    an = hlo_analysis.analyze(loop, _meta(128, 256), _meta(8, 256, 256))
    assert an.flops == 8 * 2 * 128 * 256 * 256
    assert an.n_while_loops == 0 and an.trip_counts == {}


def test_nested_loops_multiply():
    def nested(x, ws):
        for i in range(ws.shape[0]):
            for _ in range(4):
                x = torch.tanh(x @ ws[i])
        return x

    an = hlo_analysis.analyze(nested, _meta(32, 64), _meta(5, 64, 64))
    assert an.flops == 5 * 4 * 2 * 32 * 64 * 64


@pytest.mark.parametrize("arch_id", ["tinyllama-1.1b", "qwen3-32b", "phi4-mini-3.8b", "recurrentgemma-9b"])
def test_prefill_flops_equal_reference_hlo(arch_id):
    ref_arch, arch = ref_get_arch(arch_id).reduced(), get_arch(arch_id).reduced()
    b, s = 2, 1024

    def ref_prefill(params, batch):  # the reference dry-run's prefill cell
        logits, _, states = ref_transformer.forward(params, batch, ref_arch, collect_state=True)
        return logits[:, -1, :], states

    params = jax.eval_shape(lambda k: ref_transformer.init_params(k, ref_arch), jax.ShapeDtypeStruct((2,), jnp.uint32))
    compiled = jax.jit(ref_prefill).lower(params, {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}).compile()
    want = ref_hlo.analyze(compiled.as_text()).flops
    model = transformer.init_params(arch, torch.Generator(), META)
    with torch.inference_mode():
        an = hlo_analysis.analyze(dryrun.prefill_fn, model, {"tokens": _meta(b, s, dtype=torch.int32)}, arch)
    assert an.flops == pytest.approx(want, rel=DENSE_FLOPS_RTOL, abs=0)


def _rwkv_gemm_flops(arch, b: int, s: int) -> int:
    """The GEMMs of an RWKV6 forward, from the shapes: per layer the ddlerp
    LoRA (5 trunks of rank 32), r/k/v/g and the output, the decay LoRA
    (rank 64), the channel mix, the chunked form's inter-chunk products
    (the output against the carried state and the state update, per
    chunk); then the head."""
    d, f, h, n, c = arch.d_model, arch.d_ff, arch.n_heads, arch.rwkv_head_dim, arch.rwkv_chunk_size
    tok = b * s
    per_layer = (5 * 2 * tok * d * 32 * 2 + 5 * 2 * tok * d * d + 2 * 2 * tok * d * 64
                 + 2 * tok * (d * f + d * d + f * d) + 2 * (s // c) * 2 * b * c * h * n * n)
    return arch.n_layers * per_layer + 2 * tok * d * arch.vocab_size


def test_rwkv_prefill_is_its_gemms_plus_the_kernels_declared_cost():
    arch = get_arch("rwkv6-3b").reduced()
    b, s = 2, 256
    model = transformer.init_params(arch, torch.Generator(), META)
    with torch.inference_mode():
        an = hlo_analysis.analyze(dryrun.prefill_fn, model, {"tokens": _meta(b, s, dtype=torch.int32)}, arch)
    c, n = arch.rwkv_chunk_size, arch.rwkv_head_dim
    g = b * (s // c) * arch.n_heads
    assert an.kernels == {"rwkv_intra": {"launches": arch.n_layers,
                                         "flops": arch.n_layers * rwkv_intra.intra_flops(g, c, n),
                                         "bytes": arch.n_layers * 4 * (6 * g * c * n + g * n)}}
    assert an.flops == _rwkv_gemm_flops(arch, b, s) + an.kernels["rwkv_intra"]["flops"]


def test_declared_flops_are_chip_smokes_bound_counts():
    for shape in [(5120, 64, 64), (1280, 64, 64), (7, 40, 64), (3, 1, 64)]:
        assert rwkv_intra.intra_flops(*shape) == chip_smoke.intra_flops(*shape)
        assert rwkv_intra.intra_bwd_flops(*shape) == chip_smoke.intra_bwd_flops(*shape)


class _Devices(TorchDispatchMode):
    """Every device an op's tensor outputs land on."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
        return out


def _declared(fn, *args):
    """(what ``fn`` returns on meta inputs, the costs it declared), checking
    that nothing left ``meta``."""
    rows = []

    class Sink:
        def on_kernel(self, name, flops, nbytes):
            rows.append((name, flops, nbytes))

        def on_collective(self, kind, nbytes):
            rows.append((kind, nbytes))

    devices = _Devices()
    with costs.collecting(Sink()), devices:
        out = fn(*args)
    assert devices.seen <= {"meta"}
    return out, rows


def test_wrappers_on_meta_declare_the_bound_columns_cost():
    n, rows, m = 1 << 22, 1024, 1 << 16
    cfg = HLLConfig(p=16, hash_bits=64)
    i32 = torch.int32
    items = _meta(n, dtype=i32)
    cases = [
        (hash_rank.hash_rank, (items, cfg), [((n,), i32), ((n,), i32)], n * (4 + 8), 0),
        (hll_fused.hll_update_fused, (_meta(m, dtype=torch.uint8), items, None, cfg), [((m,), torch.uint8)],
         n * 4 + 2 * m, 0),
        (bucket_fold.bucket_fold, (_meta(8, m, dtype=torch.uint8),), [((m,), torch.uint8)], 8 * m + m, 0),
        (bank_scatter.bank_scatter_max, (_meta(rows, m, dtype=torch.uint8), items, items, items),
         [((rows, m), torch.uint8)], 2 * rows * m + 12 * n, 0),
        (sparse_scatter.sparse_scatter_coo, (items, items, items, 16384, 4096), [((16384, 4096), i32), ((16384,), i32)],
         12 * n + 4 * 16384 * 4096 + 4 * 16384, 0),
        (window_fold.window_fold_max, (_meta(64, rows, 4096, dtype=torch.uint8), _meta(64, dtype=torch.bool)),
         [((rows, 4096), torch.uint8)], 64 * rows * 4096 + rows * 4096, 0),
        (window_fold.window_merge_max, (_meta(3, rows, 4096, dtype=torch.uint8),), [((rows, 4096), torch.uint8)],
         4 * rows * 4096, 0),
        (cm_scatter.cm_scatter_add, (_meta(rows, 4, 1024, dtype=i32), items, items, CMConfig(4, 1024)),
         [((rows, 4, 1024), i32)], 8 * n + 2 * rows * 4 * 1024 * 4, 0),
        (cm_scatter.cm_window_fold_sum, (_meta(64, rows, 4096, dtype=i32), _meta(64, dtype=torch.bool)),
         [((rows, 4096), i32)], 4 * 64 * rows * 4096 + 4 * rows * 4096, 0),
        (rwkv_intra.rwkv_intra, (*[_meta(5120, 64, 64)] * 5, _meta(5120, 64)), [((5120, 64, 64), torch.float32)],
         4 * (6 * 5120 * 64 * 64 + 5120 * 64), chip_smoke.intra_flops(5120, 64, 64)),
        (rwkv_intra.rwkv_intra_bwd, (*[_meta(1280, 64, 64)] * 5, _meta(1280, 64), _meta(1280, 64, 64)),
         [((1280, 64, 64), torch.float32)] * 5 + [((1280, 64), torch.float32)],
         4 * (11 * 1280 * 64 * 64 + 2 * 1280 * 64), chip_smoke.intra_bwd_flops(1280, 64, 64)),
    ]
    for fn, args, outs, nbytes, flops in cases:
        before = launch_counts()[fn.__name__]
        out, rows_ = _declared(fn, *args)
        out = out if isinstance(out, tuple) else (out,)
        assert [(tuple(t.shape), t.dtype) for t in out] == outs, fn.__name__
        assert rows_ == [(fn.__name__, flops, nbytes)], fn.__name__
        assert launch_counts()[fn.__name__] == before  # nothing launched


def test_meta_outputs_match_the_plain_versions_shapes():
    rng = np.random.default_rng(0)
    cfg = HLLConfig(p=8, hash_bits=64)
    items = torch.from_numpy(rng.integers(-(2**31), 2**31, 1000).astype(np.int32))
    regs = torch.zeros(cfg.m, dtype=torch.uint8)
    for fn, args in [(hash_rank.hash_rank, (items, cfg)), (hll_fused.hll_update_fused, (regs, items, None, cfg)),
                     (bucket_fold.bucket_fold, (torch.zeros(3, 64, dtype=torch.uint8),))]:
        cpu = fn(*args)
        meta, _ = _declared(fn, *[a.to(META) if isinstance(a, torch.Tensor) else a for a in args])
        cpu, meta = (cpu, meta) if isinstance(cpu, tuple) else ((cpu,), (meta,))
        assert [(t.shape, t.dtype) for t in cpu] == [(t.shape, t.dtype) for t in meta]


def test_placement_and_compression_declare_their_gathers():
    cfg = HLLConfig(p=10, hash_bits=64)
    mesh = make_test_mesh((4,), ("data",), device="cpu")
    items = torch.arange(4000, dtype=torch.int32)
    plan = ExecutionPlan(backend="torch", placement="mesh", mesh=mesh, data_axes=("data",))
    an = hlo_analysis.analyze(update_registers, torch.zeros(cfg.m, dtype=torch.uint8), items, cfg, plan)
    assert an.collectives_by_kind == {"all-reduce": 3 * cfg.m}
    assert an.collective_bytes == 3 * cfg.m
    xs = [torch.ones(1000) for _ in range(4)]
    an = hlo_analysis.analyze(compress.compressed_psum, xs)
    assert an.collective_bytes == compress.compressed_allreduce_bytes(xs[0], 4)["int8_gather_bytes"]


def test_roofline_terms_use_the_cards_published_figures():
    an = hlo_analysis.Analysis(flops=989e12, bytes=3.35e12, collective_bytes=450e9, collectives_by_kind={},
                               n_while_loops=0, trip_counts={})
    one = hlo_analysis.roofline_terms(an, n_chips=1, model_flops=989e12 / 2)
    assert one["compute_s"] == pytest.approx(1.0) and one["memory_s"] == pytest.approx(1.0)
    assert one["collective_s"] == pytest.approx(450e9 / 3.35e12)  # one card: HBM traffic
    assert one["useful_flop_ratio"] == pytest.approx(0.5) and one["roofline_fraction"] == pytest.approx(0.5)
    two = hlo_analysis.roofline_terms(an, n_chips=2)
    assert two["collective_s"] == pytest.approx(0.5)  # NVLink, 450 GB/s each way
    assert hlo_analysis.PEAK_FLOPS_BF16 == 989e12 and hlo_analysis.HBM_BW == 3.35e12


# ----------------------------------------------------------------------------
# the dry-run and its report
# ----------------------------------------------------------------------------


def _reduced_overrides(arch_id):
    full = get_arch(arch_id)
    red = full.reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red) if getattr(red, f.name) != getattr(full, f.name)}


SMALL = {"train": ShapeConfig("train_small", 128, 8, "train"), "prefill": ShapeConfig("prefill_small", 256, 4, "prefill"),
         "decode": ShapeConfig("decode_small", 256, 8, "decode"), "long": ShapeConfig("long_500k", 1024, 1, "decode")}


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_dryrun_records_of_reduced_archs(arch_id, tmp_path):
    devices = _Devices()
    mesh = Mesh((2, 2), ("data", "model"), [META] * 4)
    with devices:
        recs = [dryrun.run_cell(arch_id, shape, False, str(tmp_path), overrides=_reduced_overrides(arch_id),
                                capacity_bytes=CAPACITY, mesh=mesh, grad_accum=2 if shape.kind == "train" else 0)
                for shape in SMALL.values()]
    assert devices.seen <= {"meta"}
    for rec in recs:
        assert rec["status"] in ("ok", "skipped"), rec.get("traceback")
        if rec["status"] == "ok":
            mem = rec["memory_analysis"]
            assert rec["fits_one_card"] and rec["fits_per_position"]
            assert mem["peak_bytes_per_device_est"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            assert mem["argument_size_in_bytes"] <= mem["one_card"]["argument_size_in_bytes"]
            assert rec["roofline"]["hlo_flops"] > 0 and rec["model_flops_global"] > 0
            assert rec["hlo"]["n_while_loops"] == 0 and rec["hlo"]["trip_counts"] == {}
    skipped = [r["shape"] for r in recs if r["status"] == "skipped"]
    assert skipped == ([] if is_cell_supported(get_arch(arch_id), SHAPES["long_500k"]) else ["long_500k"])
    records = report.load(str(tmp_path))
    assert len(records) == 4 and arch_id in report.dryrun_table(records)


def test_dryrun_full_width_cells_on_meta(tmp_path):
    devices = _Devices()
    with devices:
        recs = [dryrun.run_cell("smollm-360m", s, False, str(tmp_path), capacity_bytes=CAPACITY)
                for s in ("decode_32k", "long_500k", "prefill_32k")]
    assert devices.seen <= {"meta"}
    assert [r["status"] for r in recs] == ["ok", "skipped", "ok"]
    decode = recs[0]
    # the 16 x 16 mesh: each position holds its shard of the weights and of the
    # cache; the whole program does not fit one card, a position does
    assert decode["chips"] == 256 and decode["mesh"] == "pod16x16"
    assert not decode["fits_one_card"] and decode["fits_per_position"]
    records = report.load(str(tmp_path))
    assert "smollm-360m" in report.roofline_table(records)
    picks = report.interesting_cells(records)
    assert picks["worst_fraction"]["status"] == "ok"


def test_depth_extrapolation_is_exact():
    """Runs at one and two layers (and two and three micro-batches) give the
    counts of four layers and four micro-batches exactly, the peak too."""
    arch = get_arch("rwkv6-3b").reduced()
    shape = ShapeConfig("t", 128, 8, "train")
    runs = {(r, n): dryrun._fake_run(dryrun._with_repeats(arch, r), shape, step.TrainConfig(grad_accum=n), 2 * n)
            for r in (1, 2) for n in (2, 3)}
    got = dryrun._extrapolate(runs, 4, 4)
    want = dryrun._fake_run(dryrun._with_repeats(arch, 4), shape, step.TrainConfig(grad_accum=4), 8)
    for key in ("flops", "bytes", "collective_bytes"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["peak_live_bytes"] == max(v for k, v in want.items() if k.startswith("peak/"))
    assert got["kernels/rwkv_intra_bwd/launches"] == want["kernels/rwkv_intra_bwd/launches"] == 16


def test_dryrun_main_writes_and_reports(tmp_path, capsys):
    dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--both-meshes", "--out", str(tmp_path),
                 "--capacity-bytes", str(CAPACITY)])
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "pod16x16" in out and "pod2x16x16" in out and "Hillclimb candidates" in out


# ----------------------------------------------------------------------------
# the sketch roofline
# ----------------------------------------------------------------------------


def test_sketch_roofline_ideal_and_declared_bytes():
    assert sketch_roofline.ideal_memory_s() * 1e3 == pytest.approx(0.3205, abs=5e-5)
    n = sketch_roofline.N_ITEMS
    for name, cfg, backend, k in sketch_roofline.VARIANTS:
        plan = ExecutionPlan(backend=backend, pipelines=k)
        devices = _Devices()
        with devices:
            an = hlo_analysis.analyze(update_registers, _meta(cfg.m, dtype=torch.uint8), _meta(n, dtype=torch.int32),
                                      cfg, plan)
        assert devices.seen <= {"meta"}
        fused = an.kernels["hll_update_fused"]
        assert fused["launches"] == k and fused["bytes"] == 4 * n + 2 * k * cfg.m, name
        assert ("bucket_fold" in an.kernels) == (k > 1)
        terms = hlo_analysis.roofline_terms(an, n_chips=1)
        assert terms["dominant"] == "memory_s" and terms["memory_s"] >= sketch_roofline.ideal_memory_s()


def test_sketch_roofline_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        sketch_roofline.run(torch.zeros(16, dtype=torch.int32))


@pytest.mark.gpu
def test_sketch_roofline_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    items = sketch_roofline.make_stream(1 << 22, "cuda", 3)
    for r, (_, cfg, _, _) in zip(sketch_roofline.run(items, rounds=2), sketch_roofline.VARIANTS):
        want = update_registers(torch.zeros(cfg.m, dtype=torch.uint8, device="cuda"), items, cfg,
                                ExecutionPlan(backend="torch", pipelines=1))
        assert torch.equal(r["registers"], want), r["variant"]
        assert r["measured_ms"] > 0 and r["roofline_fraction"] > 0


@pytest.mark.gpu
def test_dryrun_peak_against_the_card():
    """The dry-run's whole-program peak of a train step of RWKV6-3B at full
    width over 2 layers (the kernel pair's path) against the card's over the
    same step: within ``CARD_PEAK_BAND``.  The card adds a fixed few tens of
    MB the fake run cannot see (cuBLAS workspaces, the tap kernel's scratch),
    ~1 % here and nothing at full depth (chip_smoke's dryrun phase); at the
    reduced width that fixed part is most of the step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arch = dataclasses.replace(get_arch("rwkv6-3b"), n_layers=2)
    shape = ShapeConfig("train_4x1024", 1024, 4, "train")
    rec = dryrun.run_cell("rwkv6-3b", shape, False, None, overrides={"n_layers": 2}, grad_accum=2,
                          capacity_bytes=CAPACITY, mesh=Mesh((1, 1), ("data", "model"), [META]))
    measured = chip_smoke._measured_peak(torch.device("cuda"), arch, "train", 4, 1024, 2)
    predicted = rec["memory_analysis"]["one_card"]["peak_bytes_est"]
    assert CARD_PEAK_BAND[0] <= measured / predicted <= CARD_PEAK_BAND[1], (measured, predicted)


def test_chip_smoke_new_phases_rehearse_on_the_cpu(tmp_path):
    """chip_smoke.py's sharding and dryrun phases at a tiny size on the CPU
    (the sketch_roofline phase times the card, so it has no CPU run)."""
    cpu = torch.device("cpu")
    out = chip_smoke.phase_sharding(cpu, step_run=("smollm-360m", 2, 64), psum_size=4096, reduce=True)
    assert out["specs"]["param_leaves"] > 0 and out["hinted_step"]["leaves"] > 0
    assert out["psum"]["max_abs_err"] <= out["psum"]["bound"]
    dry = chip_smoke.phase_dryrun(cpu, jobs=1, capacity=CAPACITY, out_dir=tmp_path, reduce=True)
    assert [row["fits_one_card"] for row in dry["measured"]] == [True] * len(chip_smoke.DRYRUN_MEASURED)
    assert all("measured" not in row for row in dry["measured"])  # no card, no measured peak


def test_dryrun_cells_in_worker_processes(tmp_path):
    cells = [("smollm-360m", "decode_32k"), ("tinyllama-1.1b", "long_500k")]
    recs = dryrun.run_cells(cells, True, str(tmp_path), jobs=2, capacity_bytes=CAPACITY)
    assert [(r["arch"], r["shape"], r["mesh"], r["status"]) for r in recs] == [
        ("smollm-360m", "decode_32k", "pod2x16x16", "ok"), ("tinyllama-1.1b", "long_500k", "pod2x16x16", "skipped")]
    assert recs[0]["chips"] == 512
