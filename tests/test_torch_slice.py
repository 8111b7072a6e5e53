"""The whole main-path slice of the port against the reference.

* One seeded keyed stream, in several chunks, through the port's default
  plan on the CPU and through the reference's default plan: the same final
  bank, counters, bytes and estimates; likewise one single-sketch stream,
  and one epoch stream through a HybridBank and a WindowedBank.
* ``chip_smoke.py``'s phases (kernels, stream, bank, hybrid, window,
  countmin, cm_window, board, serve, launch, obs, placement, attn_serve,
  family_serve, train, examples) rehearsed at a tiny size on the CPU
  (serve and launch: the reduced RWKV6-3B; attn_serve: the reduced
  TinyLlama-1.1B; family_serve: the reduced olmoe-1b-7b, mixtral-8x7b and
  recurrentgemma-9b; examples: the five examples at small flags), where
  every kernel wrapper runs its plain version.
* Every module of ``repro_torch``, ``chip_smoke`` and the five
  ``examples_torch`` files pull in no ``jax`` and nothing of ``repro``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.sketch import HyperLogLog as RefHLL
from repro.sketch import HybridBank as RefHybrid
from repro.sketch import SketchBank as RefBank
from repro.sketch import WindowedBank as RefRing
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch import HLLConfig, HybridBank, HyperLogLog, SketchBank, WindowedBank
from repro_torch.kernels import KERNELS, launch_counts, reset_launches

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_keyed_stream_through_the_whole_slice_matches_reference():
    rng = np.random.default_rng(2024)
    rows, p, hash_bits = 29, 12, 64
    bank = SketchBank.empty(rows, HLLConfig(p=p, hash_bits=hash_bits), device="cpu")
    ref = RefBank.empty(rows, RefConfig(p=p, hash_bits=hash_bits))
    for _ in range(4):
        keys = ((rng.zipf(1.2, 3000) - 1) % (rows + 2) - 1).astype(np.int32)  # -1 and B too
        items = rng.integers(0, 2**31, 3000, dtype=np.int32)
        bank = bank.update_many(keys, items)
        ref = ref.update_many(jnp.asarray(keys), jnp.asarray(items))
    np.testing.assert_array_equal(bank.registers.numpy(), np.asarray(ref.registers))
    np.testing.assert_array_equal(bank.counts, ref.counts)
    assert bank.to_bytes() == ref.to_bytes()
    np.testing.assert_allclose(bank.estimate_many().numpy(), np.asarray(ref.estimate_many()), rtol=1e-6)
    assert [bank.estimate(i) for i in range(rows)] == [ref.estimate(i) for i in range(rows)]


def test_single_sketch_stream_through_the_whole_slice_matches_reference():
    rng = np.random.default_rng(7)
    cfg = HLLConfig(p=16, hash_bits=32, seed=99)
    sk, ref = HyperLogLog.empty(cfg, "cpu"), RefHLL.empty(RefConfig(p=16, hash_bits=32, seed=99))
    for _ in range(3):
        items = rng.integers(0, 2**32, 4096, dtype=np.uint32)
        sk, ref = sk.update(items), ref.update(jnp.asarray(items))
    assert sk.to_bytes() == ref.to_bytes()
    assert sk.estimate() == ref.estimate() and sk.count == ref.count


def test_hybrid_and_window_slice_matches_reference(monkeypatch):
    # the reference's windows need jax.core.trace_state_clean (ROADMAP §C)
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    rng = np.random.default_rng(12)
    rows, cfg, rcfg = 19, HLLConfig(p=8, hash_bits=64), RefConfig(p=8, hash_bits=64)
    hyb, ref_hyb = HybridBank.empty(rows, cfg, device="cpu"), RefHybrid.empty(rows, rcfg)
    ring, ref_ring = WindowedBank.empty(4, rows, cfg, device="cpu"), RefRing.empty(4, rows, rcfg)
    for epoch in range(7):
        keys = ((rng.zipf(1.2, 1500) - 1) % (rows + 2) - 1).astype(np.int32)
        items = rng.integers(0, 2**31, 1500, dtype=np.int32)
        hyb, ref_hyb = hyb.update_many(keys, items), ref_hyb.update_many(jnp.asarray(keys), jnp.asarray(items))
        ring = ring.observe(keys, items).advance()
        ref_ring = ref_ring.observe(jnp.asarray(keys), jnp.asarray(items)).advance()
        np.testing.assert_allclose(ring.estimate_window(2).numpy(), np.asarray(ref_ring.estimate_window(2)),
                                   rtol=1e-6)
    assert hyb.to_bytes() == ref_hyb.to_bytes() and ring.to_bytes() == ref_ring.to_bytes()
    np.testing.assert_allclose(hyb.estimate_many().numpy(), np.asarray(ref_hyb.estimate_many()), rtol=1e-6)
    assert [hyb.estimate(i) for i in range(rows)] == [ref_hyb.estimate(i) for i in range(rows)]


def test_chip_smoke_phases_rehearse_on_the_cpu():
    reset_launches()
    errs = chip_smoke.phase_kernels("cpu", n=1 << 10, rows=11, configs=((8, 32), (16, 64)),
                                    hybrid_rows=37, window=5, cm_cells=1 << 16,
                                    intra_shapes=((3, 64, 8), (2, 1, 16)), intra_strong=((2, 16, 8),),
                                    intra_bwd_shapes=((3, 16, 8), (2, 1, 16)), intra_bwd_strong=((2, 16, 8),),
                                    intra_bwd_underflow=((2, 9, 8),), intra_bwd_zero_dy=((2, 16, 8),))
    assert set(errs) == set(KERNELS) and max(errs.values()) == 0.0
    stream = chip_smoke.phase_stream("cpu", chunks=2, chunk_items=1 << 11, configs=((10, 64),), pipelines=3)
    assert stream["items"] == 1 << 12 and len(stream["configs"]) == 1
    bank = chip_smoke.phase_bank("cpu", rows=13, ticks=2, tick_items=1 << 11, p=8)
    assert bank["rows"] == 13 and bank["items"] == 1 << 12
    hybrid = chip_smoke.phase_hybrid("cpu", rows=64, items_per_row=40, p=8)
    assert 0 < hybrid["promoted_rows"] < 64 and hybrid["memory_reduction"] > 1
    window = chip_smoke.phase_window("cpu", window=8, rows=16, epoch_items=1 << 10, p=8,
                                     hybrid_window=4, mr_base=2, mr_levels=2)
    assert window["epochs"] == 16 and window["hybrid_ring"]["window"] == 4
    countmin = chip_smoke.phase_countmin("cpu", rows=12, ticks=2, tick_items=1 << 12, depth=3, width=64,
                                         item_ids=1 << 10, probes=128)
    assert countmin["items"] == 1 << 13 and countmin["probe_overcount_mean"] >= 0
    cm_window = chip_smoke.phase_cm_window("cpu", window=8, rows=6, epoch_items=1 << 10, depth=2, width=32,
                                           item_ids=1 << 10, probes=64, bytes_window=3)
    assert cm_window["epochs"] == 16 and cm_window["rcmw_bytes"] > 0
    board = chip_smoke.phase_board("cpu", streams=9, epochs=4, epoch_items=1 << 10, window=2, vocab=300,
                                   p=6, depth=2, width=32)
    assert board["flat"]["items_seen"] == 4 << 10 and board["windowed"]["streams_reported"] <= 9
    # on the CPU the wrappers run their plain versions and never count a launch
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_chip_smoke_serve_phase_rehearses_on_the_cpu():
    reset_launches()
    arch = chip_smoke.get_arch(chip_smoke.SERVE_ARCH).reduced()
    serve = chip_smoke.phase_serve("cpu", arch=arch, requests=2, prompt_len=128, gen_len=2, tf_prompt=64,
                                   tf_steps=4, ragged=(40, 100))
    assert serve["params"] == arch.param_count() and serve["layers"] == 2
    assert serve["vs_plain"]["logits"]["max_abs_err"] == 0.0  # the plain version on both sides here
    assert serve["teacher_forced_max_abs_err"] <= chip_smoke.SERVE_TF_ATOL
    assert {row["exact"] for row in serve["board"].values()} >= {2}
    assert set(serve["ragged"]) == {40, 100}
    assert launch_counts()["rwkv_intra"] == 0


def test_chip_smoke_launch_and_obs_phases_rehearse_on_the_cpu(tmp_path):
    from repro_torch.obs import metrics
    from repro_torch.serve.coalesce import SharedWindowRing

    reset_launches()
    args = ("--arch", chip_smoke.SERVE_ARCH, "--requests", "3", "--prompt-len", "64", "--gen-len", "2",
            "--report-every", "1")
    try:
        launch = chip_smoke.phase_launch("cpu", args=args, out_dir=tmp_path)
    finally:
        SharedWindowRing.reset()
    assert (launch["requests"], launch["prompt_len"], launch["gen_len"]) == (3, 64, 2)
    assert launch["prefill_tokens_per_s"] > 0 and launch["decode_tokens_per_s"] > 0
    assert {"bank_update[cuda]", "sparse_dedup[cuda]", "cm_update[cuda]", "window_merge[cuda]"} <= set(launch["seams"])
    assert (tmp_path / "launch_metrics.json").exists() and (tmp_path / "launch_trace.json").exists()
    assert not metrics.enabled()
    obs = chip_smoke.phase_obs("cpu", rows=16, p=8, tick_items=1 << 10, calls=3, rounds=1, small_rows=16,
                               small_items=1 << 10, window=3)
    assert set(obs["over_passthrough"]) == {"disabled", "enabled", "traced"}
    assert len(obs["sync_calls"]) == 4 and not metrics.enabled()
    # the passthrough arm put the wrapped backends and record sites back
    assert hasattr(chip_smoke.SketchBank, "update_many") and metrics.inc.__module__ == metrics.__name__
    # on the CPU the wrappers run their plain versions and never count a launch
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_chip_smoke_placement_and_attn_serve_phases_rehearse_on_the_cpu(tmp_path):
    from repro_torch.obs import metrics

    reset_launches()
    placement = chip_smoke.phase_placement(
        "cpu", rows=37, tick_items=1001, p=8, hybrid_rows=64, hybrid_items_per_row=40, window=6, window_rows=11,
        window_epochs=9, epoch_items=500, cm_rows=13, cm_depth=3, cm_width=64, cm_items=1000, stream_chunks=3,
        stream_items=1000, repeats=2)
    assert placement["meshes"] == ["4-shard", "1-device"] and len(placement["bank"]["path_per_block"]) == 4
    assert {name: len(w["ingest_s"]) for name, w in placement["bank"]["walls"].items()} == {
        "local": 2, "sharded 4-shard": 2}
    arch = chip_smoke.get_arch(chip_smoke.ATTN_ARCH).reduced()
    args = ("--arch", chip_smoke.ATTN_ARCH, "--requests", "3", "--prompt-len", "64", "--gen-len", "2")
    attn = chip_smoke.phase_attn_serve("cpu", args=args, arch=arch, out_dir=tmp_path, check_prompt=40,
                                       check_steps=4, swa_window=16, batch_prompts=(5, 12, 30, 9, 17, 3),
                                       batch_new=4)
    assert {k: len(v) for k, v in attn["launcher"].items()} == {"local": 2, "sharded": 2} and not metrics.enabled()
    errs = attn["against_forward_max_abs_err"]
    assert max(errs["f32"].values()) <= chip_smoke.ATTN_F32_ATOL
    assert max(errs["f32 swa"].values()) <= chip_smoke.ATTN_F32_ATOL
    assert attn["batcher"]["tokens"] == 24 and attn["batcher"]["worst_gap"] <= chip_smoke.ATTN_BATCH_TIE
    # on the CPU the wrappers run their plain versions and never count a launch
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_chip_smoke_family_serve_phase_rehearses_on_the_cpu(tmp_path):
    from repro_torch.obs import metrics

    reset_launches()
    family = chip_smoke.phase_family_serve(
        "cpu", launch_args=("--requests", "3", "--prompt-len", "300", "--gen-len", "2"), reduce=True,
        check_prompt=40, check_steps=4, route_prompt=300, batch_prompts=(5, 12, 30, 9, 17, 3), batch_new=4,
        out_dir=tmp_path)
    assert set(family["launcher"]) == set(chip_smoke.FAMILY_LAUNCH_ARCHS) and not metrics.enabled()
    olmoe = family["launcher"]["olmoe-1b-7b"]
    # reduced olmoe, 300-token groups: capacity 150 of 8 experts, some dropped
    assert olmoe["prefill_route_calls"] == 2 and olmoe["capacity"] == 150 and olmoe["dropped_choices"] > 0
    assert olmoe["collapse"]["collapsed_estimate"] < olmoe["collapse"]["estimate"] / 1.5
    assert set(family["legs"]) == set(chip_smoke.FAMILY_CHECK_LAYERS)
    for arch_id, legs in family["legs"].items():
        assert max(legs["f32"]["prefill"], legs["f32"]["decode"]) <= chip_smoke.ATTN_F32_ATOL
        assert legs["f32"].get("positions_after_a_flip", 0) == 0
    assert family["legs"]["recurrentgemma-9b"]["scan_float64"]["tokens"] == 300
    assert {row["tokens"] for row in family["batcher"].values()} == {24}
    # on the CPU the wrappers run their plain versions and never count a launch
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_chip_smoke_train_phase_rehearses_on_the_cpu(tmp_path):
    reset_launches()
    runs = (("smollm-360m", 2, 64, 1), ("rwkv6-3b", 4, 128, 2))
    train = chip_smoke.phase_train("cpu", runs=runs, steps=3, lr=3e-3, reduce=True, pair_batch=(2, 128),
                                   ckpt=("smollm-360m", 2, 2, 32, 4), out_dir=tmp_path)
    assert set(train["runs"]) == {"smollm-360m", "rwkv6-3b"}
    for arch_id, batch, seq, accum in runs:
        row = train["runs"][arch_id]
        assert (row["global_batch"], row["seq_len"], row["grad_accum"], len(row["loss"])) == (batch, seq, accum, 3)
        assert row["loss"][-1] < row["loss"][0] and row["zipf_flips_card_vs_cpu"] == 0
        assert row["tokens_per_s"] > 0 and row["exact_distinct"] > 0
    pair = train["pair"]
    assert pair["kernel"]["mean_abs_grad_diff"] == 0.0  # the plain pair on both sides here
    assert pair["control"]["mean_abs_grad_diff"] > 0.0
    assert train["checkpoint"]["resumed_equal"] and train["checkpoint"]["leaves"] > 0
    assert not list(tmp_path.glob("train_ckpt/*"))
    # on the CPU the wrappers run their plain versions and never count a launch
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_chip_smoke_examples_phase_rehearses_on_the_cpu(monkeypatch):
    import tempfile

    made = []
    mkdtemp = tempfile.mkdtemp
    monkeypatch.setattr(tempfile, "mkdtemp", lambda **kw: made.append(mkdtemp(**kw)) or made[-1])
    reset_launches()
    out = chip_smoke.phase_examples(
        "cpu", stream_flags=("--chunks", "2", "--chunk-items", "65536", "--p", "12"), quick_items=100_000,
        serve_flags=("--requests", "2", "--prompt-len", "64", "--gen-len", "4"), train_steps=30,
        train_small=("--batch", "2", "--seq", "16"), resume=(2, 1, 4), full=("--steps", "2", "--ckpt-every", "2"),
        elastic=(2, 4))
    runs = out["stream_cardinality"]["runs"]
    assert set(runs) == set(chip_smoke.EXAMPLE_STREAM_RUNS)
    assert all(row["equal_to_torch_backend"] and row["streamed"] == 2 * 65536 for row in runs.values())
    assert runs["unique"]["sigmas"] <= 4
    zipf = out["stream_cardinality"]["zipf_card_vs_cpu"]
    assert zipf["differing"] == zipf["exp_differ_rate"] == 0 and zipf["tokens"] == 2 * 65536
    assert out["quickstart"]["top8"] == list(range(8)) and out["quickstart"]["sigmas"] <= 4
    assert out["serve_lm"]["rwkv6-3b"]["items_seen"] == {"request_ids": 2, "prompt_tokens": 128,
                                                         "generated_tokens": 8}
    train = out["train_lm"]
    assert train["defaults"]["last_loss"] < train["defaults"]["first_loss"] and train["resume"]["resumed"]
    assert train["full"]["steps"] == 2 and train["full"]["sigmas"] <= 4
    assert out["elastic_rescale"]["step"] == 4 and out["elastic_rescale"]["registers_equal"]
    # every checkpoint directory the phase made is gone; on the CPU no launch counts
    assert len(made) == 4 and not any(os.path.exists(d) for d in made)
    assert launch_counts() == {name: 0 for name in KERNELS}


def test_chip_smoke_zipf_flip_rule_catches_a_flip_off_a_boundary():
    from repro_torch.data.pipeline import DataConfig, batch_at_step, zipf_exponent

    cfg = DataConfig(32000, 2, 64)
    tokens = batch_at_step(cfg, 3, "cpu")["tokens"].numpy()
    argument = zipf_exponent(cfg, 3, "cpu")[:-1].numpy()
    assert chip_smoke.zipf_flips(tokens, tokens, argument, 32000) == 0
    # a token one off at its own integer boundary counts; elsewhere, or by
    # more than one, it fails
    x = np.exp(argument.astype(np.float64))
    at_edge = int(np.argmin(np.abs(x - np.rint(x)) / np.spacing(x.astype(np.float32))))
    moved = tokens.copy().reshape(-1)
    moved[at_edge] += 1 if np.rint(x[at_edge]) > x[at_edge] else -1
    if np.abs(x[at_edge] - np.rint(x[at_edge])) <= 2 * np.spacing(np.float32(x[at_edge])):
        assert chip_smoke.zipf_flips(moved, tokens, argument, 32000) == 1
    far = int(np.argmax(np.abs(x - np.rint(x))))
    bad = tokens.copy().reshape(-1)
    bad[far] += 1
    with pytest.raises(AssertionError, match="integer boundary"):
        chip_smoke.zipf_flips(bad, tokens, argument, 32000)
    bad[far] += 1
    with pytest.raises(AssertionError, match="more than one"):
        chip_smoke.zipf_flips(bad, tokens, argument, 32000)


def test_chip_smoke_float64_routing_catches_a_wrong_tie_or_drop():
    # a zero router: every probability ties, so experts 0..k-1 in order, and
    # the queues past capacity drop; the higher index first, or a drop
    # missed, is caught
    arch = chip_smoke.get_arch("olmoe-1b-7b").reduced()
    k, cap = arch.moe.top_k, 3
    logits = torch.zeros((2, 5, arch.moe.num_experts))
    order, keep = chip_smoke._routing_float64(logits, k, cap)
    assert (order == torch.arange(k)).all() and keep.sum() == 2 * k * cap
    good = {"cap": cap, "logits": logits, "expert_idx": order, "keep": keep}
    assert chip_smoke._check_routing_float64([good], arch, "zero router") == 2 * k * (5 - cap)
    for bad in (dict(good, expert_idx=order.flip(-1)), dict(good, keep=torch.ones_like(keep))):
        with pytest.raises(AssertionError, match="float64"):
            chip_smoke._check_routing_float64([bad], arch, "zero router")
    # the near-tie rule of the bf16 legs: how far apart the experts a
    # routing swaps lie in the logits
    logits = torch.tensor([3.0, 2.0, 2.0, 1.0])
    assert chip_smoke._tie_gap(logits, torch.tensor([0, 1])) == 0.0  # forward's own top 2
    assert chip_smoke._tie_gap(logits, torch.tensor([0, 2])) == 0.0  # the tie taken the other way
    assert chip_smoke._tie_gap(logits, torch.tensor([0, 3])) == 1.0  # expert 3 over expert 1 or 2
    assert chip_smoke._tie_gap(logits, torch.tensor([1, 0])) == 1.0  # the order of the two swapped


def test_chip_smoke_control_catches_a_wrong_intra_term(monkeypatch):
    # a kernel off by more than the sums' last places fails the serve check
    arch = chip_smoke.get_arch(chip_smoke.SERVE_ARCH).reduced()
    model = chip_smoke.transformer.init_params(arch, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.randint(0, arch.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))}
    wrong = lambda *args: chip_smoke.rwkv_intra_plain(*args) * 1.01
    monkeypatch.setattr(chip_smoke.rwkv6, "rwkv_intra", wrong)
    with chip_smoke._activations(torch.float32):
        trio = chip_smoke._prefill_trio(model, batch, arch, 65)
    with pytest.raises(AssertionError, match="control"):
        chip_smoke._against_plain(trio, "prefill")


def test_profile_busy_time_counts_each_kernel_once():
    # an aten op reports its kernels' device time as its own self time too;
    # only the card's own entries (kernels, copies, fills) make the busy time
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    entries = [
        SimpleNamespace(key="aten::bincount", device_type=DeviceType.CPU, self_device_time_total=118),
        SimpleNamespace(key="kernelHistogram1D", device_type=DeviceType.CUDA, self_device_time_total=118),
        SimpleNamespace(key="Memcpy DtoD", device_type=DeviceType.CUDA, self_device_time_total=47),
        SimpleNamespace(key="aten::empty", device_type=DeviceType.CPU, self_device_time_total=0),
        SimpleNamespace(key="idle kernel", device_type=DeviceType.CUDA, self_device_time_total=0),
    ]
    assert [e.key for e in chip_smoke._device_entries(entries)] == ["kernelHistogram1D", "Memcpy DtoD"]


def test_profile_busy_time_leaves_out_profiler_ranges():
    # a record_function range (a span or seam of the port while the profiler
    # records) lies on the card's timeline with its whole length as device
    # time; only the kernels inside it count
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def entry(key, device_us, annotation):
        return SimpleNamespace(key=key, device_type=DeviceType.CUDA, self_device_time_total=device_us,
                               is_user_annotation=annotation)

    entries = [entry("sketch.bank.update_many", 900, True), entry("bank_update[cuda]", 400, True),
               entry("ProfilerStep#2", 1000, True), entry("bank_scatter_kernel", 380, False),
               entry("kernelHistogram1D", 118, False)]
    assert [e.key for e in chip_smoke._device_entries(entries)] == ["bank_scatter_kernel", "kernelHistogram1D"]


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    # every module of the port, chip_smoke.py and the port's examples
    # (importing an example does not run it)
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "names += ['chip_smoke', 'examples_torch'] + ['examples_torch.' + n for n in\n"
        "          ('quickstart', 'stream_cardinality', 'serve_lm', 'train_lm', 'elastic_rescale')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "repro_torch.kernels.wrappers()\n"
        "assert len(names) > 80, len(names)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and '"ok"' not in run.stdout
