"""Port vs reference: the sketch examples, ``examples_torch/stream_cardinality.py``
and ``examples_torch/quickstart.py``, and the zipf stream they read.

Each port example runs with ``device="cpu"`` at a small size; the same
inputs go through the reference library calls the reference example makes
(``examples/stream_cardinality.py``, ``examples/quickstart.py``):

* ``stream_cardinality``, every mode (one sketch over k lanes, ``--tenants``,
  ``--window``, ``--window-levels``) with ``--chunks 4 --chunk-items 65536
  --p 12``: registers, banks and rings bit-identical, host estimates equal
  and the batched device estimates within ``DEVICE_RTOL`` (the bound of
  tests/test_torch_estimators.py), for ``unique`` and ``uniform`` on each
  package's own tokens (bit-identical) and for ``zipf`` on the port's
  tokens;
* the zipf stream at the example's vocab, V = 2^31 - 1, over those four
  chunks of 1024 x 64 (ROADMAP C.3): ``unique`` and ``uniform``
  bit-identical; each zipf token within one float32 ulp of the reference's
  token; the differing count within ``chip_smoke.zipf_flip_bound`` at the
  measured rate ``ZIPF_CPU_EXP_RATE`` (measured here: 6,856 of 262,144);
* ``quickstart`` over 2 x 10^5 items: registers, the streamed count, the
  union, jaccard and the blob bytes equal, every estimator equal (host
  paths), the window readings within ``DEVICE_RTOL``, ``topk`` and
  ``query`` equal;
* every example's CLI: ``--device`` defaults to the card and raises without
  one.

The reference's windows call ``jax.core.trace_state_clean``, which jax
0.9.0 moved to ``jax._src.core``; the tests alias it back first (ROADMAP C).
``gpu`` tests run the two examples on the card; they skip without one.
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro.sketch import CMConfig as RefCMConfig
from repro.sketch import CountMinBank as RefCountMin
from repro.sketch import ExecutionPlan as RefPlan
from repro.sketch import HyperLogLog as RefHLL
from repro.sketch import MultiResWindowedBank as RefMultiRes
from repro.sketch import SketchBank as RefBank
from repro.sketch import WindowedBank as RefRing
from repro.sketch import available_estimators as ref_estimators
from repro.sketch import hll as ref_hll
from repro.sketch import update_registers as ref_update_registers
from repro.sketch.exact import exact_distinct as ref_exact_distinct
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch.data import pipeline
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.sketch import ExecutionPlan, HyperLogLog

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import ZIPF_CPU_EXP_RATE, zipf_flip_bound, zipf_flips  # noqa: E402
from examples_torch import quickstart, stream_cardinality  # noqa: E402

DEVICE_RTOL = 1e-6  # the batched float32 estimates (tests/test_torch_estimators.py)
SMALL = ["--chunks", "4", "--chunk-items", "65536", "--p", "12"]
MODES = {
    "single": [],
    "bank": ["--tenants", "8"],
    "window": ["--tenants", "4", "--window", "4", "--advance-every", "2"],
    "multires": ["--tenants", "4", "--window", "4", "--advance-every", "2", "--window-levels", "3"],
}
EXAMPLES = ("quickstart", "stream_cardinality", "serve_lm", "train_lm", "elastic_rescale")


@pytest.fixture(autouse=True)
def _trace_state_alias(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)


# ----------------------------------------------------------------------------
# stream_cardinality
# ----------------------------------------------------------------------------


def _ref_stream(args, tokens):
    """The reference example's library calls over ``tokens`` (one (1024, S)
    int32 array a chunk; chunk 0 is the warm-up's too): its final state and
    readings."""
    cfg = RefConfig(p=args.p, hash_bits=64)
    plan = RefPlan(backend="jnp", pipelines=args.pipelines, estimator=args.estimator)
    if args.window > 0:
        rows = max(1, args.tenants)
        if args.window_levels > 0:
            win = RefMultiRes.empty(args.window, rows, cfg, levels=args.window_levels)
        else:
            win = RefRing.empty(args.window, rows, cfg)
        for step, chunk in enumerate(tokens):
            if step and step % args.advance_every == 0:
                win = win.advance()
            flat = jnp.asarray(chunk).reshape(-1)
            win = win.observe(flat % rows, flat, plan)
        return {"window": win, "rolling": np.asarray(win.estimate_window(plan=plan)),
                "newest": np.asarray(win.estimate_window(1, plan))}
    if args.tenants > 1:
        bank = RefBank.empty(args.tenants, cfg)
        for chunk in tokens:
            flat = jnp.asarray(chunk).reshape(-1)
            bank = bank.update_many(flat % args.tenants, flat, plan)
        return {"bank": bank, "estimates": np.asarray(bank.estimate_many(args.estimator))}
    regs = ref_hll.init_registers(cfg)
    for chunk in tokens:
        regs = ref_update_registers(regs, jnp.asarray(chunk), cfg, RefPlan(backend="jnp", pipelines=args.pipelines))
    return {"registers": np.asarray(regs), "estimate": ref_hll.estimate(regs, cfg, estimator=args.estimator)}


@pytest.mark.parametrize("distribution", ["unique", "uniform", "zipf"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_stream_cardinality_matches_reference(mode, distribution, capsys):
    argv = SMALL + MODES[mode] + ["--distribution", distribution, "--device", "cpu"]
    args = stream_cardinality.parse_args(argv)
    got = stream_cardinality.main(argv)
    data = stream_cardinality.data_config(args)
    mine = [pipeline.batch_at_step(data, s, "cpu")["tokens"].numpy() for s in range(args.chunks)]
    if distribution == "zipf":
        tokens = mine  # the tokens are held to the reference's in the test below
    else:
        ref_data = ref_pipeline.DataConfig(vocab_size=data.vocab_size, global_batch=data.global_batch,
                                           seq_len=data.seq_len, distribution=distribution)
        tokens = [np.asarray(ref_pipeline.batch_at_step(ref_data, jnp.asarray(s, jnp.int32))["tokens"])
                  for s in range(args.chunks)]
        for a, b in zip(mine, tokens):
            np.testing.assert_array_equal(a, b)
    want = _ref_stream(args, tokens)
    assert got["streamed"] == args.chunks * args.chunk_items
    if mode == "single":
        np.testing.assert_array_equal(got["registers"].numpy(), want["registers"])
        assert got["estimate"] == want["estimate"]
        assert got["devices"] == 1
    elif mode == "bank":
        np.testing.assert_array_equal(got["bank"].registers.numpy(), np.asarray(want["bank"].registers))
        np.testing.assert_array_equal(got["bank"].counts, np.asarray(want["bank"].counts))
        np.testing.assert_allclose(got["estimates"], want["estimates"], rtol=DEVICE_RTOL)
    else:
        assert got["window"].to_bytes() == want["window"].to_bytes()
        assert got["window"].epoch == want["window"].epoch
        np.testing.assert_allclose(got["rolling"], want["rolling"], rtol=DEVICE_RTOL)
        np.testing.assert_allclose(got["newest"], want["newest"], rtol=DEVICE_RTOL)
    printed = capsys.readouterr().out
    assert "sustained:" in printed
    if mode in ("single", "bank"):
        assert f"of {got['streamed']:,} streamed" in printed


def test_stream_cardinality_backends_give_one_answer():
    # the example's backend against the eager one, as the card's run checks
    for mode in ("single", "bank", "window"):
        args = stream_cardinality.parse_args(SMALL + MODES[mode] + ["--device", "cpu", "--chunks", "2"])
        a, b = stream_cardinality.run(args), stream_cardinality.run(args, backend="torch")
        key = {"single": "registers", "bank": "bank", "window": "window"}[mode]
        if mode == "single":
            assert torch.equal(a[key], b[key])
        else:
            assert a[key].to_bytes() == b[key].to_bytes()


def test_zipf_tokens_at_the_examples_vocab_within_one_ulp():
    """ROADMAP C.3 at V = 2^31 - 1: above 2^23 every float32 is an integer,
    so a one-ulp difference of the two packages' exp moves the token by its
    value's ulp (up to 128)."""
    vocab = 2**31 - 1
    flips = total = 0
    widest = 0
    for s in range(4):
        for dist in ("unique", "uniform", "zipf"):
            ref_cfg = ref_pipeline.DataConfig(vocab, 1024, 64, distribution=dist)
            cfg = pipeline.DataConfig(vocab, 1024, 64, distribution=dist)
            want = ref_pipeline.batch_at_step(ref_cfg, jnp.asarray(s, jnp.int32))
            got = pipeline.batch_at_step(cfg, s, "cpu")
            if dist != "zipf":
                for key in got:
                    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
                continue
            arg = pipeline.zipf_exponent(cfg, s, "cpu").numpy()
            a, b = got["tokens"].numpy(), np.asarray(want["tokens"])
            flips += zipf_flips(a, b, arg[:-1], vocab)
            zipf_flips(got["targets"].numpy(), np.asarray(want["targets"]), arg[1:], vocab)
            widest = max(widest, int(np.abs(a.astype(np.int64) - b).max()))
            total += a.size
    assert 0 < flips <= zipf_flip_bound(vocab, total, ZIPF_CPU_EXP_RATE), flips
    assert 1 < widest <= 128  # a flip above 2^24 moves by more than one


def test_zipf_flip_rule_allows_an_ulp_above_two_to_the_23():
    vocab = 2**31 - 1
    cfg = pipeline.DataConfig(vocab, 2, 64)
    tokens = pipeline.batch_at_step(cfg, 0, "cpu")["tokens"].numpy().reshape(-1)
    argument = pipeline.zipf_exponent(cfg, 0, "cpu")[:-1].numpy()
    high = int(np.argmax(tokens))
    assert tokens[high] >= 2**24
    ulp = int(np.spacing(np.float32(tokens[high])))
    moved = tokens.copy()
    moved[high] -= ulp
    assert zipf_flips(moved, tokens, argument, vocab) == 1
    moved[high] -= ulp
    with pytest.raises(AssertionError, match="more than one"):
        zipf_flips(moved, tokens, argument, vocab)
    assert zipf_flips(moved, tokens, argument, vocab, ulps=2) == 1


# ----------------------------------------------------------------------------
# quickstart
# ----------------------------------------------------------------------------


def test_quickstart_matches_reference(capsys):
    n = 200_000
    got = quickstart.tour(n, "cpu")
    printed = capsys.readouterr().out

    # the reference example's calls, at n items
    cfg = RefConfig(p=16, hash_bits=64)
    rng = np.random.default_rng(0)
    items_np = rng.integers(0, 2**22, n, dtype=np.int32)
    items = jnp.asarray(items_np)
    np.testing.assert_array_equal(got["items"].numpy(), items_np)
    sk = RefHLL.of(items, cfg)
    assert got["exact"] == ref_exact_distinct(items)
    np.testing.assert_array_equal(got["sketch"].registers.numpy(), np.asarray(sk.registers))
    streamed = RefHLL.empty(cfg)
    for chunk in np.split(items_np, 5):
        streamed = streamed.update(jnp.asarray(chunk), RefPlan(backend="jnp", pipelines=8))
    np.testing.assert_array_equal(got["streamed"].registers.numpy(), np.asarray(streamed.registers))
    assert got["streamed"].count == streamed.count == n
    a, b = RefHLL.of(items[: n // 2], cfg), RefHLL.of(items[n // 2:], cfg)
    merged = a | b
    np.testing.assert_array_equal(got["merged"].registers.numpy(), np.asarray(merged.registers))
    assert got["jaccard"] == a.jaccard(b)
    assert got["blob"] == merged.to_bytes()
    assert list(got["estimates"]) == list(ref_estimators())
    for name, value in got["estimates"].items():
        assert value == sk.estimate(estimator=name), name

    wcfg = RefConfig(p=12, hash_bits=64)
    win = RefRing.empty(4, 1, wcfg)
    for epoch in range(6):
        if epoch:
            win = win.advance()
        chunk = jnp.arange(epoch * 50_000, epoch * 50_000 + 80_000, dtype=jnp.int32)
        win = win.observe(jnp.zeros(chunk.shape, jnp.int32), chunk)
    assert got["window"].to_bytes() == win.to_bytes()
    np.testing.assert_allclose(got["rolling"], float(win.estimate_window()[0]), rtol=DEVICE_RTOL)
    np.testing.assert_allclose(got["newest"], float(win.estimate_window(1)[0]), rtol=DEVICE_RTOL)

    hot = np.repeat(np.arange(8, dtype=np.int32), 5_000)
    tail = rng.integers(1_000, 2**20, 60_000).astype(np.int32)
    stream = np.concatenate([hot, tail])
    rng.shuffle(stream)
    hh = RefCountMin.empty(1, RefCMConfig(depth=4, width=1024)).update_many(np.zeros(stream.shape, np.int32), stream)
    vals, cnts = hh.topk(8)
    np.testing.assert_array_equal(got["topk"][0], vals)
    np.testing.assert_array_equal(got["topk"][1], cnts)
    assert sorted(got["topk"][0][0].tolist()) == list(range(8))
    np.testing.assert_array_equal(got["query"], np.asarray(hh.query(jnp.arange(8)))[0])
    assert got["heavy"].nbytes == hh.nbytes
    assert "0.2M items: exact=" in printed and "survives round-trip" in printed


def test_quickstart_default_plan_and_pipelined_backend_equal_torch():
    out = quickstart.tour(20_000, "cpu")
    torch_plan = ExecutionPlan(backend="torch")
    want = HyperLogLog.of(out["items"], out["sketch"].cfg, torch_plan)
    assert torch.equal(out["sketch"].registers, want.registers)
    assert torch.equal(out["streamed"].registers, want.registers)


# ----------------------------------------------------------------------------
# the command lines
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card_and_raises_without_one(name):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    module = importlib.import_module(f"examples_torch.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


# ----------------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
def test_stream_cardinality_on_card_launches_its_kernels(mode):
    _card()
    argv = SMALL + MODES[mode]
    want = {"single": {"hll_update_fused", "bucket_fold"}, "bank": {"hash_rank", "bank_scatter_max"},
            "window": {"hash_rank", "bank_scatter_max", "window_merge_max", "window_fold_max"},
            "multires": {"hash_rank", "bank_scatter_max", "window_fold_max"}}[mode]
    reset_launches()
    got = stream_cardinality.main(argv)
    launched = {name for name, count in launch_counts().items() if count}
    assert want <= launched, (want, launched)
    plain = stream_cardinality.run(stream_cardinality.parse_args(argv), backend="torch")
    key = {"single": "registers", "bank": "bank", "window": "window", "multires": "window"}[mode]
    if mode == "single":
        assert torch.equal(got[key], plain[key])
    else:
        assert got[key].to_bytes() == plain[key].to_bytes()


@pytest.mark.gpu
def test_quickstart_on_card_equals_cpu():
    dev = _card()
    reset_launches()
    got = quickstart.tour(200_000, dev)
    launched = {name for name, count in launch_counts().items() if count}
    assert {"hll_update_fused", "bucket_fold", "hash_rank", "bank_scatter_max", "window_merge_max",
            "window_fold_max", "cm_scatter_add"} <= launched
    want = quickstart.tour(200_000, "cpu")
    assert got["blob"] == want["blob"] and got["estimates"] == want["estimates"]
    np.testing.assert_array_equal(got["topk"][0], want["topk"][0])
    np.testing.assert_array_equal(got["query"], want["query"])
