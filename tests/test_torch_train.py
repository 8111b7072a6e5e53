"""Port vs reference: the training path -- data, loss and gradients, the
RWKV6 intra-chunk gradient, the datapath tap, the step and the launcher.

The reference's reduced archs (d 128, vocab 512) are initialised with
``jax.random`` and carried to the port with ``repro_torch.interop``;
inputs are seeded numpy arrays handed to both.  The model legs run in
float32 (``ACT_DTYPE`` set to float32 in both packages, a renamed arch for
the jitted reference), so they compare the algorithm; the sums run in
other orders.  Stated tolerances (measured on this container in brackets):

* loss, ``nll``, ``aux``: within ``LOSS_RTOL`` relative (1.5e-7);
* every gradient leaf: max |port - reference| within ``GRAD_RTOL`` of the
  leaf's largest magnitude (4.2e-5, rwkv6-3b; the others <= 4.2e-6);
* the intra-chunk gradient against ``jax.vjp`` of ``rwkv_intra_ref``:
  within ``INTRA_GRAD_RTOL`` of each gradient's largest magnitude;
* one ``train_step`` (grad_accum 1 and 2, M-RoPE positions split as the
  reference splits them): metrics as the loss, ``grad_norm`` within 1e-5
  relative, ``mu`` and ``nu`` as the gradients, the sketch registers
  bit-identical.  The parameters move by ``lr * mhat / (sqrt(nhat) + eps)``,
  which turns over where a gradient element is ~eps and its last places
  differ, so they are held to ``lr`` times 2 plus 1e-6 of the leaf's scale,
  with such elements under 1 %;
* data: ``unique`` and ``uniform`` batches bit-identical; ``zipf`` tokens
  (float32 ``exp``, ROADMAP C.3) differing by one, each at an integer
  boundary (the float64 ``exp`` of the same float32 argument within 2
  float32 ulps of an integer), in no more than ``chip_smoke.zipf_flip_bound``
  tokens: the expected number within one float32 ulp of an integer, which
  grows with the vocab (at 24,576 tokens: 1 at V = 512, 231 at 256,000;
  measured 0-3 against the reference, 3 in 8,192 on the card at 65,536);
* the tap: registers bit-identical to the reference's ``datapath_tap``;
* the launcher, in-process against the reference's (same initial state,
  seed and flags): the loss of every step within ``LAUNCH_RTOL`` (a few
  AdamW steps turn last-place differences over; measured 1.5e-7), the
  printed exact-finalized estimate and the sketch equal.

``gpu`` tests repeat the kernel, data, tap and step checks on the card.
"""

import contextlib
import dataclasses
import io
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import pipeline as ref_pipeline
from repro.kernels.rwkv_intra import rwkv_intra_ref
from repro.launch import train as ref_launch
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.optim import adamw as ref_adamw
from repro.sketch import dispatch as ref_dispatch
from repro.sketch import hll as ref_hll
from repro.train import loop as ref_loop
from repro.train import step as ref_step
from repro_torch import configs, interop
from repro_torch.data import pipeline
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels import rwkv_intra as intra_lib
from repro_torch.launch import train as launch
from repro_torch.models import common, rwkv6, transformer
from repro_torch.optim import adamw
from repro_torch.sketch import HLLConfig, dispatch, hll, u64
from repro_torch.train import loop, step

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import zipf_flip_bound, zipf_flips  # noqa: E402  (the card's zipf rule)

LOSS_RTOL = 1e-6
GRAD_RTOL = 2e-4
INTRA_GRAD_RTOL = 1e-5
LAUNCH_RTOL = 1e-5
B, S = 4, 64
# the witness of a few steps at warmup 1 (the full-width train runs' case)
WITNESS_LR = 3e-4
WITNESS_STEPS = 3
WITNESS_LAYERS = 2
WITNESS_RTOL = {"bf16": 2e-3, "f32": 1e-4}


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(ref_common, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)


def _archs(arch_id, suffix="-f32-train"):
    ref_arch = dataclasses.replace(ref_configs.get_arch(arch_id).reduced(), name=arch_id + suffix)
    return ref_arch, configs.get_arch(arch_id).reduced()


def _batches(arch, ref_arch, seed=1, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, arch.vocab_size, (b, s)).astype(np.int32)
    tgts = rng.integers(0, arch.vocab_size, (b, s)).astype(np.int32)
    ref_batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)}
    if arch.mrope:
        ref_batch["positions"] = ref_transformer.default_positions(ref_arch, b, s)
        batch["positions"] = transformer.default_positions(arch, b, s, "cpu")
    return ref_batch, batch


def _leaf_err(got, want) -> float:
    """max |got - want| over the largest |want| of a leaf."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def _tree_errs(got_tree, want_tree) -> dict:
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    assert set(got) == set(want)
    return {jax.tree_util.keystr(k): _leaf_err(got[k], want[k]) for k in want}


# ----------------------------------------------------------------------------
# loss and gradients
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ["smollm-360m", "rwkv6-3b", "olmoe-1b-7b", "recurrentgemma-9b", "qwen2-vl-72b"])
def test_loss_and_grads_match_reference(arch_id, f32):
    ref_arch, arch = _archs(arch_id)
    params = ref_transformer.init_params(jax.random.PRNGKey(0), ref_arch)
    model = interop.model_from_reference(jax.tree_util.tree_map(np.asarray, params), arch, "cpu")
    assert not any(p.requires_grad for p in model.parameters())  # frozen for serving
    model.requires_grad_(True)
    ref_batch, batch = _batches(arch, ref_arch)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: ref_transformer.loss_fn(p, b, ref_arch), has_aux=True))
    (want_loss, want_parts), want_grads = grad_fn(params, ref_batch)

    loss, parts = transformer.loss_fn(model, batch, arch)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["nll"].detach()), float(want_parts["nll"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"].detach()), float(want_parts["aux"]), rtol=LOSS_RTOL, atol=1e-7)
    if arch.moe is not None:
        assert float(parts["aux"].detach()) > 0
    got_tree = interop._tree(interop._param_leaves(dict(zip(names, grads)), arch))
    errs = _tree_errs(got_tree, jax.tree_util.tree_map(np.asarray, want_grads))
    assert max(errs.values()) <= GRAD_RTOL, errs


def test_forward_recomputes_each_stage_body_only_when_training(monkeypatch):
    # a trainable model under grad mode checkpoints every stage body; a
    # frozen one, inference mode and a prefill (collect_state) do not
    arch = configs.get_arch("recurrentgemma-9b").reduced()  # stages ((rec, rec, attn), 1) + ((rec,), 1)
    model = transformer.init_params(arch, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint", lambda *a, **k: calls.append(k) or real(*a, **k))
    transformer.forward(model, batch, arch)
    model.requires_grad_(True)
    with torch.inference_mode():
        transformer.forward(model, batch, arch)
    transformer.forward(model, batch, arch, collect_state=True)
    assert calls == []
    transformer.forward(model, batch, arch)
    assert calls == [{"use_reentrant": False}] * 2


# ----------------------------------------------------------------------------
# the intra-chunk gradient
# ----------------------------------------------------------------------------


def _intra_case(b, nc, h, c, n, decay_scale, seed):
    rng = np.random.default_rng(seed)
    g = b * nc * h
    r, k, v = (rng.normal(0, 1, (g, c, n)).astype(np.float32) for _ in range(3))
    lw = -(0.01 + (decay_scale - 0.01) * rng.random((g, c, n))).astype(np.float32)
    lcum = np.cumsum(lw, axis=1, dtype=np.float32)
    lex = (lcum - lw).astype(np.float32)
    u = rng.normal(0, 0.3, (h, n)).astype(np.float32)
    dy = rng.normal(0, 1, (g, c, n)).astype(np.float32)
    return r, k, v, lex, lcum, u, dy


@pytest.mark.parametrize("shape", [(1, 2, 3, 16, 8, 1.0), (2, 1, 2, 1, 8, 1.0), (1, 3, 2, 17, 12, 1.0),
                                   (1, 2, 2, 32, 16, 50.0)],
                         ids=["c16", "c1", "ragged-c17", "strong-decay"])
def test_intra_autograd_matches_reference_vjp(shape):
    b, nc, h, c, n, decay, = shape
    r, k, v, lex, lcum, u, dy = _intra_case(b, nc, h, c, n, decay, seed=c)
    tile = lambda x: jnp.tile(x[None], (b * nc, 1, 1)).reshape(-1, n)
    _, vjp = jax.vjp(lambda *a: rwkv_intra_ref(*a[:5], tile(a[5])), *map(jnp.asarray, (r, k, v, lex, lcum, u)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(dy))]
    if decay > 1:
        # above the diagonal the reference's exp overflows and its masked
        # product's gradient is inf * 0 = NaN; the port masks the exponent,
        # so it is held to its float64 plain version there
        assert np.isnan(want[0]).any()
        wide = intra_lib.rwkv_intra_bwd_plain(*(torch.from_numpy(x).double() for x in (
            r, k, v, lex, lcum, np.tile(u[None], (b * nc, 1, 1)).reshape(-1, n), dy)))
        want = [w.numpy() for w in wide[:5]] + [wide[5].reshape(b * nc, h, n).sum(0).numpy()]

    ins = [torch.from_numpy(x).requires_grad_(True) for x in (r, k, v, lex, lcum, u)]
    ug = ins[5][None].expand(b * nc, h, n).reshape(-1, n)
    y = rwkv6.IntraChunk.apply(*ins[:5], ug)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(rwkv_intra_ref(*map(jnp.asarray, (r, k, v, lex, lcum)),
                                                                             tile(jnp.asarray(u)))),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(y, ins, torch.from_numpy(dy))
    for name, gt, wt in zip(("r", "k", "v", "lex", "lcum", "u"), got, want):
        assert gt.shape == wt.shape and gt.dtype == torch.float32
        assert _leaf_err(gt.numpy(), wt) <= INTRA_GRAD_RTOL, name


def test_intra_bwd_plain_per_cell_du_and_float64_oracle():
    # the plain backward's du is per cell (the kernel writes it once a
    # cell); over float64 inputs it runs in float64, the card's oracle
    r, k, v, lex, lcum, u, dy = _intra_case(1, 2, 3, 16, 8, 1.0, seed=3)
    ug = np.tile(u[None], (2, 1, 1)).reshape(-1, 8)
    got = intra_lib.rwkv_intra_bwd(*(torch.from_numpy(x) for x in (r, k, v, lex, lcum, ug, dy)))
    _, vjp = jax.vjp(rwkv_intra_ref, *map(jnp.asarray, (r, k, v, lex, lcum, ug)))
    for gt, wt in zip(got, vjp(jnp.asarray(dy))):
        assert _leaf_err(gt.numpy(), np.asarray(wt)) <= INTRA_GRAD_RTOL
    wide = intra_lib.rwkv_intra_bwd_plain(*(torch.from_numpy(x).double() for x in (r, k, v, lex, lcum, ug, dy)))
    assert all(t.dtype == torch.float64 for t in wide)
    for gt, wt in zip(got, wide):
        assert _leaf_err(gt.numpy(), wt.numpy()) <= INTRA_GRAD_RTOL
    assert launch_counts()["rwkv_intra_bwd"] == 0  # CPU tensors: the plain version


# ----------------------------------------------------------------------------
# data and the tap
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [512, 32000, 151936, 256000])
def test_batches_match_reference(vocab):
    for dist in ("unique", "uniform", "zipf"):
        flips = total = 0
        for s in (0, 1, 77):
            ref_cfg = ref_pipeline.DataConfig(vocab, 8, 1024, seed=3, distribution=dist)
            cfg = pipeline.DataConfig(vocab, 8, 1024, seed=3, distribution=dist)
            want = ref_pipeline.batch_at_step(ref_cfg, jnp.asarray(s, jnp.int32))
            got = pipeline.batch_at_step(cfg, s, "cpu")
            assert set(got) == {"tokens", "targets"}
            for key in got:
                assert got[key].dtype == torch.int32 and tuple(got[key].shape) == (8, 1024)
            if dist != "zipf":
                for key in got:
                    np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
                continue
            arg = pipeline.zipf_exponent(cfg, s, "cpu").numpy()
            flips += zipf_flips(got["tokens"].numpy(), np.asarray(want["tokens"]), arg[:-1], vocab)
            zipf_flips(got["targets"].numpy(), np.asarray(want["targets"]), arg[1:], vocab)
            total += 8 * 1024
        assert flips <= zipf_flip_bound(vocab, total), (dist, flips)


def test_host_shard_and_stream_chunks_match_reference():
    cfg, ref_cfg = pipeline.DataConfig(512, 8, 16, distribution="uniform"), ref_pipeline.DataConfig(
        512, 8, 16, distribution="uniform")
    batch = pipeline.batch_at_step(cfg, 5, "cpu")
    ref_batch = ref_pipeline.batch_at_step(ref_cfg, jnp.asarray(5, jnp.int32))
    for host in range(4):
        got, want = pipeline.host_shard(batch, host, 4), ref_pipeline.host_shard(ref_batch, host, 4)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    got = list(pipeline.stream_chunks(cfg, 3, start_step=2, device="cpu"))
    want = list(ref_pipeline.stream_chunks(ref_cfg, 3, start_step=2))
    assert [s for s, _ in got] == [s for s, _ in want] == [2, 3, 4]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g["tokens"].numpy(), np.asarray(w["tokens"]))


@pytest.mark.parametrize("p,hash_bits", [(14, 64), (16, 64), (12, 32)])
def test_datapath_tap_bit_identical_to_reference(p, hash_bits):
    rng = np.random.default_rng(p + hash_bits)
    cfg, ref_cfg = HLLConfig(p=p, hash_bits=hash_bits), ref_hll.HLLConfig(p=p, hash_bits=hash_bits)
    regs, ref_regs = hll.init_registers(cfg, "cpu"), ref_hll.init_registers(ref_cfg)
    for _ in range(3):
        tokens = rng.integers(0, 65536, (4, 256)).astype(np.int32)
        regs = dispatch.datapath_tap(regs, torch.from_numpy(tokens), cfg)
        ref_regs = ref_dispatch.datapath_tap(ref_regs, jnp.asarray(tokens), ref_cfg)
        np.testing.assert_array_equal(regs.numpy(), np.asarray(ref_regs))
    assert regs.dtype == torch.uint8 and launch_counts()["hll_update_fused"] == 0


# ----------------------------------------------------------------------------
# the step
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id,accum", [("qwen2-vl-72b", 2), ("smollm-360m", 1)])
def test_train_step_matches_reference(arch_id, accum, f32):
    ref_arch, arch = _archs(arch_id, f"-f32-step{accum}")
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=4)
    ref_cfg = ref_step.TrainConfig(optimizer=ref_adamw.OptimizerConfig(**kw), sketch=ref_hll.HLLConfig(12, 64),
                                   grad_accum=accum)
    cfg = step.TrainConfig(optimizer=adamw.OptimizerConfig(**kw), sketch=HLLConfig(12, 64), grad_accum=accum)
    ref_state = ref_step.init_train_state(jax.random.PRNGKey(0), ref_arch, ref_cfg)
    state = interop.train_state_from_reference(jax.tree_util.tree_map(np.asarray, ref_state), arch, "cpu")
    assert all(p.requires_grad for p in state["params"].parameters())
    ref_batch, batch = _batches(arch, ref_arch, b=4, s=32)
    ref_state, ref_m = jax.jit(lambda s, b: ref_step.train_step(s, b, ref_arch, ref_cfg))(ref_state, ref_batch)
    state, m = step.make_jitted_step(arch, cfg)(state, batch)

    assert set(m) == set(ref_m) == {"loss", "nll", "aux", "distinct_tokens", "lr", "grad_norm"}
    for key in ("loss", "nll", "distinct_tokens", "lr"):
        np.testing.assert_allclose(float(m[key]), float(ref_m[key]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-5)
    got, want = interop.train_state_to_reference(state), jax.tree_util.tree_map(np.asarray, ref_state)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    np.testing.assert_array_equal(got["sketch"], want["sketch"])
    assert int(got["step"]) == int(got["opt"]["count"]) == 1 and got["step"].dtype == np.int32
    for moment in ("mu", "nu"):
        errs = _tree_errs(got["opt"][moment], want["opt"][moment])
        assert max(errs.values()) <= GRAD_RTOL, (moment, errs)
    turned = n = 0
    for key, a in jax.tree_util.tree_leaves_with_path(want["params"]):
        g = dict(jax.tree_util.tree_leaves_with_path(got["params"]))[key]
        err, scale = np.abs(g - a), np.abs(a).max()
        assert err.max() <= 2 * kw["lr"] + 1e-6 * scale
        turned += int((err > 1e-6 * scale).sum())
        n += a.size
    assert turned <= 0.01 * n


def test_init_train_state_layout():
    arch = configs.get_arch("smollm-360m").reduced()
    state = step.init_train_state(torch.Generator().manual_seed(0), arch, step.TrainConfig(), "cpu")
    assert set(state) == {"params", "opt", "step", "sketch"}
    assert all(p.requires_grad and p.dtype == torch.float32 for p in state["params"].parameters())
    assert state["sketch"].shape == (1 << 16,) and state["sketch"].dtype == torch.uint8
    tree = interop.train_state_to_reference(state)
    ref_tree = jax.eval_shape(lambda k: ref_step.init_train_state(k, ref_configs.get_arch("smollm-360m").reduced(),
                                                                  ref_step.TrainConfig()), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(ref_tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(ref_tree)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_none_device_means_the_card_or_an_error(monkeypatch):
    # ROADMAP C.2 and the new entry points: None is the card, which must exist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = configs.get_arch("smollm-360m").reduced()
    calls = {
        "default_positions": lambda: transformer.default_positions(arch, 2, 8),
        "rope_frequencies": lambda: common.rope_frequencies(32, 10_000.0),
        "u64.from_py": lambda: u64.from_py(7),
        "u64.from_numpy": lambda: u64.from_numpy(np.arange(3, dtype=np.uint64)),
        "batch_at_step": lambda: pipeline.batch_at_step(pipeline.DataConfig(512, 2, 8), 0),
        "stream_chunks": lambda: next(pipeline.stream_chunks(pipeline.DataConfig(512, 2, 8), 1)),
        "init_train_state": lambda: step.init_train_state(torch.Generator(), arch, step.TrainConfig()),
        "loop.train": lambda: loop.train(arch, step.TrainConfig(), pipeline.DataConfig(512, 2, 8), loop.LoopConfig(1)),
        "launch.train": lambda: launch.main(["--steps", "1"]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ----------------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------------


def _spy_steps(monkeypatch, module, make, record):
    def spy(*args, **kwargs):
        fn = make(*args, **kwargs)

        def stepped(state, batch):
            state, metrics = fn(state, batch)
            record.append({k: float(v) for k, v in metrics.items()})
            return state, metrics
        return stepped

    monkeypatch.setattr(module, "make_jitted_step", spy)


def test_train_launcher_matches_the_reference_launcher(monkeypatch, f32):
    argv = ["--steps", "3", "--global-batch", "2", "--seq-len", "32", "--sketch-p", "10"]
    ref_arch = ref_configs.get_arch("smollm-360m").reduced()
    arch = configs.get_arch("smollm-360m").reduced()
    ref_cfg = ref_step.TrainConfig(sketch=ref_hll.HLLConfig(p=10, hash_bits=64))
    initial = jax.tree_util.tree_map(np.asarray, ref_step.init_train_state(jax.random.PRNGKey(0), ref_arch, ref_cfg))
    monkeypatch.setattr(loop, "init_state", lambda a, c, seed, device: interop.train_state_from_reference(
        initial, arch, device))
    ref_steps, steps = [], []
    _spy_steps(monkeypatch, ref_loop, ref_loop.make_jitted_step, ref_steps)
    _spy_steps(monkeypatch, loop, loop.make_jitted_step, steps)
    ref_out, out = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with contextlib.redirect_stdout(ref_out):
        ref_launch.main()
    with contextlib.redirect_stdout(out):
        state, history = launch.main(argv + ["--device", "cpu"])
    assert len(steps) == len(ref_steps) == 3
    for got, want in zip(steps, ref_steps):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LAUNCH_RTOL)
        assert got["lr"] == want["lr"]
    ref_lines, lines = ref_out.getvalue().splitlines(), out.getvalue().splitlines()
    assert [line.split("(")[0] for line in lines[-1:]] == [line.split("(")[0] for line in ref_lines[-1:]]
    assert lines[-1].startswith("[loop] exact-finalized distinct-token estimate (original): ")
    assert history[-1]["step"] == 3 and lines[0].startswith("[step     3] loss=")


# ----------------------------------------------------------------------------
# steps at the first step's full rate, beside the reference
# ----------------------------------------------------------------------------


def _steps_beside_reference(arch, ref_arch, lr, batch, seq, device, steps=WITNESS_STEPS):
    """The loss of each of ``steps`` train steps of the port (on ``device``)
    and of the jitted reference (on the host), from one initial state (the
    port's, drawn on ``device``), over the same zipf batches, with the
    launcher's optimizer at ``steps`` steps: warmup max(1, steps // 10) = 1,
    so the first update moves every weight by the whole rate."""
    kw = dict(lr=lr, warmup_steps=max(1, steps // 10), total_steps=steps)
    cfg = step.TrainConfig(optimizer=adamw.OptimizerConfig(**kw), sketch=HLLConfig(14, 64))
    ref_cfg = ref_step.TrainConfig(optimizer=ref_adamw.OptimizerConfig(**kw), sketch=ref_hll.HLLConfig(14, 64))
    state = loop.init_state(arch, cfg, 0, device)
    ref_state = jax.tree_util.tree_map(jnp.asarray, interop.train_state_to_reference(state))
    data = pipeline.DataConfig(arch.vocab_size, batch, seq)
    fn, ref_fn = step.make_jitted_step(arch, cfg), jax.jit(lambda s, b: ref_step.train_step(s, b, ref_arch, ref_cfg))
    losses, ref_losses = [], []
    for i in range(steps):
        host = pipeline.batch_at_step(data, i, "cpu")
        _, m = fn(state, {k: v.to(device) for k, v in host.items()})
        ref_state, ref_m = ref_fn(ref_state, {k: jnp.asarray(v.numpy()) for k, v in host.items()})
        losses.append(float(m["loss"]))
        ref_losses.append(float(ref_m["loss"]))
    return np.array(losses), np.array(ref_losses)


def _assert_histories_agree(losses, ref_losses, rtol):
    """Each step's loss within ``rtol`` of the reference's, and each step's
    change of the loss within ``rtol`` of the loss of the reference's change."""
    np.testing.assert_allclose(losses, ref_losses, rtol=rtol)
    np.testing.assert_allclose(np.diff(losses), np.diff(ref_losses), atol=rtol * float(np.abs(ref_losses).max()))


def _witness_legs(monkeypatch, leg, arch, ref_arch):
    """The leg's dtype set in both packages; the float32 leg renames the
    reference's arch for its jit caches."""
    if leg == "bf16":
        return ref_arch
    monkeypatch.setattr(ref_common, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    return dataclasses.replace(ref_arch, name=f"{ref_arch.name}-f32-witness-{arch.n_layers}")


@pytest.mark.parametrize("leg", ["bf16", "f32"])
@pytest.mark.parametrize("arch_id", ["tinyllama-1.1b", "rwkv6-3b"])
def test_steps_at_warmup_one_match_reference(arch_id, leg, monkeypatch):
    # the rehearsal, at the reduced size, of the full-width witness below
    arch = configs.get_arch(arch_id).reduced()
    ref_arch = _witness_legs(monkeypatch, leg, arch, ref_configs.get_arch(arch_id).reduced())
    losses, ref_losses = _steps_beside_reference(arch, ref_arch, WITNESS_LR, 2, 64, "cpu")
    print(arch_id, leg, "port", losses.tolist(), "reference", ref_losses.tolist())
    _assert_histories_agree(losses, ref_losses, WITNESS_RTOL[leg])


# ----------------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_none_device_lands_on_the_card():
    _card()
    arch = configs.get_arch("qwen2-vl-72b").reduced()
    made = [transformer.default_positions(arch, 2, 8), common.rope_frequencies(32, 10_000.0), u64.from_py(7),
            u64.from_numpy(np.arange(3, dtype=np.uint64)),
            pipeline.batch_at_step(pipeline.DataConfig(512, 2, 8), 0)["tokens"],
            step.init_train_state(torch.Generator(device="cuda"), arch, step.TrainConfig())["sketch"]]
    assert [t.device.type for t in made] == ["cuda"] * len(made)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 40, 64, 64, 1.0, False), (1, 1, 3, 1, 64, 1.0, False),
                                   (1, 2, 5, 40, 64, 1.0, False), (1, 2, 3, 17, 30, 1.0, False),
                                   (1, 2, 4, 64, 64, 50.0, False), (1, 1, 2, 32, 32, 50.0, False),
                                   (1, 2, 20, 8, 64, 1.0, False), (1, 2, 20, 9, 64, 1.0, False),
                                   (1, 2, 20, 57, 64, 1.0, False), (1, 2, 20, 64, 1, 1.0, False),
                                   (1, 2, 20, 64, 33, 1.0, False), (8, 16, 40, 64, 64, 1.0, False),
                                   (2, 16, 40, 64, 64, 1.0, True), (1, 2, 20, 64, 64, 200.0, False)],
                         ids=["train", "c1", "ragged-c40", "c17-n30", "strong-decay", "strong-c32", "c8", "c9",
                              "c57", "n1", "n33", "serve-grid", "zero-dy", "decay-200"])
def test_intra_bwd_kernel_matches_plain_on_card(shape):
    # ragged sub-chunks (C = 8, 9, 57), N off 4 and 32, the serve grid (5120
    # cells: a race shows in a few cells), dy = 0 (exact zeros) and decay
    # scale 200, where the two-level factors underflow
    dev = _card()
    b, nc, h, c, n, decay, zero_dy = shape
    r, k, v, lex, lcum, u, dy = _intra_case(b, nc, h, c, n, decay, seed=c + n)
    if zero_dy:
        dy = np.zeros_like(dy)
    ug = np.tile(u[None], (b * nc, 1, 1)).reshape(-1, n)
    ins = [torch.from_numpy(x).to(dev) for x in (r, k, v, lex, lcum, ug, dy)]
    before = launch_counts()["rwkv_intra_bwd"]
    got = intra_lib.rwkv_intra_bwd(*ins)
    torch.cuda.synchronize()
    assert launch_counts()["rwkv_intra_bwd"] == before + 1
    oracle = intra_lib.rwkv_intra_bwd_plain(*(t.double() for t in ins))
    plain = intra_lib.rwkv_intra_bwd_plain(*ins)
    for name, gt, pt, wt in zip(("r", "k", "v", "lex", "lcum", "u"), got, plain, oracle):
        assert torch.isfinite(gt).all(), name
        # the kernel within the float32 plain version's own distance of the oracle
        assert _leaf_err(gt.cpu().numpy(), wt.cpu().numpy()) <= INTRA_GRAD_RTOL, name
        assert _leaf_err(gt.cpu().numpy(), pt.cpu().numpy()) <= 2 * INTRA_GRAD_RTOL, name


@pytest.mark.gpu
def test_batches_and_tap_on_card():
    dev = _card()
    for vocab in (512, 49152, 65536):
        for dist in ("unique", "uniform", "zipf"):
            cfg = pipeline.DataConfig(vocab, 8, 1024, seed=1, distribution=dist)
            got, want = pipeline.batch_at_step(cfg, 9, dev), pipeline.batch_at_step(cfg, 9, "cpu")
            assert got["tokens"].device.type == "cuda"
            if dist != "zipf":
                assert torch.equal(got["tokens"].cpu(), want["tokens"])
                continue
            flips = zipf_flips(got["tokens"].cpu().numpy(), want["tokens"].numpy(),
                               pipeline.zipf_exponent(cfg, 9, "cpu")[:-1].numpy(), vocab)
            assert flips <= zipf_flip_bound(vocab, 8 * 1024)
    cfg = HLLConfig(p=16, hash_bits=64)
    tokens = pipeline.batch_at_step(pipeline.DataConfig(65536, 8, 1024), 2, dev)["tokens"]
    reset_launches()
    regs = dispatch.datapath_tap(hll.init_registers(cfg, dev), tokens, cfg)
    assert launch_counts()["hll_update_fused"] == 1
    assert torch.equal(regs.cpu(), hll.update(hll.init_registers(cfg, "cpu"), tokens.cpu(), cfg))


@pytest.mark.gpu
def test_rwkv_train_step_on_card_launches_the_kernel_pair(monkeypatch):
    # the reduced RWKV6 with grad_accum 2: each layer and micro-batch
    # launches rwkv_intra twice (the forward and the checkpoint's recompute)
    # and rwkv_intra_bwd once; the tap launches hll_update_fused once a
    # step; loss and grad norm agree with the same step on the CPU
    dev = _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    arch = configs.get_arch("rwkv6-3b").reduced()
    cfg = step.TrainConfig(sketch=HLLConfig(12, 64), grad_accum=2)
    cpu = step.init_train_state(torch.Generator().manual_seed(0), arch, cfg, "cpu")
    card = interop.train_state_from_reference(interop.train_state_to_reference(cpu), arch, dev)
    data = pipeline.DataConfig(arch.vocab_size, 4, 128)
    reset_launches()
    _, m_card = step.train_step(card, pipeline.batch_at_step(data, 0, dev), arch, cfg)
    counts = launch_counts()
    assert counts["rwkv_intra"] == 2 * 2 * arch.n_layers and counts["rwkv_intra_bwd"] == 2 * arch.n_layers
    assert counts["hll_update_fused"] == 1
    _, m_cpu = step.train_step(cpu, pipeline.batch_at_step(data, 0, "cpu"), arch, cfg)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_card[key]), float(m_cpu[key]), rtol=1e-4)
    assert torch.equal(card["sketch"].cpu(), cpu["sketch"])


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["bf16", "f32"])
@pytest.mark.parametrize("arch_id", ["tinyllama-1.1b", "rwkv6-3b"])
def test_full_width_steps_at_warmup_one_witnessed_by_the_reference(arch_id, leg, monkeypatch):
    # the full-width train runs' optimizer (warmup 1, so the first update
    # moves every weight by the whole rate) at WITNESS_LR over the first
    # WITNESS_LAYERS layers at full width: the port on the card, the
    # reference on the host, the same initial state and batches; the loss
    # histories must agree, so what the loss does there is the algorithm's
    dev = _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    arch = dataclasses.replace(configs.get_arch(arch_id), n_layers=WITNESS_LAYERS)
    ref_arch = _witness_legs(monkeypatch, leg, arch,
                             dataclasses.replace(ref_configs.get_arch(arch_id), n_layers=WITNESS_LAYERS))
    t0 = time.perf_counter()
    losses, ref_losses = _steps_beside_reference(arch, ref_arch, WITNESS_LR, 2, 256, dev)
    print(f"{arch_id} x{WITNESS_LAYERS} {leg} lr {WITNESS_LR}: port {losses.tolist()} "
          f"reference {ref_losses.tolist()} ({time.perf_counter() - t0:.1f} s)")
    _assert_histories_agree(losses, ref_losses, WITNESS_RTOL[leg])
