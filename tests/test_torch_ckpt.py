"""Port vs reference: checkpoints and resumption.

Both packages write one directory per step -- ``step_<n>/leaf_<i>.npy``
and ``manifest.json`` -- with the reference's training state as its leaves
(each stage's layers stacked, ``jax.tree_util.keystr`` keypaths, the
reference's flatten order).  Held bit for bit: a directory the reference
writes restores into the port, and one the port writes into the
reference, with and without the error-feedback residuals; the port's
manifest equals the reference's for the same state; a save/restore round
trip (async too); and a resumed CPU run equal to an uninterrupted one.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import ckpt as ref_ckpt
from repro.sketch import hll as ref_hll
from repro.train import step as ref_step
from repro_torch import configs, interop
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, batch_at_step
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.sketch import HLLConfig
from repro_torch.train import loop, step

ARCH_ID = "olmoe-1b-7b"  # MoE channels and a stage of 2 stacked layers


def _ref_state(seed=0, ef=False):
    """A reference training state of the reduced arch with every leaf set:
    random weights and moments, a count, a step and registers."""
    arch = ref_configs.get_arch(ARCH_ID).reduced()
    state = ref_step.init_train_state(jax.random.PRNGKey(seed), arch, ref_step.TrainConfig(
        sketch=ref_hll.HLLConfig(p=10, hash_bits=64)))
    rng = np.random.default_rng(seed)
    fill = lambda tree: jax.tree_util.tree_map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32), tree)
    tree = jax.tree_util.tree_map(np.asarray, state)
    tree["opt"]["mu"], tree["opt"]["nu"] = fill(tree["params"]), fill(tree["params"])
    tree["opt"]["ef"] = fill(tree["params"]) if ef else None
    tree["opt"]["count"] = np.asarray(7, np.int32)
    tree["step"] = np.asarray(7, np.int32)
    tree["sketch"] = rng.integers(0, 40, tree["sketch"].shape).astype(np.uint8)
    return tree


def _template(ef=False):
    """A fresh port state of the same structure (other weights)."""
    state = step.init_train_state(torch.Generator().manual_seed(5), configs.get_arch(ARCH_ID).reduced(),
                                  step.TrainConfig(sketch=HLLConfig(p=10, hash_bits=64)), "cpu")
    if ef:
        state["opt"]["ef"] = {name: torch.zeros_like(p) for name, p in state["opt"]["mu"].items()}
    return state


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "error-feedback"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, ef):
    tree = _ref_state(ef=ef)
    ref_ckpt.save(jax.tree_util.tree_map(jnp.asarray, tree), str(tmp_path), 7)
    assert ckpt.latest_step(str(tmp_path)) == 7
    state = ckpt.restore(_template(ef), str(tmp_path), 7)
    _assert_trees_equal(interop.train_state_to_reference(state), tree)
    assert all(p.requires_grad for p in state["params"].parameters())


@pytest.mark.parametrize("ef", [False, True], ids=["plain", "error-feedback"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, ef):
    tree = _ref_state(seed=1, ef=ef)
    state = interop.train_state_from_reference(tree, configs.get_arch(ARCH_ID).reduced(), "cpu")
    ckpt.save(state, str(tmp_path / "port"), 3)
    ref_ckpt.save(jax.tree_util.tree_map(jnp.asarray, tree), str(tmp_path / "ref"), 3)
    manifests = [json.loads((tmp_path / d / "step_3" / "manifest.json").read_text()) for d in ("port", "ref")]
    assert manifests[0] == manifests[1]  # the same leaves, keys, order, shapes and dtypes
    template = jax.tree_util.tree_map(jnp.asarray, _ref_state(seed=2, ef=ef))
    restored = ref_ckpt.restore(template, str(tmp_path / "port"), 3)
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, restored), tree)


def test_round_trip_and_refusals(tmp_path):
    state = interop.train_state_from_reference(_ref_state(seed=3), configs.get_arch(ARCH_ID).reduced(), "cpu")
    handle = ckpt.save(state, str(tmp_path), 11, async_write=True)
    handle.join()
    assert sorted(os.listdir(tmp_path)) == ["step_11"]
    template = _template()
    assert ckpt.restore(template, str(tmp_path), 11) is template
    _assert_trees_equal(interop.train_state_to_reference(template), interop.train_state_to_reference(state))
    with pytest.raises(ValueError, match="incompatible structures"):
        ckpt.restore(_template(ef=True), str(tmp_path), 11)
    other = step.init_train_state(torch.Generator(), configs.get_arch("smollm-360m").reduced(),
                                  step.TrainConfig(sketch=HLLConfig(p=10, hash_bits=64)), "cpu")
    with pytest.raises((KeyError, ValueError)):
        ckpt.restore(other, str(tmp_path), 11)
    manifest = tmp_path / "step_11" / "manifest.json"
    meta = json.loads(manifest.read_text())
    meta["leaves"][-1]["key"] = "['nope']"
    manifest.write_text(json.dumps(meta))
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(_template(), str(tmp_path), 11)


def test_async_save_holds_the_state_of_its_step(tmp_path, monkeypatch):
    # the loop saves asynchronously and steps on while the thread writes:
    # the checkpoint must hold the state at the save's step, every leaf (the
    # unstacked ones too, whose host arrays a CPU tensor could share)
    arch = configs.get_arch(ARCH_ID).reduced()
    cfg = step.TrainConfig(optimizer=OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=4),
                           sketch=HLLConfig(p=10, hash_bits=64))
    data = DataConfig(vocab_size=arch.vocab_size, global_batch=2, seq_len=32)
    state = loop.init_state(arch, cfg, 0, "cpu")
    fn = step.make_jitted_step(arch, cfg)
    state, _ = fn(state, batch_at_step(data, 0, "cpu"))
    at_save = interop.train_state_to_reference(state)
    release, save = threading.Event(), np.save

    def held_save(*args, **kwargs):  # the write waits until the next step is done
        assert release.wait(60)
        return save(*args, **kwargs)

    monkeypatch.setattr(np, "save", held_save)
    handle = ckpt.save(state, str(tmp_path), 1, async_write=True)
    state, _ = fn(state, batch_at_step(data, 1, "cpu"))
    release.set()
    handle.join()
    after = interop.train_state_to_reference(state)
    assert not np.array_equal(after["params"]["embed"], at_save["params"]["embed"])
    _assert_trees_equal(interop.train_state_to_reference(ckpt.restore(_template(), str(tmp_path), 1)), at_save)


def test_latest_step(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "absent")) is None
    for name in ("step_3", "step_12", ".tmp_step_40", "step_x", "other"):
        (tmp_path / name).mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 12


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    # 6 steps straight, against 3 steps, a checkpoint, and a resumed run
    # to 6: bit for bit on the CPU, the sketch included
    arch = configs.get_arch("rwkv6-3b").reduced()
    cfg = step.TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=6),
                           sketch=HLLConfig(p=8, hash_bits=32), grad_accum=2)
    data = DataConfig(vocab_size=arch.vocab_size, global_batch=2, seq_len=64)
    quiet = lambda line: None
    full, full_history = loop.train(arch, cfg, data, loop.LoopConfig(6, ckpt_every=100, log_every=1),
                                    log_fn=quiet, device="cpu")
    d = str(tmp_path / "ck")
    loop.train(arch, cfg, data, loop.LoopConfig(3, ckpt_every=3, ckpt_dir=d, log_every=1), log_fn=quiet,
               device="cpu")
    lines = []
    resumed, history = loop.train(arch, cfg, data, loop.LoopConfig(6, ckpt_every=100, ckpt_dir=d, log_every=1),
                                  log_fn=lines.append, device="cpu")
    assert lines[0] == "[loop] resumed from step 3"
    assert [h["step"] for h in history] == [4, 5, 6]
    assert history == full_history[3:]
    _assert_trees_equal(interop.train_state_to_reference(resumed), interop.train_state_to_reference(full))
    assert ckpt.latest_step(d) == 6


@pytest.mark.gpu
def test_round_trip_and_resume_on_card(tmp_path):
    # the embedding's backward scatters with atomics unless the run is
    # deterministic; under use_deterministic_algorithms a resumed run on the
    # card equals an uninterrupted one bit for bit
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arch = configs.get_arch("rwkv6-3b").reduced()
    cfg = step.TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                           sketch=HLLConfig(p=8, hash_bits=32))
    data = DataConfig(vocab_size=arch.vocab_size, global_batch=2, seq_len=128)
    quiet = lambda line: None
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        full, _ = loop.train(arch, cfg, data, loop.LoopConfig(4, ckpt_every=100), log_fn=quiet)
        d = str(tmp_path / "ck")
        loop.train(arch, cfg, data, loop.LoopConfig(2, ckpt_every=2, ckpt_dir=d), log_fn=quiet)
        resumed, _ = loop.train(arch, cfg, data, loop.LoopConfig(4, ckpt_every=100, ckpt_dir=d), log_fn=quiet)
    finally:
        torch.use_deterministic_algorithms(before)
    assert full["sketch"].device.type == "cuda"
    _assert_trees_equal(interop.train_state_to_reference(resumed), interop.train_state_to_reference(full))
    template = _template()
    ckpt.save(interop.train_state_from_reference(_ref_state(seed=4), configs.get_arch(ARCH_ID).reduced(), "cuda"),
              str(tmp_path / "rt"), 1)
    _assert_trees_equal(interop.train_state_to_reference(ckpt.restore(template, str(tmp_path / "rt"), 1)),
                        _ref_state(seed=4))
