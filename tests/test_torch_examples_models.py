"""Port vs reference: the model examples, ``examples_torch/serve_lm.py``,
``examples_torch/train_lm.py`` and ``examples_torch/elastic_rescale.py``.

Each port example runs with ``device="cpu"`` at a small size:

* ``serve_lm``: the reference example's calls (``engine.prefill``,
  ``engine.decode_loop``, a ``StreamSketch`` board) on the reference's
  reduced model and prompts (``jax.random``), and the port's ``serve`` on
  the same weights (``interop.model_from_reference``) and prompts, in the
  float32 leg (``ACT_DTYPE`` float32 in both packages, a renamed arch for
  the jitted reference): the generated tokens equal; the board's items
  seen equal and its estimates within ``DEVICE_RTOL``.  TinyLlama (the
  default) and RWKV6;
* ``train_lm`` at 3 + 2 steps of 2 x 16 into a fresh checkpoint directory:
  the rerun logs its resume, and its state equals an uninterrupted 5-step
  run leaf for leaf (deterministic algorithms); the tap's registers equal
  the reference's ``hll.update`` of the same tokens;
* ``elastic_rescale`` at 3 + 3 steps: the sketch registers equal across the
  restore, every restored leaf on its sharding's device, the run resumed
  to step 6 with the registers of every step's tokens.

``gpu`` tests run the three examples on the card; they skip without one.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.serve import engine as ref_engine
from repro.sketch import hll as ref_hll
from repro.sketch.hll import HLLConfig as RefConfig
from repro.telemetry.sketchboard import StreamSketch as RefBoard
from repro_torch import configs, interop
from repro_torch.data.pipeline import DataConfig, batch_at_step
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.models import common
from repro_torch.sharding import specs
from repro_torch.sketch import hll

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from examples_torch import elastic_rescale, serve_lm, train_lm  # noqa: E402

DEVICE_RTOL = 1e-6  # the board's batched float32 estimates (tests/test_torch_estimators.py)
B, S, T = 2, 64, 8


# ----------------------------------------------------------------------------
# serve_lm
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ["tinyllama-1.1b", "rwkv6-3b"])
def test_serve_lm_matches_reference_in_float32(arch_id, monkeypatch, capsys):
    monkeypatch.setattr(ref_common, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    # the jitted reference decode must not reuse a bf16 trace
    ref_arch = dataclasses.replace(ref_configs.get_arch(arch_id).reduced(), name=f"{arch_id}-f32-example")
    params = ref_transformer.init_params(jax.random.PRNGKey(0), ref_arch)
    prompts = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, ref_arch.vocab_size)

    # the reference example's calls
    logits, cache = ref_engine.prefill(params, {"tokens": prompts}, ref_arch, kv_len=S + T + 1)
    first = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)
    generated, _ = ref_engine.decode_loop(params, cache, first, jnp.asarray(S, jnp.int32), ref_arch, steps=T)
    board = RefBoard(RefConfig(p=12, hash_bits=64))
    board.observe("request_ids", jnp.arange(1000, 1000 + B, dtype=jnp.int32))
    board.observe("prompt_tokens", prompts)
    board.observe("generated_tokens", generated)
    want = board.report()

    arch = configs.get_arch(arch_id).reduced()
    model = interop.model_from_reference(jax.tree_util.tree_map(np.asarray, params), arch, "cpu")
    batch = {"tokens": torch.from_numpy(np.array(prompts, np.int32))}
    got = serve_lm.serve(model, batch, arch, T)
    np.testing.assert_array_equal(got["first"].numpy(), np.asarray(first))
    np.testing.assert_array_equal(got["generated"].numpy(), np.asarray(generated))
    assert list(got["report"]) == list(want) == ["request_ids", "prompt_tokens", "generated_tokens"]
    for name, row in want.items():
        assert got["report"][name]["items_seen"] == row["items_seen"]
        np.testing.assert_allclose(got["report"][name]["estimate"], row["estimate"], rtol=DEVICE_RTOL)
    assert f"sample output: {np.asarray(generated[0])[:16].tolist()}" in capsys.readouterr().out


def test_serve_lm_main_draws_on_the_device_and_reports(capsys):
    got = serve_lm.main(["--device", "cpu", "--requests", "2", "--prompt-len", "16", "--gen-len", "4"])
    assert tuple(got["generated"].shape) == (2, 4)
    report = got["report"]
    assert [report[n]["items_seen"] for n in report] == [2, 32, 8]
    assert "served 2 requests" in capsys.readouterr().out


# ----------------------------------------------------------------------------
# train_lm
# ----------------------------------------------------------------------------


def _train_argv(steps: int, ckpt_dir, every: int) -> list:
    return ["--device", "cpu", "--steps", str(steps), "--batch", "2", "--seq", "16", "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", str(every)]


def _same_leaves(a: dict, b: dict) -> int:
    leaves_a, leaves_b = interop.train_state_leaves(a), interop.train_state_leaves(b)
    assert [p for p, _, _ in leaves_a] == [p for p, _, _ in leaves_b]
    for (path, ta, _), (_, tb, _) in zip(leaves_a, leaves_b):
        assert all(torch.equal(x, y) for x, y in zip(ta, tb)), path
    return len(leaves_a)


def test_train_lm_resumes_to_the_uninterrupted_state(tmp_path, capsys):
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        train_lm.main(_train_argv(3, tmp_path / "killed", 3))
        resumed = train_lm.main(_train_argv(5, tmp_path / "killed", 3))
        printed = capsys.readouterr().out
        straight = train_lm.main(_train_argv(5, tmp_path / "straight", 50))
    finally:
        torch.use_deterministic_algorithms(before)
    assert "[loop] resumed from step 3" in printed
    assert [row["step"] for row in resumed["history"]] == [5]
    assert _same_leaves(resumed["state"], straight["state"]) > 3
    assert int(resumed["state"]["step"]) == 5

    # the tap: the reference's hll.update over the same tokens
    arch = configs.get_arch("smollm-360m").reduced()
    data = DataConfig(vocab_size=arch.vocab_size, global_batch=2, seq_len=16)
    tokens = np.concatenate([batch_at_step(data, s, "cpu")["tokens"].numpy().reshape(-1) for s in range(5)])
    cfg = RefConfig(p=14, hash_bits=64)
    want = ref_hll.update(ref_hll.init_registers(cfg), jnp.asarray(tokens), cfg)
    np.testing.assert_array_equal(resumed["state"]["sketch"].numpy(), np.asarray(want))


def test_train_lm_rerun_at_the_same_steps_trains_nothing(tmp_path):
    # the reference's behaviour (examples/train_lm.py): nothing is logged,
    # so the first logged loss is missing
    train_lm.main(_train_argv(2, tmp_path, 2))
    with pytest.raises(IndexError):
        train_lm.main(_train_argv(2, tmp_path, 2))


# ----------------------------------------------------------------------------
# elastic_rescale
# ----------------------------------------------------------------------------


def test_elastic_rescale_keeps_registers_across_the_restore(capsys):
    got = elastic_rescale.rescale(3, 6, "cpu")
    np.testing.assert_array_equal(got["sketch_restored"], got["sketch_before"])
    where = specs.tree_device(got["shardings"])
    assert where == torch.device("cpu")
    for _, tensors, _ in interop.train_state_leaves(got["restored"]):
        assert all(t.device == where for t in tensors)
    assert got["step"] == 6
    arch = configs.get_arch("smollm-360m").reduced()
    data = DataConfig(vocab_size=arch.vocab_size, global_batch=4, seq_len=64)
    cfg = hll.HLLConfig(p=10, hash_bits=64)
    tokens = torch.cat([batch_at_step(data, s, "cpu")["tokens"].reshape(-1) for s in range(6)])
    assert torch.equal(got["state"]["sketch"], hll.update(hll.init_registers(cfg, "cpu"), tokens, cfg))
    printed = capsys.readouterr().out
    assert "sketch registers survived resharding bit-exactly" in printed
    assert "[loop] resumed from step 3" in printed


# ----------------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", ["tinyllama-1.1b", "rwkv6-3b"])
def test_serve_lm_on_card_launches_its_kernels(arch_id):
    _card()
    reset_launches()
    got = serve_lm.main(["--arch", arch_id, "--requests", "2", "--prompt-len", "64", "--gen-len", "4"])
    counts = launch_counts()
    assert counts["hash_rank"] > 0 and counts["bank_scatter_max"] > 0
    if arch_id == "rwkv6-3b":
        assert counts["rwkv_intra"] == configs.get_arch(arch_id).reduced().n_layers
    assert got["report"]["generated_tokens"]["items_seen"] == 8


@pytest.mark.gpu
def test_train_lm_and_elastic_rescale_on_card(tmp_path):
    _card()
    reset_launches()
    train_lm.main(["--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "a"),
                   "--ckpt-every", "3"])
    assert launch_counts()["hll_update_fused"] == 3
    got = elastic_rescale.rescale(3, 6)
    np.testing.assert_array_equal(got["sketch_restored"], got["sketch_before"])
    assert got["step"] == 6
