"""Port vs reference: RWKV6 serving, prefill + decode, end to end.

The reference's reduced RWKV6-3B (2 layers, d 128, 4 heads of 32, vocab
512, chunk 64) is initialised once for the module and carried to the port
with ``repro_torch.interop``.  One seeded batch of B = 2 prompts of
S = 128 tokens (two chunks) goes through ``engine.prefill`` in both
packages, then ``decode_step`` is teacher-forced over the next T = 8 tokens
(so a greedy tie cannot fork the two runs), then ``decode_loop`` runs.
Two legs:

* float32: ``ACT_DTYPE`` set to float32 in both packages, held within
  ``F32_TOL`` (float32 sums in another order);
* bf16, as shipped, held within ``BF16_TOL`` on every value and
  ``BF16_MEAN`` on the mean.  XLA's CPU compiler keeps bf16 chains of
  elementwise ops in float32 inside a fusion (``xla_allow_excess_precision``,
  on by default), where PyTorch rounds after every op; with that flag off
  the two packages' bf16 token-shift states agree bit for bit and the
  logits' mean difference drops 4x, so the bf16 tolerance is that
  rounding, not the algorithm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.serve import engine as ref_engine
from repro_torch import configs, interop
from repro_torch.kernels import launch_counts, rwkv_intra
from repro_torch.models import common, rwkv6, transformer
from repro_torch.serve import engine

B, S, T = 2, 128, 8
F32_TOL = dict(rtol=1e-3, atol=1e-3)  # measured: 1.5e-4 on prefill logits, 5e-5 on states
BF16_TOL = dict(rtol=0, atol=0.5)  # measured: 0.17 on prefill logits, 0.12 on decode logits
BF16_MEAN = 0.05  # measured: 0.010 on prefill logits, 0.020 on decode logits
_ref_step = jax.jit(ref_engine.decode_step, static_argnames=("arch",))


@pytest.fixture(scope="module")
def ref():
    """(arch, reference params, the port's model, tokens (B, S + T))."""
    ref_arch = ref_configs.get_arch("rwkv6-3b").reduced()
    params = ref_transformer.init_params(jax.random.PRNGKey(0), ref_arch)
    arch = configs.get_arch("rwkv6-3b").reduced()
    model = interop.model_from_reference(jax.tree_util.tree_map(np.asarray, params), arch, "cpu")
    toks = np.random.default_rng(1).integers(0, arch.vocab_size, (B, S + T)).astype(np.int32)
    return ref_arch, params, model, toks


def _f32(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, leg):
    got, want = _f32(got), _f32(want)
    if leg == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, **BF16_TOL)
        assert np.abs(got - want).mean() <= BF16_MEAN


def _same_cache(mine, theirs, leg):
    for si, stage in enumerate(theirs["stages"]):
        for sub, entry in stage.items():
            for name, want in entry.items():
                got = mine["stages"][si][sub][name]
                assert tuple(got.shape) == want.shape
                assert got.dtype == (torch.float32 if want.dtype == jnp.float32 else common.ACT_DTYPE)
                _close(got, want, leg)


@pytest.mark.parametrize("leg", ["f32", "bf16"])
def test_prefill_then_teacher_forced_decode_matches_reference(ref, monkeypatch, leg):
    ref_arch, params, model, toks = ref
    arch = configs.get_arch("rwkv6-3b").reduced()
    if leg == "f32":
        monkeypatch.setattr(ref_common, "ACT_DTYPE", jnp.float32)
        monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
        # the jitted reference step must not reuse its bf16 trace
        ref_arch = dataclasses.replace(ref_arch, name="rwkv6-3b-f32")
    want_logits, want_cache = ref_engine.prefill(params, {"tokens": jnp.asarray(toks[:, :S])}, ref_arch, S + T)
    got_logits, got_cache = engine.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])}, arch, S + T)
    assert got_logits.dtype == common.ACT_DTYPE and tuple(got_logits.shape) == want_logits.shape
    _close(got_logits, want_logits, leg)
    _same_cache(got_cache, want_cache, leg)
    for t in range(T):
        want_step, want_cache = _ref_step(params, want_cache, jnp.asarray(toks[:, S + t]), jnp.asarray(S + t),
                                          arch=ref_arch)
        got_step, got_cache = engine.decode_step(model, got_cache, torch.from_numpy(toks[:, S + t]), S + t, arch)
        assert got_step.dtype == torch.float32
        _close(got_step, want_step, leg)
    _same_cache(got_cache, want_cache, leg)


def test_decode_loop_matches_reference_in_float32(ref, monkeypatch):
    ref_arch, params, model, toks = ref
    arch = configs.get_arch("rwkv6-3b").reduced()
    monkeypatch.setattr(ref_common, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    ref_arch = dataclasses.replace(ref_arch, name="rwkv6-3b-f32-loop")  # decode_loop is jitted on arch
    want_logits, want_cache = ref_engine.prefill(params, {"tokens": jnp.asarray(toks[:, :S])}, ref_arch, S + T)
    got_logits, got_cache = engine.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])}, arch, S + T)
    first = np.asarray(jnp.argmax(want_logits[:, -1], axis=-1)).astype(np.int32)
    assert np.array_equal(got_logits[:, -1].argmax(-1).numpy(), first)
    want, _ = ref_engine.decode_loop(params, want_cache, jnp.asarray(first), jnp.asarray(S, jnp.int32), ref_arch,
                                     steps=4)
    got, _ = engine.decode_loop(model, got_cache, torch.from_numpy(first), S, arch, steps=4)
    # float32 logits differ by < 1e-4 here, far inside every greedy margin of this batch
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


def test_decode_loop_is_greedy_over_decode_step(ref):
    _, _, model, toks = ref
    arch = configs.get_arch("rwkv6-3b").reduced()
    logits, cache = engine.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])}, arch, S + T)
    first = logits[:, -1].float().argmax(-1).to(torch.int32)
    got, _ = engine.decode_loop(model, cache, first, S, arch, steps=5)
    assert tuple(got.shape) == (B, 5) and bool(((got >= 0) & (got < arch.vocab_size)).all())
    tok, want = first, []
    for i in range(5):
        step, cache = engine.decode_step(model, cache, tok, S + i, arch)
        tok = step.argmax(-1).to(torch.int32)
        want.append(tok)
    assert torch.equal(got, torch.stack(want, dim=1))


def test_prefill_then_decode_matches_forward(ref):
    # the reference's own invariant (tests/test_serve.py), in the port:
    # a one-chunk prefill of 64, then 8 steps, against forward of 72 (the scan)
    _, _, model, toks = ref
    arch = configs.get_arch("rwkv6-3b").reduced()
    s = 64
    with torch.inference_mode():
        full, _, _ = transformer.forward(model, {"tokens": torch.from_numpy(toks[:, :s + T])}, arch)
    pre, cache = engine.prefill(model, {"tokens": torch.from_numpy(toks[:, :s])}, arch, s + T)
    np.testing.assert_allclose(_f32(pre), _f32(full[:, :s]), atol=0.1)
    for t in range(T):
        step, cache = engine.decode_step(model, cache, torch.from_numpy(toks[:, s + t]), s + t, arch)
        np.testing.assert_allclose(_f32(step), _f32(full[:, s + t]), atol=0.15)


def test_init_cache_matches_reference_layout():
    ref_arch, arch = ref_configs.get_arch("rwkv6-3b").reduced(), configs.get_arch("rwkv6-3b").reduced()
    want = ref_engine.init_cache(ref_arch, 3, 40)
    got = engine.init_cache(arch, 3, 40, "cpu")
    assert len(got["stages"]) == len(want["stages"]) and set(got) == set(want)
    for g, w in zip(got["stages"], want["stages"]):
        for sub, entry in w.items():
            assert set(g[sub]) == set(entry)
            for name, arr in entry.items():
                assert tuple(g[sub][name].shape) == arr.shape and not g[sub][name].any()
                assert g[sub][name].dtype == (torch.float32 if arr.dtype == jnp.float32 else torch.bfloat16)


def test_cache_round_trips_bit_for_bit(ref):
    ref_arch, params, _, toks = ref
    arch = configs.get_arch("rwkv6-3b").reduced()
    _, cache = ref_engine.prefill(params, {"tokens": jnp.asarray(toks[:, :S])}, ref_arch, S + T)
    entry = cache["stages"][0]["sub0"]
    as_f32 = {"stages": [{"sub0": {k: np.asarray(v, np.float32) for k, v in entry.items()}}]}
    as_bits = {"stages": [{"sub0": {k: (np.asarray(v).view(np.uint16) if v.dtype == jnp.bfloat16 else np.asarray(v))
                                    for k, v in entry.items()}}]}
    for crossing in (as_f32, as_bits):
        port = interop.cache_from_reference(crossing, arch, "cpu")
        assert port["stages"][0]["sub0"]["x_prev"].dtype == torch.bfloat16
        back = interop.cache_to_reference(port)["stages"][0]["sub0"]
        for name, want in as_f32["stages"][0]["sub0"].items():
            assert back[name].dtype == np.float32 and np.array_equal(back[name], want)
    bad = {"stages": [{"sub0": dict(as_f32["stages"][0]["sub0"], x_prev=as_f32["stages"][0]["sub0"]["x_prev"] + 1e-3)}]}
    with pytest.raises(ValueError, match="not bf16 values"):
        interop.cache_from_reference(bad, arch, "cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    arch = configs.get_arch("rwkv6-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.init_cache(arch, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(arch, torch.Generator().manual_seed(0))


@pytest.mark.gpu
def test_prefill_on_card_goes_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arch = configs.get_arch("rwkv6-3b").reduced()
    model = transformer.init_params(arch, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = {"tokens": torch.randint(0, arch.vocab_size, (B, S), device="cuda")}
    # float32 activations: kernel and plain intra sums differ in the last
    # place only, with no bf16 rounding to flip and carry
    before = common.ACT_DTYPE
    common.ACT_DTYPE = torch.float32
    try:
        launches = launch_counts()["rwkv_intra"]
        got, got_cache = engine.prefill(model, batch, arch, S + 1)
        assert launch_counts()["rwkv_intra"] == launches + arch.n_layers
        real = rwkv6.rwkv_intra
        rwkv6.rwkv_intra = rwkv_intra.rwkv_intra_plain
        try:
            want, want_cache = engine.prefill(model, batch, arch, S + 1)
        finally:
            rwkv6.rwkv_intra = real
    finally:
        common.ACT_DTYPE = before
    torch.testing.assert_close(got, want, **F32_TOL)
    torch.testing.assert_close(got_cache["stages"][0]["sub0"]["s"], want_cache["stages"][0]["sub0"]["s"], **F32_TOL)
