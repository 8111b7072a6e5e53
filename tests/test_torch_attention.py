"""Port vs reference: attention-family serving (ROADMAP A.12.1 without MoE
and RG-LRU).

The reference's reduced configs (2 layers, d 128, 4 heads of 32 over 2 KV
heads, vocab 512) are initialised with ``jax.random`` and carried to the
port with ``repro_torch.interop``; inputs are seeded numpy arrays handed to
both packages.  Two legs, as in tests/test_torch_serve.py:

* float32: ``ACT_DTYPE`` set to float32 in both packages; the algorithms
  agree within ``F32_TOL`` (measured: at most 4.9e-6 on the logits);
* bf16, as shipped, within ``BF16_TOL`` on every logit and ``BF16_MEAN`` on
  the mean (measured: at most 0.047 and 0.0095; logits have std ~1).  XLA's
  CPU compiler keeps fused bf16 chains in float32, PyTorch rounds each op
  (ROADMAP C), so this is rounding, not the algorithm.

Covered: ``apply_rope`` / ``apply_mrope``, GQA attention (blocked against
the reference and against the port's naive oracle), a sliding window with
the prompt longer than the window (the SWA ring wraps in decode),
``kvquant`` (int8 values and bf16 scales bit-identical), prefill and
teacher-forced decode for tinyllama-1.1b, smollm-360m (tied embeddings),
qwen2-vl-72b (M-RoPE and the frontend stub) and qwen3-32b (qk-norm), the
``ContinuousBatcher`` (the reference's tokens; a mixed batch gives each
request its solo tokens; recycled slots are clean), the model and cache
interop, parameter counts, and ``gpu`` tests of the card's attention
phase's checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro.serve import engine as ref_engine
from repro.serve import kvquant as ref_kvquant
from repro.serve import scheduler as ref_scheduler
from repro_torch import configs, interop
from repro_torch.models import attention, common, registry, transformer
from repro_torch.serve import engine, kvquant, scheduler

B, S, T = 2, 40, 6
F32_TOL = dict(rtol=1e-4, atol=1e-4)
F32_QUANT_ATOL = 5e-3  # an int8 step flips where float32 K/V differ in the last place (measured 9.6e-4)
BF16_TOL = dict(rtol=0, atol=0.15)
BF16_MEAN = 0.03
ARCHS = {
    "tinyllama": ("tinyllama-1.1b", {}),
    "smollm": ("smollm-360m", {}),
    "qwen2-vl": ("qwen2-vl-72b", {}),
    "qwen3": ("qwen3-32b", {}),
    "swa": ("tinyllama-1.1b", {"sliding_window": 16}),  # S = 40 > 16: the ring wraps
    "kvquant": ("tinyllama-1.1b", {"kv_quant": True}),
}
_ref_step = jax.jit(ref_engine.decode_step, static_argnames=("arch",))


def _archs(name):
    arch_id, extra = ARCHS[name]
    return (dataclasses.replace(ref_configs.get_arch(arch_id).reduced(), **extra),
            dataclasses.replace(configs.get_arch(arch_id).reduced(), **extra))


@pytest.fixture(scope="module")
def models():
    """name -> (reference params, the port's model), built once."""
    out = {}
    for name in ARCHS:
        ref_arch, arch = _archs(name)
        params = ref_transformer.init_params(jax.random.PRNGKey(0), ref_arch)
        out[name] = (params, interop.model_from_reference(jax.tree_util.tree_map(np.asarray, params), arch, "cpu"))
    return out


@pytest.fixture
def leg_dtype(request, monkeypatch):
    """Set both packages' activation dtype for the test's leg."""
    if request.param == "f32":
        monkeypatch.setattr(ref_common, "ACT_DTYPE", jnp.float32)
        monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    return request.param


def _f32(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, leg, quant=False):
    got, want = _f32(got), _f32(want)
    if leg == "f32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL["rtol"], atol=F32_QUANT_ATOL if quant else F32_TOL["atol"])
    else:
        np.testing.assert_allclose(got, want, **BF16_TOL)
        assert np.abs(got - want).mean() <= BF16_MEAN


def _batches(arch, ref_arch, tokens, seed=2):
    """The same batch for both packages, with M-RoPE positions and frontend
    embeddings where the arch takes them (as the launchers build them)."""
    b, s = tokens.shape
    ref_batch, batch = {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}
    if arch.mrope:
        ref_batch["positions"] = ref_transformer.default_positions(ref_arch, b, s)
        batch["positions"] = transformer.default_positions(arch, b, s, "cpu")
    if arch.frontend_stub_len:
        fe = np.random.default_rng(seed).normal(0, 0.02, (b, arch.frontend_stub_len, arch.d_model))
        ref_batch["frontend_embeds"] = jnp.asarray(fe, jnp.float32).astype(jnp.bfloat16)
        batch["frontend_embeds"] = torch.from_numpy(fe.astype(np.float32)).to(torch.bfloat16)
    return ref_batch, batch


# ----------------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_mrope_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 11, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 11)).astype(np.int32)
    pos3 = rng.integers(0, 5000, (3, 2, 11)).astype(np.int32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    # float32: sin/cos of large angles differ in the last places (ATen vs XLA);
    # bf16: the output rounds to bf16, one place is 2^-8 relative
    tol = dict(rtol=1e-5, atol=2e-4) if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(_f32(common.apply_rope(tx, torch.from_numpy(pos), 10_000.0)),
                               _f32(ref_common.apply_rope(jx, jnp.asarray(pos), 10_000.0)), **tol)
    np.testing.assert_allclose(_f32(common.apply_mrope(tx, torch.from_numpy(pos3), 1e6)),
                               _f32(ref_common.apply_mrope(jx, jnp.asarray(pos3), 1e6)), **tol)
    np.testing.assert_array_equal(common.rope_frequencies(32, 10_000.0, "cpu").numpy(),
                                  np.asarray(ref_common.rope_frequencies(32, 10_000.0)))
    # the half-split pairing: position 0 is the identity, and M-RoPE with one
    # position stream for all three sections is RoPE
    assert torch.equal(common.apply_rope(tx, torch.zeros(2, 11, dtype=torch.int32), 1e4), tx)
    same = torch.from_numpy(pos).expand(3, 2, 11)
    torch.testing.assert_close(common.apply_mrope(tx, same, 1e4), common.apply_rope(tx, torch.from_numpy(pos), 1e4))


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_flash_attention_matches_reference(window, dtype):
    rng = np.random.default_rng(3)
    q = rng.normal(0, 1, (2, 24, 8, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 24, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    want = ref_attention.flash_attention(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                                         jnp.asarray(pos), jnp.asarray(pos), window=window, kv_block=8)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    tp = torch.from_numpy(pos)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -6)
    for kv_block in (8, 24):  # three blocks, one block
        got = attention.flash_attention(tq, tk, tv, tp, tp, window=window, kv_block=kv_block)
        assert got.dtype == tq.dtype
        np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    with pytest.raises(ValueError, match="must divide kv_block"):
        attention.flash_attention(tq, tk, tv, tp, tp, kv_block=10)


@pytest.mark.parametrize("leg_dtype", ["f32", "bf16"], indirect=True)
@pytest.mark.parametrize("name", ["tinyllama", "qwen2-vl", "qwen3", "swa"])
def test_self_attention_matches_reference_and_the_naive_oracle(models, name, leg_dtype):
    params, model = models[name]
    ref_arch, arch = _archs(name)
    x = np.random.default_rng(4).normal(0, 1, (B, S, arch.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(ref_common.ACT_DTYPE), torch.from_numpy(x).to(common.ACT_DTYPE)
    jpos = ref_transformer.default_positions(ref_arch, B, S)
    tpos = transformer.default_positions(arch, B, S, "cpu")
    window = transformer._sublayer_window("attn", arch)
    ref_mixer = jax.tree_util.tree_map(lambda a: a[0], params["stage0"]["sub0"]["mixer"])
    mixer = model.layers[0].mixer
    want = ref_attention.self_attention(ref_mixer, jx, jpos, ref_arch, window=window, kv_block=8)
    got = attention.self_attention(mixer, tx, tpos, arch, window=window, kv_block=8)
    _close(got, want, leg_dtype)
    naive = attention.reference_attention(mixer, tx, tpos, arch, window=window)
    _close(got, naive, leg_dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kvquant_is_bit_identical_to_reference(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (3, 17, 2, 32)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: the 1e-8 floor of the scale
    x[0, 1, :, :4] = [127.0, 0.5, -0.5, 1.5]  # ties at .5 after the scale (round half to even)
    x[0, 2] = 1e-30
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = ref_kvquant.quantize_kv(jx)
    got_q, got_s = kvquant.quantize_kv(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.view(torch.int16).numpy(), np.asarray(want_s).view(np.int16))
    for out in (torch.float32, torch.bfloat16):
        want = ref_kvquant.dequantize_kv(want_q, want_s, jnp.float32 if out == torch.float32 else jnp.bfloat16)
        np.testing.assert_array_equal(_f32(kvquant.dequantize_kv(got_q, got_s, out)), _f32(want))


# ----------------------------------------------------------------------------
# serving: prefill, decode, caches
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("leg_dtype", ["f32", "bf16"], indirect=True)
@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_then_teacher_forced_decode_matches_reference(models, name, leg_dtype):
    params, model = models[name]
    ref_arch, arch = _archs(name)
    if leg_dtype == "f32":  # the jitted reference step must not reuse its bf16 trace
        ref_arch = dataclasses.replace(ref_arch, name=ref_arch.name + "-f32")
    toks = np.random.default_rng(1).integers(0, arch.vocab_size, (B, S + T)).astype(np.int32)
    ref_batch, batch = _batches(arch, ref_arch, toks[:, :S])
    want_logits, want_cache = ref_engine.prefill(params, ref_batch, ref_arch, S + T)
    got_logits, got_cache = engine.prefill(model, batch, arch, S + T)
    assert tuple(got_logits.shape) == want_logits.shape
    _close(got_logits, want_logits, leg_dtype)
    w = engine.cache_width(arch, "attn", S + T)
    np.testing.assert_array_equal(got_cache[f"kv_pos_{w}"].numpy(), np.asarray(want_cache[f"kv_pos_{w}"]))
    for t in range(T):
        want_step, want_cache = _ref_step(params, want_cache, jnp.asarray(toks[:, S + t]), jnp.asarray(S + t),
                                          arch=ref_arch)
        got_step, got_cache = engine.decode_step(model, got_cache, torch.from_numpy(toks[:, S + t]), S + t, arch)
        assert got_step.dtype == torch.float32
        _close(got_step, want_step, leg_dtype, quant=arch.kv_quant)
    np.testing.assert_array_equal(got_cache[f"kv_pos_{w}"].numpy(), np.asarray(want_cache[f"kv_pos_{w}"]))
    for si, stage in enumerate(want_cache["stages"]):
        for sub, entry in stage.items():
            for key, want in entry.items():
                got = got_cache["stages"][si][sub][key]
                assert tuple(got.shape) == want.shape, key
                if got.dtype == torch.int8:
                    # float32 K/V differ in the last places: an int8 step at a
                    # rounding tie; bf16 K/V by up to one bf16 place (2^-8 of
                    # the value), which moves a value near its row's max by up to
                    # 127 / 256 steps and the row's scale as well
                    limit = 1 if leg_dtype == "f32" else 2
                    assert np.abs(got.numpy().astype(int) - np.asarray(want).astype(int)).max() <= limit
                else:
                    _close(got, want, leg_dtype, quant=arch.kv_quant)


@pytest.mark.parametrize("name", ["tinyllama", "smollm", "qwen2-vl"])
def test_greedy_decode_loop_matches_reference_in_float32(models, name, monkeypatch):
    monkeypatch.setattr(ref_common, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    params, model = models[name]
    ref_arch, arch = _archs(name)
    ref_arch = dataclasses.replace(ref_arch, name=ref_arch.name + "-f32-loop")  # decode_loop is jitted on arch
    toks = np.random.default_rng(6).integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    ref_batch, batch = _batches(arch, ref_arch, toks)
    want_logits, want_cache = ref_engine.prefill(params, ref_batch, ref_arch, S + 8)
    got_logits, got_cache = engine.prefill(model, batch, arch, S + 8)
    first = np.asarray(jnp.argmax(want_logits[:, -1], axis=-1)).astype(np.int32)
    assert np.array_equal(got_logits[:, -1].argmax(-1).numpy(), first)
    want, _ = ref_engine.decode_loop(params, want_cache, jnp.asarray(first), jnp.asarray(S, jnp.int32), ref_arch,
                                     steps=6)
    got, _ = engine.decode_loop(model, got_cache, torch.from_numpy(first), S, arch, steps=6)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["tinyllama", "swa", "kvquant", "qwen2-vl"])
def test_prefill_then_decode_matches_forward(models, name, monkeypatch):
    # the reference's own invariant (tests/test_serve.py): prefill S, then
    # decode T teacher-forced steps, against forward of S + T, in float32;
    # "swa" wraps the 16-slot ring twice, "kvquant" reads int8 keys
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    _, model = models[name]
    _, arch = _archs(name)
    toks = np.random.default_rng(7).integers(0, arch.vocab_size, (B, S + T)).astype(np.int32)
    with torch.inference_mode():
        full, _, _ = transformer.forward(model, {"tokens": torch.from_numpy(toks)}, arch)
    pre, cache = engine.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])}, arch, S + T)
    tol = dict(rtol=0, atol=0.05 if arch.kv_quant else 1e-4)
    np.testing.assert_allclose(_f32(pre), _f32(full[:, :S]), **tol)
    for t in range(T):
        step, cache = engine.decode_step(model, cache, torch.from_numpy(toks[:, S + t]), S + t, arch)
        np.testing.assert_allclose(_f32(step), _f32(full[:, S + t]), **tol)


@pytest.mark.parametrize("name", ["tinyllama", "swa", "kvquant"])
def test_init_cache_matches_reference_layout(name):
    ref_arch, arch = _archs(name)
    want = ref_engine.init_cache(ref_arch, 3, 40)
    got = engine.init_cache(arch, 3, 40, "cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(got[f"kv_pos_{engine.cache_width(arch, 'attn', 40)}"].numpy(),
                                  np.asarray(want[f"kv_pos_{engine.cache_width(arch, 'attn', 40)}"]))
    dtypes = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.int8): torch.int8}
    for g, w in zip(got["stages"], want["stages"]):
        for sub, entry in w.items():
            assert set(g[sub]) == set(entry)
            for key, arr in entry.items():
                assert tuple(g[sub][key].shape) == arr.shape and not g[sub][key].any()
                assert g[sub][key].dtype == dtypes[arr.dtype]


@pytest.mark.parametrize("name", ["tinyllama", "kvquant"])
def test_kv_cache_and_weights_cross_bit_for_bit(models, name):
    params, model = models[name]
    ref_arch, arch = _archs(name)
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = interop.model_to_reference(model, arch)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got, want)
    toks = np.random.default_rng(8).integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    _, cache = ref_engine.prefill(params, {"tokens": jnp.asarray(toks)}, ref_arch, S + 4)

    def as_numpy(x, bits):
        x = np.asarray(x)
        return x.view(np.uint16) if bits and x.dtype == jnp.bfloat16 else (
            x.astype(np.float32) if x.dtype == jnp.bfloat16 else x)

    for bits in (False, True):
        crossing = jax.tree_util.tree_map(lambda x: as_numpy(x, bits), cache)
        port = interop.cache_from_reference(crossing, arch, "cpu")
        assert port["stages"][0]["sub0"]["k"].dtype == (torch.int8 if arch.kv_quant else torch.bfloat16)
        # the crossed cache decodes as the port's own prefill's does
        _, own = engine.prefill(model, {"tokens": torch.from_numpy(toks)}, arch, S + 4)
        back = interop.cache_to_reference(port)
        for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(cache)):
            np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32) if want.dtype == jnp.bfloat16
                                                          else want))
        a, _ = engine.decode_step(model, port, torch.from_numpy(toks[:, -1]), S, arch)
        b, _ = engine.decode_step(model, own, torch.from_numpy(toks[:, -1]), S, arch)
        np.testing.assert_allclose(_f32(a), _f32(b), **BF16_TOL)


@pytest.mark.parametrize("arch_id", ref_configs.ARCH_IDS)
def test_param_counts_match_reference(arch_id):
    # every family, full and reduced, all parameters and the active ones
    arch, ref_arch = configs.get_arch(arch_id), ref_configs.get_arch(arch_id)
    for mine, theirs in ((arch, ref_arch), (arch.reduced(), ref_arch.reduced())):
        for active in (False, True):
            assert registry.param_count(mine, active) == ref_registry.param_count(theirs, active)
        assert registry.non_embedding_params(mine) == ref_registry.non_embedding_params(theirs)
        assert registry.model_flops_per_token(mine, "decode") == ref_registry.model_flops_per_token(theirs, "decode")
    full = {"tinyllama-1.1b": 1_100_048_384,  # 22 layers, d 2048, GQA 32/4, d_ff 5632, vocab 32000
            "olmoe-1b-7b": 6_919_096_320, "mixtral-8x7b": 46_702_792_704, "recurrentgemma-9b": 9_396_195_328}
    if arch_id in full:
        assert arch.param_count() == full[arch_id]


# ----------------------------------------------------------------------------
# continuous batching
# ----------------------------------------------------------------------------


def _solo_greedy(model, arch, prompt, max_new, kv_len=64):
    logits, cache = engine.prefill(model, {"tokens": torch.from_numpy(prompt[None])}, arch, kv_len)
    tok = int(logits[0, -1].argmax())
    out, pos = [tok], len(prompt)
    for _ in range(max_new - 1):
        step, cache = engine.decode_step(model, cache, torch.tensor([tok], dtype=torch.int32), pos, arch)
        tok = int(step[0].argmax())
        out.append(tok)
        pos += 1
    return out


@pytest.mark.parametrize("leg_dtype", ["f32", "bf16"], indirect=True)
def test_continuous_batcher_gives_the_reference_tokens_and_the_solo_tokens(models, leg_dtype):
    # 6 requests of mixed lengths over 4 slots: two wait for a recycled slot.
    # The reference's tokens in float32; in bf16 XLA's excess precision can
    # flip a greedy near-tie against the port (ROADMAP C), so that leg holds
    # the port's mixed batches to the port's solo decodes alone.
    params, model = models["tinyllama"]
    ref_arch, arch = _archs("tinyllama")
    ref_arch = dataclasses.replace(ref_arch, name=f"{ref_arch.name}-batcher-{leg_dtype}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab_size, n, dtype=np.int32) for n in (12, 23, 5, 30, 17, 9)]
    max_new = [6, 4, 7, 3, 5, 6]

    def requests(cls):
        return [cls(uid=i, prompt=p, max_new=n) for i, (p, n) in enumerate(zip(prompts, max_new))]

    batcher = scheduler.ContinuousBatcher(model, arch, n_slots=4, kv_len=64)
    reqs = requests(scheduler.Request)
    for r in reqs:
        batcher.submit(r)
    got = batcher.run()
    assert all(r.done for r in reqs) and [len(got[i]) for i in range(6)] == max_new
    if leg_dtype == "f32":
        ref = ref_scheduler.ContinuousBatcher(params, ref_arch, n_slots=4, kv_len=64)
        for r in requests(ref_scheduler.Request):
            ref.submit(r)
        assert got == ref.run()
    for i, p in enumerate(prompts):
        assert got[i] == _solo_greedy(model, arch, p, max_new[i]), i


def test_recycled_slot_is_clean_and_slots_recycle(models):
    _, model = models["swa"]
    _, arch = _archs("swa")
    rng = np.random.default_rng(2)
    p = rng.integers(0, arch.vocab_size, 20, dtype=np.int32)  # longer than the 16-slot window
    batcher = scheduler.ContinuousBatcher(model, arch, n_slots=1, kv_len=32)
    batcher.submit(scheduler.Request(uid=0, prompt=p, max_new=4))
    batcher.submit(scheduler.Request(uid=1, prompt=rng.integers(0, arch.vocab_size, 15, dtype=np.int32), max_new=4))
    batcher.submit(scheduler.Request(uid=2, prompt=p, max_new=4))
    out = batcher.run()
    assert set(out) == {0, 1, 2} and all(len(v) == 4 for v in out.values())
    assert out[0] == out[2] == _solo_greedy(model, arch, p, 4, kv_len=32)
    cache = scheduler.slotted_cache(arch, 3, 32, "cpu")
    assert tuple(cache["kv_pos_16"].shape) == (3, 16) and bool((cache["kv_pos_16"] == -1).all())


# ----------------------------------------------------------------------------
# the card (the attention phase's checks of chip_smoke.py, at a small size)
# ----------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tinyllama", "swa", "kvquant", "qwen2-vl"])
def test_prefill_then_decode_matches_forward_on_card(models, name, monkeypatch):
    dev = _card()
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    _, arch = _archs(name)
    model = transformer.init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.randint(0, arch.vocab_size, (B, S + T), generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev, dtype=torch.int32)
    with torch.inference_mode():
        full, _, _ = transformer.forward(model, {"tokens": toks}, arch)
    pre, cache = engine.prefill(model, {"tokens": toks[:, :S]}, arch, S + T)
    atol = 0.05 if arch.kv_quant else 1e-3
    torch.testing.assert_close(pre, full[:, :S], rtol=0, atol=atol)
    for t in range(T):
        step, cache = engine.decode_step(model, cache, toks[:, S + t], S + t, arch)
        torch.testing.assert_close(step, full[:, S + t], rtol=0, atol=atol)


@pytest.mark.gpu
def test_kvquant_on_card_matches_the_cpu_bit_for_bit():
    dev = _card()
    x = torch.from_numpy(np.random.default_rng(9).normal(0, 2, (64, 8, 64)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        want_q, want_s = kvquant.quantize_kv(x.to(dtype))
        got_q, got_s = kvquant.quantize_kv(x.to(dtype).to(dev))
        assert torch.equal(got_q.cpu(), want_q) and torch.equal(got_s.cpu().view(torch.int16), want_s.view(torch.int16))


@pytest.mark.gpu
def test_continuous_batcher_mixed_matches_solo_on_card(monkeypatch):
    # float32: cuBLAS may pick other GEMMs for other batch sizes, so the
    # invariant holds on tokens with float32 margins, not bit for bit
    dev = _card()
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    _, arch = _archs("tinyllama")
    model = transformer.init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab_size, n, dtype=np.int32) for n in (12, 23, 5, 30)]
    batcher = scheduler.ContinuousBatcher(model, arch, n_slots=3, kv_len=64)
    for i, p in enumerate(prompts):
        batcher.submit(scheduler.Request(uid=i, prompt=p, max_new=5))
    out = batcher.run()
    for i, p in enumerate(prompts):
        logits, cache = engine.prefill(model, {"tokens": torch.from_numpy(p[None]).to(dev)}, arch, 64)
        assert out[i][0] == int(logits[0, -1].argmax())
        tok, pos = out[i][0], len(p)
        for want in out[i][1:]:
            step, cache = engine.decode_step(model, cache, torch.tensor([tok], dtype=torch.int32, device=dev), pos,
                                             arch)
            assert int(step[0].argmax()) == want
            tok, pos = want, pos + 1


@pytest.mark.gpu
def test_launcher_default_arch_local_and_sharded_on_card(capsys):
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import serve
    from repro_torch.serve.coalesce import SharedWindowRing

    _card()
    argv = ["--requests", "3", "--prompt-len", "64", "--gen-len", "4"]  # the default --arch tinyllama-1.1b
    printed = {}
    for placement in ("local", "sharded"):
        SharedWindowRing.reset()
        reset_launches()
        serve.main(argv + ["--placement", placement])
        launches = launch_counts()
        assert all(launches[name] > 0 for name in ("hash_rank", "bank_scatter_max", "sparse_scatter_coo",
                                                   "cm_scatter_add", "window_fold_max", "window_merge_max"))
        printed[placement] = capsys.readouterr().out.splitlines()
    assert printed["local"][0].startswith("tinyllama-1.1b: prefill")
    assert printed["local"][1:] == printed["sharded"][1:]
