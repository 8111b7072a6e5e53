"""Port vs reference: MoE and RG-LRU hybrid serving (ROADMAP A.12.1's last
families): reduced olmoe-1b-7b, mixtral-8x7b and recurrentgemma-9b.

The reference's reduced configs (d 128, vocab 512; MoE: 2 layers of 8
experts of 64, top-2, mixtral's sliding window 64; recurrentgemma: 4 layers
as (rec, rec, attn) + a trailing (rec,) stage, local window 64, tied
embeddings) are initialised with ``jax.random`` and carried to the port with
``repro_torch.interop``; inputs are seeded numpy arrays handed to both
packages.  Prompts of S = 60 tokens and T = 8 decode steps: the 64-slot
rings wrap.  Two legs, as in tests/test_torch_attention.py:

* float32: ``ACT_DTYPE`` set to float32 in both packages; logits within
  ``F32_TOL`` (measured at most 4.8e-6), the MoE aux loss within 1e-6
  relative, greedy tokens equal;
* bf16, as shipped: every logit within ``BF16_TOL`` and the mean within
  ``BF16_MEAN`` for the hybrid (measured at most 0.02 and 0.003).  For
  MoE, XLA's excess bf16 precision upstream of the router (ROADMAP C) can
  move a bf16 router logit across a tie or a rounding step and so flip one
  of a token's expert choices, which moves that position's logits by O(1)
  (measured up to 2.4) and, through attention, the later positions'.  Both
  packages' routings are logged (the reference's through a debug callback)
  and held with the card's rule (``chip_smoke._family_leg``): every
  position of a sequence before its first routing flip within
  ``BF16_TOL``, with the cache entries of those positions; the flip a
  near-tie (the experts it swaps no further apart in the reference's
  router logits than twice the largest change of that token's logits);
  and over all positions the mean within ``BF16_MEAN`` (measured at most
  0.019) and at most ``BF16_FLIP_SHARE`` of them past ``BF16_TOL``
  (measured at most 0.11).  The float32 leg holds the routing itself bit
  for bit (tests/test_torch_moe.py).

Covered (the parameter counts of all ten archs are in
tests/test_torch_attention.py): ``forward``, prefill +
teacher-forced decode (logits and every cache entry, the RG-LRU's ``conv``
and ``h`` included), greedy ``decode_loop``, prefill + decode against
``forward``, the cache layouts, weights and caches crossing bit for bit,
the ``ContinuousBatcher`` (the reference's tokens in float32; every request
its solo tokens in both legs), the serve launcher's printed lines against
the reference launcher's, and ``gpu`` tests of the card's family phase's
checks at full width over 2-3 layers.
"""

import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.serve import engine as ref_engine
from repro.serve import scheduler as ref_scheduler
from repro.serve.coalesce import SharedWindowRing as RefSharedRing
from repro_torch import configs, interop
from repro_torch.launch import serve
from repro_torch.models import common, moe, rglru, transformer
from repro_torch.serve import engine, scheduler
from repro_torch.serve.coalesce import SharedWindowRing

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import _tie_gap  # noqa: E402  (the card's near-tie rule)

B, S, T = 2, 60, 8
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 0.15
BF16_MEAN = 0.03
BF16_FLIP_SHARE = 0.25
ARCHS = {"olmoe": "olmoe-1b-7b", "mixtral": "mixtral-8x7b", "recurrentgemma": "recurrentgemma-9b"}
_ref_step = jax.jit(ref_engine.decode_step, static_argnames=("arch",))


def _archs(name, suffix=""):
    ref_arch = ref_configs.get_arch(ARCHS[name]).reduced()
    if suffix:  # the jitted reference caches on arch: another leg needs another name
        ref_arch = dataclasses.replace(ref_arch, name=ref_arch.name + suffix)
    return ref_arch, configs.get_arch(ARCHS[name]).reduced()


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


def _close(got, want, leg, arch) -> np.ndarray:
    """Asserts the leg's tolerance; for a bf16 MoE leg asserts the mean and
    returns each position's largest logit error (B, positions), which
    ``_hold_routed`` holds."""
    got, want = _f32(got), _f32(want)
    if leg == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
        return None
    err = np.abs(got - want)
    assert err.mean() <= BF16_MEAN, err.mean()
    if arch.moe is None:
        assert err.max() <= BF16_TOL, err.max()
        return None
    # a flipped expert choice moves its position's logits, and the later ones'
    return err.reshape(err.shape[0], -1, err.shape[-1]).max(-1)


@contextlib.contextmanager
def _port_routes():
    """Every ``moe.route`` call of the port inside the block, in call order:
    (router logits (G, Tg, E), expert_idx (G, Tg, k)) as numpy."""
    calls, original = [], moe.route

    def spy(params, xt, arch, cap):
        r = original(params, xt, arch, cap)
        calls.append((_f32(xt @ params["router"].to(xt.dtype)), r.expert_idx.numpy()))
        return r

    moe.route = spy
    try:
        yield calls
    finally:
        moe.route = original


@pytest.fixture
def ref_routes(monkeypatch):
    """Every reference ``moe_mixer`` call traced after the fixture, in call
    order, as ``_port_routes`` logs the port's.  A jitted reference function
    records only if it is traced anew (a renamed arch)."""
    calls, original = [], ref_transformer.moe_lib.moe_mixer

    def spy(params, x, arch):
        out = original(params, x, arch)
        b, s, d = x.shape
        xt = x.reshape(b * s // min(s, 4096), min(s, 4096), d)
        logits = (xt @ params["router"].astype(x.dtype)).astype(jnp.float32)  # as the reference computes them
        jax.debug.callback(lambda lg, idx: calls.append((np.asarray(lg), np.asarray(idx))), logits, out[2],
                           ordered=True)
        return out

    monkeypatch.setattr(ref_transformer.moe_lib, "moe_mixer", spy)
    return calls


def _hold_routed(errs, got_calls, want_calls, arch) -> np.ndarray:
    """The card's bf16 MoE rule on per-position errors ``errs`` (B, P) of
    runs whose route calls are logged: each run (a prefill, a decode step)
    routes once per layer, in layer order.  Returns which positions come
    before their sequence's first flip (B, P); those are held to BF16_TOL."""
    layers, b = arch.n_layers, errs.shape[0]
    assert len(got_calls) == len(want_calls) and len(got_calls) % layers == 0

    def per_position(calls, i):  # (layers, B, P, width)
        return np.stack([np.concatenate([c[i].reshape(b, -1, c[i].shape[-1]) for c in calls[layer::layers]], 1)
                         for layer in range(layers)])

    got, want = per_position(got_calls, 1), per_position(want_calls, 1)
    got_logits, want_logits = per_position(got_calls, 0), per_position(want_calls, 0)
    assert got.shape[2] == errs.shape[1]
    differs = (got != want).any(-1)  # (layers, B, P)
    held = np.cumprod(~differs.any(0), axis=1).astype(bool)
    for seq in range(b):
        flipped = np.flatnonzero(differs[:, seq].any(0))
        if flipped.size:
            pos = int(flipped[0])
            layer = int(np.flatnonzero(differs[:, seq, pos])[0])
            gap = _tie_gap(torch.from_numpy(want_logits[layer, seq, pos]), torch.from_numpy(got[layer, seq, pos]))
            change = float(np.abs(got_logits[layer, seq, pos] - want_logits[layer, seq, pos]).max())
            assert gap <= 2 * change, (seq, pos, layer, gap, change)
    assert errs[held].max(initial=0.0) <= BF16_TOL, errs[held].max()
    assert (errs > BF16_TOL).mean() <= BF16_FLIP_SHARE
    return held


def _tokens(arch, seed, shape=(B, S + T)):
    return np.random.default_rng(seed).integers(0, arch.vocab_size, shape).astype(np.int32)


# ----------------------------------------------------------------------------
# structure and counts
# ----------------------------------------------------------------------------


def test_hybrid_layers_form_whole_patterns_and_a_trailing_stage():
    full = configs.get_arch("recurrentgemma-9b")
    pattern = ("rec", "rec", "attn")
    assert transformer.layer_stages(full) == [(pattern, 12), (("rec", "rec"), 1)]  # 38 = 12 x 3 + 2
    assert transformer.layer_stages(full.reduced()) == [(pattern, 1), (("rec",), 1)]  # 4 = 3 + 1
    for arch_id in ARCHS.values():
        arch = configs.get_arch(arch_id)
        assert transformer.layer_stages(arch) == ref_transformer.layer_stages(ref_configs.get_arch(arch_id))
        assert len(transformer.sublayers(arch)) == arch.n_layers


@pytest.mark.parametrize("name", list(ARCHS))
def test_init_params_builds_the_reference_tree(models, name):
    ref_arch, arch = _archs(name)
    model = transformer.init_params(arch, torch.Generator().manual_seed(0), "cpu")
    mine = interop.model_to_reference(model, arch)
    tree = jax.tree_util.tree_map(np.asarray, models[name][0])
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    kinds = [kind for _, _, _, kind in transformer.sublayers(arch)]
    assert [block.kind for block in model.layers] == kinds
    for block in model.layers:
        assert isinstance(block.channel, moe.MoE) == (arch.moe is not None)
        assert isinstance(block.mixer, rglru.RGLRU) == (block.kind == "rec")
        if block.kind == "rec":
            assert torch.equal(block.mixer["lam"], rglru.lam_init(arch.d_model, "cpu"))


# ----------------------------------------------------------------------------
# forward, prefill, decode
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("leg_dtype", ["f32", "bf16"], indirect=True)
@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_matches_reference(models, name, leg_dtype, ref_routes):
    params, model = models[name]
    ref_arch, arch = _archs(name)
    toks = _tokens(arch, 1)
    want, want_aux, _ = ref_transformer.forward(params, {"tokens": jnp.asarray(toks)}, ref_arch)
    with torch.inference_mode(), _port_routes() as got_routes:
        got, aux, _ = transformer.forward(model, {"tokens": torch.from_numpy(toks)}, arch)
    assert tuple(got.shape) == want.shape and got.dtype == common.ACT_DTYPE
    errs = _close(got, want, leg_dtype, arch)
    if errs is not None:
        jax.effects_barrier()
        _hold_routed(errs, got_routes, ref_routes, arch)
    assert aux.dtype == torch.float32
    if arch.moe is None:
        assert float(aux) == float(want_aux) == 0.0
    elif leg_dtype == "f32":
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("leg_dtype", ["f32", "bf16"], indirect=True)
@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_then_teacher_forced_decode_matches_reference(models, name, leg_dtype, ref_routes):
    params, model = models[name]
    ref_arch, arch = _archs(name, "-" + leg_dtype)  # a fresh trace of the jitted step logs its routes
    toks = _tokens(arch, 2)
    want_logits, want_cache = ref_engine.prefill(params, {"tokens": jnp.asarray(toks[:, :S])}, ref_arch, S + T)
    with _port_routes() as got_routes:
        got_logits, got_cache = engine.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])}, arch, S + T)
        errs = [_close(got_logits, want_logits, leg_dtype, arch)]
        for t in range(T):
            want_step, want_cache = _ref_step(params, want_cache, jnp.asarray(toks[:, S + t]), jnp.asarray(S + t),
                                              arch=ref_arch)
            got_step, got_cache = engine.decode_step(model, got_cache, torch.from_numpy(toks[:, S + t]), S + t,
                                                     arch)
            assert got_step.dtype == torch.float32
            errs.append(_close(got_step[:, None], want_step[:, None], leg_dtype, arch))
    held = None  # (B, S + T): the positions whose cache entries are held in a bf16 MoE leg
    if errs[0] is not None:
        jax.effects_barrier()
        held = _hold_routed(np.concatenate(errs, axis=1), got_routes, ref_routes, arch)
    for key in got_cache:
        if key != "stages":
            np.testing.assert_array_equal(got_cache[key].numpy(), np.asarray(want_cache[key]))
    for si, stage in enumerate(want_cache["stages"]):
        for sub, entry in stage.items():
            for key, want in entry.items():
                got, want = _f32(got_cache["stages"][si][sub][key]), _f32(want)
                assert got.shape == want.shape, key
                if leg_dtype == "f32":
                    np.testing.assert_allclose(got, want, **F32_TOL)
                    continue
                if held is not None:  # (repeats, B, slots, ...): the slots holding held positions
                    slot_pos = np.asarray(want_cache[f"kv_pos_{got.shape[2]}"])
                    keep = (slot_pos >= 0) & held[:, np.maximum(slot_pos, 0)]  # (B, slots)
                    got, want = got[:, keep], want[:, keep]
                np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("name", list(ARCHS))
def test_greedy_decode_loop_matches_reference_in_float32(models, name, monkeypatch):
    monkeypatch.setattr(ref_common, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    params, model = models[name]
    ref_arch, arch = _archs(name, "-f32-loop")  # decode_loop is jitted on arch
    toks = _tokens(arch, 3, (B, S))
    want_logits, want_cache = ref_engine.prefill(params, {"tokens": jnp.asarray(toks)}, ref_arch, S + T + 1)
    got_logits, got_cache = engine.prefill(model, {"tokens": torch.from_numpy(toks)}, arch, S + T + 1)
    first = np.asarray(jnp.argmax(want_logits[:, -1], axis=-1)).astype(np.int32)
    assert np.array_equal(got_logits[:, -1].argmax(-1).numpy(), first)
    want, _ = ref_engine.decode_loop(params, want_cache, jnp.asarray(first), jnp.asarray(S, jnp.int32), ref_arch,
                                     steps=T)
    got, _ = engine.decode_loop(model, got_cache, torch.from_numpy(first), S, arch, steps=T)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_then_decode_matches_forward(models, name, monkeypatch):
    # the reference's own invariant (tests/test_serve.py) in float32: prefill
    # S, decode T teacher-forced steps, against forward of S + T (MoE groups
    # of S and of S + T tokens are both drop-free at this size)
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    _, model = models[name]
    _, arch = _archs(name)
    toks = torch.from_numpy(_tokens(arch, 4))
    with torch.inference_mode():
        full, _, _ = transformer.forward(model, {"tokens": toks}, arch)
    pre, cache = engine.prefill(model, {"tokens": toks[:, :S]}, arch, S + T)
    np.testing.assert_allclose(_f32(pre), _f32(full[:, :S]), rtol=0, atol=1e-4)
    for t in range(T):
        step, cache = engine.decode_step(model, cache, toks[:, S + t], S + t, arch)
        np.testing.assert_allclose(_f32(step), _f32(full[:, S + t]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(ARCHS))
def test_init_cache_matches_reference_layout(name):
    ref_arch, arch = _archs(name)
    want = ref_engine.init_cache(ref_arch, 3, S + T)
    got = engine.init_cache(arch, 3, S + T, "cpu")
    assert set(got) == set(want)
    dtypes = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}
    for key in got:
        if key != "stages":
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for g, w in zip(got["stages"], want["stages"]):
        assert set(g) == set(w)
        for sub, entry in w.items():
            assert set(g[sub]) == set(entry)
            for key, arr in entry.items():
                assert tuple(g[sub][key].shape) == arr.shape and not g[sub][key].any()
                assert g[sub][key].dtype == dtypes[arr.dtype]
    if name == "recurrentgemma":
        assert set(got["stages"][0]["sub0"]) == {"conv", "h"} and set(got["stages"][1]["sub0"]) == {"conv", "h"}


@pytest.mark.parametrize("name", list(ARCHS))
def test_weights_and_cache_cross_bit_for_bit(models, name):
    params, model = models[name]
    ref_arch, arch = _archs(name)
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = interop.model_to_reference(model, arch)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(got, want)
    toks = _tokens(arch, 5, (B, S))
    _, cache = ref_engine.prefill(params, {"tokens": jnp.asarray(toks)}, ref_arch, S + 4)

    def as_numpy(x, bits):
        x = np.asarray(x)
        if x.dtype == jnp.bfloat16:
            return x.view(np.uint16) if bits else x.astype(np.float32)
        return x

    _, own = engine.prefill(model, {"tokens": torch.from_numpy(toks)}, arch, S + 4)
    for bits in (False, True):
        port = interop.cache_from_reference(jax.tree_util.tree_map(lambda x: as_numpy(x, bits), cache), arch, "cpu")
        if name == "recurrentgemma":
            rec = port["stages"][0]["sub0"]
            assert rec["conv"].dtype == torch.bfloat16 and rec["h"].dtype == torch.float32
        back = interop.cache_to_reference(port)
        for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(cache)):
            np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32) if want.dtype == jnp.bfloat16
                                                          else want))
        # the crossed cache decodes as the port's own prefill's does
        with _port_routes() as crossed_routes:
            a, _ = engine.decode_step(model, port, torch.from_numpy(toks[:, -1]), S, arch)
        with _port_routes() as own_routes:
            b, _ = engine.decode_step(model, own, torch.from_numpy(toks[:, -1]), S, arch)
        errs = _close(a[:, None], b[:, None], "bf16", arch)
        if errs is not None:
            _hold_routed(errs, crossed_routes, own_routes, arch)
    bad = jax.tree_util.tree_map(lambda x: as_numpy(x, False), cache)
    if name == "recurrentgemma":
        bad["stages"][0]["sub0"]["h"] = bad["stages"][0]["sub0"]["h"][:, :, :3]
        with pytest.raises(ValueError, match="sub0/h"):
            interop.cache_from_reference(bad, arch, "cpu")


# ----------------------------------------------------------------------------
# continuous batching
# ----------------------------------------------------------------------------


def _solo_greedy(model, arch, prompt, max_new, kv_len):
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
@pytest.mark.parametrize("name", list(ARCHS))
def test_continuous_batcher_gives_the_reference_tokens_and_the_solo_tokens(models, name, leg_dtype):
    # 5 requests of mixed lengths over 3 slots: two wait for a recycled slot;
    # the 70-token prompt wraps the 64-slot ring.  The reference's tokens in
    # float32; in bf16 the port's mixed batches are held to its solo decodes.
    params, model = models[name]
    ref_arch, arch = _archs(name, f"-batcher-{leg_dtype}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab_size, n, dtype=np.int32) for n in (12, 70, 5, 30, 17)]
    max_new = [5, 4, 6, 3, 5]
    kv_len = 80

    def requests(cls):
        return [cls(uid=i, prompt=p, max_new=n) for i, (p, n) in enumerate(zip(prompts, max_new))]

    batcher = scheduler.ContinuousBatcher(model, arch, n_slots=3, kv_len=kv_len)
    reqs = requests(scheduler.Request)
    for r in reqs:
        batcher.submit(r)
    got = batcher.run()
    assert all(r.done for r in reqs) and [len(got[i]) for i in range(5)] == max_new
    if leg_dtype == "f32":
        ref = ref_scheduler.ContinuousBatcher(params, ref_arch, n_slots=3, kv_len=kv_len)
        for r in requests(ref_scheduler.Request):
            ref.submit(r)
        assert got == ref.run()
    for i, p in enumerate(prompts):
        assert got[i] == _solo_greedy(model, arch, p, max_new[i], kv_len), i


# ----------------------------------------------------------------------------
# the serve launcher
# ----------------------------------------------------------------------------


@pytest.fixture
def clean_launcher(monkeypatch):
    """No shared ring in either package around the run; the reference's
    windows need ``jax.core.trace_state_clean`` (ROADMAP C)."""
    monkeypatch.setattr(jax.core, "trace_state_clean", jax._src.core.trace_state_clean, raising=False)
    SharedWindowRing.reset()
    RefSharedRing.reset()
    yield
    SharedWindowRing.reset()
    RefSharedRing.reset()


@pytest.mark.parametrize("name", list(ARCHS))
def test_serve_launcher_prints_the_reference_lines(name, clean_launcher, monkeypatch):
    arch_id = ARCHS[name]
    argv = ["--arch", arch_id, "--requests", "4", "--prompt-len", "16", "--gen-len", "2", "--window-epochs", "4"]
    seen = {}
    ref_init, ref_loop = ref_serve.transformer.init_params, ref_serve.engine.decode_loop

    def spy_init(key, arch):
        seen["params"] = ref_init(key, arch)
        return seen["params"]

    def spy_loop(*args, **kwargs):
        out = ref_loop(*args, **kwargs)
        seen["tokens"] = np.asarray(out[0])
        return out

    monkeypatch.setattr(ref_serve.transformer, "init_params", spy_init)
    monkeypatch.setattr(ref_serve.engine, "decode_loop", spy_loop)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    theirs = io.StringIO()
    with contextlib.redirect_stdout(theirs):
        ref_serve.main()

    vocab = configs.get_arch(arch_id).reduced().vocab_size
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, vocab)).astype(np.int32)
    params = jax.tree_util.tree_map(np.asarray, seen["params"])
    monkeypatch.setattr(serve, "_model", lambda args, arch, device: interop.model_from_reference(params, arch,
                                                                                                  device))
    monkeypatch.setattr(serve, "_prompts", lambda args, arch, device: torch.from_numpy(prompts).to(device))
    port_loop = serve.engine.decode_loop
    decoded = {}

    def pinned_loop(*args, **kwargs):
        # the port's own decode runs; its tokens are pinned to the reference's
        decoded["tokens"] = port_loop(*args, **kwargs)[0].numpy()
        return torch.from_numpy(seen["tokens"].copy()), None

    monkeypatch.setattr(serve.engine, "decode_loop", pinned_loop)
    mine = io.StringIO()
    with contextlib.redirect_stdout(mine):
        serve.main(argv + ["--device", "cpu"])
    assert decoded["tokens"].shape == seen["tokens"].shape

    def without_wall_times(text):
        return [line for line in text.splitlines() if not line.startswith(f"{arch_id}: prefill ")]

    assert mine.getvalue().count(f"{arch_id}: prefill ") == 1
    assert without_wall_times(mine.getvalue()) == without_wall_times(theirs.getvalue())


# ----------------------------------------------------------------------------
# the card (the family phase's checks of chip_smoke.py, over few layers)
# ----------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id,layers", [("olmoe-1b-7b", 2), ("mixtral-8x7b", 2), ("recurrentgemma-9b", 3)])
def test_full_width_prefill_then_decode_matches_forward_on_card(arch_id, layers, monkeypatch):
    # full width, float32, TF32 off; 248 + 8 tokens keep the MoE groups
    # drop-free (tg <= 256) so that forward and prefill route alike
    dev = _card()
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    arch = dataclasses.replace(configs.get_arch(arch_id), n_layers=layers)
    model = transformer.init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
    s, t = 248, 8
    toks = torch.randint(0, arch.vocab_size, (2, s + t), generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev, dtype=torch.int32)
    with torch.inference_mode():
        full, _, _ = transformer.forward(model, {"tokens": toks}, arch)
    pre, cache = engine.prefill(model, {"tokens": toks[:, :s]}, arch, s + t)
    torch.testing.assert_close(pre, full[:, :s], rtol=0, atol=2e-3)
    for i in range(t):
        step, cache = engine.decode_step(model, cache, toks[:, s + i], s + i, arch)
        torch.testing.assert_close(step, full[:, s + i], rtol=0, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["olmoe", "recurrentgemma"])
def test_continuous_batcher_mixed_matches_solo_on_card(name, monkeypatch):
    dev = _card()
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    _, arch = _archs(name)
    model = transformer.init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, arch.vocab_size, n, dtype=np.int32) for n in (12, 70, 5, 30)]
    batcher = scheduler.ContinuousBatcher(model, arch, n_slots=3, kv_len=80)
    for i, p in enumerate(prompts):
        batcher.submit(scheduler.Request(uid=i, prompt=p, max_new=5))
    out = batcher.run()
    for i, p in enumerate(prompts):
        logits, cache = engine.prefill(model, {"tokens": torch.from_numpy(p[None]).to(dev)}, arch, 80)
        assert out[i][0] == int(logits[0, -1].argmax())
        tok, pos = out[i][0], len(p)
        for want in out[i][1:]:
            step, cache = engine.decode_step(model, cache, torch.tensor([tok], dtype=torch.int32, device=dev), pos,
                                             arch)
            assert int(step[0].argmax()) == want
            tok, pos = want, pos + 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", ["olmoe-1b-7b", "recurrentgemma-9b"])
def test_launcher_serves_the_family_on_card(arch_id, capsys):
    from repro_torch.kernels import launch_counts, reset_launches

    _card()
    SharedWindowRing.reset()
    reset_launches()
    serve.main(["--arch", arch_id, "--requests", "3", "--prompt-len", "64", "--gen-len", "4"])
    launches = launch_counts()
    assert all(launches[name] > 0 for name in ("hash_rank", "bank_scatter_max", "sparse_scatter_coo",
                                               "cm_scatter_add", "window_fold_max", "window_merge_max"))
    assert capsys.readouterr().out.startswith(f"{arch_id}: prefill")
    SharedWindowRing.reset()
