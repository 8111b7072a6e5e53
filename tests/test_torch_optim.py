"""Port vs reference: AdamW, its schedule, clipping and int8 error feedback.

The reference is jitted; XLA's CPU compiler contracts ``a * b + c`` into a
fused multiply-add, turns a division by a constant into a product with its
reciprocal, and rounds ``cos`` and ``pow`` otherwise than ATen (ROADMAP
C.4), so the port is held to stated bounds, not bit for bit:

* ``schedule``: within ``LR_ULPS`` float32 ulps (measured 8 at 3,858 of
  the 10,001 steps of the default schedule, 5.4e-7 relative);
* ``global_norm``: within 1e-6 relative; the int8 scale within 1 ulp (the
  reference divides by 127 as a product with its reciprocal), q equal but
  at a tie of ``round`` that the scale's last place moves; the compressed
  gradients and their residuals within 2 ulps of the gradients' scale.
  The scale is per tensor of the reference's tree, whose layer leaves are
  stacked over a stage: the port's layers share it (``STACKS``);
* ``update``, each package iterating its own state over 20 steps on the
  same gradients: every leaf of the parameters within ``P_ULPS`` ulps of
  the leaf's largest magnitude, ``mu`` and ``nu`` within ``MOMENT_ULPS``
  (measured 2, 6 and 11 over three seeds, with and without compression),
  at every step -- the bound does not grow.  Ulps of the leaf's scale, not
  of each element: an element near 0 is a difference of two terms whose
  own roundings set its error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro_torch.optim import adamw

LR_ULPS = 8
P_ULPS = 4
MOMENT_ULPS = 16
SHAPES = {"embed": (64, 16), "final_norm": (16,), "layers.0.mixer.wr": (16, 16), "layers.0.norm1": (16,),
          "layers.0.mixer.u": (16,), "layers.1.norm1": (16,)}
# the reference holds the two layers' norm1 as one stacked leaf, one int8 scale
STACKS = [["layers.0.mixer.wr"], ["layers.0.mixer.u"], ["layers.0.norm1", "layers.1.norm1"]]


def _ref_tree(flat):
    """The reference's tree of SHAPES' leaves: each layer's leaf stacked over
    the stage's two layers, as its transformer holds them."""
    return {"embed": flat["embed"], "final_norm": flat["final_norm"], "stage0": {"sub0": {
        "mixer": {"wr": flat["layers.0.mixer.wr"][None], "u": flat["layers.0.mixer.u"][None]},
        "norm1": np.stack([flat["layers.0.norm1"], flat["layers.1.norm1"]])}}}


def _from_ref(tree):
    sub = jax.tree_util.tree_map(np.asarray, tree["stage0"]["sub0"])
    return {"embed": np.asarray(tree["embed"]), "final_norm": np.asarray(tree["final_norm"]),
            "layers.0.mixer.wr": sub["mixer"]["wr"][0], "layers.0.norm1": sub["norm1"][0],
            "layers.0.mixer.u": sub["mixer"]["u"][0], "layers.1.norm1": sub["norm1"][1]}


def _ulps(got, want) -> np.ndarray:
    a = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _scaled_err(got, want) -> float:
    """max |got - want| in ulps of want's largest magnitude."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.spacing(np.float32(np.abs(want).max())))


def _grads(rng, step):
    return {k: rng.normal(0, 0.5 if step % 3 else 3.0, s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("cfg_kw", [dict(), dict(warmup_steps=1, total_steps=100, lr=3e-3)])
def test_schedule_within_stated_ulps_of_reference(cfg_kw):
    steps = np.arange(min(10_001, cfg_kw.get("total_steps", 10_000) + 2), dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: ref_adamw.schedule(ref_adamw.OptimizerConfig(**cfg_kw), s))(
        jnp.asarray(steps)))
    got = adamw.schedule(adamw.OptimizerConfig(**cfg_kw), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= LR_ULPS


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(3)
    flat = _grads(rng, 0)
    want_norm = ref_adamw.global_norm(_ref_tree(flat))
    tensors = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    np.testing.assert_allclose(float(adamw.global_norm(tensors)), float(want_norm), rtol=1e-6)
    for max_norm in (1.0, 1e6):  # clipped, and left as it is
        ref_clipped, ref_norm = ref_adamw.clip_by_global_norm(_ref_tree(flat), max_norm)
        clipped, norm = adamw.clip_by_global_norm({k: torch.from_numpy(v.copy()) for k, v in flat.items()}, max_norm)
        np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
        for k, v in _from_ref(ref_clipped).items():
            np.testing.assert_allclose(clipped[k].numpy(), v, rtol=2e-6, atol=0)


def test_int8_quantization_matches_reference():
    rng = np.random.default_rng(5)
    quantize = jax.jit(ref_adamw.quantize_int8)
    moved = 0
    for i in range(20):
        x = (rng.normal(size=(64, 33)) * rng.uniform(0.01, 10)).astype(np.float32)
        x[0, 0] = 0.0
        ref_q, ref_scale = quantize(jnp.asarray(x))
        q, scale = adamw.quantize_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8 and scale.shape == () and scale.dtype == torch.float32
        assert _ulps(scale.numpy(), np.asarray(ref_scale)) <= 1
        diff = np.abs(q.numpy().astype(np.int32) - np.asarray(ref_q).astype(np.int32))
        assert diff.max() <= 1
        moved += int(diff.sum())
        np.testing.assert_allclose(adamw.dequantize_int8(q, scale).numpy(),
                                   np.asarray(ref_adamw.dequantize_int8(ref_q, ref_scale)),
                                   rtol=2 ** -22, atol=float(scale) * int(diff.max()))
    assert moved <= 20 * 64 * 33 // 1000  # ties of round only


def test_error_feedback_carries_the_residual_like_the_reference():
    # each step takes the reference's residuals of the step before, so that
    # a step is compared on the same inputs (the carried comparison is the
    # 20-step update test below)
    rng = np.random.default_rng(11)
    ref_ef, ef = None, None
    compress = jax.jit(ref_adamw.compress_with_error_feedback)
    for step in range(5):
        flat = _grads(rng, step)
        ref_out, ref_next = compress(_ref_tree(flat), ref_ef)
        out, ef = adamw.compress_with_error_feedback({k: torch.from_numpy(v.copy()) for k, v in flat.items()}, ef,
                                                     STACKS)
        want_out, want_ef = _from_ref(ref_out), _from_ref(ref_next)
        for k in SHAPES:
            assert out[k].dtype == ef[k].dtype == torch.float32
            # a residual is in ulps of the gradients' scale: a last-place
            # change of the int8 scale moves the dequantized value by up to
            # 127 of the scale's ulps
            ulp = np.spacing(np.float32(np.abs(want_out[k]).max()))
            assert np.abs(out[k].numpy() - want_out[k]).max() <= 2 * ulp, (k, step)
            assert np.abs(ef[k].numpy() - want_ef[k]).max() <= 2 * ulp, (k, step)
        ref_ef = ref_next
        ef = {k: torch.from_numpy(np.array(v)) for k, v in _from_ref(ref_next).items()}


def test_init_state_and_the_decay_rule():
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    state = adamw.init_state(params)
    assert set(state) == {"mu", "nu", "count", "ef"} and state["ef"] is None
    assert state["count"].dtype == torch.int32 and state["count"].shape == ()
    assert all(state["mu"][k].shape == s and state["nu"][k].dtype == torch.float32 for k, s in SHAPES.items())
    # the reference decays leaves of ndim >= 2 and stacks each layer's leaf
    # over its stage: only final_norm goes without decay.  The rule reads
    # the stacks, not the names: a 1-d tensor listed in none goes without
    stacked = {name for names in STACKS for name in names}
    assert [k for k, p in params.items() if not adamw.decays(k, p, stacked)] == ["final_norm"]
    assert [k for k, p in params.items() if not adamw.decays(k, p, set())] == [
        "final_norm", "layers.0.norm1", "layers.0.mixer.u", "layers.1.norm1"]


@pytest.mark.parametrize("compress", [False, True])
def test_update_stays_within_bound_of_reference_over_20_steps(compress):
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(0, 0.1, s).astype(np.float32) for k, s in SHAPES.items()}
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=20, compress_grads=compress)
    ref_cfg, cfg = ref_adamw.OptimizerConfig(**kw), adamw.OptimizerConfig(**kw)
    ref_p = jax.tree_util.tree_map(jnp.asarray, _ref_tree(p0))
    ref_s = ref_adamw.init_state(ref_p)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = adamw.init_state(params)
    step = jax.jit(lambda p, g, s: ref_adamw.update(p, g, s, ref_cfg))
    worst = []
    for i in range(20):
        flat = _grads(rng, i)
        ref_p, ref_s, ref_m = step(ref_p, jax.tree_util.tree_map(jnp.asarray, _ref_tree(flat)), ref_s)
        got_p, state, m = adamw.update(params, {k: torch.from_numpy(v.copy()) for k, v in flat.items()}, state, cfg,
                                       STACKS)
        assert got_p is params and int(state["count"]) == int(ref_s["count"]) == i + 1
        assert (state["ef"] is not None) == compress
        assert _ulps(m["lr"].numpy(), np.asarray(ref_m["lr"])) <= LR_ULPS
        np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-6)
        want_p, want_mu, want_nu = _from_ref(ref_p), _from_ref(ref_s["mu"]), _from_ref(ref_s["nu"])
        errs = (max(_scaled_err(params[k].numpy(), want_p[k]) for k in SHAPES),
                max(_scaled_err(state["mu"][k].numpy(), want_mu[k]) for k in SHAPES),
                max(_scaled_err(state["nu"][k].numpy(), want_nu[k]) for k in SHAPES))
        worst.append(errs)
    assert max(e[0] for e in worst) <= P_ULPS, worst
    assert max(max(e[1], e[2]) for e in worst) <= MOMENT_ULPS, worst


# ----------------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------------


@pytest.mark.gpu
def test_update_on_card_within_bound_of_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(1)
    p0 = {k: rng.normal(0, 0.1, s).astype(np.float32) for k, s in SHAPES.items()}
    cfg = adamw.OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=20, compress_grads=True)
    cpu = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    card = {k: torch.from_numpy(v.copy()).cuda() for k, v in p0.items()}
    cpu_state, card_state = adamw.init_state(cpu), adamw.init_state(card)
    for i in range(20):
        flat = _grads(rng, i)
        _, cpu_state, m = adamw.update(cpu, {k: torch.from_numpy(v.copy()) for k, v in flat.items()}, cpu_state, cfg,
                                       STACKS)
        _, card_state, mc = adamw.update(card, {k: torch.from_numpy(v.copy()).cuda() for k, v in flat.items()},
                                         card_state, cfg, STACKS)
        assert card_state["count"].device.type == "cuda"
        assert _ulps(mc["lr"].cpu().numpy(), m["lr"].numpy()) <= LR_ULPS
        for k in SHAPES:
            assert _scaled_err(card[k].cpu().numpy(), cpu[k].numpy()) <= P_ULPS
            assert _scaled_err(card_state["mu"][k].cpu().numpy(), cpu_state["mu"][k].numpy()) <= MOMENT_ULPS
