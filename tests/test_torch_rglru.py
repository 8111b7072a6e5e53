"""Port vs reference: the RG-LRU recurrent block (``repro_torch.models.rglru``).

The reference's reduced recurrentgemma-9b block parameters (d 128, conv
width 4) are drawn with ``jax.random`` and handed to the port as tensors;
inputs are seeded numpy arrays given to both packages.  Checked:

* ``rglru_scan`` bit for bit against ``jax.lax.associative_scan`` (the
  port follows its odd/even recursion: the same float32 operations in the
  same tree) at odd, even and power-of-two lengths, on random decays and on
  adversarial ones (a near 0, a near 1, a exactly 0 and 1), and within
  ``SCAN_RTOL`` of the largest |h| of a float64 sequential scan;
* ``_causal_conv`` bit for bit in float32 and bf16 (the reference's order of
  shifted products and adds, each rounded in the activation dtype);
* ``_gates``, ``block`` (with and without ``return_state``) and
  ``block_step`` within ``F32_TOL`` in float32 (products summed in another
  order; measured at most 3e-7) and ``BF16_TOL`` in bf16;
* ``block_step`` continued from ``block``'s state against the block over
  the whole sequence, in the port alone (float32);
* ``init_params``'s shapes and distributions, and ``lam``:
  ``jnp.linspace(2.0, 6.0, d)``'s values as its source defines them.  XLA
  compiles that definition with fused multiply-adds chosen shape by shape,
  so the reference's own bits are reproduced at d <= 3 and within 2 float32
  ulps at wider d (``lam_init``'s docstring);
* ``gpu`` tests: the 1024-token scan at recurrentgemma's full width on the
  card against the CPU's bits and a float64 sequential scan, ``lam``
  equal on the card and the CPU, and ``init_state`` on the card when no
  device is named (on the CPU that call raises: no fallback).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import rglru as ref_rglru
from repro_torch import configs
from repro_torch.models import rglru

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -6)
SCAN_RTOL = 4e-6  # of the largest |h|: the prefix tree rounds partial sums of that size (measured 5e-7)
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
ARCH = configs.get_arch("recurrentgemma-9b").reduced()
REF_ARCH = ref_configs.get_arch("recurrentgemma-9b").reduced()


@pytest.fixture(scope="module")
def params():
    """(the reference's block parameters, the same as port tensors)."""
    ref = ref_rglru.init_params(jax.random.PRNGKey(0), REF_ARCH)
    return ref, {name: torch.from_numpy(np.array(value)) for name, value in ref.items()}


def _x(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def _f32(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _close(got, want, leg):
    np.testing.assert_allclose(_f32(got), _f32(want), **(F32_TOL if leg == "f32" else BF16_TOL))


def assert_scan_close(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=SCAN_RTOL * max(1.0, float(np.abs(want).max())))


def sequential_scan(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """h_t = a_t h_{t-1} + b_t over axis 1, in float64."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    h = np.zeros_like(b)
    carry = np.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        carry = a[:, t] * carry + b[:, t]
        h[:, t] = carry
    return h


def _decays(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.uniform(0, 1, shape).astype(np.float32)
    if kind == "near 0":
        return (10.0 ** rng.uniform(-30, -3, shape)).astype(np.float32)
    if kind == "near 1":
        return (1 - 10.0 ** rng.uniform(-7, -3, shape)).astype(np.float32)
    a = rng.uniform(0, 1, shape).astype(np.float32)  # "0 and 1": exact resets and carries
    a[rng.random(shape) < 0.2] = 0.0
    a[rng.random(shape) < 0.2] = 1.0
    return a


@pytest.mark.parametrize("kind", ["random", "near 0", "near 1", "0 and 1"])
@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 333, 1024])
def test_rglru_scan_is_bit_identical_to_associative_scan(s, kind):
    a = _decays(kind, (2, s, 16), s)
    b = _x((2, s, 16), s + 1)
    got = rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(b))))
    assert_scan_close(got, sequential_scan(a, b))


@pytest.mark.parametrize("leg", list(DTYPES))
def test_causal_conv_is_bit_identical_to_reference(params, leg):
    ref, mine = params
    dt, jdt = DTYPES[leg]
    x = _x((2, 37, ARCH.d_model), 1)
    conv = dict(mine, conv_b=torch.from_numpy(_x((ARCH.d_model,), 2, 0.1)))  # a bias that is not zero
    ref_conv = dict(ref, conv_b=jnp.asarray(conv["conv_b"].numpy()))
    got = rglru._causal_conv(conv, torch.from_numpy(x).to(dt))
    assert got.dtype == dt
    np.testing.assert_array_equal(_f32(got), _f32(ref_rglru._causal_conv(ref_conv, jnp.asarray(x).astype(jdt))))


def test_gates_match_reference(params):
    ref, mine = params
    xc = _x((2, 9, ARCH.d_model), 3)
    for g, w in zip(rglru._gates(mine, torch.from_numpy(xc)), ref_rglru._gates(ref, jnp.asarray(xc))):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("leg", list(DTYPES))
@pytest.mark.parametrize("s", [3, 40, 257])
def test_block_matches_reference(params, s, leg):
    ref, mine = params
    dt, jdt = DTYPES[leg]
    x = _x((2, s, ARCH.d_model), s)
    got = rglru.block(mine, torch.from_numpy(x).to(dt), ARCH)
    want = ref_rglru.block(ref, jnp.asarray(x).astype(jdt), REF_ARCH)
    assert got.dtype == dt and tuple(got.shape) == want.shape
    _close(got, want, leg)
    got, state = rglru.block(mine, torch.from_numpy(x).to(dt), ARCH, return_state=True)
    want, ref_state = ref_rglru.block(ref, jnp.asarray(x).astype(jdt), REF_ARCH, return_state=True)
    _close(got, want, leg)
    assert state.conv.dtype == torch.bfloat16 and state.h.dtype == torch.float32
    assert tuple(state.conv.shape) == ref_state.conv.shape == (2, ARCH.conv_width - 1, ARCH.d_model)
    _close(state.conv, ref_state.conv, leg)
    _close(state.h, ref_state.h, leg)


@pytest.mark.parametrize("leg", list(DTYPES))
def test_block_step_matches_reference(params, leg):
    ref, mine = params
    dt, jdt = DTYPES[leg]
    x_t = _x((3, ARCH.d_model), 4)
    conv, h = _x((3, ARCH.conv_width - 1, ARCH.d_model), 5), _x((3, ARCH.d_model), 6, 0.5)
    state = rglru.RGLRUState(conv=torch.from_numpy(conv).to(dt), h=torch.from_numpy(h))
    ref_state = ref_rglru.RGLRUState(conv=jnp.asarray(conv).astype(jdt), h=jnp.asarray(h))
    got, new = rglru.block_step(mine, torch.from_numpy(x_t).to(dt), state, ARCH)
    want, ref_new = ref_rglru.block_step(ref, jnp.asarray(x_t).astype(jdt), ref_state, REF_ARCH)
    _close(got, want, leg)
    _close(new.conv, ref_new.conv, leg)
    _close(new.h, ref_new.h, leg)


def test_block_step_continues_the_prefill_state(params, monkeypatch):
    # block over S tokens == block over the first S - T, then T block_steps
    # from its returned state, in float32 (the state's conv window is kept in
    # the activation dtype; the window sums in another order)
    monkeypatch.setattr(rglru.common, "ACT_DTYPE", torch.float32)
    _, mine = params
    s, t = 30, 6
    x = torch.from_numpy(_x((2, s, ARCH.d_model), 7))
    full = rglru.block(mine, x, ARCH)
    _, state = rglru.block(mine, x[:, : s - t], ARCH, return_state=True)
    for i in range(s - t, s):
        out, state = rglru.block_step(mine, x[:, i], state, ARCH)
        np.testing.assert_allclose(out.numpy(), full[:, i].numpy(), **F32_TOL)


def test_init_state_matches_reference():
    want = ref_rglru.init_state(3, REF_ARCH)
    got = rglru.init_state(3, ARCH, "cpu")
    assert tuple(got.conv.shape) == want.conv.shape and got.conv.dtype == torch.bfloat16
    assert tuple(got.h.shape) == want.h.shape and got.h.dtype == torch.float32
    assert not got.conv.any() and not got.h.any()


def test_init_state_defaults_to_the_card():
    # no device named: the card, or an error where there is none (no CPU fallback)
    if torch.cuda.is_available():
        state = rglru.init_state(2, ARCH)
        assert state.conv.device.type == state.h.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rglru.init_state(2, ARCH)


def test_init_params_follows_the_reference_shapes_and_distributions():
    want = ref_rglru.init_params(jax.random.PRNGKey(0), REF_ARCH)
    got = rglru.init_params(ARCH, torch.Generator().manual_seed(0), "cpu")
    assert rglru.param_shapes(ARCH) == {name: tuple(v.shape) for name, v in want.items()}
    d, w = ARCH.d_model, ARCH.conv_width
    for name in ("w_x", "w_gate", "w_a", "w_i", "w_out"):
        assert abs(float(got[name].std()) - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(float(got["conv_w"].std()) - 1 / w) < 0.1 / w
    assert not got["conv_b"].any()
    assert all(t.dtype == torch.float32 for t in got.values())


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("d", [1, 2, 3, 128, 2048, 4096])
def test_lam_is_jnp_linspace_as_its_source_defines_it(d):
    got = rglru.lam_init(d, "cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (d,)
    # the definition, one float32 rounding per operation
    f32 = np.float32
    step = np.arange(d - 1, dtype=f32) / f32(max(d - 1, 1))
    want = np.append(f32(2.0) * (f32(1) - step) + f32(6.0) * step, f32(6.0)) if d > 1 else np.array([2.0], f32)
    np.testing.assert_array_equal(got, want)
    # the reference's compiled values: equal at d <= 3, within 2 ulps beyond
    ref = np.asarray(jnp.linspace(2.0, 6.0, d).astype(jnp.float32))
    assert _ulps(got, ref) <= (0 if d <= 3 else 2)
    assert got[0] == 2.0 and got[-1] == (6.0 if d > 1 else 2.0)
    if d == ARCH.d_model:
        np.testing.assert_array_equal(got, rglru.init_params(ARCH, torch.Generator(), "cpu")["lam"].numpy())


# ----------------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "near 0", "near 1", "0 and 1"])
def test_full_width_scan_on_card(kind):
    # recurrentgemma's d 4096 over a 1024-token prompt: elementwise float32
    # operations round alike on the card and the CPU
    dev = _card()
    d = configs.get_arch("recurrentgemma-9b").d_model
    a, b = _decays(kind, (2, 1024, d), 1), _x((2, 1024, d), 2)
    got = rglru.rglru_scan(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)).cpu()
    assert torch.equal(got, rglru.rglru_scan(torch.from_numpy(a), torch.from_numpy(b)))
    assert_scan_close(got.numpy()[:, :, :256], sequential_scan(a[:, :, :256], b[:, :, :256]))


@pytest.mark.gpu
def test_init_state_lands_on_the_card_by_default():
    _card()
    state = rglru.init_state(3, configs.get_arch("recurrentgemma-9b"))
    assert state.conv.device.type == state.h.device.type == "cuda"
    assert not state.conv.any() and not state.h.any()


@pytest.mark.gpu
def test_lam_on_card_equals_the_cpu():
    dev = _card()
    for d in (128, 4096):
        assert torch.equal(rglru.lam_init(d, dev).cpu(), rglru.lam_init(d, "cpu"))
