"""Port vs reference: the MoE channel mixer (``repro_torch.models.moe``).

The reference's reduced olmoe-1b-7b and mixtral-8x7b MoE parameters (d 128,
8 experts of 64, top-2, capacity factor 2.0) are drawn with ``jax.random``
and handed to the port as tensors; inputs are seeded numpy arrays given to
both packages.  Checked:

* assignments (``expert_idx``) bit-identical to the reference's, in float32
  and in bf16 on the same bf16 inputs, and the drops: a (token, choice)
  past its expert's capacity adds nothing, so the outputs carry the drops,
  and the port's ``route`` positions and ``keep`` equal a numpy oracle of the
  reference's token-major queue rule;
* the outputs within ``F32_TOL`` in float32 (sums in another order;
  measured at most 1.2e-6) and ``BF16_TOL`` in bf16 (one bf16 place of the
  output, measured at most 0.0039), the aux loss within 1e-6 relative;
* the cases: a random router at S = 40 (one drop-free group) and S = 300
  (tg > 256: capacity 150; and 75 at capacity factor 1.0, where random
  loads overflow), decode's groups of one token, a zero
  router (every probability ties: the lower index must win), a router that
  sends every token to expert 0 (that queue overflows), and at tiny width a
  sequence of 8192 tokens (two groups of 4096 in one sequence);
* ``init_params``'s shapes and distributions;
* ``gpu`` tests: at olmoe's full width on the card, the same routers over
  1024-token groups (capacity 160), the assignments equal to a float64
  recomputation from the card's own router logits; and a witness for the
  serve launcher's olmoe drops: its layer 0 (the launcher's weights and
  prompts) run by the reference on the host and by the port on the card,
  with the router input, logits, assignments and drops compared, and the
  router input's cross-token cosine, which says why random weights drop
  so many choices.

``assignment_stream`` and the reference's two collapse tests are in
tests/test_torch_telemetry.py.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import common as ref_common
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro_torch import configs, interop
from repro_torch.launch import serve
from repro_torch.models import moe, transformer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import _tie_gap  # noqa: E402  (the card's near-tie rule)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -6)
AUX_RTOL = 1e-6
ARCH_IDS = ("olmoe-1b-7b", "mixtral-8x7b")
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _archs(arch_id, **moe_fields):
    ref_arch, arch = ref_configs.get_arch(arch_id).reduced(), configs.get_arch(arch_id).reduced()
    if moe_fields:
        ref_arch = dataclasses.replace(ref_arch, moe=dataclasses.replace(ref_arch.moe, **moe_fields))
        arch = dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, **moe_fields))
    return ref_arch, arch


def _params(ref_arch, seed=0):
    """(the reference's MoE parameters, the same as port tensors)."""
    params = ref_moe.init_params(jax.random.PRNGKey(seed), ref_arch)
    return params, {name: torch.from_numpy(np.array(value)) for name, value in params.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _oracle_routing(expert_idx: np.ndarray, tg: int, e: int, cap: int):
    """The reference's queue rule in numpy: (slot, keep) of (B, S, k)
    assignments grouped by ``tg`` tokens, token-major, choice-minor."""
    b, s, k = expert_idx.shape
    flat = expert_idx.reshape(-1, tg * k)
    slot = np.zeros_like(flat)
    for g, row in enumerate(flat):
        seen = np.zeros(e, np.int64)
        for i, ex in enumerate(row):
            slot[g, i] = seen[ex]
            seen[ex] += 1
    slot = slot.reshape(b, s, k)
    return slot, slot < cap


def _run_both(ref_arch, arch, params, tparams, x, leg):
    dt, jdt = DTYPES[leg]
    want = ref_moe.moe_mixer(params, jnp.asarray(x).astype(jdt), ref_arch)
    got = moe.moe_mixer(tparams, torch.from_numpy(x).to(dt), arch)
    return got, want


def _check(got, want, leg):
    (out, aux, idx), (w_out, w_aux, w_idx) = got, want
    assert idx.dtype == torch.int32 and tuple(idx.shape) == w_idx.shape
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    assert out.dtype == DTYPES[leg][0]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(w_out.astype(jnp.float32)),
                               **(F32_TOL if leg == "f32" else BF16_TOL))
    np.testing.assert_allclose(float(aux), float(w_aux), rtol=AUX_RTOL)


def _check_drops(arch, x, tparams, leg):
    """The port's route: positions and keep equal to the oracle, and the
    tokens whose every choice was dropped get an output of exactly zero."""
    b, s, d = x.shape
    tg = moe.group_tokens(s)
    cap = moe.capacity(tg, arch.moe)
    xt = torch.from_numpy(x).to(DTYPES[leg][0]).reshape(b * s // tg, tg, d)
    r = moe.route(tparams, xt, arch, cap)
    k = arch.moe.top_k
    slot, keep = _oracle_routing(r.expert_idx.reshape(b, s, k).numpy(), tg, arch.moe.num_experts, cap)
    np.testing.assert_array_equal(r.slot.reshape(b, s, k).numpy(), slot)
    np.testing.assert_array_equal(r.keep.reshape(b, s, k).numpy(), keep)
    out, _, _ = moe.moe_mixer(tparams, torch.from_numpy(x).to(DTYPES[leg][0]), arch)
    all_dropped = ~keep.any(-1)
    assert not out[torch.from_numpy(all_dropped)].any()
    return int((~keep).sum())


@pytest.mark.parametrize("leg", list(DTYPES))
@pytest.mark.parametrize("s,capacity_factor", [(40, None), (300, None), (300, 1.0)])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_moe_mixer_matches_reference(arch_id, s, capacity_factor, leg):
    # tg = 40 routes drop-free; at tg = 300 the reduced configs' capacity
    # (150) outlasts a random router's loads, capacity factor 1.0 (75) does not
    ref_arch, arch = _archs(arch_id, **({} if capacity_factor is None else {"capacity_factor": capacity_factor}))
    params, tparams = _params(ref_arch)
    x = _x((2, s, arch.d_model), s)
    _check(*_run_both(ref_arch, arch, params, tparams, x, leg), leg)
    dropped = _check_drops(arch, x, tparams, leg)
    assert (dropped > 0) == (capacity_factor is not None)


@pytest.mark.parametrize("leg", list(DTYPES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_decode_groups_of_one_token_match_reference(arch_id, leg):
    # decode: (B, 1, d), tg = 1, capacity top_k, drop-free
    ref_arch, arch = _archs(arch_id)
    params, tparams = _params(ref_arch, seed=1)
    assert moe.capacity(1, arch.moe) == arch.moe.top_k
    _check(*_run_both(ref_arch, arch, params, tparams, _x((5, 1, arch.d_model), 7), leg), leg)


@pytest.mark.parametrize("leg", list(DTYPES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_zero_router_ties_go_to_the_lower_expert(arch_id, leg):
    # every probability 1/E: jax.lax.top_k takes experts 0..k-1 in order, so
    # the port must too; at S = 300 their queues overflow (capacity 150)
    ref_arch, arch = _archs(arch_id)
    params, tparams = _params(ref_arch, seed=2)
    params = dict(params, router=jnp.zeros_like(params["router"]))
    tparams = dict(tparams, router=torch.zeros_like(tparams["router"]))
    x = _x((2, 300, arch.d_model), 3)
    got, want = _run_both(ref_arch, arch, params, tparams, x, leg)
    _check(got, want, leg)
    assert (got[2].numpy() == np.arange(arch.moe.top_k)).all()
    cap = moe.capacity(300, arch.moe)
    assert _check_drops(arch, x, tparams, leg) == 2 * arch.moe.top_k * (300 - cap)
    # the tokens past capacity add nothing, in both packages
    assert not got[0][:, cap:].any() and not np.asarray(want[0][:, cap:].astype(jnp.float32)).any()


@pytest.mark.parametrize("leg", list(DTYPES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_router_that_picks_one_expert_drops_like_reference(arch_id, leg):
    # feature 0 is 1 for every token and drives expert 0's logit to 10: every
    # token's first choice is expert 0, whose queue overflows; the other
    # choices follow small random logits
    ref_arch, arch = _archs(arch_id)
    params, tparams = _params(ref_arch, seed=3)
    router = np.random.default_rng(4).normal(0, 0.01, params["router"].shape).astype(np.float32)
    router[0] = 0.0
    router[0, 0] = 10.0
    params = dict(params, router=jnp.asarray(router))
    tparams = dict(tparams, router=torch.from_numpy(router))
    x = _x((2, 300, arch.d_model), 5)
    x[..., 0] = 1.0
    got, want = _run_both(ref_arch, arch, params, tparams, x, leg)
    _check(got, want, leg)
    assert (got[2][..., 0].numpy() == 0).all()
    cap = moe.capacity(300, arch.moe)
    assert _check_drops(arch, x, tparams, leg) >= 2 * (300 - cap)


@pytest.mark.parametrize("leg", list(DTYPES))
def test_several_groups_in_one_sequence_match_reference(leg):
    # 8192 tokens of one sequence: two routing groups of 4096 at tiny width;
    # capacity factor 0.25 keeps the reference's one-hot tensors small
    # (capacity 256) and drops many choices
    ref_arch, arch = _archs("olmoe-1b-7b", capacity_factor=0.25)
    ref_arch, arch = (dataclasses.replace(a, d_model=32) for a in (ref_arch, arch))
    params, tparams = _params(ref_arch, seed=4)
    x = _x((1, 8192, 32), 6)
    assert moe.group_tokens(8192) == 4096 and moe.capacity(4096, arch.moe) == 256
    _check(*_run_both(ref_arch, arch, params, tparams, x, leg), leg)
    assert _check_drops(arch, x, tparams, leg) > 0


def test_capacity_rule_matches_reference_formula():
    for arch_id in ARCH_IDS:
        full = configs.get_arch(arch_id).moe
        for tg in (1, 2, 255, 256, 257, 300, 1024, 4096):
            want = int(full.capacity_factor * tg * full.top_k / full.num_experts)
            want = max(tg * full.top_k if tg <= 256 else want, full.top_k)
            assert moe.capacity(tg, full) == want
    # olmoe's 1024-token prefill groups at full width: 160 slots per expert
    assert moe.capacity(1024, configs.get_arch("olmoe-1b-7b").moe) == 160


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_init_params_follows_the_reference_shapes_and_distributions(arch_id):
    ref_arch, arch = _archs(arch_id)
    want = ref_moe.init_params(jax.random.PRNGKey(0), ref_arch)
    got = moe.init_params(arch, torch.Generator().manual_seed(0), "cpu")
    assert moe.param_shapes(arch) == {name: tuple(v.shape) for name, v in want.items()}
    d, f = arch.d_model, arch.moe.d_expert
    for name, scale in (("router", d ** -0.5), ("gate", d ** -0.5), ("up", d ** -0.5), ("down", f ** -0.5)):
        assert got[name].dtype == torch.float32 and tuple(got[name].shape) == want[name].shape
        assert abs(float(got[name].std()) - scale) < 0.1 * scale
        assert abs(float(got[name].mean())) < 0.1 * scale


# ----------------------------------------------------------------------------
# the card: full width, 1024-token groups
# ----------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def routing_in_float64(logits: torch.Tensor, k: int, cap: int):
    """The reference's routing recomputed in float64 on the host from router
    logits (G, Tg, E): (expert_idx, keep), lower index first among ties."""
    probs = torch.softmax(logits.double().cpu(), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    g, tg, _ = logits.shape
    slot, keep = _oracle_routing(order.reshape(g, tg, k).numpy(), tg, logits.shape[-1], cap)
    return order, torch.from_numpy(keep)


@pytest.mark.gpu
@pytest.mark.parametrize("router", ["random", "zero", "one expert"])
def test_full_width_routing_on_card_matches_float64(router, monkeypatch):
    dev = _card()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    arch = configs.get_arch("olmoe-1b-7b")
    params = moe.init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
    x = torch.randn((2, 1024, arch.d_model), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    if router == "zero":
        params["router"].zero_()
    elif router == "one expert":
        params["router"][0] = 0.0
        params["router"][0, 0] = 10.0
        x[..., 0] = 1.0
    k, cap = arch.moe.top_k, moe.capacity(1024, arch.moe)
    r = moe.route(params, x, arch, cap)
    order, keep = routing_in_float64(x @ params["router"], k, cap)
    assert torch.equal(r.expert_idx.cpu(), order) and torch.equal(r.keep.cpu(), keep)
    out, _, idx = moe.moe_mixer(params, x, arch)
    assert torch.equal(idx.cpu().long(), order)
    assert bool(torch.isfinite(out).all())
    if router != "random":
        assert int((~keep).sum()) > 0  # expert 0's queue overflows


def _mean_cosine(x: np.ndarray) -> float:
    """Mean cosine between the rows of different tokens of each group (G, T, d)."""
    u = x.astype(np.float64)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    t = u.shape[1]
    total = np.square(np.linalg.norm(u.sum(axis=1), axis=-1))
    return float(((total - t) / (t * (t - 1))).mean())


def _drops(expert_idx: np.ndarray, e: int, cap: int) -> int:
    tg = expert_idx.shape[1]
    return int((~_oracle_routing(expert_idx, tg, e, cap)[1]).sum())


WITNESS_LAYERS = 3  # full-width layers of the launcher's olmoe held to the reference


@pytest.mark.gpu
def test_launcher_olmoe_layer0_drops_witnessed_by_the_reference(monkeypatch):
    # the serve launcher's olmoe-1b-7b prefill at full width drops many
    # (token, choice) pairs past capacity 160.  Its first WITNESS_LAYERS
    # layers (layer 0 first: the launcher's weights are drawn layer by layer,
    # so these are its layers) on its 8 x 1024 prompts run in the port on
    # the card; the reference then runs each layer on the host with the same
    # weights, from the port's input to that layer, up to the router: the
    # router inputs and each layer's drops must agree, and a token may route
    # otherwise only at a near-tie of the reference's router logits (a
    # reroute's changes to the next layers' inputs stay in the port's
    # stream, which the reference starts each layer from).  Printed beside
    # them: the mean cross-token cosine of the router input and of the
    # embeddings alone, and the drops once each group's mean logit is taken
    # out (the part of the routing that all tokens share)
    dev = _card()
    argv = ["--arch", "olmoe-1b-7b", "--full-config", "--requests", "8", "--prompt-len", "1024"]
    args = serve._parser().parse_args(argv)
    arch = dataclasses.replace(configs.get_arch("olmoe-1b-7b"), n_layers=WITNESS_LAYERS)
    ref_arch = dataclasses.replace(ref_configs.get_arch("olmoe-1b-7b"), n_layers=WITNESS_LAYERS)
    e, k = arch.moe.num_experts, arch.moe.top_k
    cap = moe.capacity(1024, arch.moe)
    model = serve._model(args, arch, dev)
    prompts = serve._prompts(args, arch, dev)

    seen, inputs = [], []
    route, apply_sublayer = moe.route, transformer._apply_sublayer

    def spy(params, xt, arch_, cap_):
        r = route(params, xt, arch_, cap_)
        seen.append(dict(xt=xt.float().cpu().numpy(),
                         logits=(xt @ params["router"].to(xt.dtype)).float().cpu().numpy(),
                         idx=r.expert_idx.cpu().numpy(), drops=int((~r.keep).sum())))
        return r

    def layer_input(kind, sub, x, *rest):
        inputs.append(x.cpu())
        return apply_sublayer(kind, sub, x, *rest)

    monkeypatch.setattr(moe, "route", spy)
    monkeypatch.setattr(transformer, "_apply_sublayer", layer_input)
    with torch.inference_mode():
        transformer.forward(model, {"tokens": prompts}, arch)
    assert len(seen) == len(inputs) == WITNESS_LAYERS
    embed_rows = model.embed[prompts.long()].float().cpu().numpy()

    # the reference on the host, each layer up to its MoE mixer's input
    tree = interop.model_to_reference(model, arch)
    del model
    torch.cuda.empty_cache()
    tokens = jnp.asarray(prompts.cpu().numpy())
    positions = ref_transformer.default_positions(ref_arch, *tokens.shape)
    captured = {}

    def mixer_input(params, h2, arch_):
        captured["h2"] = h2
        return jnp.zeros_like(h2), jnp.zeros((), jnp.float32), None

    monkeypatch.setattr(ref_transformer.moe_lib, "moe_mixer", mixer_input)
    rows = []
    for layer, (port, x_in) in enumerate(zip(seen, inputs)):
        stage = tree["stage0"]["sub0"]
        sub = {name: jax.tree_util.tree_map(lambda a: jnp.asarray(a[layer]), stage[name])
               for name in ("norm1", "norm2", "mixer")}
        sub["channel"] = {"router": jnp.asarray(stage["channel"]["router"][layer])}
        x = jnp.asarray(x_in.float().numpy()).astype(ref_common.ACT_DTYPE)  # bf16 values, exactly
        ref_transformer._apply_sublayer("attn", sub, x, positions, ref_arch, False)
        h2 = captured["h2"]  # the reference's router input, computed by its own layer code
        ref_logits = (h2 @ sub["channel"]["router"].astype(h2.dtype)).astype(jnp.float32)  # moe_mixer's lines
        ref_idx = np.asarray(jax.lax.top_k(jax.nn.softmax(ref_logits, axis=-1), k)[1])
        ref_in, ref_logits = np.asarray(h2.astype(jnp.float32)), np.asarray(ref_logits)
        port_in, port_logits, port_idx = port["xt"], port["logits"], port["idx"]

        # a token routed otherwise (its choices or their order) must sit at a
        # near-tie of the reference's logits, as chip_smoke.py's bf16 legs hold
        otherwise = np.argwhere((port_idx != ref_idx).any(-1))
        ties = [(_tie_gap(torch.tensor(ref_logits[g, t]), torch.tensor(port_idx[g, t])),
                 float(np.abs(port_logits[g, t] - ref_logits[g, t]).max())) for g, t in otherwise]
        centred = port_logits - port_logits.mean(axis=1, keepdims=True)
        row = {
            "layer": layer,
            "router_input_mean_abs_diff": float(np.abs(port_in - ref_in).mean()),
            "router_input_max_abs_diff": float(np.abs(port_in - ref_in).max()),
            "logits_max_abs_diff": float(np.abs(port_logits - ref_logits).max()),
            "choices_equal": float((port_idx == ref_idx).mean()),
            "tokens_routed_otherwise": len(ties), "largest_gap": max((gap for gap, _ in ties), default=0.0),
            "choices": int(port_idx.size), "capacity": cap,
            "drops_port": port["drops"], "drops_reference": _drops(ref_idx, e, cap),
            "router_input_cosine_port": _mean_cosine(port_in), "router_input_cosine_reference": _mean_cosine(ref_in),
            "shared_logit_std": float(port_logits.mean(axis=1).std(axis=-1).mean()),
            "token_logit_std": float(centred.std(axis=-1).mean()),
            "drops_without_the_shared_logits": _drops(np.argsort(-centred, axis=-1, kind="stable")[..., :k], e, cap),
        }
        if layer == 0:
            row["embedding_cosine"] = _mean_cosine(embed_rows)
        print(f"[olmoe layer-{layer} witness] {json.dumps(row)}")
        rows.append((row, ties))
    for row, ties in rows:
        assert _drops(seen[row["layer"]]["idx"], e, cap) == row["drops_port"]  # the port's keep is the queue rule's
        assert row["router_input_mean_abs_diff"] <= 0.01
        assert all(gap <= 2 * change for gap, change in ties), row["layer"]
        assert abs(row["drops_port"] - row["drops_reference"]) <= 0.01 * row["choices"], row["layer"]
        assert abs(row["router_input_cosine_port"] - row["router_input_cosine_reference"]) <= 0.01
