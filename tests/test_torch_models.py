"""Port vs reference: the configs and the RWKV6 modules.

The reference's reduced RWKV6-3B (2 layers, d 128, 4 heads of 32, vocab
512) is initialised once for the module and carried to the port with
``repro_torch.interop``; inputs are seeded numpy arrays handed to both.
The modules run with float32 inputs, so the comparison is of the
algorithm: both packages compute in float32, in other orders of
summation, held within rtol 1e-4 and atol 1e-4 (``TOL``).  The bf16 leg of
the whole model is in ``tests/test_torch_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import common as ref_common
from repro.models import registry as ref_registry
from repro.models import rwkv6 as ref_rwkv6
from repro.models import transformer as ref_transformer
from repro_torch import configs, interop
from repro_torch.kernels import rwkv_intra
from repro_torch.models import common, registry, rwkv6, transformer

TOL = dict(rtol=1e-4, atol=1e-4)  # float32, sums in another order
B = 2


@pytest.fixture(scope="module")
def ref():
    """(arch, reference params, their numpy tree, the port's model)."""
    ref_arch = ref_configs.get_arch("rwkv6-3b").reduced()
    params = ref_transformer.init_params(jax.random.PRNGKey(0), ref_arch)
    tree = jax.tree_util.tree_map(np.asarray, params)
    arch = configs.get_arch("rwkv6-3b").reduced()
    return arch, params, tree, interop.model_from_reference(tree, arch, "cpu")


def _layer(params, i=0):
    """Layer i's sublayer params of the reference's stacked stage."""
    return jax.tree_util.tree_map(lambda a: a[i], params["stage0"]["sub0"])


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


# ----------------------------------------------------------------------------
# configs and parameter counts
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ref_configs.ARCH_IDS)
def test_configs_match_reference(arch_id):
    mine, theirs = configs.get_arch(arch_id), ref_configs.get_arch(arch_id)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(theirs.reduced())


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()
    }
    for arch_id in configs.ARCH_IDS:
        for name in configs.SHAPES:
            assert configs.skip_reason(configs.get_arch(arch_id), configs.SHAPES[name]) == ref_configs.skip_reason(
                ref_configs.get_arch(arch_id), ref_configs.SHAPES[name])


def test_rwkv6_3b_param_count_matches_reference():
    arch = configs.get_arch("rwkv6-3b")
    assert arch.param_count() == 3_099_609_600 == ref_registry.param_count(ref_configs.get_arch("rwkv6-3b"))
    assert arch.reduced().param_count() == ref_configs.get_arch("rwkv6-3b").reduced().param_count()
    assert registry.model_flops_per_token(arch, "prefill") == ref_registry.model_flops_per_token(
        ref_configs.get_arch("rwkv6-3b"), "prefill")
    assert registry.non_embedding_params(arch) == ref_registry.non_embedding_params(ref_configs.get_arch("rwkv6-3b"))


@pytest.mark.parametrize("arch_id", ["tinyllama-1.1b", "mixtral-8x7b", "recurrentgemma-9b"])
def test_every_family_builds_with_the_reference_param_count(arch_id):
    # dense, MoE and the RG-LRU hybrid (tests/test_torch_attention.py,
    # tests/test_torch_families.py): the reference's parameter count and,
    # for the model drawn, its layer list
    arch, ref_arch = configs.get_arch(arch_id).reduced(), ref_configs.get_arch(arch_id).reduced()
    assert arch.param_count() == ref_registry.param_count(ref_arch)
    model = transformer.init_params(arch, torch.Generator().manual_seed(0), "cpu")
    assert len(model.layers) == arch.n_layers
    assert [block.kind for block in model.layers] == [
        kind for pattern, repeats in ref_transformer.layer_stages(ref_arch) for _ in range(repeats) for kind in pattern]
    assert sum(p.numel() for p in model.parameters()) == ref_registry.param_count(ref_arch)


def test_init_params_follows_the_reference_tree_and_distributions(ref):
    arch, _, tree, _ = ref
    model = transformer.init_params(arch, torch.Generator().manual_seed(0), "cpu")
    mine = interop.model_to_reference(model, arch)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    mixer = mine["stage0"]["sub0"]["mixer"]
    assert (mixer["mix_base"] == 0.5).all() and (mixer["decay_base"] == -0.5).all()
    assert (mixer["ln_w"] == 1).all() and (mixer["ln_b"] == 0).all()
    assert abs(mixer["wr"].std() - 1 / np.sqrt(arch.d_model)) < 0.1 / np.sqrt(arch.d_model)
    assert abs(mine["embed"].std() - 0.02) < 0.002
    assert not any(p.requires_grad for p in model.parameters())


# ----------------------------------------------------------------------------
# modules
# ----------------------------------------------------------------------------


def test_rms_norm_matches_reference():
    x, w = _x((3, 5, 64), 1), _x((64,), 2)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
           ref_common.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), dict(rtol=1e-6, atol=1e-6))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = common.rms_norm(xb, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = ref_common.rms_norm(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(w))
    _close(got, want, dict(rtol=1e-2, atol=1e-2))  # one bf16 rounding apart at most


def test_head_norm_matches_reference(ref):
    arch, params, _, model = ref
    y = _x((B, 7, arch.n_heads, arch.rwkv_head_dim), 3, scale=3.0) + 1.5
    _close(rwkv6._head_norm(model.layers[0].mixer, torch.from_numpy(y), arch),
           ref_rwkv6._head_norm(_layer(params)["mixer"], jnp.asarray(y), arch), dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("s", [1, 64])
def test_projections_match_reference(ref, s):
    arch, params, _, model = ref
    x = _x((B, s, arch.d_model), 4)
    got = rwkv6._projections(model.layers[1].mixer, torch.from_numpy(x), arch)
    want = ref_rwkv6._projections(_layer(params, 1)["mixer"], jnp.asarray(x), arch)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("s", [128, 40, 100])
@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_chunked_matches_reference(ref, s, carried):
    # 128: two chunks of 64; 40: one short chunk (C = 40); 100: the scan
    arch, params, _, model = ref
    x = _x((B, s, arch.d_model), s)
    st = _x((B, arch.n_heads, arch.rwkv_head_dim, arch.rwkv_head_dim), s + 1, scale=0.5) if carried else None
    want = ref_rwkv6.time_mix_chunked(_layer(params)["mixer"], jnp.asarray(x), arch,
                                      None if st is None else jnp.asarray(st), chunk=arch.rwkv_chunk_size)
    got = rwkv6.time_mix_chunked(model.layers[0].mixer, torch.from_numpy(x), arch,
                                 None if st is None else torch.from_numpy(st), chunk=arch.rwkv_chunk_size)
    for g, w in zip(got, want):
        _close(g, w)


def test_time_mix_matches_reference(ref):
    # the per-token scan from a carried state, at one short chunk's length
    arch, params, _, model = ref
    x = _x((B, 40, arch.d_model), 17)
    st = _x((B, arch.n_heads, arch.rwkv_head_dim, arch.rwkv_head_dim), 18, scale=0.5)
    want = ref_rwkv6.time_mix(_layer(params, 1)["mixer"], jnp.asarray(x), arch, jnp.asarray(st))
    got = rwkv6.time_mix(model.layers[1].mixer, torch.from_numpy(x), arch, torch.from_numpy(st))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("s,calls", [(128, 1), (40, 1), (100, 0)])
def test_chunked_intra_term_is_one_rwkv_intra_call_per_layer(ref, monkeypatch, s, calls):
    arch, _, _, model = ref
    seen = []

    def spy(r, k, v, lex, lcum, u):
        seen.append(tuple(r.shape))
        return rwkv_intra.rwkv_intra_plain(r, k, v, lex, lcum, u)

    monkeypatch.setattr(rwkv6, "rwkv_intra", spy)
    rwkv6.time_mix_chunked(model.layers[0].mixer, torch.from_numpy(_x((B, s, arch.d_model), 5)), arch,
                           chunk=arch.rwkv_chunk_size)
    c = min(arch.rwkv_chunk_size, s)
    assert seen == [(B * (s // c) * arch.n_heads, c, arch.rwkv_head_dim)] * calls


def test_time_mix_step_matches_reference(ref):
    arch, params, _, model = ref
    h, n = arch.n_heads, arch.rwkv_head_dim
    x_t, x_prev, state = _x((B, arch.d_model), 6), _x((B, arch.d_model), 7), _x((B, h, n, n), 8, scale=0.5)
    got = rwkv6.time_mix_step(model.layers[1].mixer, *(torch.from_numpy(a) for a in (x_t, x_prev, state)), arch)
    want = ref_rwkv6.time_mix_step(_layer(params, 1)["mixer"], *(jnp.asarray(a) for a in (x_t, x_prev, state)),
                                   arch)
    for g, w in zip(got, want):
        _close(g, w)


def test_recurrence_step_matches_reference(ref):
    arch, params, _, _ = ref
    h, n = arch.n_heads, arch.rwkv_head_dim
    state, r, k, v = _x((B, h, n, n), 9), _x((B, h, n), 10), _x((B, h, n), 11), _x((B, h, n), 12)
    log_w, u = -np.abs(_x((B, h, n), 13)), _x((h, n), 14)
    args = (state, r, k, v, log_w, u)
    got = rwkv6.recurrence_step(*(torch.from_numpy(a) for a in args))
    want = ref_rwkv6.recurrence_step(*(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        _close(g, w, dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("with_prev", [False, True])
def test_channel_mix_matches_reference(ref, with_prev):
    arch, params, _, model = ref
    x = _x((B, 9, arch.d_model), 15)
    prev = _x((B, 9, arch.d_model), 16) if with_prev else None
    got = rwkv6.channel_mix(model.layers[0].channel, torch.from_numpy(x),
                            None if prev is None else torch.from_numpy(prev))
    want = ref_rwkv6.channel_mix(_layer(params)["channel"], jnp.asarray(x), None if prev is None else jnp.asarray(prev))
    _close(got, want)


# ----------------------------------------------------------------------------
# interop
# ----------------------------------------------------------------------------


def test_model_round_trips_bit_for_bit(ref):
    arch, _, tree, model = ref
    back = interop.model_to_reference(model, arch)
    leaves, want = jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(leaves, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_model_from_reference_validates_the_tree(ref):
    arch, _, tree, _ = ref
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["stage0"]["sub0"]["mixer"]["wr"] = bad["stage0"]["sub0"]["mixer"]["wr"][:, :3]
    with pytest.raises(ValueError, match="mixer/wr"):
        interop.model_from_reference(bad, arch, "cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["embed"] = bad["embed"].astype(np.float64)
    with pytest.raises(TypeError, match="float32"):
        interop.model_from_reference(bad, arch, "cpu")
