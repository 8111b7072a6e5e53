"""Port vs reference: the partition rules, the activation hints, the
compressed all-reduce, the production meshes and the sharding arguments of
the train step and the checkpoint restore.

* ``param_specs`` / ``batch_specs`` / ``cache_specs``: equal to the
  reference's spec for spec (``PartitionSpec`` entries compared as tuples)
  for all ten archs at full width, on the (16, 16), (2, 16, 16), (64, 4) and
  (32, 8) meshes; the reference's trees from ``jax.eval_shape``, the port's
  from ``meta`` builds (``interop.meta_tree``, ``engine.init_cache``).
* ``constrain``: a spy on both packages records the same (dims, shape)
  sequence and the same resolved specs in a reduced forward of the rwkv6,
  dense-attention, rglru and moe families (the reference traces a stage's
  body once, the port runs every layer: the port's sequence is the
  reference's, each stage's part repeated once a layer).  The port's
  outputs with hints equal those without, bit for bit, in float32.
* ``compressed_psum`` and ``make_compressed_grad_reducer`` against the
  reference under ``shard_map`` over 4 forced host devices (a subprocess,
  as ``tests/test_dryrun_small.py`` runs its faked meshes): the int8
  payloads and scales bit-identical; the sums within ``SUM_ULPS`` float32
  ulps of the summed magnitudes (XLA may contract and reorder the adds;
  exact on the CPU).
* ``NamedSharding.check``, ``make_jitted_step`` and ``restore(shardings=)``
  raise on the shapes where the reference's ``device_put`` and jit raise
  (the same subprocess), and a reduced step under a (1, 1) mesh with hints
  equals the plain step.
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch.mesh import make_auto_mesh as ref_make_auto_mesh
from repro.models import transformer as ref_transformer
from repro.serve import engine as ref_engine
from repro.sharding import ctx as ref_ctx
from repro.sharding import specs as ref_specs

from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch, is_cell_supported
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh, make_test_mesh, n_chips
from repro_torch.models import common, transformer
from repro_torch.optim import compress
from repro_torch.optim.adamw import quantize_int8
from repro_torch.serve import engine
from repro_torch.sharding import ctx, specs
from repro_torch.sharding.specs import P, NamedSharding
from repro_torch.train import step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "64x4": ((64, 4), ("data", "model")), "32x8": ((32, 8), ("data", "model"))}
SUM_ULPS = 4
HINTS = {"plain": dict(batch_axes=("data",), model_axis="model"),
         "seq_parallel": dict(batch_axes=("data",), model_axis="model", seq_parallel=True)}


class _RefMesh:
    """What the reference's spec rules read of a mesh (as its own tests fake it)."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _port_mesh(name):
    shape, axes = MESHES[name]
    return Mesh(shape, axes, [META] * math.prod(shape))


def _flat_ref(tree):
    return {jax.tree_util.keystr(p): tuple(s) for p, s in jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}


def _flat_port(tree):
    return {specs.keystr(p): tuple(s) for p, s in specs.tree_leaves_with_path(tree)}


_REF_SHAPES = {}


def _ref_param_shapes(arch_id):
    if arch_id not in _REF_SHAPES:
        arch = ref_get_arch(arch_id)
        _REF_SHAPES[arch_id] = jax.eval_shape(lambda k: ref_transformer.init_params(k, arch),
                                              jax.ShapeDtypeStruct((2,), jnp.uint32))
    return _REF_SHAPES[arch_id]


def _port_param_tree(arch_id):
    model = transformer.init_params(get_arch(arch_id), torch.Generator(), META)
    return interop.meta_tree(interop.param_leaves(model))


# ----------------------------------------------------------------------------
# specs
# ----------------------------------------------------------------------------


def test_partition_spec_normalizes_as_jax():
    for entries in [(("data",), None), (("pod", "data"), None), ("model",), (), (None, None)]:
        assert tuple(P(*entries)) == tuple(jax.sharding.PartitionSpec(*entries))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_specs_equal_reference(arch_id):
    ref_tree, tree = _ref_param_shapes(arch_id), _port_param_tree(arch_id)
    ref_arch, arch = ref_get_arch(arch_id), get_arch(arch_id)
    for name in ("16x16", "64x4", "32x8"):  # the (2, 16, 16) mesh has the same data and model sizes
        data, model = MESHES[name][0][-2:]
        want = _flat_ref(ref_specs.param_specs(ref_tree, ref_arch, data_size=data, model_size=model))
        got = _flat_port(specs.param_specs(tree, arch, data_size=data, model_size=model))
        assert got == want, (arch_id, name, {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v})
    flat = {specs.keystr(p): tuple(t.shape) for p, t in specs.tree_leaves_with_path(tree)}
    assert flat == {jax.tree_util.keystr(p): tuple(a.shape) for p, a in jax.tree_util.tree_leaves_with_path(ref_tree)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_batch_and_cache_specs_equal_reference(arch_id, mesh_name):
    shape_, axes = MESHES[mesh_name]
    ref_mesh, mesh = _RefMesh(shape_, axes), _port_mesh(mesh_name)
    ref_arch, arch = ref_get_arch(arch_id), get_arch(arch_id)
    for cell in SHAPES.values():
        keys = ("tokens", "targets", "positions", "frontend_embeds", "token", "pos_scalar")
        want = ref_specs.batch_specs(ref_arch, ref_mesh, cell.global_batch, keys)
        got = specs.batch_specs(arch, mesh, cell.global_batch, keys)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}, cell.name
        if cell.kind != "decode" or not is_cell_supported(arch, cell):
            continue
        ref_cache = jax.eval_shape(lambda: ref_engine.init_cache(ref_arch, cell.global_batch, cell.seq_len))
        cache = engine.init_cache(arch, cell.global_batch, cell.seq_len, device=META)
        want = _flat_ref(ref_specs.cache_specs(ref_cache, ref_arch, ref_mesh, cell.global_batch))
        got = _flat_port(specs.cache_specs(cache, arch, mesh, cell.global_batch))
        assert got == want, (cell.name, {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v})
        specs.check_tree(cache, specs.named(specs.cache_specs(cache, arch, mesh, cell.global_batch), mesh))


def test_named_sharding_shards_and_joins():
    mesh = make_test_mesh((2, 3), ("data", "model"), device="cpu")
    x = torch.arange(4 * 6 * 5, dtype=torch.float32).reshape(4, 6, 5)
    for spec in [P("data", "model"), P(("data", "model")), P(None, "model"), P(), P(None, None, None)]:
        sh = NamedSharding(mesh, spec)
        if spec == P(("data", "model")):
            with pytest.raises(ValueError, match="divisible by 6"):
                sh.shard(x)
            continue
        shards = sh.shard(x)
        assert len(shards) == 6 and shards[0].shape == sh.shard_shape(x.shape)
        assert torch.equal(sh.unshard(shards), x)
    # position (i, j) of a ("data", "model") sharding holds block (i, j)
    shards = NamedSharding(mesh, P("data", "model")).shard(x)
    assert torch.equal(shards[1 * 3 + 2], x[2:4, 4:6])
    with pytest.raises(ValueError, match="rank"):
        NamedSharding(mesh, P("data", None, None, None)).check((4, 6, 5))
    with pytest.raises(ValueError, match="not in the mesh"):
        NamedSharding(mesh, P("pod"))


def test_production_meshes():
    m1 = make_production_mesh(devices=[META] * 256)
    m2 = make_production_mesh(multi_pod=True, devices=[META] * 512)
    m3 = make_production_mesh(tp=4, devices=[META] * 256)
    assert m1.shape == {"data": 16, "model": 16} and n_chips(m1) == 256
    assert m2.shape == {"pod": 2, "data": 16, "model": 16} and n_chips(m2) == 512
    assert m3.shape == {"data": 64, "model": 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_production_mesh()


# ----------------------------------------------------------------------------
# activation hints
# ----------------------------------------------------------------------------


def _ref_constraints(arch_id, hints, monkeypatch):
    arch = ref_get_arch(arch_id).reduced()
    calls, resolved = [], []
    orig, orig_wsc = ref_ctx.constrain, jax.lax.with_sharding_constraint

    def spy(x, dims):
        calls.append((tuple(dims), tuple(x.shape)))
        return orig(x, dims)

    def spy_wsc(x, spec):
        resolved.append(tuple(spec))
        return orig_wsc(x, spec)

    monkeypatch.setattr(ref_ctx, "constrain", spy)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", spy_wsc)
    params = ref_transformer.init_params(jax.random.PRNGKey(0), arch)
    toks = jnp.asarray(np.random.default_rng(3).integers(0, arch.vocab_size, (2, 64)).astype(np.int32))
    with ref_make_auto_mesh((1, 1), ("data", "model")), ref_ctx.use_hints(ref_ctx.ActivationHints(**hints)):
        jax.jit(lambda p, b: ref_transformer.forward(p, b, arch)[0])(params, {"tokens": toks})
    monkeypatch.setattr(ref_ctx, "constrain", orig)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", orig_wsc)
    return calls, resolved


@pytest.mark.parametrize("hints_name", list(HINTS))
@pytest.mark.parametrize("arch_id", ["rwkv6-3b", "tinyllama-1.1b", "recurrentgemma-9b", "olmoe-1b-7b"])
def test_constraint_sites_match_reference(arch_id, hints_name, monkeypatch):
    hints = HINTS[hints_name]
    ref_calls, ref_resolved = _ref_constraints(arch_id, hints, monkeypatch)
    monkeypatch.setattr(common, "ACT_DTYPE", torch.float32)
    arch = get_arch(arch_id).reduced()
    model = transformer.init_params(arch, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, arch.vocab_size, (2, 64)).astype(np.int32))
    calls, resolved = [], []
    orig = ctx.constrain

    def spy(x, dims):
        calls.append((tuple(dims), tuple(x.shape)))
        resolved.append(tuple(ctx.resolve(dims, ctx.get_hints())))
        return orig(x, dims)

    with torch.inference_mode():
        plain = transformer.forward(model, {"tokens": toks}, arch)[0]
        monkeypatch.setattr(ctx, "constrain", spy)
        with ctx.use_hints(ctx.ActivationHints(**hints)):
            hinted = transformer.forward(model, {"tokens": toks}, arch)[0]
    assert torch.equal(plain, hinted)
    # the reference traced each stage's body once; the port ran each layer
    stages = transformer.layer_stages(arch)
    assert all(r == 1 for _, r in stages) or len(stages) == 1, stages
    repeats = stages[0][1] if len(stages) == 1 else 1
    assert calls == ref_calls * repeats
    assert resolved == ref_resolved * repeats
    assert len(calls) > 0


def test_constrain_is_identity_and_checks_rank():
    x = torch.zeros(2, 3)
    assert ctx.constrain(x, ("batch", "model", None)) is x  # hints unset: no check, as the reference
    with ctx.use_hints(ctx.ActivationHints(batch_axes=("pod", "data"), model_axis=None)):
        assert ctx.constrain(x, ("batch", "model")) is x
        assert ctx.resolve(("batch", "model"), ctx.get_hints()) == P(("pod", "data"), None)
        with pytest.raises(ValueError, match="rank"):
            ctx.constrain(x, ("batch", "model", None))
    assert ctx.get_hints() is None


# ----------------------------------------------------------------------------
# compressed all-reduce and the raising shapes, against the reference on 4
# forced host devices
# ----------------------------------------------------------------------------

# (shape, spec) over a ("data", "model") = (2, 2) mesh
RAISE_CASES = [((22, 8), ("data", None)), ((24, 8), ("data", None)), ((4, 6), ("data", "model")),
               ((4, 5), ("data", "model")), ((8,), ("data", "model")), ((6, 4), (("data", "model"), None)),
               ((8, 4), (("data", "model"), None)), ((3,), ())]


def _reference_on_four_devices(xs: np.ndarray, tree: dict, stacked_shape) -> dict:
    code = f"""
        import json
        import numpy as np
        import jax, jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.compat import shard_map
        from repro.launch.mesh import make_auto_mesh
        from repro.optim.adamw import quantize_int8
        from repro.optim.compress import compressed_psum, make_compressed_grad_reducer

        xs = np.asarray({xs.tolist()!r}, np.float32)
        tree = {{k: np.asarray(v, np.float32) for k, v in {json.dumps({k: v.tolist() for k, v in tree.items()})}.items()}}
        mesh = make_auto_mesh((4,), ("data",))

        def payload(x):
            q, s = quantize_int8(x)
            return jax.lax.all_gather(q, "data"), jax.lax.all_gather(s, "data")

        qs, ss = jax.jit(shard_map(payload, mesh=mesh, in_specs=P("data"), out_specs=P()))(jnp.asarray(xs))
        summed = jax.jit(shard_map(lambda x: compressed_psum(x, "data"), mesh=mesh, in_specs=P("data"),
                                   out_specs=P()))(jnp.asarray(xs))
        mean = make_compressed_grad_reducer(mesh, ("data",))({{k: jnp.asarray(v) for k, v in tree.items()}})
        mesh2 = make_auto_mesh((2, 2), ("data", "model"))
        raises = []
        for shape, spec in {RAISE_CASES!r}:
            sh = NamedSharding(mesh2, P(*spec))
            try:
                jax.device_put(np.zeros(shape, np.float32), sh)
                put = False
            except ValueError:
                put = True
            try:
                jax.jit(lambda a: a, in_shardings=(sh,)).lower(jax.ShapeDtypeStruct(shape, jnp.float32))
                jit = False
            except ValueError:
                jit = True
            raises.append([put, jit])
        stacked = NamedSharding(make_auto_mesh((4,), ("data",)), P("data"))
        try:
            jax.jit(lambda a: a, in_shardings=(stacked,)).lower(jax.ShapeDtypeStruct({tuple(stacked_shape)!r}, jnp.float32))
            step_raises = False
        except ValueError:
            step_raises = True
        print(json.dumps({{"qs": np.asarray(qs).reshape(4, -1).tolist(), "ss": np.asarray(ss).reshape(-1).tolist(),
                          "summed": np.asarray(summed).reshape(-1).tolist(),
                          "mean": {{k: np.asarray(v).reshape(-1).tolist() for k, v in mean.items()}},
                          "raises": raises, "step_raises": step_raises}}))
    """
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def four_devices():
    rng = np.random.default_rng(7)
    xs = rng.normal(0, 1, (4, 96)).astype(np.float32)
    xs[2] *= 40.0  # one position far larger: its scale dominates its payload
    tree = {"a": rng.normal(0, 1, (64,)).astype(np.float32), "b": rng.normal(0, 3, (8, 16)).astype(np.float32)}
    arch = get_arch("smollm-360m").reduced()
    stacked = (transformer.layer_stages(arch)[0][1], arch.d_model)  # stage0/sub0/norm1 stacked
    return xs, tree, stacked, _reference_on_four_devices(xs, tree, stacked)


def _ulp_bound(terms: np.ndarray) -> np.ndarray:
    return SUM_ULPS * np.finfo(np.float32).eps * np.sum(np.abs(terms), axis=0)


def test_compressed_psum_payload_and_sum_match_reference(four_devices):
    xs, _, _, ref = four_devices
    shards = [torch.from_numpy(x) for x in xs]
    qs, ss = compress.compressed_gather(shards)
    assert np.array_equal(qs.numpy(), np.asarray(ref["qs"], np.int8))
    assert np.array_equal(ss.numpy(), np.asarray(ref["ss"], np.float32))
    for i, x in enumerate(shards):
        q, s = quantize_int8(x)
        assert torch.equal(qs[i], q) and torch.equal(ss[i], s)
    got = compress.compressed_psum(shards).numpy()
    want = np.asarray(ref["summed"], np.float32)
    terms = qs.numpy().astype(np.float32) * ss.numpy()[:, None]
    assert np.all(np.abs(got - want) <= _ulp_bound(terms)), np.max(np.abs(got - want))
    assert np.max(np.abs(got - xs.sum(0))) <= np.abs(xs.sum(0)).max() * 0.02 + 1e-3  # test_sharding's bound


def test_compressed_grad_reducer_matches_reference(four_devices):
    _, tree, _, ref = four_devices
    mesh = make_test_mesh((4,), ("data",), device="cpu")
    got = compress.make_compressed_grad_reducer(mesh, ("data",))({k: torch.from_numpy(v) for k, v in tree.items()})
    for k, v in tree.items():
        q, s = quantize_int8(torch.from_numpy(v))
        terms = np.repeat((q.numpy().astype(np.float32) * s.numpy())[None], 4, axis=0)
        want = np.asarray(ref["mean"][k], np.float32).reshape(v.shape)
        assert np.all(np.abs(got[k].numpy() - want) <= _ulp_bound(terms) / 4), k


def test_allreduce_bytes_accounting_matches_reference():
    from repro.optim.compress import compressed_allreduce_bytes as ref_bytes

    for n, devices in [(1000, 4), (64, 16), (7, 2)]:
        assert compress.compressed_allreduce_bytes(torch.zeros(n), devices) == ref_bytes(jnp.zeros(n), devices)


def test_sharding_checks_raise_where_the_reference_raises(four_devices):
    _, _, _, ref = four_devices
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    for (shape, spec), (put_raises, jit_raises) in zip(RAISE_CASES, ref["raises"]):
        assert put_raises == jit_raises
        try:
            NamedSharding(mesh, P(*spec)).check(shape)
            raised = False
        except ValueError:
            raised = True
        assert raised == put_raises, (shape, spec)


def _small_state(arch, cfg, seed=0):
    return step.init_train_state(torch.Generator().manual_seed(seed), arch, cfg, device="cpu")


def _batch(arch, b=2, s=32, seed=5):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, arch.vocab_size, (b, s + 1)).astype(np.int32))
    return {"tokens": toks[:, :-1].contiguous(), "targets": toks[:, 1:].contiguous()}


def test_jitted_step_and_restore_raise_where_jit_raises(four_devices, tmp_path):
    _, _, stacked_shape, ref = four_devices
    assert ref["step_raises"]  # the reference's jit refuses P("data") over 4 on the 2-layer stack
    arch = get_arch("smollm-360m").reduced()
    cfg = step.TrainConfig()
    state = _small_state(arch, cfg)
    tree = interop.meta_tree(interop.train_state_leaves(state))
    assert tuple(tree["params"]["stage0"]["sub0"]["norm1"].shape) == tuple(stacked_shape)
    mesh = make_test_mesh((4, 1), ("data", "model"), device="cpu")
    shardings = dryrun.state_shardings(tree, arch, mesh)
    batch = _batch(arch, b=4)
    fn = step.make_jitted_step(arch, cfg, mesh, shardings, dryrun.batch_shardings(batch, arch, mesh, 4))
    fn(state, batch)  # the rules' own specs divide
    ckpt.save(state, str(tmp_path), 1)
    bad = dict(shardings, params=dict(shardings["params"]))
    bad["params"]["stage0"] = {"sub0": dict(shardings["params"]["stage0"]["sub0"],
                                            norm1=NamedSharding(mesh, P("data")))}
    with pytest.raises(ValueError, match="divisible by 4"):
        step.make_jitted_step(arch, cfg, mesh, bad)(state, batch)
    with pytest.raises(ValueError, match="divisible by 4"):
        ckpt.restore(_small_state(arch, cfg, seed=1), str(tmp_path), 1, shardings=bad)
    batch_bad = {"tokens": batch["tokens"][:3], "targets": batch["targets"][:3]}
    with pytest.raises(ValueError, match="divisible by 4"):
        fn(state, batch_bad)


def test_restore_with_shardings_places_and_loads(tmp_path):
    arch = get_arch("tinyllama-1.1b").reduced()
    cfg = step.TrainConfig()
    state = _small_state(arch, cfg)
    step.train_step(state, _batch(arch), arch, cfg)
    ckpt.save(state, str(tmp_path), 1)
    mesh = make_test_mesh((1, 1), ("data", "model"), device="cpu")
    template = _small_state(arch, cfg, seed=9)
    shardings = dryrun.state_shardings(interop.meta_tree(interop.train_state_leaves(template)), arch, mesh)
    restored = ckpt.restore(template, str(tmp_path), 1, shardings=shardings)
    for (path, a, _), (_, b, _) in zip(interop.train_state_leaves(restored), interop.train_state_leaves(state)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), path


@pytest.mark.parametrize("arch_id", ["smollm-360m", "rwkv6-3b", "qwen2-vl-72b"])
def test_sharded_step_equals_plain_step(arch_id):
    """The counterpart of the reference's test_sharded_train_matches_single_device."""
    arch = get_arch(arch_id).reduced()
    cfg = step.TrainConfig(grad_accum=2)
    batch = _batch(arch, b=4)
    if arch.mrope:
        batch["positions"] = transformer.default_positions(arch, 4, 32, "cpu").contiguous()
    plain = _small_state(arch, cfg)
    _, m_plain = step.train_step(plain, batch, arch, cfg)
    hinted = _small_state(arch, cfg)
    mesh = make_test_mesh((1, 1), ("data", "model"), device="cpu")
    tree = interop.meta_tree(interop.train_state_leaves(hinted))
    fn = step.make_jitted_step(arch, cfg, mesh, dryrun.state_shardings(tree, arch, mesh),
                               dryrun.batch_shardings(batch, arch, mesh, 4))
    with ctx.use_hints(ctx.ActivationHints(batch_axes=("data",), model_axis="model", seq_parallel=True)):
        _, m_hinted = fn(hinted, batch)
    assert torch.equal(m_plain["loss"], m_hinted["loss"])
    for (path, a, _), (_, b, _) in zip(interop.train_state_leaves(hinted), interop.train_state_leaves(plain)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), path


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_compressed_psum_on_card():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(4)
    xs = [torch.randn(1 << 16, generator=gen, device=dev) for _ in range(4)]
    qs, ss = compress.compressed_gather(xs)
    for i, x in enumerate(xs):
        q, s = quantize_int8(x.cpu())
        assert torch.equal(qs[i].cpu(), q) and torch.equal(ss[i].cpu(), s)  # the card quantizes as the CPU does
    got, want = compress.compressed_psum(xs), torch.stack(xs).sum(0)
    assert (got - want).abs().max() <= want.abs().max() * 0.02 + 1e-3


@pytest.mark.gpu
def test_sharded_step_equals_plain_step_on_card():
    dev = _card()
    import chip_smoke

    arch = get_arch("rwkv6-3b").reduced()
    out = chip_smoke._hinted_step(dev, arch, 2, 128)
    assert out["leaves"] > 0
