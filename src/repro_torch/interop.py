"""Carry sketch state between the reference package and the port.

There are no weights: a sketch's state is its registers and its exact item
counters, exchanged as numpy arrays in the reference's own layout --
uint8 registers, (m,) or (B, m), and uint32 (hi, lo) counter limbs, (2,) or
(B, 2).  A ``HybridBank`` crosses as its settled fields (``pair_buf``,
``pair_len``, ``dense_block``, ``slot_map``, ``n_items``, ``threshold``) and
a ``WindowedBank`` as (W, B, m) registers, (W, B, 2) limbs, ``cursor`` and
``epochs``, in dicts keyed by the reference's field names.  Hidden state
(the ring's incremental fold, the fold caches, an unsettled append log)
never crosses: it rebuilds on the other side.  A ``CountMinBank`` crosses
as ``counters`` (uint32), ``labels`` and ``label_counts`` (int32), (B, d, w)
each, and ``n_items`` limbs; a ``WindowedCountMinBank`` as the same fields
with a leading W axis plus ``cursor`` and ``epochs``.  Wire bytes (RHLL,
RHLB, RHLW, RCMB, RCMW) need nothing here: both packages write and read
the same formats.

A model's weights cross as the reference's parameter tree: nested dicts
of float32 numpy arrays (``embed``, ``final_norm``, ``lm_head`` and per
stage ``stage<i>/sub<j>/{norm1, norm2, mixer/..., channel/...}`` stacked
over the stage's layers), bit for bit: the RWKV6 mixers, the attention
mixers (``wq``/``wk``/``wv``/``wo`` in the reference's GQA head grouping,
``q_norm``/``k_norm`` with qk-norm; a tied head is the embedding), the
RG-LRU mixers (``w_x``, ``w_gate``, ``conv_w``, ``conv_b``, ``w_a``,
``w_i``, ``lam``, ``w_out``), and the SwiGLU or MoE (``router``, ``gate``,
``up``, ``down``) channel mixes.  A training state
(``repro_torch.train.step``) crosses as the reference's: the weights,
AdamW's ``mu``, ``nu`` (and ``ef``) in the same tree, the int32 ``count``
and ``step`` and the uint8 sketch registers (``train_state_to_reference``,
``train_state_from_reference``; ``train_state_leaves`` lists its leaves in
the reference's flatten order, which the checkpoints use).  The decode
cache crosses in the reference's layout too (``cache_from_reference``): float32 entries (the
RWKV and RG-LRU states) as float32, bf16 entries (the RWKV token shifts,
the RG-LRU conv windows, the K/V rings, the int8 cache's scales) as
float32 (exact) or as their uint16 bits, since numpy
has no bfloat16 that torch reads, the int8 rings as int8 and the
``kv_pos_<W>`` slot maps as int32.  Converting JAX arrays to numpy is the
caller's part.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.serve import engine
from repro_torch.sketch import hll
from repro_torch.sketch.bank import SketchBank
from repro_torch.sketch.carrier import HyperLogLog
from repro_torch.sketch.countmin import CMConfig, CountMinBank, WindowedCountMinBank
from repro_torch.sketch.hll import HLLConfig
from repro_torch.sketch.sparse import HybridBank, _check_threshold
from repro_torch.sketch.window import WindowedBank, _validate_epoch_ring


def from_reference_state(
    registers: np.ndarray,
    n_items: np.ndarray,
    p: int,
    hash_bits: int,
    seed: int = 0,
    device=None,
) -> Union[HyperLogLog, SketchBank]:
    """A ``HyperLogLog`` for (m,) registers, a ``SketchBank`` for (B, m)."""
    cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
    regs = np.asarray(registers)
    limbs = np.asarray(n_items)
    if regs.shape[-1:] != (cfg.m,) or regs.ndim not in (1, 2):
        raise ValueError(f"expected (m,) or (B, m) registers with m={cfg.m}, got {regs.shape}")
    if limbs.shape != regs.shape[:-1] + (2,):
        raise ValueError(f"expected {regs.shape[:-1] + (2,)} counter limbs, got {limbs.shape}")
    device = hll.resolve_device(device)
    state = (
        torch.from_numpy(regs.astype(np.uint8)).to(device),
        torch.from_numpy(limbs.astype(np.uint32).astype(np.int64)).to(device),
        cfg,
    )
    return HyperLogLog(*state) if regs.ndim == 1 else SketchBank(*state)


def to_reference_state(x: Union[HyperLogLog, SketchBank]) -> Tuple[np.ndarray, np.ndarray]:
    """(registers uint8, n_items uint32 limbs) as the reference carries them."""
    return (
        x.registers.detach().cpu().numpy().astype(np.uint8),
        x.n_items.detach().cpu().numpy().astype(np.uint32),
    )


def _limbs(n_items: np.ndarray, shape: tuple) -> torch.Tensor:
    limbs = np.asarray(n_items)
    if limbs.shape != shape:
        raise ValueError(f"expected {shape} counter limbs, got {limbs.shape}")
    return torch.from_numpy(limbs.astype(np.uint32).astype(np.int64))


def hybrid_to_reference_state(bank: HybridBank) -> Dict[str, object]:
    """The settled fields of a ``HybridBank`` as the reference carries them."""
    s = bank.compact()
    return {
        "pair_buf": s.pair_buf.cpu().numpy().astype(np.int32),
        "pair_len": s.pair_len.cpu().numpy().astype(np.int32),
        "dense_block": s.dense_block.cpu().numpy().astype(np.uint8),
        "slot_map": s.slot_map.cpu().numpy().astype(np.int32),
        "n_items": s.n_items.cpu().numpy().astype(np.uint32),
        "threshold": int(s.threshold),
    }


def hybrid_from_reference_state(
    state: Dict[str, object], p: int, hash_bits: int, seed: int = 0, device=None
) -> HybridBank:
    """A ``HybridBank`` from the reference's settled fields (see above)."""
    cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
    pair_buf = np.array(state["pair_buf"], dtype=np.int32)
    rows = pair_buf.shape[0]
    dense = np.array(state["dense_block"], dtype=np.uint8)
    if pair_buf.ndim != 2 or dense.ndim != 2 or dense.shape[1] != cfg.m:
        raise ValueError(f"expected (B, C) pairs and (D, m={cfg.m}) dense rows")
    device = hll.resolve_device(device)
    return HybridBank(
        torch.from_numpy(pair_buf).to(device),
        torch.from_numpy(np.array(state["pair_len"], dtype=np.int32).reshape(rows)).to(device),
        torch.from_numpy(dense).to(device),
        torch.from_numpy(np.array(state["slot_map"], dtype=np.int32).reshape(rows)).to(device),
        _limbs(state["n_items"], (rows, 2)).to(device),
        cfg,
        _check_threshold(int(state["threshold"]), cfg),
    )


def window_to_reference_state(win: WindowedBank) -> Dict[str, object]:
    """A ``WindowedBank``'s ring as the reference carries it."""
    return {
        "registers": win.registers.cpu().numpy().astype(np.uint8),
        "n_items": win.n_items.cpu().numpy().astype(np.uint32),
        "cursor": int(win.cursor),
        "epochs": np.asarray(win.epochs, dtype=np.int32),
    }


def window_from_reference_state(
    state: Dict[str, object], p: int, hash_bits: int, seed: int = 0, device=None
) -> WindowedBank:
    """A ``WindowedBank`` from the reference's ring (see above)."""
    cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
    regs = np.array(state["registers"], dtype=np.uint8)
    if regs.ndim != 3 or regs.shape[2] != cfg.m:
        raise ValueError(f"expected (W, B, m={cfg.m}) registers, got {regs.shape}")
    window = regs.shape[0]
    cursor = int(state["cursor"])
    epochs = np.asarray(state["epochs"]).astype(np.int64).reshape(window)
    _validate_epoch_ring(epochs, cursor, window)
    device = hll.resolve_device(device)
    return WindowedBank(
        torch.from_numpy(regs).to(device),
        _limbs(state["n_items"], regs.shape[:2] + (2,)).to(device),
        cursor,
        epochs.astype(np.int32),
        cfg,
    )


def _cm_tables(state: Dict[str, object], cfg: CMConfig, ndim: int):
    """The (counters, labels, label_counts) of a count-min state as int32
    tensors (counters hold the uint32 bits), checked against ``cfg``."""
    counters = np.asarray(state["counters"])
    if counters.ndim != ndim or counters.shape[-2:] != (cfg.depth, cfg.width):
        raise ValueError(
            f"expected {ndim}-d counters ending in (d={cfg.depth}, w={cfg.width}), got {counters.shape}"
        )
    tables = [counters.astype(np.uint32).view(np.int32)]
    for field in ("labels", "label_counts"):
        table = np.asarray(state[field])
        if table.shape != counters.shape:
            raise ValueError(f"{field} are {table.shape}, counters {counters.shape}")
        tables.append(table.astype(np.int32))
    return [torch.from_numpy(np.ascontiguousarray(t)) for t in tables]


def countmin_to_reference_state(bank: CountMinBank) -> Dict[str, object]:
    """A ``CountMinBank``'s fields as the reference carries them."""
    return {
        "counters": bank.counters.cpu().numpy().view(np.uint32),
        "labels": bank.labels.cpu().numpy().astype(np.int32),
        "label_counts": bank.label_counts.cpu().numpy().astype(np.int32),
        "n_items": bank.n_items.cpu().numpy().astype(np.uint32),
    }


def countmin_from_reference_state(
    state: Dict[str, object], depth: int, width: int, seed: int = 0, device=None
) -> CountMinBank:
    """A ``CountMinBank`` from the reference's fields (see above)."""
    cfg = CMConfig(depth=depth, width=width, seed=seed)
    counters, labels, votes = _cm_tables(state, cfg, 3)
    device = hll.resolve_device(device)
    limbs = _limbs(state["n_items"], (counters.shape[0], 2))
    return CountMinBank(counters.to(device), labels.to(device), votes.to(device), limbs.to(device), cfg)


def cm_window_to_reference_state(win: WindowedCountMinBank) -> Dict[str, object]:
    """A ``WindowedCountMinBank``'s ring as the reference carries it."""
    state = countmin_to_reference_state(win)
    state.update(cursor=int(win.cursor), epochs=np.asarray(win.epochs, dtype=np.int32))
    return state


def cm_window_from_reference_state(
    state: Dict[str, object], depth: int, width: int, seed: int = 0, device=None
) -> WindowedCountMinBank:
    """A ``WindowedCountMinBank`` from the reference's ring (see above)."""
    cfg = CMConfig(depth=depth, width=width, seed=seed)
    counters, labels, votes = _cm_tables(state, cfg, 4)
    window = counters.shape[0]
    cursor = int(state["cursor"])
    epochs = np.asarray(state["epochs"]).astype(np.int64).reshape(window)
    _validate_epoch_ring(epochs, cursor, window)
    device = hll.resolve_device(device)
    limbs = _limbs(state["n_items"], tuple(counters.shape[:2]) + (2,))
    return WindowedCountMinBank(
        counters.to(device), labels.to(device), votes.to(device), limbs.to(device),
        cursor, epochs.astype(np.int32), cfg,
    )


# ----------------------------------------------------------------------------
# model weights and the decode cache
# ----------------------------------------------------------------------------


def _float32_leaf(value, shape: tuple, where: str) -> np.ndarray:
    arr = np.asarray(value)
    if arr.shape != tuple(shape):
        raise ValueError(f"{where}: expected shape {tuple(shape)}, got {arr.shape}")
    if arr.dtype != np.float32:
        raise TypeError(f"{where}: expected float32, got {arr.dtype}")
    return arr


def _named_from_tree(tree: Dict[str, object], arch: ArchConfig, device) -> Dict[str, torch.Tensor]:
    """A reference parameter-shaped tree (the weights, or AdamW's ``mu``,
    ``nu`` or ``ef``) as the port's tensors keyed by the model's parameter
    names, each layer's slice of its stage's stacked leaf, bit for bit."""
    shapes = transformer.param_shapes(arch)

    def tensor(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(arr)).to(device)  # a writable copy

    def leaf(node, shape_tree, name, where):
        return _float32_leaf(node[name], shape_tree[name], f"{where}/{name}")

    top = ("embed", "final_norm") + (() if arch.tie_embeddings else ("lm_head",))
    named = {name: tensor(leaf(tree, shapes, name, "")) for name in top}
    for i, (si, rep, j, _) in enumerate(transformer.sublayers(arch)):
        where = f"stage{si}/sub{j}"
        sub, sub_shapes = tree[f"stage{si}"][f"sub{j}"], shapes[f"stage{si}"][f"sub{j}"]
        for name in ("norm1", "norm2"):
            named[f"layers.{i}.{name}"] = tensor(leaf(sub, sub_shapes, name, where)[rep])
        for part in ("mixer", "channel"):
            for name in sub_shapes[part]:
                named[f"layers.{i}.{part}.{name}"] = tensor(leaf(sub[part], sub_shapes[part], name,
                                                                 f"{where}/{part}")[rep])
    return named


def model_from_reference(params: Dict[str, object], arch: ArchConfig, device=None) -> transformer.Model:
    """The port's model holding the reference's parameter tree, bit for bit."""
    named = _named_from_tree(params, arch, hll.resolve_device(device))
    shapes = transformer.param_shapes(arch)
    layers = []
    for i, (si, _, j, kind) in enumerate(transformer.sublayers(arch)):
        sub_shapes = shapes[f"stage{si}"][f"sub{j}"]
        parts = {part: {name: named[f"layers.{i}.{part}.{name}"] for name in sub_shapes[part]}
                 for part in ("mixer", "channel")}
        layers.append(transformer.Block(kind, named[f"layers.{i}.norm1"], named[f"layers.{i}.norm2"],
                                        *transformer.make_parts(kind, arch, parts["mixer"], parts["channel"])))
    return transformer.Model(arch, named["embed"], named["final_norm"], layers, named.get("lm_head"))


def _param_leaves(named: Dict[str, torch.Tensor], arch: ArchConfig) -> list:
    """(key path, tensors, stacked) of each leaf of the reference's
    parameter-shaped tree over the port's named tensors: a top-level leaf
    holds one tensor, a stage's leaf the tensors of its layers, stacked."""
    leaves = [((name,), [named[name]], False) for name in ("embed", "final_norm", "lm_head") if name in named]
    leaves += [(path, [named[name] for name in names], True)
               for path, names in transformer.stage_stacks(arch, named).items()]
    return leaves


def param_leaves(model: transformer.Model) -> list:
    """(key path, tensors, stacked) of each leaf of the reference's
    parameter tree over a port model (``model.arch`` lays out the stages)."""
    return _param_leaves(dict(model.named_parameters()), model.arch)


def meta_tree(leaves) -> Dict[str, object]:
    """Nested dicts of ``meta`` tensors, each of its leaf's shape and dtype
    as the reference holds it (a stage's layers stacked), from (key path,
    tensors, stacked) leaves; nothing is allocated.  The sharding rules
    (``repro_torch.sharding.specs``) read these trees."""
    out: Dict[str, object] = {}
    for path, tensors, stacked in leaves:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        shape = ((len(tensors),) if stacked else ()) + tuple(tensors[0].shape)
        node[path[-1]] = torch.empty(shape, dtype=tensors[0].dtype, device="meta")
    return out


def model_to_reference(model: transformer.Model, arch: ArchConfig) -> Dict[str, object]:
    """The reference's parameter tree (float32 numpy arrays) of a port model."""
    return _tree(_param_leaves(dict(model.named_parameters()), arch))


def leaf_array(tensors, stacked: bool) -> np.ndarray:
    """The host array of one reference leaf -- its tensor, or its layers'
    stacked -- as a copy: later in-place updates of the tensors (a CPU
    tensor's ``numpy()`` is a view of it) leave it as it was."""
    if stacked:
        return np.stack([t.detach().cpu().numpy() for t in tensors])
    return tensors[0].detach().to("cpu", copy=True).numpy()


def _tree(leaves) -> Dict[str, object]:
    """Nested dicts of host arrays from (key path, tensors, stacked) leaves."""
    out: Dict[str, object] = {}
    for path, tensors, stacked in leaves:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf_array(tensors, stacked)
    return out


# ----------------------------------------------------------------------------
# the training state
# ----------------------------------------------------------------------------


def train_state_leaves(state: Dict[str, object]) -> list:
    """Every leaf of the reference's training-state tree over a port state
    (``repro_torch.train.step``), in the reference's flatten order (keys
    sorted at every level): (key path, the port tensors it holds, whether
    they stack over a stage's layers).  ``opt.ef = None`` is no leaf."""
    model = state["params"]
    arch = model.arch
    opt = state["opt"]
    leaves = [(("opt", "count"), [opt["count"]], False), (("sketch",), [state["sketch"]], False),
              (("step",), [state["step"]], False)]
    trees = {"params": dict(model.named_parameters()), "mu": opt["mu"], "nu": opt["nu"], "ef": opt["ef"]}
    for name, named in trees.items():
        if named is not None:
            root = ("params",) if name == "params" else ("opt", name)
            leaves += [(root + path, tensors, stacked) for path, tensors, stacked in _param_leaves(named, arch)]
    return sorted(leaves, key=lambda leaf: leaf[0])


def train_state_to_reference(state: Dict[str, object]) -> Dict[str, object]:
    """The reference's training state (``repro.train.step``) as numpy:
    ``params``, ``opt`` (``mu``, ``nu``, int32 ``count``, ``ef`` or None),
    int32 ``step`` and uint8 ``sketch`` registers."""
    out = _tree(train_state_leaves(state))
    out["opt"].setdefault("ef", None)
    return out


def train_state_from_reference(tree: Dict[str, object], arch: ArchConfig, device=None) -> Dict[str, object]:
    """A port training state holding the reference's (numpy arrays), bit for
    bit; its parameters are trainable."""
    device = hll.resolve_device(device)
    model = model_from_reference(tree["params"], arch, device)
    model.requires_grad_(True)
    opt = tree["opt"]

    def scalar_int32(value, where: str) -> torch.Tensor:
        arr = np.asarray(value)
        if arr.shape != () or arr.dtype != np.int32:
            raise TypeError(f"{where}: expected an int32 scalar, got {arr.dtype} {arr.shape}")
        return torch.from_numpy(np.array(arr)).to(device)

    sketch = np.asarray(tree["sketch"])
    if sketch.dtype != np.uint8 or sketch.ndim != 1:
        raise TypeError(f"sketch: expected (m,) uint8 registers, got {sketch.dtype} {sketch.shape}")
    return {
        "params": model,
        "opt": {
            "mu": _named_from_tree(opt["mu"], arch, device),
            "nu": _named_from_tree(opt["nu"], arch, device),
            "count": scalar_int32(opt["count"], "opt/count"),
            "ef": None if opt.get("ef") is None else _named_from_tree(opt["ef"], arch, device),
        },
        "step": scalar_int32(tree["step"], "step"),
        "sketch": torch.from_numpy(np.array(sketch)).to(device),
    }


def _bf16_from_reference(value, where: str) -> torch.Tensor:
    """A bf16 tensor from float32 values (which must be bf16 values) or uint16 bits."""
    arr = np.asarray(value)
    if arr.dtype == np.uint16:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    if arr.dtype != np.float32:
        raise TypeError(f"{where}: expected float32 or uint16 bits of bf16, got {arr.dtype}")
    f32 = torch.from_numpy(np.array(arr))
    out = f32.to(torch.bfloat16)
    if not torch.equal(out.float(), f32):
        raise ValueError(f"{where}: float32 values that are not bf16 values")
    return out


def cache_from_reference(cache: Dict[str, object], arch: ArchConfig, device=None) -> Dict[str, object]:
    """The port's decode cache from the reference's, any family the port
    runs: float32 entries (``s``, ``h``) as float32, bf16 entries
    (``x_prev``, ``cm_x_prev``, ``conv``, the K/V rings, the int8 cache's
    scales) as float32 values or uint16 bits, the int8 rings as int8, and the ``kv_pos_<W>``
    slot maps, (W,) or (B, W), as int32."""
    device = hll.resolve_device(device)
    # the layout to expect: the port's own empty cache, on no device
    batch = np.asarray(next(iter(cache["stages"][0]["sub0"].values()))).shape[1]
    widths = [int(key.split("_")[-1]) for key in cache if key.startswith("kv_pos_")]
    template = engine.init_cache(arch, batch, max(widths, default=1), device="meta")
    out: Dict[str, object] = {"stages": []}
    for si, (pattern, _) in enumerate(transformer.layer_stages(arch)):
        stage = {}
        for j, _ in enumerate(pattern):
            entries, where = cache["stages"][si][f"sub{j}"], f"stages[{si}]/sub{j}"
            layout = template["stages"][si][f"sub{j}"]
            if set(entries) != set(layout):
                raise ValueError(f"{where}: entries {sorted(entries)}, expected {sorted(layout)}")
            moved = {}
            for name, value in entries.items():
                if np.shape(value) != tuple(layout[name].shape):
                    raise ValueError(f"{where}/{name}: expected {tuple(layout[name].shape)}, got {np.shape(value)}")
                dtype = layout[name].dtype
                if dtype == torch.bfloat16:
                    t = _bf16_from_reference(value, f"{where}/{name}")
                else:
                    arr = np.asarray(value)
                    want = np.float32 if dtype == torch.float32 else np.int8
                    if arr.dtype != want:
                        raise TypeError(f"{where}/{name}: expected {np.dtype(want)}, got {arr.dtype}")
                    t = torch.from_numpy(np.array(arr))
                moved[name] = t.to(device)
            stage[f"sub{j}"] = moved
        out["stages"].append(stage)
    for key, value in cache.items():
        if key.startswith("kv_pos_"):
            out[key] = torch.from_numpy(np.asarray(value).astype(np.int32)).to(device)
    return out


def cache_to_reference(cache: Dict[str, object]) -> Dict[str, object]:
    """The reference's decode-cache layout as numpy: bf16 entries as float32
    (their values, exactly), float32 and int8 entries as they are, the slot
    maps as int32."""
    def array(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out: Dict[str, object] = {key: array(value) for key, value in cache.items() if key != "stages"}
    out["stages"] = [
        {sub: {name: array(t) for name, t in entry.items()} for sub, entry in stage.items()}
        for stage in cache["stages"]
    ]
    return out
