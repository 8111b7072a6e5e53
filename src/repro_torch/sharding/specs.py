"""Partition rules: FSDP over 'data', TP over 'model', DP over 'pod'.

Port of ``repro/sharding/specs.py``: the same rules under the same names,
over the port's device-list ``Mesh`` (``repro_torch/launch/mesh.py``).

Parameters
  The rules see each stage's weights stacked over its layers, as the
  reference holds them: a leading layer axis that FSDP shards over 'data'
  where it divides (ZeRO-3), else the largest weight dim it divides.
  Tensor-parallel 'model' sharding follows the Megatron pattern:
  column-parallel in-projections, row-parallel out-projections, experts
  over 'model' when the expert count divides it (EP), expert-hidden
  otherwise.  The port keeps one tensor per layer, so the trees given here
  are the reference's stacked shapes (``interop.meta_tree`` of the
  checkpoint's leaves, keyed by their key paths), not the port's per-layer tensors: one spec then
  covers a stage's layers exactly as in the reference.

Activations
  Batch shards over ('pod', 'data'); decode KV caches shard their
  *sequence* axis over 'model' (sequence-parallel flash-decode).

``NamedSharding`` is the port's counterpart of jax's: it checks a shape's
divisibility as jit's ``in_shardings`` do, and cuts a whole tensor into
its per-position shards and joins them back.  The port runs one process
and returns whole tensors to the caller (the single-controller model of
``launch/mesh.py``), so a sharding places a leaf on its mesh's first
device and says what each position would hold.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import Mesh

DATA_AXES = ("pod", "data")  # batch axes (pod may be absent on single-pod)
FSDP_AXIS = "data"
TP_AXIS = "model"


class PartitionSpec(tuple):
    """One entry per dim: None (replicated), an axis name, or a tuple of
    axis names the dim shards over in order.  A one-name tuple is that name,
    as ``jax.sharding.PartitionSpec`` normalizes it."""

    def __new__(cls, *entries):
        def norm(entry):
            if isinstance(entry, (tuple, list)):
                entry = tuple(entry)
                return entry[0] if len(entry) == 1 else entry
            return entry

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: PartitionSpec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in order."""
    return tuple(a for entry in spec for a in _axes(entry))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` over a ``Mesh``."""

    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        object.__setattr__(self, "spec", PartitionSpec(*self.spec))
        used = spec_axes(self.spec)
        unknown = [a for a in used if a not in self.mesh.axis_names]
        if unknown:
            raise ValueError(f"{self.spec} names axes {unknown} not in the mesh's {self.mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"{self.spec} uses a mesh axis twice")

    @property
    def device(self) -> torch.device:
        """Where the caller's whole tensor lives: the mesh's first position."""
        return self.mesh.devices[0]

    def factors(self, ndim: int) -> Tuple[int, ...]:
        """How many shards each of ``ndim`` dims splits into."""
        sizes = self.mesh.shape
        entries = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return tuple(math.prod(sizes[a] for a in _axes(e)) for e in entries)

    def check(self, shape, what: str = "value") -> None:
        """Raise ValueError where jit's ``in_shardings`` would: a spec longer
        than the rank, or a dim its axes do not divide."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(
                f"{what}: sharding {self.spec} is for arrays of rank >= {len(self.spec)}, "
                f"got shape {shape}"
            )
        for dim, factor in enumerate(self.factors(len(shape))):
            if shape[dim] % factor:
                raise ValueError(
                    f"{what}: sharding {self.spec} implies that the global size of its dimension "
                    f"{dim} should be divisible by {factor}, but it is equal to {shape[dim]} "
                    f"(full shape: {shape})"
                )

    def shard_shape(self, shape) -> Tuple[int, ...]:
        self.check(shape)
        return tuple(s // f for s, f in zip(shape, self.factors(len(shape))))

    def shard_factor(self, shape) -> int:
        """Positions that split a whole leaf: its bytes a position are the
        leaf's over this."""
        return math.prod(self.factors(len(tuple(shape))))

    def _blocks(self, ndim: int):
        """For each mesh position, row-major: its block index along each dim."""
        names, sizes = self.mesh.axis_names, self.mesh.axis_sizes
        entries = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        for flat in range(len(self.mesh.devices)):
            coord = {}
            for name, size in zip(reversed(names), reversed(sizes)):
                flat, coord[name] = divmod(flat, size)
            block = []
            for entry in entries:
                index = 0
                for a in _axes(entry):
                    index = index * self.mesh.shape[a] + coord[a]
                block.append(index)
            yield tuple(block)

    def shard(self, tensor: torch.Tensor) -> list:
        """The whole tensor cut into one shard a mesh position, row-major,
        each on its position's device."""
        shape = self.shard_shape(tensor.shape)
        out = []
        for device, block in zip(self.mesh.devices, self._blocks(tensor.dim())):
            piece = tensor
            for dim, (i, size) in enumerate(zip(block, shape)):
                piece = piece.narrow(dim, i * size, size)
            out.append(piece.to(device, copy=True))
        return out

    def unshard(self, shards: Sequence[torch.Tensor]) -> torch.Tensor:
        """The whole tensor, on ``device``, from the shards ``shard`` made."""
        if len(shards) != len(self.mesh.devices):
            raise ValueError(f"{len(shards)} shards for a mesh of {len(self.mesh.devices)} positions")
        first = shards[0]
        factors = self.factors(first.dim())
        whole = torch.empty(tuple(s * f for s, f in zip(first.shape, factors)), dtype=first.dtype,
                            device=self.device)
        for piece, block in zip(shards, self._blocks(first.dim())):
            region = whole
            for dim, i in enumerate(block):
                region = region.narrow(dim, i * first.shape[dim], first.shape[dim])
            region.copy_(piece)
        return whole


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


# ----------------------------------------------------------------------------
# trees: nested dicts (and lists) of leaves under key paths
# ----------------------------------------------------------------------------


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists; any other node is a
    leaf (a tensor, a shape tuple), as ``jax.tree_util.tree_map_with_path``
    sees the reference's trees.  A None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path, tree)


def tree_leaves_with_path(tree, path: tuple = ()) -> list:
    """[(path, leaf)] of a tree, keys in sorted order at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in tree_leaves_with_path(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


# ----------------------------------------------------------------------------
# parameter specs
# ----------------------------------------------------------------------------

# leaf-name -> (tp_dim_from_right_of_unstacked, row_parallel)
_TP_RULES = {
    # attention
    "wq": ("col",),
    "wk": ("col",),
    "wv": ("col",),
    "wo": ("row",),
    "wg": ("col",),
    # swiglu / rwkv channel
    "gate": ("col",),
    "up": ("col",),
    "down": ("row",),
    "wk_cm": ("col",),
    # rglru
    "w_x": ("col",),
    "w_gate": ("col",),
    "w_a": ("col",),
    "w_i": ("col",),
    "w_out": ("row",),
    # rwkv decay lora (d, rank)/(rank, d): keep replicated (tiny)
}


def _add_fsdp(dims: list, shape, data_size: int) -> list:
    """Place the FSDP 'data' axis on the largest free dim it divides.

    Shardings demand exact divisibility (a 22-layer stack cannot shard over
    data=16), so the axis goes to the biggest divisible dim -- usually the
    stacked-layer dim, else a weight matrix dim -- or nowhere.
    """
    candidates = sorted(
        (i for i in range(len(dims)) if dims[i] is None),
        key=lambda i: -shape[i],
    )
    for i in candidates:
        if shape[i] % data_size == 0 and shape[i] >= data_size:
            dims[i] = FSDP_AXIS
            break
    return dims


def _param_spec(path: Tuple, leaf, arch: ArchConfig, data_size: int, model_size: int) -> PartitionSpec:
    names = [str(p) for p in path]
    leaf_name = names[-1]
    shape = _shape(leaf)
    ndim = len(shape)
    dims: list = [None] * ndim

    def tp(dim_idx: int):
        """Apply TP to a dim if it divides the model axis."""
        if shape[dim_idx] % model_size == 0 and shape[dim_idx] >= model_size:
            dims[dim_idx] = TP_AXIS

    if leaf_name == "embed":
        tp(0)  # vocab-parallel
        return P(*dims)
    if leaf_name == "lm_head":
        tp(1)
        return P(*dims)
    if ndim <= 1:
        return P(*dims)

    stacked = any(n.startswith("stage") for n in names)
    off = 1 if stacked else 0
    inner = ndim - off
    moe = arch.moe
    in_moe = moe is not None and leaf_name in ("gate", "up", "down", "router")

    if in_moe and leaf_name != "router" and inner == 3:
        if moe.sharding == "ep" and moe.num_experts % model_size == 0:
            tp(off + 0)  # experts over 'model' (EP)
        elif leaf_name == "down":  # (E, f, d): expert-hidden TP
            tp(off + 1)
        else:  # (E, d, f)
            tp(off + 2)
    elif not in_moe:
        rule = _TP_RULES.get(leaf_name)
        if rule and inner == 2:
            tp(off + (1 if rule[0] == "col" else 0))

    return P(*_add_fsdp(dims, shape, data_size))


def param_specs(params_tree, arch: ArchConfig, data_size: int = 16, model_size: int = 16):
    """PartitionSpec tree matching the reference-shaped parameter tree
    (``interop.meta_tree(interop.param_leaves(model))``, or
    ``transformer.param_shapes(arch)``)."""
    return tree_map_with_path(
        lambda path, leaf: _param_spec(path, leaf, arch, data_size, model_size),
        params_tree,
    )


def param_shardings(params_tree, arch: ArchConfig, mesh: Mesh):
    specs = param_specs(
        params_tree, arch,
        data_size=mesh.shape.get(FSDP_AXIS, 1),
        model_size=mesh.shape.get(TP_AXIS, 1),
    )
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), specs)


# ----------------------------------------------------------------------------
# batch / cache specs
# ----------------------------------------------------------------------------


def _batch_dim(mesh: Mesh, global_batch: int):
    dp = data_axes(mesh)
    n_dp = math.prod(mesh.shape[a] for a in dp)
    return dp if global_batch % n_dp == 0 else None  # tiny batches replicate


def batch_spec(arch: ArchConfig, mesh: Mesh, global_batch: int, key: str) -> PartitionSpec:
    bdim = _batch_dim(mesh, global_batch)
    if key == "positions" and arch.mrope:
        return P(None, bdim, None)
    if key == "frontend_embeds":
        return P(bdim, None, None)
    if key in ("token", "pos_scalar"):
        return P(bdim) if key == "token" else P()
    return P(bdim, None)  # tokens / targets / positions (B, S)


def batch_specs(arch: ArchConfig, mesh: Mesh, global_batch: int, batch_tree):
    return {k: batch_spec(arch, mesh, global_batch, k) for k in batch_tree}


def cache_specs(cache_tree, arch: ArchConfig, mesh: Mesh, global_batch: int):
    """Decode-cache specs: batch over data axes, KV sequence over 'model'.

    Every placement is divisibility-checked; when a preferred dim does not
    divide, the next candidate dim is tried, else that dim stays replicated.
    """
    bdim = _batch_dim(mesh, global_batch)
    tp_size = mesh.shape.get(TP_AXIS, 1)

    def spec(path, leaf):
        leaf_name = str(path[-1])
        shape = _shape(leaf)
        if leaf_name.startswith("kv_pos"):
            return P(None)

        def tp_first(dims, candidates):
            for c in candidates:
                if shape[c] % tp_size == 0 and shape[c] >= tp_size:
                    dims[c] = TP_AXIS
                    return dims
            return dims

        if leaf_name in ("k", "v"):  # (L, B, W, Hkv, hd): seq over model
            return P(*tp_first([None, bdim, None, None, None], [2, 4]))
        if leaf_name in ("k_scale", "v_scale"):  # (L, B, W, Hkv, 1)
            return P(*tp_first([None, bdim, None, None, None], [2]))
        if leaf_name == "s":  # rwkv state (L, B, H, N, N)
            return P(*tp_first([None, bdim, None, None, None], [2, 3]))  # heads, else key-dim
        if leaf_name == "conv":  # (L, B, w-1, d)
            return P(*tp_first([None, bdim, None, None], [3]))
        if leaf_name == "h":  # (L, B, d)
            return P(*tp_first([None, bdim, None], [2]))
        if leaf_name in ("x_prev", "cm_x_prev"):  # (L, B, d) replicated d
            return P(None, bdim, None)
        return P(*([None] * len(shape)))

    return tree_map_with_path(spec, cache_tree)


def at_path(tree, path):
    """The node of ``tree`` at ``path``; None where a node on the way is None
    (an unconstrained subtree)."""
    for key in path:
        if tree is None:
            return None
        tree = tree[key]
    return tree


def check_tree(tree, shardings, what: str = "") -> None:
    """Check every leaf of ``tree`` against the ``NamedSharding`` at its path
    in ``shardings`` (None: unconstrained), as jit's ``in_shardings`` check
    their arguments."""
    for path, leaf in tree_leaves_with_path(tree):
        sharding = at_path(shardings, path)
        if sharding is not None:
            sharding.check(_shape(leaf), f"{what}{keystr(path)}")


def canonical_device(device) -> torch.device:
    """``device`` with the current card's index where it names none
    (``cuda`` and ``cuda:0`` are one device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def tree_device(shardings) -> torch.device:
    """The one device the ``NamedSharding``s of a tree place whole tensors on."""
    devices = {canonical_device(leaf.device) for _, leaf in tree_leaves_with_path(shardings)}
    if len(devices) != 1:
        raise ValueError(f"shardings over {len(devices)} devices: {sorted(map(str, devices))}")
    return devices.pop()


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and list indices."""
    return "".join(f"[{key!r}]" for key in path)


def named(tree, mesh: Mesh):
    """Each spec of ``tree`` as a ``NamedSharding`` over ``mesh``."""
    return tree_map_with_path(lambda _, spec: NamedSharding(mesh, spec), tree)


def sharded_bytes(tree, shardings: Optional[dict] = None) -> int:
    """Bytes a mesh position holds of ``tree``'s leaves (tensors, meta or
    not): each leaf's bytes over its sharding's shard factor."""
    total = 0
    for path, leaf in tree_leaves_with_path(tree):
        sharding = at_path(shardings, path)
        factor = 1 if sharding is None else sharding.shard_factor(leaf.shape)
        total += leaf.numel() * leaf.element_size() // factor
    return total
