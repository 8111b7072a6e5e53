"""Checkpoint/restart with async writes, in the reference's on-disk format.

Port of ``repro/checkpoint/ckpt.py``.  Format, as the reference writes it:
one directory per step -- ``step_<n>/leaf_<i>.npy`` + ``manifest.json``
(step; per leaf its index, keypath, shape and dtype) -- written to
``.tmp_step_<n>`` and renamed into place, so a crash mid-write can never
corrupt the latest checkpoint.  The leaves are the reference's training
state tree (``interop.train_state_leaves``): each stage's layers stacked as
the reference holds them, under ``jax.tree_util.keystr``'s keypaths (for
example ``['opt']['mu']['stage0']['sub0']['mixer']['wq']``), in its
flatten order, so either package restores the other's directory.

Fault-tolerance contract used by train/loop.py:
  * save every N steps (async: the host copy is snapshotted synchronously,
    the disk write happens on a worker thread; the step loop never blocks
    on I/O),
  * on (re)start, ``latest_step`` + ``restore`` resume params, optimizer,
    data cursor and sketch -- a preempted job loses at most N steps.

``restore`` is template-based, as the reference's: the caller supplies the
live state (from ``init_train_state``) and each leaf is copied into its
tensors in place, on their devices -- or, with ``shardings``, on the
device the shardings place whole tensors on (the elastic-resume path onto
another mesh), each leaf first checked against its sharding.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import interop
from repro_torch.sharding import specs as shardspecs


def save(state: dict, directory: str, step: int, async_write: bool = False):
    """Checkpoint a training state. Returns a join() handle when async."""
    host_leaves = [(shardspecs.keystr(path), interop.leaf_array(tensors, stacked))
                   for path, tensors, stacked in interop.train_state_leaves(state)]

    def write():
        tmp = os.path.join(directory, f".tmp_step_{step}")
        final = os.path.join(directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (keypath, arr) in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            manifest["leaves"].append(
                {"i": i, "key": keypath, "shape": list(arr.shape), "dtype": str(arr.dtype)}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_", 1)[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None


def _place(state: dict, device: torch.device) -> None:
    """Move every tensor of a training state to ``device``, in place of the
    old ones (the model's parameters keep their ``Parameter`` objects)."""
    state["params"].to(device)
    opt = state["opt"]
    for name in ("mu", "nu", "ef"):
        if opt.get(name) is not None:
            opt[name] = {k: v.to(device) for k, v in opt[name].items()}
    opt["count"] = opt["count"].to(device)
    state["step"] = state["step"].to(device)
    state["sketch"] = state["sketch"].to(device)


def restore(template: dict, directory: str, step: int, shardings=None) -> dict:
    """Load ``step`` into the tensors of ``template`` (in place); returns it.

    ``shardings``: an optional tree of ``NamedSharding``s shaped like the
    reference's state (``specs.named`` of its specs; None where
    unconstrained).  Each leaf is checked against its sharding -- ValueError
    where the reference's ``device_put`` raises -- and the state is placed
    on the shardings' device, which may differ from the template's."""
    final = os.path.join(directory, f"step_{step}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)

    leaves = interop.train_state_leaves(template)
    if len(manifest["leaves"]) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, template has "
            f"{len(leaves)} -- incompatible structures"
        )
    by_key = {m["key"]: m for m in manifest["leaves"]}

    loaded = []
    for path, tensors, stacked in leaves:
        key = shardspecs.keystr(path)
        meta = by_key.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(final, f"leaf_{meta['i']}.npy"))
        shape = ((len(tensors),) if stacked else ()) + tuple(tensors[0].shape)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != template {shape}")
        sharding = shardspecs.at_path(shardings, path)
        if sharding is not None:
            sharding.check(arr.shape, key)
        loaded.append((arr, tensors, stacked))
    if shardings is not None:
        _place(template, shardspecs.tree_device(shardings))
        loaded = [(arr, tensors, stacked) for (arr, _, _), (_, tensors, stacked)
                  in zip(loaded, interop.train_state_leaves(template))]
    with torch.no_grad():
        for arr, tensors, stacked in loaded:
            for t, a in zip(tensors, arr if stacked else [arr]):
                t.copy_(torch.from_numpy(np.array(a)))
    return template
