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
tensors in place, on their devices.
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


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{key!r}]" for key in path)


def save(state: dict, directory: str, step: int, async_write: bool = False):
    """Checkpoint a training state. Returns a join() handle when async."""
    host_leaves = [(_keystr(path), interop.leaf_array(tensors, stacked))
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


def restore(template: dict, directory: str, step: int) -> dict:
    """Load ``step`` into the tensors of ``template`` (in place); returns it."""
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
        key = _keystr(path)
        meta = by_key.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(final, f"leaf_{meta['i']}.npy"))
        shape = ((len(tensors),) if stacked else ()) + tuple(tensors[0].shape)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != template {shape}")
        loaded.append((arr, tensors, stacked))
    with torch.no_grad():
        for arr, tensors, stacked in loaded:
            for t, a in zip(tensors, arr if stacked else [arr]):
                t.copy_(torch.from_numpy(np.array(a)))
    return template
