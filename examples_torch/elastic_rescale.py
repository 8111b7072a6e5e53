"""Elastic rescale demo: train, checkpoint, resume on a different topology.

    PYTHONPATH=src python examples_torch/elastic_rescale.py [--device cpu]

The port of ``examples/elastic_rescale.py``: phase 1 trains N steps and
checkpoints; phase 2 'loses half the fleet' -- the same checkpoint resumes
onto a different mesh layout with every array placed by its sharding on
restore (checkpoint/ckpt.py), the step-indexed data pipeline continues
exactly where it left off, and the HLL sketch registers survive verbatim
(a max-lattice cannot be corrupted by topology changes or replayed
batches).  The mesh is the process's devices (every visible card, or the
one CPU); the port runs one process and places whole tensors on the
mesh's first device (``repro_torch.sharding.specs``).
"""

import argparse
import shutil
import tempfile

import numpy as np

from repro_torch import interop
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import local_devices, make_auto_mesh
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.sharding.specs import NamedSharding, PartitionSpec, tree_map_with_path
from repro_torch.sketch import HLLConfig, estimate
from repro_torch.sketch.hll import resolve_device
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import TrainConfig

# The tap is dispatch.datapath_tap under DEFAULT_PLAN, backend "cuda": one
# hll_update_fused launch a step.  Every backend gives bit-identical
# registers (DESIGN.md §3); on a CPU tensor each kernel wrapper runs its
# plain version.


def rescale(first: int = 20, total: int = 40, device=None) -> dict:
    """Train to ``first`` and checkpoint, restore with explicit shardings,
    train on to ``total``."""
    device = resolve_device(device)
    arch = get_arch("smollm-360m").reduced()
    cfg = TrainConfig(
        optimizer=OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=total),
        sketch=HLLConfig(p=10, hash_bits=64),
    )
    data = DataConfig(vocab_size=arch.vocab_size, global_batch=4, seq_len=64)
    d = tempfile.mkdtemp(prefix="repro_elastic_")
    try:
        print(f"=== phase 1: 'big mesh' — {first} steps, checkpoint at {first}")
        loop1 = LoopConfig(total_steps=first, ckpt_every=first, ckpt_dir=d,
                           async_ckpt=False, log_every=10)
        state1, _ = train(arch, cfg, data, loop1, device=device)
        sketch_before = state1["sketch"].cpu().numpy()

        print("\n=== phase 2: fleet rescaled — resume from the checkpoint "
              f"onto a different device layout, continue to step {total}")
        devices = local_devices(device)
        mesh = make_auto_mesh((len(devices),), ("data",), devices)
        # restore with explicit (re)shardings: the elastic path; the tree
        # has the reference's state's shape (each stage's layers stacked)
        template = state1
        shardings = tree_map_with_path(
            lambda _, leaf: NamedSharding(mesh, PartitionSpec()),
            interop.meta_tree(interop.train_state_leaves(template)),
        )
        restored = ckpt.restore(template, d, first, shardings=shardings)
        sketch_restored = restored["sketch"].cpu().numpy()
        np.testing.assert_array_equal(sketch_restored, sketch_before)
        print("sketch registers survived resharding bit-exactly")

        loop2 = LoopConfig(total_steps=total, ckpt_every=total, ckpt_dir=d,
                           async_ckpt=False, log_every=10)
        state2, _ = train(arch, cfg, data, loop2, device=device)
        est = estimate(state2["sketch"], cfg.sketch,
                       estimator=cfg.sketch_estimator)
        print(f"\nresumed to step {int(state2['step'])}; distinct tokens "
              f"seen across BOTH topologies: {est:,.0f}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"sketch_before": sketch_before, "sketch_restored": sketch_restored, "restored": restored,
            "shardings": shardings, "state": state2, "step": int(state2["step"]), "estimate": est}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs every "
                         "kernel's plain PyTorch version)")
    args = ap.parse_args(argv)
    return rescale(device=args.device)


if __name__ == "__main__":
    main()
