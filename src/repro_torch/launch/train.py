"""Training launcher: --arch selection, restartable, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 100 --ckpt-dir /tmp/ck [--reduced | --full-config] \\
        [--grad-accum 2] [--compress-grads] [--device cpu]

Port of ``repro/launch/train.py``: the same flags and defaults, plus
``--device`` (the card by default; ``cpu`` runs every kernel's plain
PyTorch version).  The reference's loop, like this one, runs the step
without shardings; its multi-host entry (``jax.distributed.initialize``
when ``JAX_COORDINATOR`` is set) has no counterpart in the port, which
runs one process (the single-controller model of ``launch/mesh.py``).
The FSDP/TP shardings of ``sharding/specs.py`` go through the same step
(``train.step.make_jitted_step``'s sharding arguments), and the dry-run
(``launch/dryrun.py``) asks what each position of the production meshes
would hold under them.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.sketch import HLLConfig
from repro_torch.sketch.estimators import DEFAULT_ESTIMATOR, available_estimators
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import TrainConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--sketch-p", type=int, default=14)
    ap.add_argument("--estimator", default=DEFAULT_ESTIMATOR,
                    choices=available_estimators(),
                    help="phase-4 finalizer for the sketch telemetry")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card; "
                         "'cpu' runs every kernel's plain PyTorch version)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()

    cfg = TrainConfig(
        optimizer=OptimizerConfig(
            lr=args.lr,
            warmup_steps=max(1, args.steps // 10),
            total_steps=args.steps,
            compress_grads=args.compress_grads,
        ),
        sketch=HLLConfig(p=args.sketch_p, hash_bits=64),
        sketch_estimator=args.estimator,
        grad_accum=args.grad_accum,
    )
    data = DataConfig(
        vocab_size=arch.vocab_size,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
    )
    loop = LoopConfig(
        total_steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
    )
    return train(arch, cfg, data, loop, device=args.device)


if __name__ == "__main__":
    main()
