"""Train a small LM for a few hundred steps with sketch telemetry on the
datapath -- checkpointed, restartable, on the card.

    PYTHONPATH=src python examples_torch/train_lm.py --steps 200 --arch smollm-360m

The port of ``examples/train_lm.py``.  The --arch flag selects any of the
10 assigned architectures (reduced to a small twin unless --full-config);
loss decreases and the HLL tap reports the distinct-token count of
everything the model has consumed, inside the step.  Kill it mid-run and
rerun: it resumes from the last checkpoint (at most --ckpt-every steps
lost).  As in the reference, a rerun with the same --steps into a
directory that already holds that step trains nothing, and reading its
first logged loss then fails.
"""

import argparse
import os
import tempfile

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.sketch import HLLConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import TrainConfig

# The tap is dispatch.datapath_tap under DEFAULT_PLAN, backend "cuda": one
# hll_update_fused launch a step, and an RWKV6 arch runs the rwkv_intra and
# rwkv_intra_bwd kernels.  Every backend gives bit-identical registers
# (DESIGN.md §3); on a CPU tensor each kernel wrapper runs its plain
# version.


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="use the published size")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs every "
                         "kernel's plain PyTorch version)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if not args.full_config:
        arch = arch.reduced()
    cfg = TrainConfig(
        optimizer=OptimizerConfig(
            lr=args.lr, warmup_steps=20, total_steps=args.steps,
            compress_grads=args.compress_grads,
        ),
        sketch=HLLConfig(p=14, hash_bits=64),
    )
    data = DataConfig(
        vocab_size=arch.vocab_size, global_batch=args.batch, seq_len=args.seq
    )
    loop = LoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, log_every=10,
    )
    print(f"training {args.arch} ({'full' if args.full_config else 'reduced'}) "
          f"for {args.steps} steps; checkpoints -> {args.ckpt_dir}")
    state, history = train(arch, cfg, data, loop, device=args.device)
    first, last = history[0], history[-1]
    print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f} over "
          f"{args.steps} steps; distinct tokens seen ~"
          f"{last['distinct_tokens']:,.0f}")
    return {"state": state, "history": history, "first_loss": first["loss"], "last_loss": last["loss"],
            "distinct_tokens": last["distinct_tokens"]}


if __name__ == "__main__":
    main()
