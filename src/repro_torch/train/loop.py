"""Training loop: restartable, with async checkpoints + HLL telemetry.

Port of ``repro/train/loop.py``.  A lost worker kills the step; recovery is
restart-from-latest (at most ``ckpt_every`` steps lost).  The data pipeline
is a pure function of the step index, so a restarted job consumes exactly
the remaining stream -- and the HLL sketch, being a max-lattice, is immune
to the replayed boundary batch (re-aggregating a batch is a no-op).

The loop runs on ``device`` (the card unless the caller asks for the CPU):
the weights are drawn there from ``torch.Generator(device).manual_seed(seed)``
(``init_state``), each step's batch is made there, and each step ends in a
read of its loss, which waits for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, batch_at_step
from repro_torch.obs.tracing import Stopwatch
from repro_torch.sketch import estimators
from repro_torch.sketch.hll import resolve_device
from repro_torch.train.step import TrainConfig, init_train_state, make_jitted_step
from repro_torch.train.watchdog import StepWatchdog, Verdict


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    async_ckpt: bool = True
    log_every: int = 10


def init_state(arch: ArchConfig, train_cfg: TrainConfig, seed: int, device: torch.device) -> dict:
    """The loop's fresh state: weights drawn from ``seed`` on ``device``."""
    return init_train_state(torch.Generator(device=device).manual_seed(seed), arch, train_cfg, device)


def train(
    arch: ArchConfig,
    train_cfg: TrainConfig,
    data_cfg: DataConfig,
    loop_cfg: LoopConfig,
    seed: int = 0,
    log_fn: Callable[[str], None] = print,
    device=None,
):
    """Run (or resume) training; returns (final_state, history)."""
    device = resolve_device(device)
    state = init_state(arch, train_cfg, seed, device)

    start = 0
    pending_write = None
    if loop_cfg.ckpt_dir:
        last = ckpt.latest_step(loop_cfg.ckpt_dir)
        if last is not None:
            state = ckpt.restore(state, loop_cfg.ckpt_dir, last)
            start = int(state["step"])
            log_fn(f"[loop] resumed from step {start}")

    step_fn = make_jitted_step(arch, train_cfg)
    watchdog = StepWatchdog()
    history = []
    wall = Stopwatch()
    wall.start()
    for step in range(start, loop_cfg.total_steps):
        watchdog.step_begin()  # the window covers the batch's making too
        batch = batch_at_step(data_cfg, step, device)
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])  # waits for the step
        verdict = watchdog.step_end()
        if verdict is not Verdict.OK and loop_cfg.ckpt_dir:
            # straggler policy: snapshot immediately so a restart loses
            # nothing; a WEDGED verdict in production also aborts the job
            # for the cluster manager to reschedule.
            log_fn(f"[watchdog] step {step + 1}: {verdict.value} "
                   f"(deadline {watchdog.deadline_s():.1f}s) — snapshotting")
            if pending_write is not None:
                pending_write.join()
            pending_write = ckpt.save(
                state, loop_cfg.ckpt_dir, step + 1,
                async_write=loop_cfg.async_ckpt,
            )
        if (step + 1) % loop_cfg.log_every == 0 or step + 1 == loop_cfg.total_steps:
            m = {k: float(v) for k, v in metrics.items()}
            dt = wall.elapsed() / (step - start + 1)
            history.append({"step": step + 1, **m})
            log_fn(
                f"[step {step + 1:5d}] loss={m['loss']:.4f} "
                f"nll={m['nll']:.4f} lr={m['lr']:.2e} "
                f"distinct={m['distinct_tokens']:.0f} "
                f"({dt * 1e3:.0f} ms/step)"
            )
        if loop_cfg.ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0:
            if pending_write is not None:
                pending_write.join()
            pending_write = ckpt.save(
                state, loop_cfg.ckpt_dir, step + 1,
                async_write=loop_cfg.async_ckpt,
            )
    if pending_write is not None:
        pending_write.join()
    if loop_cfg.ckpt_dir:
        ckpt.save(state, loop_cfg.ckpt_dir, loop_cfg.total_steps)

    # exact host-side sketch finalization (paper phase 4), dispatched
    # through the estimator registry
    distinct = estimators.estimate(
        state["sketch"], train_cfg.sketch,
        estimator=train_cfg.sketch_estimator,
    )
    log_fn(
        f"[loop] exact-finalized distinct-token estimate "
        f"({train_cfg.sketch_estimator}): {distinct:.0f}"
    )
    return state, history
