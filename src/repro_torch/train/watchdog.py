"""Straggler / hang mitigation for synchronous training.

Port of ``repro/train/watchdog.py``.  In a synchronous job one slow or
wedged worker stalls every step.  The mitigation layers:

  1. DETECT -- ``StepWatchdog`` tracks a robust running estimate of step
     time (median + MAD) and flags steps beyond ``k_mad`` deviations; a
     hard ``timeout_factor`` classifies a wedge.
  2. BOUND THE BLAST RADIUS -- steps are small quanta and checkpoints are
     cheap and async (checkpoint/ckpt.py), so a restart loses at most
     ckpt_every steps.
  3. RECOVER -- the loop's policy says what to do: keep going
     (transient), snapshot now (degrading), or abort-for-restart (wedged;
     train/loop.py resumes from the latest checkpoint, and the step-indexed
     data pipeline replays exactly the lost steps).  The HLL sketch is
     replay-immune by construction.

The step time is the host's wall clock around a step that ends in a
synchronizing read (the loop reads the loss), so it is the device's time
too.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

from repro_torch.obs.tracing import Stopwatch


class Verdict(enum.Enum):
    OK = "ok"
    SLOW = "slow"  # straggling: snapshot soon
    WEDGED = "wedged"  # abort and restart from checkpoint


@dataclasses.dataclass
class StepWatchdog:
    """Robust step-time anomaly detector (median + MAD)."""

    warmup_steps: int = 5  # first steps (kernel builds, allocator growth) excluded from stats
    k_mad: float = 6.0  # SLOW threshold: median + k * MAD
    timeout_factor: float = 10.0  # WEDGED threshold: factor over median
    min_timeout_s: float = 1.0

    _durations: List[float] = dataclasses.field(default_factory=list)
    _watch: Stopwatch = dataclasses.field(default_factory=Stopwatch)
    slow_count: int = 0
    wedged_count: int = 0

    def step_begin(self) -> None:
        self._watch.start()

    def _stats(self):
        xs = sorted(self._durations)
        n = len(xs)
        med = xs[n // 2]
        mad = sorted(abs(x - med) for x in xs)[n // 2]
        return med, max(mad, med * 0.01)

    def step_end(self) -> Verdict:
        assert self._watch.running, "step_begin not called"
        dt = self._watch.stop()

        if len(self._durations) < self.warmup_steps:
            self._durations.append(dt)
            return Verdict.OK

        med, mad = self._stats()
        verdict = Verdict.OK
        if dt > max(self.timeout_factor * med, self.min_timeout_s):
            self.wedged_count += 1
            verdict = Verdict.WEDGED
        elif dt > med + self.k_mad * mad:
            self.slow_count += 1
            verdict = Verdict.SLOW
        else:
            # only healthy steps update the baseline (stragglers must not
            # poison the estimate)
            self._durations.append(dt)
            if len(self._durations) > 256:
                self._durations.pop(0)
        return verdict

    def deadline_s(self) -> float:
        """Current hard-timeout for external watchers (collective timeout)."""
        if len(self._durations) < self.warmup_steps:
            return float("inf")
        med, _ = self._stats()
        return max(self.timeout_factor * med, self.min_timeout_s)
