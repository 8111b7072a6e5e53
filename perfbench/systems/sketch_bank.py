"""System under test ``sketch_bank``: a ``repro_torch`` SketchBank of tenant rows.

The window calls ``SketchBank.update_many`` under the default plan, one
keyed tick a call (``hash_rank``, then ``bank_scatter_max``, and the exact
counters' ``bank_row_count``); a closed-loop mix reads every row's estimate
to the host after each tick (``SketchBank.estimate_many``, then ``.cpu()``).
"""

from __future__ import annotations

from repro_torch.sketch import HLLConfig, SketchBank


def open_state(config: dict, device):
    cfg = HLLConfig(p=int(config["p"]), hash_bits=int(config["hash_bits"]), seed=int(config["hash_seed"]))
    return SketchBank.empty(int(config["rows"]), cfg, device)


def call(state, batch: dict):
    return state.update_many(batch["keys"], batch["items"])


def read(state, config: dict):
    return state.estimate_many(config["estimator"]).cpu()


def outputs(state) -> dict:
    return {"registers": state.registers, "counts": state.counts}
