"""System under test ``count_min``: a ``repro_torch`` CountMinBank of tenant rows.

The window calls ``CountMinBank.update_many`` under the default plan, one
keyed tick a call (``cm_scatter_add`` into the counters, the batch-canonical
Topkapi vote into the labels and votes, and the exact counters'
``bank_row_count``), as the serve path's telemetry board does.
"""

from __future__ import annotations

from repro_torch.sketch import CMConfig, CountMinBank


def open_state(config: dict, device):
    cfg = CMConfig(depth=int(config["depth"]), width=int(config["width"]), seed=int(config["cm_seed"]))
    return CountMinBank.empty(int(config["rows"]), cfg, device)


def call(state, batch: dict):
    return state.update_many(batch["keys"], batch["items"])


def read(state, config: dict):
    raise ValueError("the count_min system has no per-call read")


def outputs(state) -> dict:
    return {"counters": state.counters, "labels": state.labels, "label_counts": state.label_counts,
            "counts": state.counts}
