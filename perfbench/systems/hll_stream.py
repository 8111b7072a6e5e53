"""System under test ``hll_stream``: one ``repro_torch`` HyperLogLog fed chunks.

The window calls ``HyperLogLog.update`` under the default plan (the fused
``hll_update_fused`` kernel on the card), one chunk a call.
"""

from __future__ import annotations

from repro_torch.sketch import HLLConfig, HyperLogLog


def open_state(config: dict, device):
    cfg = HLLConfig(p=int(config["p"]), hash_bits=int(config["hash_bits"]), seed=int(config["hash_seed"]))
    return HyperLogLog.empty(cfg, device)


def call(state, batch: dict):
    return state.update(batch["items"])


def read(state, config: dict):
    raise ValueError("the hll_stream system has no per-call read")


def outputs(state) -> dict:
    return {"registers": state.registers, "count": state.count}
