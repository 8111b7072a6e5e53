"""The comparison that decides ``correct`` fails where it must.

The control (the reference one precision below the configuration, put in
the program's place) and each fault a cell can have, planted in the timed
path underneath a whole run: a call that returns its state unchanged, half
of each batch left out, an answer altered where it is produced, and a call
that is sound through the first pass of the pool and, after it, counts
every item but lands only half of them in the registers (which a check of
the first pass alone would miss, since a register max of items it has
seen changes nothing).  (No cell
spans cards, so none has an exchange between chips to leave out.)  The CPU
runs at small sizes; the ``gpu`` tests run every cell at its own size.
"""

import dataclasses

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import WORKLOADS, small_cell

CPU = torch.device("cpu")
# the small cells' pools hold 16 batches; the warm-up takes 2 calls, so the
# fault starts in the window's second pass
LATE_AFTER = 2 + 16 + 3


def _run(workload, seconds=0.05, control=False, device=CPU, cell=None):
    return harness.run_cell(cell or small_cell(workload), 2**31 + 41, seconds, False, device, 0.0, control=control)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_program_passes(workload):
    result = _run(workload, control=True)
    assert result["correct"] is True
    correct, checks = harness.judge(result["control"], small_cell(workload).config["limits"])
    assert not correct
    assert checks["registers_differ"]["value"] > 0


def _stream_faults():
    from repro_torch.sketch.carrier import HyperLogLog

    update = HyperLogLog.update

    def unchanged(self, items, plan=None):
        return self

    def half(self, items, plan=None):
        flat = items.reshape(-1)
        return update(self, flat[: flat.numel() // 2], plan)

    def altered(self, items, plan=None):
        out = update(self, items, plan)
        regs = out.registers.clone()
        regs[0] += 1
        return dataclasses.replace(out, registers=regs)

    def registers_half(self, items, plan=None):
        return dataclasses.replace(half(self, items, plan), n_items=update(self, items, plan).n_items)

    return HyperLogLog, "update", {"unchanged": unchanged, "half": half, "altered": altered,
                                   "late": _late(update, registers_half)}


def _bank_faults():
    from repro_torch.sketch.bank import SketchBank

    update_many = SketchBank.update_many

    def unchanged(self, keys, items, plan=None):
        return self

    def half(self, keys, items, plan=None):
        n = keys.numel() // 2
        return update_many(self, keys.reshape(-1)[:n], items.reshape(-1)[:n], plan)

    def altered(self, keys, items, plan=None):
        out = update_many(self, keys, items, plan)
        regs = out.registers.clone()
        regs[0, 0] += 1
        return dataclasses.replace(out, registers=regs)

    def registers_half(self, keys, items, plan=None):
        return dataclasses.replace(half(self, keys, items, plan), n_items=update_many(self, keys, items, plan).n_items)

    return SketchBank, "update_many", {"unchanged": unchanged, "half": half, "altered": altered,
                                       "late": _late(update_many, registers_half)}


def _late(sound, fault, after=LATE_AFTER):
    """``sound`` for the first ``after`` calls, ``fault`` from then on."""
    calls = [0]

    def late(*args, **kwargs):
        calls[0] += 1
        return (sound if calls[0] <= after else fault)(*args, **kwargs)

    return late


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "late"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    owner, name, faults = _stream_faults() if workload.startswith("nic_stream") else _bank_faults()
    monkeypatch.setattr(owner, name, faults[fault])
    result = _run(workload, seconds=0.5 if fault == "late" else 0.05)
    assert len(harness.poollib.make(small_cell(workload).config, small_cell(workload).traffic, 1, CPU)) == 16
    if fault == "late":
        assert result["attempted"] > LATE_AFTER
        checks = result["checks"]
        assert checks["registers_differ"]["value"] > 0
        assert checks.get("count_gap", checks.get("counter_rows_differ"))["value"] == 0
    assert result["correct"] is False and result["failed"] == result["attempted"]


def test_an_altered_estimate_is_not_correct(monkeypatch):
    from repro_torch.sketch.bank import SketchBank

    estimate_many = SketchBank.estimate_many

    def altered(self, estimator=None, plan=None):
        est = estimate_many(self, estimator, plan).clone()
        est[0] = est[0] * 1.001 + 1.0
        return est

    monkeypatch.setattr(SketchBank, "estimate_many", altered)
    result = _run("tenant_fleet.dashboard")
    assert result["correct"] is False
    assert result["checks"]["estimate_rel_gap"]["value"] > result["checks"]["estimate_rel_gap"]["limit"]
    assert result["checks"]["registers_differ"]["value"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_at_its_own_size_on_the_card(workload, card):
    result = _run(workload, seconds=1.0, control=True, device=card, cell=harness.load_cell(workload))
    assert result["correct"] is True, result["checks"]
    assert not harness.judge(result["control"], harness.load_cell(workload).config["limits"])[0]
