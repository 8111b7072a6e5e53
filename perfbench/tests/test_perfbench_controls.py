"""The comparison that decides ``correct`` fails where it must.

The control (the reference one precision below the configuration, put in
the program's place) and each fault a cell can have, planted in the timed
path underneath a whole run: a call that returns its state unchanged, half
of each batch left out, an answer altered where it is produced, and a call
that is sound through the first pass of the pool and, after it, turns to
the system's late fault (for today's systems: every item counted, only half
of them landed in the registers, which a check of the first pass alone
would miss, since a register max of items it has seen changes nothing); in
a cell that reads each call, a read with an answer altered.  Each system's
faults, and what each must show, are its hooks (``faults/<system>.py``).
(No cell spans cards, so none has an exchange between chips to leave out.)
The CPU runs at small sizes; the ``gpu`` tests run every cell at its own
size.
"""

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import WORKLOADS, hooks, small_cell

CPU = torch.device("cpu")
READS = [w for w in WORKLOADS if small_cell(w).traffic.get("read_each_call")]


def _run(workload, seconds=0.05, control=False, device=CPU, cell=None):
    return harness.run_cell(cell or small_cell(workload), 2**31 + 41, seconds, False, device, 0.0, control=control)


def _late_after(cell) -> int:
    """Calls of the port before the late fault: the warm-up's, a whole pass of
    the pool, and 3 more, so that the fault starts in the window's second pass."""
    return harness.WARM_CALLS + harness.poollib.batches_of(cell.traffic) + 3


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_program_passes(workload):
    cell = small_cell(workload)
    result = _run(workload, control=True)
    assert result["correct"] is True
    correct, checks = harness.judge(result["control"], cell.config["limits"])
    assert not correct
    for name in hooks(cell.config["system"]).CONTROL_FAILS:
        assert checks[name]["value"] > checks[name]["limit"]


def _late(sound, fault, after):
    """``sound`` for the first ``after`` calls, ``fault`` from then on."""
    calls = [0]

    def late(*args, **kwargs):
        calls[0] += 1
        return (sound if calls[0] <= after else fault)(*args, **kwargs)

    return late


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "late"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    cell = small_cell(workload)
    system = hooks(cell.config["system"])
    owner, name, faults = system.faults()
    after = _late_after(cell)
    planted = _late(getattr(owner, name), faults["late"], after) if fault == "late" else faults[fault]
    monkeypatch.setattr(owner, name, planted)
    result = _run(workload, seconds=0.5 if fault == "late" else 0.05)
    assert len(harness.poollib.make(cell.config, cell.traffic, 1, CPU)) == harness.poollib.batches_of(cell.traffic)
    if fault == "late":
        assert result["attempted"] > after
        system.late_shows(result["checks"])
    assert result["correct"] is False and result["failed"] == result["attempted"]


@pytest.mark.parametrize("workload", READS)
def test_an_altered_estimate_is_not_correct(workload, monkeypatch):
    system = hooks(small_cell(workload).config["system"])
    owner, name, altered = system.altered_read()
    monkeypatch.setattr(owner, name, altered)
    result = _run(workload)
    assert result["correct"] is False
    system.altered_read_shows(result["checks"])


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_at_its_own_size_on_the_card(workload, card):
    result = _run(workload, seconds=1.0, control=True, device=card, cell=harness.load_cell(workload))
    assert result["correct"] is True, result["checks"]
    assert not harness.judge(result["control"], harness.load_cell(workload).config["limits"])[0]
