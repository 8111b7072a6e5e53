"""The port's one launch path and its one table of kernels, on the CPU.

Every CUDA launch of a kernel wrapper goes through
``repro_torch.kernels._build.launch``: the C launcher on PyTorch's current
stream under the device's guard, a refused launch raised, then the
kernel's cost declared to ``repro_torch.obs.costs`` and the launch counted
under the kernel's name (``launch_counts``).  With the library lookup, the
device guard and the stream stubbed, the protocol runs here for every name
of ``KERNELS``; the table itself is held to ``csrc/`` and the wrappers.
"""

import contextlib
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import KERNELS, _build, launch_counts, reset_launches, wrappers
from repro_torch.obs import costs

ROOT = Path(__file__).resolve().parents[1]
STREAM = 0x5EED


class _Collector:
    def __init__(self):
        self.kernels = []

    def on_kernel(self, name, flops, nbytes):
        self.kernels.append((name, flops, nbytes))

    def on_collective(self, kind, nbytes):
        raise AssertionError("a kernel launch declared a collective")


class _Lib:
    @staticmethod
    def repro_error_string(error):
        return b"stubbed refusal"


@pytest.fixture
def launcher(monkeypatch):
    """Stubs for ``_build.launch``'s library lookup, device guard and stream:
    the launcher records (lib, symbol, args, inside the guard) and returns
    ``state["error"]``."""
    state = {"error": 0, "calls": [], "guarded": None}

    def function(lib, symbol, argtypes):
        def launch(*args):
            state["calls"].append((lib, symbol, args, state["guarded"]))
            return state["error"]

        return launch

    @contextlib.contextmanager
    def device_guard(device):
        state["guarded"] = device
        try:
            yield
        finally:
            state["guarded"] = None

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream", lambda device: STREAM)
    monkeypatch.setattr(torch.cuda, "device", device_guard)
    for kernel in KERNELS.values():
        monkeypatch.setitem(_build._LIBS, kernel.source, _Lib())
    reset_launches()
    yield state
    reset_launches()


@pytest.mark.parametrize("name", list(KERNELS))
def test_a_launch_counts_once_and_declares_its_cost_once_and_a_refused_one_neither(launcher, name):
    lib = KERNELS[name].source
    device = torch.device("cuda", 0)
    flops, nbytes = 3 * len(name), 1 << len(name)

    def launch():
        _build.launch(name, lib, f"{lib}_launch", [], device, (11, 22), flops, nbytes)

    with costs.collecting(_Collector()) as seen:
        launch()
    assert launcher["calls"] == [(lib, f"{lib}_launch", (11, 22, STREAM), device)]
    assert seen.kernels == [(name, flops, nbytes)]
    assert launch_counts() == {other: int(other == name) for other in KERNELS}

    launcher["error"] = 700
    with costs.collecting(_Collector()) as seen:
        with pytest.raises(RuntimeError, match=rf"^{name}: CUDA error 700 \(stubbed refusal\)$"):
            launch()
    assert len(launcher["calls"]) == 2
    assert seen.kernels == []
    assert launch_counts()[name] == 1


def test_the_kernel_table_names_every_source_wrapper_and_replaced_entry():
    assert sorted({kernel.source for kernel in KERNELS.values()}) == list(_build.SOURCES)
    assert len(_build.SOURCES) == 12 and len(KERNELS) == 14
    for name, fn in wrappers().items():
        assert fn.__name__ == KERNELS[name].wrapper == name
        assert not hasattr(fn, "launches"), name
        assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / f"{KERNELS[name].source}.cu").is_file()
        replaced = KERNELS[name].replaces.split(":")[0]
        assert replaced.startswith("src/repro/") and (ROOT / replaced).is_file(), name
