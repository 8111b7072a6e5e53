"""Test hooks of the ``hll_stream`` system: faults planted in ``HyperLogLog.update``."""

import dataclasses

CONTROL_FAILS = ("registers_differ",)


def faults():
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
                                   "late": registers_half}


def late_shows(checks):
    """Every item counted, half of them in the registers."""
    assert checks["registers_differ"]["value"] > 0
    assert checks["count_gap"]["value"] == 0
