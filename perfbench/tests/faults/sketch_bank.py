"""Test hooks of the ``sketch_bank`` system: faults planted in
``SketchBank.update_many``, and an estimate altered in ``estimate_many``."""

import dataclasses

CONTROL_FAILS = ("registers_differ",)


def faults():
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
                                       "late": registers_half}


def late_shows(checks):
    """Every entry counted, half of them in the registers."""
    assert checks["registers_differ"]["value"] > 0
    assert checks["counter_rows_differ"]["value"] == 0


def altered_read():
    from repro_torch.sketch.bank import SketchBank

    estimate_many = SketchBank.estimate_many

    def altered(self, estimator=None, plan=None):
        est = estimate_many(self, estimator, plan).clone()
        est[0] = est[0] * 1.001 + 1.0
        return est

    return SketchBank, "estimate_many", altered


def altered_read_shows(checks):
    """The estimate is caught, the registers are sound."""
    assert checks["estimate_rel_gap"]["value"] > checks["estimate_rel_gap"]["limit"]
    assert checks["registers_differ"]["value"] == 0
