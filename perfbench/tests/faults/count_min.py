"""Test hooks of the ``count_min`` system: faults planted in ``CountMinBank.update_many``."""

import dataclasses

CONTROL_FAILS = ("counters_differ", "labels_differ")


def faults():
    from repro_torch.sketch.countmin import CountMinBank

    update_many = CountMinBank.update_many

    def unchanged(self, keys, items, plan=None):
        return self

    def half(self, keys, items, plan=None):
        n = keys.numel() // 2
        return update_many(self, keys.reshape(-1)[:n], items.reshape(-1)[:n], plan)

    def altered(self, keys, items, plan=None):
        out = update_many(self, keys, items, plan)
        counters = out.counters.clone()
        counters[0, 0, 0] += 1
        return dataclasses.replace(out, counters=counters)

    def votes_half(self, keys, items, plan=None):
        voted = half(self, keys, items, plan)
        return dataclasses.replace(update_many(self, keys, items, plan), labels=voted.labels,
                                   label_counts=voted.label_counts)

    return CountMinBank, "update_many", {"unchanged": unchanged, "half": half, "altered": altered,
                                         "late": votes_half}


def late_shows(checks):
    """Every entry counted and in the counters, the vote over half of them:
    the check sees the vote on its own."""
    assert checks["labels_differ"]["value"] > 0
    assert checks["counters_differ"]["value"] == 0
    assert checks["counter_rows_differ"]["value"] == 0
