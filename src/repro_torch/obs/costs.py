"""Declared costs: the work the op analysis cannot see through a dispatch mode.

The port's kernels launch through ``ctypes`` (``kernels/_build.py``), so no
``TorchDispatchMode`` sees them; and its placement rules move whole tensors
between mesh positions with ``.to()``, an operator that says nothing of
which positions it joins.  So each kernel wrapper declares, at every launch,
the FLOPs and bytes of its kernel, counted as PERF.md's bound column counts
them (each input read once, each output written once); and each placement
rule declares the bytes it gathers from the other positions.  On ``meta``
tensors a wrapper launches nothing and declares the same cost.
``repro_torch.launch.hlo_analysis.analyze`` collects the declarations while
it runs a callable.  With no collector open a declaration is a loop over an
empty list.
"""

from __future__ import annotations

import contextlib
from typing import List

_COLLECTORS: List[object] = []


def kernel(name: str, flops: int, nbytes: int) -> None:
    """A kernel launch (or its stand-in on ``meta`` tensors) of ``flops``
    operations moving ``nbytes`` bytes."""
    for c in _COLLECTORS:
        c.on_kernel(name, flops, nbytes)


def collective(kind: str, nbytes: int) -> None:
    """``nbytes`` moved between mesh positions by a rule of kind ``kind``
    (the reference's collective it stands for: ``all-gather``,
    ``all-reduce``)."""
    for c in _COLLECTORS:
        c.on_collective(kind, nbytes)


@contextlib.contextmanager
def collecting(collector):
    """Send the declarations made inside the block to ``collector`` (an
    object with ``on_kernel`` and ``on_collective``)."""
    _COLLECTORS.append(collector)
    try:
        yield collector
    finally:
        _COLLECTORS.remove(collector)
