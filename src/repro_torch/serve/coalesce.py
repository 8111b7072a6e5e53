"""Request coalescing: many tenants' pending updates, ONE ingest per tick.

Port of ``repro/serve/coalesce.py``.  The paper's FPGA wins sustained line
rate because ingest never waits on a per-request round trip; the serving
mirror of that (DESIGN.md §16) is a coalescing queue in front of the bank.
Tenants ``submit()`` their keyed token streams as they arrive -- cheap
host-side appends, no device work -- and a periodic tick ``drain()``s the
queue into one merged (keys, items) batch that lands with a single fused
``update_many`` dispatch.  N per-tenant batches and their concatenation are
bit-identical by the §6 lattice laws (register max is associative,
commutative and idempotent, and the exact counters add), so coalescing is
pure batching: it can change WHEN a register moves, never WHERE it lands.

Double-buffered host-to-device staging: ``drain(stage=True)`` copies the
merged batch into pinned host tensors and from there to the device with
``non_blocking=True``, through a ring of slots.  The copy and the kernels
behind it run asynchronously, so while the card scatters tick N's batch the
host is already concatenating and staging tick N+1's into the other slot.
Each slot keeps its pinned sources and device tensors alive until the ring
comes back to it: a pinned source freed under an in-flight copy could be
handed out again and overwritten before the card has read it.
Host-orchestrated carriers (HybridBank's append log) consume the merged
batch on the host instead via ``drain(stage=False)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.sketch.hll import resolve_device

__all__ = ["CoalescingQueue", "DoubleBuffer", "SharedWindowRing"]


class _Slot(NamedTuple):
    """One staged batch: the host sources and their device copies."""

    sources: Tuple[torch.Tensor, ...]
    tensors: Tuple[torch.Tensor, ...]


class DoubleBuffer:
    """Two-slot host-to-device staging ring (ping-pong transfer buffers).

    ``device`` defaults to the card; on the CPU, staging is a plain copy.
    """

    def __init__(self, depth: int = 2, device=None):
        if depth < 2:
            raise ValueError(f"staging needs >= 2 slots, got {depth}")
        self.device = resolve_device(device)
        self._slots = [None] * depth
        self._tick = 0

    @property
    def depth(self) -> int:
        return len(self._slots)

    def stage(self, *host_arrays) -> Tuple[torch.Tensor, ...]:
        """Copy ``host_arrays`` to the device; returns the device tensors.

        Rotates through the slot ring, so the previous tick's buffers stay
        referenced while its scatter is still in flight and the slot being
        overwritten is always the oldest (already retired) one.
        """
        sources = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in host_arrays)
        if self.device.type == "cuda":
            sources = tuple(s.pin_memory() for s in sources)
            tensors = tuple(s.to(self.device, non_blocking=True) for s in sources)
        else:
            tensors = tuple(s.to(self.device, copy=True) for s in sources)
        self._slots[self._tick % len(self._slots)] = _Slot(sources, tensors)
        self._tick += 1
        return tensors


class CoalescingQueue:
    """Pending per-tenant updates, drained as one merged batch per tick."""

    def __init__(self, staging_depth: int = 2, device=None):
        self._chunks = []  # [(keys int32, items), ...] host-side numpy
        self._staging = DoubleBuffer(staging_depth, device)
        self.ticks = 0

    def submit(self, keys, items) -> int:
        """Queue one tenant batch (host append, no device work); returns
        the number of items pending after the append."""
        keys = np.asarray(keys).reshape(-1).astype(np.int32, copy=False)
        items = np.asarray(items).reshape(-1)
        if keys.shape[0] != items.shape[0]:
            raise ValueError(
                f"keys ({keys.shape[0]}) and items ({items.shape[0]}) "
                f"must flatten to the same length"
            )
        if keys.shape[0]:
            self._chunks.append((keys, items))
            obs_metrics.inc("serve.coalesce.submitted")
        return self.pending_items()

    def submit_row(self, row: int, items) -> int:
        """``submit`` with every item routed to one tenant row."""
        items = np.asarray(items).reshape(-1)
        return self.submit(np.full(items.shape[0], row, np.int32), items)

    def pending_batches(self) -> int:
        return len(self._chunks)

    def pending_items(self) -> int:
        return sum(k.shape[0] for k, _ in self._chunks)

    def drain(self, stage: bool = True) -> Optional[Tuple]:
        """Pop everything pending as ONE merged (keys, items) batch.

        ``stage=True`` routes the merge through the double buffer and
        returns device tensors (the fused-scatter path); ``stage=False``
        returns the host arrays for host-orchestrated carriers.  An empty
        queue returns None -- a tick with no traffic must not dispatch
        anything.
        """
        if not self._chunks:
            return None
        chunks, self._chunks = self._chunks, []
        keys = np.concatenate([k for k, _ in chunks])
        items = np.concatenate([x for _, x in chunks])
        self.ticks += 1
        obs_metrics.inc("serve.coalesce.ticks")
        obs_metrics.observe("serve.coalesce.batches_per_tick", len(chunks))
        obs_metrics.observe("serve.coalesce.batch_items", keys.shape[0])
        if stage:
            return self._staging.stage(keys, items)
        return keys, items

    def flush_into(self, bank, plan=None):
        """Drain into ``bank`` with ONE ``update_many``; returns the new
        bank (unchanged when nothing is pending).  Device-stages unless
        the carrier ingests on host (a ``pending_pairs`` surface marks
        the HybridBank append-log family)."""
        host_carrier = hasattr(bank, "pending_pairs")
        merged = self.drain(stage=not host_carrier)
        if merged is None:
            return bank
        return bank.update_many(merged[0], merged[1], plan)


class SharedWindowRing:
    """Process-wide window rings shared across requests (DESIGN.md §16).

    The §14 fold decomposition and fold cache amortize per INSTANCE; a
    ring constructed per request pays the rebuild every time.  Serving
    code gets-or-creates one ring per (carrier, shape, config) key and
    writes functional updates back with ``swap``, so every request's read
    hits the same decomposed state.
    """

    _rings: dict = {}

    @classmethod
    def get_or_create(cls, key, factory):
        ring = cls._rings.get(key)
        if ring is None:
            ring = cls._rings[key] = factory()
            obs_metrics.inc("serve.window_ring.created")
        else:
            obs_metrics.inc("serve.window_ring.shared")
        return ring

    @classmethod
    def swap(cls, key, ring):
        """Publish an updated ring under ``key``; returns it."""
        cls._rings[key] = ring
        return ring

    @classmethod
    def reset(cls) -> None:
        """Drop every shared ring (tests and process teardown)."""
        cls._rings.clear()
