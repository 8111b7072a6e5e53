"""WindowedBank: time-bucketed bank rings with fused sliding-window estimates.

Port of ``repro/sketch/window.py``: a window is a ring of W time-bucket
banks, and a windowed estimate is ONE masked max-fold across the ring axis
followed by the batched ``estimate_many`` (DESIGN.md §11).

Ring/rotation contract (DESIGN.md §11):

* ``registers`` is (W, B, m) uint8 and ``n_items`` (W, B, 2) exact counter
  limbs, on the ring's device.
* ``epochs`` labels each slot with the absolute time bucket it holds; slot
  s always holds an epoch congruent to s modulo W, and the slot at
  ``cursor`` holds the newest.  Both are host values (a python int and a
  (W,) int32 numpy array), as in the reference's hybrid ring, so rotation
  is host arithmetic; the fold's (W,) live mask is computed on the card
  from a copy of ``epochs`` made once per instance without a host sync.
* ``advance()`` / ``advance_to(t)`` rotate and zero the slots they enter;
  a jump of W or more expires the whole ring; the past never returns.
* ``observe(keys, items, plan)`` ingests into the CURRENT bucket through
  ``SketchBank.update_many`` (§9 routing and drop rules unchanged).
* ``estimate_window(last_k, plan)`` folds the ring with the window backend
  registered under ``plan.backend`` and finalizes with one batched
  ``estimate_many``.

Incremental maintenance (DESIGN.md §14): the dense ring carries a hidden
prefix/suffix fold decomposition so the full-window read merges three
(B, m) fragments (the window-merge axis) whatever W is, plus a per-instance
fold cache.  Both live in the instance's ``__dict__`` and are dropped by
``dataclasses.replace`` and ``from_bytes``: invalidation by construction.
The carriers are eager, and the hidden state stands down while
``torch.compile`` traces (``torch.compiler.is_compiling()``), where the
reference checks ``jax.core.trace_state_clean()``.

Carriers are functional, as in the reference: ``observe`` and ``advance_to``
return new instances and leave the old ones valid, so each copies the ring.

``HybridWindowedBank`` is a ring of ``HybridBank`` buckets (RHLW v2);
``MultiResWindowedBank`` an exponential histogram of ``SketchBank``
buckets (RHLW v3).  Wire formats are byte-identical to the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.sketch import hll, u64
from repro_torch.sketch.bank import _BANK_HEADER, SketchBank, estimate_rows
from repro_torch.sketch.dispatch import row_shard_apply
from repro_torch.sketch.hll import HLLConfig
from repro_torch.sketch.plan import (
    DEFAULT_PLAN,
    ExecutionPlan,
    get_window_backend,
    get_window_merge_backend,
)

_WINDOW_HEADER = struct.Struct("<4sBBBBQIII")
# magic, ver, p, H, flags, seed, W, B, cursor
_WINDOW_MAGIC = b"RHLW"
_WINDOW_VERSION = 1
_EPOCH = np.dtype("<i4")


def _ring_epochs(newest: int, window: int) -> np.ndarray:
    """Epoch labels of a ring whose newest epoch is ``newest``: slot s holds
    the unique epoch in (newest - W, newest] congruent to s mod W (a fresh
    ring is at epoch 0; its negative labels were never filled)."""
    slots = np.arange(window, dtype=np.int64)
    return (newest - np.mod(newest - slots, window)).astype(_EPOCH)


def _check_last_k_value(last_k: Optional[int], window: int) -> int:
    """Shared ``last_k`` validation for every ring flavor, one message."""
    if last_k is None:
        return window
    if not 1 <= int(last_k) <= window:
        raise ValueError(f"last_k must be in [1, {window}], got {last_k}")
    return int(last_k)


def _concrete() -> bool:
    """True outside a ``torch.compile`` trace: the hidden fold state and
    the caches are host-side and must not capture traced values."""
    return not torch.compiler.is_compiling()


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without a host sync (pinned copy)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _ring_fold(backend, ring, mask, cfg, plan: ExecutionPlan):
    """One masked ring fold under ``plan``'s placement.

    Folds are per-row maps over the bank axis (dim 1 of the (W, B, m)
    ring), so placement="sharded" runs the SAME backend on each shard's
    row block (DESIGN.md §16) -- the flat fold row for row; every other
    placement folds the whole ring as-is.
    """
    if plan.placement == "sharded":
        # the mask goes whole to every block (in_dim None)
        return row_shard_apply(
            plan, lambda r, m: backend(r, m, cfg, plan), (ring, mask), (1, None)
        )
    return backend(ring, mask, cfg, plan)


def _parts_merge(parts, cfg, plan: ExecutionPlan):
    """Merge (K, B, m) fold fragments under ``plan``'s placement -- the
    sharded mirror of :func:`_ring_fold` for the §14 incremental read."""
    merge = get_window_merge_backend(plan.backend)
    if plan.placement == "sharded":
        return row_shard_apply(plan, lambda p: merge(p, cfg, plan), (parts,), (1,))
    return merge(parts, cfg, plan)


class _RingReads:
    """Window reads shared verbatim by the dense and hybrid rings."""

    def _check_last_k(self, last_k: Optional[int]) -> int:
        return _check_last_k_value(last_k, self.window)

    @property
    def epoch(self) -> int:
        """The newest (current) absolute epoch."""
        return int(self.epochs[self.cursor])

    def _host_live_mask(self, last_k: int) -> np.ndarray:
        """(W,) bool: slots holding one of the ``last_k`` newest epochs."""
        return np.asarray(self.epochs) > self.epoch - last_k

    def window_counts(self, last_k: Optional[int] = None) -> np.ndarray:
        """(B,) exact observation counts over the last ``last_k`` epochs."""
        mask = self._host_live_mask(self._check_last_k(last_k))
        return self.counts[mask].sum(axis=0, dtype=np.uint64)


@dataclasses.dataclass(frozen=True)
class _SuffixFold:
    """The prefix/suffix decomposition of a ring's CLOSED buckets.

    With the closed buckets ordered oldest -> newest as a_1..a_C (C = W - 1;
    the bucket at ``cursor`` is the dirty head):

    * ``prefix`` is the (C, B, m) suffix-fold stack built at the last
      rebuild: ``prefix[i] = fold(a_{i+1} .. a_C)``.  Only ``prefix[head]``
      is read; a rotation expires the oldest front bucket by bumping
      ``head``.
    * ``suffix`` is the (B, m) running fold of every closed bucket newer
      than the front segment; each rotation folds the just-closed head
      bucket into it.
    * ``epoch`` is the absolute epoch this state describes; a mismatch
      forces a rebuild instead of a wrong answer.

    Full-window read = merge(prefix[head], suffix, ring[cursor]).  Rebuilds
    cost O(W) once per W rotations: O(1) amortized (DESIGN.md §14).
    """

    prefix: torch.Tensor
    head: int
    suffix: torch.Tensor
    epoch: int


@dataclasses.dataclass(frozen=True)
class WindowedBank(_RingReads):
    """A (W, B, m) ring of time-bucket banks as one frozen value."""

    registers: torch.Tensor  # (W, B, m) uint8
    n_items: torch.Tensor  # (W, B, 2) int64 (hi, lo) uint32 limbs per bucket row
    cursor: int  # ring slot of the newest epoch
    epochs: np.ndarray  # (W,) int32 absolute epoch held by each slot
    cfg: HLLConfig

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def empty(cls, window: int, rows: int, cfg: Optional[HLLConfig] = None, device=None) -> "WindowedBank":
        cfg = cfg or HLLConfig()
        if window < 1:
            raise ValueError(f"a window needs at least one bucket, got {window}")
        if rows < 1:
            raise ValueError(f"a bank needs at least one row, got {rows}")
        device = hll.resolve_device(device)
        return cls(
            torch.zeros((window, rows, cfg.m), dtype=hll.REGISTER_DTYPE, device=device),
            torch.zeros((window, rows, 2), dtype=torch.int64, device=device),
            0,
            _ring_epochs(0, window),
            cfg,
        )

    def with_rows(self, rows: int) -> "WindowedBank":
        """Grow the bank axis to ``rows`` (new rows start empty)."""
        have = self.rows
        if rows < have:
            raise ValueError(f"cannot shrink a {have}-row window to {rows}")
        if rows == have:
            return self
        pad = (0, 0, 0, rows - have)
        return dataclasses.replace(
            self,
            registers=torch.nn.functional.pad(self.registers, pad),
            n_items=torch.nn.functional.pad(self.n_items, pad),
        )

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def window(self) -> int:
        return int(self.registers.shape[0])

    @property
    def rows(self) -> int:
        return int(self.registers.shape[1])

    def __len__(self) -> int:
        return self.rows

    @property
    def device(self) -> torch.device:
        return self.registers.device

    @property
    def counts(self) -> np.ndarray:
        """(W, B) exact per-bucket-per-row observation counts as uint64."""
        return u64.to_numpy(self.n_items)

    @functools.cached_property
    def _epochs_on_device(self) -> torch.Tensor:
        return _to_device(np.asarray(self.epochs, dtype=np.int32), self.device)

    def _live_mask(self, last_k: int) -> torch.Tensor:
        """(W,) bool on the ring's device: the ``last_k`` newest epochs."""
        return self._epochs_on_device > self.epoch - last_k

    # ------------------------------------------------------------------
    # incremental fold state (hidden, host-side; DESIGN.md §14)
    # ------------------------------------------------------------------

    def _suffix_state(self) -> _SuffixFold:
        """The live decomposition -- threaded forward by ``advance_to``,
        rebuilt from the ring when absent or stale."""
        state = self.__dict__.get("_inc")
        if state is None or state.epoch != self.epoch:
            state = self._rebuild_suffix()
            object.__setattr__(self, "_inc", state)
        return state

    def _rebuild_suffix(self) -> _SuffixFold:
        """One O(W) reverse running max over the closed buckets.

        The reference takes ``jax.lax.cummax(reverse=True)``; ``torch.cummax``
        would also return an int64 index per register (2 GiB at W = 64,
        B = 1024, p = 12), so the stack folds with W - 2 in-place
        ``torch.maximum`` steps instead, once per W rotations.  Expired
        slots were zeroed by ``advance_to`` and fold as the rank-0 identity.
        """
        obs_metrics.inc("window.prefix_rebuilds")
        cursor = self.cursor
        closed = torch.cat([self.registers[cursor + 1 :], self.registers[:cursor]])
        for i in range(closed.shape[0] - 2, -1, -1):
            torch.maximum(closed[i], closed[i + 1], out=closed[i])
        suffix = torch.zeros_like(self.registers[0])
        return _SuffixFold(closed, 0, suffix, self.epoch)

    def _thread_state(self, out: "WindowedBank", steps: int) -> None:
        """Carry the decomposition onto ``out`` after a rotation of ``steps``
        epochs: fold the just-closed head bucket into the suffix and pop
        ``steps`` expired front buckets.  Leaves ``out`` stateless (to
        rebuild lazily) when the rotation outruns the stack."""
        state = self.__dict__.get("_inc")
        if steps <= 0:
            if state is not None and state.epoch == self.epoch:
                object.__setattr__(out, "_inc", state)
            return
        if state is None or state.epoch != self.epoch or steps >= self.window:
            return
        if steps > state.prefix.shape[0] - state.head:
            # the jump expires buckets already folded into the suffix
            # accumulator; max has no inverse, so rebuild from the ring
            return
        object.__setattr__(
            out,
            "_inc",
            _SuffixFold(
                state.prefix,
                state.head + steps,
                torch.maximum(state.suffix, self.registers[self.cursor]),
                self.epoch + steps,
            ),
        )

    # ------------------------------------------------------------------
    # ingestion (current bucket; paper phase 3)
    # ------------------------------------------------------------------

    def observe(self, keys, items, plan: Optional[ExecutionPlan] = None) -> "WindowedBank":
        """Route each item to row ``keys[i]`` of the CURRENT time bucket.

        The current bucket IS a ``SketchBank``, so the ingest delegates to
        ``SketchBank.update_many`` wholesale.  Empty streams return ``self``
        without dispatching anything.
        """
        cur = SketchBank(self.registers[self.cursor], self.n_items[self.cursor], self.cfg)
        new = cur.update_many(keys, items, plan)
        if new is cur:  # the empty-stream short-circuit
            return self
        registers = self.registers.clone()
        registers[self.cursor] = new.registers
        n_items = self.n_items.clone()
        n_items[self.cursor] = new.n_items
        out = dataclasses.replace(self, registers=registers, n_items=n_items)
        # the decomposition describes CLOSED buckets only, so it threads
        # through unchanged; the fold cache starts empty on the new instance
        if _concrete():
            self._thread_state(out, 0)
        return out

    # ------------------------------------------------------------------
    # rotation (the sliding part of the window)
    # ------------------------------------------------------------------

    def advance(self, steps: int = 1) -> "WindowedBank":
        """Open ``steps`` new epochs, expiring the buckets they overwrite."""
        if steps < 1:
            raise ValueError(f"advance needs steps >= 1, got {steps}")
        return self.advance_to(self.epoch + steps)

    def advance_to(self, epoch: int) -> "WindowedBank":
        """Rotate forward so ``epoch`` is current; the past never returns.

        The slots that open are zeroed (their old buckets have slid out of
        the window); jumping W or more epochs expires the whole ring.
        ``epoch`` at or before the current epoch is a no-op.  The opened
        slots are one cyclic run, so at most two slice fills clear them.
        """
        current = self.epoch
        target = max(int(epoch), current)
        window = self.window
        steps = target - current
        if steps == 0:
            registers, n_items = self.registers, self.n_items  # never written in place
        elif steps >= window:
            registers = torch.zeros_like(self.registers)
            n_items = torch.zeros_like(self.n_items)
        else:
            registers = self.registers.clone()
            n_items = self.n_items.clone()
            start = (self.cursor + 1) % window
            for lo, hi in ((start, min(start + steps, window)), (0, max(0, start + steps - window))):
                registers[lo:hi] = 0
                n_items[lo:hi] = 0
        out = dataclasses.replace(
            self,
            registers=registers,
            n_items=n_items,
            cursor=target % window,
            epochs=_ring_epochs(target, window),
        )
        if _concrete():
            self._thread_state(out, steps)
        return out

    # ------------------------------------------------------------------
    # estimation (paper phase 4, windowed)
    # ------------------------------------------------------------------

    def estimate_window(
        self,
        last_k: Optional[int] = None,
        plan: Optional[ExecutionPlan] = None,
        estimator: Optional[str] = None,
    ) -> torch.Tensor:
        """(B,) float32 distinct counts over the ``last_k`` newest epochs."""
        folded = self._fold_registers(self._check_last_k(last_k), plan)
        plan = DEFAULT_PLAN if plan is None else plan
        return estimate_rows(folded, self.cfg, estimator or plan.estimator, plan)

    def _fold_registers(self, last_k: int, plan: Optional[ExecutionPlan]) -> torch.Tensor:
        """(B, m) fold of the ``last_k`` newest epochs -- cached, and O(1)
        in W for the full window (DESIGN.md §14).

        The cache key carries the plan's dispatch identity so distinct
        backends still run their own fold paths.  A full-window read merges
        the three decomposition fragments through the window-merge axis;
        suffix windows (last_k < W) take the masked ring fold, cached the
        same way.
        """
        plan = (DEFAULT_PLAN if plan is None else plan).validate()
        backend = get_window_backend(plan.backend)
        if not _concrete():
            return _ring_fold(backend, self.registers, self._live_mask(last_k), self.cfg, plan)
        cache = self.__dict__.setdefault("_fold_cache", {})
        # no mesh in the key: a fold is a per-row map, so every mesh (and
        # every placement) gives the same registers by construction
        key = (last_k, plan.backend, plan.pipelines, plan.placement)
        hit = cache.get(key)
        if hit is not None:
            obs_metrics.inc("window.fold_cache.hits")
            return hit
        obs_metrics.inc("window.fold_cache.misses")
        if last_k == self.window:
            regs = self._fold_incremental(plan)
        else:
            regs = _ring_fold(backend, self.registers, self._live_mask(last_k), self.cfg, plan)
        cache[key] = regs
        return regs

    def _fold_incremental(self, plan: ExecutionPlan) -> torch.Tensor:
        """merge(prefix top, suffix accumulator, dirty head) -- three (B, m)
        fragments, whatever W is; bit-identical to the masked ring fold."""
        state = self._suffix_state()
        if state.head < state.prefix.shape[0]:
            prefix_top = state.prefix[state.head]
        else:  # front segment fully drained (or W == 1): identity
            prefix_top = torch.zeros_like(state.suffix)
        parts = torch.stack([prefix_top, state.suffix, self.registers[self.cursor]])
        return _parts_merge(parts, self.cfg, plan)

    def fold_window(self, last_k: Optional[int] = None, plan: Optional[ExecutionPlan] = None) -> SketchBank:
        """The ``last_k``-epoch suffix collapsed to a flat ``SketchBank``."""
        last_k = self._check_last_k(last_k)
        regs = self._fold_registers(last_k, plan)
        return SketchBank(regs, u64.from_numpy(self.window_counts(last_k), self.device), self.cfg)

    # ------------------------------------------------------------------
    # serialization (RHLW: window header + epochs + RHLB payloads)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """28-byte window header + W int32 epochs + W RHLB bucket blobs."""
        header = _WINDOW_HEADER.pack(
            _WINDOW_MAGIC, _WINDOW_VERSION, self.cfg.p, self.cfg.hash_bits, 0,
            self.cfg.seed, self.window, self.rows, self.cursor,
        )
        epochs = np.asarray(self.epochs, dtype=_EPOCH).tobytes()
        regs = self.registers.cpu()
        limbs = self.n_items.cpu()
        buckets = b"".join(
            SketchBank(regs[w], limbs[w], self.cfg).to_bytes() for w in range(self.window)
        )
        return header + epochs + buckets

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "WindowedBank":
        if len(data) < _WINDOW_HEADER.size:
            raise ValueError(f"truncated window: {len(data)} bytes")
        magic, version, p, hash_bits, _flags, seed, window, rows, cursor = (
            _WINDOW_HEADER.unpack(data[: _WINDOW_HEADER.size])
        )
        if magic != _WINDOW_MAGIC:
            raise ValueError(f"bad magic {magic!r}; not a serialized window")
        if version != _WINDOW_VERSION:
            hints = {
                2: "; version 2 is the hybrid sparse ring — parse it with "
                "HybridWindowedBank.from_bytes",
                3: "; version 3 is the multi-resolution ring — parse it "
                "with MultiResWindowedBank.from_bytes",
            }
            raise ValueError(f"unsupported window version {version}{hints.get(version, '')}")
        if window < 1 or rows < 1:
            raise ValueError(f"window header claims {window} buckets x {rows} rows")
        if cursor >= window:
            raise ValueError(f"cursor {cursor} out of range for W={window}")
        cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
        epochs_end = _WINDOW_HEADER.size + window * _EPOCH.itemsize
        bucket_size = _BANK_HEADER.size + rows * 8 + rows * cfg.m
        expected = epochs_end + window * bucket_size
        if len(data) != expected:
            # covers payloads cut mid-bucket and mid-row alike
            raise ValueError(
                f"window payload is {len(data)} bytes, expected {expected} "
                f"for W={window}, B={rows}, m={cfg.m}"
            )
        epochs = np.frombuffer(data[_WINDOW_HEADER.size : epochs_end], _EPOCH).astype(np.int64)
        _validate_epoch_ring(epochs, cursor, window)
        regs, limbs = [], []
        for w in range(window):
            start = epochs_end + w * bucket_size
            bucket = SketchBank.from_bytes(data[start : start + bucket_size], device="cpu")
            if bucket.cfg != cfg or len(bucket) != rows:
                raise ValueError(f"bucket {w} disagrees with the window header")
            regs.append(bucket.registers)
            limbs.append(bucket.n_items)
        device = hll.resolve_device(device)
        return cls(
            torch.stack(regs).to(device),
            torch.stack(limbs).to(device),
            int(cursor),
            epochs.astype(_EPOCH),
            cfg,
        )


# ----------------------------------------------------------------------------
# hybrid (sparse-bucket) rings -- DESIGN.md §12
# ----------------------------------------------------------------------------

_WINDOW_VERSION_SPARSE = 2
_BUCKET_LEN = struct.Struct("<Q")


def _validate_epoch_ring(epochs: np.ndarray, cursor: int, window: int) -> None:
    """The slot-congruence invariant shared by RHLW v1 and v2 parsers."""
    epochs = epochs.astype(np.int64)
    slots = np.arange(window, dtype=np.int64)
    if not (
        np.array_equal(np.mod(epochs, window), slots)
        and int(np.argmax(epochs)) == cursor
        and int(epochs.max() - epochs.min()) == window - 1
    ):
        raise ValueError("corrupt epoch labels: ring invariant violated")


@dataclasses.dataclass(frozen=True)
class HybridWindowedBank(_RingReads):
    """A ring of W sparse/dense ``HybridBank`` time buckets.

    Same ring/rotation contract as ``WindowedBank``; promotion state is PER
    BUCKET and rides the slot as it ages.  Window folds merge the live
    hybrid buckets pairwise (W is small) and finalize with one batched
    ``estimate_many``; merges and serialization settle each bucket's
    append log first.  ``to_bytes``/``from_bytes`` is RHLW v2 (v1 dense
    rings still parse, as all-dense buckets).
    """

    buckets: tuple  # W HybridBanks, slot order
    cursor: int
    epochs: np.ndarray  # (W,) int32 absolute epoch per slot

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def empty(
        cls,
        window: int,
        rows: int,
        cfg: Optional[HLLConfig] = None,
        threshold: Optional[int] = None,
        device=None,
    ) -> "HybridWindowedBank":
        from repro_torch.sketch.sparse import HybridBank

        if window < 1:
            raise ValueError(f"a window needs at least one bucket, got {window}")
        device = hll.resolve_device(device)
        return cls(
            tuple(HybridBank.empty(rows, cfg, threshold, device) for _ in range(window)),
            0,
            _ring_epochs(0, window),
        )

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def window(self) -> int:
        return len(self.buckets)

    @property
    def rows(self) -> int:
        return len(self.buckets[0])

    def __len__(self) -> int:
        return self.rows

    @property
    def cfg(self) -> HLLConfig:
        return self.buckets[0].cfg

    @property
    def threshold(self) -> int:
        return self.buckets[0].threshold

    @property
    def device(self) -> torch.device:
        return self.buckets[0].device

    @property
    def counts(self) -> np.ndarray:
        """(W, B) exact per-bucket-per-row observation counts as uint64."""
        return np.stack([b.counts for b in self.buckets])

    def density(self) -> dict:
        """Ring-wide storage stats: the §12 introspection summed over W."""
        per = [b.density() for b in self.buckets]
        nbytes = sum(d["nbytes"] for d in per)
        dense_nbytes = sum(d["dense_nbytes"] for d in per)
        return {
            "window": self.window,
            "rows": self.rows,
            "dense_rows": sum(d["dense_rows"] for d in per),
            "sparse_rows": sum(d["sparse_rows"] for d in per),
            "threshold": self.threshold,
            "occupancy_mean": float(np.mean([d["occupancy_mean"] for d in per])),
            "nbytes": nbytes,
            "dense_nbytes": dense_nbytes,
            "reduction": dense_nbytes / nbytes if nbytes else 0.0,
        }

    # ------------------------------------------------------------------
    # ingestion + rotation
    # ------------------------------------------------------------------

    def observe(self, keys, items, plan: Optional[ExecutionPlan] = None) -> "HybridWindowedBank":
        """Hybrid-route each item into the CURRENT time bucket (delegates to
        ``HybridBank.update_many``, append log included); empty streams
        return ``self``."""
        cur = self.buckets[self.cursor]
        new = cur.update_many(keys, items, plan)
        if new is cur:  # the empty-stream short-circuit
            return self
        buckets = list(self.buckets)
        buckets[self.cursor] = new
        return dataclasses.replace(self, buckets=tuple(buckets))

    def advance(self, steps: int = 1) -> "HybridWindowedBank":
        if steps < 1:
            raise ValueError(f"advance needs steps >= 1, got {steps}")
        return self.advance_to(self.epoch + steps)

    def advance_to(self, epoch: int) -> "HybridWindowedBank":
        """Rotate forward; overwritten buckets expire (same rules as the
        dense ring: monotone, whole-ring expiry on jumps >= W)."""
        from repro_torch.sketch.sparse import HybridBank

        target = max(int(epoch), self.epoch)
        window = self.window
        new_epochs = _ring_epochs(target, window)
        stale = new_epochs.astype(np.int64) > np.asarray(self.epochs, np.int64)
        buckets = tuple(
            HybridBank.empty(self.rows, self.cfg, self.threshold, self.device) if stale[s] else self.buckets[s]
            for s in range(window)
        )
        return dataclasses.replace(self, buckets=buckets, cursor=target % window, epochs=new_epochs)

    # ------------------------------------------------------------------
    # estimation
    # ------------------------------------------------------------------

    def fold_window(self, last_k: Optional[int] = None, plan: Optional[ExecutionPlan] = None):
        """The live ``last_k``-epoch suffix merged into one ``HybridBank``.

        Pairwise hybrid merges over the live buckets, each dedup under
        ``plan`` (default: ``DEFAULT_PLAN``; the reference's signature has
        no plan and merges under its default).  Memoized per instance,
        ``last_k`` and plan.
        """
        last_k = self._check_last_k(last_k)
        plan = (DEFAULT_PLAN if plan is None else plan).validate()
        cacheable = _concrete()
        key = (last_k, plan.backend, plan.pipelines)
        if cacheable:
            cache = self.__dict__.setdefault("_fold_cache", {})
            hit = cache.get(key)
            if hit is not None:
                obs_metrics.inc("window.fold_cache.hits")
                return hit
            obs_metrics.inc("window.fold_cache.misses")
        mask = self._host_live_mask(last_k)
        live = [self.buckets[s] for s in range(self.window) if mask[s]]
        out = live[0]
        for b in live[1:]:
            out = out.merge(b, plan)
        if cacheable:
            cache[key] = out
        return out

    def estimate_window(
        self,
        last_k: Optional[int] = None,
        plan: Optional[ExecutionPlan] = None,
        estimator: Optional[str] = None,
    ) -> torch.Tensor:
        """(B,) float32 distinct counts over the ``last_k`` newest epochs."""
        plan = DEFAULT_PLAN if plan is None else plan
        return self.fold_window(last_k, plan).estimate_many(estimator or plan.estimator)

    # ------------------------------------------------------------------
    # serialization (RHLW v2: length-prefixed hybrid bucket payloads)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        header = _WINDOW_HEADER.pack(
            _WINDOW_MAGIC, _WINDOW_VERSION_SPARSE, self.cfg.p, self.cfg.hash_bits, 0,
            self.cfg.seed, self.window, self.rows, self.cursor,
        )
        out = [header, np.asarray(self.epochs, dtype=_EPOCH).tobytes()]
        for b in self.buckets:
            blob = b.to_bytes()
            out.append(_BUCKET_LEN.pack(len(blob)))
            out.append(blob)
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "HybridWindowedBank":
        from repro_torch.sketch.sparse import HybridBank

        if len(data) < _WINDOW_HEADER.size:
            raise ValueError(f"truncated window: {len(data)} bytes")
        magic, version, p, hash_bits, _flags, seed, window, rows, cursor = (
            _WINDOW_HEADER.unpack(data[: _WINDOW_HEADER.size])
        )
        if magic != _WINDOW_MAGIC:
            raise ValueError(f"bad magic {magic!r}; not a serialized window")
        if version == _WINDOW_VERSION:
            # dense rings still parse, version-gated: all-dense buckets
            dense = WindowedBank.from_bytes(data, device)
            buckets = tuple(
                SketchBank(dense.registers[w], dense.n_items[w], dense.cfg).to_hybrid(
                    dense_rows=np.ones(dense.rows, bool)
                )
                for w in range(dense.window)
            )
            return cls(buckets, dense.cursor, np.asarray(dense.epochs, _EPOCH))
        if version != _WINDOW_VERSION_SPARSE:
            hint = (
                "; version 3 is the multi-resolution ring — parse it "
                "with MultiResWindowedBank.from_bytes"
                if version == _WINDOW_VERSION_MULTI
                else ""
            )
            raise ValueError(f"unsupported window version {version}{hint}")
        if window < 1 or rows < 1:
            raise ValueError(f"window header claims {window} buckets x {rows} rows")
        if cursor >= window:
            raise ValueError(f"cursor {cursor} out of range for W={window}")
        cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
        epochs_end = _WINDOW_HEADER.size + window * _EPOCH.itemsize
        if len(data) < epochs_end:
            raise ValueError("truncated window: epoch labels cut short")
        epochs = np.frombuffer(data[_WINDOW_HEADER.size : epochs_end], _EPOCH)
        _validate_epoch_ring(epochs, cursor, window)
        off = epochs_end
        buckets, was_v1 = [], []
        for w in range(window):
            if len(data) < off + _BUCKET_LEN.size:
                raise ValueError(f"bucket {w}: length prefix cut short")
            (blen,) = _BUCKET_LEN.unpack_from(data, off)
            off += _BUCKET_LEN.size
            if len(data) < off + blen:
                raise ValueError(f"bucket {w}: payload cut short")
            payload = data[off : off + blen]
            bucket = HybridBank.from_bytes(payload, device)
            if bucket.cfg != cfg or len(bucket) != rows:
                raise ValueError(f"bucket {w} disagrees with the window header")
            buckets.append(bucket)
            # a version-gated v1 dense payload carries no threshold of its
            # own; it adopts the ring's below instead of vetoing it
            was_v1.append(len(payload) > 5 and payload[4] == 1)
            off += blen
        if off != len(data):
            raise ValueError(f"window payload is {len(data)} bytes, expected {off}")
        v2_thresholds = {b.threshold for b, v1 in zip(buckets, was_v1) if not v1}
        if len(v2_thresholds) > 1:
            raise ValueError(f"bucket thresholds disagree across the ring: {sorted(v2_thresholds)}")
        if v2_thresholds:
            (ring_threshold,) = v2_thresholds
            buckets = [
                dataclasses.replace(b, threshold=ring_threshold) if v1 else b
                for b, v1 in zip(buckets, was_v1)
            ]
        return cls(tuple(buckets), int(cursor), epochs.copy())


# ----------------------------------------------------------------------------
# multi-resolution rings (exponential histogram) -- DESIGN.md §14
# ----------------------------------------------------------------------------

_WINDOW_VERSION_MULTI = 3
_MR_BASE = struct.Struct("<I")
_MR_BUCKET = struct.Struct("<iiI")  # start epoch, end epoch, logical size
_MR_MAX_LEVELS = 24  # keeps base * 2**levels (and every epoch label) in int32


@dataclasses.dataclass(frozen=True)
class _MRBucket:
    """One closed exponential-histogram bucket spanning epochs
    [start, end], of logical level size ``size`` (a power of two)."""

    start: int
    end: int
    size: int
    bank: SketchBank


@dataclasses.dataclass(frozen=True)
class MultiResWindowedBank:
    """An exponential-histogram window: O(base·levels) slots, long horizon.

    Each resolution level holds at most ``base`` buckets of logical size
    2^l, l < ``levels``; when a level overflows, its two oldest buckets
    merge into one bucket of the next level (register max + exact counter
    add).  A ``horizon = base * (2**levels - 1)`` epoch span costs at most
    ``base * levels`` closed buckets.  Only the window BOUNDARY is
    approximated: a query folds every bucket that intersects it.  Queries
    stack the live buckets and fold them through the same window-fold axis
    as the dense ring, memoized per instance.  RHLW v3 on the wire.
    """

    current: SketchBank  # the open bucket at `epoch`
    closed: tuple  # _MRBuckets, NEWEST first, strictly older, non-overlapping
    epoch: int
    base: int  # max buckets per resolution level
    levels: int  # level sizes 1, 2, ..., 2**(levels-1)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def empty(
        cls,
        base: int,
        rows: int,
        cfg: Optional[HLLConfig] = None,
        levels: int = 4,
        device=None,
    ) -> "MultiResWindowedBank":
        cfg = cfg or HLLConfig()
        if base < 1:
            raise ValueError(f"a window needs at least one bucket, got {base}")
        if rows < 1:
            raise ValueError(f"a bank needs at least one row, got {rows}")
        _check_mr_shape(base, levels)
        return cls(SketchBank.empty(rows, cfg, device), (), 0, base, levels)

    def with_rows(self, rows: int) -> "MultiResWindowedBank":
        """Grow the bank axis to ``rows`` (new rows start empty)."""
        have = self.rows
        if rows < have:
            raise ValueError(f"cannot shrink a {have}-row window to {rows}")
        if rows == have:
            return self

        def grow(bank: SketchBank) -> SketchBank:
            pad = (0, 0, 0, rows - have)
            return dataclasses.replace(
                bank,
                registers=torch.nn.functional.pad(bank.registers, pad),
                n_items=torch.nn.functional.pad(bank.n_items, pad),
            )

        return dataclasses.replace(
            self,
            current=grow(self.current),
            closed=tuple(dataclasses.replace(b, bank=grow(b.bank)) for b in self.closed),
        )

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def cfg(self) -> HLLConfig:
        return self.current.cfg

    @property
    def rows(self) -> int:
        return len(self.current)

    def __len__(self) -> int:
        return self.rows

    @property
    def device(self) -> torch.device:
        return self.current.device

    @property
    def horizon(self) -> int:
        """The answerable span in epochs: base * (2**levels - 1)."""
        return self.base * ((1 << self.levels) - 1)

    @property
    def window(self) -> int:
        """Alias of ``horizon``: the bound ``last_k`` validates against."""
        return self.horizon

    @property
    def slots(self) -> int:
        """Buckets currently held (current + closed): O(base · levels)."""
        return 1 + len(self.closed)

    def _check_last_k(self, last_k: Optional[int]) -> int:
        return _check_last_k_value(last_k, self.window)

    def _live_buckets(self, last_k: int) -> list:
        """Closed buckets intersecting the last ``last_k`` epochs, newest
        first.  The current bucket is always live and not listed here."""
        floor = self.epoch - last_k
        return [b for b in self.closed if b.end > floor]

    def window_counts(self, last_k: Optional[int] = None) -> np.ndarray:
        """(B,) exact observation counts over the covered buckets."""
        last_k = self._check_last_k(last_k)
        totals = self.current.counts.copy()
        for b in self._live_buckets(last_k):
            totals += b.bank.counts
        return totals

    def density(self) -> dict:
        """Slot/storage introspection of the multi-res ring."""
        per_level = {}
        for b in self.closed:
            per_level[b.size] = per_level.get(b.size, 0) + 1
        nbytes = self.current.nbytes + sum(b.bank.nbytes for b in self.closed)
        dense_slots = min(self.horizon, self.epoch + 1)
        return {
            "horizon": self.horizon,
            "slots": self.slots,
            "rows": self.rows,
            "base": self.base,
            "levels": self.levels,
            "buckets_per_size": dict(sorted(per_level.items())),
            "nbytes": nbytes,
            "dense_ring_nbytes": dense_slots * self.current.nbytes,
            "reduction": (dense_slots * self.current.nbytes) / nbytes if nbytes else 0.0,
        }

    # ------------------------------------------------------------------
    # ingestion + rotation
    # ------------------------------------------------------------------

    def observe(self, keys, items, plan: Optional[ExecutionPlan] = None) -> "MultiResWindowedBank":
        """Route each item to row ``keys[i]`` of the CURRENT epoch bucket."""
        new = self.current.update_many(keys, items, plan)
        if new is self.current:  # the empty-stream short-circuit
            return self
        return dataclasses.replace(self, current=new)

    def advance(self, steps: int = 1) -> "MultiResWindowedBank":
        if steps < 1:
            raise ValueError(f"advance needs steps >= 1, got {steps}")
        return self.advance_to(self.epoch + steps)

    def advance_to(self, epoch: int) -> "MultiResWindowedBank":
        """Rotate forward to ``epoch``, running the slot-merge schedule.

        The just-closed current bucket enters level 0 (if it observed
        anything); any level left holding more than ``base`` buckets merges
        its two oldest into the next level; top-level overflow drops the
        oldest.  Buckets past the horizon expire.  Monotone.
        """
        target = max(int(epoch), self.epoch)
        if target == self.epoch:
            return self
        closed = list(self.closed)
        if int(self.current.counts.sum()) > 0:
            closed.insert(0, _MRBucket(self.epoch, self.epoch, 1, self.current))
            closed = _mr_carry(closed, self.base, self.levels)
        floor = target - self.horizon
        closed = [b for b in closed if b.end > floor]
        return dataclasses.replace(
            self,
            current=SketchBank.empty(self.rows, self.cfg, self.device),
            closed=tuple(closed),
            epoch=target,
        )

    # ------------------------------------------------------------------
    # estimation
    # ------------------------------------------------------------------

    def _fold_registers(self, last_k: int, plan: Optional[ExecutionPlan]) -> torch.Tensor:
        """(B, m) fold of every bucket covering the last ``last_k`` epochs,
        through the window-fold axis with every slice live; memoized."""
        plan = (DEFAULT_PLAN if plan is None else plan).validate()
        backend = get_window_backend(plan.backend)
        cacheable = _concrete()
        key = (last_k, plan.backend, plan.pipelines, plan.placement)  # no mesh: as in WindowedBank
        if cacheable:
            cache = self.__dict__.setdefault("_fold_cache", {})
            hit = cache.get(key)
            if hit is not None:
                obs_metrics.inc("window.fold_cache.hits")
                return hit
            obs_metrics.inc("window.fold_cache.misses")
        stack = torch.stack(
            [self.current.registers] + [b.bank.registers for b in self._live_buckets(last_k)]
        )
        mask = torch.ones((stack.shape[0],), dtype=torch.bool, device=stack.device)
        regs = _ring_fold(backend, stack, mask, self.cfg, plan)
        if cacheable:
            cache[key] = regs
        return regs

    def estimate_window(
        self,
        last_k: Optional[int] = None,
        plan: Optional[ExecutionPlan] = None,
        estimator: Optional[str] = None,
    ) -> torch.Tensor:
        """(B,) float32 distinct counts over (at least) the last ``last_k``
        epochs -- rounded up to bucket edges at the tail."""
        folded = self._fold_registers(self._check_last_k(last_k), plan)
        plan = DEFAULT_PLAN if plan is None else plan
        return estimate_rows(folded, self.cfg, estimator or plan.estimator, plan)

    def fold_window(self, last_k: Optional[int] = None, plan: Optional[ExecutionPlan] = None) -> SketchBank:
        """The covered suffix collapsed to a flat ``SketchBank``."""
        last_k = self._check_last_k(last_k)
        regs = self._fold_registers(last_k, plan)
        return SketchBank(regs, u64.from_numpy(self.window_counts(last_k), self.device), self.cfg)

    # ------------------------------------------------------------------
    # serialization (RHLW v3)
    # ------------------------------------------------------------------

    def to_bytes(self) -> bytes:
        header = _WINDOW_HEADER.pack(
            _WINDOW_MAGIC, _WINDOW_VERSION_MULTI, self.cfg.p, self.cfg.hash_bits, self.levels,
            self.cfg.seed, self.slots, self.rows, self.epoch,
        )
        out = [header, _MR_BASE.pack(self.base)]
        labelled = [(self.epoch, self.epoch, 1, self.current)] + [
            (b.start, b.end, b.size, b.bank) for b in self.closed
        ]
        for start, end, size, bank in labelled:
            out.append(_MR_BUCKET.pack(start, end, size))
            out.append(bank.to_bytes())
        return b"".join(out)

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "MultiResWindowedBank":
        if len(data) < _WINDOW_HEADER.size + _MR_BASE.size:
            raise ValueError(f"truncated window: {len(data)} bytes")
        magic, version, p, hash_bits, levels, seed, slots, rows, epoch = (
            _WINDOW_HEADER.unpack(data[: _WINDOW_HEADER.size])
        )
        if magic != _WINDOW_MAGIC:
            raise ValueError(f"bad magic {magic!r}; not a serialized window")
        if version != _WINDOW_VERSION_MULTI:
            raise ValueError(
                f"unsupported window version {version}; versions 1/2 are "
                "the dense/hybrid rings — parse them with "
                "WindowedBank/HybridWindowedBank.from_bytes"
            )
        if slots < 1 or rows < 1:
            raise ValueError(f"window header claims {slots} buckets x {rows} rows")
        (base,) = _MR_BASE.unpack_from(data, _WINDOW_HEADER.size)
        _check_mr_shape(base, levels)
        cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
        bank_size = _BANK_HEADER.size + rows * 8 + rows * cfg.m
        bucket_size = _MR_BUCKET.size + bank_size
        expected = _WINDOW_HEADER.size + _MR_BASE.size + slots * bucket_size
        if len(data) != expected:
            raise ValueError(
                f"window payload is {len(data)} bytes, expected {expected} "
                f"for {slots} buckets, B={rows}, m={cfg.m}"
            )
        horizon = base * ((1 << levels) - 1)
        size_max = 1 << (levels - 1)
        device = hll.resolve_device(device)
        buckets = []
        off = _WINDOW_HEADER.size + _MR_BASE.size
        for w in range(slots):
            start, end, size = _MR_BUCKET.unpack_from(data, off)
            off += _MR_BUCKET.size
            bank = SketchBank.from_bytes(data[off : off + bank_size], device)
            off += bank_size
            if bank.cfg != cfg or len(bank) != rows:
                raise ValueError(f"bucket {w} disagrees with the window header")
            buckets.append((start, end, size, bank))
        start0, end0, size0, current = buckets[0]
        if not (start0 == end0 == epoch and size0 == 1):
            raise ValueError(
                "corrupt multi-resolution labels: the first bucket must be "
                "the open current epoch"
            )
        prev_start, prev_size = start0, None
        closed = []
        for w, (start, end, size, bank) in enumerate(buckets[1:], start=1):
            if not (
                0 <= start <= end < prev_start
                and 1 <= size <= size_max
                and size & (size - 1) == 0
                and size <= end - start + 1
                and (prev_size is None or size >= prev_size)
                and end > epoch - horizon
            ):
                raise ValueError(
                    f"corrupt multi-resolution labels: bucket {w} violates "
                    "the slot-merge schedule invariants"
                )
            prev_start, prev_size = start, size
            closed.append(_MRBucket(start, end, size, bank))
        return cls(current, tuple(closed), epoch, base, levels)


def _check_mr_shape(base: int, levels: int) -> None:
    """Bounds shared by the constructor and the RHLW v3 parser."""
    if base < 1:
        raise ValueError(f"multi-resolution base must be >= 1, got {base}")
    if not 1 <= levels <= _MR_MAX_LEVELS:
        raise ValueError(f"multi-resolution levels must be in [1, {_MR_MAX_LEVELS}], got {levels}")
    if base * (1 << levels) >= 1 << 31:
        raise ValueError(
            f"horizon base * (2**levels - 1) overflows int32 epochs "
            f"(base={base}, levels={levels})"
        )


def _mr_carry(closed: list, base: int, levels: int) -> list:
    """The exponential-histogram slot-merge schedule (DESIGN.md §14).

    ``closed`` is newest-first with level sizes non-decreasing toward the
    old end.  For each level size s = 1, 2, 4, ...: while the level holds
    more than ``base`` buckets, its two OLDEST merge into one size-2s
    bucket (register max plus exact counter add); a top-level overflow
    drops the oldest bucket instead (it sits at the horizon boundary).
    """
    size_max = 1 << (levels - 1)
    out = list(closed)
    size = 1
    while size <= size_max:
        idxs = [i for i, b in enumerate(out) if b.size == size]
        while len(idxs) > base:
            oldest = idxs[-1]
            if 2 * size > size_max:
                out.pop(oldest)
                idxs.pop()
                continue
            older, newer = out[oldest], out[oldest - 1]
            out[oldest - 1] = _MRBucket(older.start, newer.end, 2 * size, newer.bank.merge(older.bank))
            out.pop(oldest)
            idxs.pop()
            idxs.pop()
        size *= 2
    return out
