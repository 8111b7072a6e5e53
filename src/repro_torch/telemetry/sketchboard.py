"""StreamSketch: the paper's sketch as a first-class telemetry feature.

Port of ``repro/telemetry/sketchboard.py``.  A board wraps named
``HyperLogLog`` carriers so a training or serving job can track several
cardinalities at once (distinct tokens, distinct users or request ids).

Ingest is **buffered and bank-batched** (DESIGN.md §9): ``observe()`` only
appends the items to a per-stream buffer on the board's device; at flush
time every buffered stream's registers stack into one ``SketchBank`` and a
single keyed ``update_many`` (key = stream row) aggregates everything at
once.  Flushes happen once ``flush_items`` items are pending and before any
read, so results are bit-identical to unbuffered per-stream updates.

``report()`` finalizes the whole board with one batched ``estimate_many``;
``report(exact=True)`` and ``estimate()`` keep the exact host finalizer.

``window=W`` switches the board to WINDOWED mode (DESIGN.md §11): streams
become rows of one ``WindowedBank`` ring, ``advance()`` slides the window,
and every read answers over the last W epochs.  ``window_levels=L`` swaps
the ring for a ``MultiResWindowedBank`` (DESIGN.md §14); it does not
combine with ``track_topk``.

``track_topk=CMConfig(...)`` adds heavy-hitter tracking (DESIGN.md §13): the
same buffered keyed stream also feeds one ``CountMinBank`` (row = stream),
or a ``WindowedCountMinBank`` ring that advances in lockstep with the HLL
ring on a windowed board, and ``topk(name, k)`` / ``report(topk=k)`` answer
which items dominate a stream.

Every stream's updates run under one ``ExecutionPlan``; ``plan=None`` means
the port's ``DEFAULT_PLAN`` (backend "cuda").  ``device=None`` means the
card; the board hands its device to every carrier it creates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.sketch import hll
from repro_torch.sketch.bank import SketchBank, update_many
from repro_torch.sketch.carrier import HyperLogLog
from repro_torch.sketch.countmin import CMConfig, CountMinBank, WindowedCountMinBank
from repro_torch.sketch.estimators import DEFAULT_ESTIMATOR, estimate_many
from repro_torch.sketch.hll import HLLConfig
from repro_torch.sketch.plan import DEFAULT_PLAN, ExecutionPlan, get_bank_backend, get_cm_backend
from repro_torch.sketch.window import MultiResWindowedBank, WindowedBank


@dataclasses.dataclass
class StreamSketch:
    cfg: HLLConfig
    plan: Optional[ExecutionPlan] = None  # None = the port's DEFAULT_PLAN ("cuda")
    sketches: Dict[str, HyperLogLog] = dataclasses.field(default_factory=dict)
    # buffered keyed ingest: flush once this many items are pending
    flush_items: int = 1 << 20
    # W > 0 switches the board to windowed mode (DESIGN.md §11)
    window: Optional[int] = None
    # L > 0 upgrades the windowed ring to the multi-resolution histogram
    # (DESIGN.md §14): horizon window * (2**L - 1) epochs
    window_levels: Optional[int] = None
    # a CMConfig adds heavy-hitter tracking (DESIGN.md §13)
    track_topk: Optional[CMConfig] = None
    # the device every carrier of the board lives on; None = the card
    device: Optional[torch.device] = None
    _pending: Dict[str, List[torch.Tensor]] = dataclasses.field(default_factory=dict, repr=False)
    _pending_items: int = dataclasses.field(default=0, repr=False)
    _wbank: Optional[object] = dataclasses.field(default=None, repr=False)
    _wrows: Dict[str, int] = dataclasses.field(default_factory=dict, repr=False)
    # the full-window fold, memoized between ring mutations so per-stream
    # reads over many streams cost ONE fold, not B
    _wfold_cache: Optional[SketchBank] = dataclasses.field(default=None, repr=False)
    # heavy-hitter state: the flat bank (row = stream, flat boards), the
    # ring (windowed boards, advanced in lockstep with _wbank), the flat
    # board's name -> row map, and the memoized window fold
    _cmbank: Optional[CountMinBank] = dataclasses.field(default=None, repr=False)
    _cmwin: Optional[WindowedCountMinBank] = dataclasses.field(default=None, repr=False)
    _cm_rows: Dict[str, int] = dataclasses.field(default_factory=dict, repr=False)
    _cmfold_cache: Optional[CountMinBank] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.device = hll.resolve_device(self.device)
        if self.window is not None and self.window < 1:
            raise ValueError(f"window needs at least one bucket, got {self.window}")
        if self.window_levels is not None:
            if self.window is None:
                raise ValueError("window_levels needs a windowed board (window=W)")
            if self.window_levels < 1:
                raise ValueError(
                    f"window_levels needs at least one level, got {self.window_levels}"
                )
            if self.track_topk is not None:
                raise ValueError(
                    "window_levels cannot combine with track_topk: the "
                    "count-min ring has no multi-resolution carrier"
                )

    def _estimator(self, estimator: Optional[str]) -> str:
        if estimator is not None:
            return estimator
        return self.plan.estimator if self.plan is not None else DEFAULT_ESTIMATOR

    def _empty_sketch(self) -> HyperLogLog:
        return HyperLogLog.empty(self.cfg, self.device)

    def stream(self, name: str) -> HyperLogLog:
        """The named sketch, current through any buffered observations.

        In windowed mode this is a read-only SNAPSHOT of the stream's
        sliding window (ring fold + exact windowed counter).
        """
        if name in self._pending:
            self.flush()
        if self.window is not None:
            if name not in self._wrows:
                self._wrows[name] = len(self._wrows)
            row = self._wrows[name]
            if self._wbank is None or row >= self._wbank.rows:
                return self._empty_sketch()
            return self._window_fold().row(row)
        if name not in self.sketches:
            self.sketches[name] = self._empty_sketch()
        return self.sketches[name]

    def _window_fold(self) -> SketchBank:
        """The live window collapsed to a flat bank (row = stream), memoized
        until the next ring mutation (flush/advance/grow)."""
        if self._wfold_cache is None:
            self._wfold_cache = self._wbank.fold_window(plan=self.plan)
        return self._wfold_cache

    def observe(self, name: str, items) -> None:
        """Buffer ``items`` for ``name``; aggregation happens at flush."""
        if self.window is not None:
            if name not in self._wrows:
                self._wrows[name] = len(self._wrows)
        elif name not in self.sketches:
            self.sketches[name] = self._empty_sketch()
        # murmur3 hashes the 32-bit pattern, so holding the buffer as int32
        # bits (the reference casts to uint32) cannot change any register
        flat = hll.as_items(items, self.device)
        if flat.numel() == 0:
            return
        self._pending.setdefault(name, []).append(flat)
        self._pending_items += int(flat.numel())
        if self._pending_items >= self.flush_items:
            self.flush()

    def _keyed_buffer(self, rowmap: Dict[str, int]):
        """The pending buffer as one keyed (keys, items) stream: every
        buffered array of stream ``name`` keyed by ``rowmap[name]``."""
        names = list(self._pending)
        arrays = [a for name in names for a in self._pending[name]]
        rows = [rowmap[name] for name in names for _ in self._pending[name]]
        sizes = [a.numel() for a in arrays]
        keys = torch.repeat_interleave(
            torch.tensor(rows, dtype=torch.int32, device=self.device),
            torch.tensor(sizes, device=self.device),
            output_size=sum(sizes),
        )
        return keys, torch.cat(arrays)

    def _clear_pending(self) -> None:
        self._pending.clear()
        self._pending_items = 0

    def flush(self) -> None:
        """Drain the buffer: ONE keyed update_many over the pending streams.

        Bit-identical to the unbuffered path: scatter-max commutes with any
        batching of the stream.
        """
        if not self._pending:
            return
        if self.track_topk is not None:
            # the count-min twin ingests the SAME buffered keyed stream
            # first, while the buffer is still intact
            self._flush_topk()
        names = list(self._pending)
        if self.window is not None:
            # windowed boards land the whole buffer in the CURRENT time
            # bucket of the ring with the same single keyed dispatch
            keys, items = self._keyed_buffer(self._wrows)
            rows = len(self._wrows)
            if self._wbank is None:
                self._wbank = self._new_wbank(rows)
            elif rows > self._wbank.rows:
                self._wbank = self._wbank.with_rows(rows)
            self._wbank = self._wbank.observe(keys, items, self.plan)
            self._wfold_cache = None
            self._clear_pending()
            return
        try:
            get_bank_backend((self.plan or DEFAULT_PLAN).backend)
        except ValueError:
            # a plugin backend registered only for single sketches keeps
            # working: one per-stream update over the concatenated buffer
            for name in names:
                chunk = torch.cat(self._pending[name])
                self.sketches[name] = self.sketches[name].update(chunk, self.plan)
            self._clear_pending()
            return
        keys, items = self._keyed_buffer({name: row for row, name in enumerate(names)})
        bank = SketchBank.from_sketches([self.sketches[n] for n in names])
        bank = update_many(bank, keys, items, self.plan)
        for row, name in enumerate(names):
            self.sketches[name] = bank.row(row)
        self._clear_pending()

    def advance(self, steps: int = 1) -> None:
        """Windowed mode: open ``steps`` new epochs (flushes first, so
        everything observed so far belongs to the bucket being closed)."""
        self._require_window("advance")
        self.flush()
        self._ensure_wbank()
        self._wbank = self._wbank.advance(steps)
        self._wfold_cache = None
        if self._cmwin is not None:
            # the count-min ring slides in lockstep, so top-k answers cover
            # the same epochs as the cardinalities
            self._cmwin = self._cmwin.advance(steps)
            self._cmfold_cache = None

    def advance_to(self, epoch: int) -> None:
        """Windowed mode: jump the ring forward to absolute ``epoch``."""
        self._require_window("advance_to")
        self.flush()
        self._ensure_wbank()
        self._wbank = self._wbank.advance_to(epoch)
        self._wfold_cache = None
        if self._cmwin is not None:
            self._cmwin = self._cmwin.advance_to(epoch)
            self._cmfold_cache = None

    # ------------------------------------------------------------------
    # heavy hitters (track_topk boards; DESIGN.md §13)
    # ------------------------------------------------------------------

    def _cm_plan(self) -> Optional[ExecutionPlan]:
        """The board plan if its backend has a count-min path, else None.

        A plugin backend registered only for the HLL axes keeps working: its
        board falls back to the default count-min dispatch, the same
        degradation contract as the flat-flush bank fallback above.  Every
        built-in backend has a count-min path, so this never covers one.
        """
        try:
            get_cm_backend((self.plan or DEFAULT_PLAN).backend)
        except ValueError:
            return None
        return self.plan

    def _flush_topk(self) -> None:
        """Feed the buffered keyed stream into the count-min twin."""
        rowmap = self._wrows if self.window is not None else self._cm_rows
        for name in self._pending:
            if name not in rowmap:
                rowmap[name] = len(rowmap)
        keys, items = self._keyed_buffer(rowmap)
        rows = len(rowmap)
        plan = self._cm_plan()
        if self.window is not None:
            if self._cmwin is None:
                self._cmwin = WindowedCountMinBank.empty(self.window, rows, self.track_topk, self.device)
            elif rows > self._cmwin.rows:
                self._cmwin = self._cmwin.with_rows(rows)
            self._cmwin = self._cmwin.observe(keys, items, plan)
        else:
            if self._cmbank is None:
                self._cmbank = CountMinBank.empty(rows, self.track_topk, self.device)
            elif rows > len(self._cmbank):
                self._cmbank = self._cmbank.with_rows(rows)
            self._cmbank = self._cmbank.update_many(keys, items, plan)
        self._cmfold_cache = None

    def _cm_read_bank(self) -> Optional[CountMinBank]:
        """The flat count-min bank current through any window fold."""
        if self.window is None:
            return self._cmbank
        if self._cmwin is None:
            return None
        if self._cmfold_cache is None:
            self._cmfold_cache = self._cmwin.fold_window(plan=self._cm_plan())
        return self._cmfold_cache

    def _require_topk(self, op: str) -> None:
        if self.track_topk is None:
            raise ValueError(f"{op}() needs a heavy-hitter board (track_topk=CMConfig(...))")

    @staticmethod
    def _topk_row(vals: np.ndarray, cnts: np.ndarray) -> List[tuple]:
        return [(int(np.uint32(v)), int(c)) for v, c in zip(vals, cnts) if c > 0]

    def topk(self, name: str, k: int = 10) -> List[tuple]:
        """The stream's top-k heavy items as [(item, est_count), ...].

        Items come back as uint32 values; counts are count-min upper
        bounds.  On a windowed board the answer covers the sliding W-epoch
        window.  Streams this board has never seen report [].
        """
        self._require_topk("topk")
        self.flush()
        rowmap = self._wrows if self.window is not None else self._cm_rows
        bank = self._cm_read_bank()
        if bank is None or name not in rowmap or rowmap[name] >= len(bank):
            return []
        vals, cnts = bank.topk(k)
        row = rowmap[name]
        return self._topk_row(vals[row], cnts[row])

    def window_bytes(self) -> bytes:
        """Windowed mode: the whole ring as one RHLW blob (DESIGN.md §11).

        Row-to-name mapping travels separately (``window_rows()``).
        """
        self._require_window("window_bytes")
        self.flush()
        self._ensure_wbank()
        return self._wbank.to_bytes()

    def window_rows(self) -> tuple:
        """Stream names in bank-row order (row i holds names[i])."""
        self._require_window("window_rows")
        return tuple(sorted(self._wrows, key=self._wrows.get))

    def _require_window(self, op: str) -> None:
        if self.window is None:
            raise ValueError(f"{op}() needs a windowed board (window=W)")

    def merge_from(self, other: "StreamSketch") -> None:
        if self.window is not None or other.window is not None:
            raise ValueError(
                "windowed boards do not merge: epochs on different boards "
                "are not aligned; ship RHLW blobs (window_bytes) instead"
            )
        if other.cfg != self.cfg:
            raise ValueError(
                f"cannot merge boards with different configs: {self.cfg} vs {other.cfg}"
            )
        if self.track_topk != other.track_topk:
            raise ValueError(
                f"cannot merge boards with different track_topk configs: "
                f"{self.track_topk} vs {other.track_topk}"
            )
        self.flush()
        other.flush()
        for name, sk in other.sketches.items():
            self.sketches[name] = self.stream(name).merge(sk)
        if self.track_topk is not None and other._cmbank is not None:
            # align the other board's rows to this board's name -> row map,
            # then fold with ONE mergeable count-min merge (Topkapi rule)
            for name in other._cm_rows:
                if name not in self._cm_rows:
                    self._cm_rows[name] = len(self._cm_rows)
            rows = len(self._cm_rows)
            if self._cmbank is None:
                self._cmbank = CountMinBank.empty(rows, self.track_topk, self.device)
            elif rows > len(self._cmbank):
                self._cmbank = self._cmbank.with_rows(rows)
            dst = torch.tensor([self._cm_rows[n] for n in other._cm_rows], device=self.device)
            src = torch.tensor(list(other._cm_rows.values()), device=self.device)

            def place(theirs: torch.Tensor) -> torch.Tensor:
                out = torch.zeros((rows,) + tuple(theirs.shape[1:]), dtype=theirs.dtype, device=self.device)
                out[dst] = theirs.to(self.device)[src]
                return out

            theirs = other._cmbank
            aligned = CountMinBank(
                place(theirs.counters), place(theirs.labels), place(theirs.label_counts),
                place(theirs.n_items), self.track_topk,
            )
            self._cmbank = self._cmbank.merge(aligned)
            self._cmfold_cache = None

    def estimate(self, name: str, estimator: Optional[str] = None) -> float:
        """Exact host-side estimate for one stream (its sliding-window count
        on a windowed board)."""
        return self.stream(name).estimate(self._estimator(estimator))

    def serialize(self) -> Dict[str, bytes]:
        """Dense per-stream blobs (HyperLogLog.to_bytes) for shipping."""
        if self.window is not None:
            raise ValueError("windowed boards serialize the whole ring: use window_bytes()")
        self.flush()
        return {name: sk.to_bytes() for name, sk in self.sketches.items()}

    @classmethod
    def deserialize(
        cls,
        blobs: Dict[str, bytes],
        cfg: Optional[HLLConfig] = None,
        plan: Optional[ExecutionPlan] = None,
        device=None,
    ) -> "StreamSketch":
        """Rebuild a board from serialize() output.

        ``cfg`` is only required for a board serialized before its first
        observe(); when given, it must match the config recovered from the
        blobs.
        """
        device = hll.resolve_device(device)
        sketches = {n: HyperLogLog.from_bytes(b, device) for n, b in blobs.items()}
        if sketches:
            recovered = next(iter(sketches.values())).cfg
            for name, sk in sketches.items():
                if sk.cfg != recovered:
                    raise ValueError(
                        f"blob {name!r} config {sk.cfg} disagrees with the "
                        f"other streams on this board"
                    )
            if cfg is not None and cfg != recovered:
                raise ValueError(
                    f"cfg mismatch: blobs were serialized with {recovered}, "
                    f"deserialize was asked for {cfg}"
                )
            cfg = recovered
        elif cfg is None:
            raise ValueError("empty board: pass cfg= to deserialize it")
        return cls(cfg=cfg, plan=plan, sketches=sketches, device=device)

    def _board_registers(self) -> tuple:
        """(names, stacked (B, m) uint8 host registers) of the live board."""
        if self.window is not None:
            names = self.window_rows()
            if not names:
                return (), np.zeros((0, self.cfg.m), np.uint8)
            self._ensure_wbank()
            regs = self._window_fold().registers.cpu().numpy()
            return names, regs[[self._wrows[n] for n in names]]
        names = tuple(self.sketches)
        if not names:
            return (), np.zeros((0, self.cfg.m), np.uint8)
        return names, torch.stack([self.sketches[n].registers for n in names]).cpu().numpy()

    def density(self) -> Dict[str, object]:
        """Per-board register-density stats (DESIGN.md §12): how full each
        stream's registers are, how many streams are sparse-eligible, and
        what the board would cost under the hybrid sparse layout."""
        self.flush()
        names, regs = self._board_registers()
        m = self.cfg.m
        occ = (regs > 0).sum(axis=1)
        thr = self.plan.sparse_threshold if self.plan is not None else None
        if thr is None:
            thr = max(1, m // 4)
        # sparse rows cost ~4 bytes/pair + fixed per-row bookkeeping (§12)
        hybrid = int(np.where(occ > thr, m, 4 * occ + 16).sum())
        return {
            "streams": len(names),
            "occupancy": {n: float(occ[i] / m) for i, n in enumerate(names)},
            "occupancy_mean": float(occ.mean() / m) if len(names) else 0.0,
            "sparse_eligible": int((occ <= thr).sum()),
            "dense_nbytes": int(len(names) * m),
            "hybrid_nbytes_estimate": hybrid,
        }

    def report(
        self,
        exact: bool = False,
        estimator: Optional[str] = None,
        density: bool = False,
        topk: Optional[int] = None,
    ) -> Dict[str, dict]:
        """Per-stream estimates; one batched device finalization by default.

        Windowed boards report rolling counts over the sliding W-epoch
        window.  ``density=True`` adds a ``register_occupancy`` column;
        ``topk=k`` adds a ``topk`` column from ONE batched recovery over the
        whole board (heavy-hitter boards only).
        """
        if topk is not None:
            self._require_topk("report(topk=k)")
        self.flush()
        estimator = self._estimator(estimator)
        if self.window is not None:
            out = self._report_window(exact, estimator)
        else:
            out = self._report_flat(exact, estimator)
        if density:
            occ = self.density()["occupancy"]
            for name, row in out.items():
                row["register_occupancy"] = occ[name]
        if topk is not None:
            bank = self._cm_read_bank()
            rowmap = self._wrows if self.window is not None else self._cm_rows
            if bank is not None:
                vals, cnts = bank.topk(topk)
            for name, row in out.items():
                r = rowmap.get(name)
                if r is None or bank is None or r >= len(bank):
                    row["topk"] = []
                    continue
                row["topk"] = self._topk_row(vals[r], cnts[r])
        return out

    def _report_flat(self, exact: bool, estimator: str) -> Dict[str, dict]:
        names = list(self.sketches)
        if exact or not names:
            estimates = [self.sketches[n].estimate(estimator) for n in names]
        else:
            bank = torch.stack([self.sketches[n].registers for n in names])
            estimates = [float(e) for e in estimate_many(bank, self.cfg, estimator).cpu().numpy()]
        out = {}
        for name, est in zip(names, estimates):
            sk = self.sketches[name]
            out[name] = {
                "estimate": est,
                "items_seen": sk.count,
                "duplication": (sk.count / est) if est > 0 else float("nan"),
                "stderr_expected": sk.standard_error,
            }
        return out

    def _new_wbank(self, rows: int):
        """The board's window carrier: the dense ring, or the exponential
        histogram when ``window_levels`` is set."""
        if self.window_levels is not None:
            return MultiResWindowedBank.empty(
                self.window, rows, self.cfg, levels=self.window_levels, device=self.device
            )
        return WindowedBank.empty(self.window, rows, self.cfg, self.device)

    def _ensure_wbank(self) -> None:
        """Materialize/grow the ring for every registered stream row."""
        rows = max(1, len(self._wrows))
        if self._wbank is None:
            self._wbank = self._new_wbank(rows)
            self._wfold_cache = None
        elif rows > self._wbank.rows:
            self._wbank = self._wbank.with_rows(rows)
            self._wfold_cache = None

    def _report_window(self, exact: bool, estimator: str) -> Dict[str, dict]:
        names = self.window_rows()
        if not names:
            return {}
        self._ensure_wbank()
        # ONE (cached) ring fold; finalization is one batched estimate_many
        # or, for exact=True, the host finalizer per row
        folded = self._window_fold()
        if exact:
            estimates = [folded.estimate(self._wrows[n], estimator) for n in names]
        else:
            ests = folded.estimate_many(estimator).cpu().numpy()
            estimates = [float(ests[self._wrows[n]]) for n in names]
        counts = folded.counts
        stderr = hll.standard_error(self.cfg)
        out = {}
        for name, est in zip(names, estimates):
            seen = int(counts[self._wrows[name]])
            out[name] = {
                "estimate": est,
                "items_seen": seen,
                "duplication": (seen / est) if est > 0 else float("nan"),
                "stderr_expected": stderr,
            }
        return out
