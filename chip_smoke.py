#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py [--src DIR] [--time KERNEL,..] [--profile STEP,..]

Run from a checkout of the repo on a machine with a CUDA card and the CUDA
toolkit; it needs no arguments and no network.  With ``--time`` or
``--profile`` it runs only the timing of those kernels and the profile of
those steps, and prints no result line; ``--src DIR`` imports the port from
DIR (another tree's ``src/``, such as a parent commit's) instead of this
checkout's, so that two trees are measured by the same code: run parent,
change, change, parent in one call to compare them.  Phases, each of which
raises (exit code 1) when it fails:

  build    compile the fourteen kernels (twelve sources) from
           src/repro_torch/kernels/csrc with nvcc, one process per source,
           all at once; print the seconds and ptxas's register,
           shared-memory and spill report.
  kernels  each kernel against its plain PyTorch version on the card,
           bit for bit, at the main path's shapes and at ragged lengths,
           with the edge items 0, 0xFFFFFFFF and negative int32, and keys
           -1 and B for the bank; bank_scatter_max also on adversarial
           streams (every entry on one key and on one cell, B = 1, B - 1
           rows, p = 4 (the whole bank one tile) and p = 12, keys -1, B and
           2^31 - 1, buckets -1 and m, ranks 0 and 256, n in {0, 1, 127},
           2^25 + 5 entries in 2048 slices, and plans past the tiled limits,
           m = 2^17 and m = 20), each on the path it picks and on both paths
           where the tiled one's limits allow it, the input bank unchanged,
           printing the path each case took; bucket_fold at k in {1, 3, 8,
           9} x m in {16, 20, 2^14, 2^16} uint8, (5, 1001) int32 and rows
           off a 16-byte boundary; hash/rank also against the pure-python
           Murmur3 oracles; sparse_scatter_coo at p in {4, 8, 12, 16} with
           rows -1 and B and rank-0 entries, and on adversarial streams
           (every triple on one cell, one row at p = 16 spanning four
           tiles, only dropped entries, rows * m not a multiple of 2^14,
           ranks past 2^18) and on the global path; window_fold_max with every
           slice live, a suffix, none live, and W = 1; window_merge_max at
           K = 3; cm_scatter_add at d in {1, 4, 16} x w in {1, 1000, 1024,
           2^16}, lengths 2^22 + 3, 1 and 127, keys -1 and B, counters
           preset at 0xFFFFFFF0 so that the adds wrap, and on adversarial
           streams (every item on one key and one item, only dropped keys,
           B = 1, 1023 rows, w = 1000, 2^25 + 5 items in 2048 slices, the
           global path at the main config), printing the path each case
           took; hll_update_fused also on identical items, items off a
           16-byte boundary, n = 1 and 127, at p in {4, 16}, both widths,
           seed 2^64 - 1, onto zero and preset registers; cm_window_fold_sum
           on a (64, 1024, 4096) ring of counters >= 0xFFFFFFF0 with every
           slice live, a suffix, none live, W = 1, and a 35-counter plane
           (the scalar kernel); rwkv_intra at (G, C, N) = (5120, 64, 64)
           (the serve prefill's grid), (7, 40, 64), (3, 1, 64),
           (16, 64, 32), (5, 17, 64) and (3, 33, 30), and under strong
           decay (decay scale 50) at (5120, 64, 64), (64, 64, 64) and
           (2, 32, 32), within rtol 1e-5 and atol 1e-4, every output
           finite; rwkv_intra_bwd at the training grid (1280, 64, 64), the
           serve grid (5120, 64, 64), (3, 1, 64), (7, 40, 64),
           (5, 17, 30), (16, 64, 32), C in {8, 9, 57} at N = 64 and N in
           {1, 33} at C = 64, under strong decay (scale 50) at all of
           those but four small ones and at (2, 32, 32), at decay scale
           200 (the factors underflow) and with an all-zero dy: every
           gradient finite and within 1e-5 of its largest magnitude of the
           float32 plain version, both printed against the float64 plain
           version; its ptxas report and the blocks an SM holds;
           bank_row_count on Zipf(1.2) keys, dropped keys, one row and
           none, onto limbs near 2^32 and 2^64, at 1024 rows, at the path
           boundary and at HybridBank's chunk (16384 rows, 909,312 keys);
           cm_vote against the plain vote at d in {1, 4, 16} x w in {1,
           1000, 1024, 2^16}, n in {2^22 + 3, 1, 127}, Zipf(1.2) items with the
           int32 limits among them, onto random int32 tables, and on one key
           and one item taking every entry and on only dropped keys,
           printing the cells each case sent down the cooperative path;
           hll_estimate against its plain version (register_histogram_plain,
           _original_device) at p in {4, 12, 16} x H in {32, 64}: a bank
           fed Zipf(1.2)-keyed items with all-zero, saturated, one-rank and
           corrupt rows added, one (m,) sketch, and rows off a 16-byte
           boundary; the counts bit for bit, the estimates within 1e-6.
  stream   the paper's NIC deployment (Tab. IV), lengthened: 2^26 uint32
           items in 16 chunks of 2^22 through ``update_registers`` under
           "cuda" and "cuda_pipelined" (k = 8), for (p, H) in
           {14, 16} x {32, 64}; registers bit-identical to the "torch"
           backend on the card, estimate within 4 standard errors of the
           exact distinct count.
  bank     a 1024-tenant p = 16, H = 64 SketchBank (64 MiB of uint8
           registers): 8 ticks of 2^22 items with Zipf(1.2) tenant keys
           through ``update_many`` under "cuda", bit-identical to "torch";
           ``estimate_many`` against each row's exact distinct count; the
           RHLB bytes round-trip.
  hybrid   the acceptance deployment of benchmarks/bench_sparse.py at
           full size: a 16384-row HybridBank, p = 12, H = 64, threshold
           m // 4, 222 items per row in 4 chunks, 10 % of the rows taking
           90 % of the items, read (settled) after every chunk, under
           "cuda" and under "torch": settled state bit-identical between
           the two; to_dense() equal to a SketchBank fed the same stream;
           the LC fast path's estimates equal to that bank's; every row in
           the bench's Bonferroni band; RHLB v2 bytes round-trip.
  window   three rings on Zipf(1.2) tenant traffic, 2^20 items an epoch:
           a WindowedBank W = 64, B = 1024, p = 12, H = 64 (a 256 MiB
           ring) over 2W epochs, whose estimate_window() and
           estimate_window(W // 4) under "cuda" equal "torch" every 8th
           epoch and whose incremental full read equals a cold fold; a
           MultiResWindowedBank (base 4, levels 4) and a
           HybridWindowedBank (W = 16) on the same traffic, equal to
           "torch"; RHLW v1, v3 and v2 bytes round-trip.
  countmin bench_heavy's largest CountMinBank, B = 1024, CMConfig(4,
           1024) (serve.py's --cm-depth/--cm-width; 48 MiB of counters,
           labels and votes): 8 ticks of 2^22 items, Zipf(1.2) tenant keys
           with keys -1 and B mixed in, Zipf(1.1) items over 2^20 ids,
           under "cuda" and "torch": counters, labels, votes and counts
           bit-identical; 4096 probes (the 64 heaviest ids + random ones)
           queried equal under both plans and never below the exact count;
           topk(10) equal; the true top-1 id of each of the 16 busiest rows
           in its topk(10); RCMB round trip; merge of two halves equal to
           one ingest; labels and votes equal to the plain vote
           (_label_update) tick by tick, since the vote is the kernel under
           both plans; the ticks launched cm_vote once each; cm_vote alone
           at the tick's shape on this phase's ticks and on uniform keys
           and items (the benchmark cell's), device and host ms, its bytes
           bound, the plain vote's wall ms, the last tick's cells on the
           cooperative path.
  cm_window  a WindowedCountMinBank W = 64, B = 1024, CMConfig(4, 1024)
           (a 3 GiB ring) over 2W epochs of 2^20 items with one advance_to
           jump of W + 3: fold_window() and fold_window(W // 4) under "cuda"
           equal "torch" every 8th epoch, and query_window of 4096 probes;
           RCMW round trip on a W = 8 ring of the same B.
  board    serve.py's telemetry board, StreamSketch(HLLConfig(12, 64),
           track_topk=CMConfig(4, 1024)), flat and windowed (W = 16), 256
           named streams, 32 epochs of 2^20 token ids (Zipf(1.1) over the
           50257-token GPT-2 vocabulary) split over the streams by
           Zipf(1.2), under "cuda" and "torch": report(exact=True) equal,
           report() within rtol 1e-6, topk(name, 5) equal for every
           stream, serialize() / window_bytes() equal.
  serve    RWKV6-3B serving at full width (get_arch("rwkv6-3b"): 32 layers,
           d_model 2560, 40 heads of 64, vocab 65536, chunk 64; 3.1 B
           float32 parameters drawn on the card from a seeded generator):
           8 requests of 1024-token prompts through engine.prefill (each
           layer launches rwkv_intra once over 8 * 16 * 40 = 5120 cells),
           32 greedy steps of engine.decode_loop, and a StreamSketch board
           (p = 12, H = 64) over the request ids, prompt tokens and
           generated tokens, as examples/serve_lm.py runs them.  Checks:
           the prefill against the same prefill with rwkv_intra_plain
           (last-position logits, the final states, the first greedy
           token); prefill + teacher-forced decode_step against forward at
           2 full-width layers; a 40-token (C = 40) and a 100-token (the
           per-token scan) prompt against the plain run; tokens in the
           vocabulary, logits finite; each board estimate within 4 sigma
           of the exact distinct count.  Prints prefill and decode tokens
           per second, peak device memory and rwkv_intra's share of the
           prefill (its device time from the profiler over a prefill).
  launch   the port's serve launcher, ``repro_torch.launch.serve.main``
           called in-process as ``--arch rwkv6-3b --full-config --requests 8
           --prompt-len 1024 --gen-len 32 --report-every 4 --metrics-out
           build/launch_metrics.json``, under a trace capture written to
           build/launch_trace.json: the snapshot must count 8 coalescer
           submits, at least one tick and 8 request reads, window fold-cache
           hits, and dispatches through the cuda backends only; the trace
           must hold the prefill, decode and 8 request spans and the
           dispatch seams; every kernel of LAUNCH_KERNELS must launch.
           Prints the launcher's own prefill and decode tokens per second,
           peak device memory and the snapshot's [metrics] line; then runs
           the launcher once more under the profiler (busy time, idle share
           against the first run's wall, top device entries).
  obs      benchmarks/bench_obs.py at the bank tick's shape (SketchBank
           1024 x p = 16, 2^22 Zipf(1.2)-keyed items): the median wall of
           update_many (synchronized) over 80 calls an arm, with the
           instrumentation passed through, disabled, enabled, and enabled
           under a trace, the arms in turn; the three ratios over
           passthrough are printed, not gated.  Gated: the synchronizing
           calls (torch.cuda.set_sync_debug_mode) of one
           SketchBank.update_many, HyperLogLog.update, HybridBank.update_many
           with its settling read, and WindowedBank.estimate_window must not
           grow when metrics and a trace are on.
  placement  every sketch carrier at its phase's shape under placement
           "sharded" and "mesh" over a 4-position mesh on the one card
           ([cuda:0] * 4: four row blocks, four stream shards) and over a
           mesh of the visible cards, under "cuda", bit-identical to
           placement "local": the bank (1024 x p = 16, 2 ticks of 2^22
           Zipf(1.2)-keyed items; registers, counters, estimates, RHLB),
           the hybrid bank (B = 16384, p = 12; settled state, estimates,
           RHLB v2), the ring (W = 64, B = 1024, p = 12, W + 4 epochs of
           2^20 items; folds and full and suffix reads every 16 epochs,
           the ring, RHLW), count-min (1024 x CMConfig(4, 1024), 2^22 + 3
           items; counters, labels, votes, RCMB) and one stream sketch
           (p = 16, 4 chunks of 2^22 + 5 items) under "cuda" and
           "cuda_pipelined".  Prints the walls of local and sharded bank
           ingest (the last tick again) and read, 10 each in turns after a
           warm-up round, and the bank_scatter_max path of each block.
  attn_serve  TinyLlama-1.1B unreduced (22 layers, d 2048, 32 heads over
           4 KV heads, d_ff 5632, vocab 32000; 1.1 B float32 parameters
           drawn on the card) through ``repro_torch.launch.serve.main``
           with its default arch and the launch phase's traffic (8 x
           1024-token prompts, 32 greedy steps), with --placement local
           and sharded in turns, twice: the same printed telemetry, every
           kernel of ATTN_LAUNCH_KERNELS launched in each run; prints
           prefill and decode tokens/s and peak device memory.  Then at 2
           full-width layers: prefill of 256 tokens + 8 teacher-forced
           decode steps against forward, in float32 (atol 2e-3), in bf16
           (atol 0.15), in float32 with a 128-token sliding window (the
           ring wraps), and in bf16 with the int8 KV cache (atol 0.3); and
           a ContinuousBatcher of 6 prompts of 37-511 tokens over 4 slots
           at full width in float32, each request's tokens held to its solo
           decode (a token may differ only where solo's top logit leads it
           by at most 1e-3; the agreement is printed).
  family_serve  the MoE and RG-LRU hybrid families: olmoe-1b-7b unreduced
           (16 layers, d 2048, 64 experts of 1024, top-8, vocab 50304; 6.9 B
           float32 parameters drawn on the card) and recurrentgemma-9b
           unreduced (38 layers as 12 x (rec, rec, attn) + 2 rec, d 4096,
           MQA, local window 2048, vocab 256000, tied; 9.4 B) through
           ``repro_torch.launch.serve.main`` with the launch phase's traffic,
           every kernel of ATTN_LAUNCH_KERNELS launched in each run; prints
           prefill and decode tokens/s, peak device memory and, for olmoe,
           the (token, choice) pairs each prefill layer dropped past capacity
           (groups of 1024 tokens, capacity 160); the layer-0 assignment
           stream of that prefill (``moe.assignment_stream``) on a
           StreamSketch within 4 sigma of its exact distinct pairs, and a
           collapsed stream (every choice -> expert 0) below it / 1.5.  At
           full width over 2 layers (olmoe-1b-7b, mixtral-8x7b) and 3
           (recurrentgemma-9b): prefill of 248 tokens + 8 teacher-forced
           decode steps against forward in float32 (atol 2e-3) and bf16
           (atol 0.15; for MoE up to the first position whose routing
           differs from forward's, which must be a near-tie: the swapped
           experts' forward logits no further apart than twice the change
           of that token's logits), every routing of both legs equal to its
           float64 recomputation from the same router logits, again over
           1024-token groups where capacity drops; the RG-LRU scan over 1024
           tokens within 4e-6 of the largest |h| of a float64 sequential
           scan; a ContinuousBatcher of 6 prompts of 37-511 tokens over 4
           slots at full width in float32 for olmoe-1b-7b and
           recurrentgemma-9b, held to solo decodes as in attn_serve.
  train    the port's train launcher, ``repro_torch.launch.train.main``,
           at full width for smollm-360m and TinyLlama-1.1B (8 x 1024
           tokens a step) and RWKV6-3B (4 x 1024 in 2 micro-batches), 4
           steps each with float32 AdamW state at --lr 2e-5: per arch tokens/s (steps
           after the first), peak device memory, the tap's share of a step
           (CUDA events), loss, distinct_tokens and grad norm per step, the
           exact-finalized estimate against the exact distinct tokens
           (within 4 sigma); the tap's registers equal to the plain
           hll.update of the same tokens; the card's zipf batches against
           the CPU's (each differing token one off at an integer boundary,
           no more than zipf_flip_bound: the expected number of tokens a
           one-ulp change of their exp moves); the loss falling; hll_update_fused launched
           once a step, and for RWKV6-3B rwkv_intra twice (the forward and
           the checkpoint's recompute) and rwkv_intra_bwd once a layer and
           micro-batch.  Then RWKV6-3B's loss and gradients of one 2 x 1024
           micro-batch with the kernel pair against the plain pair, within 2
           x a control's change (the plain pair's outputs times 1 + 2^-20
           N(0, 1)); and, under torch.use_deterministic_algorithms, a
           2-layer full-width smollm-360m: 4 steps straight equal to 2, a
           checkpoint and a resumed run, and a save/restore round trip,
           every leaf.
  sharding the partition rules and the compressed all-reduce: param_specs
           and cache_specs of the ten archs at full width (on ``meta``; the
           decode_32k and long_500k caches) divisible on the production
           16 x 16 mesh; no leaf over 50 M parameters of qwen2-vl-72b and
           mixtral-8x7b replicated, each such stacked layer leaf over FSDP;
           compressed_psum over 4 positions of the card (2^22 float32 each)
           within 2 % of the largest |sum| + 1e-3 of the float32 sum, its
           int8 payloads and scales equal to quantize_int8 of each
           position, and the mean reducer likewise; one full-width
           smollm-360m train step (4 x 1024) through make_jitted_step with a
           (1, 1) mesh's shardings and activation hints equal to the plain
           step, every leaf and the loss, under deterministic algorithms.
  dryrun   ``repro_torch.launch.dryrun`` over every (arch x shape) cell of
           the ten archs and configs.SHAPES on the 16 x 16 mesh, in
           DRYRUN_JOBS (8) processes: no cell in error, each cell's per-position
           peak, fits and roofline printed; then the dry-run's whole-program
           peak of the cells the train and serve phases run at full width
           (train: smollm-360m and TinyLlama-1.1B at 8 x 1024, RWKV6-3B at
           4 x 1024 in 2 micro-batches; prefill: RWKV6-3B and TinyLlama-1.1B
           at 8 x 1024) beside the card's max_memory_allocated over one step
           of the same callable; each must be predicted to fit, as it did.
  sketch_roofline  ``repro_torch.launch.sketch_roofline`` at 2^28 items,
           p = 16: scatter and hash32 (backend cuda), pipelined4/8/16
           (cuda_pipelined), each variant's median device ms over 5 rounds
           of 10 calls, its op-analysis terms and its fraction of the
           stream read once (0.3205 ms); registers bit-identical to the
           "torch" backend's.
  examples the five examples of examples_torch/, each ``main`` called
           in-process with --device cuda.  stream_cardinality at its
           defaults (16 chunks of 2^20 zipf items over V = 2^31 - 1, p = 16,
           8 pipelines), with --tenants 64, with --tenants 16 --window 8
           --advance-every 2, the same with --window-levels 3, and with
           --distribution unique: each run's registers, bank or ring and
           readings equal to the same stream through the "torch" backend on
           the card, the unique estimate within 4 sigma of n; items/s and
           finalization us printed; then the card's zipf tokens of those 16
           chunks against the CPU's (each within 2 ulps of its value, since
           expf on the card is within 2 ulps, and at an integer boundary
           below 2^23; no more than zipf_flip_bound at rate 1), with the
           share of exponents whose exp differs.  quickstart as is (5 M
           items, p = 16): the estimate within 4 sigma of the exact count,
           the blob's round trip, the registers of HyperLogLog.of, the
           pipelined stream and the union equal to the "torch" backend's,
           the top 8 values ids 0-7.  serve_lm at its defaults (reduced
           TinyLlama-1.1B, 8 x 64 prompts, 32 steps) and with --arch
           rwkv6-3b: the board's items seen equal to the items observed;
           prefill and decode tokens/s.  train_lm at its defaults (reduced
           smollm-360m, 200 steps; the loss falls), killed at step 20
           (--ckpt-every 10) and rerun to 40 in the same directory (it logs
           the resume from step 20), and --full-config --arch smollm-360m
           --steps 8 --ckpt-every 8 (tokens/s after the first step, peak
           device memory, the tap's estimate within 4 sigma of the exact
           distinct tokens), each into a fresh temporary directory deleted
           after it (a full-width checkpoint is ~4.3 GB).  elastic_rescale
           as is (20 + 20 steps): the registers equal across the resharded
           restore, resumed to step 40.
  timing   each kernel's device time (CUDA events over warm launches
           queued back to back) and host time per call, its bound (the
           larger of bytes over 3.35 TB/s and float32 operations over
           67 TFLOP/s), its plain version's time and, where one PyTorch
           call computes the same function, that call's time;
           cm_scatter_add, hll_update_fused, bank_scatter_max,
           bucket_fold and rwkv_intra_bwd in 5 rounds (min, median, max;
           the record takes the first, as every row); bucket_fold's floor, the time of a (1, 16)
           fold; beside them sparse_scatter_coo and cm_scatter_add on
           their global paths (the previous designs), and bank_scatter_max
           on both paths at each caller's shape and at banks of 16, 32 and
           48 MiB, on random registers and on the registers one update
           leaves (the numbers of bank_scatter.py's path rule);
           hll_estimate's "original" read at the fleet's (1024, 4096) bank
           and, beside it, at a (1, 65536) sketch, each against the plain
           read (wall clock: its bincount reads back to the host).
  profile  torch.profiler over a few stream chunks, bank ticks (local and
           over 4 row blocks) and their bank_scatter_max alone, hybrid
           ticks, full-window reads, count-min ticks, their label votes
           alone and their cm_scatter_add alone, full-window reads of the
           count-min ring, full-width RWKV6-3B, TinyLlama-1.1B,
           olmoe-1b-7b and recurrentgemma-9b prefills and decode steps (one
           model on the card at a time), and, only when --profile names
           them (train_attn, train_rwkv), a full-width train step of
           TinyLlama-1.1B and of RWKV6-3B, after a warm-up step: wall and device-busy time per step, idle
           share, top device entries.

The launch counters are zeroed just before the stream, bank, hybrid,
window, countmin, cm_window and board phases (the sketch paths) and read
just after; the ten sketch kernels must have launched there.  They are
zeroed again just before the serve phase and read just after; rwkv_intra
must have launched there, once per layer of every prefill whose prompt a
chunk divides.  They are zeroed once more just before the launch phase's
run and read just after it; every kernel of LAUNCH_KERNELS must have
launched there.  They are zeroed just before the placement phase and read
just after; every kernel of PLACEMENT_KERNELS must have launched there;
and just before and after each launcher run of the attn_serve and
family_serve phases, where every kernel of ATTN_LAUNCH_KERNELS must have
launched, and of the train phase, where the train path's kernels must have
launched the counts above; and just before and after the sketch_roofline
phase's runs, where hll_update_fused and bucket_fold must have launched;
and just before and after each example's run of the examples phase, where
the kernels of EXAMPLE_STREAM_RUNS, EXAMPLE_QUICKSTART_KERNELS,
EXAMPLE_SERVE_RUNS and EXAMPLE_TRAIN_KERNELS must have launched (rwkv_intra
once a layer of the RWKV6 prefill, the tap once a training step).
After the kernels
phase it checks that the count-min main
path's shapes take the tiled cm_scatter_add, and the bank tick the tiled
bank_scatter_max.
Before the last line it prints the kernels' JSON record and the card's
name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
With no card it raises before printing any result.
"""

from __future__ import annotations

import argparse
import ctypes
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch



def _port_src() -> Path:
    """Where the port is imported from: this checkout's ``src/``, or DIR
    after ``--src DIR``."""
    args = sys.argv[1:]
    if "--src" in args[:-1]:
        return Path(args[args.index("--src") + 1]).resolve()
    return Path(__file__).resolve().parent / "src"


sys.path.insert(0, str(_port_src()))

from repro_torch.kernels import KERNELS, _build, launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.bank_scatter import bank_scatter_max, bank_scatter_max_plain  # noqa: E402
from repro_torch.kernels.bucket_fold import bucket_fold, bucket_fold_plain  # noqa: E402
from repro_torch.kernels.cm_scatter import (  # noqa: E402
    cm_scatter_add,
    cm_scatter_add_plain,
    cm_window_fold_sum,
    cm_window_fold_sum_plain,
)
from repro_torch.kernels.hash_rank import hash_rank, hash_rank_plain  # noqa: E402
from repro_torch.kernels.hll_fused import hll_update_fused, hll_update_fused_plain  # noqa: E402
from repro_torch.kernels import bank_scatter as bank_module  # noqa: E402
from repro_torch.kernels import sparse_scatter as sparse_module  # noqa: E402
from repro_torch.kernels import cm_scatter as cm_module  # noqa: E402
from repro_torch.kernels import hll_fused as hll_module  # noqa: E402
try:  # a tree from before the counters' kernel (--src) has no bank_count
    from repro_torch.kernels import bank_count as count_module  # noqa: E402
except ImportError:
    count_module = None
try:  # a tree from before the vote's kernel (--src) has no cm_vote
    from repro_torch.kernels import cm_vote as vote_module  # noqa: E402
except ImportError:
    vote_module = None
try:  # a tree from before the estimate's kernel (--src) has no hll_estimate
    from repro_torch.kernels import hll_estimate as estimate_module  # noqa: E402
except ImportError:
    estimate_module = None
from repro_torch.kernels.rwkv_intra import (  # noqa: E402
    rwkv_intra,
    rwkv_intra_bwd,
    rwkv_intra_bwd_plain,
    rwkv_intra_plain,
)
from repro_torch.kernels.sparse_scatter import sparse_scatter_coo, sparse_scatter_coo_plain  # noqa: E402
from repro_torch.kernels.window_fold import (  # noqa: E402
    window_fold_max,
    window_fold_max_plain,
    window_merge_max,
    window_merge_max_plain,
)
from repro_torch.sketch import (  # noqa: E402
    CMConfig,
    CountMinBank,
    ExecutionPlan,
    HLLConfig,
    HybridBank,
    HybridWindowedBank,
    HyperLogLog,
    MultiResWindowedBank,
    SketchBank,
    WindowedBank,
    WindowedCountMinBank,
    reference_plan,
)
from repro_torch.sketch import u64  # noqa: E402
from repro_torch.sketch.countmin import _label_update, cm_hash_index  # noqa: E402
from repro_torch.sketch.murmur3 import murmur3_32_py, murmur3_64_py  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import rglru, rwkv6, transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.telemetry import StreamSketch  # noqa: E402

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (NVIDIA data sheet)
STREAM_CONFIGS = ((14, 32), (14, 64), (16, 32), (16, 64))
STREAM_CHUNKS = 16
STREAM_CHUNK_ITEMS = 1 << 22
PIPELINES = 8
BANK_ROWS = 1024
BANK_TICKS = 8
BANK_TICK_ITEMS = 1 << 22
COUNT_TICK_KEYS = 1 << 25  # the fleet tick of perfbench's tenant_fleet cells
COUNT_LARGE_ROWS = 1 << 20  # a bank past bank_row_count's shared path
ZIPF_A = 1.2  # tenant skew of benchmarks/bench_serve.py
HYBRID_ROWS = 16384  # benchmarks/bench_sparse.py, acceptance size
HYBRID_ITEMS_PER_ROW = 222
HYBRID_CHUNKS = 4
HOT_FRAC, HOT_SHARE = 0.1, 0.9  # 10 % of the rows take 90 % of the items
BAND_ALPHA = 0.01  # the bench's family-wise error budget
WINDOW = 64  # the top of benchmarks/bench_window.py's W sweep
WINDOW_ROWS = 1024
WINDOW_EPOCH_ITEMS = 1 << 20
HYBRID_WINDOW = 16
MR_BASE, MR_LEVELS = 4, 4
EDGE_ITEMS = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1], dtype=np.uint32)
# count-min: bench_heavy.py's largest bank and serve.py's --cm-depth/--cm-width
CM_ROWS, CM_DEPTH, CM_WIDTH = 1024, 4, 1024
CM_TICKS = 8
CM_TICK_ITEMS = 1 << 22
CM_ITEM_IDS = 1 << 20
CM_ITEM_ZIPF = 1.1  # item skew: every tenant row has heavy hitters
CM_PROBES = 4096
CM_BYTES_WINDOW = 8  # the RCMW round trip's ring (a W = 64 ring is 3 GiB)
CM_CELL_CAP = 1 << 26  # kernel-phase banks: at most 256 MiB of counters
# the telemetry board of serve.py: HLL p = 12, H = 64 + CMConfig(4, 1024)
BOARD_STREAMS = 256
BOARD_EPOCHS = 32
BOARD_EPOCH_ITEMS = 1 << 20
BOARD_WINDOW = 16
GPT2_VOCAB = 50257  # the serve path's token streams
# RWKV6-3B serving: launch/serve.py's --requests and --gen-len defaults,
# the prompt lengthened to 16 chunks of 64
SERVE_ARCH = "rwkv6-3b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN = 8, 1024, 32
CHECK_LAYERS = 2  # full-width layers of the teacher-forced and ragged legs
TF_PROMPT, TF_STEPS = 128, 64  # prefill of 2 chunks, then 64 steps against forward of 3 chunks
RAGGED_PROMPTS = (40, 100)  # one short chunk (C = 40), and the per-token scan
INTRA_SHAPES = ((5120, 64, 64), (7, 40, 64), (3, 1, 64), (16, 64, 32), (5, 17, 64), (3, 33, 30))
INTRA_STRONG = ((5120, 64, 64), (64, 64, 64), (2, 32, 32))  # decay scale 50
INTRA_RTOL, INTRA_ATOL = 1e-5, 1e-4  # tests/test_rwkv_intra_kernel.py's tolerance
# the kernel prefill against the plain one: within SERVE_NOISE_FACTOR x the
# mean change that a relative N(0, SERVE_NOISE^2) error of the plain intra
# term makes
SERVE_NOISE, SERVE_NOISE_FACTOR = 2.0 ** -20, 2.0
# prefill + teacher-forced decode vs forward (tests/test_serve.py allows
# 0.1 / 0.15 at the reduced size)
SERVE_TF_ATOL = 0.15

# rwkv_intra_bwd against its plain version: the training grid (a micro-batch
# of 2 sequences x 16 chunks x 40 heads), C = 1, ragged chunks (one and a
# half sub-chunks, 57 = 7 x 8 + 1), N = 1, 30 and 33, the serve grid (every
# cell checked for races), strong decay (scale 50), decay scale 200 (the
# two-level factors underflow) and an all-zero dy; each gradient within
# INTRA_BWD_TOL of its largest magnitude
INTRA_BWD_RAGGED = ((40, 8, 64), (40, 9, 64), (40, 57, 64), (40, 64, 1), (40, 64, 33), (5120, 64, 64))
INTRA_BWD_SHAPES = ((1280, 64, 64), (3, 1, 64), (7, 40, 64), (5, 17, 30), (16, 64, 32)) + INTRA_BWD_RAGGED
INTRA_BWD_STRONG = ((1280, 64, 64), (2, 32, 32)) + INTRA_BWD_RAGGED
INTRA_BWD_UNDERFLOW = ((1280, 64, 64), (40, 57, 64))  # decay scale 200
INTRA_BWD_ZERO_DY = ((1280, 64, 64),)
INTRA_BWD_TOL = 1e-5
# timed in rounds, min/median/max printed
SPREAD_KERNELS = ("cm_scatter_add", "hll_update_fused", "bank_scatter_max", "bucket_fold", "rwkv_intra_bwd")
SPREAD_ROUNDS = 5
# whose plain and library calls read back to the host (torch.bincount, the
# plain vote's unique_consecutive): timed by the synchronized wall clock
# (_wall_ms)
HOST_READS = ("bank_row_count", "cm_vote", "hll_estimate")
# hll_estimate's estimates against the plain finalize: its harmonic sum is
# float64 rounded once, the plain one a float32 matrix-vector product
ESTIMATE_RTOL = 1e-6
PROFILE_ATTEMPTS = 3  # recordings of a profile step before its partial one is reported
# profiled only when --profile names them: a full-width train step launches
# ~10^5 kernels, and their recording took 399 s of a call (NVIDIA H100 80GB
# HBM3, 700.00 W), a third of the script's time limit
PROFILE_ON_REQUEST = ("train_attn", "train_rwkv")
SERVE_KERNELS = ("rwkv_intra",)  # launched on the serve phase; the others but the next on the sketch phases
TRAIN_ONLY_KERNELS = ("rwkv_intra_bwd",)  # launched on the train phase alone


def _sorted_unique(values: np.ndarray) -> np.ndarray:
    """The distinct values, ascending -- what ``np.unique`` returns, from one
    ``np.sort`` and a neighbour compare.  With the numpy of an H100 host,
    ``np.unique`` kept the stream phase busy for minutes (190-257 s; under
    2 s with this)."""
    s = np.sort(values)
    keep = np.ones(s.shape, dtype=bool)
    keep[1:] = s[1:] != s[:-1]
    return s[keep]


def _items_tensor(values: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(values.astype(np.uint32).view(np.int32)).to(device)


def _max_abs_err(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Max |a - b|; raises unless the two are bit-identical."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    err = float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0.0
    if err != 0.0:
        raise AssertionError(f"{what}: kernel and plain version differ (max abs err {err})")
    return err


def _close_err(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float, what: str) -> float:
    """Max |got - want|; raises unless both are finite and |got - want| <=
    atol + rtol * |want| everywhere."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes {tuple(got.shape)} vs {tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what}: max abs err {float(diff.max())} beyond rtol {rtol}, atol {atol}")
    return float(diff.max()) if diff.numel() else 0.0


def _intra_inputs(g: int, c: int, n: int, gen: torch.Generator, device, decay_scale: float = 1.0) -> tuple:
    """tests/test_rwkv_intra_kernel.py's inputs: r, k, v ~ N(0, 1), log-decays
    -U(0.01, decay_scale) summed within the chunk, u ~ N(0, 0.3^2)."""
    def normal(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=device) * std

    r, k, v = normal(g, c, n), normal(g, c, n), normal(g, c, n)
    lw = -(0.01 + (decay_scale - 0.01) * torch.rand((g, c, n), generator=gen, device=device))
    lcum = torch.cumsum(lw, dim=1)
    return r, k, v, lcum - lw, lcum, normal(g, n, std=0.3)


def _intra_bwd_inputs(g: int, c: int, n: int, gen: torch.Generator, device, decay_scale: float = 1.0) -> tuple:
    """_intra_inputs and an output gradient dy ~ N(0, 1)."""
    args = _intra_inputs(g, c, n, gen, device, decay_scale)
    return args + (torch.randn((g, c, n), generator=gen, device=device),)


def _scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the largest |want|."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _intra_bwd_case(args, what: str, tol: float = INTRA_BWD_TOL) -> dict:
    """rwkv_intra_bwd against rwkv_intra_bwd_plain (float32) and both against
    the float64 plain version; raises unless every gradient is finite and
    within ``tol`` of its largest magnitude of the float32 plain one."""
    got = rwkv_intra_bwd(*args)
    plain = rwkv_intra_bwd_plain(*args)
    wide = rwkv_intra_bwd_plain(*(a.double() for a in args))
    row = {"max_abs_err": 0.0, "kernel_vs_plain": 0.0, "kernel_vs_float64": 0.0, "plain_vs_float64": 0.0}
    for name, gt, pt, wt in zip(("r", "k", "v", "lex", "lcum", "u"), got, plain, wide):
        if not (torch.isfinite(gt).all() and torch.isfinite(pt).all()):
            raise AssertionError(f"{what}: d{name} not finite")
        err = _scaled_err(gt, pt)
        if err > tol:
            raise AssertionError(f"{what}: d{name} {err} of its largest magnitude from the plain version, "
                                 f"beyond {tol}")
        row["max_abs_err"] = max(row["max_abs_err"], float((gt - pt).abs().max()))
        row["kernel_vs_plain"] = max(row["kernel_vs_plain"], err)
        row["kernel_vs_float64"] = max(row["kernel_vs_float64"], _scaled_err(gt, wt))
        row["plain_vs_float64"] = max(row["plain_vs_float64"], _scaled_err(pt, wt))
    return row


def _intra_bwd_occupancy() -> str:
    """rwkv_intra_bwd's ptxas report (registers, stack, spills of both
    instantiations), its dynamic shared bytes a block and the blocks an SM
    holds (the occupancy calculator's answer)."""
    fn = _build.function("rwkv_intra_bwd", "rwkv_intra_bwd_occupancy", [ctypes.POINTER(ctypes.c_int)])
    shared = ctypes.c_int(0)
    blocks = fn(ctypes.byref(shared))
    if blocks < 1:
        raise AssertionError(f"rwkv_intra_bwd: the occupancy query returned {blocks}")
    ptxas = "; ".join(line.split(":", 1)[-1].strip() for line in _build.build_log("rwkv_intra_bwd").splitlines()
                      if "Used" in line or "spill" in line)
    return f"ptxas {ptxas}; {shared.value} dynamic shared bytes a block; {blocks} blocks an SM"


def _stream_items(n: int, rng: np.random.Generator) -> np.ndarray:
    """n uint32 items with the edge values at the front."""
    values = rng.integers(0, 2**32, n, dtype=np.uint32)
    values[: min(n, EDGE_ITEMS.size)] = EDGE_ITEMS[: min(n, EDGE_ITEMS.size)]
    return values


# ----------------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------------


def phase_build() -> dict:
    t0 = time.perf_counter()
    seconds = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f} s wall, nvcc seconds {seconds}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print("[build] dynamic shared memory per block: hll_fused's file pass m bytes (65536 at p = 16); "
          "cm_scatter 4 * (counters of a tile + 2 slices + 1) a tile block (67,652 at the main shape), "
          "4 * (tiles + 4 + items a slice) a partition block (64,592 at the main shape); "
          "bank_scatter 65536 + 4 * (2 slices + 1) a tile block (67,652 at the main shape), "
          "4 * (tiles + 4 + entries a slice) a partition block (67,664 at the main shape), "
          "8 * (tiles + 1) the plan block; "
          "rwkv_intra 72960 bytes at C = N = 64; rwkv_intra_bwd 109824 bytes (any C, N); "
          "sparse_scatter 4 * (2^14 + 2^10 + 2 slices + 1) a tile block (71748 at 264 slices), "
          "4 * (tiles + 4 + triples a slice) a partition block (71520 on the bench_sparse stream); "
          "the other kernels none")
    return seconds


@contextlib.contextmanager
def _setting(module, name: str, value):
    """Set ``module.name`` to ``value`` for the ``with`` block."""
    before = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, before)


def _sparse_adversarial(n: int, rows: int, m: int, rng: np.random.Generator) -> dict:
    """sparse_scatter_coo's hard streams, {name: (row, bucket, rank, rows, m)}:
    every triple on one cell, one row at p = 16 (four tiles), only dropped
    entries, rows * m not a multiple of 2^14 (m = 5000), ranks past 2^18."""
    drop = rng.integers(0, 4, n)
    return {
        "one cell": (np.full(n, rows // 2, np.int32), np.full(n, m - 1, np.int32),
                     rng.integers(1, 60, n).astype(np.int32), rows, m),
        "one row p=16": (np.zeros(n, np.int32), rng.integers(0, 1 << 16, n).astype(np.int32),
                         rng.integers(0, 60, n).astype(np.int32), 1, 1 << 16),
        "all dropped": (np.where(drop == 0, -1, np.where(drop == 1, rows, 0)).astype(np.int32),
                        np.where(drop == 2, m, np.where(drop == 3, -1, 0)).astype(np.int32),
                        np.where(drop < 2, 5, 0).astype(np.int32), rows, m),
        "ragged cells": (rng.integers(-1, 1001, n).astype(np.int32), rng.integers(0, 5000, n).astype(np.int32),
                         rng.integers(0, 60, n).astype(np.int32), 1000, 5000),
        "wide ranks": (rng.integers(0, rows, n).astype(np.int32), rng.integers(0, m, n).astype(np.int32),
                       rng.integers(0, 2**31 - 1, n).astype(np.int32), rows, m),
    }


def _sms(device) -> int:
    """The card's SMs, the launch plans' input (132 on an H100 SXM; the CPU
    rehearsal, which runs the plain versions, plans as for that card)."""
    return _build.sm_count(torch.device(device)) if torch.device(device).type == "cuda" else 132


def _cm_path(rows: int, cfg: CMConfig, n: int, device) -> str:
    """The path cm_scatter_add takes at this shape: "tiled" or "global"."""
    return cm_module.cm_scatter_path(rows, cfg, n, _sms(device))


def _cm_adversarial(n: int, rows: int, rng: np.random.Generator) -> dict:
    """cm_scatter_add's hard streams, {name: (keys, items, rows, cfg)}: every
    item on one key and one item (one counter a depth row takes all n adds,
    across the units of its split tile), only dropped keys, B = 1, B - 1
    rows (1023: the last tile holds 3 of 4), w = 1000 (64-bit items, hashed
    again), a row past a tile (the global path)."""
    keys = rng.integers(-1, rows + 1, n, dtype=np.int32)
    items = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    cfg = CMConfig(CM_DEPTH, CM_WIDTH, seed=2**64 - 1)
    return {
        "one key one item": (np.full(n, rows // 2, np.int32), np.full(n, 99, np.int32), rows, cfg),
        "only dropped keys": (np.where(keys % 2 == 0, -1, rows).astype(np.int32), items, rows, cfg),
        "one row": (np.where(keys % 5 == 0, 1, 0).astype(np.int32), items, 1, cfg),
        "ragged tiles": (keys, items, rows - 1, cfg),
        "w=1000": (np.clip(keys, -1, 100).astype(np.int32), items, min(rows, 100), CMConfig(3, 1000, seed=5)),
        "global path": (keys, items, rows, CMConfig(1, 1 << 16)),
    }


def _bank_adversarial(n: int, rows: int, rng: np.random.Generator) -> dict:
    """bank_scatter_max's hard streams, {name: (rows, m, keys, idx, rank)} at
    p = 16 unless named: every entry on one key (a tile split into ~n / 8192
    units) and on one cell, B = 1, B - 1 rows, p = 4 (the whole bank in one
    tile), p = 12, keys -1, B and 2^31 - 1, buckets -1 and m, ranks 0 and
    256, n in {0, 1, 127}; plans past the tiled limits (m = 2^17, m = 20)."""
    m = 1 << 16
    keys = ((rng.zipf(ZIPF_A, n) - 1) % rows).astype(np.int32)
    idx = rng.integers(0, m, n, dtype=np.int32)
    rank = rng.integers(1, 40, n, dtype=np.int32)
    bad_keys, bad_idx, bad_rank = keys.copy(), idx.copy(), rank.copy()
    bad_keys[0::4], bad_keys[1::4], bad_keys[2::4] = -1, rows, 2**31 - 1
    bad_idx[0::3], bad_idx[1::3] = -1, m
    bad_rank[0::3], bad_rank[1::3] = 0, 256
    cases = {
        "one key": (rows, m, np.zeros(n, np.int32), idx, rank),
        "one cell": (rows, m, np.full(n, rows // 2, np.int32), np.full(n, m - 1, np.int32), rank),
        "B=1": (1, m, np.where(keys % 5 == 0, 1, 0).astype(np.int32), idx, rank),
        "B-1 rows": (rows - 1, m, keys, idx, rank),
        "p=4": (rows, 16, keys, idx % 16, rank),
        "p=12": (rows, 1 << 12, keys, idx % (1 << 12), rank),
        "dropped keys": (rows, m, bad_keys, idx, rank),
        "dropped buckets": (rows, m, keys, bad_idx, rank),
        "dropped ranks": (rows, m, keys, idx, bad_rank),
        "m=2^17": (8, 1 << 17, keys % 9, idx * 2, rank),
        "m=20": (64, 20, keys % 65, idx % 21, rank),
    }
    for length in (0, 1, 127):
        cases[f"n={length}"] = (rows - 1, m, keys[:length], idx[:length], rank[:length])
    return cases


def _bank_cases(device, n: int, rows: int, rng: np.random.Generator) -> float:
    """bank_scatter_max on its hard streams and 2^25 + 5 entries (2048
    slices), on the path it picks and on both paths where the tiled one's
    limits allow; the input bank unchanged after every call.  Prints the
    path each case took."""
    sms = _sms(device)
    cases = _bank_adversarial(n + 3, rows, rng)
    many = 8 * n + 5
    keys = rng.integers(0, rows, many, dtype=np.int32)
    keys[::5] = 0  # a hot row: a fifth of the entries, split over units of all 2048 slices
    cases[f"many slices, n={many}"] = (rows, 1 << 16, keys, rng.integers(0, 1 << 16, many, dtype=np.int32),
                                       rng.integers(1, 30, many, dtype=np.int32))
    err, paths = 0.0, {}
    for what, (b_rows, m, keys, idx, rank) in cases.items():
        bank = torch.from_numpy(rng.integers(0, 20, (b_rows, m), dtype=np.uint8)).to(device)
        before = bank.clone()
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (keys, idx, rank)]
        want = bank_scatter_max_plain(bank, *args)
        paths[what] = bank_module.bank_scatter_path(b_rows, m, len(keys), sms)
        fits = bank_module.tiled_fits(b_rows, m, len(keys), sms)
        if fits == what.startswith("m="):
            raise AssertionError(f"bank_scatter_max {what}: the tiled limits {'allow' if fits else 'refuse'} it")
        runs = {"chosen": bank_scatter_max, "global": bank_module.bank_scatter_max_global}
        if fits:
            runs["tiled"] = bank_module.bank_scatter_max_tiled
        for path, fn in runs.items():
            err = max(err, _max_abs_err(fn(bank, *args), want, f"bank_scatter_max {what}, {path}"))
        _max_abs_err(bank, before, f"bank_scatter_max {what}: the input bank")
        del bank, before, args, want
    print(f"[kernels] bank_scatter_max paths: {json.dumps(paths)}")
    return err


def _row_count_cases(device, n: int, rows: int, hybrid_rows: int, rng: np.random.Generator) -> float:
    """bank_row_count on Zipf(1.2) keys and its hard streams -- keys -1, B
    and beyond dropped, every key in one row, every key dropped -- onto
    limbs that carry across 2^32 or wrap at 2^64, at the full length, 3 keys
    and keys off a 16-byte boundary: n + 3 keys over B rows and over B at
    the path boundary (SHARED_ROWS and one more), and HybridBank's chunk
    (``hybrid_rows`` rows, a quarter of HYBRID_ITEMS_PER_ROW keys a row,
    also on its own traffic, 10 % of the rows taking 90 %); the input limbs
    unchanged after every call.  Prints the path each shape took."""
    err, paths = 0.0, {}
    mask32, mask64 = np.uint64((1 << 32) - 1), np.uint64((1 << 64) - 1)
    chunk = hybrid_rows * HYBRID_ITEMS_PER_ROW // HYBRID_CHUNKS
    shapes = [(rows, n + 3), (count_module.SHARED_ROWS, n + 3), (count_module.SHARED_ROWS + 1, n + 3),
              (hybrid_rows, chunk)]
    zipf = rng.zipf(ZIPF_A, max(length for _, length in shapes)) - 1
    for b_rows, length in shapes:
        paths[f"B={b_rows}, n={length}"] = count_module.bank_count_path(b_rows)
        foreign = rng.integers(-3, b_rows + 3, length).astype(np.int32)
        foreign[:2] = [-1, b_rows]
        streams = {"zipf": (zipf[:length] % b_rows).astype(np.int32), "foreign keys": foreign,
                   "one row": np.full(length, b_rows - 1, np.int32),
                   "all dropped": np.where(foreign < 0, foreign, foreign + b_rows).astype(np.int32)}
        if (b_rows, length) == (hybrid_rows, chunk):
            streams["hybrid traffic"] = _zipf_traffic(hybrid_rows, chunk, rng)[0]
        spread = np.arange(b_rows, dtype=np.uint64)
        counters = {"random": rng.integers(0, 1 << 40, b_rows, dtype=np.uint64),
                    "near 2^32": mask32 - spread % np.uint64(3), "near 2^64": mask64 - spread % np.uint64(5)}
        for cname, values in counters.items():
            limbs = u64.from_numpy(values, device)
            before = limbs.clone()
            for sname, keys in streams.items():
                k_t = torch.from_numpy(keys).to(device)
                for what, kk in ((f"n={length}", k_t), ("offset 1", k_t[1:]), ("n=3", k_t[:3])):
                    got = count_module.bank_row_count(limbs, kk)
                    err = max(err, _max_abs_err(got, count_module.bank_row_count_plain(limbs, kk),
                                                f"bank_row_count B={b_rows} {sname} {what}, counters {cname}"))
            _max_abs_err(limbs, before, f"bank_row_count B={b_rows}, counters {cname}: the input limbs")
    print(f"[kernels] bank_row_count paths: {json.dumps(paths)}")
    return err


def _vote_cases(device, n: int, rows: int, rng: np.random.Generator) -> float:
    """cm_vote against the plain vote (_label_update) on the card, bit for
    bit: d in {1, 4, 16} x w in {1, 1000, 1024, 2^16} on n + 3 keys with -1 and B
    mixed in and Zipf(1.2) items over 500 ids (with the int32 limits among
    them, so that multiplicities tie), onto random int32 tables (every branch
    of the absorb rule); one key and one item taking every entry, only
    dropped keys, n = 1 and 127; prints the cells that took the cooperative
    path (warp, block) in each case."""
    ids = rng.integers(-(2**31), 2**31, 500, dtype=np.int64)
    ids[:2] = [-(2**31), 2**31 - 1]

    def tables(b_rows, cfg):
        shape = (b_rows, cfg.depth, cfg.width)
        return [torch.from_numpy(rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)).to(device)
                for _ in range(2)]

    cases = {}
    for depth in (1, 4, 16):
        for width in (1, 1000, 1024, 1 << 16):
            cfg = CMConfig(depth, width, seed=2**64 - 1 if width == 1000 else 0)
            b_rows = max(1, min(rows, (CM_CELL_CAP // 4) // cfg.cells))
            for length in (n + 3, 1, 127):
                keys = rng.integers(-1, b_rows + 1, length, dtype=np.int32)
                items = ids[(rng.zipf(1.2, length) - 1) % ids.size].astype(np.int32)
                cases[f"{cfg} B={b_rows} n={length}"] = (keys, items, b_rows, cfg)
    cfg = CMConfig(CM_DEPTH, CM_WIDTH)
    keys = rng.integers(-1, rows + 1, n + 3, dtype=np.int32)
    cases["one key one item"] = (np.full(n + 3, rows // 2, np.int32), np.full(n + 3, -99, np.int32), rows, cfg)
    cases["only dropped keys"] = (np.where(keys % 2 == 0, -1, rows).astype(np.int32), keys, rows, cfg)
    err, paths = 0.0, {}
    for what, (keys, items, b_rows, cfg) in cases.items():
        labels, votes = tables(b_rows, cfg)
        k_t, x = torch.from_numpy(keys).to(device), torch.from_numpy(items).to(device)
        got = vote_module.cm_vote(labels, votes, k_t, x, cfg)
        want = _label_update(labels, votes, k_t, x, cfg)
        err = max(err, _max_abs_err(got[0], want[0], f"cm_vote labels, {what}"),
                  _max_abs_err(got[1], want[1], f"cm_vote votes, {what}"))
        if torch.device(device).type == "cuda":
            paths[what] = vote_module.cm_vote.cooperative.tolist()
        del labels, votes, got, want
    print(f"[kernels] cm_vote cells on the cooperative path (warp, block): {json.dumps(paths)}")
    return err


def _plain_estimate(registers: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    """The plain "original" read that hll_estimate replaces on the card:
    register_histogram_plain's bincount, then _original_device."""
    from repro_torch.sketch.estimators import _original_device, register_histogram_plain

    return _original_device(register_histogram_plain(registers, cfg).to(torch.float32), cfg)


def _estimate_cases(device, n: int, rows: int, rng: np.random.Generator) -> float:
    """hll_estimate (the estimators' read, which launches it for a uint8
    bank on the card) against its plain version at p in {4, 12, 16} x H in
    {32, 64}: a bank of ``rows`` rows fed n Zipf(1.2)-keyed items,
    with an all-zero, a saturated, a one-rank (E past 2^32 / 30 where H =
    32) and a corrupt row (values past max_rank) added; one (m,) sketch;
    the bank off a 16-byte boundary.  The counts bit for bit (returns their
    max abs err), the "original" estimates within ESTIMATE_RTOL with the
    same infinities (prints the widest relative gap)."""
    from repro_torch.sketch import estimators

    keys, items = _zipf_keyed(rows, n, rng)
    k_t, x_t = torch.from_numpy(keys).to(device), torch.from_numpy(items).to(device)
    err, gaps = 0.0, {}
    for p in (4, 12, 16):
        for hash_bits in (32, 64):
            cfg = HLLConfig(p=p, hash_bits=hash_bits)
            fed = SketchBank.empty(rows, cfg, device).update_many(k_t, x_t).registers
            corrupt = fed[0].clone()
            corrupt[::7] = torch.randint(cfg.max_rank + 1, 256, corrupt[::7].shape, dtype=torch.uint8, device=device)
            special = torch.stack([torch.zeros_like(fed[0]), torch.full_like(fed[0], cfg.max_rank),
                                   torch.full_like(fed[0], min(cfg.max_rank, 29 - p)), corrupt])
            bank = torch.cat([fed, special])
            flat = torch.cat([bank.reshape(-1), bank[0]])
            cases = {"bank": bank, "one sketch": bank[0], "offset 1": flat[1: 1 + bank.numel()].view(bank.shape)}
            for what, regs in cases.items():
                what = f"hll_estimate p={p} H={hash_bits} {what}"
                want = estimators.register_histogram_plain(regs, cfg)
                err = max(err, _max_abs_err(estimators.register_histogram(regs, cfg), want, what))
                got = estimators.estimate_many(regs, cfg, "original").double()
                plain = estimators._original_device(want.to(torch.float32), cfg).double()
                if not torch.equal(torch.isinf(got), torch.isinf(plain)):
                    raise AssertionError(f"{what}: the estimates' infinities differ")
                live = torch.isfinite(plain)
                gap = float(((got - plain).abs() / plain.abs().clamp_min(1e-30))[live].max()) if live.any() else 0.0
                if gap > ESTIMATE_RTOL:
                    raise AssertionError(f"{what}: estimates {gap} from the plain version, beyond {ESTIMATE_RTOL}")
                gaps[what] = gap
    print(f"[kernels] hll_estimate counts bit-identical; widest relative gap of the estimates: {max(gaps.values())}")
    return err


def phase_kernels(device, n: int = 1 << 22, rows: int = BANK_ROWS, configs=STREAM_CONFIGS,
                  hybrid_rows: int = HYBRID_ROWS, window: int = WINDOW, cm_cells: int = CM_CELL_CAP,
                  intra_shapes=INTRA_SHAPES, intra_strong=INTRA_STRONG, intra_bwd_shapes=INTRA_BWD_SHAPES,
                  intra_bwd_strong=INTRA_BWD_STRONG, intra_bwd_underflow=INTRA_BWD_UNDERFLOW,
                  intra_bwd_zero_dy=INTRA_BWD_ZERO_DY) -> dict:
    """Every kernel against its plain version at main-path and ragged sizes."""
    rng = np.random.default_rng(SEED)
    errs = {name: 0.0 for name in KERNELS}
    lengths = (n, n + 3, 1, 127, 1000)
    for p, hash_bits in tuple(configs) + ((4, 64), (8, 32)):
        for seed in (0, 2**64 - 1):
            cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
            for length in lengths:
                values = _stream_items(length, rng)
                x = _items_tensor(values, device)
                idx, rank = hash_rank(x, cfg)
                pidx, prank = hash_rank_plain(x, cfg)
                errs["hash_rank"] = max(
                    errs["hash_rank"],
                    _max_abs_err(idx, pidx, f"hash_rank idx {cfg} n={length}"),
                    _max_abs_err(rank, prank, f"hash_rank rank {cfg} n={length}"),
                )
                # the pure-python Murmur3 oracle on the edge items
                for j, v in enumerate(values[: EDGE_ITEMS.size].tolist()):
                    if hash_bits == 32:
                        h, width = murmur3_32_py(v, seed), 32
                    else:
                        h, width = murmur3_64_py(v, seed), 64
                    rest = h & ((1 << (width - p)) - 1)
                    want = (h >> (width - p), (width - p) - rest.bit_length() + 1)
                    got = (int(idx[j]), int(rank[j]))
                    if got != want:
                        raise AssertionError(f"hash_rank {cfg} item {v:#x}: {got} != oracle {want}")
                # accumulation onto existing registers, and n_valid padding
                regs = torch.from_numpy(
                    rng.integers(0, cfg.max_rank + 1, cfg.m, dtype=np.uint8)
                ).to(device)
                regs[: cfg.m // 2] = 0
                for n_valid in (length, length // 2):
                    errs["hll_update_fused"] = max(
                        errs["hll_update_fused"],
                        _max_abs_err(
                            hll_update_fused(regs, x, n_valid, cfg),
                            hll_update_fused_plain(regs, x, n_valid, cfg),
                            f"hll_update_fused {cfg} n={length} n_valid={n_valid}",
                        ),
                    )
    # every item identical (one hot register), and items off a 16-byte
    # boundary, at p in {4, 16}, both widths, seed 2^64 - 1, onto preset registers
    files = {}
    same = torch.full((n + 3,), 0x5EED, dtype=torch.int32, device=device)
    for p, hash_bits in ((4, 32), (4, 64), (16, 32), (16, 64)):
        cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=2**64 - 1)
        regs = torch.from_numpy(rng.integers(0, cfg.max_rank + 1, cfg.m, dtype=np.uint8)).to(device)
        x = _items_tensor(_stream_items(n + 7, rng), device)
        cases = {"identical items": same, "offset 1": x[1:], "offset 3": x[3:], "n=1": x[:1], "n=127": x[:127]}
        for what, items in cases.items():
            files[f"{cfg.p}/{cfg.hash_bits} {what}"] = hll_module.hll_partials(items.numel(), p, _sms(device))
            for r in (torch.zeros_like(regs), regs):
                errs["hll_update_fused"] = max(
                    errs["hll_update_fused"],
                    _max_abs_err(hll_update_fused(r, items, None, cfg), hll_update_fused_plain(r, items, None, cfg),
                                 f"hll_update_fused {cfg} {what}"),
                )
    print(f"[kernels] hll_update_fused register files per case: {json.dumps(files)}")
    del same, x, cases
    # k within one group of 8 rows in flight, and past it; rows a multiple
    # of 16 bytes (16-byte columns) or not (4-byte columns)
    folds = [(k, m, torch.uint8) for k in (1, 3, PIPELINES, PIPELINES + 1) for m in (16, 20, 1 << 14, 1 << 16)]
    for k, m, dtype in folds + [(5, 1001, torch.int32)]:
        hi = 62 if dtype == torch.uint8 else 2**31 - 1
        partials = torch.from_numpy(
            rng.integers(0, hi, (k, m)).astype(np.uint8 if dtype == torch.uint8 else np.int32)
        ).to(device)
        errs["bucket_fold"] = max(
            errs["bucket_fold"],
            _max_abs_err(bucket_fold(partials), bucket_fold_plain(partials), f"bucket_fold ({k}, {m}) {dtype}"),
        )
    # rows 4 bytes past a 16-byte boundary (a view): the 4-byte columns
    flat = torch.from_numpy(rng.integers(0, 62, (PIPELINES + 1) * (1 << 14), dtype=np.uint8)).to(device)
    view = flat[4: 4 + PIPELINES * (1 << 14)].view(PIPELINES, 1 << 14)
    errs["bucket_fold"] = max(errs["bucket_fold"], _max_abs_err(bucket_fold(view), bucket_fold_plain(view),
                                                                "bucket_fold off a 16-byte boundary"))
    cfg = HLLConfig(p=16, hash_bits=64)
    bank = torch.from_numpy(rng.integers(0, 20, (rows, cfg.m), dtype=np.uint8)).to(device)
    for length in (n, n + 3, 1, 1000):
        keys = rng.integers(-1, rows + 1, length, dtype=np.int32)  # -1 and B are dropped
        keys[: min(length, 2)] = [-1, rows][: min(length, 2)]
        x = _items_tensor(_stream_items(length, rng), device)
        idx, rank = hash_rank_plain(x, cfg)
        rank[:: 7] = 0  # padding ranks are no-ops
        k_t = torch.from_numpy(keys).to(device)
        errs["bank_scatter_max"] = max(
            errs["bank_scatter_max"],
            _max_abs_err(
                bank_scatter_max(bank, k_t, idx, rank),
                bank_scatter_max_plain(bank, k_t, idx, rank),
                f"bank_scatter_max B={rows} n={length}",
            ),
        )
    errs["bank_scatter_max"] = max(errs["bank_scatter_max"], _bank_cases(device, n, rows, rng))
    errs["bank_row_count"] = _row_count_cases(device, n, rows, hybrid_rows, rng)
    errs["cm_vote"] = _vote_cases(device, n, rows, rng)
    errs["hll_estimate"] = _estimate_cases(device, n, rows, rng)
    for p in (4, 8, 12, 16):
        m = 1 << p
        srows = hybrid_rows if p <= 12 else rows
        for length in (n + 3, 1, 127):
            row = rng.integers(-1, srows + 1, length, dtype=np.int32)  # -1 and B are dropped
            row[: min(length, 2)] = [-1, srows][: min(length, 2)]
            bucket = rng.integers(0, m, length, dtype=np.int32)
            rank = rng.integers(0, 60, length, dtype=np.int32)
            rank[::5] = 0  # rank-0 entries are no-ops
            args = [torch.from_numpy(a).to(device) for a in (row, bucket, rank)]
            got = sparse_scatter_coo(*args, srows, m)
            want = sparse_scatter_coo_plain(*args, srows, m)
            errs["sparse_scatter_coo"] = max(
                errs["sparse_scatter_coo"],
                _max_abs_err(got[0], want[0], f"sparse_scatter_coo cells p={p} B={srows} n={length}"),
                _max_abs_err(got[1], want[1], f"sparse_scatter_coo distinct p={p} B={srows} n={length}"),
            )
    cases = _sparse_adversarial(n + 3, hybrid_rows, 1 << 12, rng)
    row = rng.integers(-1, rows + 1, n + 3, dtype=np.int32)
    cases["global path"] = (row, rng.integers(0, 1 << 12, n + 3, dtype=np.int32),
                            rng.integers(0, 60, n + 3, dtype=np.int32), rows, 1 << 12)
    for what, (row, bucket, rank, srows, m) in cases.items():
        args = [torch.from_numpy(a).to(device) for a in (row, bucket, rank)]
        # HIST_TILES = 0 sends every plan to the global path
        with _setting(sparse_module, "HIST_TILES", 0) if what == "global path" else contextlib.nullcontext():
            got = sparse_scatter_coo(*args, srows, m)
        want = sparse_scatter_coo_plain(*args, srows, m)
        errs["sparse_scatter_coo"] = max(
            errs["sparse_scatter_coo"],
            _max_abs_err(got[0], want[0], f"sparse_scatter_coo cells, {what}"),
            _max_abs_err(got[1], want[1], f"sparse_scatter_coo distinct, {what}"),
        )
    del cases, args, got, want
    m = 1 << 12
    ring = torch.from_numpy(rng.integers(0, 40, (window, rows, m), dtype=np.uint8)).to(device)
    masks = {
        "all live": torch.ones(window, dtype=torch.bool),
        f"last_k={window // 4}": torch.arange(window) >= window - window // 4,
        "none live": torch.zeros(window, dtype=torch.bool),
    }
    for what, mask in masks.items():
        mask = mask.to(device)
        errs["window_fold_max"] = max(
            errs["window_fold_max"],
            _max_abs_err(window_fold_max(ring, mask), window_fold_max_plain(ring, mask),
                         f"window_fold_max W={window} {what}"),
        )
    one = ring[:1].clone()
    live = torch.ones(1, dtype=torch.bool, device=device)
    errs["window_fold_max"] = max(
        errs["window_fold_max"],
        _max_abs_err(window_fold_max(one, live), window_fold_max_plain(one, live), "window_fold_max W=1"),
    )
    parts = ring[:3].clone()
    errs["window_merge_max"] = _max_abs_err(
        window_merge_max(parts), window_merge_max_plain(parts), "window_merge_max K=3"
    )
    del ring, one, parts
    paths = {}
    for depth in (1, 4, 16):
        for width in (1, 1000, 1024, 1 << 16):
            cfg = CMConfig(depth, width, seed=2**64 - 1 if width == 1000 else 0)
            cm_rows = max(1, min(rows, cm_cells // cfg.cells))
            # every counter at 0xFFFFFFF0, so that the adds wrap past 2^32
            counters = torch.full((cm_rows, depth, width), -16, dtype=torch.int32, device=device)
            for length in (n + 3, 1, 127):
                keys = rng.integers(-1, cm_rows + 1, length, dtype=np.int32)  # -1 and B are dropped
                keys[: min(length, 2)] = [-1, cm_rows][: min(length, 2)]
                k_t = torch.from_numpy(keys).to(device)
                x = _items_tensor(_stream_items(length, rng), device)
                paths[f"d={depth} w={width} B={cm_rows} n={length}"] = _cm_path(cm_rows, cfg, length, device)
                errs["cm_scatter_add"] = max(
                    errs["cm_scatter_add"],
                    _max_abs_err(cm_scatter_add(counters, k_t, x, cfg), cm_scatter_add_plain(counters, k_t, x, cfg),
                                 f"cm_scatter_add {cfg} B={cm_rows} n={length}"),
                )
            del counters
    cases = {what: (*case, n + 3) for what, case in _cm_adversarial(n + 3, rows, rng).items()}
    cfg = CMConfig(CM_DEPTH, CM_WIDTH)
    many = 8 * n + 5  # 2^25 + 5 items: 2048 slices
    keys = rng.integers(-1, rows + 1, many, dtype=np.int32)
    cases[f"many slices, n={many}"] = (keys, keys * 7919, rows, cfg, many)
    cases["global path, main config"] = (keys[: n + 3], keys[: n + 3] * 7919, rows, cfg, n + 3)
    for what, (keys, items, cm_rows, cfg, length) in cases.items():
        counters = torch.full((cm_rows, cfg.depth, cfg.width), -16, dtype=torch.int32, device=device)
        k_t, x = torch.from_numpy(keys).to(device), torch.from_numpy(items).to(device)
        if what == "global path, main config":
            paths[what] = "global"
            got = cm_module.cm_scatter_add_global(counters, k_t, x, cfg)
        else:
            paths[what] = _cm_path(cm_rows, cfg, length, device)
            got = cm_scatter_add(counters, k_t, x, cfg)
        errs["cm_scatter_add"] = max(
            errs["cm_scatter_add"],
            _max_abs_err(got, cm_scatter_add_plain(counters, k_t, x, cfg), f"cm_scatter_add, {what}"),
        )
        del counters, got
    print(f"[kernels] cm_scatter_add paths: {json.dumps(paths)}")
    del cases, keys
    gen = torch.Generator(device=device).manual_seed(SEED)
    # counters in [0xFFFFFFF0, 0xFFFFFFFF]: every sum of two or more wraps
    cm_ring = torch.randint(-16, 0, (window, rows, CM_DEPTH * CM_WIDTH), generator=gen, dtype=torch.int32,
                            device=device)
    masks = {
        "all live": torch.ones(window, dtype=torch.bool),
        f"last_k={window // 4}": torch.arange(window) >= window - window // 4,
        "none live": torch.zeros(window, dtype=torch.bool),
    }
    rings = {f"W={window} {what}": (cm_ring, mask.to(device)) for what, mask in masks.items()}
    rings["W=1"] = (cm_ring[:1].clone(), torch.ones(1, dtype=torch.bool, device=device))
    # a plane of 35 counters, not a multiple of 4: the scalar kernel
    odd = torch.randint(-16, 0, (4, 5, 1, 7), generator=gen, dtype=torch.int32, device=device)
    rings["plane 35"] = (odd, torch.tensor([True, False, True, True], device=device))
    for what, (r, mask) in rings.items():
        errs["cm_window_fold_sum"] = max(
            errs["cm_window_fold_sum"],
            _max_abs_err(cm_window_fold_sum(r, mask), cm_window_fold_sum_plain(r, mask),
                         f"cm_window_fold_sum {what}"),
        )
    # rwkv_intra: float32 sums in another order than the plain version's
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    cases = [(shape, 1.0) for shape in intra_shapes] + [(shape, 50.0) for shape in intra_strong]
    for (g, c, nn), decay in cases:
        args = _intra_inputs(g, c, nn, gen, device, decay_scale=decay)
        errs["rwkv_intra"] = max(
            errs["rwkv_intra"],
            _close_err(rwkv_intra(*args), rwkv_intra_plain(*args), INTRA_RTOL, INTRA_ATOL,
                       f"rwkv_intra (G, C, N) = {(g, c, nn)}, decay scale {decay}"),
        )
        del args
    # rwkv_intra_bwd: each gradient against the float32 plain version, and
    # both against the float64 plain version
    cases = ([(shape, 1.0, False) for shape in intra_bwd_shapes] + [(shape, 50.0, False) for shape in intra_bwd_strong]
             + [(shape, 200.0, False) for shape in intra_bwd_underflow]
             + [(shape, 1.0, True) for shape in intra_bwd_zero_dy])
    bwd = {}
    for (g, c, nn), decay, zero_dy in cases:
        args = _intra_bwd_inputs(g, c, nn, gen, device, decay)
        if zero_dy:
            args = args[:-1] + (torch.zeros_like(args[-1]),)
        what = f"{(g, c, nn)} decay {decay}" + (", dy = 0" if zero_dy else "")
        row = _intra_bwd_case(args, f"rwkv_intra_bwd (G, C, N) = {what}")
        bwd[what] = row
        errs["rwkv_intra_bwd"] = max(errs["rwkv_intra_bwd"], row.pop("max_abs_err"))
        del args
    print(f"[kernels] rwkv_intra_bwd, each gradient's max |difference| over its largest magnitude (within "
          f"{INTRA_BWD_TOL} of the plain version's): {json.dumps(bwd)}")
    if torch.device(device).type == "cuda":
        print(f"[kernels] rwkv_intra_bwd: {_intra_bwd_occupancy()}")
    print(f"[kernels] sketch kernels bit-identical to their plain versions, rwkv_intra within rtol "
          f"{INTRA_RTOL} atol {INTRA_ATOL}, rwkv_intra_bwd as above: max_abs_err {errs}")
    return errs


def phase_stream(device, chunks: int = STREAM_CHUNKS, chunk_items: int = STREAM_CHUNK_ITEMS,
                 configs=STREAM_CONFIGS, pipelines: int = PIPELINES) -> dict:
    """The Tab. IV stream through the kernel backends, held to "torch"."""
    rng = np.random.default_rng(SEED)
    values = rng.integers(0, 2**32, chunks * chunk_items, dtype=np.uint32)
    exact = int(_sorted_unique(values).size)
    x = _items_tensor(values, device)
    plans = {
        "cuda": ExecutionPlan(backend="cuda"),
        "cuda_pipelined": ExecutionPlan(backend="cuda_pipelined", pipelines=pipelines),
        "torch": reference_plan(),
    }
    result = {"items": int(values.size), "exact_distinct": exact, "configs": []}
    for p, hash_bits in configs:
        cfg = HLLConfig(p=p, hash_bits=hash_bits)
        sketches, seconds = {}, {}
        for name, plan in plans.items():
            sk = HyperLogLog.empty(cfg, device)
            _sync(device)
            t0 = time.perf_counter()
            for c in range(chunks):
                sk = sk.update(x[c * chunk_items : (c + 1) * chunk_items], plan)
            _sync(device)
            seconds[name] = time.perf_counter() - t0
            sketches[name] = sk
        for name in ("cuda", "cuda_pipelined"):
            _max_abs_err(sketches[name].registers, sketches["torch"].registers, f"stream {name} {cfg}")
            if sketches[name].count != values.size:
                raise AssertionError(f"stream {name} {cfg}: count {sketches[name].count} != {values.size}")
        est = sketches["cuda"].estimate()
        sigma = sketches["cuda"].standard_error
        # a 32-bit hash maps distinct items together: expected lost distinct
        # values n^2 / 2^33, which the estimator cannot see
        collisions = exact * exact / 2.0**33 if hash_bits == 32 else 0.0
        bound = 4 * sigma * exact + collisions
        if not abs(est - exact) <= bound:
            raise AssertionError(f"stream {cfg}: estimate {est} vs exact {exact}, bound {bound}")
        row = {
            "p": p, "hash_bits": hash_bits, "estimate": est, "rel_err": (est - exact) / exact,
            "bound_rel": bound / exact,
            "items_per_s": {name: values.size / s for name, s in seconds.items()},
        }
        result["configs"].append(row)
        print(f"[stream] {json.dumps(row)}")
    return result


def _zipf_keyed(rows: int, n: int, rng: np.random.Generator):
    """Zipf-popular tenant keys and uniform tokens, as benchmarks/bench_serve.py."""
    keys = ((rng.zipf(ZIPF_A, n) - 1) % rows).astype(np.int32)
    items = rng.integers(0, 2**31, n, dtype=np.int32)
    return keys, items


def phase_bank(device, rows: int = BANK_ROWS, ticks: int = BANK_TICKS,
               tick_items: int = BANK_TICK_ITEMS, p: int = 16, hash_bits: int = 64) -> dict:
    """The multi-tenant serve bank through "cuda", held to "torch"."""
    rng = np.random.default_rng(SEED + 1)
    keys, items = _zipf_keyed(rows, ticks * tick_items, rng)
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    k_t = torch.from_numpy(keys).to(device)
    x_t = torch.from_numpy(items).to(device)
    bank = SketchBank.empty(rows, cfg, device)
    ref = SketchBank.empty(rows, cfg, device)
    cuda_plan, torch_plan = ExecutionPlan(backend="cuda"), reference_plan()
    seconds = 0.0
    for t in range(ticks):
        span = slice(t * tick_items, (t + 1) * tick_items)
        _sync(device)
        t0 = time.perf_counter()
        bank = bank.update_many(k_t[span], x_t[span], cuda_plan)
        _sync(device)
        seconds += time.perf_counter() - t0
        ref = ref.update_many(k_t[span], x_t[span], torch_plan)
    _max_abs_err(bank.registers, ref.registers, "bank registers cuda vs torch")
    if not np.array_equal(bank.counts, ref.counts):
        raise AssertionError("bank counters differ between cuda and torch")
    if not np.array_equal(bank.counts, np.bincount(keys, minlength=rows).astype(np.uint64)):
        raise AssertionError("bank counters are not the exact per-row counts")

    est = bank.estimate_many()
    if est.shape != (rows,) or not bool(torch.isfinite(est).all()):
        raise AssertionError(f"estimate_many: shape {tuple(est.shape)}, finite {bool(torch.isfinite(est).all())}")
    pairs = _sorted_unique((keys.astype(np.int64) << 32) | items.astype(np.int64))
    exact = np.bincount((pairs >> 32).astype(np.int64), minlength=rows)
    sigma = 1.04 / np.sqrt(cfg.m)
    err = np.abs(est.cpu().numpy().astype(np.float64) - exact)
    bound = 6 * sigma * exact + 3
    if not (err <= bound).all():
        worst = int(np.argmax(err / bound))
        raise AssertionError(f"bank row {worst}: estimate {float(est[worst])} vs exact {exact[worst]}")

    blob = bank.to_bytes()
    back = SketchBank.from_bytes(blob, device)
    _max_abs_err(back.registers, bank.registers, "RHLB round trip registers")
    if not np.array_equal(back.counts, bank.counts) or back.to_bytes() != blob:
        raise AssertionError("RHLB round trip changed the bank")
    result = {
        "rows": rows, "items": int(keys.size), "bank_mib": bank.registers.numel() / 2**20,
        "ingest_items_per_s": keys.size / seconds, "max_rel_err": float((err / np.maximum(exact, 1)).max()),
        "rhlb_bytes": len(blob),
    }
    print(f"[bank] {json.dumps(result)}")
    return result


def _zipf_traffic(rows: int, n: int, rng: np.random.Generator):
    """Keyed stream where HOT_FRAC of the rows receive HOT_SHARE of the
    items, as benchmarks/bench_sparse.py's ``_zipf_traffic``."""
    hot = max(1, int(rows * HOT_FRAC))
    hot_keys = rng.integers(0, hot, n)
    cold_keys = rng.integers(hot, rows, n) if rows > hot else hot_keys
    keys = np.where(rng.random(n) < HOT_SHARE, hot_keys, cold_keys)
    return keys.astype(np.int32), rng.integers(0, 2**31, n, dtype=np.int32)


def _band_z(rows: int) -> float:
    """Bonferroni z for the max error over ``rows`` estimates, as
    benchmarks/bench_sparse.py's ``_band_z``."""
    return statistics.NormalDist().inv_cdf(1.0 - BAND_ALPHA / (2.0 * rows))


def _same_hybrid(a: HybridBank, b: HybridBank, what: str) -> None:
    """Raise unless two settled hybrid banks are bit-identical."""
    for field in ("pairs", "sparse_len", "dense", "dense_slot"):
        _max_abs_err(getattr(a, field), getattr(b, field), f"{what} {field}")
    if not np.array_equal(a.counts, b.counts):
        raise AssertionError(f"{what}: counters differ")


def phase_hybrid(device, rows: int = HYBRID_ROWS, items_per_row: int = HYBRID_ITEMS_PER_ROW,
                 chunks: int = HYBRID_CHUNKS, p: int = 12, hash_bits: int = 64) -> dict:
    """The bench_sparse acceptance deployment through "cuda", held to "torch"."""
    rng = np.random.default_rng(rows)
    n = items_per_row * rows
    keys, items = _zipf_traffic(rows, n, rng)
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    k_chunks = torch.from_numpy(keys).to(device).tensor_split(chunks)
    x_chunks = torch.from_numpy(items).to(device).tensor_split(chunks)
    banks, seconds = {}, {}
    for name, plan in (("cuda", ExecutionPlan(backend="cuda")), ("torch", reference_plan())):
        # warm-up: one chunk through a throwaway bank, so the timed pass
        # pays no first-call costs (kernel loads, allocator growth)
        HybridBank.empty(rows, cfg, device=device).update_many(k_chunks[0], x_chunks[0], plan).compact()
        bank = HybridBank.empty(rows, cfg, device=device)
        _sync(device)
        t0 = time.perf_counter()
        for k, x in zip(k_chunks, x_chunks):
            # a read after every chunk settles the append log (compaction
            # inside the timed region, as the bench times it)
            bank = bank.update_many(k, x, plan).compact()
        _sync(device)
        seconds[name] = time.perf_counter() - t0
        banks[name] = bank
    bank = banks["cuda"]
    _same_hybrid(bank, banks["torch"], "hybrid cuda vs torch")
    if not np.array_equal(bank.counts, np.bincount(keys, minlength=rows).astype(np.uint64)):
        raise AssertionError("hybrid counters are not the exact per-row counts")
    dense = SketchBank.empty(rows, cfg, device)
    for k, x in zip(k_chunks, x_chunks):
        dense = dense.update_many(k, x, ExecutionPlan(backend="cuda"))
    _max_abs_err(bank.to_dense().registers, dense.registers, "hybrid to_dense vs dense bank")
    if not 0 < bank.dense_rows < rows:
        raise AssertionError(f"hybrid: {bank.dense_rows} of {rows} rows promoted")

    est = bank.estimate_many()
    dense_est = dense.estimate_many()
    sparse_rows = bank.dense_slot < 0
    # the LC fast path on sparse rows is the dense path's small-range
    # branch, bit for bit; dense rows run the same finalizer on a smaller
    # batch (its harmonic sum is a float32 matrix-vector product, so it is
    # held to 1e-6 and the differing rows are counted)
    _max_abs_err(est[sparse_rows].view(torch.int32), dense_est[sparse_rows].view(torch.int32),
                 "hybrid LC fast path vs dense estimate_many")
    dense_diff = int((est[~sparse_rows] != dense_est[~sparse_rows]).sum())
    if not torch.allclose(est, dense_est, rtol=1e-6, atol=0):
        raise AssertionError("hybrid dense-row estimates differ from the dense bank beyond 1e-6")

    combo = _sorted_unique(keys.astype(np.int64) * (1 << 31) + items.astype(np.int64))
    true = np.bincount((combo >> 31).astype(np.int64), minlength=rows)
    z = _band_z(rows)
    sigma = 1.04 / np.sqrt(cfg.m)
    tol = z * sigma * true + 3.0 * np.sqrt(true + 1.0)
    err = np.abs(est.cpu().numpy().astype(np.float64) - true)
    if not (err <= tol).all():
        worst = int(np.argmax(err - tol))
        raise AssertionError(f"hybrid row {worst}: estimate {float(est[worst])} vs true {true[worst]} "
                             f"outside the {z:.2f}-sigma band")

    blob = bank.to_bytes()
    if HybridBank.from_bytes(blob, device).to_bytes() != blob:
        raise AssertionError("RHLB v2 round trip changed the hybrid bank")
    result = {
        "rows": rows, "items": int(n), "promoted_rows": bank.dense_rows, "capacity": bank.capacity,
        "dense_nbytes": dense.nbytes, "hybrid_nbytes": bank.nbytes,
        "memory_reduction": dense.nbytes / bank.nbytes,
        "ingest_items_per_s": {name: n / sec for name, sec in seconds.items()},
        "band_z": z, "max_err_sigma": float((err / np.maximum(sigma * true, 1e-9)).max()),
        "dense_rows_estimate_ulp_diffs": dense_diff, "rhlb_v2_bytes": len(blob),
    }
    print(f"[hybrid] {json.dumps(result)}")
    return result


def _zipf_epoch(rows: int, n: int, rng: np.random.Generator, device):
    keys, items = _zipf_keyed(rows, n, rng)
    return torch.from_numpy(keys).to(device), torch.from_numpy(items).to(device)


def phase_window(device, window: int = WINDOW, rows: int = WINDOW_ROWS, epoch_items: int = WINDOW_EPOCH_ITEMS,
                 p: int = 12, hash_bits: int = 64, hybrid_window: int = HYBRID_WINDOW,
                 mr_base: int = MR_BASE, mr_levels: int = MR_LEVELS) -> dict:
    """Three rings on one Zipf-keyed epoch stream, "cuda" held to "torch"."""
    rng = np.random.default_rng(SEED + 5)
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    plans = {"cuda": ExecutionPlan(backend="cuda"), "torch": reference_plan()}
    rings = {name: WindowedBank.empty(window, rows, cfg, device) for name in plans}
    multi = {name: MultiResWindowedBank.empty(mr_base, rows, cfg, mr_levels, device) for name in plans}
    hybrid = {name: HybridWindowedBank.empty(hybrid_window, rows, cfg, device=device) for name in plans}
    epochs = 2 * window
    seconds, reads = 0.0, 0
    for epoch in range(epochs):
        k, x = _zipf_epoch(rows, epoch_items, rng, device)
        for name, plan in plans.items():
            if epoch:
                rings[name] = rings[name].advance()
                multi[name] = multi[name].advance()
                hybrid[name] = hybrid[name].advance()
            rings[name] = rings[name].observe(k, x, plan)
            multi[name] = multi[name].observe(k, x, plan)
            hybrid[name] = hybrid[name].observe(k, x, plan)
        if epoch % 8 != 7:
            continue
        ring, ref = rings["cuda"], rings["torch"]
        _max_abs_err(ring.registers, ref.registers, f"window ring registers epoch {epoch}")
        _sync(device)
        t0 = time.perf_counter()
        full = ring.estimate_window(plan=plans["cuda"])
        quarter = ring.estimate_window(window // 4, plan=plans["cuda"])
        _sync(device)
        seconds += time.perf_counter() - t0
        reads += 1
        _max_abs_err(full.view(torch.int32), ref.estimate_window(plan=plans["torch"]).view(torch.int32),
                     f"window estimate_window() epoch {epoch}")
        _max_abs_err(quarter.view(torch.int32),
                     ref.estimate_window(window // 4, plan=plans["torch"]).view(torch.int32),
                     f"window estimate_window({window // 4}) epoch {epoch}")
        cold = window_fold_max_plain(ring.registers, torch.ones(window, dtype=torch.bool, device=device))
        _max_abs_err(ring.fold_window(plan=plans["cuda"]).registers, cold,
                     f"window incremental read vs cold fold epoch {epoch}")
        _max_abs_err(multi["cuda"].estimate_window(plan=plans["cuda"]).view(torch.int32),
                     multi["torch"].estimate_window(plan=plans["torch"]).view(torch.int32),
                     f"multi-res estimate_window() epoch {epoch}")
        _same_hybrid(hybrid["cuda"].fold_window(plan=plans["cuda"]),
                     hybrid["torch"].fold_window(plan=plans["torch"]), f"hybrid ring fold epoch {epoch}")
    ring, mr, hy = rings["cuda"], multi["cuda"], hybrid["cuda"]
    exact = ring.window_counts()
    if exact.sum() != np.uint64(window * epoch_items):
        raise AssertionError(f"window counters: {exact.sum()} != {window * epoch_items}")
    for blob_of, parse, what in (
        (ring.to_bytes, WindowedBank.from_bytes, "RHLW v1"),
        (mr.to_bytes, MultiResWindowedBank.from_bytes, "RHLW v3"),
        (hy.to_bytes, HybridWindowedBank.from_bytes, "RHLW v2"),
    ):
        blob = blob_of()
        if parse(blob, device).to_bytes() != blob:
            raise AssertionError(f"{what} round trip changed the ring")
    result = {
        "window": window, "rows": rows, "epochs": epochs, "ring_mib": ring.registers.numel() / 2**20,
        "read_ms": seconds * 1e3 / max(reads, 1), "multires_slots": mr.slots,
        "hybrid_ring": hy.density(),
    }
    print(f"[window] {json.dumps(result)}")
    return result


def _zipf_ranks(n: int, a: float, support: int, gen: torch.Generator) -> torch.Tensor:
    """n Zipf(a) ranks in [0, support), int64, drawn on ``gen``'s device by
    inverse CDF: rank r has probability proportional to (r + 1)^-a.  numpy's
    ``zipf`` is a rejection sampler on the host, too slow for the ~5 * 10^8
    draws the count-min phases make."""
    device = gen.device
    weights = torch.arange(1, support + 1, dtype=torch.float64, device=device) ** -a
    cdf = torch.cumsum(weights, 0)
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device) * cdf[-1]
    return torch.searchsorted(cdf, u).clamp_(max=support - 1)


def _cm_traffic(rows: int, n: int, item_ids: int, gen: torch.Generator):
    """Zipf(1.2) tenant keys (bench_serve's skew) over the B rows with keys
    -1 and B mixed in, and Zipf(1.1) items over ``item_ids`` ids, rotated
    per tenant so every row has heavy hitters of its own; int32 tensors on
    ``gen``'s device."""
    keys = _zipf_ranks(n, ZIPF_A, rows, gen)
    keys[::1009] = -1
    keys[1::1013] = rows
    ranks = _zipf_ranks(n, CM_ITEM_ZIPF, item_ids, gen)
    items = (ranks + keys * 7919) % item_ids
    return keys.to(torch.int32), items.to(torch.int32)


def _same_cm(a: CountMinBank, b: CountMinBank, what: str) -> None:
    """Raise unless two count-min banks are bit-identical."""
    for field in ("counters", "labels", "label_counts", "n_items"):
        _max_abs_err(getattr(a, field), getattr(b, field), f"{what} {field}")


def _exact_pair_counts(keys: torch.Tensor, items: torch.Tensor, rows: int, item_ids: int):
    """(sorted (row, item) codes, their exact counts) of the valid keys, in
    plain torch on the stream's device: the reference the sketch is held to."""
    valid = (keys >= 0) & (keys < rows)
    code = keys[valid].to(torch.int64) * item_ids + items[valid].to(torch.int64)
    return torch.unique(code, return_counts=True)


def _lookup(codes: torch.Tensor, counts: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Exact counts of ``query`` codes (0 where absent)."""
    at = torch.searchsorted(codes, query).clamp(max=codes.numel() - 1)
    return torch.where(codes[at] == query, counts[at], 0)


def phase_countmin(device, rows: int = CM_ROWS, ticks: int = CM_TICKS, tick_items: int = CM_TICK_ITEMS,
                   depth: int = CM_DEPTH, width: int = CM_WIDTH, item_ids: int = CM_ITEM_IDS,
                   probes: int = CM_PROBES) -> dict:
    """bench_heavy's largest CountMinBank through "cuda", held to "torch",
    its labels and votes to the plain vote tick by tick; the vote kernel
    alone at the tick's shape against its bound and the plain vote."""
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    k_t, x_t = _cm_traffic(rows, ticks * tick_items, item_ids, gen)
    cfg = CMConfig(depth, width, seed=0)
    spans = [slice(t * tick_items, (t + 1) * tick_items) for t in range(ticks)]
    plans = {"cuda": ExecutionPlan(backend="cuda"), "torch": reference_plan()}
    on_card = torch.device(device).type == "cuda" and vote_module is not None
    voted = launch_counts().get("cm_vote", 0)
    banks, seconds, cooperative = {}, {}, None
    for name, plan in plans.items():
        CountMinBank.empty(rows, cfg, device).update_many(k_t[spans[0]], x_t[spans[0]], plan)  # warm-up
        bank = CountMinBank.empty(rows, cfg, device)
        _sync(device)
        t0 = time.perf_counter()
        for span in spans:
            bank = bank.update_many(k_t[span], x_t[span], plan)
        _sync(device)
        seconds[name] = time.perf_counter() - t0
        banks[name] = bank
        if on_card and name == "cuda":
            cooperative = vote_module.cm_vote.cooperative.tolist()  # the last tick's
    bank = banks["cuda"]
    _same_cm(bank, banks["torch"], "countmin cuda vs torch")
    # the vote is the kernel under every plan on the card: hold it to the plain vote
    empty = CountMinBank.empty(rows, cfg, device)
    labels, votes = empty.labels, empty.label_counts
    for span in spans:
        labels, votes = _label_update(labels, votes, k_t[span], x_t[span], cfg)
    _max_abs_err(bank.labels, labels, "countmin labels vs the plain vote")
    _max_abs_err(bank.label_counts, votes, "countmin votes vs the plain vote")
    vote = None
    if on_card:
        # the main path's ticks took the kernel: 1 + ticks a plan
        launched = launch_counts()["cm_vote"] - voted
        if launched != 2 * (1 + ticks):
            raise AssertionError(f"the count-min ticks launched cm_vote {launched} times, not {2 * (1 + ticks)}")
        # this phase's ticks (Zipf keys: a hot row takes one block) and the
        # benchmark cell's (keys and items uniform), 4 ticks rotated
        uniform = [(torch.randint(0, rows, (tick_items,), generator=gen, device=device, dtype=torch.int32),
                    torch.randint(-(2**31), 2**31 - 1, (tick_items,), generator=gen, device=device,
                                  dtype=torch.int32)) for _ in range(4)]
        vote = {"launched": launched, "cooperative_cells_last_tick": cooperative,
                "bound_ms": (8 * tick_items + 16 * rows * cfg.cells) / HBM_BYTES_PER_S * 1e3}
        for what, calls in (("zipf keys", [(k_t[span], x_t[span]) for span in spans[:4]]), ("uniform", uniform)):
            ms, host_ms = _time_ms(lambda k, x: vote_module.cm_vote(labels, votes, k, x, cfg), calls)
            plain_ms = _wall_ms(lambda k, x: _label_update(labels, votes, k, x, cfg), calls, iters=3)[0]
            vote[what] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms}
        del uniform
        print(f"[countmin] cm_vote at the tick ({tick_items} entries into {rows} x {cfg}): {json.dumps(vote)}")
    landed = torch.bincount(k_t[(k_t >= 0) & (k_t < rows)].to(torch.int64), minlength=rows)
    if not np.array_equal(bank.counts, landed.cpu().numpy().astype(np.uint64)):
        raise AssertionError("countmin counters are not the exact per-row counts")

    codes, counts = _exact_pair_counts(k_t, x_t, rows, item_ids)
    by_item = torch.bincount((codes % item_ids), weights=counts.double(), minlength=item_ids)
    heavy = torch.topk(by_item, 64).indices
    rand = torch.randint(0, item_ids, (probes - 64,), generator=gen, device=device)
    probe = torch.cat([heavy, rand]).to(torch.int32)
    est = bank.query(probe, plans["cuda"])
    _max_abs_err(est, banks["torch"].query(probe, plans["torch"]), "countmin query cuda vs torch")
    grid = torch.arange(rows, device=device)[:, None] * item_ids + probe.to(torch.int64)[None, :]
    exact = _lookup(codes, counts, grid)
    if est.shape != (rows, probes) or not bool((est >= exact).all()):
        raise AssertionError("countmin query is below an exact count")
    top_v, top_c = bank.topk(10)
    ref_v, ref_c = banks["torch"].topk(10)
    if not (np.array_equal(top_v, ref_v) and np.array_equal(top_c, ref_c)):
        raise AssertionError("countmin topk(10) differs between cuda and torch")
    busiest = np.argsort(bank.counts, kind="stable")[::-1][:16]
    row_of = codes // item_ids
    for b in busiest.tolist():
        mine = row_of == b
        true_top = int(codes[mine][torch.argmax(counts[mine])] % item_ids)
        if true_top not in top_v[b].tolist():
            raise AssertionError(f"countmin row {b}: true top-1 {true_top} not in topk(10) {top_v[b]}")

    blob = bank.to_bytes()
    if CountMinBank.from_bytes(blob, device).to_bytes() != blob:
        raise AssertionError("RCMB round trip changed the bank")
    half = ticks // 2 * tick_items
    first = CountMinBank.empty(rows, cfg, device).update_many(k_t[:half], x_t[:half], plans["cuda"])
    second = CountMinBank.empty(rows, cfg, device).update_many(k_t[half:], x_t[half:], plans["cuda"])
    merged = first.merge(second)
    _max_abs_err(merged.counters, bank.counters, "countmin merge of halves vs one ingest")
    if not np.array_equal(merged.counts, bank.counts):
        raise AssertionError("countmin merge of halves: counts differ from one ingest")
    over = (est - exact).to(torch.float64)
    result = {
        "rows": rows, "depth": depth, "width": width, "items": k_t.numel(),
        "state_mib": bank.nbytes / 2**20,
        "ingest_items_per_s": {name: k_t.numel() / sec for name, sec in seconds.items()},
        "probe_overcount_mean": float(over.mean()), "probe_overcount_max": float(over.max()),
        "rcmb_bytes": len(blob), "vote": vote,
    }
    print(f"[countmin] {json.dumps(result)}")
    return result


def phase_cm_window(device, window: int = WINDOW, rows: int = CM_ROWS, epoch_items: int = WINDOW_EPOCH_ITEMS,
                    depth: int = CM_DEPTH, width: int = CM_WIDTH, item_ids: int = CM_ITEM_IDS,
                    probes: int = CM_PROBES, bytes_window: int = CM_BYTES_WINDOW) -> dict:
    """A (W, B, d, w) count-min ring over 2W epochs, "cuda" held to "torch"."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    cfg = CMConfig(depth, width, seed=0)
    plans = {"cuda": ExecutionPlan(backend="cuda"), "torch": reference_plan()}
    rings = {name: WindowedCountMinBank.empty(window, rows, cfg, device) for name in plans}
    probe = torch.randint(0, item_ids, (probes,), generator=gen, device=device, dtype=torch.int32)
    epochs = 2 * window
    jump_at = window + window // 4
    observe_s = advance_s = read_s = 0.0
    reads, landed = 0, []
    for epoch in range(epochs):
        k, x = _cm_traffic(rows, epoch_items, item_ids, gen)
        landed.append(int(((k >= 0) & (k < rows)).sum()))
        for name, plan in plans.items():
            ring = rings[name]
            _sync(device)
            t0 = time.perf_counter()
            if epoch == jump_at:  # one jump of more than W expires the whole ring
                ring = ring.advance_to(ring.epoch + window + 3)
            elif epoch:
                ring = ring.advance()
            _sync(device)
            t1 = time.perf_counter()
            ring = ring.observe(k, x, plan)
            _sync(device)
            if name == "cuda":
                advance_s += t1 - t0
                observe_s += time.perf_counter() - t1
            rings[name] = ring
        if epoch % 8 != 7:
            continue
        ring, ref = rings["cuda"], rings["torch"]
        for last_k in (None, window // 4):
            _sync(device)
            t0 = time.perf_counter()
            got = ring.fold_window(last_k, plans["cuda"])
            _sync(device)
            read_s += time.perf_counter() - t0
            reads += 1
            want = ref.fold_window(last_k, plans["torch"])
            _same_cm(got, want, f"cm_window fold_window({last_k}) epoch {epoch}")
            _max_abs_err(got.query(probe, plans["cuda"]), ref.query_window(probe, last_k, plans["torch"]),
                         f"cm_window query_window({last_k}) epoch {epoch}")
    ring = rings["cuda"]
    # the jump expired every epoch before it; the ring holds those after
    if int(ring.window_counts().sum()) != sum(landed[jump_at:]):
        raise AssertionError(f"cm_window counters: {ring.window_counts().sum()} != {sum(landed[jump_at:])}")
    del rings, ref, got, want
    small = WindowedCountMinBank.empty(bytes_window, rows, cfg, device)
    for epoch in range(bytes_window + 2):
        k, x = _cm_traffic(rows, epoch_items // 4, item_ids, gen)
        small = small.observe(k, x, plans["cuda"]).advance()
    blob = small.to_bytes()
    if WindowedCountMinBank.from_bytes(blob, device).to_bytes() != blob:
        raise AssertionError("RCMW round trip changed the ring")
    result = {
        "window": window, "rows": rows, "depth": depth, "width": width, "epochs": epochs,
        "ring_mib": 3 * 4 * ring.counters.numel() / 2**20,
        "observe_ms": observe_s * 1e3 / epochs, "advance_ms": advance_s * 1e3 / (epochs - 1),
        "read_ms": read_s * 1e3 / max(reads, 1), "rcmw_bytes": len(blob),
    }
    print(f"[cm_window] {json.dumps(result)}")
    return result


def phase_board(device, streams: int = BOARD_STREAMS, epochs: int = BOARD_EPOCHS,
                epoch_items: int = BOARD_EPOCH_ITEMS, window: int = BOARD_WINDOW, vocab: int = GPT2_VOCAB,
                p: int = 12, depth: int = CM_DEPTH, width: int = CM_WIDTH) -> dict:
    """serve.py's telemetry board with heavy hitters, flat and windowed,
    under "cuda" and "torch" plans."""
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    cfg, cm = HLLConfig(p=p, hash_bits=64), CMConfig(depth, width, seed=0)
    names = [f"stream{i:03d}" for i in range(streams)]
    boards = {
        (name, kind): StreamSketch(cfg, plan=plan, track_topk=cm, device=device,
                                   window=window if kind == "windowed" else None)
        for name, plan in (("cuda", ExecutionPlan(backend="cuda")), ("torch", reference_plan()))
        for kind in ("flat", "windowed")
    }
    seconds = {key: 0.0 for key in boards}
    for epoch in range(epochs):
        which, order = torch.sort(_zipf_ranks(epoch_items, ZIPF_A, streams, gen), stable=True)
        t = _zipf_ranks(epoch_items, CM_ITEM_ZIPF, vocab, gen).to(torch.int32)[order]
        bounds = torch.searchsorted(which, torch.arange(streams + 1, device=device)).tolist()
        for key, board in boards.items():
            _sync(device)
            t0 = time.perf_counter()
            for i in range(streams):
                if bounds[i + 1] > bounds[i]:
                    board.observe(names[i], t[bounds[i]: bounds[i + 1]])
            if key[1] == "windowed":
                board.advance()
            _sync(device)
            seconds[key] += time.perf_counter() - t0
    result = {"streams": streams, "epochs": epochs, "items": epochs * epoch_items, "window": window}
    for kind in ("flat", "windowed"):
        board, ref = boards[("cuda", kind)], boards[("torch", kind)]
        exact, want = board.report(exact=True), ref.report(exact=True)
        if exact.keys() != want.keys() or any(
            (exact[n]["estimate"], exact[n]["items_seen"]) != (want[n]["estimate"], want[n]["items_seen"])
            for n in want
        ):
            raise AssertionError(f"board {kind}: report(exact=True) differs between cuda and torch")
        fast, slow = board.report(), ref.report()
        got = np.array([fast[n]["estimate"] for n in want])
        ref_est = np.array([slow[n]["estimate"] for n in want])
        if not np.allclose(got, ref_est, rtol=1e-6, atol=0):
            raise AssertionError(f"board {kind}: report() estimates differ beyond rtol 1e-6")
        for n in want:
            if board.topk(n, 5) != ref.topk(n, 5):
                raise AssertionError(f"board {kind}: topk({n!r}, 5) differs between cuda and torch")
        blob_of = (lambda b: b.window_bytes()) if kind == "windowed" else (lambda b: b.serialize())
        if blob_of(board) != blob_of(ref):
            raise AssertionError(f"board {kind}: bytes differ between cuda and torch")
        seen = sum(row["items_seen"] for row in exact.values())
        result[kind] = {
            "streams_reported": len(exact), "items_seen": seen,
            "ingest_items_per_s": {name: epochs * epoch_items / seconds[(name, kind)] for name in ("cuda", "torch")},
            "top1_of_busiest": board.topk(names[0], 1),
        }
    if result["flat"]["items_seen"] != epochs * epoch_items:
        raise AssertionError(f"flat board saw {result['flat']['items_seen']} of {epochs * epoch_items} items")
    print(f"[board] {json.dumps(result)}")
    return result


def _swap_intra(fn):
    """Make ``repro_torch.models.rwkv6`` call ``fn`` for its intra term;
    returns the function it called before (restore it in a finally)."""
    before = rwkv6.rwkv_intra
    rwkv6.rwkv_intra = fn
    return before


@contextlib.contextmanager
def _activations(dtype: torch.dtype):
    """Run the model with ``dtype`` activations (the tests' float32 leg)."""
    before = model_common.ACT_DTYPE
    model_common.ACT_DTYPE = dtype
    try:
        yield
    finally:
        model_common.ACT_DTYPE = before


def _prefill_trio(model, batch, arch, kv_len: int):
    """Three prefills of one batch: with the kernel, with rwkv_intra_plain,
    and with rwkv_intra_plain's output times (1 + SERVE_NOISE * z), z ~ N(0,
    1) drawn per element from a seeded generator -- the control that shows
    how far a last-place change of the intra sums, such as another order of
    summation makes, carries through the model.  Returns them and the
    first's launches."""
    before = launch_counts()["rwkv_intra"]
    got = engine.prefill(model, batch, arch, kv_len)
    launched = launch_counts()["rwkv_intra"] - before
    real = _swap_intra(rwkv_intra_plain)
    try:
        want = engine.prefill(model, batch, arch, kv_len)
        gen = torch.Generator(device=model.embed.device).manual_seed(SEED + 12)

        def noisy(*args):
            y = rwkv_intra_plain(*args)
            return y * (1.0 + SERVE_NOISE * torch.randn(y.shape, generator=gen, device=y.device))

        rwkv6.rwkv_intra = noisy
        control = engine.prefill(model, batch, arch, kv_len)
    finally:
        _swap_intra(real)
    return got, want, control, launched


def _against_plain(trio, what: str) -> dict:
    """The kernel prefill against the plain one: last-position logits and
    final states, each no further from the plain run on average than
    SERVE_NOISE_FACTOR times the control; the first greedy token equal but
    where the plain run's two best logits lie within twice the control's
    largest logit change."""
    (logits, cache), (plain, plain_cache), (ctrl, ctrl_cache), _ = trio
    out = {}
    pairs = {"logits": (logits[:, -1].float(), plain[:, -1].float(), ctrl[:, -1].float()),
             "state": (_states(cache), _states(plain_cache), _states(ctrl_cache))}
    for name, (got, want, noise) in pairs.items():
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{what} {name}: non-finite values")
        err, ctrl_err = (got - want).abs(), (noise - want).abs()
        row = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
               "control_max_abs_err": float(ctrl_err.max()), "control_mean_abs_err": float(ctrl_err.mean())}
        if row["mean_abs_err"] > SERVE_NOISE_FACTOR * row["control_mean_abs_err"]:
            raise AssertionError(f"{what} {name}: kernel vs plain {row} beyond {SERVE_NOISE_FACTOR} x the control")
        out[name] = row
    out["first_token_ties"] = _greedy_agrees(pairs["logits"][0], pairs["logits"][1],
                                             2 * out["logits"]["control_max_abs_err"], f"{what} first token")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: prefill logits are not all finite")
    return out


def _states(cache) -> torch.Tensor:
    return torch.cat([entry["s"].reshape(-1) for stage in cache["stages"] for entry in stage.values()])


def _greedy_agrees(got_logits: torch.Tensor, want_logits: torch.Tensor, tol: float, what: str) -> int:
    """The greedy tokens of two (B, V) logits agree, but where the two best
    logits lie within ``tol`` (a tie the logits' error allows).  Returns the
    number of such ties."""
    got_tok, want_tok = got_logits.float().argmax(-1), want_logits.float().argmax(-1)
    ties = 0
    for b in torch.nonzero(got_tok != want_tok).reshape(-1).tolist():
        gap = float(want_logits[b].float().max() - want_logits[b, got_tok[b]].float())
        if gap > tol:
            raise AssertionError(f"{what}: request {b} greedy token {int(got_tok[b])} vs {int(want_tok[b])}, "
                                 f"logit gap {gap} beyond {tol}")
        ties += 1
    return ties


def phase_serve(device, arch=None, requests: int = SERVE_REQUESTS, prompt_len: int = SERVE_PROMPT,
                gen_len: int = SERVE_GEN, check_layers: int = CHECK_LAYERS, tf_prompt: int = TF_PROMPT,
                tf_steps: int = TF_STEPS, ragged=RAGGED_PROMPTS, tf_atol: float = SERVE_TF_ATOL) -> dict:
    """RWKV6-3B serving at full width (examples/serve_lm.py's flow), held to
    its plain-intra run and to the teacher-forced forward."""
    arch = arch if arch is not None else get_arch(SERVE_ARCH)
    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    b, s, t = requests, prompt_len, gen_len
    result = {"arch": arch.name, "layers": arch.n_layers, "d_model": arch.d_model, "requests": b,
              "prompt_len": s, "gen_len": t}
    with torch.inference_mode():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        t0 = time.perf_counter()
        model = transformer.init_params(arch, gen, device)
        _sync(device)
        result["init_s"] = time.perf_counter() - t0
        result["params"] = sum(p.numel() for p in model.parameters())
        if result["params"] != arch.param_count():
            raise AssertionError(f"{result['params']} parameters, the config counts {arch.param_count()}")
        prompts = torch.randint(0, arch.vocab_size, (b, s), generator=gen, device=device, dtype=torch.int32)
        request_ids = torch.arange(1000, 1000 + b, dtype=torch.int32, device=device)
        batch, kv_len = {"tokens": prompts}, s + t + 1

        # warm-up prefill (cuBLAS handles, the kernel library), under the
        # profiler for the intra kernel's own device time; CUDA events around
        # each call would also count the card's waits on a slow host
        intra_ms = None
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                engine.prefill(model, batch, arch, kv_len)
                _sync(device)
            intra = [e for e in _device_entries(prof.key_averages()) if "rwkv_intra" in e.key]
            intra_ms = sum(e.self_device_time_total for e in intra) / 1e3 if intra else None
        else:
            engine.prefill(model, batch, arch, kv_len)
        trio = _prefill_trio(model, batch, arch, kv_len)
        result["intra_launches_per_prefill"] = trio[-1]
        result["vs_plain"] = _against_plain(trio, "prefill")
        del trio
        # the same with float32 activations: no bf16 rounding for a
        # last-place difference of the intra sums to flip and carry on
        with _activations(torch.float32):
            result["vs_plain_f32"] = _against_plain(_prefill_trio(model, batch, arch, kv_len), "float32 prefill")
        # the kernel prefill once more, timed alone
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = engine.prefill(model, batch, arch, kv_len)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        result["intra_ms_per_prefill"] = intra_ms
        result["intra_share_of_prefill"] = None if intra_ms is None else intra_ms / (prefill_s * 1e3)
        last = logits[:, -1].float()
        first = torch.argmax(last, dim=-1).to(torch.int32)

        _sync(device)
        t0 = time.perf_counter()
        generated, final = engine.decode_loop(model, cache, first, s, arch, steps=t)
        _sync(device)
        decode_s = time.perf_counter() - t0
        after, _ = engine.decode_step(model, final, generated[:, -1], s + t, arch)
        if generated.shape != (b, t) or not bool(((generated >= 0) & (generated < arch.vocab_size)).all()):
            raise AssertionError(f"generated tokens {tuple(generated.shape)} outside [0, {arch.vocab_size})")
        if not (torch.isfinite(after).all() and torch.isfinite(_states(final)).all()):
            raise AssertionError("decode logits or states are not all finite")
        result.update(prefill_s=prefill_s, decode_s=decode_s, prefill_tokens_per_s=b * s / prefill_s,
                      decode_tokens_per_s=b * t / decode_s)

        board = StreamSketch(HLLConfig(p=12, hash_bits=64), device=device)
        streams = {"request_ids": request_ids, "prompt_tokens": prompts, "generated_tokens": generated}
        for name, items in streams.items():
            board.observe(name, items)
        report = board.report()
        sigma = 1.04 / np.sqrt(board.cfg.m)
        result["board"] = {}
        for name, items in streams.items():
            exact = int(torch.unique(items).numel())
            est = report[name]["estimate"]
            if abs(est - exact) > 4 * sigma * exact:
                raise AssertionError(f"board {name}: estimate {est} vs {exact} distinct, beyond 4 sigma")
            result["board"][name] = {"estimate": est, "exact": exact, "items_seen": report[name]["items_seen"]}
        del model, cache, final, logits, generated
        if on_card:
            result["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)

        # the teacher-forced invariant and the ragged prompts, at CHECK_LAYERS full-width layers
        small = dataclasses.replace(arch, n_layers=check_layers)
        model = transformer.init_params(small, gen, device)
        toks = torch.randint(0, small.vocab_size, (b, tf_prompt + tf_steps), generator=gen, device=device,
                             dtype=torch.int32)
        full_logits, _, _ = transformer.forward(model, {"tokens": toks}, small)
        pre_logits, c = engine.prefill(model, {"tokens": toks[:, :tf_prompt]}, small, tf_prompt + tf_steps)
        tf_err = _close_err(pre_logits.float(), full_logits[:, :tf_prompt].float(), 0.0, tf_atol,
                            "teacher-forced prefill vs forward")
        for i in range(tf_steps):
            step_logits, c = engine.decode_step(model, c, toks[:, tf_prompt + i], tf_prompt + i, small)
            tf_err = max(tf_err, _close_err(step_logits, full_logits[:, tf_prompt + i].float(), 0.0, tf_atol,
                                            f"teacher-forced decode step {i} vs forward"))
        result["teacher_forced_max_abs_err"] = tf_err
        result["ragged"] = {}
        for length in ragged:
            trio = _prefill_trio(model, {"tokens": toks[:, :length]}, small, length + 1)
            chunked = length % min(small.rwkv_chunk_size, length) == 0
            if on_card and trio[-1] != (check_layers if chunked else 0):
                raise AssertionError(f"{length}-token prompt launched rwkv_intra {trio[-1]} times")
            result["ragged"][length] = dict(_against_plain(trio, f"{length}-token prompt"), launches=trio[-1])
    print(f"[serve] {json.dumps(result)}")
    return result


LAUNCH_ARGS = ("--arch", SERVE_ARCH, "--full-config", "--requests", str(SERVE_REQUESTS), "--prompt-len",
               str(SERVE_PROMPT), "--gen-len", str(SERVE_GEN), "--report-every", "4")
# the launcher's kernels: the prefill's intra form; the board flush and
# the window ring's epochs (hash + bank scatter); the hybrid settle (sparse
# dedup); the heavy-hitter banks (count-min scatter); the window reads
# (merge of the fold fragments, suffix fold)
LAUNCH_KERNELS = ("rwkv_intra", "hash_rank", "bank_scatter_max", "sparse_scatter_coo", "cm_scatter_add",
                  "window_fold_max", "window_merge_max")
OBS_ROWS, OBS_P, OBS_TICK_ITEMS, OBS_CALLS, OBS_ROUNDS = 1024, 16, 1 << 22, 20, 4
BUILD = Path("build")


def phase_launch(device, args=LAUNCH_ARGS, out_dir: Path = BUILD, kernels=LAUNCH_KERNELS) -> dict:
    """The port's serve launcher in-process (``repro_torch.launch.serve.main``),
    RWKV6-3B at full width, with metrics and a trace capture on: its
    snapshot, trace and launch counts checked; then, on the card, the same
    run under the profiler for its busy time (the idle share is against
    the first run's wall)."""
    import contextlib as _ctx
    import gc
    import io

    from repro_torch.launch import serve as launcher
    from repro_torch.obs import metrics, tracing
    from repro_torch.obs.format import metrics_report_line

    on_card = torch.device(device).type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    out_dir.mkdir(parents=True, exist_ok=True)
    snap_path, trace_path = out_dir / "launch_metrics.json", out_dir / "launch_trace.json"
    argv = list(args) + ["--metrics-out", str(snap_path), "--device", str(device)]
    parsed = launcher._parser().parse_args(argv)
    b, s, t = parsed.requests, parsed.prompt_len, parsed.gen_len
    printed = io.StringIO()
    reset_launches()
    tracing.start_trace()
    _sync(device)
    t0 = time.perf_counter()
    try:
        with _ctx.redirect_stdout(printed):
            launcher.main(argv)
        _sync(device)
    finally:
        tracing.stop_trace()
        metrics.disable()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    tracing.write_trace(str(trace_path))
    for line in printed.getvalue().splitlines():
        print(f"[launch] | {line}")
    snap = json.loads(snap_path.read_text())
    counters, hists = snap["counters"], snap["histograms"]
    if counters.get("serve.coalesce.submitted") != b or counters.get("serve.coalesce.ticks", 0) < 1:
        raise AssertionError(f"coalescer: {counters.get('serve.coalesce.submitted')} submitted, "
                             f"{counters.get('serve.coalesce.ticks')} ticks for {b} requests")
    if hists.get("serve.request.seconds", {}).get("count") != b:
        raise AssertionError(f"serve.request.seconds holds {hists.get('serve.request.seconds')} for {b} requests")
    if counters.get("window.fold_cache.hits", 0) <= 0:
        raise AssertionError("the request reads never hit the window fold cache")
    backends = {k.split(".")[2] for k in counters
                if k.startswith("dispatch.") and k.endswith(".calls") and not k.startswith("dispatch.estimate.")}
    if not backends or not backends <= {"cuda", "cuda_pipelined"}:
        raise AssertionError(f"the launcher dispatched through {sorted(backends)}, not only the cuda backends")
    events = [e["name"] for e in json.loads(trace_path.read_text())["traceEvents"]]
    seams = sorted({n for n in events if n.endswith("[cuda]")})
    if ("serve.prefill" not in events or "serve.decode" not in events
            or events.count("serve.request") != b or not seams):
        raise AssertionError(f"trace: {events.count('serve.prefill')} prefill, {events.count('serve.decode')} "
                             f"decode, {events.count('serve.request')} request spans, seams {seams}")
    if on_card:
        missing = [name for name in kernels if launches[name] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the launcher's path: {missing}")
    prefill_s = hists["serve.prefill.seconds"]["sum"]
    decode_s = hists["serve.decode.seconds"]["sum"]
    busy_ms = None
    if on_card:
        # the same run once more under the profiler (metrics and trace off):
        # the card's busy time over the whole launcher, weights drawn included
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.serve.coalesce import SharedWindowRing

        SharedWindowRing.reset()  # the same work as the first run: a new ring
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with _ctx.redirect_stdout(io.StringIO()):
                launcher.main(list(args) + ["--device", str(device)])
            _sync(device)
        entries = _device_entries(prof.key_averages())
        busy_ms = sum(e.self_device_time_total for e in entries) / 1e3
        for e in sorted(entries, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[launch] profile: {e.self_device_time_total / 1e3:.4f} ms x{e.count}  {e.key[:90]}")
    result = {
        "wall_s": wall_s, "device_busy_ms": busy_ms,
        "idle_share": None if busy_ms is None else 1.0 - busy_ms / (wall_s * 1e3),
        "requests": b, "prompt_len": s, "gen_len": t, "prefill_s": prefill_s, "decode_s": decode_s,
        "prefill_tokens_per_s": b * s / prefill_s, "decode_tokens_per_s": b * t / decode_s,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if on_card else None,
        "launches": {name: launches[name] for name in kernels}, "seams": seams, "trace_events": len(events),
        "dispatches": {k: v for k, v in counters.items() if k.startswith("dispatch.")},
    }
    print(f"[launch] prefill {result['prefill_tokens_per_s']:.6g} tokens/s, decode "
          f"{result['decode_tokens_per_s']:.6g} tokens/s, peak device memory {result['max_memory_allocated']} "
          f"bytes; {metrics_report_line(snap)}; {json.dumps(result)}")
    return result


# the placement phase's kernels: the bank and window ingest (hash + bank
# scatter), the single sketch (fused, and the pipelined fold), the hybrid
# settle, the ring reads, count-min ingest
PLACEMENT_KERNELS = ("hash_rank", "bank_scatter_max", "hll_update_fused", "bucket_fold", "sparse_scatter_coo",
                     "window_fold_max", "window_merge_max", "cm_scatter_add")
PLACEMENT_SHARDS = 4  # row blocks on one card: the port's forced-device count
PLACEMENT_WINDOW_EPOCHS = WINDOW + 4  # the ring wraps once


def _placement_meshes(device, shards: int) -> dict:
    """A mesh of ``shards`` positions on ``device``, and one over the visible
    devices of its kind (every card; the one CPU)."""
    from repro_torch.launch.mesh import make_auto_mesh

    dev = torch.device(device)
    visible = make_auto_mesh((torch.cuda.device_count(),), ("data",)) if dev.type == "cuda" else \
        make_auto_mesh((1,), ("data",), [dev])
    return {f"{shards}-shard": make_auto_mesh((shards,), ("data",), [dev] * shards),
            f"{len(visible.devices)}-device": visible}


def _placement_plans(base: ExecutionPlan, meshes: dict, placements=("sharded", "mesh")) -> dict:
    return {f"{placement} {name}": (base.with_sharding(mesh) if placement == "sharded" else base.with_mesh(mesh))
            for name, mesh in meshes.items() for placement in placements}


def _wall(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def phase_placement(device, shards: int = PLACEMENT_SHARDS, rows: int = BANK_ROWS, ticks: int = 2,
                    tick_items: int = BANK_TICK_ITEMS, p: int = 16, hybrid_rows: int = HYBRID_ROWS,
                    hybrid_items_per_row: int = HYBRID_ITEMS_PER_ROW, window: int = WINDOW,
                    window_rows: int = WINDOW_ROWS, window_epochs: int = PLACEMENT_WINDOW_EPOCHS,
                    epoch_items: int = WINDOW_EPOCH_ITEMS, cm_rows: int = CM_ROWS, cm_depth: int = CM_DEPTH,
                    cm_width: int = CM_WIDTH, cm_items: int = CM_TICK_ITEMS, stream_chunks: int = 4,
                    stream_items: int = STREAM_CHUNK_ITEMS, repeats: int = 10) -> dict:
    """Each carrier at its phase's shape under placement="sharded" and
    "mesh" over a ``shards``-position mesh on one card and over the visible
    devices, bit-identical to placement="local" under "cuda": the bank
    (registers, counters, estimates, RHLB), the hybrid bank (settled state,
    estimates, RHLB v2), the W-epoch ring (ring, folds, full and suffix
    reads, RHLW), count-min (counters, labels, votes, RCMB) and one stream
    sketch under "cuda" and "cuda_pipelined".  Prints the walls of local
    and sharded bank ingest and read (medians of ``repeats`` in turns) and
    the bank path each block took."""
    meshes = _placement_meshes(device, shards)
    local = ExecutionPlan(backend="cuda")
    plans = _placement_plans(local, meshes)
    out = {"shards": shards, "meshes": list(meshes)}

    # the bank: 1024 x p = 16 (64 MiB), Zipf(1.2) tenant keys
    rng = np.random.default_rng(SEED + 11)
    cfg = HLLConfig(p=p, hash_bits=64)
    keys, items = _zipf_keyed(rows, ticks * tick_items, rng)
    k_t, x_t = torch.from_numpy(keys).to(device), torch.from_numpy(items).to(device)
    spans = [slice(t * tick_items, (t + 1) * tick_items) for t in range(ticks)]
    banks = {}
    for name, plan in {"local": local, **plans}.items():
        bank = SketchBank.empty(rows, cfg, device)
        for span in spans:
            bank = bank.update_many(k_t[span], x_t[span], plan)
        banks[name] = (bank, bank.estimate_many(plan=plan))
    # walls: the last tick again onto each filled bank, and a read, local
    # and 4 row blocks in turns after a warm-up round; medians and samples
    sharded = f"sharded {shards}-shard"
    walls = {name: {"ingest_s": [], "read_s": []} for name in ("local", sharded)}
    for rep in range(repeats + 1):
        for name in walls:
            plan, bank = {"local": local, **plans}[name], banks[name][0]
            _, ingest = _wall(lambda: bank.update_many(k_t[spans[-1]], x_t[spans[-1]], plan), device)
            _, read = _wall(lambda: bank.estimate_many(plan=plan), device)
            if rep:
                walls[name]["ingest_s"].append(ingest)
                walls[name]["read_s"].append(read)
    medians = {name: {k: statistics.median(v) for k, v in w.items()} for name, w in walls.items()}
    want, want_est = banks["local"]
    blob = want.to_bytes()
    for name in plans:
        bank, est = banks[name]
        _max_abs_err(bank.registers, want.registers, f"bank registers {name} vs local")
        _max_abs_err(bank.n_items, want.n_items, f"bank counters {name} vs local")
        _max_abs_err(est.view(torch.int32), want_est.view(torch.int32), f"bank estimates {name} vs local")
        if bank.to_bytes() != blob:
            raise AssertionError(f"RHLB bytes {name} differ from local")
    sms = _sms(device) if torch.device(device).type == "cuda" else 132
    block = -(-rows // shards)
    out["bank"] = {
        "rows": rows, "items_per_tick": tick_items, "walls": walls, "median_walls": medians,
        "path_local": bank_module.bank_scatter_path(rows, cfg.m, tick_items, sms),
        "path_per_block": [bank_module.bank_scatter_path(min(block, rows - i * block), cfg.m, tick_items, sms)
                           for i in range(shards)],
    }

    # hybrid: bench_sparse's acceptance deployment, B = 16384, p = 12
    rng = np.random.default_rng(SEED + 12)
    hcfg = HLLConfig(p=12, hash_bits=64)
    hk, hx = _zipf_traffic(hybrid_rows, hybrid_rows * hybrid_items_per_row, rng)
    hk_c = torch.from_numpy(hk).to(device).tensor_split(HYBRID_CHUNKS)
    hx_c = torch.from_numpy(hx).to(device).tensor_split(HYBRID_CHUNKS)
    hybrids = {}
    for name, plan in {"local": local, **plans}.items():
        bank = HybridBank.empty(hybrid_rows, hcfg, device=device)
        for k, x in zip(hk_c, hx_c):
            bank = bank.update_many(k, x, plan).compact()
        hybrids[name] = (bank, bank.estimate_many(plan=plan))
    want, want_est = hybrids["local"]
    for name in plans:
        bank, est = hybrids[name]
        _same_hybrid(bank, want, f"hybrid {name} vs local")
        _max_abs_err(est.view(torch.int32), want_est.view(torch.int32), f"hybrid estimates {name} vs local")
        if bank.to_bytes() != want.to_bytes():
            raise AssertionError(f"RHLB v2 bytes {name} differ from local")
    out["hybrid"] = {"rows": hybrid_rows, "promoted_rows": want.dense_rows}

    # the ring: W = 64, B = 1024, p = 12 (256 MiB)
    rng = np.random.default_rng(SEED + 13)
    rings = {name: WindowedBank.empty(window, window_rows, hcfg, device) for name in {"local": local, **plans}}
    reads = 0
    for epoch in range(window_epochs):
        k, x = _zipf_epoch(window_rows, epoch_items, rng, device)
        for name, plan in {"local": local, **plans}.items():
            rings[name] = (rings[name].advance() if epoch else rings[name]).observe(k, x, plan)
        if epoch % 16 != 15 and epoch != window_epochs - 1:
            continue
        reads += 1
        want = rings["local"]
        for last_k in (None, max(1, window // 4)):
            want_fold = want.fold_window(last_k, plan=local).registers
            want_est = want.estimate_window(last_k, plan=local)
            for name, plan in plans.items():
                _max_abs_err(rings[name].fold_window(last_k, plan=plan).registers, want_fold,
                             f"ring fold {name} epoch {epoch} last_k {last_k}")
                _max_abs_err(rings[name].estimate_window(last_k, plan=plan).view(torch.int32),
                             want_est.view(torch.int32), f"ring estimates {name} epoch {epoch} last_k {last_k}")
    blob = rings["local"].to_bytes()
    for name in plans:
        _max_abs_err(rings[name].registers, rings["local"].registers, f"ring {name} vs local")
        if rings[name].to_bytes() != blob:
            raise AssertionError(f"RHLW bytes {name} differ from local")
    out["window"] = {"window": window, "rows": window_rows, "epochs": window_epochs, "reads": reads}

    # count-min: B = 1024, CMConfig(4, 1024); the stream length is odd, so
    # the mesh rule pads the keys with -1
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    ck, cx = _cm_traffic(cm_rows, cm_items + 3, CM_ITEM_IDS, gen)
    ccfg = CMConfig(cm_depth, cm_width, seed=0)
    cms = {name: CountMinBank.empty(cm_rows, ccfg, device).update_many(ck, cx, plan)
           for name, plan in {"local": local, **plans}.items()}
    for name in plans:
        _same_cm(cms[name], cms["local"], f"count-min {name} vs local")
        if cms[name].to_bytes() != cms["local"].to_bytes():
            raise AssertionError(f"RCMB bytes {name} differ from local")
    out["countmin"] = {"rows": cm_rows, "items": cm_items + 3}

    # one stream sketch under mesh, "cuda" and "cuda_pipelined"; an odd
    # length, so the stream is edge-padded
    scfg = HLLConfig(p=16, hash_bits=64)
    stream = _items_tensor(_stream_items(stream_chunks * stream_items + 5, np.random.default_rng(SEED + 15)), device)
    for backend in ("cuda", "cuda_pipelined"):
        base = ExecutionPlan(backend=backend, pipelines=PIPELINES)
        want = HyperLogLog.empty(scfg, device).update(stream, base)
        for name, plan in _placement_plans(base, meshes, ("mesh",)).items():
            got = HyperLogLog.empty(scfg, device)
            for chunk in stream.tensor_split(stream_chunks):
                got = got.update(chunk, plan)
            _max_abs_err(got.registers, want.registers, f"stream sketch {backend} {name} vs local")
    out["bank_ratio_sharded_over_local"] = {
        "ingest": medians[sharded]["ingest_s"] / medians["local"]["ingest_s"],
        "read": medians[sharded]["read_s"] / medians["local"]["read_s"],
    }
    print(f"[placement] {json.dumps(out)}")
    return out


ATTN_ARCH = "tinyllama-1.1b"
ATTN_LAUNCH_ARGS = ("--arch", ATTN_ARCH, "--full-config", "--requests", str(SERVE_REQUESTS), "--prompt-len",
                    str(SERVE_PROMPT), "--gen-len", str(SERVE_GEN), "--report-every", "4")
# the board's kernels on the attention launcher (no rwkv_intra there)
ATTN_LAUNCH_KERNELS = ("hash_rank", "bank_scatter_max", "sparse_scatter_coo", "cm_scatter_add",
                       "window_fold_max", "window_merge_max")
ATTN_CHECK_PROMPT, ATTN_CHECK_STEPS = 256, 8  # the 2-layer legs
ATTN_WINDOW = 128  # the SWA leg's window, under its prompt of 256
ATTN_F32_ATOL = 2e-3  # float32 legs: prefill + decode against forward (TF32 off)
ATTN_BF16_ATOL = 0.15  # bf16 legs: GEMMs of other shapes round otherwise (SERVE_TF_ATOL)
ATTN_QUANT_ATOL = 0.3  # the int8 cache against forward's bf16 K/V
ATTN_BATCH_PROMPTS = (37, 128, 300, 64, 511, 90)
ATTN_BATCH_SLOTS, ATTN_BATCH_NEW = 4, 8
ATTN_BATCH_TIE = 1e-3  # float32 logits: a token may differ from solo only on a tie this close


def _launcher_run(device, argv, snap_path: Path) -> dict:
    """One in-process run of ``repro_torch.launch.serve.main`` with metrics
    on: its printed telemetry (less the wall-clock lines), wall, prefill and
    decode tokens/s from its spans, launch counts and peak device memory.
    The launch counts are zeroed just before the run and read just after."""
    import gc
    import io

    from repro_torch.launch import serve as launcher
    from repro_torch.obs import metrics
    from repro_torch.serve.coalesce import SharedWindowRing

    on_card = torch.device(device).type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    SharedWindowRing.reset()
    parsed = launcher._parser().parse_args(list(argv))
    printed = io.StringIO()
    reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            launcher.main(list(argv) + ["--device", str(device), "--metrics-out", str(snap_path)])
        _sync(device)
    finally:
        metrics.disable()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    hists = json.loads(snap_path.read_text())["histograms"]
    b, s, t = parsed.requests, parsed.prompt_len, parsed.gen_len
    lines = printed.getvalue().splitlines()
    return {
        "wall_s": wall, "launches": launches, "printed": lines,
        "prefill_tokens_per_s": b * s / hists["serve.prefill.seconds"]["sum"],
        "decode_tokens_per_s": b * t / hists["serve.decode.seconds"]["sum"],
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if on_card else None,
        # the tok/s line, the [metrics] latencies and the snapshot path vary
        "telemetry": [line for line in lines[1:] if not line.startswith(("[metrics]", "  metrics snapshot"))],
    }


def _batcher_against_solo(model, arch, prompts, slots: int, new: int, what: str) -> dict:
    """A ContinuousBatcher of ``prompts`` over ``slots`` slots, each request's
    tokens held to its solo prefill + decode: a token may differ from solo's
    greedy choice only where solo's top logit leads it by at most
    ATTN_BATCH_TIE (cuBLAS may pick other GEMMs for other batch sizes)."""
    from repro_torch.serve import scheduler

    device = model.embed.device
    kv_len = max(len(p) for p in prompts) + new + 1
    batcher = scheduler.ContinuousBatcher(model, arch, n_slots=slots, kv_len=kv_len)
    for i, prompt in enumerate(prompts):
        batcher.submit(scheduler.Request(uid=i, prompt=prompt, max_new=new))
    got = batcher.run()
    agree, total, worst_tie = 0, 0, 0.0
    for i, prompt in enumerate(prompts):
        logits, cache = engine.prefill(model, {"tokens": torch.from_numpy(prompt[None]).to(device)}, arch, kv_len)
        step = logits[0, -1].float()
        pos = len(prompt)
        for j, tok in enumerate(got[i]):
            gap = float(step.max() - step[tok])
            agree += gap == 0.0
            total += 1
            worst_tie = max(worst_tie, gap)
            if gap > ATTN_BATCH_TIE:
                raise AssertionError(f"{what} batcher request {i} token {j}: {tok} trails solo's greedy by {gap}")
            if j + 1 < len(got[i]):
                logits, cache = engine.decode_step(
                    model, cache, torch.tensor([tok], dtype=torch.int32, device=device), pos, arch)
                step, pos = logits[0], pos + 1
    return {"requests": len(prompts), "slots": slots, "tokens": total, "solo_agree": agree, "worst_gap": worst_tie}


def phase_attn_serve(device, args=ATTN_LAUNCH_ARGS, kernels=ATTN_LAUNCH_KERNELS, arch=None, out_dir: Path = BUILD,
                     check_layers: int = CHECK_LAYERS, check_prompt: int = ATTN_CHECK_PROMPT,
                     check_steps: int = ATTN_CHECK_STEPS, swa_window: int = ATTN_WINDOW,
                     batch_prompts=ATTN_BATCH_PROMPTS, batch_slots: int = ATTN_BATCH_SLOTS,
                     batch_new: int = ATTN_BATCH_NEW) -> dict:
    """TinyLlama-1.1B through the serve launcher at full width, with
    ``--placement local`` and ``sharded``: the same printed telemetry, every
    board kernel launched.  Then, on the same widths: prefill + decode
    against forward at ``check_layers`` layers in float32 and bf16, with a
    sliding window under the prompt (the ring wraps) and with the int8
    cache; and a ContinuousBatcher of mixed prompts over fewer slots than
    requests, in float32, each request's tokens held to its solo decode."""
    on_card = torch.device(device).type == "cuda"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {"arch": ATTN_ARCH}
    runs = {}
    # two rounds in turns: the first run of the process pays cuBLAS's and
    # the allocator's set-up
    for placement in ("local", "sharded", "local", "sharded"):
        run = _launcher_run(device, list(args) + ["--placement", placement],
                            out_dir / f"attn_serve_{placement}_metrics.json")
        for line in run.pop("printed"):
            print(f"[attn_serve] {placement} | {line}")
        launches = run.pop("launches")
        if on_card:
            missing = [name for name in kernels if launches[name] == 0]
            if missing:
                raise AssertionError(f"kernels never launched on the {placement} launcher: {missing}")
        run["launches"] = {name: launches[name] for name in kernels}
        runs.setdefault(placement, []).append(run)
    for rnd, (loc, shd) in enumerate(zip(runs["local"], runs["sharded"])):
        if loc.pop("telemetry") != shd.pop("telemetry"):
            raise AssertionError(f"round {rnd}: the sharded launcher printed other telemetry than the local one")
    out["launcher"] = runs

    full = get_arch(ATTN_ARCH) if arch is None else arch
    small = dataclasses.replace(full, n_layers=check_layers)
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    toks = torch.randint(0, small.vocab_size, (2, check_prompt + check_steps), generator=gen, device=device,
                         dtype=torch.int32)
    legs = {}
    for leg, dtype, atol, leg_arch in (
        ("f32", torch.float32, ATTN_F32_ATOL, small),
        ("bf16", torch.bfloat16, ATTN_BF16_ATOL, small),
        ("f32 swa", torch.float32, ATTN_F32_ATOL, dataclasses.replace(small, sliding_window=swa_window)),
        ("bf16 kv_quant", torch.bfloat16, ATTN_QUANT_ATOL, dataclasses.replace(small, kv_quant=True)),
    ):
        model = transformer.init_params(leg_arch, torch.Generator(device=device).manual_seed(SEED), device)
        with _activations(dtype):
            legs[leg] = _family_leg(model, leg_arch, toks, check_steps, atol, False, f"attn {leg}")
        del model
    out["against_forward_max_abs_err"] = legs

    # continuous batching at full width in float32
    with _activations(torch.float32):
        model = transformer.init_params(full, torch.Generator(device=device).manual_seed(SEED), device)
        rng = np.random.default_rng(SEED + 22)
        prompts = [rng.integers(0, full.vocab_size, n, dtype=np.int32) for n in batch_prompts]
        out["batcher"] = _batcher_against_solo(model, full, prompts, batch_slots, batch_new, "attn")
        del model
    print(f"[attn_serve] {json.dumps(out)}")
    return out


FAMILY_LAUNCH_ARCHS = ("olmoe-1b-7b", "recurrentgemma-9b")  # unreduced through the launcher
FAMILY_CHECK_LAYERS = {"olmoe-1b-7b": 2, "mixtral-8x7b": 2, "recurrentgemma-9b": 3}  # a whole (rec, rec, attn)
# prefill 248 + 8 decode steps: MoE groups of at most 256 tokens route
# drop-free, so forward and prefill + decode route the same tokens alike
FAMILY_CHECK_PROMPT, FAMILY_CHECK_STEPS = 248, 8
FAMILY_BATCH_ARCHS = ("olmoe-1b-7b", "recurrentgemma-9b")
SCAN_RTOL = 4e-6  # of the largest |h|: the prefix tree rounds partial sums of that size


@contextlib.contextmanager
def _routing_log(logits: bool = False):
    """Every ``moe.route`` call inside the block, in call order: the group
    size, capacity, assignments and keep mask (and, with ``logits``, the
    router logits the call computed, recomputed by the same product)."""
    calls = []
    original = moe_lib.route

    def spy(params, xt, arch, cap):
        r = original(params, xt, arch, cap)
        entry = {"tg": xt.shape[1], "cap": cap, "expert_idx": r.expert_idx, "keep": r.keep}
        if logits:
            entry["logits"] = (xt @ params["router"].to(xt.dtype)).float()
        calls.append(entry)
        return r

    moe_lib.route = spy
    try:
        yield calls
    finally:
        moe_lib.route = original


def _routing_float64(logits: torch.Tensor, k: int, cap: int):
    """The reference's routing recomputed in float64 from router logits
    (G, Tg, E): the top k of the float64 softmax, the lower index first
    among ties, and each choice's queue position found by a stable sort of
    the choices by expert (token-major, choice-minor within an expert)."""
    probs = torch.softmax(logits.double(), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    g, tg, e = logits.shape
    flat = order.reshape(g, tg * k)
    by_expert = torch.sort(flat, dim=1, stable=True)
    starts = torch.searchsorted(by_expert.values, torch.arange(e, device=logits.device).expand(g, e).contiguous())
    ranks = torch.arange(tg * k, device=logits.device).expand(g, -1) - torch.gather(starts, 1, by_expert.values)
    slot = torch.empty_like(flat).scatter_(1, by_expert.indices, ranks)
    return order, (slot < cap).reshape(g, tg, k)


def _check_routing_float64(calls, arch, what: str) -> int:
    """Every logged call's assignments and keep mask equal to the float64
    recomputation from its own router logits; returns the dropped choices."""
    dropped = 0
    for i, call in enumerate(calls):
        order, keep = _routing_float64(call["logits"], arch.moe.top_k, call["cap"])
        if not torch.equal(call["expert_idx"], order) or not torch.equal(call["keep"], keep):
            bad = int((call["expert_idx"] != order).any(-1).sum())
            raise AssertionError(f"{what} route call {i}: {bad} tokens routed otherwise than the float64 "
                                 f"recomputation, keep equal: {torch.equal(call['keep'], keep)}")
        dropped += int((~keep).sum())
    return dropped


def _tie_gap(logits: torch.Tensor, choices: torch.Tensor) -> float:
    """How far apart two of ``logits`` (E,) are that a stable top-k must swap
    to give ``choices`` (k,) in their order: the largest rise along the
    choices, and the largest logit left out above the last choice.  A
    routing flipped by a perturbation of at most d per logit has a gap of
    at most 2 d."""
    chosen = logits[choices]
    gap = float((chosen[1:] - chosen[:-1]).clamp(min=0).max()) if len(choices) > 1 else 0.0
    rest = torch.ones_like(logits, dtype=torch.bool)
    rest[choices] = False
    if bool(rest.any()):
        gap = max(gap, float((logits[rest].max() - chosen[-1]).clamp(min=0)))
    return gap


def _family_leg(model, arch, toks, steps: int, atol: float, allow_flips: bool, what: str) -> dict:
    """Prefill of all but ``steps`` tokens and teacher-forced decode steps
    against forward over all of them, for every family (attn_serve's legs
    too); every MoE routing of both equal to its float64 recomputation.  The routing of each position is compared with
    forward's too.  Where ``allow_flips`` (bf16), a sequence is held to
    ``atol`` up to its first position whose routing differs from forward's
    in some layer, and that flip must be a near-tie: the experts it swaps lie
    no further apart in forward's router logits than twice the largest
    change of that token's router logits between the two runs.  The later
    positions are counted, not held: the flip reaches them through
    attention."""
    b, total = toks.shape
    s = total - steps
    with _routing_log(logits=True) as fwd_log, torch.inference_mode():
        full, _, _ = transformer.forward(model, {"tokens": toks}, arch)
    with _routing_log(logits=True) as srv_log:
        pre, cache = engine.prefill(model, {"tokens": toks[:, :s]}, arch, total)
        outs = [pre.float()]
        for t in range(steps):
            step, cache = engine.decode_step(model, cache, toks[:, s + t], s + t, arch)
            outs.append(step[:, None].float())
    err = (torch.cat(outs, dim=1) - full.float()).abs().amax(-1)  # (B, total)
    held = torch.ones_like(err, dtype=torch.bool)
    row = {}
    if arch.moe is not None:
        k, e, layers = arch.moe.top_k, arch.moe.num_experts, arch.n_layers

        def per_position(log, key, width):  # (layers, B, total, width): prefill, then the decode steps
            return torch.stack([torch.cat([c[key].reshape(b, -1, width) for c in log[layer::layers]], dim=1)
                                for layer in range(layers)])

        fwd, srv = per_position(fwd_log, "expert_idx", k), per_position(srv_log, "expert_idx", k)
        fwd_logits, srv_logits = per_position(fwd_log, "logits", e), per_position(srv_log, "logits", e)
        differs = (fwd != srv).any(-1)  # (layers, B, total)
        held = torch.cumprod((~differs.any(0)).int(), dim=1).bool()
        row["flips"] = []
        for seq in range(b):
            flipped = torch.nonzero(differs[:, seq].any(0))
            if flipped.numel() == 0:
                continue
            pos = int(flipped[0])
            layer = int(torch.nonzero(differs[:, seq, pos])[0])
            logits = fwd_logits[layer, seq, pos]
            flip = {"sequence": seq, "position": pos, "layer": layer,
                    "gap": _tie_gap(logits, srv[layer, seq, pos]),
                    "logit_change": float((srv_logits[layer, seq, pos] - logits).abs().max())}
            row["flips"].append(flip)
            if not allow_flips or flip["gap"] > 2 * flip["logit_change"]:
                raise AssertionError(f"{what}: routing differs from forward's, not at a near-tie: {flip}")
        row["positions_after_a_flip"] = int((~held).sum())
        row["dropped_choices"] = _check_routing_float64(fwd_log + srv_log, arch, what)
    err = torch.where(held, err, 0.0)
    row.update(prefill=float(err[:, :s].max()), decode=float(err[:, s:].max()))
    if not max(row["prefill"], row["decode"]) <= atol or not bool(torch.isfinite(full).all()):
        raise AssertionError(f"{what}: prefill + decode differ from forward by {row} (atol {atol})")
    return row


def _scan_against_float64(model, arch, toks) -> dict:
    """The first rec layer's recurrence over the prompt at full width: the
    port's prefix scan against a float64 sequential scan of the same a, b."""
    block = next(block for block in model.layers if block.kind == "rec")
    mixer = block.mixer
    with torch.inference_mode():
        x = model_common.rms_norm(transformer.embed_tokens(model, {"tokens": toks}, arch), block.norm1)
        xb = x @ mixer["w_x"].to(x.dtype)
        a, b = rglru._gates(mixer, rglru._causal_conv(mixer, xb))
        h = rglru.rglru_scan(a, b)
        a64, b64 = a.double(), b.double()
        carry = torch.zeros_like(b64[:, 0])
        want = torch.empty_like(b64)
        for t in range(b64.shape[1]):
            carry = a64[:, t] * carry + b64[:, t]
            want[:, t] = carry
    scale = max(1.0, float(want.abs().max()))
    err = float((h.double() - want).abs().max())
    row = {"tokens": toks.shape[1], "d": arch.d_model, "max_abs_err": err, "max_abs_h": scale,
           "a_min": float(a.min()), "a_max": float(a.max())}
    if not err <= SCAN_RTOL * scale:
        raise AssertionError(f"RG-LRU scan against a float64 sequential scan: {row} (tolerance {SCAN_RTOL} x max|h|)")
    return row


def _collapse_check(prompts: torch.Tensor, expert_idx: torch.Tensor, device) -> dict:
    """The MoE collapse telemetry of the serve launcher's board config: the
    layer-0 assignment stream's estimate within 4 sigma of its exact
    distinct pairs, and a collapsed stream (every choice -> expert 0) below
    the healthy one / 1.5."""
    board = StreamSketch(HLLConfig(p=12, hash_bits=64), device=device)
    healthy = moe_lib.assignment_stream(prompts, expert_idx)
    collapsed = moe_lib.assignment_stream(prompts, torch.zeros_like(expert_idx))
    board.observe("healthy", healthy)
    board.observe("collapsed", collapsed)
    report = board.report()
    exact = int(torch.unique(healthy).numel())
    sigma = 1.04 / np.sqrt(board.cfg.m)
    row = {"pairs": int(healthy.numel()), "exact_distinct": exact, "estimate": report["healthy"]["estimate"],
           "collapsed_exact": int(torch.unique(collapsed).numel()), "collapsed_estimate": report["collapsed"]["estimate"]}
    if abs(row["estimate"] - exact) > 4 * sigma * exact:
        raise AssertionError(f"assignment stream: estimate {row['estimate']} vs {exact} distinct, beyond 4 sigma")
    if not row["collapsed_estimate"] < row["estimate"] / 1.5:
        raise AssertionError(f"a collapsed router reads {row['collapsed_estimate']}, not below {row['estimate']} / 1.5")
    return row


def phase_family_serve(device, archs=FAMILY_LAUNCH_ARCHS, launch_args=None, kernels=ATTN_LAUNCH_KERNELS,
                       check=None, check_prompt: int = FAMILY_CHECK_PROMPT, check_steps: int = FAMILY_CHECK_STEPS,
                       route_prompt: int = SERVE_PROMPT, batch_archs=FAMILY_BATCH_ARCHS,
                       batch_prompts=ATTN_BATCH_PROMPTS, batch_slots: int = ATTN_BATCH_SLOTS,
                       batch_new: int = ATTN_BATCH_NEW, out_dir: Path = BUILD, reduce=False) -> dict:
    """The MoE and RG-LRU hybrid families on the card: olmoe-1b-7b and
    recurrentgemma-9b unreduced through the serve launcher, with the launch
    phase's traffic; at full width over 2-3 layers, prefill + decode against
    forward in float32 and bf16 for olmoe-1b-7b, mixtral-8x7b and
    recurrentgemma-9b, the float32 routing against its float64
    recomputation (over ``route_prompt``-token groups too, where capacity
    drops), the RG-LRU scan against a float64 sequential scan; a
    ContinuousBatcher of mixed prompts at full width for one MoE arch and the
    hybrid; the router-collapse telemetry of the launcher's olmoe prefill."""
    from repro_torch.launch import serve as launcher

    on_card = torch.device(device).type == "cuda"
    out_dir.mkdir(parents=True, exist_ok=True)
    full_arch = (lambda a: get_arch(a).reduced()) if reduce else get_arch
    out = {"launcher": {}, "legs": {}, "batcher": {}}
    launch_args = launch_args or ("--full-config", "--requests", str(SERVE_REQUESTS), "--prompt-len",
                                  str(SERVE_PROMPT), "--gen-len", str(SERVE_GEN), "--report-every", "4")
    for arch_id in archs:
        argv = ["--arch", arch_id, *launch_args]
        with _routing_log() as log:
            run = _launcher_run(device, argv, out_dir / f"family_{arch_id}_metrics.json")
        for line in run.pop("printed"):
            print(f"[family_serve] {arch_id} | {line}")
        run.pop("telemetry")
        launches = run.pop("launches")
        if on_card:
            missing = [name for name in kernels if launches[name] == 0]
            if missing:
                raise AssertionError(f"kernels never launched on the {arch_id} launcher: {missing}")
        run["launches"] = {name: launches[name] for name in kernels}
        prefill_calls = [c for c in log if c["tg"] > 1]
        if prefill_calls:
            arch = full_arch(arch_id)
            run["prefill_route_calls"] = len(prefill_calls)
            run["capacity"] = prefill_calls[0]["cap"]
            run["dropped_choices_per_layer"] = [int((~c["keep"]).sum()) for c in prefill_calls]
            run["dropped_choices"] = sum(run["dropped_choices_per_layer"])
            prompts = launcher._prompts(launcher._parser().parse_args(argv), arch, device)
            run["collapse"] = _collapse_check(prompts, prefill_calls[0]["expert_idx"].reshape(
                *prompts.shape, arch.moe.top_k), device)
        print(f"[family_serve] {arch_id} launcher: {json.dumps(run)}")
        out["launcher"][arch_id] = run

    check = check or FAMILY_CHECK_LAYERS
    for arch_id, layers in check.items():
        small = dataclasses.replace(full_arch(arch_id), n_layers=layers)
        model = transformer.init_params(small, torch.Generator(device=device).manual_seed(SEED), device)
        gen = torch.Generator(device=device).manual_seed(SEED + 23)
        toks = torch.randint(0, small.vocab_size, (2, check_prompt + check_steps), generator=gen, device=device,
                             dtype=torch.int32)
        legs = {}
        for leg, dtype, atol, allow_flips in (("f32", torch.float32, ATTN_F32_ATOL, False),
                                              ("bf16", torch.bfloat16, ATTN_BF16_ATOL, True)):
            with _activations(dtype):
                legs[leg] = _family_leg(model, small, toks, check_steps, atol, allow_flips, f"{arch_id} {leg}")
        long_toks = torch.randint(0, small.vocab_size, (2, route_prompt), generator=gen, device=device,
                                  dtype=torch.int32)
        if small.moe is not None:
            # groups of route_prompt tokens: capacity drops, checked in float64
            with _activations(torch.float32), _routing_log(logits=True) as log, torch.inference_mode():
                transformer.forward(model, {"tokens": long_toks}, small)
            legs["routing_float64"] = {"tokens": route_prompt, "capacity": log[0]["cap"],
                                       "dropped_choices": _check_routing_float64(log, small, f"{arch_id} routing")}
        if any(kind == "rec" for _, _, _, kind in transformer.sublayers(small)):
            legs["scan_float64"] = _scan_against_float64(model, small, long_toks)
        del model
        print(f"[family_serve] {arch_id} x {layers} layers: {json.dumps(legs)}")
        out["legs"][arch_id] = legs

    for arch_id in batch_archs:
        arch = full_arch(arch_id)
        with _activations(torch.float32):
            model = transformer.init_params(arch, torch.Generator(device=device).manual_seed(SEED), device)
            rng = np.random.default_rng(SEED + 24)
            prompts = [rng.integers(0, arch.vocab_size, n, dtype=np.int32) for n in batch_prompts]
            out["batcher"][arch_id] = _batcher_against_solo(model, arch, prompts, batch_slots, batch_new, arch_id)
            del model
        print(f"[family_serve] {arch_id} batcher: {json.dumps(out['batcher'][arch_id])}")
    return out


# ----------------------------------------------------------------------------
# training
# ----------------------------------------------------------------------------

# the train launcher at full width: (arch, global batch, sequence, grad_accum).
# RWKV6-3B's float32 parameters, gradients and AdamW moments take 16 bytes a
# parameter (~50 GB), so it takes 4 sequences a step in 2 micro-batches
TRAIN_RUNS = (("smollm-360m", 8, 1024, 1), (ATTN_ARCH, 8, 1024, 1), (SERVE_ARCH, 4, 1024, 2))
TRAIN_STEPS = 4
# --lr of the full-width runs.  With 4 steps the launcher's warmup is one
# step, so the first AdamW step moves every weight by the whole rate; the
# launcher's 3e-3 is for the reduced archs.  Measured at full width (NVIDIA
# H100 80GB HBM3, 700.00 W), the loss over 4 steps: at 3e-3 TinyLlama-1.1B
# 10.88, 11.96, 20.67, 12.06; at 3e-4 smollm-360m fell (10.996 to 9.621),
# TinyLlama-1.1B 10.88, 10.28, 13.07, 10.46 and RWKV6-3B 11.60, 22.00,
# 17.13, 13.91.  The reference's steps rise the same way after a first
# update at the whole rate: tests/test_torch_train.py's full-width witness
# holds 2 layers of each at 3e-4 to it
TRAIN_LR = 2e-5
TRAIN_SKETCH_P = 14  # the launcher's --sketch-p default
TRAIN_PAIR_BATCH = (2, 1024)  # the kernel pair against the plain pair: one RWKV6-3B micro-batch
TRAIN_CKPT = ("smollm-360m", 2, 2, 256, 4)  # arch, layers, batch, sequence, steps of the checkpoint leg


def intra_bwd_flops(g: int, c: int, n: int) -> int:
    """float32 operations of rwkv_intra_bwd on (G, C, N) cells, the exps not
    counted: per pair s < t and n, A's subtract, two multiplies and add, dA's
    multiply-add, and P's and Q's subtract, two multiplies and add; per
    (s <= t, n) dv's multiply-add; per (t, n) the diagonal terms of A, dA,
    dr, dk, dLex, dL and du (12)."""
    pairs = c * (c - 1) // 2
    return g * n * (pairs * (4 + 2 + 4 + 4) + 2 * (c * (c + 1) // 2) + 12 * c)


ZIPF_CPU_EXP_RATE = 1 / 8  # XLA's and ATen's CPU float32 exp differ in 9.6 % of the zipf exponents (ROADMAP C.3)


def zipf_flip_bound(vocab: int, tokens: int, rate: float = 1.0) -> int:
    """The most zipf tokens two float32 ``exp``s may set apart among
    ``tokens`` tokens of a vocab (ROADMAP C.3): the expected number that a
    one-ulp change of their exp moves, times ``rate``, the share of
    arguments at which the two exps differ (1 where it is not known).  A
    token x moves with probability <= min(1, x 2^-22): below 2^23 the change
    (ulp(x) <= x 2^-23, either way) must cross an integer, above it every
    float32 is an integer.  x is log-uniform over [1, V)."""
    knee = min(vocab, 2 ** 22)
    share = ((knee - 1) * 2.0 ** -22 + math.log(vocab / knee)) / math.log(vocab)
    return math.ceil(tokens * rate * share)


def zipf_flips(got: np.ndarray, want: np.ndarray, argument: np.ndarray, vocab: int, ulps: int = 1) -> int:
    """How many zipf tokens differ between ``got`` and ``want`` (any shape,
    one float32 ``argument`` per token); raises unless each differs by at
    most ``ulps`` float32 ulps of its value, and below 2^23 (where the ulp
    is under one) by one at an integer boundary: the float64 exp of its
    float32 argument within ``ulps`` + 1 float32 ulps of an integer (or both
    clamped to the last token)."""
    got, want = got.reshape(-1).astype(np.int64), want.reshape(-1).astype(np.int64)
    where = np.nonzero(got != want)[0]
    big = np.maximum(got[where], want[where])
    step = np.maximum(1, ulps * np.spacing(big.astype(np.float32)).astype(np.int64))
    if (np.abs(got[where] - want[where]) > step).any():
        raise AssertionError(f"zipf tokens differ by more than one or {ulps} ulp(s) of their value, "
                             f"whichever is larger")
    x = np.exp(argument.reshape(-1)[where].astype(np.float64))
    near = np.abs(x - np.rint(x)) <= (ulps + 1) * np.spacing(x.astype(np.float32)).astype(np.float64)
    ok = near | (big >= 2 ** 23) | (np.minimum(got[where], want[where]) == vocab - 1)
    if not ok.all():
        raise AssertionError(f"zipf tokens differ away from an integer boundary: {x[~ok][:4]}")
    return len(where)


def _train_launcher_run(device, arch_id: str, batch: int, seq: int, accum: int, steps: int, reduce: bool,
                        lr: float) -> dict:
    """One in-process run of ``repro_torch.launch.train.main`` (see
    ``_timed_train_run``)."""
    from repro_torch.launch import train as launcher

    argv = ["--arch", arch_id, "--steps", str(steps), "--global-batch", str(batch), "--seq-len", str(seq),
            "--grad-accum", str(accum), "--lr", str(lr), "--device", str(device)] + (
                [] if reduce else ["--full-config"])
    return _timed_train_run(device, lambda a: launcher.main(a)[0], argv)


def _timed_train_run(device, run, argv) -> dict:
    """``run(argv)``, a training entry point that returns its final state,
    in-process: per step its wall (synchronized), device time (CUDA events)
    and the tap's device time, the metrics and the batch; launches, peak
    memory, the final state, the printed lines.  The launch counts are
    zeroed just before the run and read just after it."""
    import gc
    import io

    from repro_torch.train import loop as train_loop
    from repro_torch.train import step as train_step

    on_card = torch.device(device).type == "cuda"
    event = lambda: torch.cuda.Event(enable_timing=True)
    rows, taps = [], []
    make, tap = train_loop.make_jitted_step, train_step.datapath_tap

    def timed_tap(*args):
        marks = (event(), event()) if on_card else None
        if marks:
            marks[0].record()
        out = tap(*args)
        if marks:
            marks[1].record()
        taps.append(marks)
        return out

    def timed_make(arch, cfg):
        fn = make(arch, cfg)

        def stepped(state, step_batch):
            marks = (event(), event()) if on_card else None
            _sync(device)
            t0 = time.perf_counter()
            if marks:
                marks[0].record()
            state, metrics = fn(state, step_batch)
            if marks:
                marks[1].record()
            _sync(device)
            rows.append({"wall_s": time.perf_counter() - t0, "marks": marks,
                         "metrics": {k: float(v) for k, v in metrics.items()}, "tokens": step_batch["tokens"]})
            return state, metrics
        return stepped

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    printed = io.StringIO()
    train_loop.make_jitted_step, train_step.datapath_tap = timed_make, timed_tap
    reset_launches()
    try:
        with contextlib.redirect_stdout(printed):
            state = run(argv)
        _sync(device)
    finally:
        train_loop.make_jitted_step, train_step.datapath_tap = make, tap
    launches = launch_counts()
    for row, tap_marks in zip(rows, taps):
        marks = row.pop("marks")
        row["device_ms"] = marks[0].elapsed_time(marks[1]) if on_card else None
        row["tap_ms"] = tap_marks[0].elapsed_time(tap_marks[1]) if on_card else None
    return {"rows": rows, "launches": launches, "state": state, "printed": printed.getvalue().splitlines(),
            "max_memory_allocated": torch.cuda.max_memory_allocated(device) if on_card else None}


def _train_checks(device, arch, run: dict, batch: int, seq: int, accum: int, steps: int, lr: float) -> dict:
    """A launcher run's checks: launches, the tap against the plain
    ``hll.update``, the finalized estimate against the exact distinct
    tokens, the zipf flips of the card's batches against the CPU's, the
    loss falling; returns the run's numbers."""
    from repro_torch.data.pipeline import DataConfig, batch_at_step, zipf_exponent
    from repro_torch.sketch import hll

    on_card = torch.device(device).type == "cuda"
    rows, launches = run["rows"], run["launches"]
    layers = arch.n_layers
    want = {"hll_update_fused": steps}
    if arch.mixer == "rwkv6":
        # the forward and the checkpoint's recompute, and one backward, a
        # layer and micro-batch
        want.update(rwkv_intra=2 * layers * accum * steps, rwkv_intra_bwd=layers * accum * steps)
    got = {name: launches[name] for name in want}
    if on_card and got != want:
        raise AssertionError(f"train {arch.name}: launches {got}, expected {want}")
    cfg = HLLConfig(p=TRAIN_SKETCH_P, hash_bits=64)
    tokens = torch.cat([row["tokens"].reshape(-1) for row in rows])
    regs = run["state"]["sketch"]
    if not torch.equal(regs, hll.update(hll.init_registers(cfg, device), tokens, cfg)):
        raise AssertionError(f"train {arch.name}: the tap's registers differ from the plain hll.update")
    exact = int(torch.unique(tokens).numel())
    estimate = hll.estimate(regs, cfg)
    if abs(estimate - exact) > 4 * hll.standard_error(cfg) * exact:
        raise AssertionError(f"train {arch.name}: estimate {estimate} vs exact {exact} distinct tokens")
    data = DataConfig(vocab_size=arch.vocab_size, global_batch=batch, seq_len=seq)
    flips = 0
    for s in range(steps):
        mine, cpu = batch_at_step(data, s, device), batch_at_step(data, s, "cpu")
        flips += zipf_flips(mine["tokens"].cpu().numpy(), cpu["tokens"].numpy(),
                            zipf_exponent(data, s, "cpu")[:-1].numpy(), arch.vocab_size)
    if flips > zipf_flip_bound(arch.vocab_size, steps * batch * seq):
        raise AssertionError(f"train {arch.name}: {flips} zipf tokens differ from the CPU's")
    losses = [row["metrics"]["loss"] for row in rows]
    if not all(np.isfinite(v) for row in rows for v in row["metrics"].values()):
        raise AssertionError(f"train {arch.name}: metrics not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train {arch.name}: the loss did not fall: {losses}")
    warm = rows[1:] or rows
    step_ms = [row["device_ms"] for row in warm]
    tap_ms = [row["tap_ms"] for row in warm]
    return {
        "arch": arch.name, "params": arch.param_count(), "global_batch": batch, "seq_len": seq, "grad_accum": accum,
        "steps": steps, "lr": lr, "tokens_per_s": batch * seq * len(warm) / sum(row["wall_s"] for row in warm),
        "first_step_s": rows[0]["wall_s"], "step_wall_s": [row["wall_s"] for row in rows],
        "step_device_ms": [row["device_ms"] for row in rows],
        "tap_ms": [row["tap_ms"] for row in rows],
        "tap_share": sum(tap_ms) / sum(step_ms) if on_card else None,
        "max_memory_allocated": run["max_memory_allocated"],
        "loss": losses, "distinct_tokens": [row["metrics"]["distinct_tokens"] for row in rows],
        "grad_norm": [row["metrics"]["grad_norm"] for row in rows],
        "estimate": estimate, "exact_distinct": exact, "zipf_flips_card_vs_cpu": flips,
        "launches": got,
    }


def _grads_with(model, batch, arch, fwd, bwd) -> tuple:
    """Loss and gradients of ``loss_fn`` with ``fwd``/``bwd`` as the intra
    term's pair."""
    before = (rwkv6.rwkv_intra, rwkv6.rwkv_intra_bwd)
    rwkv6.rwkv_intra, rwkv6.rwkv_intra_bwd = fwd, bwd
    try:
        loss, _ = transformer.loss_fn(model, batch, arch)
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True, materialize_grads=True)
    finally:
        rwkv6.rwkv_intra, rwkv6.rwkv_intra_bwd = before
    return loss.detach(), grads


def _grad_stats(grads, want) -> dict:
    """The global norm of ``grads`` and their mean |difference| from ``want``."""
    from repro_torch.optim import adamw

    total = sum(float((g - w).abs().sum()) for g, w in zip(grads, want))
    count = sum(g.numel() for g in grads)
    return {"grad_norm": float(adamw.global_norm(dict(enumerate(grads)))), "mean_abs_grad_diff": total / count}


def _train_pair_check(device, arch, batch_shape) -> dict:
    """One RWKV6 micro-batch's loss and gradients with the kernel pair
    (rwkv_intra, rwkv_intra_bwd), with the plain pair, and with a control:
    the plain pair's outputs times (1 + SERVE_NOISE * z).  The kernel pair's
    loss, global grad norm and mean |gradient difference| from the plain
    pair's must lie within SERVE_NOISE_FACTOR times the control's (a loss or
    norm within 4 float32 ulps counts as equal)."""
    from repro_torch.data.pipeline import DataConfig, batch_at_step

    import gc

    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    model = transformer.init_params(arch, gen, device)
    model.requires_grad_(True)
    b, s = batch_shape
    batch = batch_at_step(DataConfig(arch.vocab_size, b, s, seed=1), 0, device)

    def noisy(t):
        return t * (1.0 + SERVE_NOISE * torch.randn(t.shape, generator=gen, device=t.device))

    plain_loss, plain = _grads_with(model, batch, arch, rwkv_intra_plain, rwkv_intra_bwd_plain)
    want = _grad_stats(plain, plain)
    rows = {"plain": {"loss": float(plain_loss), **want}}
    pairs = {"kernel": (rwkv_intra, rwkv_intra_bwd),
             "control": (lambda *a: noisy(rwkv_intra_plain(*a)),
                         lambda *a: tuple(noisy(t) for t in rwkv_intra_bwd_plain(*a)))}
    for name, (fwd, bwd) in pairs.items():
        loss, grads = _grads_with(model, batch, arch, fwd, bwd)
        rows[name] = {"loss": float(loss), **_grad_stats(grads, plain)}
        del grads
        gc.collect()
    del plain, model
    gc.collect()
    for key in ("loss", "grad_norm", "mean_abs_grad_diff"):
        ref = rows["plain"][key]
        got, ctrl = abs(rows["kernel"][key] - ref), abs(rows["control"][key] - ref)
        floor = 0.0 if key == "mean_abs_grad_diff" else 4 * float(np.spacing(np.float32(ref)))
        if got > max(SERVE_NOISE_FACTOR * ctrl, floor):
            raise AssertionError(f"train pair {key}: kernel {got} from the plain pair, beyond "
                                 f"{SERVE_NOISE_FACTOR} x the control's {ctrl}: {rows}")
    return rows


@contextlib.contextmanager
def _deterministic():
    """torch.use_deterministic_algorithms(True), with cuBLAS's deterministic
    workspace, for the block; both restored after it."""
    import os

    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = env or ":4096:8"  # cuBLAS's deterministic mode
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def _same_state(a: dict, b: dict, what: str) -> int:
    """Raise unless two training states hold the same leaves, bit for bit;
    returns the leaves' count."""
    from repro_torch import interop

    leaves_a, leaves_b = interop.train_state_leaves(a), interop.train_state_leaves(b)
    if [p for p, _, _ in leaves_a] != [p for p, _, _ in leaves_b]:
        raise AssertionError(f"{what}: the states' leaves differ")
    for (path, ta, _), (_, tb, _) in zip(leaves_a, leaves_b):
        if not all(torch.equal(x, y) for x, y in zip(ta, tb)):
            raise AssertionError(f"{what}: leaf {path} differs")
    return len(leaves_a)


def _train_ckpt_leg(device, arch, batch: int, seq: int, steps: int, out_dir: Path) -> dict:
    """Under torch.use_deterministic_algorithms(True): ``steps`` steps
    straight against half of them, a checkpoint and a resumed run -- every
    leaf equal; and a save/restore round trip into a fresh state -- every
    leaf equal."""
    import shutil

    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.train import loop as train_loop
    from repro_torch.train import step as train_step

    cfg = train_step.TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=steps),
                                 sketch=HLLConfig(p=TRAIN_SKETCH_P, hash_bits=64))
    data = DataConfig(vocab_size=arch.vocab_size, global_batch=batch, seq_len=seq)
    root = out_dir / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    quiet = lambda line: None
    try:
        with _deterministic():
            t0 = time.perf_counter()
            full, _ = train_loop.train(arch, cfg, data, train_loop.LoopConfig(steps, ckpt_every=10 ** 9),
                                       log_fn=quiet, device=device)
            ck = str(root / "resume")
            train_loop.train(arch, cfg, data, train_loop.LoopConfig(steps // 2, ckpt_every=steps // 2, ckpt_dir=ck),
                             log_fn=quiet, device=device)
            resumed, _ = train_loop.train(arch, cfg, data,
                                          train_loop.LoopConfig(steps, ckpt_every=10 ** 9, ckpt_dir=ck),
                                          log_fn=quiet, device=device)
            leaves = _same_state(resumed, full, "resumed run")
            ckpt.save(full, str(root / "round_trip"), steps, async_write=True).join()
            template = train_loop.init_state(arch, cfg, SEED + 41, torch.device(device))
            _same_state(ckpt.restore(template, str(root / "round_trip"), steps), full, "round trip")
            wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"arch": arch.name, "layers": arch.n_layers, "steps": steps, "leaves": leaves, "wall_s": wall,
            "resumed_equal": True, "round_trip_equal": True}


def phase_train(device, runs=TRAIN_RUNS, steps: int = TRAIN_STEPS, lr: float = TRAIN_LR, reduce: bool = False,
                pair_batch=TRAIN_PAIR_BATCH, ckpt=TRAIN_CKPT, out_dir: Path = BUILD) -> dict:
    """Training through ``repro_torch.launch.train.main`` at full width
    (``reduce``: the reduced archs, for the CPU rehearsal): per arch its
    tokens/s, peak memory, the tap's share of a step, loss and estimates,
    launches; the kernel pair's whole step against the plain pair's and a
    control's; the checkpoint leg.  (rwkv_intra_bwd against its plain
    version is in the kernels phase.)  The launch counts are zeroed just before each launcher run and
    read just after it."""
    import gc

    out_dir.mkdir(parents=True, exist_ok=True)
    out = {"runs": {}}
    for arch_id, batch, seq, accum in runs:
        arch = get_arch(arch_id).reduced() if reduce else get_arch(arch_id)
        run = _train_launcher_run(device, arch_id, batch, seq, accum, steps, reduce, lr)
        for line in run["printed"]:
            print(f"[train] {arch_id} | {line}")
        row = _train_checks(device, arch, run, batch, seq, accum, steps, lr)
        del run
        gc.collect()
        print(f"[train] {arch_id}: {json.dumps(row)}")
        out["runs"][arch_id] = row

    arch = get_arch(SERVE_ARCH).reduced() if reduce else get_arch(SERVE_ARCH)
    out["pair"] = _train_pair_check(device, arch, pair_batch)
    print(f"[train] {SERVE_ARCH} kernel pair against the plain pair and a control: {json.dumps(out['pair'])}")
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    arch_id, layers, batch, seq, ck_steps = ckpt
    arch = get_arch(arch_id).reduced() if reduce else dataclasses.replace(get_arch(arch_id), n_layers=layers)
    out["checkpoint"] = _train_ckpt_leg(device, arch, batch, seq, ck_steps, out_dir)
    print(f"[train] checkpoint leg: {json.dumps(out['checkpoint'])}")
    return out


@contextlib.contextmanager
def _passthrough(planlib, metrics):
    """No observability code on the bank path: the registry's raw backends
    swapped in and the call sites' record functions made no-ops (as
    benchmarks/bench_obs.py's baseline)."""
    saved = {name: dict(getattr(planlib, name)) for name in ("_BACKENDS", "_BANK_BACKENDS")}
    record = metrics.inc, metrics.observe
    try:
        for name, entries in saved.items():
            reg = getattr(planlib, name)
            for key, fn in entries.items():
                reg[key] = getattr(fn, "__sketch_backend__", fn)
        metrics.inc = lambda name, value=1: None
        metrics.observe = lambda name, value: None
        yield
    finally:
        for name, entries in saved.items():
            reg = getattr(planlib, name)
            reg.clear()
            reg.update(entries)
        metrics.inc, metrics.observe = record


@contextlib.contextmanager
def _obs_on(metrics, tracing):
    """Metrics on (and a trace capture, given ``tracing``) for the block."""
    metrics.enable()
    if tracing is not None:
        tracing.start_trace()
    try:
        yield
    finally:
        if tracing is not None:
            tracing.stop_trace()
        metrics.disable()
        metrics.reset()


def _sync_calls(fns, on_card: bool):
    """The fewest synchronizing calls one of ``fns`` (the same work on fresh
    inputs) makes, counted by PyTorch's sync debug mode (one warning each);
    the least of several strips a call the caching allocator makes now and
    then.  None off the card."""
    import warnings

    counts = []
    for fn in fns:
        if not on_card:
            fn()
            continue
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    return min(counts) if counts else None


def phase_obs(device, rows: int = OBS_ROWS, p: int = OBS_P, tick_items: int = OBS_TICK_ITEMS,
              calls: int = OBS_CALLS, rounds: int = OBS_ROUNDS, small_rows: int = 1024,
              small_items: int = 1 << 16, window: int = 8) -> dict:
    """benchmarks/bench_obs.py on the card at the bank tick's shape: the
    median wall of ``SketchBank.update_many`` with the instrumentation
    passed through, disabled (the default), enabled, and enabled under a
    trace capture (reported, not gated); and the synchronizing calls of the
    sketch entry points with metrics off and with metrics and a trace on
    (gated: enabling adds none)."""
    from repro_torch.obs import metrics, tracing
    from repro_torch.sketch import plan as planlib

    on_card = torch.device(device).type == "cuda"
    rng = np.random.default_rng(SEED + 11)
    keys, items = _zipf_keyed(rows, tick_items, rng)
    k_t, x_t = torch.from_numpy(keys).to(device), torch.from_numpy(items).to(device)
    bank = SketchBank.empty(rows, HLLConfig(p=p, hash_bits=64), device)
    metrics.disable()
    metrics.reset()

    def tick_s() -> list:
        out = []
        for _ in range(calls):
            _sync(device)
            t0 = time.perf_counter()
            bank.update_many(k_t, x_t)
            _sync(device)
            out.append(time.perf_counter() - t0)
        return out

    tick_s()  # warm-up: the kernels' build and first launches
    arms = {
        "passthrough": lambda: _passthrough(planlib, metrics),
        "disabled": contextlib.nullcontext,
        "enabled": lambda: _obs_on(metrics, None),
        "traced": lambda: _obs_on(metrics, tracing),
    }
    walls = {arm: [] for arm in arms}
    order = list(arms)
    for r in range(rounds):
        # the arms in turn, starting one later each round
        for arm in order[r % len(order):] + order[:r % len(order)]:
            with arms[arm]():
                walls[arm] += tick_s()
    median_ms = {arm: statistics.median(w) * 1e3 for arm, w in walls.items()}
    ratios = {arm: median_ms[arm] / median_ms["passthrough"] for arm in ("disabled", "enabled", "traced")}

    # the sketch entry points, each on fresh inputs so every arm does the
    # same work (no fold or settle cached from an earlier arm)
    cfg = HLLConfig(p=12, hash_bits=64)
    hk, hx = _zipf_keyed(small_rows, small_items, rng)
    hk_t, hx_t = torch.from_numpy(hk).to(device), torch.from_numpy(hx).to(device)
    ring0 = WindowedBank.empty(window, small_rows, cfg, device)
    for _ in range(window):
        ring0 = ring0.observe(hk_t, hx_t).advance()
    ops = {
        "SketchBank.update_many": lambda: bank.update_many(k_t, x_t),
        "HyperLogLog.update": lambda: HyperLogLog.empty(HLLConfig(p=p, hash_bits=64), device).update(x_t),
        "HybridBank.update_many + estimate_many": lambda: HybridBank.empty(small_rows, cfg, device=device)
        .update_many(hk_t, hx_t).estimate_many(),
    }
    syncs = {}
    for name, op in ops.items():
        op()  # warm
        off = _sync_calls([op] * 3, on_card)
        metrics.enable()
        tracing.start_trace()
        on = _sync_calls([op] * 3, on_card)
        tracing.stop_trace()
        metrics.disable()
        syncs[name] = (off, on)
    rings = [ring0.observe(hk_t, hx_t) for _ in range(7)]
    rings[0].estimate_window()  # warm
    off = _sync_calls([r.estimate_window for r in rings[1:4]], on_card)
    metrics.enable()
    tracing.start_trace()
    on = _sync_calls([r.estimate_window for r in rings[4:]], on_card)
    tracing.stop_trace()
    metrics.disable()
    metrics.reset()
    syncs["WindowedBank.estimate_window"] = (off, on)
    added = {name: on - off for name, (off, on) in syncs.items() if on_card and on > off}
    result = {"rows": rows, "p": p, "tick_items": tick_items, "calls_per_arm": calls * rounds,
              "median_ms": median_ms, "over_passthrough": ratios,
              "sync_calls": {name: {"disabled": off, "enabled_traced": on} for name, (off, on) in syncs.items()}}
    print(f"[obs] {json.dumps(result)}")
    if added:
        raise AssertionError(f"enabling metrics and a trace added synchronizing calls: {added}")
    return result


SHARDING_FSDP_ARCHS = ("qwen2-vl-72b", "mixtral-8x7b")  # the reference's test_fsdp_actually_shards_big_params
SHARDING_FSDP_MIN = 50e6  # parameters of a leaf that must carry the FSDP axis
SHARDING_POSITIONS = 4  # compressed_psum's positions on the one card
SHARDING_PSUM_SIZE = 1 << 22
SHARDING_STEP = ("smollm-360m", 4, 1024)  # arch, batch, sequence of the hinted step
DRYRUN_JOBS = 8  # worker processes of the sweep (the card's host has 8 cores; the caller waits)
# (arch, kind, batch, sequence, micro-batches): the cells the train and
# serve phases run at full width
DRYRUN_MEASURED = (("smollm-360m", "train", 8, 1024, 1), (ATTN_ARCH, "train", 8, 1024, 1),
                   (SERVE_ARCH, "train", 4, 1024, 2), (SERVE_ARCH, "prefill", 8, 1024, 1),
                   (ATTN_ARCH, "prefill", 8, 1024, 1))
SKETCH_ROOFLINE_KERNELS = ("hll_update_fused", "bucket_fold")


def _specs_checks(mesh) -> dict:
    """``param_specs`` of the ten archs at full width and ``cache_specs`` of
    their decode cells, on ``meta``, each checked against its leaf on the
    production ``mesh`` (``NamedSharding.check``: the divisibility jit's
    in_shardings demand); no large leaf of SHARDING_FSDP_ARCHS replicated,
    and each large stacked layer leaf carrying the FSDP axis."""
    from repro_torch import interop
    from repro_torch.configs import ARCH_IDS, SHAPES, is_cell_supported
    from repro_torch.sharding import specs as shardspecs

    leaves = caches = 0
    for arch_id in ARCH_IDS:
        arch = get_arch(arch_id)
        tree = interop.meta_tree(interop.param_leaves(transformer.init_params(arch, torch.Generator(), "meta")))
        specs = shardspecs.param_specs(tree, arch, mesh.shape["data"], mesh.shape["model"])
        shardspecs.check_tree(tree, shardspecs.named(specs, mesh), f"{arch_id} params")
        leaves += len(shardspecs.tree_leaves_with_path(tree))
        if arch_id in SHARDING_FSDP_ARCHS:
            flat = dict(shardspecs.tree_leaves_with_path(specs))
            # no large leaf replicated (the reference's test), and every large
            # stacked layer leaf over FSDP (the embedding and head shard the
            # vocabulary over 'model' instead)
            bare = [(shardspecs.keystr(path), tuple(leaf.shape)) for path, leaf in shardspecs.tree_leaves_with_path(tree)
                    if leaf.numel() > SHARDING_FSDP_MIN
                    and (not shardspecs.spec_axes(flat[path])
                         or (path[0].startswith("stage") and shardspecs.FSDP_AXIS not in shardspecs.spec_axes(flat[path])))]
            if bare:
                raise AssertionError(f"{arch_id}: leaves over {SHARDING_FSDP_MIN:.0f} parameters without FSDP: {bare}")
        for shape_name in ("decode_32k", "long_500k"):
            shape = SHAPES[shape_name]
            if is_cell_supported(arch, shape):
                cache = engine.init_cache(arch, shape.global_batch, shape.seq_len, device="meta")
                cspecs = shardspecs.cache_specs(cache, arch, mesh, shape.global_batch)
                shardspecs.check_tree(cache, shardspecs.named(cspecs, mesh), f"{arch_id} {shape_name} cache")
                caches += 1
    return {"param_leaves": leaves, "caches": caches}


def _hinted_step(device, arch, batch: int, seq: int) -> dict:
    """One train step under a (1, 1) mesh with its shardings and activation
    hints (``make_jitted_step``'s sharding arguments) against the plain
    step from the same state and batch, under deterministic algorithms:
    every leaf and the loss equal, bit for bit."""
    from repro_torch import interop
    from repro_torch.data.pipeline import DataConfig, batch_at_step
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import ctx as shardctx
    from repro_torch.train import step as train_step

    cfg = train_step.TrainConfig(sketch=HLLConfig(p=TRAIN_SKETCH_P, hash_bits=64))
    data = batch_at_step(DataConfig(arch.vocab_size, batch, seq), 0, device)
    mesh = make_test_mesh((1, 1), ("data", "model"), device)
    out = {}
    with _deterministic():
        plain = train_step.init_train_state(torch.Generator(device=device).manual_seed(SEED), arch, cfg, device)
        _, plain_metrics = train_step.train_step(plain, data, arch, cfg)
        hinted = train_step.init_train_state(torch.Generator(device=device).manual_seed(SEED), arch, cfg, device)
        tree = interop.meta_tree(interop.train_state_leaves(hinted))
        step = train_step.make_jitted_step(arch, cfg, mesh, dryrun.state_shardings(tree, arch, mesh),
                                           dryrun.batch_shardings(data, arch, mesh, batch))
        with shardctx.use_hints(shardctx.ActivationHints(batch_axes=("data",), model_axis="model")):
            _, hinted_metrics = step(hinted, data)
        out["leaves"] = _same_state(hinted, plain, "hinted step")
    if not torch.equal(plain_metrics["loss"], hinted_metrics["loss"]):
        raise AssertionError(f"hinted step's loss {float(hinted_metrics['loss'])} != {float(plain_metrics['loss'])}")
    out["loss"] = float(plain_metrics["loss"])
    return out


def phase_sharding(device, step_run=SHARDING_STEP, positions: int = SHARDING_POSITIONS,
                   psum_size: int = SHARDING_PSUM_SIZE, reduce: bool = False) -> dict:
    """The sharding rules and the compressed all-reduce (see the module
    docstring); ``reduce`` takes the hinted step's reduced arch, for the CPU
    rehearsal."""
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.optim import adamw, compress

    out = {"specs": _specs_checks(make_production_mesh(devices=[torch.device("meta")] * 256))}
    gen = torch.Generator(device=device).manual_seed(SEED + 51)
    xs = [torch.randn(psum_size, generator=gen, device=device) for _ in range(positions)]
    qs, scales = compress.compressed_gather(xs)
    for i, x in enumerate(xs):
        q, scale = adamw.quantize_int8(x)
        if not (torch.equal(qs[i], q) and torch.equal(scales[i], scale)):
            raise AssertionError(f"compressed_psum's int8 payload of position {i} differs from quantize_int8")
    got, want = compress.compressed_psum(xs), torch.stack(xs).sum(0)
    err = (got - want).abs().max().item()
    bound = 0.02 * want.abs().max().item() + 1e-3  # tests/test_sharding.py's bound
    mesh = make_test_mesh((positions,), ("data",), device)
    mean = compress.make_compressed_grad_reducer(mesh, ("data",))({"g": xs[0]})["g"]
    mean_err = (mean - xs[0]).abs().max().item()
    if err > bound or mean_err > 0.02 * xs[0].abs().max().item() + 1e-3:
        raise AssertionError(f"compressed_psum off the float32 sum: {err} (bound {bound}), mean {mean_err}")
    out["psum"] = {"positions": positions, "size": psum_size, "max_abs_err": err, "bound": bound,
                   "reducer_max_abs_err": mean_err}
    arch_id, batch, seq = step_run
    arch = get_arch(arch_id).reduced() if reduce else get_arch(arch_id)
    out["hinted_step"] = {"arch": arch_id, "batch": batch, "seq": seq, **_hinted_step(device, arch, batch, seq)}
    print(f"[sharding] {json.dumps(out)}")
    return out


def _measured_peak(device, arch, kind: str, batch: int, seq: int, accum: int) -> int:
    """Bytes the card allocated at most over one step of the dry-run's cell
    (``dryrun.prefill_fn``, or the train step with the dry-run's
    ``TrainConfig``) at full width, beyond what was allocated before it."""
    import gc

    from repro_torch.launch import dryrun
    from repro_torch.train import step as train_step

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 52)
    tokens = torch.randint(0, arch.vocab_size, (batch, seq + 1), generator=gen, device=device, dtype=torch.int32)
    if kind == "train":
        cfg = train_step.TrainConfig(grad_accum=accum)
        state = train_step.init_train_state(gen, arch, cfg, device)
        train_step.train_step(state, {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}, arch, cfg)
        del state
    else:
        model = transformer.init_params(arch, gen, device)
        with torch.inference_mode():
            out = dryrun.prefill_fn(model, {"tokens": tokens[:, :-1]}, arch)
        del model, out
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def phase_dryrun(device, jobs: int = DRYRUN_JOBS, measured=DRYRUN_MEASURED, capacity=None, out_dir: Path = BUILD,
                 reduce: bool = False) -> dict:
    """The dry-run's sweep and its peaks against the card's (see the module
    docstring).  ``capacity`` (bytes) defaults to the card's memory;
    ``reduce`` runs the sweep's reduced archs, and without a card no peak
    is measured, for the CPU rehearsal."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    on_card = torch.device(device).type == "cuda"
    capacity = dryrun.card_capacity() if capacity is None else capacity
    cells = [(a, s) for s in SHAPES for a in ARCH_IDS]  # the long train cells first: the workers finish together
    t0 = time.perf_counter()
    records = dryrun.run_cells([] if reduce else cells, False, str(out_dir / "dryrun"), jobs, capacity_bytes=capacity)
    sweep_s = time.perf_counter() - t0
    errors = [(r["arch"], r["shape"], r["error"]) for r in records if r["status"] == "error"]
    if errors:
        raise AssertionError(f"dry-run cells in error: {errors}")
    for r in records:
        line = {"status": r["status"]}
        if r["status"] == "ok":
            mem = r["memory_analysis"]
            line.update(peak_per_position=mem["peak_bytes_per_device_est"], fits_per_position=r["fits_per_position"],
                        fits_one_card=r["fits_one_card"], dominant=r["roofline"]["dominant"],
                        bound_s=r["roofline"]["bound_s"], useful=r["roofline"].get("useful_flop_ratio"),
                        fake_run_s=r["compile_s"])
        print(f"[dryrun] {r['arch']} {r['shape']} {r['mesh']}: {json.dumps(line)}")
    one = Mesh((1, 1), ("data", "model"), [torch.device("meta")])
    rows = []
    for arch_id, kind, batch, seq, accum in measured:
        full = get_arch(arch_id)
        arch = full.reduced() if reduce else full
        overrides = {f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)
                     if getattr(arch, f.name) != getattr(full, f.name)}
        shape = ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)
        rec = dryrun.run_cell(arch_id, shape, False, None, overrides=overrides or None, grad_accum=accum,
                              capacity_bytes=capacity, mesh=one)
        if rec["status"] != "ok":
            raise AssertionError(f"dry-run of {arch_id} {shape.name}: {rec.get('error')}")
        predicted = rec["memory_analysis"]["one_card"]["peak_bytes_est"]
        row = {"arch": arch_id, "cell": shape.name, "grad_accum": accum, "predicted": predicted,
               "predicted_args": rec["memory_analysis"]["one_card"]["argument_size_in_bytes"],
               "fits_one_card": rec["fits_one_card"]}
        if on_card:
            row["measured"] = _measured_peak(device, arch, kind, batch, seq, accum)
            row["measured_over_predicted"] = row["measured"] / predicted
            # the card ran the cell, so it fits: the dry-run must say so
            if not rec["fits_one_card"]:
                raise AssertionError(f"the dry-run says {arch_id} {shape.name} does not fit one card; the card ran it")
        print(f"[dryrun] predicted and measured peak: {json.dumps(row)}")
        rows.append(row)
    print(f"[dryrun] {len(records)} cells in {sweep_s:.1f} s over {jobs} processes; capacity {capacity} bytes")
    return {"cells": len(records), "sweep_s": sweep_s, "measured": rows,
            "statuses": {s: sum(r["status"] == s for r in records) for s in ("ok", "skipped")}}


def phase_sketch_roofline(device, n_items=None, rounds: int = 5) -> dict:
    """The paper's Fig. 4 question on the card (see the module docstring):
    the five variants' measured time against the stream read once, each
    variant's registers bit-identical to the "torch" backend's."""
    from repro_torch.launch import sketch_roofline
    from repro_torch.sketch import update_registers

    items = sketch_roofline.make_stream(sketch_roofline.N_ITEMS if n_items is None else n_items, device, SEED + 53)
    reset_launches()
    results = sketch_roofline.run(items, rounds=rounds)
    launches = launch_counts()
    missing = [name for name in SKETCH_ROOFLINE_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the sketch roofline: {missing}")
    want = {}
    for r, (_, cfg, _, _) in zip(results, sketch_roofline.VARIANTS):
        if cfg not in want:
            want[cfg] = update_registers(torch.zeros(cfg.m, dtype=torch.uint8, device=device), items, cfg,
                                         ExecutionPlan(backend="torch", pipelines=1))
        if not torch.equal(r.pop("registers"), want[cfg]):
            raise AssertionError(f"sketch roofline {r['variant']}: registers differ from the torch backend's")
        print(f"[sketch_roofline] {json.dumps(r)}")
    return {"variants": results, "launches": {k: launches[k] for k in SKETCH_ROOFLINE_KERNELS}}


# the examples phase: each run's flags and the kernels the dispatch code says
# it launches (sketch/backends.py, telemetry/sketchboard.py, models/rwkv6.py,
# dispatch.datapath_tap)
EXAMPLE_STREAM_RUNS = {
    "defaults": ((), ("hll_update_fused", "bucket_fold")),
    "tenants": (("--tenants", "64"), ("hash_rank", "bank_scatter_max")),
    "window": (("--tenants", "16", "--window", "8", "--advance-every", "2"),
               ("hash_rank", "bank_scatter_max", "window_merge_max", "window_fold_max")),
    "multires": (("--tenants", "16", "--window", "8", "--advance-every", "2", "--window-levels", "3"),
                 ("hash_rank", "bank_scatter_max", "window_fold_max")),
    "unique": (("--distribution", "unique"), ("hll_update_fused", "bucket_fold")),
}
EXAMPLE_QUICKSTART_KERNELS = ("hll_update_fused", "bucket_fold", "hash_rank", "bank_scatter_max", "window_merge_max",
                              "window_fold_max", "cm_scatter_add")
EXAMPLE_SERVE_RUNS = {"tinyllama-1.1b": ("hash_rank", "bank_scatter_max"),
                      "rwkv6-3b": ("rwkv_intra", "hash_rank", "bank_scatter_max")}
EXAMPLE_TRAIN_KERNELS = ("hll_update_fused",)  # the tap, once a step
EXAMPLE_RESUME = (20, 10, 40)  # train_lm's kill-and-rerun: --steps, --ckpt-every, then --steps
EXAMPLE_TRAIN_FULL = ("--full-config", "--arch", "smollm-360m", "--steps", "8", "--ckpt-every", "8")
EXAMPLE_ZIPF_ULPS = 2  # expf's largest error on the card (CUDA C++ Programming Guide): two exps 2 ulps apart


def _example_run(device, what: str, fn, *args):
    """``fn(*args)`` with the launch counts zeroed just before it and read
    just after it; its printed lines echoed as ``[examples] what | line``.
    Returns (its result, the counts, the lines)."""
    import io

    printed = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(printed):
        out = fn(*args)
    _sync(device)
    launches = launch_counts()
    lines = printed.getvalue().splitlines()
    for line in lines:
        print(f"[examples] {what} | {line}")
    return out, launches, lines


def _must_launch(device, what: str, launches: dict, kernels) -> dict:
    """The kernels a run launched, with their counts; raises on the card
    where one of ``kernels`` never launched (on the CPU every wrapper runs
    its plain version)."""
    missing = [name for name in kernels if launches[name] == 0]
    if missing and torch.device(device).type == "cuda":
        raise AssertionError(f"examples {what}: kernels never launched: {missing} (launches {launches})")
    return {name: count for name, count in launches.items() if count}


def _stream_example(device, stream_flags) -> dict:
    """Each stream_cardinality run against the same stream through the
    "torch" backend on the same device; the unique run's estimate within 4
    sigma of n; the card's zipf stream against the CPU's."""
    from examples_torch import stream_cardinality
    from repro_torch.data.pipeline import batch_at_step, zipf_exponent
    from repro_torch.sketch import hll

    rows = {}
    for name, (flags, kernels) in EXAMPLE_STREAM_RUNS.items():
        argv = list(flags) + list(stream_flags) + ["--device", str(device)]
        what = "stream_cardinality " + (" ".join(flags) or "(defaults)")
        out, launches, _ = _example_run(device, what, stream_cardinality.main, argv)
        with contextlib.redirect_stdout(None):
            plain = stream_cardinality.run(stream_cardinality.parse_args(argv), "torch")
        if out["mode"] == "single":
            same = torch.equal(out["registers"], plain["registers"]) and out["estimate"] == plain["estimate"]
        elif out["mode"] == "bank":
            same = (out["bank"].to_bytes() == plain["bank"].to_bytes()
                    and np.array_equal(out["estimates"], plain["estimates"]))
        else:
            same = (out["window"].to_bytes() == plain["window"].to_bytes()
                    and np.array_equal(out["rolling"], plain["rolling"])
                    and np.array_equal(out["newest"], plain["newest"]))
        if not same:
            raise AssertionError(f"examples {what}: the state or readings differ from the torch backend's")
        row = {"flags": list(flags), "streamed": out["streamed"], "items_per_s": out["items_per_s"],
               "finalize_us": out["finalize_us"], "launches": _must_launch(device, what, launches, kernels),
               "equal_to_torch_backend": True}
        if name == "unique":
            cfg = HLLConfig(p=stream_cardinality.parse_args(argv).p, hash_bits=64)
            n, est = out["streamed"], out["estimate"]
            row["estimate"], row["sigmas"] = est, abs(est - n) / (hll.standard_error(cfg) * n)
            if row["sigmas"] > 4:
                raise AssertionError(f"examples {what}: estimate {est} of {n} unique items, {row['sigmas']} sigma")
        rows[name] = row
        print(f"[examples] {what}: {json.dumps(row)}")

    # the card's zipf tokens at the example's vocab against the CPU's (ROADMAP C.3)
    args = stream_cardinality.parse_args(list(stream_flags) + ["--device", str(device)])
    data = stream_cardinality.data_config(args)
    flips = widest = exp_differ = n = 0
    for step in range(args.chunks):
        mine = batch_at_step(data, step, device)["tokens"].cpu().numpy()
        cpu = batch_at_step(data, step, "cpu")["tokens"].numpy()
        arg = zipf_exponent(data, step, "cpu")[:-1]
        flips += zipf_flips(mine, cpu, arg.numpy(), data.vocab_size, EXAMPLE_ZIPF_ULPS)
        widest = max(widest, int(np.abs(mine.astype(np.int64) - cpu).max()))
        exp_differ += int((torch.exp(arg.to(device)).cpu() != torch.exp(arg)).sum())
        n += mine.size
    bound = zipf_flip_bound(data.vocab_size, n)  # rate 1: this is where the card's rate is measured
    zipf = {"vocab": data.vocab_size, "tokens": n, "differing": flips, "bound": bound, "widest": widest,
            "exp_differ_rate": exp_differ / n}
    print(f"[examples] zipf tokens, card against CPU: {json.dumps(zipf)}")
    if flips > bound:
        raise AssertionError(f"examples: {flips} zipf tokens of {n} differ from the CPU's, over {bound}")
    return {"runs": rows, "zipf_card_vs_cpu": zipf}


def _quickstart_example(device, quick_items) -> dict:
    """quickstart: its estimate within 4 sigma, the blob's round trip, the
    registers equal to the "torch" backend's, the top 8 = ids 0-7."""
    from examples_torch import quickstart
    from repro_torch.sketch import standard_error

    if quick_items is None:
        out, launches, _ = _example_run(device, "quickstart", quickstart.main, ["--device", str(device)])
    else:
        out, launches, _ = _example_run(device, "quickstart", quickstart.tour, quick_items, device)
    sk, exact = out["sketch"], out["exact"]
    est = sk.estimate()
    sigmas = abs(est - exact) / (standard_error(sk.cfg) * exact)
    if sigmas > 4:
        raise AssertionError(f"examples quickstart: estimate {est} vs exact {exact}, {sigmas} sigma")
    back = HyperLogLog.from_bytes(out["blob"], device)
    if back.to_bytes() != out["blob"] or not torch.equal(back.registers, out["merged"].registers):
        raise AssertionError("examples quickstart: the blob does not round-trip")
    want = HyperLogLog.of(out["items"], sk.cfg, ExecutionPlan(backend="torch"))
    for name in ("sketch", "streamed", "merged"):
        if not torch.equal(out[name].registers, want.registers):
            raise AssertionError(f"examples quickstart: {name} registers differ from the torch backend's")
    top = sorted(out["topk"][0][0].tolist())
    if top != list(range(8)):
        raise AssertionError(f"examples quickstart: top 8 values {top}, not ids 0-7")
    row = {"items": out["items"].numel(), "exact": exact, "estimate": est, "sigmas": sigmas,
           "blob_bytes": len(out["blob"]), "launches": _must_launch(device, "quickstart", launches,
                                                                        EXAMPLE_QUICKSTART_KERNELS),
           "equal_to_torch_backend": True, "top8": top}
    print(f"[examples] quickstart: {json.dumps(row)}")
    return row


def _serve_example(device, serve_flags) -> dict:
    """serve_lm at its defaults and with --arch rwkv6-3b: the board's items
    seen equal to the items observed; rwkv_intra once a layer a prefill."""
    from examples_torch import serve_lm

    rows = {}
    for arch_id, kernels in EXAMPLE_SERVE_RUNS.items():
        what = f"serve_lm --arch {arch_id}"
        out, launches, _ = _example_run(device, what, serve_lm.main,
                                        ["--arch", arch_id, "--device", str(device)] + list(serve_flags))
        b, s, t = out["requests"], out["prompt_len"], out["gen_len"]
        seen = {name: out["report"][name]["items_seen"] for name in out["report"]}
        if seen != {"request_ids": b, "prompt_tokens": b * s, "generated_tokens": b * t}:
            raise AssertionError(f"examples {what}: the board saw {seen}")
        row = {"requests": b, "prompt_len": s, "gen_len": t, "prefill_tokens_per_s": out["prefill_tokens_per_s"],
               "decode_tokens_per_s": out["decode_tokens_per_s"], "items_seen": seen,
               "launches": _must_launch(device, what, launches, kernels)}
        if arch_id == "rwkv6-3b":
            layers = get_arch(arch_id).reduced().n_layers
            if torch.device(device).type == "cuda" and launches["rwkv_intra"] != layers:
                raise AssertionError(f"examples {what}: rwkv_intra launched {launches['rwkv_intra']} times in "
                                     f"one prefill, not once a layer ({layers})")
        rows[arch_id] = row
        print(f"[examples] {what}: {json.dumps(row)}")
    return rows


def _train_examples(device, train_steps: int, train_small, resume, full) -> dict:
    """train_lm at its defaults (the loss falls), killed and rerun (it
    resumes), and at full width (tokens/s, peak memory, the tap's estimate
    within 4 sigma of the exact distinct tokens); elastic_rescale's registers
    across the resharded restore.  Every checkpoint directory is fresh and
    deleted after its run."""
    import gc
    import shutil
    import tempfile

    from examples_torch import train_lm
    from repro_torch.sketch import hll

    out = {}
    dirs = []

    def fresh() -> str:
        dirs.append(tempfile.mkdtemp(prefix="repro_torch_examples_"))
        return dirs[-1]

    try:
        argv = ["--steps", str(train_steps), "--ckpt-dir", fresh(), "--device", str(device)] + list(train_small)
        run, launches, _ = _example_run(device, "train_lm", train_lm.main, argv)
        if not run["last_loss"] < run["first_loss"]:
            raise AssertionError(f"examples train_lm: the loss did not fall: {run['history']}")
        if torch.device(device).type == "cuda" and launches["hll_update_fused"] != train_steps:
            raise AssertionError(f"examples train_lm: the tap launched {launches['hll_update_fused']} times "
                                 f"in {train_steps} steps")
        out["defaults"] = {"steps": train_steps, "first_loss": run["first_loss"], "last_loss": run["last_loss"],
                           "distinct_tokens": run["distinct_tokens"],
                           "launches": _must_launch(device, "train_lm", launches, EXAMPLE_TRAIN_KERNELS)}
        del run

        killed_at, every, rerun_to = resume
        d = fresh()
        base = ["--ckpt-dir", d, "--ckpt-every", str(every), "--device", str(device)] + list(train_small)
        _, killed, _ = _example_run(device, "train_lm (killed)", train_lm.main, ["--steps", str(killed_at)] + base)
        rerun, launches, lines = _example_run(device, "train_lm (rerun)", train_lm.main,
                                              ["--steps", str(rerun_to)] + base)
        if f"[loop] resumed from step {killed_at}" not in lines or int(rerun["state"]["step"]) != rerun_to:
            raise AssertionError(f"examples train_lm: the rerun did not resume from step {killed_at}")
        out["resume"] = {"killed_at": killed_at, "rerun_to": rerun_to, "resumed": True,
                         "launches": {"killed": _must_launch(device, "train_lm (killed)", killed, EXAMPLE_TRAIN_KERNELS),
                                      "rerun": _must_launch(device, "train_lm (rerun)", launches,
                                                            EXAMPLE_TRAIN_KERNELS)}}
        del rerun
        gc.collect()

        argv = list(full) + ["--ckpt-dir", fresh(), "--device", str(device)] + list(train_small)
        run = _timed_train_run(device, lambda a: train_lm.main(a)["state"], argv)
        for line in run["printed"]:
            print(f"[examples] train_lm {' '.join(full)} | {line}")
        rows = run["rows"]
        cfg = HLLConfig(p=14, hash_bits=64)
        tokens = torch.cat([row["tokens"].reshape(-1) for row in rows])
        exact = int(torch.unique(tokens).numel())
        est = hll.estimate(run["state"]["sketch"], cfg)
        sigmas = abs(est - exact) / (hll.standard_error(cfg) * exact)
        if sigmas > 4:
            raise AssertionError(f"examples train_lm full width: tap estimate {est} vs {exact} exact, {sigmas} sigma")
        warm = rows[1:] or rows
        shape = tuple(rows[0]["tokens"].shape)
        out["full"] = {"flags": list(full), "batch": list(shape), "steps": len(rows),
                       "tokens_per_s": math.prod(shape) * len(warm) / sum(row["wall_s"] for row in warm),
                       "max_memory_allocated": run["max_memory_allocated"], "estimate": est, "exact_distinct": exact,
                       "sigmas": sigmas, "launches": _must_launch(device, "train_lm full", run["launches"],
                                                                  EXAMPLE_TRAIN_KERNELS)}
        del run, rows, tokens
        gc.collect()
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    for name in ("defaults", "resume", "full"):
        print(f"[examples] train_lm {name}: {json.dumps(out[name])}")
    return out


def phase_examples(device, stream_flags=(), quick_items=None, serve_flags=(), train_steps: int = 200,
                   train_small=(), resume=EXAMPLE_RESUME, full=EXAMPLE_TRAIN_FULL, elastic=None) -> dict:
    """The five examples of ``examples_torch/``, each ``main`` in-process on
    ``device`` (see the module docstring); the sizes are the examples' own
    unless given (the CPU rehearsal's).  The launch counts are zeroed just
    before each run and read just after it."""
    import gc

    from examples_torch import elastic_rescale

    on_card = torch.device(device).type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out = {"stream_cardinality": _stream_example(device, stream_flags),
           "quickstart": _quickstart_example(device, quick_items),
           "serve_lm": _serve_example(device, serve_flags),
           "train_lm": _train_examples(device, train_steps, train_small, resume, full)}
    if elastic is None:
        run, launches, lines = _example_run(device, "elastic_rescale", elastic_rescale.main, ["--device", str(device)])
        total = 40
    else:
        run, launches, lines = _example_run(device, "elastic_rescale", elastic_rescale.rescale, *elastic, device)
        total = elastic[1]
    if not np.array_equal(run["sketch_restored"], run["sketch_before"]):
        raise AssertionError("examples elastic_rescale: the registers changed across the restore")
    if run["step"] != total or "sketch registers survived resharding bit-exactly" not in lines:
        raise AssertionError(f"examples elastic_rescale: resumed to step {run['step']}, not {total}")
    if on_card and launches["hll_update_fused"] != total:
        raise AssertionError(f"examples elastic_rescale: the tap launched {launches['hll_update_fused']} times")
    out["elastic_rescale"] = {"step": run["step"], "registers_equal": True, "estimate": run["estimate"],
                              "launches": _must_launch(device, "elastic_rescale", launches,
                                                           EXAMPLE_TRAIN_KERNELS)}
    print(f"[examples] elastic_rescale: {json.dumps(out['elastic_rescale'])}")
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, args_list, iters: int = 50, warmup: int = 3) -> tuple:
    """(device ms, host ms) per call, each a mean over ``iters`` warm calls.

    Device time: CUDA events around the calls, enqueued behind a sleeping
    kernel so the card runs them back to back and the events time the card,
    not the Python that launches them; the sleep doubles until the host
    finishes enqueuing before the card reaches the first call.  Host time:
    the wall clock of the same calls, synchronized, launch overhead
    included.  ``args_list`` rotates the inputs, so repeated calls do not
    find them all in the 50 MB L2 where the real caller would not.
    """
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    cycles = 1 << 24
    for _ in range(8):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            break
        cycles *= 2
    else:
        raise RuntimeError("the host could not enqueue the timed calls ahead of the card")
    device_ms = start.elapsed_time(stop) / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    return device_ms, (time.perf_counter() - t0) * 1e3 / iters


def _wall_ms(fn, args_list, iters: int = 10, warmup: int = 2) -> tuple:
    """(ms, ms) per call, both the synchronized wall clock over ``iters``
    calls: for a callable that reads back to the host (``torch.bincount``
    reads its input's min and max), which the card cannot run ahead of the
    host as ``_time_ms`` needs."""
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    return ms, ms


def intra_flops(g: int, c: int, n: int) -> int:
    """float32 operations of rwkv_intra on (G, C, N) cells: per pair s < t and
    n a subtract, two multiplies and an add (the exp not counted); per (t, n)
    three for the diagonal; per (t, s <= t, n) a multiply-add for y."""
    return g * n * (4 * (c * (c - 1) // 2) + 3 * c + 2 * (c * (c + 1) // 2))


def phase_timing(device, n: int = 1 << 22, rows: int = BANK_ROWS, hybrid_rows: int = HYBRID_ROWS,
                 window: int = WINDOW, intra_shape=INTRA_SHAPES[0], intra_bwd_shape=INTRA_BWD_SHAPES[0],
                 only=None) -> dict:
    """Kernel, plain and library times at the main path's shapes; ``only``
    (kernel names) times those alone, without the variants."""
    rng = np.random.default_rng(SEED + 2)
    cfg = HLLConfig(p=16, hash_bits=64)
    m = cfg.m
    streams = [(_items_tensor(rng.integers(0, 2**32, n, dtype=np.uint32), device),) for _ in range(4)]
    regs = torch.zeros(m, dtype=torch.uint8, device=device)
    partials = torch.from_numpy(rng.integers(0, 50, (PIPELINES, m), dtype=np.uint8)).to(device)
    keys, items = _zipf_keyed(rows, n, rng)
    bank = torch.from_numpy(rng.integers(0, 20, (rows, m), dtype=np.uint8)).to(device)
    k_t = torch.from_numpy(keys).to(device)
    idx, rank = hash_rank(_items_tensor(items.view(np.uint32), device), cfg)
    cells = k_t.to(torch.int64) * m + idx
    rank8 = rank.to(torch.uint8)
    flat = bank.reshape(-1)
    # sparse_scatter_coo at the hybrid compaction's shape: the whole
    # bench_sparse stream (222 items a row) deduped into (16384, 4096) cells
    sm = 1 << 12
    triples = hybrid_rows * HYBRID_ITEMS_PER_ROW
    hkeys, hitems = _zipf_traffic(hybrid_rows, triples, rng)
    hrow = torch.from_numpy(hkeys).to(device)
    hidx, hrank = hash_rank(_items_tensor(hitems.view(np.uint32), device), HLLConfig(p=12, hash_bits=64))
    hcell = hrow.to(torch.int64) * sm + hidx
    # window_fold_max over the 256 MiB ring with every slice live, and
    # window_merge_max over the K = 3 fragments, rotated over 8 stacks so
    # they do not sit in L2
    ring = torch.from_numpy(rng.integers(0, 40, (window, rows, sm), dtype=np.uint8)).to(device)
    live = torch.ones(window, dtype=torch.bool, device=device)
    stacks = [(torch.from_numpy(rng.integers(0, 40, (3, rows, sm), dtype=np.uint8)).to(device),)
              for _ in range(8)]
    # cm_scatter_add: 2^22 keyed items into the (1024, 4, 1024) bank; the
    # library call is index_add_ of the d-expanded cells into the flat int32
    # counters, with the hash (cm_hash_index) computed beforehand, outside it
    cmc = CMConfig(CM_DEPTH, CM_WIDTH, seed=0)
    cm_bank = torch.from_numpy(rng.integers(0, 1000, (rows, CM_DEPTH, CM_WIDTH), dtype=np.int32)).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    cm_streams = [_cm_traffic(rows, n, CM_ITEM_IDS, gen) for _ in range(4)]
    ck_t, cx_t = cm_streams[0]
    ok = (ck_t >= 0) & (ck_t < rows)
    lane = torch.arange(CM_DEPTH, device=device)[:, None] * CM_WIDTH
    idx_ok = cm_hash_index(cx_t, cmc).to(torch.int64)[:, ok]
    cm_cells = ((ck_t[ok].to(torch.int64) * cmc.cells)[None, :] + lane + idx_ok).reshape(-1)
    cm_ones = torch.ones(cm_cells.numel(), dtype=torch.int32, device=device)
    cm_flat = cm_bank.reshape(-1)
    # cm_window_fold_sum over a (64, 1024, 4096) int32 ring (1 GiB), all live
    cm_ring = torch.randint(-16, 0, (window, rows, cmc.cells), dtype=torch.int32, device=device)
    # rwkv_intra at the serve prefill's grid: 8 requests x 16 chunks x 40 heads
    ig, ic, inn = intra_shape
    intra_args = _intra_inputs(ig, ic, inn, gen, device)
    # rwkv_intra_bwd at the training grid: 2 sequences x 16 chunks x 40 heads
    bg, bc, bn = intra_bwd_shape
    bwd_args = _intra_bwd_inputs(bg, bc, bn, gen, device)
    # bank_row_count at the fleet tick's shape: 2^25 Zipf(1.2) keys over the
    # 1024 rows, 2 streams of 128 MiB rotated
    count_streams = [(_zipf_ranks(COUNT_TICK_KEYS, ZIPF_A, rows, gen).to(torch.int32),) for _ in range(2)]
    count_limbs = u64.from_numpy(rng.integers(0, 1 << 40, rows, dtype=np.uint64), device)
    calls = {
        "hash_rank": (
            (lambda x: hash_rank(x, cfg), streams),
            (lambda x: hash_rank_plain(x, cfg), streams),
            None,
            n * (4 + 8),
        ),
        "hll_update_fused": (
            (lambda x: hll_update_fused(regs, x, None, cfg), streams),
            (lambda x: hll_update_fused_plain(regs, x, None, cfg), streams),
            None,
            n * 4 + 2 * m,
        ),
        "bucket_fold": (
            (bucket_fold, [(partials,)]),
            (bucket_fold_plain, [(partials,)]),
            (lambda t: torch.amax(t, 0), [(partials,)]),
            partials.numel() + m,
        ),
        "bank_scatter_max": (
            (bank_scatter_max, [(bank, k_t, idx, rank)]),
            (bank_scatter_max_plain, [(bank, k_t, idx, rank)]),
            (lambda: flat.scatter_reduce(0, cells, rank8, "amax"), [()]),
            2 * bank.numel() + 12 * n,
        ),
        "sparse_scatter_coo": (
            (lambda: sparse_scatter_coo(hrow, hidx, hrank, hybrid_rows, sm), [()]),
            (lambda: sparse_scatter_coo_plain(hrow, hidx, hrank, hybrid_rows, sm), [()]),
            # the cells half only: one scatter_reduce amax into zeroed cells
            (lambda: torch.zeros(hybrid_rows * sm, dtype=torch.int32, device=device).scatter_reduce_(
                0, hcell, hrank, "amax"), [()]),
            12 * triples + 4 * hybrid_rows * sm + 4 * hybrid_rows,
        ),
        "window_fold_max": (
            (window_fold_max, [(ring, live)]),
            (window_fold_max_plain, [(ring, live)]),
            (lambda: torch.amax(ring, 0), [()]),
            ring.numel() + rows * sm,
        ),
        "window_merge_max": (
            (window_merge_max, stacks),
            (window_merge_max_plain, stacks),
            (lambda t: torch.amax(t, 0), stacks),
            4 * rows * sm,
        ),
        "cm_scatter_add": (
            (lambda k, x: cm_scatter_add(cm_bank, k, x, cmc), cm_streams),
            (lambda k, x: cm_scatter_add_plain(cm_bank, k, x, cmc), cm_streams),
            (lambda: cm_flat.index_add(0, cm_cells, cm_ones), [()]),
            8 * n + 2 * cm_bank.numel() * 4,
        ),
        "cm_window_fold_sum": (
            (cm_window_fold_sum, [(cm_ring, live)]),
            (cm_window_fold_sum_plain, [(cm_ring, live)]),
            (lambda: cm_ring.sum(0, dtype=torch.int32), [()]),
            4 * cm_ring.numel() + 4 * rows * cmc.cells,
        ),
        # no one PyTorch call computes the intra form: no library time
        "rwkv_intra": (
            (rwkv_intra, [intra_args]),
            (rwkv_intra_plain, [intra_args]),
            None,
            4 * (6 * ig * ic * inn + ig * inn),
        ),
        # no one PyTorch call computes the gradient either; its inputs: six
        # tiles and u; its outputs: five tiles and du per cell
        "rwkv_intra_bwd": (
            (rwkv_intra_bwd, [bwd_args]),
            (rwkv_intra_bwd_plain, [bwd_args]),
            None,
            4 * (11 * bg * bc * bn + 2 * bg * bn),
        ),
    }
    if vote_module is not None:
        # cm_vote at the tick of the benchmark's heavy-hitter cell: 2^22 keys
        # and items uniform into the (1024, 4, 1024) tables, 2 ticks rotated;
        # no one PyTorch call computes the vote
        cm_labels, cm_votes = (torch.randint(-8, 8, (rows, CM_DEPTH, CM_WIDTH), generator=gen, device=device,
                                             dtype=torch.int32) for _ in range(2))
        vote_ticks = [(torch.randint(0, rows, (n,), generator=gen, device=device, dtype=torch.int32),
                       torch.randint(-(2**31), 2**31 - 1, (n,), generator=gen, device=device, dtype=torch.int32))
                      for _ in range(2)]
        calls["cm_vote"] = (
            (lambda k, x: vote_module.cm_vote(cm_labels, cm_votes, k, x, cmc), vote_ticks),
            (lambda k, x: _label_update(cm_labels, cm_votes, k, x, cmc), vote_ticks),
            None,
            8 * n + 16 * cm_labels.numel(),
        )
    if estimate_module is not None:
        # hll_estimate at the dashboard's read: "original" over the fleet's
        # (1024, 4096) bank after one Zipf(1.2)-keyed update; no one PyTorch
        # call computes it
        fleet_cfg = HLLConfig(p=12, hash_bits=64)
        fleet = [(SketchBank.empty(rows, fleet_cfg, device).update_many(k_t, _items_tensor(items, device)).registers,)]
        calls["hll_estimate"] = (
            (lambda r: estimate_module.hll_estimate(r, fleet_cfg, "original"), fleet),
            (lambda r: _plain_estimate(r, fleet_cfg), fleet),
            None,
            fleet[0][0].numel() + 4 * rows,
        )
    if count_module is not None:
        calls["bank_row_count"] = (
            (lambda k: count_module.bank_row_count(count_limbs, k), count_streams),
            (lambda k: count_module.bank_row_count_plain(count_limbs, k), count_streams),
            # the counts half only: one bincount of keys that are all valid
            (lambda k: torch.bincount(k, minlength=rows), count_streams),
            4 * COUNT_TICK_KEYS + 32 * rows,
        )
    # float32 operations where the guide's peak table has a rate for them;
    # the sketch kernels' integer work has none, so bytes bound them
    flops = {"rwkv_intra": intra_flops(ig, ic, inn), "rwkv_intra_bwd": intra_bwd_flops(bg, bc, bn)}
    out = {}
    if only is not None:
        calls = {name: calls[name] for name in only}
    for name, (kernel, plain, library, nbytes) in calls.items():
        ms, host_ms = _time_ms(*kernel)
        spread = None
        if name in SPREAD_KERNELS:
            # more rounds beside the first, which every row records as ms:
            # these two move from run to run
            rounds = [ms] + [_time_ms(*kernel)[0] for _ in range(SPREAD_ROUNDS - 1)]
            spread = {"min": min(rounds), "median": statistics.median(rounds), "max": max(rounds),
                      "rounds": rounds}
        plain_ms, plain_host_ms = (_wall_ms if name in HOST_READS else _time_ms)(*plain, iters=3)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops.get(name, 0) / F32_FLOPS_PER_S * 1e3
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "library_ms": (_wall_ms if name in HOST_READS else _time_ms)(*library, iters=10)[0] if library else None,
            "host_ms": host_ms, "plain_host_ms": plain_host_ms,
        }
        if spread:
            out[name]["spread_ms"] = spread
    if "bucket_fold" in out:
        # the card's time for one launch of this kernel: a (1, 16) fold
        tiny = partials[:1, :16].contiguous()
        out["bucket_fold"]["floor_ms"] = _time_ms(bucket_fold, [(tiny,)])[0]
    for name, row in out.items():
        print(f"[timing] {name}: {json.dumps(row)}")
    variants = {}
    if only is None:
        # sparse_scatter_coo's global path at the same shape (zeroed cells,
        # atomicMax and first-touch counts, one thread a triple, uncapped grid)
        with _setting(sparse_module, "HIST_TILES", 0):
            variants["sparse_scatter_coo global path"] = _time_ms(
                lambda: sparse_scatter_coo(hrow, hidx, hrank, hybrid_rows, sm), [()])[0]
        # cm_scatter_add's global path at the main shape: one atomicAdd a hit
        # into a copy of the bank (the previous design)
        print(f"[timing] cm_scatter_add path at the main shape: {_cm_path(rows, cmc, n, device)}")
        variants["cm_scatter_add global path"] = _time_ms(
            lambda k, x: cm_module.cm_scatter_add_global(cm_bank, k, x, cmc), cm_streams)[0]
    if (only is None or "bank_scatter_max" in only) and hasattr(bank_module, "bank_scatter_max_global"):
        variants.update(_bank_path_times(device, rows, n, rng))
    if (only is None or "bank_row_count" in only) and count_module is not None:
        variants.update(_row_count_times(device, rows, hybrid_rows, count_streams, rng))
    if (only is None or "hll_estimate" in only) and estimate_module is not None:
        # a p = 16 sketch (HyperLogLog.estimate_device, the train step's
        # tap): one block of 512 threads
        from repro_torch.sketch import hll

        c16 = HLLConfig(p=16, hash_bits=64)
        sketch = [(hll.update(hll.init_registers(c16, device), streams[0][0], c16).reshape(1, -1),)]
        variants["hll_estimate (1, 65536)"] = _time_ms(lambda r: estimate_module.hll_estimate(r, c16, "original"),
                                                       sketch)[0]
        variants["hll_estimate plain (1, 65536)"] = _wall_ms(
            lambda r: _plain_estimate(r, c16), sketch)[0]
    if variants:
        print(f"[timing] variants, device ms: {json.dumps(variants)}")
        out["variants"] = variants
    return out


def _row_count_times(device, rows: int, hybrid_rows: int, tick_streams: list, rng: np.random.Generator) -> dict:
    """bank_row_count's paths and its plain version, device ms, at the fleet
    tick's shape (``tick_streams``), at HybridBank's (16384 rows,
    bench_sparse's chunk of 909,312 keys, 10 % of the rows taking 90 %, 4
    streams rotated) and at a bank past the shared path: 2^20 rows and the
    tick's 2^25 Zipf(1.2) keys, 2 streams rotated.  SHARED_ROWS = 0 sends
    every shape to the global path."""
    chunk = hybrid_rows * HYBRID_ITEMS_PER_ROW // HYBRID_CHUNKS
    hybrid = [(torch.from_numpy(_zipf_traffic(hybrid_rows, chunk, rng)[0]).to(device),) for _ in range(4)]
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    large = [(_zipf_ranks(COUNT_TICK_KEYS, ZIPF_A, COUNT_LARGE_ROWS, gen).to(torch.int32),) for _ in range(2)]
    times = {}
    for name, b_rows, streams in (("fleet tick", rows, tick_streams), ("hybrid chunk", hybrid_rows, hybrid),
                                  ("large bank", COUNT_LARGE_ROWS, large)):
        limbs = u64.from_numpy(rng.integers(0, 1 << 40, b_rows, dtype=np.uint64), device)
        shape = f"({b_rows} rows, {streams[0][0].numel()} keys)"
        chosen = count_module.bank_count_path(b_rows)
        for path in ("shared", "global") if chosen == "shared" else ("global",):
            with _setting(count_module, "SHARED_ROWS", 0) if path == "global" else contextlib.nullcontext():
                times[f"bank_row_count {path} path, {name} {shape}{' (chosen)' if path == chosen else ''}"] = (
                    _time_ms(lambda k: count_module.bank_row_count(limbs, k), streams)[0])
        times[f"bank_row_count plain, {name} {shape}"] = _wall_ms(
            lambda k: count_module.bank_row_count_plain(limbs, k), streams)[0]
        del streams
    return times


def bank_callers(rows: int = BANK_ROWS, n: int = BANK_TICK_ITEMS) -> dict:
    """The bank backend's callers on the main paths, {name: (B, p, entries,
    share of entries with a dropped key)}: ``SketchBank.update_many``'s tick,
    a ``WindowedBank`` epoch (its current slice), the telemetry board's flush
    (``SketchBank.from_sketches`` of the streams), ``HybridBank``'s dense
    block at the bench_sparse acceptance size (1638 promoted rows; the last
    chunk's 909,312 entries, the 10 % bound for sparse rows keyed -1)."""
    return {
        "bank tick": (rows, 16, n, 0.0),
        "window epoch": (WINDOW_ROWS, 12, WINDOW_EPOCH_ITEMS, 0.0),
        "board flush": (BOARD_STREAMS, 12, BOARD_EPOCH_ITEMS, 0.0),
        "hybrid dense block": (1638, 12, 909_312, 0.1),
    }


def _bank_path_times(device, rows: int, n: int, rng: np.random.Generator) -> dict:
    """bank_scatter_max's two paths at each caller's shape, device ms, and
    the path ``bank_scatter_path`` picks there; Zipf(1.2) keys as the bank
    and window phases draw them, 4 streams rotated.  Each shape twice: on a
    bank of random registers in [0, 20) (the timing row's data) and on the
    bank the caller holds in steady state, the registers after one update
    of the same traffic."""
    times = {}
    # and p = 16 banks between the callers' 1-6.5 MiB and the tick's 64 MiB,
    # where the rule's bank-size limit falls, and the tick's bank at a
    # quarter of its entries
    sweep = {f"{b_rows * 64 // 1024} MiB": (b_rows, 16, n, 0.0) for b_rows in (rows // 4, rows // 2, 3 * rows // 4)}
    sweep["bank tick, a quarter of the entries"] = (rows, 16, n // 4, 0.0)
    for name, (b_rows, p, length, dropped) in {**bank_callers(rows, n), **sweep}.items():
        cfg = HLLConfig(p=p, hash_bits=64)
        streams = []
        for _ in range(4):
            keys, items = _zipf_keyed(b_rows, length, rng)
            keys[rng.random(length) < dropped] = -1
            idx, rank = hash_rank(_items_tensor(items.view(np.uint32), device), cfg)
            streams.append((torch.from_numpy(keys).to(device), idx, rank))
        preset = torch.from_numpy(rng.integers(0, 20, (b_rows, cfg.m), dtype=np.uint8)).to(device)
        steady = bank_scatter_max_plain(torch.zeros_like(preset), *streams[0])
        chosen = bank_module.bank_scatter_path(b_rows, cfg.m, length, _sms(device))
        for state, bank in (("preset", preset), ("steady", steady)):
            for path in ("global", "tiled"):
                fn = getattr(bank_module, f"bank_scatter_max_{path}")
                times[f"bank_scatter_max {path} path, {name} ({b_rows}, {cfg.m}) n={length}, {state} bank"
                      f"{' (chosen)' if path == chosen else ''}"] = _time_ms(lambda *a: fn(bank, *a), streams)[0]
        del preset, steady, streams
    return times


def _device_entries(averages) -> list:
    """The card's own entries of a profiler's ``key_averages()``: kernels,
    copies and fills.  An aten op reports the device time of the kernels it
    launched as its own self time too, so a sum over every entry counts each
    such kernel twice (and gave idle shares below 0); so does every range
    on the card's timeline that only spans other work: the step annotation
    of a profiler schedule (``ProfilerStep*``) and each ``record_function``
    range, such as the port's spans and seams while the profiler records
    (``is_user_annotation``)."""
    from torch.autograd import DeviceType

    return [e for e in averages if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep") and not getattr(e, "is_user_annotation", False)]


def phase_profile(device, steps: int = 4, n: int = 1 << 22, rows: int = BANK_ROWS,
                  hybrid_rows: int = HYBRID_ROWS, window: int = WINDOW, requests: int = SERVE_REQUESTS,
                  prompt_len: int = SERVE_PROMPT, only=None) -> dict:
    """Where the main path's time goes: torch.profiler over a few steps.

    One step is one ``HyperLogLog.update`` of an n-item chunk under "cuda"
    (p = 16, H = 64), one ``SketchBank.update_many`` tick of n Zipf-keyed
    items, one hybrid tick (``HybridBank.update_many`` of a quarter of the
    bench_sparse stream and the read that settles it, on a bank already
    holding the other three quarters) or one full-window read
    (``estimate_window()`` of a fresh instance of the W = 64 ring: the
    three-fragment merge and the estimator), one count-min tick
    (``CountMinBank.update_many`` of n Zipf-keyed items into the (1024, 4,
    1024) bank), its Topkapi label vote alone, its ``cm_scatter_add`` alone
    (the tiled kernel's passes), the bank tick's ``bank_scatter_max`` alone,
    one full-window
    ``fold_window()`` of the 3 GiB (64, 1024, 4, 1024) count-min ring, one
    full-width RWKV6-3B ``engine.prefill`` of 8 x 1024 tokens, or one
    ``engine.decode_step`` of the 8 requests after it, the same two for
    TinyLlama-1.1B, olmoe-1b-7b (moe_*) and recurrentgemma-9b (hybrid_*),
    the bank tick over PLACEMENT_SHARDS row blocks, or one ``train_step``
    at full width of TinyLlama-1.1B (8 x 1024 tokens) or RWKV6-3B (4 x
    1024 in 2 micro-batches) with AdamW and the tap (these two only when
    ``only`` names them: PROFILE_ON_REQUEST);
    ``only`` (step names) profiles those alone.
    Prints the wall time per step (without the profiler), the
    card's busy time per step (the sum of its kernel and copy times, from
    the profiler, which records ``steps`` steps after one warm-up step: the
    first step of a session lost some of its kernels; a recording whose
    counts are not whole steps is made again, up to PROFILE_ATTEMPTS times)
    and the idle share, and the top device entries by self time.  Informational: an empty device
    trace is reported, not raised.
    """
    import gc

    rng = np.random.default_rng(SEED + 3)
    cfg = HLLConfig(p=16, hash_bits=64)
    plan = ExecutionPlan(backend="cuda")
    chunk = _items_tensor(rng.integers(0, 2**32, n, dtype=np.uint32), device)
    keys, items = _zipf_keyed(rows, n, rng)
    k_t, x_t = torch.from_numpy(keys).to(device), torch.from_numpy(items).to(device)
    # the carriers are functional, so every step redoes one update of the
    # same filled state
    sk = HyperLogLog.empty(cfg, device).update(chunk, plan)
    bank = SketchBank.empty(rows, cfg, device).update_many(k_t, x_t, plan)
    b_idx, b_rank = hash_rank(x_t, cfg)
    sharded_plan = plan.with_sharding(next(iter(_placement_meshes(device, PLACEMENT_SHARDS).values())))
    hcfg = HLLConfig(p=12, hash_bits=64)
    hkeys, hitems = _zipf_traffic(hybrid_rows, HYBRID_ITEMS_PER_ROW * hybrid_rows, rng)
    hk = torch.from_numpy(hkeys).to(device).tensor_split(HYBRID_CHUNKS)
    hx = torch.from_numpy(hitems).to(device).tensor_split(HYBRID_CHUNKS)

    def wanted(step: str) -> bool:
        return step in only if only is not None else step not in PROFILE_ON_REQUEST

    # the states that take long to fill are filled only where profiled (the
    # data of the others does not change)
    hyb = HybridBank.empty(hybrid_rows, hcfg, device=device)
    for k, x in zip(hk[:-1], hx[:-1]) if wanted("hybrid") else ():
        hyb = hyb.update_many(k, x, plan).compact()
    ring = WindowedBank.empty(window, rows, hcfg, device)
    if wanted("window_read"):
        for epoch in range(window + 1):
            ring = ring.observe(*_zipf_epoch(rows, WINDOW_EPOCH_ITEMS, rng, device), plan).advance()
        ring.estimate_window(plan=plan)  # builds the decomposition the reads thread
    cmc = CMConfig(CM_DEPTH, CM_WIDTH, seed=0)
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    ck, cx = _cm_traffic(rows, n, CM_ITEM_IDS, gen)
    cm_bank = CountMinBank.empty(rows, cmc, device).update_many(ck, cx, plan)
    cm_ring = WindowedCountMinBank.empty(window, rows, cmc, device)
    for epoch in range(window + 1) if wanted("cm_window_read") else ():
        k, x = _cm_traffic(rows, WINDOW_EPOCH_ITEMS, CM_ITEM_IDS, gen)
        cm_ring = cm_ring.observe(k, x, plan).advance()
    steps_fn = {
        "stream": lambda: sk.update(chunk, plan),
        "bank": lambda: bank.update_many(k_t, x_t, plan),
        # the same tick over PLACEMENT_SHARDS row blocks of the one card
        "bank_sharded": lambda: bank.update_many(k_t, x_t, sharded_plan),
        # the bank tick's kernel alone (the tiled kernel's passes)
        "bank_scatter_max": lambda: bank_scatter_max(bank.registers, k_t, b_idx, b_rank),
        "hybrid": lambda: hyb.update_many(hk[-1], hx[-1], plan).compact(),
        # advance_to(current epoch) is a new instance with the decomposition
        # threaded and an empty fold cache: the steady full-window read
        "window_read": lambda: ring.advance_to(ring.epoch).estimate_window(plan=plan),
        # one count-min tick (counters + the Topkapi vote), and the vote alone
        "cm_tick": lambda: cm_bank.update_many(ck, cx, plan),
        "cm_label_vote": lambda: _label_update(cm_bank.labels, cm_bank.label_counts, ck, cx, cmc),
        "cm_scatter_add": lambda: cm_scatter_add(cm_bank.counters, ck, cx, cmc),
        # a full-window read of the 3 GiB ring: the counter fold kernel and
        # the W - 1 pairwise label merges
        "cm_window_read": lambda: cm_ring.fold_window(plan=plan),
    }
    # the serve paths at full width: each model is drawn when its steps are
    # profiled and freed after them, so that one model is on the card at a time
    model_steps = {("serve_prefill", "serve_decode"): (SERVE_ARCH, SEED + 11),
                   ("attn_prefill", "attn_decode"): (ATTN_ARCH, SEED + 12),
                   ("moe_prefill", "moe_decode"): ("olmoe-1b-7b", SEED + 13),
                   ("hybrid_prefill", "hybrid_decode"): ("recurrentgemma-9b", SEED + 14)}

    # a train step at full width (the train phase's batches), one state at a time
    train_steps = {"train_attn": (ATTN_ARCH, 8, 1024, 1, SEED + 15), "train_rwkv": (SERVE_ARCH, 4, 1024, 2, SEED + 16)}

    def train_step_of(arch_id: str, batch: int, seq: int, accum: int, seed: int):
        from repro_torch.data.pipeline import DataConfig, batch_at_step
        from repro_torch.train import step as train_step

        arch = get_arch(arch_id)
        cfg = train_step.TrainConfig(sketch=HLLConfig(p=TRAIN_SKETCH_P, hash_bits=64), grad_accum=accum)
        state = train_step.init_train_state(torch.Generator(device=device).manual_seed(seed), arch, cfg, device)
        data = batch_at_step(DataConfig(arch.vocab_size, batch, seq), 0, device)
        return lambda: train_step.train_step(state, data, arch, cfg)

    def serve_steps(arch_id: str, seed: int) -> tuple:
        arch = get_arch(arch_id)
        gen = torch.Generator(device=device).manual_seed(seed)
        model = transformer.init_params(arch, gen, device)
        batch = {"tokens": torch.randint(0, arch.vocab_size, (requests, prompt_len), generator=gen,
                                         device=device, dtype=torch.int32)}
        _, cache = engine.prefill(model, batch, arch, prompt_len + 2)
        last = batch["tokens"][:, -1]
        return (lambda: engine.prefill(model, batch, arch, prompt_len + 2),
                lambda: engine.decode_step(model, cache, last, prompt_len, arch))

    result = {}
    for name, step in steps_fn.items():
        if wanted(name):
            result[name] = _profile_step(name, step, steps)
    for names, (arch_id, seed) in model_steps.items():
        if any(wanted(name) for name in names):
            for name, step in zip(names, serve_steps(arch_id, seed)):
                if wanted(name):
                    result[name] = _profile_step(name, step, steps)
            del step  # the last reference to the model
            gc.collect()
            torch.cuda.empty_cache()
    for name, args in train_steps.items():
        if wanted(name):
            step = train_step_of(*args)
            result[name] = _profile_step(name, step, steps)
            del step  # the last reference to the state
            gc.collect()
            torch.cuda.empty_cache()
    return result


def _profile_step(name: str, step, steps: int) -> dict:
    """Wall (without the profiler) and card busy time per call of ``step``,
    idle share and top device entries (see phase_profile)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    # wall time without the profiler, whose own host cost would add idle
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        # one warm-up step, then `steps` recorded; the card finishes the
        # warm-up step before the recording starts (the profiler records
        # by the card's clock, so a device-bound step's queued kernels
        # would count) and the recorded ones before it stops
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps, repeat=1)) as prof:
            for i in range(steps + 1):
                step()
                if i in (0, steps):
                    torch.cuda.synchronize()
                prof.step()
        rows_ = _device_entries(prof.key_averages())
        # every step launches the same kernels, so a count that is not a
        # whole number of steps means the profiler lost records (seen
        # now and then on the card, in the full phase only): record again
        whole = all(e.count % steps == 0 for e in rows_)
        if whole:
            break
    busy_ms = sum(e.self_device_time_total for e in rows_) / 1e3 / steps
    result = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
              "recordings": attempt, "whole_steps": whole}
    intra = [e for e in rows_ if "rwkv_intra" in e.key]
    if intra:
        result["rwkv_intra_ms"] = sum(e.self_device_time_total for e in intra) / 1e3 / steps
    print(f"[profile] {name} step: {json.dumps(result)}")
    for e in sorted(rows_, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile] {name}:   {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
              f"x{e.count / steps:g}  {e.key[:90]}")
    return result


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def _timed(phase, *args, **kwargs):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    print(f"[wall] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def _names(text: str) -> list:
    return [name for name in text.split(",") if name]


def main() -> int:
    parser = argparse.ArgumentParser(description="Drive the port's main paths on one NVIDIA card.")
    parser.add_argument("--src", help="import the port from this src/ directory")
    parser.add_argument("--time", type=_names, help="time these kernels alone (names, comma-separated)")
    parser.add_argument("--profile", type=_names, help="profile these steps alone (names, comma-separated)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    device = torch.device("cuda")
    if args.time is not None or args.profile is not None:
        import repro_torch

        print(f"[env] {nvidia_smi()}, torch {torch.__version__}, port from {Path(repro_torch.__file__).parent}")
        if args.time:
            _timed(phase_timing, device, only=args.time)
        if args.profile:
            _timed(phase_profile, device, only=args.profile)
        return 0
    # float32 products in full float32 (PyTorch's default, stated): the
    # plain intra form and the inter-chunk einsums
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    _timed(phase_build)
    errs = _timed(phase_kernels, device)
    # the main paths' shapes take the redesigned kernels: the tiled count-min
    # path (a tick, a ring epoch), two register files an SM, the tiled bank
    # path at the bank tick
    cmc = CMConfig(CM_DEPTH, CM_WIDTH)
    paths = {"countmin tick": _cm_path(CM_ROWS, cmc, CM_TICK_ITEMS, device),
             "cm_window epoch": _cm_path(CM_ROWS, cmc, WINDOW_EPOCH_ITEMS, device)}
    files = {"stream chunk": hll_module.hll_partials(STREAM_CHUNK_ITEMS, 16, _sms(device)),
             "pipelined chunk": hll_module.hll_partials(STREAM_CHUNK_ITEMS // PIPELINES, 16, _sms(device))}
    bank_paths = {name: bank_module.bank_scatter_path(b_rows, 1 << p, length, _sms(device))
                  for name, (b_rows, p, length, _) in bank_callers().items()}
    print(f"[main path] cm_scatter_add paths {paths}; hll_update_fused register files at p = 16 {files}; "
          f"bank_scatter_max paths {bank_paths}")
    if set(paths.values()) != {"tiled"}:
        raise AssertionError(f"the count-min main path does not take the tiled cm_scatter_add: {paths}")
    if bank_paths["bank tick"] != "tiled":
        raise AssertionError(f"the bank tick does not take the tiled bank_scatter_max: {bank_paths}")

    reset_launches()
    stream = _timed(phase_stream, device)
    bank = _timed(phase_bank, device)
    hybrid = _timed(phase_hybrid, device)
    window = _timed(phase_window, device)
    countmin = _timed(phase_countmin, device)
    cm_window = _timed(phase_cm_window, device)
    board = _timed(phase_board, device)
    launches = launch_counts()
    print(f"[main path] sketch paths' launches {launches}")
    missing = [name for name, count in launches.items()
               if count == 0 and name not in SERVE_KERNELS + TRAIN_ONLY_KERNELS]
    if missing:
        raise AssertionError(f"kernels never launched on the sketch paths: {missing}")

    reset_launches()
    serve = _timed(phase_serve, device)
    serve_launches = launch_counts()
    print(f"[main path] serve path's launches {serve_launches}")
    missing = [name for name in SERVE_KERNELS if serve_launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serve path: {missing}")
    if serve["intra_launches_per_prefill"] != serve["layers"]:
        raise AssertionError(f"rwkv_intra launched {serve['intra_launches_per_prefill']} times a prefill, "
                             f"not once per layer ({serve['layers']})")
    launches.update({name: serve_launches[name] for name in SERVE_KERNELS})
    launch = _timed(phase_launch, device)
    obs = _timed(phase_obs, device)

    reset_launches()
    placement = _timed(phase_placement, device)
    placement_launches = launch_counts()
    print(f"[main path] placement path's launches {placement_launches}")
    missing = [name for name in PLACEMENT_KERNELS if placement_launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the placement path: {missing}")
    attn = _timed(phase_attn_serve, device)  # zeroes and reads the counts around each launcher run
    family = _timed(phase_family_serve, device)  # likewise
    train = _timed(phase_train, device)  # zeroes and reads the counts around each launcher run
    launches.update({name: train["runs"][SERVE_ARCH]["launches"][name] for name in TRAIN_ONLY_KERNELS})
    _timed(phase_sharding, device)
    dry = _timed(phase_dryrun, device)
    roofline = _timed(phase_sketch_roofline, device)
    examples = _timed(phase_examples, device)  # zeroes and reads the counts around each example's run

    timing = _timed(phase_timing, device)
    _timed(phase_profile, device)
    best = max(stream["configs"], key=lambda r: r["items_per_s"]["cuda"])
    print(f"[timing] stream end to end, cuda: {best['items_per_s']['cuda']:.4g} items/s "
          f"at p={best['p']} H={best['hash_bits']}; bank ingest {bank['ingest_items_per_s']:.4g} items/s; "
          f"hybrid ingest {hybrid['ingest_items_per_s']['cuda']:.4g} items/s (compaction included); "
          f"full+quarter window read {window['read_ms']:.4g} ms; "
          f"count-min ingest {countmin['ingest_items_per_s']['cuda']:.4g} items/s (label vote included); "
          f"count-min ring read {cm_window['read_ms']:.4g} ms, observe {cm_window['observe_ms']:.4g} ms; "
          f"board ingest {board['flat']['ingest_items_per_s']['cuda']:.4g} items/s flat, "
          f"{board['windowed']['ingest_items_per_s']['cuda']:.4g} items/s windowed")
    print(f"[timing] serve {serve['arch']} full width, {serve['requests']} x {serve['prompt_len']} prompt: "
          f"prefill {serve['prefill_tokens_per_s']:.6g} tokens/s ({serve['prefill_s'] * 1e3:.6g} ms), "
          f"decode {serve['decode_tokens_per_s']:.6g} tokens/s over {serve['gen_len']} steps; "
          f"rwkv_intra {serve['intra_ms_per_prefill']} ms of it (share {serve['intra_share_of_prefill']}); "
          f"peak device memory {serve['max_memory_allocated']} bytes")
    print(f"[timing] launcher {SERVE_ARCH} full width: prefill {launch['prefill_tokens_per_s']:.6g} tokens/s, "
          f"decode {launch['decode_tokens_per_s']:.6g} tokens/s, peak device memory "
          f"{launch['max_memory_allocated']} bytes; obs over passthrough {obs['over_passthrough']}")
    print(f"[timing] placement, bank tick sharded over {placement['shards']} row blocks / local: ingest "
          f"{placement['bank_ratio_sharded_over_local']['ingest']:.4g}, read "
          f"{placement['bank_ratio_sharded_over_local']['read']:.4g}; block paths "
          f"{placement['bank']['path_per_block']} (local {placement['bank']['path_local']})")
    for name, runs in attn["launcher"].items():
        print(f"[timing] launcher {ATTN_ARCH} full width, --placement {name}, two runs: prefill "
              f"{[r['prefill_tokens_per_s'] for r in runs]} tokens/s, decode "
              f"{[r['decode_tokens_per_s'] for r in runs]} tokens/s, peak device memory "
              f"{[r['max_memory_allocated'] for r in runs]} bytes")
    for arch_id, run in family["launcher"].items():
        print(f"[timing] launcher {arch_id} full width: prefill {run['prefill_tokens_per_s']:.6g} tokens/s, "
              f"decode {run['decode_tokens_per_s']:.6g} tokens/s, peak device memory {run['max_memory_allocated']} "
              f"bytes" + (f"; prefill dropped {run['dropped_choices']} (token, choice) pairs over "
                          f"{run['prefill_route_calls']} layers at capacity {run['capacity']}"
                          if "dropped_choices" in run else ""))
    for row in dry["measured"]:
        print(f"[timing] dry-run {row['arch']} {row['cell']}: predicted peak {row['predicted']} bytes, measured "
              f"{row['measured']} ({row['measured_over_predicted']:.4f} of it), fits one card {row['fits_one_card']}")
    for r in roofline["variants"]:
        print(f"[timing] sketch roofline {r['variant']}: {r['measured_ms']:.6g} ms, {r['roofline_fraction']:.4g} of "
              f"the stream read once ({r['ideal_memory_s'] * 1e3:.4g} ms)")
    for arch_id, run in train["runs"].items():
        print(f"[timing] train {arch_id} full width, {run['global_batch']} x {run['seq_len']} a step "
              f"(grad_accum {run['grad_accum']}): {run['tokens_per_s']:.6g} tokens/s, peak device memory "
              f"{run['max_memory_allocated']} bytes, tap share {run['tap_share']:.4g}, loss {run['loss']}")
    for name, row in examples["stream_cardinality"]["runs"].items():
        print(f"[timing] example stream_cardinality {' '.join(row['flags']) or '(defaults)'}: "
              f"{row['items_per_s']:.6g} items/s, finalization {row['finalize_us']:.6g} us")
    for arch_id, row in examples["serve_lm"].items():
        print(f"[timing] example serve_lm --arch {arch_id}: prefill {row['prefill_tokens_per_s']:.6g} tokens/s, "
              f"decode {row['decode_tokens_per_s']:.6g} tokens/s")
    full = examples["train_lm"]["full"]
    print(f"[timing] example train_lm {' '.join(full['flags'])}: {full['tokens_per_s']:.6g} tokens/s, peak device "
          f"memory {full['max_memory_allocated']} bytes")
    kernels = [
        {
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{kernel.source}.cu",
            "replaces": kernel.replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
            "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
            "library_ms": timing[name]["library_ms"],
        }
        for name, kernel in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
