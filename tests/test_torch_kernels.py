"""Port vs reference: the plain versions of the main path's kernels.

On the CPU each port wrapper runs its plain PyTorch version.  These tests
hold it to the reference's Pallas kernel in interpret mode at p <= 12
(where the TPU kernels' VMEM caps allow them) and to ``repro/kernels/ref.py``
or the reference's jnp path at p = 16:

  bucket_fold       several (k, m), uint8 and int32 partials;
  hll_update_fused  n_valid padding and accumulation onto existing registers;
  bank_scatter_max  foreign keys (-1, B, beyond) and rank-0 padding dropped;
  sparse_scatter_coo  rows -1 and B and rank-0 entries dropped, exact
                    per-row distinct counts;
  window_fold_max   masks all live, a suffix, none live, W = 1;
  window_merge_max  K = 3 fold fragments;
  cm_scatter_add    d in {1, 3, 4, 16}, w up to 2^16, keys -1 and B dropped,
                    counters preset near 2^32 so that adds wrap;
  cm_window_fold_sum  masks all live, a suffix, none live, W = 1, sums that
                    wrap past 2^32;
  rwkv_intra        the reference kernel test's (G, C, N), a short chunk,
                    C = 1, and strong decay, against ``rwkv_intra_ref`` and
                    the Pallas kernel in interpret mode, within rtol 1e-5
                    and atol 1e-4 (float32 sums in another order).

The launch plans of the tiled kernels are pure functions, tested here:
``cm_tile_plan`` / ``cm_scatter_path`` and ``bank_tile_plan`` /
``bank_scatter_path`` (every row in one tile or on the global path, and
the bank's measured path rule at its callers' shapes), the units a tile
is split into (every slice in one unit; ``_unit_split`` here, as the CUDA
plan kernels count them), and ``hll_partials`` (the register files a
stream gets).  Plain-torch emulations of the decompositions -- cm:
partition by tile, 32-bit packing, split tiles' partials summed mod 2^32;
bank: partition by tile, (cell in tile << 8 | rank) packing, split tiles'
partials raised by max; hll: the files each item lands in, their column
max with the input registers -- are held bit for bit to the plain versions
and to the reference.

The ``gpu`` tests hold each CUDA kernel to its plain version on the card,
the tiled kernels also on adversarial streams (the bank's on both paths),
and ``bucket_fold`` on ragged shapes.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import bank_scatter as ref_bank_scatter
from repro.kernels import bucket_fold as ref_bucket_fold
from repro.kernels import hll_fused as ref_hll_fused
from repro.kernels import ref as ref_oracles
from repro.kernels import rwkv_intra as ref_rwkv_intra
from repro.sketch.backends import bank_update_jnp, sparse_merge, sparse_merge_cells
from repro.sketch.backends import window_fold as ref_window_fold
from repro.sketch.backends import window_fold_jnp, window_merge, window_merge_jnp
from repro.sketch.backends import cm_update as ref_cm_update
from repro.sketch.backends import cm_update_jnp, cm_window_fold, cm_window_fold_jnp
from repro.sketch.countmin import CMConfig as RefCMConfig
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch.kernels import bank_scatter, bucket_fold, cm_scatter, hll_fused, rwkv_intra, sparse_scatter
from repro_torch.kernels import launch_counts, window_fold
from repro_torch.sketch import hll
from repro_torch.sketch.countmin import CMConfig
from repro_torch.sketch.hll import HLLConfig

LANES = 128


def _u32(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _t(items_u32):
    return torch.from_numpy(items_u32.view(np.int32).copy())


def _registers(cfg, seed):
    """Existing registers: random valid ranks, a third of them still zero."""
    regs = np.random.default_rng(seed).integers(0, cfg.max_rank + 1, cfg.m).astype(np.uint8)
    regs[: cfg.m // 3] = 0
    return regs


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# ----------------------------------------------------------------------------
# bucket_fold
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("k,p", [(1, 4), (3, 8), (8, 12), (4, 16), (8, 16)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_bucket_fold_matches_reference(k, p, dtype):
    m = 1 << p
    partials = np.random.default_rng(k * p).integers(0, 60, (k, m)).astype(dtype)
    got = bucket_fold.bucket_fold(torch.from_numpy(partials))
    assert got.dtype == torch.from_numpy(partials).dtype and got.shape == (m,)
    if p <= 12:
        want = ref_bucket_fold.bucket_fold(jnp.asarray(partials.astype(np.int32)), interpret=True)
    else:
        want = ref_oracles.bucket_fold_ref(jnp.asarray(partials.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), np.asarray(want))


def test_bucket_fold_validates_shape_and_dtype():
    with pytest.raises(ValueError, match="k >= 1"):
        bucket_fold.bucket_fold(torch.zeros((0, 16), dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8 or int32"):
        bucket_fold.bucket_fold(torch.zeros((2, 16), dtype=torch.int64))
    with pytest.raises(ValueError, match="divisible by 4"):
        bucket_fold.bucket_fold(torch.zeros((2, 18), dtype=torch.uint8))


# ----------------------------------------------------------------------------
# hll_update_fused
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("hash_bits", [32, 64])
@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_hll_update_fused_matches_reference(p, hash_bits):
    cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=5)
    rcfg = RefConfig(p=p, hash_bits=hash_bits, seed=5)
    tile = ref_hll_fused.DEFAULT_BLOCK_ROWS * LANES
    items = _u32(3 * tile, p + hash_bits)  # the tail past n_valid is live data
    n_valid = 2 * tile + 77
    regs = _registers(cfg, p)
    got = hll_fused.hll_update_fused(torch.from_numpy(regs), _t(items), n_valid, cfg)
    if p <= ref_hll_fused.MAX_FUSED_P:
        want = ref_hll_fused.hll_update_fused(
            jnp.asarray(regs.astype(np.int32)).reshape(1, cfg.m),
            jnp.asarray(items).reshape(-1, LANES),
            jnp.full((1, 1), n_valid, jnp.int32),
            rcfg,
            interpret=True,
        ).reshape(cfg.m)
    else:
        want = ref_oracles.hll_update_fused_ref(jnp.asarray(regs), jnp.asarray(items[:n_valid]), rcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.uint8))
    assert got.dtype == hll.REGISTER_DTYPE


def test_hll_update_fused_is_functional_and_masks_everything_past_n_valid():
    cfg = HLLConfig(p=8)
    regs = torch.from_numpy(_registers(cfg, 1))
    before = regs.clone()
    out = hll_fused.hll_update_fused(regs, _t(_u32(500, 2)), 0, cfg)
    torch.testing.assert_close(out, before, rtol=0, atol=0)
    torch.testing.assert_close(regs, before, rtol=0, atol=0)
    with pytest.raises(ValueError, match="uint8"):
        hll_fused.hll_update_fused(regs.to(torch.int32), _t(_u32(5, 2)), None, cfg)


@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_hll_partials_two_files_an_sm_fewer_for_short_streams(p):
    per_file = max(hll_fused.FILE_THREADS, (1 << p) // 16)
    most = hll_fused.FILES_PER_SM * 132
    for n in (1, 127, per_file, per_file + 1, 1 << 19, (1 << 22) + 3):
        files = hll_fused.hll_partials(n, p, 132)
        assert 1 <= files <= most
        assert files == min(most, -(-n // per_file))
    assert hll_fused.hll_partials(1 << 22, 16, 132) == 264  # the main path: two an SM
    assert hll_fused.hll_partials(1 << 19, 16, 132) == 128  # a pipelined chunk (k = 8)
    assert hll_fused.hll_partials(127, p, 132) == 1
    counts = [hll_fused.hll_partials(n, p, 132) for n in range(1, 1 << 16, 997)]
    assert counts == sorted(counts)  # more items, never fewer files


def _hll_files_emulation(registers, items, n, cfg, sms, head):
    """The two-pass kernel in plain torch: which block's file each item
    lands in (``head`` items before the first 16-byte boundary, then one
    16-byte quad a thread, grid-stride, then the last < 4 items), each file
    the max of its items' ranks from zero, then the column max of the files
    and the input registers."""
    files = hll_fused.hll_partials(n, cfg.p, sms)
    threads = hll_fused.FILE_THREADS
    head = min(head, n)
    quads = (n - head) // 4
    i = torch.arange(n)
    gid = torch.where(i < head, i, torch.where(i < head + 4 * quads, ((i - head) // 4) % (files * threads),
                                               i - head - 4 * quads))
    block = gid // threads
    assert int(block.max()) < files
    idx, rank = hll.hash_index_rank(items[:n], cfg)
    out = torch.zeros((files, cfg.m), dtype=torch.int64)
    out.view(-1).scatter_reduce_(0, block * cfg.m + idx.to(torch.int64), rank.to(torch.int64), "amax")
    return torch.maximum(registers.to(torch.int64), out.amax(0)).to(torch.uint8), files


@pytest.mark.parametrize("hash_bits", [32, 64])
@pytest.mark.parametrize("p,n,head,sms", [(4, 1, 0, 132), (4, 127, 3, 132), (8, 5000, 1, 3), (12, 70_001, 2, 5),
                                          (16, 90_003, 3, 7), (16, 1 << 17, 0, 132)])
def test_hll_partial_files_match_plain_and_reference(p, n, head, sms, hash_bits):
    cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=2**64 - 1)
    rcfg = RefConfig(p=p, hash_bits=hash_bits, seed=2**64 - 1)
    values = _u32(n + 9, p * n)
    values[n // 3:: 5] = 0xDEADBEEF  # one hot item
    regs = _registers(cfg, n)
    items = _t(values)
    got, files = _hll_files_emulation(torch.from_numpy(regs), items, n, cfg, sms, head)
    assert files == hll_fused.hll_partials(n, p, sms)
    np.testing.assert_array_equal(got.numpy(), hll_fused.hll_update_fused_plain(torch.from_numpy(regs), items, n,
                                                                                 cfg).numpy())
    if p <= ref_hll_fused.MAX_FUSED_P:
        tile = ref_hll_fused.DEFAULT_BLOCK_ROWS * LANES
        padded = np.zeros(-(-(n + 9) // tile) * tile, np.uint32)
        padded[: n + 9] = values
        want = ref_hll_fused.hll_update_fused(
            jnp.asarray(regs.astype(np.int32)).reshape(1, cfg.m), jnp.asarray(padded).reshape(-1, LANES),
            jnp.full((1, 1), n, jnp.int32), rcfg, interpret=True,
        ).reshape(cfg.m)
    else:
        want = ref_oracles.hll_update_fused_ref(jnp.asarray(regs), jnp.asarray(values[:n]), rcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.uint8))


# ----------------------------------------------------------------------------
# bank_scatter_max
# ----------------------------------------------------------------------------


def _keyed_stream(n, rows, cfg, seed):
    """(keys, idx, rank) int32 with foreign keys and rank-0 padding mixed in."""
    rng = np.random.default_rng(seed)
    items = _u32(n, seed)
    keys = rng.integers(-2, rows + 3, n).astype(np.int32)
    keys[:3] = [-1, rows, rows + 100]
    idx, rank = hll.hash_index_rank(_t(items), cfg)
    rank = rank.numpy().copy()
    rank[rng.random(n) < 0.1] = 0
    return keys, idx.numpy(), rank, items


@pytest.mark.parametrize("hash_bits", [32, 64])
@pytest.mark.parametrize("p,rows,row_block", [(4, 37, 1), (4, 36, 12), (8, 10, 5), (12, 5, 1)])
def test_bank_scatter_max_matches_reference_kernel(p, rows, row_block, hash_bits):
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    tile = ref_bank_scatter.DEFAULT_BLOCK_ROWS * LANES
    keys, idx, rank, _ = _keyed_stream(2 * tile, rows, cfg, p + rows)
    bank = np.stack([_registers(cfg, r) for r in range(rows)])
    got = bank_scatter.bank_scatter_max(
        torch.from_numpy(bank), torch.from_numpy(keys), torch.from_numpy(idx), torch.from_numpy(rank)
    )
    want = ref_bank_scatter.bank_scatter_max(
        jnp.asarray(bank.astype(np.int32)),
        jnp.asarray(keys).reshape(-1, LANES),
        jnp.asarray(idx).reshape(-1, LANES),
        jnp.asarray(rank).reshape(-1, LANES),
        m=cfg.m,
        row_block=row_block,
        interpret=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.uint8))


@pytest.mark.parametrize("hash_bits", [32, 64])
def test_bank_scatter_max_p16_matches_reference_jnp_path(hash_bits):
    cfg = HLLConfig(p=16, hash_bits=hash_bits)
    rows = 3
    keys, _, _, items = _keyed_stream(4096, rows, cfg, 16)
    bank = np.stack([_registers(cfg, r) for r in range(rows)])
    idx, rank = hll.hash_index_rank(_t(items), cfg)
    got = bank_scatter.bank_scatter_max(torch.from_numpy(bank), torch.from_numpy(keys), idx, rank)
    want = bank_update_jnp(
        jnp.asarray(bank), jnp.asarray(keys), jnp.asarray(items), RefConfig(p=16, hash_bits=hash_bits)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bank_scatter_max_drops_foreign_keys_without_trace():
    cfg = HLLConfig(p=6)
    rows = 4
    keys, idx, rank, _ = _keyed_stream(2000, rows, cfg, 9)
    bank = torch.zeros((rows, cfg.m), dtype=torch.uint8)
    got = bank_scatter.bank_scatter_max(bank, *map(torch.from_numpy, (keys, idx, rank)))
    keep = (keys >= 0) & (keys < rows) & (rank > 0)
    only_valid = bank_scatter.bank_scatter_max(
        bank, *(torch.from_numpy(a[keep]) for a in (keys, idx, rank))
    )
    torch.testing.assert_close(got, only_valid, rtol=0, atol=0)
    assert int(bank.sum()) == 0  # functional: the input bank is untouched


@pytest.mark.parametrize("rows", [1, 37, 1023, 1024])
@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_bank_tile_plan_covers_every_row_once(p, rows):
    m = 1 << p
    plan = bank_scatter.bank_tile_plan(rows, m)
    assert not plan.global_path
    # whole rows, the most a power of two of them that fit 2^16 bytes:
    # one row at p = 16, 16 at p = 12, 4096 at p = 4
    per = plan.rows_per_tile
    assert per & (per - 1) == 0 and per * m == bank_scatter.TILE_BYTES
    spans = [plan.rows_of(t) for t in range(plan.tiles)]
    # back to back from row 0 to B: every row in exactly one tile
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(hi - lo == per for lo, hi in spans[:-1])
    assert 0 < spans[-1][1] - spans[-1][0] <= per
    # a packed entry, (cell in tile) << 8 | rank, fits 32 bits (24 in fact)
    assert (per * m - 1) << 8 | 255 < 1 << 24


def test_bank_tile_plan_limits_and_path_rule():
    path = bank_scatter.bank_scatter_path
    # the callers' shapes: SketchBank.update_many's tick takes the tiled
    # path; a WindowedBank epoch, the telemetry board's flush and
    # HybridBank's dense block (1-6.5 MiB banks, L2-resident) the global one
    assert bank_scatter.bank_tile_plan(1024, 1 << 16).tiles == 1024
    assert path(1024, 1 << 16, 1 << 22, 132) == "tiled"
    assert path(1024, 1 << 12, 1 << 20, 132) == "global"
    assert path(256, 1 << 12, 1 << 20, 132) == "global"
    assert path(1638, 1 << 12, 909_312, 132) == "global"
    # the measured limits: a bank of at least 32 MiB fed at least 2^21 entries
    assert path(512, 1 << 16, 1 << 22, 132) == "tiled"
    assert path(511, 1 << 16, 1 << 22, 132) == "global"
    assert path(1024, 1 << 16, 1 << 21, 132) == "tiled"
    assert path(1024, 1 << 16, (1 << 21) - 1, 132) == "global"
    # 2^25 + 5 entries: 2048 slices, still tiled; 2^27: 8192 slices, global
    assert path(1024, 1 << 16, (1 << 25) + 5, 132) == "tiled"
    assert bank_scatter.tiled_fits(1024, 1 << 16, (1 << 25) + 5, 132)
    assert not bank_scatter.tiled_fits(1024, 1 << 16, 1 << 27, 132)
    assert path(1024, 1 << 16, 1 << 27, 132) == "global"
    # the tiled limits: m past a tile, m not a multiple of 16, more tiles
    # than a histogram holds; every bank here is past 32 MiB
    for rows, m in ((256, 1 << 17), (1 << 21, 20), (1 << 16, 1000), ((bank_scatter.HIST_TILES + 1) * 16, 1 << 12)):
        assert bank_scatter.bank_tile_plan(rows, m).global_path
        assert not bank_scatter.tiled_fits(rows, m, 1 << 22, 132)
        assert path(rows, m, 1 << 22, 132) == "global"
    assert not bank_scatter.bank_tile_plan(bank_scatter.HIST_TILES * 16, 1 << 12).global_path
    assert path(bank_scatter.HIST_TILES * 16, 1 << 12, 1 << 22, 132) == "tiled"
    # an offsets scratch past 2^24 entries: 2^14 tiles x 2048 slices
    assert not bank_scatter.tiled_fits(bank_scatter.HIST_TILES, 1 << 16, 1 << 25, 132)
    assert path(bank_scatter.HIST_TILES, 1 << 16, 1 << 25, 132) == "global"
    # small shapes fit the tiled limits (the gpu tests run both paths there)
    assert bank_scatter.tiled_fits(1, 1 << 16, 1, 132) and bank_scatter.tiled_fits(1023, 16, 127, 132)


def _bank_tiled_emulation(registers, keys, idx, rank, sms, unit_items):
    """The tiled kernel's decomposition in plain torch: slices sorted by
    tile, each valid entry packed as (cell in tile) << 8 | rank in 32 bits,
    each tile's units over their groups of slices (the first from the
    tile's registers, stored; the others from zero, raising the stored tile
    by a per-byte max).  Returns (uint8 bank, the units' sizes)."""
    rows, m = registers.shape
    plan = bank_scatter.bank_tile_plan(rows, m)
    assert not plan.global_path
    keys, idx, rank = (t.to(torch.int64) for t in (keys, idx, rank))
    n = keys.numel()
    per, slices = sparse_scatter.stream_split(n, sms)
    valid = (keys >= 0) & (keys < rows) & (idx >= 0) & (idx < m) & (rank >= 1) & (rank <= 255)
    tile = torch.where(valid, keys // plan.rows_per_tile, -1)
    segments = []  # per slice: {tile: its packed entries}
    for s in range(slices):
        part = torch.arange(s * per, min(n, (s + 1) * per))
        part = part[valid[part]]
        part = part[torch.argsort(tile[part], stable=True)]
        cell = (keys[part] - tile[part] * plan.rows_per_tile) * m + idx[part]
        assert not bool((cell >= 1 << 16).any())
        packed = (cell << 8) | rank[part]
        segments.append({int(t): packed[tile[part] == t] for t in tile[part].unique()})
    out = registers.to(torch.int64).clone()
    sizes = []
    for t in range(plan.tiles):
        lo, hi = plan.rows_of(t)
        total = sum(len(seg[t]) for seg in segments if t in seg)
        stored = None
        for j, (s0, s1) in enumerate(_unit_split(total, slices, unit_items)):
            partial = out[lo:hi].reshape(-1).clone() if j == 0 else torch.zeros((hi - lo) * m, dtype=torch.int64)
            size = 0
            for seg in segments[s0:s1]:
                if t in seg:
                    partial.scatter_reduce_(0, seg[t] >> 8, seg[t] & 255, "amax")
                    size += len(seg[t])
            stored = partial if j == 0 else torch.maximum(stored, partial)
            sizes.append(size)
        out[lo:hi] = stored.reshape(hi - lo, m)
    assert sum(sizes) == int(valid.sum())  # every valid entry in exactly one unit
    return out.to(torch.uint8), sizes


@pytest.mark.parametrize("p,rows,n,sms,unit_items", [
    (16, 3, 5000, 2, 64),      # one row a tile, a hot row split into units
    (16, 1, 3000, 4, 100),     # B = 1: one tile
    (12, 37, 4096, 2, 128),    # 16 rows a tile, the last tile ragged
    (8, 300, 6144, 3, 500),    # 256 rows a tile
    (4, 1023, 5120, 2, 200),   # the whole bank in one tile
])
@pytest.mark.parametrize("hash_bits", [32, 64])
def test_bank_tiled_decomposition_matches_plain_and_reference(p, rows, n, sms, unit_items, hash_bits):
    cfg = HLLConfig(p=p, hash_bits=hash_bits)
    keys, idx, rank, items = _keyed_stream(n, rows, cfg, p + rows)
    keys[n // 2:: 3] = rows // 2  # a hot row, so that one tile is split into several units
    if p > 12:  # the jnp oracle hashes the items itself: no rank-0 padding
        idx, rank = (t.numpy() for t in hll.hash_index_rank(_t(items), cfg))
    bank = np.stack([_registers(cfg, r) for r in range(rows)])
    args = [torch.from_numpy(a) for a in (bank, keys, idx, rank)]
    got, sizes = _bank_tiled_emulation(*args, sms, unit_items)
    assert len(sizes) > bank_scatter.bank_tile_plan(rows, cfg.m).tiles  # some tile was split
    np.testing.assert_array_equal(got.numpy(), bank_scatter.bank_scatter_max_plain(*args).numpy())
    if p <= 12:
        # the Pallas kernel in interpret mode, a block of whole rows of at
        # most 4096 cells (its VMEM cap)
        row_block = max(r for r in range(1, rows + 1) if rows % r == 0 and r * cfg.m <= 4096)
        want = ref_bank_scatter.bank_scatter_max(
            jnp.asarray(bank.astype(np.int32)), *(jnp.asarray(a).reshape(-1, LANES) for a in (keys, idx, rank)),
            m=cfg.m, row_block=row_block, interpret=True)
    else:
        want = bank_update_jnp(jnp.asarray(bank), jnp.asarray(keys), jnp.asarray(items),
                               RefConfig(p=p, hash_bits=hash_bits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.uint8))


def test_bank_tiled_decomposition_drops_like_plain():
    # keys -1, B and 2^31 - 1, buckets -1 and m, ranks 0 and 256: no-ops
    rows, m, n = 5, 1 << 12, 4000
    rng = np.random.default_rng(3)
    keys = rng.integers(0, rows, n).astype(np.int32)
    idx = rng.integers(0, m, n).astype(np.int32)
    rank = rng.integers(1, 256, n).astype(np.int32)
    keys[0::8], idx[1::8], rank[2::8] = -1, -1, 0
    keys[3::8], idx[4::8], rank[5::8] = rows, m, 256
    keys[6::8] = 2**31 - 1  # one entry in 8 (the last) lands
    bank = torch.from_numpy(rng.integers(0, 30, (rows, m)).astype(np.uint8))
    args = [bank] + [torch.from_numpy(a) for a in (keys, idx, rank)]
    got, sizes = _bank_tiled_emulation(*args, 2, 64)
    assert sum(sizes) == n // 8
    torch.testing.assert_close(got, bank_scatter.bank_scatter_max_plain(*args), rtol=0, atol=0)
    landed = bank_scatter.bank_scatter_max_plain(bank, *(torch.from_numpy(a[7::8]) for a in (keys, idx, rank)))
    torch.testing.assert_close(got, landed, rtol=0, atol=0)


# ----------------------------------------------------------------------------
# sparse_scatter_coo
# ----------------------------------------------------------------------------


def _triples(n, rows, m, seed):
    """(row, bucket, rank) int32 with rows -1 and B and rank-0 entries mixed in."""
    rng = np.random.default_rng(seed)
    row = rng.integers(-1, rows + 1, n).astype(np.int32)
    row[:2] = [-1, rows][: min(n, 2)]
    bucket = rng.integers(0, m, n).astype(np.int32)
    rank = rng.integers(0, 8, n).astype(np.int32)
    return row, bucket, rank


@pytest.mark.parametrize("p,rows,row_block", [(4, 9, 4), (8, 6, 16), (10, 5, 2)])
@pytest.mark.parametrize("n", [1, 127, 2051])
def test_sparse_scatter_coo_matches_reference_kernel(p, rows, row_block, n):
    cfg = RefConfig(p=p)
    row, bucket, rank = _triples(n, rows, cfg.m, p + n)
    cells, distinct = sparse_scatter.sparse_scatter_coo(*map(torch.from_numpy, (row, bucket, rank)), rows, cfg.m)
    want_cells, want_distinct = sparse_merge(
        jnp.asarray(row), jnp.asarray(bucket), jnp.asarray(rank), rows, cfg, row_block=row_block, interpret=True
    )
    np.testing.assert_array_equal(cells.numpy(), np.asarray(want_cells))
    np.testing.assert_array_equal(distinct.numpy(), np.asarray(want_distinct))
    assert cells.dtype == distinct.dtype == torch.int32


def test_sparse_scatter_coo_p16_matches_reference_jnp_scatter():
    rows, m = 3, 1 << 16
    row, bucket, rank = _triples(5000, rows, m, 16)
    cells, distinct = sparse_scatter.sparse_scatter_coo(*map(torch.from_numpy, (row, bucket, rank)), rows, m)
    want_cells, want_distinct = sparse_merge_cells(
        jnp.asarray(row), jnp.asarray(bucket), jnp.asarray(rank), rows=rows, m=m
    )
    np.testing.assert_array_equal(cells.numpy(), np.asarray(want_cells))
    np.testing.assert_array_equal(distinct.numpy(), np.asarray(want_distinct))
    with pytest.raises(TypeError, match="int32"):
        sparse_scatter.sparse_scatter_coo(torch.zeros(2, dtype=torch.int64), *map(torch.from_numpy, (bucket[:2], rank[:2])), rows, m)


@pytest.mark.parametrize("rows", [1, 3, 16384])
@pytest.mark.parametrize("p", [4, 12, 15, 16])
def test_sparse_scatter_tile_plan_covers_every_cell_once(p, rows):
    m = 1 << p
    plan = sparse_scatter.tile_plan(rows, m)
    spans = [plan.cells(t) for t in range(plan.tiles)]
    # tiles in order, back to back, from cell 0 to rows * m: every cell in exactly one
    assert spans[0][0] == 0 and spans[-1][1] == rows * m
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(0 < hi - lo <= sparse_scatter.TILE_CELLS for lo, hi in spans)
    # every tile but the last is full; the last holds what is left
    full = spans[0][1] - spans[0][0]
    assert all(hi - lo == full for lo, hi in spans[:-1])
    assert spans[-1][1] - spans[-1][0] == rows * m - full * (plan.tiles - 1)
    if m <= sparse_scatter.TILE_CELLS:
        # whole rows: 1024 at p = 4, 4 at p = 12; a row never spans tiles
        assert not plan.spans_rows and plan.rows_per_tile == min(sparse_scatter.TILE_CELLS // m, 1024)
        assert all(lo % m == 0 and hi % m == 0 for lo, hi in spans)
    else:
        # a row spans m / 2^14 tiles: 2 at p = 15, 4 at p = 16
        assert plan.spans_rows and plan.tiles_per_row == m // sparse_scatter.TILE_CELLS
        assert plan.tiles == rows * plan.tiles_per_row
    assert plan.global_path == (plan.tiles > sparse_scatter.HIST_TILES)


def test_sparse_scatter_tile_plan_ragged_and_global_path():
    # m not a power of two: a tile holds floor(2^14 / m) rows, the last tile fewer
    plan = sparse_scatter.tile_plan(10, 5000)
    assert plan.rows_per_tile == 3 and plan.tiles == 4 and plan.cells(3) == (45000, 50000)
    # a row of 20000 cells spans 2 tiles, the second ragged
    plan = sparse_scatter.tile_plan(3, 20000)
    assert plan.tiles_per_row == 2 and plan.cells(1) == (16384, 20000) and plan.cells(2) == (20000, 36384)
    # beyond a shared histogram's tiles: the global path
    assert sparse_scatter.tile_plan(4097, 1 << 16).global_path
    assert not sparse_scatter.tile_plan(4096, 1 << 16).global_path
    # slices of the stream: two an SM at the bench's 3.64 M triples, one for a short stream
    assert sparse_scatter.stream_split(16384 * 222, 132) == (13780, 264)
    assert sparse_scatter.stream_split(127, 132) == (1024, 1)
    per, slices = sparse_scatter.stream_split(1 << 30, 132)
    assert per == sparse_scatter.MAX_SLICE and slices > sparse_scatter.MAX_SLICES  # the global path


# ----------------------------------------------------------------------------
# window_fold_max / window_merge_max
# ----------------------------------------------------------------------------


def _ring(window, rows, m, seed):
    return np.random.default_rng(seed).integers(0, 50, (window, rows, m)).astype(np.uint8)


@pytest.mark.parametrize("window,rows,p", [(1, 3, 8), (5, 4, 8), (8, 3, 10), (4, 2, 12)])
def test_window_fold_max_matches_reference_kernel(window, rows, p):
    ring = _ring(window, rows, 1 << p, window + p)
    masks = [np.ones(window, bool), np.arange(window) >= window // 2, np.zeros(window, bool),
             np.arange(window) % 2 == 1]
    for mask in masks:
        got = window_fold.window_fold_max(torch.from_numpy(ring), torch.from_numpy(mask))
        want = ref_window_fold(jnp.asarray(ring), jnp.asarray(mask), interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.uint8 and got.shape == ring.shape[1:]


def test_window_fold_max_p16_matches_reference_jnp_fold():
    ring = _ring(6, 2, 1 << 16, 1)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    got = window_fold.window_fold_max(torch.from_numpy(ring), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(window_fold_jnp(jnp.asarray(ring), jnp.asarray(mask))))
    with pytest.raises(ValueError, match=r"mask must be \(6,\)"):
        window_fold.window_fold_max(torch.from_numpy(ring), torch.ones(5, dtype=torch.bool))


@pytest.mark.parametrize("rows,p", [(3, 8), (2, 12), (2, 16)])
def test_window_merge_max_matches_reference_kernel(rows, p):
    parts = _ring(3, rows, 1 << p, p)
    got = window_fold.window_merge_max(torch.from_numpy(parts))
    if p <= 12:
        want = window_merge(jnp.asarray(parts), interpret=True)
    else:
        want = window_merge_jnp(jnp.asarray(parts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError, match="uint8"):
        window_fold.window_merge_max(torch.from_numpy(parts).to(torch.int32))


# ----------------------------------------------------------------------------
# cm_scatter_add / cm_window_fold_sum
# ----------------------------------------------------------------------------


def _cm_stream(n, rows, seed):
    """Keys with -1 and B mixed in, Zipf-heavy int32 items with edge values."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1, rows + 1, n).astype(np.int32)
    keys[: min(n, 2)] = [-1, rows][: min(n, 2)]
    items = (rng.zipf(1.2, n) % 1000).astype(np.int32)
    edges = np.array([0, -1, -(2**31), 2**31 - 1], dtype=np.int32)
    items[: min(n, 4)] = edges[: min(n, 4)]
    return keys, items


def _near_wrap(shape, seed):
    """uint32 counters within 64 of 2^32, so that a few adds wrap."""
    return (2**32 - np.random.default_rng(seed).integers(1, 64, shape)).astype(np.uint32)


@pytest.mark.parametrize("depth,width,rows,n", [(1, 1, 5, 127), (4, 64, 6, 1000), (4, 1024, 3, 4099),
                                                (16, 256, 2, 300), (3, 1000, 4, 2000)])
def test_cm_scatter_add_matches_reference_kernel(depth, width, rows, n):
    cfg, rcfg = CMConfig(depth, width, seed=9), RefCMConfig(depth, width, seed=9)
    keys, items = _cm_stream(n, rows, depth * width)
    counters = _near_wrap((rows, depth, width), n)
    got = cm_scatter.cm_scatter_add(
        torch.from_numpy(counters.view(np.int32)), torch.from_numpy(keys), torch.from_numpy(items), cfg
    )
    assert got.dtype == torch.int32 and tuple(got.shape) == counters.shape
    want = ref_cm_update(jnp.asarray(counters), jnp.asarray(keys), jnp.asarray(items), rcfg, interpret=True)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_cm_scatter_add_wide_matches_reference_jnp_path():
    cfg, rcfg = CMConfig(16, 1 << 16, seed=2**64 - 1), RefCMConfig(16, 1 << 16, seed=2**64 - 1)
    keys, items = _cm_stream(5000, 2, 1)
    counters = _near_wrap((2, 16, 1 << 16), 2)
    got = cm_scatter.cm_scatter_add(
        torch.from_numpy(counters.view(np.int32)), torch.from_numpy(keys), torch.from_numpy(items), cfg
    )
    want = cm_update_jnp(jnp.asarray(counters), jnp.asarray(keys), jnp.asarray(items), rcfg)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    with pytest.raises(TypeError, match="int32"):
        cm_scatter.cm_scatter_add(torch.zeros((2, 16, 1 << 16)), torch.from_numpy(keys), torch.from_numpy(items), cfg)
    with pytest.raises(ValueError, match=r"\(B, 4, 1024\)"):
        cm_scatter.cm_scatter_add(torch.zeros((2, 16, 1 << 16), dtype=torch.int32), torch.from_numpy(keys),
                                  torch.from_numpy(items), CMConfig())
    with pytest.raises(ValueError, match="differ in length"):
        cm_scatter.cm_scatter_add(torch.from_numpy(counters.view(np.int32)), torch.from_numpy(keys[:5]),
                                  torch.from_numpy(items), cfg)


@pytest.mark.parametrize("window,rows,depth,width", [(1, 3, 2, 64), (5, 4, 4, 64), (8, 3, 1, 1000), (4, 2, 4, 1024)])
def test_cm_window_fold_sum_matches_reference_kernel(window, rows, depth, width):
    ring = _near_wrap((window, rows, depth, width), window + width)
    masks = [np.ones(window, bool), np.arange(window) >= window // 2, np.zeros(window, bool),
             np.arange(window) % 2 == 1]
    for mask in masks:
        got = cm_scatter.cm_window_fold_sum(torch.from_numpy(ring.view(np.int32)), torch.from_numpy(mask))
        assert got.dtype == torch.int32 and tuple(got.shape) == ring.shape[1:]
        want = cm_window_fold(jnp.asarray(ring), jnp.asarray(mask), interpret=True)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_cm_window_fold_sum_wide_matches_reference_jnp_fold():
    ring = _near_wrap((6, 2, 3, 1 << 14), 3)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    got = cm_scatter.cm_window_fold_sum(torch.from_numpy(ring.view(np.int32)), torch.from_numpy(mask))
    want = cm_window_fold_jnp(jnp.asarray(ring), jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))
    with pytest.raises(ValueError, match=r"mask must be \(6,\)"):
        cm_scatter.cm_window_fold_sum(torch.from_numpy(ring.view(np.int32)), torch.ones(5, dtype=torch.bool))
    with pytest.raises(TypeError, match="int32"):
        cm_scatter.cm_window_fold_sum(torch.from_numpy(ring.astype(np.int64)), torch.from_numpy(mask))


# the tiled cm_scatter_add: its plan, and a plain-torch emulation of its
# decomposition (partition by tile, units over groups of slices, partials
# summed mod 2^32)
CM_PLAN_CONFIGS = [(d, w) for d in (1, 4, 16) for w in (1, 1000, 1024, 1 << 16)]  # chip_smoke's kernels phase


def _unit_split(total, slices, unit_items=cm_scatter.UNIT_ITEMS):
    """The work units of a tile with ``total`` items over ``slices`` slices,
    as the plan kernels of cm_scatter.cu and bank_scatter.cu count them
    (common.cuh's ``unit_count``): ceil(total / unit_items), at least 1, at
    most one a slice; unit j takes the slices [j * slices // u,
    (j + 1) * slices // u)."""
    units = min(slices, max(1, -(-total // unit_items)))
    return [(j * slices // units, (j + 1) * slices // units) for j in range(units)]


@pytest.mark.parametrize("rows", [1, 3, 1024])
@pytest.mark.parametrize("depth,width", CM_PLAN_CONFIGS)
def test_cm_tile_plan_covers_every_row_once(depth, width, rows):
    cfg = CMConfig(depth, width)
    plan = cm_scatter.cm_tile_plan(rows, cfg)
    assert plan.cells == depth * width
    assert plan.log2_width == (width.bit_length() - 1 if width & (width - 1) == 0 else -1)
    if depth * width > cm_scatter.TILE_CELLS:
        # a row larger than a tile: the global path (w = 2^16)
        assert plan.global_path and width == 1 << 16
        return
    assert not plan.global_path
    # whole rows, the most a power of two of them that fit 2^14 counters:
    # 4 at CMConfig(4, 1024), 16 at (1, 1000), 4 at (4, 1000), 16384 at (1, 1)
    per = plan.rows_per_tile
    assert per & (per - 1) == 0 and per * plan.cells <= cm_scatter.TILE_CELLS < 2 * per * plan.cells
    spans = [plan.rows_of(t) for t in range(plan.tiles)]
    # back to back from row 0 to B: every row in exactly one tile
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # every tile but the last is full; the last holds what is left
    assert all(hi - lo == plan.rows_per_tile for lo, hi in spans[:-1])
    assert 0 < spans[-1][1] - spans[-1][0] <= plan.rows_per_tile
    # a narrow item, (row in tile, h.hi mod w, h.lo mod w), fits 32 bits
    if plan.log2_width >= 0:
        assert (plan.rows_per_tile - 1).bit_length() + 2 * plan.log2_width <= 32


def test_cm_tile_plan_main_shape_and_global_paths():
    plan = cm_scatter.cm_tile_plan(1024, CMConfig(4, 1024))
    assert (plan.rows_per_tile, plan.tiles, plan.log2_width, plan.global_path) == (4, 256, 10, False)
    assert cm_scatter.cm_scatter_path(1024, CMConfig(4, 1024), 1 << 22, 132) == "tiled"
    # a row past 2^14 counters, more tiles than a shared histogram, more
    # slices than a tile block gathers from: the global path
    assert cm_scatter.cm_scatter_path(1024, CMConfig(1, 1 << 16), 1 << 22, 132) == "global"
    assert cm_scatter.cm_scatter_path(4, CMConfig(2, 1 << 13), 10, 132) == "tiled"
    assert cm_scatter.cm_scatter_path(4, CMConfig(4, 1 << 13), 10, 132) == "global"
    assert cm_scatter.cm_tile_plan(1 << 16, CMConfig(16, 1024)).global_path  # 2^16 tiles
    assert not cm_scatter.cm_tile_plan(1 << 14, CMConfig(16, 1024)).global_path
    assert cm_scatter.cm_scatter_path(1024, CMConfig(4, 1024), 1 << 27, 132) == "global"  # 8192 slices
    assert cm_scatter.cm_scatter_path(1024, CMConfig(4, 1024), 1 << 25, 132) == "tiled"  # 2048 slices


@pytest.mark.parametrize("total,slices", [(0, 264), (1, 264), (8192, 264), (8193, 264), (1_823_276, 264),
                                          (1 << 22, 264), (50_000, 1), (50_000, 3), (40_000, 7)])
def test_cm_unit_split_covers_every_slice_once(total, slices):
    units = _unit_split(total, slices)
    want = min(slices, max(1, -(-total // cm_scatter.UNIT_ITEMS)))
    assert len(units) == want
    # groups of slices back to back: every slice, so every item of the
    # tile's segment, in exactly one unit; none empty
    assert units[0][0] == 0 and units[-1][1] == slices
    assert all(a[1] == b[0] for a, b in zip(units, units[1:]))
    assert all(hi > lo for lo, hi in units)
    # the hot tile (keys 0-3) of the timing traffic, 2^22 items: 223 units
    if total == 1_823_276:
        assert len(units) == 223


def _cm_tiled_emulation(counters, keys, items, cfg, sms, unit_items):
    """The tiled kernel's decomposition in plain torch, on uint32 values held
    in int64: slices sorted by tile, each tile's units over their groups of
    slices (the first from the tile's counters, the others from zero), the
    partials summed mod 2^32.  Returns (int32 counters, the units' sizes)."""
    from repro_torch.sketch import murmur3, u64

    rows, depth, width = counters.shape
    plan = cm_scatter.cm_tile_plan(rows, cfg)
    assert not plan.global_path
    n = keys.numel()
    per, slices = sparse_scatter.stream_split(n, sms)
    h = murmur3.murmur3_64(items, cfg.seed)
    lo, hi = h & u64.MASK32, u64.shr(h, 32)
    valid = (keys >= 0) & (keys < rows)
    tile = torch.where(valid, keys // plan.rows_per_tile, -1).to(torch.int64)
    # partition: each slice's valid items sorted by tile, stored packed
    segments = []  # per slice: {tile: (row in tile, lo, hi) of its items}
    for s in range(slices):
        part = torch.arange(s * per, min(n, (s + 1) * per))
        part = part[valid[part]]
        part = part[torch.argsort(tile[part], stable=True)]
        row = keys[part].to(torch.int64) - tile[part] * plan.rows_per_tile
        if plan.log2_width >= 0:
            k, low = plan.log2_width, width - 1
            packed = (row << (2 * k)) | ((hi[part] & low) << k) | (lo[part] & low)
            assert not bool((packed >= 1 << 32).any())
            fields = (packed >> (2 * k), packed & low, (packed >> k) & low)
        else:
            fields = (row, lo[part], hi[part])
        segments.append({int(t): tuple(f[tile[part] == t] for f in fields) for t in tile[part].unique()})
    out = counters.reshape(rows, -1).to(torch.int64) & u64.MASK32
    sizes = []
    r = torch.arange(depth, dtype=torch.int64)[:, None]
    for t in range(plan.tiles):
        first, last = plan.rows_of(t)
        total = sum(len(seg[t][0]) for seg in segments if t in seg)
        partials = []
        for j, (s0, s1) in enumerate(_unit_split(total, slices, unit_items)):
            partial = out[first:last].clone() if j == 0 else torch.zeros_like(out[first:last])
            size = 0
            for seg in segments[s0:s1]:
                if t not in seg:
                    continue
                row, lo_t, hi_t = seg[t]
                mixed = (lo_t[None, :] + r * hi_t[None, :]) & u64.MASK32
                col = mixed & (width - 1) if plan.log2_width >= 0 else mixed % width
                flat = (row[None, :] * depth * width + r * width + col).reshape(-1)
                partial.view(-1).index_add_(0, flat, torch.ones_like(flat))
                size += len(row)
            partials.append(partial)
            sizes.append(size)
        out[first:last] = sum(partials) & u64.MASK32
    assert sum(sizes) == int(valid.sum())  # every valid item in exactly one unit
    return (out - ((out >> 31) << 32)).to(torch.int32).reshape(rows, depth, width), sizes


@pytest.mark.parametrize("depth,width,rows,n,sms,unit_items", [
    (4, 1024, 9, 5000, 2, 64),     # the main config, narrow packing, 3 tiles, split tiles
    (4, 1024, 1, 3000, 4, 100),    # B = 1: one tile
    (3, 1000, 11, 4099, 2, 128),   # w not a power of two: 64-bit items hashed again
    (1, 1, 5, 2000, 3, 50),        # one counter a row, 16384 rows a tile
    (16, 1024, 3, 2500, 1, 300),   # a row fills a tile
    (2, 64, 130, 6000, 3, 500),    # 128 rows a tile: the last tile ragged
    (3, 1000, 9, 3000, 2, 200),    # 16384 // 3000 = 5 rows fit, a tile holds 4
])
def test_cm_tiled_decomposition_matches_plain_and_reference(depth, width, rows, n, sms, unit_items):
    cfg, rcfg = CMConfig(depth, width, seed=2**64 - 1), RefCMConfig(depth, width, seed=2**64 - 1)
    keys, items = _cm_stream(n, rows, depth + width)
    # a hot (key, item) pair, so that one tile is split into several units
    keys[n // 2:: 3], items[n // 2:: 3] = rows // 2, 12345
    counters = np.full((rows, depth, width), 0xFFFFFFF0, dtype=np.uint32)  # the adds wrap
    counters[0] = _near_wrap((depth, width), n)
    args = (torch.from_numpy(counters.view(np.int32)), torch.from_numpy(keys), torch.from_numpy(items))
    got, sizes = _cm_tiled_emulation(*args, cfg, sms, unit_items)
    assert len(sizes) > cm_scatter.cm_tile_plan(rows, cfg).tiles  # some tile was split
    want = cm_scatter.cm_scatter_add_plain(*args, cfg)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    ref_args = (jnp.asarray(counters), jnp.asarray(keys), jnp.asarray(items), rcfg)
    # the Pallas kernel in interpret mode where its VMEM cap (4096 cells a row) allows it
    ref = ref_cm_update(*ref_args, interpret=True) if depth * width <= 4096 else cm_update_jnp(*ref_args)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(ref))


def test_cm_tiled_decomposition_only_dropped_keys():
    cfg = CMConfig(4, 1024)
    keys = np.where(np.arange(999) % 2 == 0, -1, 7).astype(np.int32)  # -1 and B
    items = np.arange(999, dtype=np.int32)
    counters = torch.full((7, 4, 1024), -16, dtype=torch.int32)
    got, sizes = _cm_tiled_emulation(counters, torch.from_numpy(keys), torch.from_numpy(items), cfg, 2, 64)
    assert sum(sizes) == 0
    torch.testing.assert_close(got, counters, rtol=0, atol=0)
    torch.testing.assert_close(
        cm_scatter.cm_scatter_add_plain(counters, torch.from_numpy(keys), torch.from_numpy(items), cfg), counters,
        rtol=0, atol=0)


# ----------------------------------------------------------------------------
# rwkv_intra
# ----------------------------------------------------------------------------

INTRA_TOL = dict(rtol=1e-5, atol=1e-4)  # tests/test_rwkv_intra_kernel.py's tolerance


def _intra_inputs(g, c, n, seed=0, decay_scale=1.0):
    """tests/test_rwkv_intra_kernel.py's inputs, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (g, c, n)).astype(np.float32) for _ in range(3))
    lw = -rng.uniform(0.01, decay_scale, (g, c, n)).astype(np.float32)
    lcum = np.cumsum(lw, axis=1, dtype=np.float32)
    u = rng.normal(0, 0.3, (g, n)).astype(np.float32)
    return r, k, v, lcum - lw, lcum, u


@pytest.mark.parametrize("g,c,n", [(1, 8, 16), (4, 32, 64), (2, 64, 64), (3, 40, 32), (5, 1, 64)])
def test_rwkv_intra_plain_matches_reference_oracle_and_kernel(g, c, n):
    args = _intra_inputs(g, c, n, seed=g * c)
    got = rwkv_intra.rwkv_intra(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and got.shape == (g, c, n)
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_rwkv_intra.rwkv_intra_ref(*jargs)), **INTRA_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_rwkv_intra.rwkv_intra(*jargs, interpret=True)),
                               **INTRA_TOL)


@pytest.mark.parametrize("g,c,n", [(2, 32, 32), (3, 64, 64)])
def test_rwkv_intra_plain_strong_decay_stable(g, c, n):
    args = _intra_inputs(g, c, n, seed=7, decay_scale=50.0)  # exp(-L) alone overflows here
    got = rwkv_intra.rwkv_intra_plain(*(torch.from_numpy(a) for a in args)).numpy()
    assert np.isfinite(got).all()
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(got, np.asarray(ref_rwkv_intra.rwkv_intra_ref(*jargs)), **INTRA_TOL)
    np.testing.assert_allclose(got, np.asarray(ref_rwkv_intra.rwkv_intra(*jargs, interpret=True)), **INTRA_TOL)


def test_rwkv_intra_plain_blocks_of_cells_change_nothing(monkeypatch):
    args = [torch.from_numpy(a) for a in _intra_inputs(7, 16, 8, seed=3)]
    whole = rwkv_intra.rwkv_intra_plain(*args)
    monkeypatch.setattr(rwkv_intra, "PLAIN_BLOCK_CELLS", 2)
    torch.testing.assert_close(rwkv_intra.rwkv_intra_plain(*args), whole, rtol=0, atol=0)


def _intra_two_level(r, k, v, lex, lcum, u, exponents, sub=8):
    """A float32 emulation of the kernel's two-level chunking.

    Sub-chunks of ``sub`` rows (the kernel's 8); a diagonal sub-block takes the pairwise
    exp(Lex[t] - L[s]); an off-diagonal one (i > j) the three factors
    through e = the last row of sub-chunk j and b = the row before
    sub-chunk i.  Every exponent taken is appended to ``exponents`` as
    (value, Lex side or not).
    """
    g, c, n = r.shape
    a = torch.zeros((g, c, c), dtype=torch.float32)
    for i in range(-(-c // sub)):
        ti = slice(i * sub, min(c, (i + 1) * sub))
        w = ti.stop - ti.start
        lower = torch.tril(torch.ones((w, w), dtype=torch.bool), diagonal=-1)[None, :, :, None]
        x = lex[:, ti, None, :] - lcum[:, None, ti, :]
        exponents.append((x.expand(g, w, w, n)[lower.expand(g, w, w, n)], True))
        pair = torch.where(lower, r[:, ti, None] * k[:, None, ti] * torch.exp(torch.where(lower, x, 0.0)), 0.0)
        a[:, ti, ti] = pair.sum(-1) + torch.diag_embed(torch.einsum("gtn,gn,gtn->gt", r[:, ti], u, k[:, ti]))
        for j in range(i):
            tj = slice(j * sub, (j + 1) * sub)
            b, e = sub * i - 1, sub * j + sub - 1
            xr, xd, xk = lex[:, ti] - lcum[:, b, None], lcum[:, b] - lcum[:, e], lcum[:, e, None] - lcum[:, tj]
            exponents += [(xr, True), (xd, False), (xk, False)]
            rp, kp = r[:, ti] * torch.exp(xr), k[:, tj] * torch.exp(xk)
            a[:, ti, tj] = torch.einsum("gtn,gn,gsn->gts", rp, torch.exp(xd), kp)
    return torch.einsum("gts,gsn->gtn", a, v)


@pytest.mark.parametrize("decay", [1.0, 50.0])
@pytest.mark.parametrize("n", [64, 32])
@pytest.mark.parametrize("c", [64, 40, 17, 1])
def test_rwkv_intra_two_level_chunking_matches_plain_and_reference(c, n, decay):
    np_args = _intra_inputs(3, c, n, seed=c + n, decay_scale=decay)
    args = [torch.from_numpy(a) for a in np_args]
    exponents = []
    got = _intra_two_level(*args, exponents).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, rwkv_intra.rwkv_intra_plain(*args).numpy(), **INTRA_TOL)
    np.testing.assert_allclose(got, np.asarray(ref_rwkv_intra.rwkv_intra_ref(*map(jnp.asarray, np_args))),
                               **INTRA_TOL)
    # L's float cumsum of negative log-decays never increases, so the
    # exponents of L alone are <= 0 exactly; Lex = L - log_w is rounded
    # once and may sit one ulp above L[t-1], so a Lex exponent may too
    ulp = float(np.spacing(np.float32(np.abs(np_args[3]).max())))
    for x, lex_side in exponents:
        assert x.numel() == 0 or float(x.max()) <= (ulp if lex_side else 0.0)


def test_rwkv_intra_two_level_exponents_nonpositive_on_exact_decays():
    # with Lex the exact exclusive sum (L shifted one row) every exponent
    # of the factored form is <= 0, even at decay scale 50
    r, k, v, _, lcum, u = (torch.from_numpy(a) for a in _intra_inputs(4, 64, 64, seed=11, decay_scale=50.0))
    lex = torch.cat([torch.zeros_like(lcum[:, :1]), lcum[:, :-1]], dim=1)
    exponents = []
    got = _intra_two_level(r, k, v, lex, lcum, u, exponents)
    assert all(x.numel() == 0 or float(x.max()) <= 0.0 for x, _ in exponents)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, rwkv_intra.rwkv_intra_plain(r, k, v, lex, lcum, u), **INTRA_TOL)


def test_rwkv_intra_validates_shapes_and_types():
    r, k, v, lex, lcum, u = (torch.from_numpy(a) for a in _intra_inputs(2, 8, 4))
    with pytest.raises(ValueError, match="like r"):
        rwkv_intra.rwkv_intra(r, k[:, :4], v, lex, lcum, u)
    with pytest.raises(ValueError, match="u must be"):
        rwkv_intra.rwkv_intra(r, k, v, lex, lcum, u[:1])
    with pytest.raises(ValueError, match=r"\(G, C, N\)"):
        rwkv_intra.rwkv_intra(r[0], k[0], v[0], lex[0], lcum[0], u[0])
    with pytest.raises(TypeError, match="floating point"):
        rwkv_intra.rwkv_intra(r, k.to(torch.int32), v, lex, lcum, u)
    before = launch_counts()["rwkv_intra"]
    rwkv_intra.rwkv_intra(r, k, v, lex, lcum, u)  # CPU tensors: the plain version, no launch
    assert launch_counts()["rwkv_intra"] == before


# ----------------------------------------------------------------------------
# the CUDA kernels on the card
# ----------------------------------------------------------------------------


@pytest.mark.gpu
def test_hll_update_fused_kernel_matches_plain_on_card():
    _need_card()
    for p, hash_bits in ((4, 32), (12, 64), (14, 64), (16, 32), (16, 64)):
        cfg = HLLConfig(p=p, hash_bits=hash_bits)
        regs = torch.from_numpy(_registers(cfg, p)).cuda()
        x = _t(_u32((1 << 21) + 5, p)).cuda()
        for n_valid in (None, 1000):
            before = launch_counts()["hll_update_fused"]
            got = hll_fused.hll_update_fused(regs, x, n_valid, cfg)
            assert launch_counts()["hll_update_fused"] == before + 1
            want = hll_fused.hll_update_fused_plain(regs, x, n_valid, cfg)
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
def test_bucket_fold_kernel_matches_plain_on_card():
    _need_card()
    rng = np.random.default_rng(0)
    for k, m, dtype in ((8, 1 << 16, np.uint8), (3, 20, np.uint8), (5, 1001, np.int32)):
        partials = torch.from_numpy(rng.integers(0, 60, (k, m)).astype(dtype)).cuda()
        before = launch_counts()["bucket_fold"]
        got = bucket_fold.bucket_fold(partials)
        assert launch_counts()["bucket_fold"] == before + 1
        torch.testing.assert_close(got, bucket_fold.bucket_fold_plain(partials), rtol=0, atol=0)


@pytest.mark.gpu
def test_bucket_fold_ragged_shapes_on_card():
    _need_card()
    rng = np.random.default_rng(1)
    cases = [(k, m, np.uint8) for k in (1, 3, 8, 9) for m in (16, 20, 1 << 14, 1 << 16)] + [(5, 1001, np.int32)]
    for k, m, dtype in cases:
        hi = 62 if dtype == np.uint8 else 2**31 - 1
        partials = torch.from_numpy(rng.integers(-hi if dtype == np.int32 else 0, hi, (k, m)).astype(dtype)).cuda()
        torch.testing.assert_close(bucket_fold.bucket_fold(partials), bucket_fold.bucket_fold_plain(partials),
                                   rtol=0, atol=0, msg=f"({k}, {m}) {dtype}")
    # rows that start 4 bytes past a 16-byte boundary: the 4-byte columns
    flat = torch.from_numpy(rng.integers(0, 62, 10 * (1 << 14)).astype(np.uint8)).cuda()
    view = flat[4: 4 + 9 * (1 << 14)].view(9, 1 << 14)
    assert view.data_ptr() % 16 == 4
    torch.testing.assert_close(bucket_fold.bucket_fold(view), bucket_fold.bucket_fold_plain(view), rtol=0, atol=0)


@pytest.mark.gpu
def test_bank_scatter_max_kernel_matches_plain_on_card():
    _need_card()
    cfg = HLLConfig(p=16, hash_bits=64)
    rows = 64
    keys, idx, rank, _ = _keyed_stream(1 << 20, rows, cfg, 3)
    bank = torch.from_numpy(np.stack([_registers(cfg, r) for r in range(rows)])).cuda()
    args = [torch.from_numpy(a).cuda() for a in (keys, idx, rank)]
    before = launch_counts()["bank_scatter_max"]
    got = bank_scatter.bank_scatter_max(bank, *args)
    assert launch_counts()["bank_scatter_max"] == before + 1
    torch.testing.assert_close(got, bank_scatter.bank_scatter_max_plain(bank, *args), rtol=0, atol=0)


def _bank_adversarial(n, seed):
    """bank_scatter_max's hard streams, {name: (rows, m, keys, idx, rank)}."""
    rng = np.random.default_rng(seed)
    m = 1 << 16
    keys = rng.integers(0, 1024, n).astype(np.int32)
    idx = rng.integers(0, m, n).astype(np.int32)
    rank = rng.integers(1, 40, n).astype(np.int32)
    dropped_keys = keys.copy()
    dropped_keys[0::4], dropped_keys[1::4], dropped_keys[2::4] = -1, 1024, 2**31 - 1
    dropped_idx = idx.copy()
    dropped_idx[0::3], dropped_idx[1::3] = -1, m
    dropped_rank = rank.copy()
    dropped_rank[0::3], dropped_rank[1::3] = 0, 256
    return {
        # every entry on one key (one tile split into ~n / 8192 units), and
        # on one cell
        "one key": (1024, m, np.zeros(n, np.int32), idx, rank),
        "one cell": (1024, m, np.full(n, 517, np.int32), np.full(n, m - 1, np.int32), rank),
        "B=1": (1, m, np.where(keys % 5 == 0, 1, 0).astype(np.int32), idx, rank),  # key 1 dropped
        "B=1023": (1023, m, keys, idx, rank),  # key 1023 dropped
        "p=4": (1024, 16, keys, idx % 16, rank),  # the whole bank in one tile
        "dropped keys": (1024, m, dropped_keys, idx, rank),
        "dropped buckets": (1024, m, keys, dropped_idx, rank),
        "dropped ranks": (1024, m, keys, idx, dropped_rank),
        "p=12": (1024, 1 << 12, keys, idx % (1 << 12), rank),
    }


@pytest.mark.gpu
def test_bank_scatter_max_adversarial_streams_on_card():
    _need_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = (1 << 22) + 3
    cases = _bank_adversarial(n, 13)
    short = cases["B=1023"]
    for length in (0, 1, 127):
        cases[f"n={length}"] = (short[0], short[1], *(a[:length] for a in short[2:]))
    many = (1 << 25) + 5  # 2048 slices
    rng = np.random.default_rng(14)
    cases["many slices"] = (1024, 1 << 16, ((rng.zipf(1.2, many) - 1) % 1024).astype(np.int32),
                            rng.integers(0, 1 << 16, many).astype(np.int32), rng.integers(1, 30, many).astype(np.int32))
    # plans past the tiled limits: m past a tile, m not a multiple of 16
    cases["m=2^17"] = (8, 1 << 17, short[2] % 9, short[3] * 2, short[4])  # key 8 dropped
    cases["m=20"] = (64, 20, short[2] % 65, short[3] % 21, short[4])
    gen = np.random.default_rng(15)
    for name, (rows, m, keys, idx, rank) in cases.items():
        bank = torch.from_numpy(gen.integers(0, 20, (rows, m)).astype(np.uint8)).cuda()
        before = bank.clone()
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (keys, idx, rank)]
        want = bank_scatter.bank_scatter_max_plain(bank, *args)
        fits = bank_scatter.tiled_fits(rows, m, len(keys), sms)
        assert fits == (not name.startswith("m=")), name
        if not fits:
            assert bank_scatter.bank_scatter_path(rows, m, len(keys), sms) == "global", name
        count = launch_counts()["bank_scatter_max"]
        torch.testing.assert_close(bank_scatter.bank_scatter_max(bank, *args), want, rtol=0, atol=0, msg=name)
        assert launch_counts()["bank_scatter_max"] == count + (len(keys) > 0), name
        # both paths, where the tiled one's limits allow it
        torch.testing.assert_close(bank_scatter.bank_scatter_max_global(bank, *args), want, rtol=0, atol=0, msg=name)
        if fits:
            torch.testing.assert_close(bank_scatter.bank_scatter_max_tiled(bank, *args), want, rtol=0, atol=0,
                                       msg=name)
        else:
            with pytest.raises(ValueError, match="limits"):
                bank_scatter.bank_scatter_max_tiled(bank, *args)
        torch.testing.assert_close(bank, before, rtol=0, atol=0, msg=name)  # the input bank is never written


@pytest.mark.gpu
def test_sparse_scatter_coo_kernel_matches_plain_on_card():
    _need_card()
    for p, rows, n in ((4, 37, 127), (12, 2048, 1 << 20), (16, 17, (1 << 20) + 3)):
        args = [torch.from_numpy(a).cuda() for a in _triples(n, rows, 1 << p, p)]
        before = launch_counts()["sparse_scatter_coo"]
        got = sparse_scatter.sparse_scatter_coo(*args, rows, 1 << p)
        assert launch_counts()["sparse_scatter_coo"] == before + 1
        want = sparse_scatter.sparse_scatter_coo_plain(*args, rows, 1 << p)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def _adversarial_triples(n, rows, m, seed):
    """The tiled kernel's hard streams, {name: (row, bucket, rank, rows, m)}."""
    rng = np.random.default_rng(seed)
    cases = {}
    # every triple on one cell
    cases["one cell"] = (np.full(n, rows // 2, np.int32), np.full(n, m - 1, np.int32),
                         rng.integers(1, 60, n).astype(np.int32), rows, m)
    # one row at p = 16: four tiles of one row, counts added across them
    cases["one row p=16"] = (np.zeros(n, np.int32), rng.integers(0, 1 << 16, n).astype(np.int32),
                             rng.integers(0, 60, n).astype(np.int32), 1, 1 << 16)
    # only dropped entries: rows -1 and B, buckets -1 and m, rank 0 and negative
    drop = rng.integers(0, 4, n)
    cases["all dropped"] = (np.where(drop == 0, -1, np.where(drop == 1, rows, 0)).astype(np.int32),
                            np.where(drop == 2, m, np.where(drop == 3, -1, 0)).astype(np.int32),
                            np.where(drop < 2, 5, 0).astype(np.int32), rows, m)
    # rows * m not a multiple of 2^14, and m not a power of two
    cases["ragged cells"] = (rng.integers(-1, 7, n).astype(np.int32), rng.integers(0, 5000, n).astype(np.int32),
                             rng.integers(0, 60, n).astype(np.int32), 6, 5000)
    # ranks past 2^18: the 64-bit packing
    cases["wide ranks"] = (rng.integers(0, rows, n).astype(np.int32), rng.integers(0, m, n).astype(np.int32),
                           rng.integers(0, 2**31 - 1, n).astype(np.int32), rows, m)
    return cases


@pytest.mark.gpu
def test_sparse_scatter_coo_adversarial_streams_on_card(monkeypatch):
    _need_card()
    cases = _adversarial_triples((1 << 18) + 3, 4096, 1 << 12, 5)
    for name, (row, bucket, rank, rows, m) in cases.items():
        args = [torch.from_numpy(a).cuda() for a in (row, bucket, rank)]
        assert not sparse_scatter.tile_plan(rows, m).global_path
        got = sparse_scatter.sparse_scatter_coo(*args, rows, m)
        want = sparse_scatter.sparse_scatter_coo_plain(*args, rows, m)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)
    # the global path, at a size a shared histogram would take
    monkeypatch.setattr(sparse_scatter, "HIST_TILES", 8)
    row, bucket, rank = _triples(100_003, 64, 1 << 12, 9)
    args = [torch.from_numpy(a).cuda() for a in (row, bucket, rank)]
    assert sparse_scatter.tile_plan(64, 1 << 12).global_path
    for g, w in zip(sparse_scatter.sparse_scatter_coo(*args, 64, 1 << 12),
                    sparse_scatter.sparse_scatter_coo_plain(*args, 64, 1 << 12)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.gpu
def test_window_fold_max_kernel_matches_plain_on_card():
    _need_card()
    ring = torch.from_numpy(_ring(16, 64, 1 << 12, 2)).cuda()
    for live in (16, 4, 0):
        mask = (torch.arange(16) >= 16 - live).cuda()
        before = launch_counts()["window_fold_max"]
        got = window_fold.window_fold_max(ring, mask)
        assert launch_counts()["window_fold_max"] == before + 1
        torch.testing.assert_close(got, window_fold.window_fold_max_plain(ring, mask), rtol=0, atol=0)


@pytest.mark.gpu
def test_window_merge_max_kernel_matches_plain_on_card():
    _need_card()
    parts = torch.from_numpy(_ring(3, 1024, 1 << 12, 3)).cuda()
    before = launch_counts()["window_merge_max"]
    got = window_fold.window_merge_max(parts)
    assert launch_counts()["window_merge_max"] == before + 1
    torch.testing.assert_close(got, window_fold.window_merge_max_plain(parts), rtol=0, atol=0)


@pytest.mark.gpu
def test_cm_scatter_add_kernel_matches_plain_on_card():
    _need_card()
    for depth, width, rows, n in ((1, 1, 5, 127), (4, 1024, 1024, (1 << 20) + 3), (16, 1 << 16, 3, 1 << 16)):
        cfg = CMConfig(depth, width, seed=7)
        keys, items = (torch.from_numpy(a).cuda() for a in _cm_stream(n, rows, width))
        counters = torch.from_numpy(_near_wrap((rows, depth, width), n).view(np.int32)).cuda()
        before = launch_counts()["cm_scatter_add"]
        got = cm_scatter.cm_scatter_add(counters, keys, items, cfg)
        assert launch_counts()["cm_scatter_add"] == before + 1
        torch.testing.assert_close(got, cm_scatter.cm_scatter_add_plain(counters, keys, items, cfg), rtol=0, atol=0)


def _cm_adversarial(n, seed):
    """The tiled cm_scatter_add's hard streams, {name: (keys, items, rows, cfg)}."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1, 1025, n).astype(np.int32)
    items = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    cfg = CMConfig(4, 1024, seed=2**64 - 1)
    return {
        # every item on one key and one item: one counter a depth row takes
        # every add, across the units of the split tile
        "one key one item": (np.full(n, 517, np.int32), np.full(n, 99, np.int32), 1024, cfg),
        "only dropped keys": (np.where(keys % 2 == 0, -1, 1024).astype(np.int32), items, 1024, cfg),
        "one row": (np.where(keys % 5 == 0, 1, 0).astype(np.int32), items, 1, cfg),  # B = 1, key 1 dropped
        # 1023 rows: the last tile holds 3; w = 1000: 64-bit items
        "ragged tiles": (keys, items, 1023, cfg),
        "w=1000": (np.clip(keys, -1, 100), items, 100, CMConfig(3, 1000, seed=5)),
        "global path": (keys, items, 1024, CMConfig(1, 1 << 16)),
    }


@pytest.mark.gpu
def test_cm_scatter_add_adversarial_streams_on_card():
    _need_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n = (1 << 22) + 3
    for name, (keys, items, rows, cfg) in _cm_adversarial(n, 11).items():
        counters = torch.full((rows, cfg.depth, cfg.width), -16, dtype=torch.int32, device="cuda")  # wraps
        args = (counters, torch.from_numpy(keys).cuda(), torch.from_numpy(items).cuda(), cfg)
        assert cm_scatter.cm_scatter_path(rows, cfg, n, sms) == ("global" if name == "global path" else "tiled")
        got = cm_scatter.cm_scatter_add(*args)
        torch.testing.assert_close(got, cm_scatter.cm_scatter_add_plain(*args), rtol=0, atol=0, msg=name)
    # many slices: 2^25 items, 2048 slices of 2^14
    n = (1 << 25) + 5
    keys, items = (torch.from_numpy(a).cuda() for a in _cm_stream(n, 1024, 3))
    counters = torch.from_numpy(_near_wrap((1024, 4, 1024), 4).view(np.int32)).cuda()
    assert sparse_scatter.stream_split(n, sms)[1] > 2000
    assert cm_scatter.cm_scatter_path(1024, CMConfig(4, 1024), n, sms) == "tiled"
    torch.testing.assert_close(cm_scatter.cm_scatter_add(counters, keys, items, CMConfig(4, 1024)),
                               cm_scatter.cm_scatter_add_plain(counters, keys, items, CMConfig(4, 1024)),
                               rtol=0, atol=0)
    # the global path at the main config
    keys, items = (torch.from_numpy(a).cuda() for a in _cm_stream((1 << 20) + 1, 1024, 5))
    want = cm_scatter.cm_scatter_add_plain(counters, keys, items, CMConfig(4, 1024))
    before = launch_counts()["cm_scatter_add"]
    torch.testing.assert_close(cm_scatter.cm_scatter_add_global(counters, keys, items, CMConfig(4, 1024)), want,
                               rtol=0, atol=0)
    assert launch_counts()["cm_scatter_add"] == before + 1


@pytest.mark.gpu
def test_hll_update_fused_adversarial_streams_on_card():
    _need_card()
    for p in (4, 16):
        for hash_bits in (32, 64):
            cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=2**64 - 1)
            preset = torch.from_numpy(_registers(cfg, p + hash_bits)).cuda()
            same = torch.full(((1 << 22) + 3,), 0x5EED, dtype=torch.int32, device="cuda")  # one hot register
            x = _t(_u32((1 << 22) + 7, p)).cuda()
            cases = {"identical items": (same, None), "n=1": (x[:1], None), "n=127": (x[:127], None),
                     "n_valid half": (x, x.numel() // 2)}
            for offset in (1, 2, 3):  # items off a 16-byte boundary
                cases[f"offset {offset}"] = (x[offset:], None)
            for name, (items, n_valid) in cases.items():
                for regs in (torch.zeros_like(preset), preset):
                    got = hll_fused.hll_update_fused(regs, items, n_valid, cfg)
                    want = hll_fused.hll_update_fused_plain(regs, items, n_valid, cfg)
                    torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"{cfg} {name}")


@pytest.mark.gpu
def test_cm_window_fold_sum_kernel_matches_plain_on_card():
    _need_card()
    for window, rows, depth, width in ((16, 64, 4, 1024), (3, 5, 1, 1), (1, 7, 3, 1000)):
        ring = torch.from_numpy(_near_wrap((window, rows, depth, width), window).view(np.int32)).cuda()
        for live in sorted({window, max(window // 4, 1), 0}):
            mask = (torch.arange(window) >= window - live).cuda()
            before = launch_counts()["cm_window_fold_sum"]
            got = cm_scatter.cm_window_fold_sum(ring, mask)
            assert launch_counts()["cm_window_fold_sum"] == before + 1
            torch.testing.assert_close(got, cm_scatter.cm_window_fold_sum_plain(ring, mask), rtol=0, atol=0)


@pytest.mark.gpu
def test_rwkv_intra_kernel_matches_plain_on_card():
    _need_card()
    cases = [((g, c, n), 1.0) for g, c, n in ((5120, 64, 64), (7, 40, 64), (3, 1, 64), (16, 64, 32), (1, 8, 16),
                                              (5, 17, 64), (3, 33, 30))]
    cases += [((64, 64, 64), 50.0), ((2, 32, 32), 50.0), ((5120, 64, 64), 50.0), ((2, 17, 7), 50.0)]
    for (g, c, n), decay in cases:
        args = [torch.from_numpy(a).cuda() for a in _intra_inputs(g, c, n, seed=c * n, decay_scale=decay)]
        before = launch_counts()["rwkv_intra"]
        got = rwkv_intra.rwkv_intra(*args)
        torch.cuda.synchronize()
        assert launch_counts()["rwkv_intra"] == before + 1
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, rwkv_intra.rwkv_intra_plain(*args), **INTRA_TOL)
    wide = [torch.from_numpy(a).cuda() for a in _intra_inputs(2, 65, 8)]
    with pytest.raises(ValueError, match="1 <= C <= 64"):
        rwkv_intra.rwkv_intra(*wide)
