"""Port vs reference: Murmur3, the (index, rank) split and the hash_rank kernel.

The same numpy items go through ``repro`` (JAX) and ``repro_torch`` on the
CPU and must agree bit for bit, and with the pure-python oracles, for
p in 4..16, H in {32, 64}, seeds {0, 2^32+7, 2^64-1} and the edge keys 0,
0xFFFFFFFF and negative int32.  The port's hash_rank wrapper on a CPU
tensor runs its plain version, held here to the reference's Pallas kernel
in interpret mode; the ``gpu`` test holds the CUDA kernel to the plain
version on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.sketch import backends as ref_backends
from repro.sketch import hll as ref_hll
from repro.sketch import murmur3 as ref_murmur3
from repro.sketch.hll import HLLConfig as RefConfig
from repro_torch.kernels import hash_rank as port_kernel
from repro_torch.kernels import launch_counts
from repro_torch.sketch import hll, murmur3
from repro_torch.sketch.hll import HLLConfig

SEEDS = (0, 2**32 + 7, 2**64 - 1)
EDGE = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1, 0xDEADBEEF], np.uint32)


def _items(n, seed):
    x = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)
    return np.concatenate([EDGE, x])


def _t(items_u32):
    """numpy uint32 -> the port's int32 item tensor (same bits)."""
    return torch.from_numpy(items_u32.view(np.int32).copy())


def _u64(limbs):
    return (np.asarray(limbs.hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        limbs.lo
    ).astype(np.uint64)


@pytest.mark.parametrize("seed", SEEDS)
def test_murmur3_32_matches_reference_and_oracle(seed):
    items = _items(2048, seed % 97)
    got = murmur3.murmur3_32(_t(items), seed).numpy()
    want = np.asarray(ref_murmur3.murmur3_32(jnp.asarray(items), seed)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    for v, h in zip(items[:40].tolist(), got[:40].tolist()):
        assert h == murmur3.murmur3_32_py(v, seed) == ref_murmur3.murmur3_32_py(v, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_murmur3_64_matches_reference_and_oracle(seed):
    items = _items(2048, seed % 89)
    got = murmur3.murmur3_64(_t(items), seed).numpy().view(np.uint64)
    want = _u64(ref_murmur3.murmur3_64(jnp.asarray(items), seed))
    np.testing.assert_array_equal(got, want)
    for v, h in zip(items[:40].tolist(), got[:40].tolist()):
        assert h == murmur3.murmur3_64_py(v, seed) == ref_murmur3.murmur3_64_py(v, seed)


def test_signed_int32_items_hash_as_their_uint32_bits():
    signed = np.array([-1, -2**31, -12345, 0, 7], np.int32)
    via_signed = murmur3.murmur3_64(torch.from_numpy(signed), 3)
    via_unsigned = murmur3.murmur3_64(_t(signed.view(np.uint32)), 3)
    torch.testing.assert_close(via_signed, via_unsigned, rtol=0, atol=0)
    want = _u64(ref_murmur3.murmur3_64(jnp.asarray(signed), 3))
    np.testing.assert_array_equal(via_signed.numpy().view(np.uint64), want)


@pytest.mark.parametrize("hash_bits", [32, 64])
@pytest.mark.parametrize("p", list(range(4, 17)))
def test_hash_index_rank_matches_reference(p, hash_bits):
    items = _items(1024, p * hash_bits)
    for seed in SEEDS:
        idx, rank = hll.hash_index_rank(_t(items), HLLConfig(p=p, hash_bits=hash_bits, seed=seed))
        ridx, rrank = ref_hll.hash_index_rank(
            jnp.asarray(items), RefConfig(p=p, hash_bits=hash_bits, seed=seed)
        )
        assert idx.dtype == rank.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(rank.numpy(), np.asarray(rrank))
        assert int(rank.min()) >= 1 and int(rank.max()) <= HLLConfig(p=p, hash_bits=hash_bits).max_rank


@pytest.mark.parametrize("hash_bits", [32, 64])
@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_plain_hash_rank_matches_reference_kernel(p, hash_bits):
    items = _items(3000, p + hash_bits)  # ragged: no multiple of the TPU tile
    cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=2**32 + 7)
    before = launch_counts()["hash_rank"]
    idx, rank = port_kernel.hash_rank(_t(items), cfg)
    assert launch_counts()["hash_rank"] == before  # a CPU tensor never launches
    ridx, rrank = ref_backends.hash_rank(
        jnp.asarray(items), RefConfig(p=p, hash_bits=hash_bits, seed=2**32 + 7), interpret=True
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(rrank))


def test_hash_rank_wrapper_validates_items(monkeypatch):
    cfg = HLLConfig(p=8)
    with pytest.raises(TypeError, match="int32 or uint32"):
        port_kernel.hash_rank(torch.zeros(4, dtype=torch.float32), cfg)
    # a tensor on a device that is neither the CPU nor a card is never run
    # through the plain version: a meta tensor (the op analysis's) gets empty
    # outputs of the kernel's shapes and launches nothing; any other device
    # meets the CUDA gate, which refuses it
    def plain(*args):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(port_kernel, "hash_rank_plain", plain)
    launches = launch_counts()["hash_rank"]
    idx, rank = port_kernel.hash_rank(torch.zeros(4, dtype=torch.int32, device="meta"), cfg)
    assert (idx.device.type, idx.shape, idx.dtype) == ("meta", (4,), torch.int32)
    assert (rank.device.type, rank.shape, rank.dtype) == ("meta", (4,), torch.int32)
    assert launch_counts()["hash_rank"] == launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_kernel._build.require_cuda(torch.zeros(4, dtype=torch.int32, device="meta"))


@pytest.mark.gpu
def test_hash_rank_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for p, hash_bits in ((4, 64), (14, 32), (16, 64)):
        cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=2**64 - 1)
        x = _t(_items((1 << 20) + 3, p)).cuda()
        before = launch_counts()["hash_rank"]
        idx, rank = port_kernel.hash_rank(x, cfg)
        assert launch_counts()["hash_rank"] == before + 1
        pidx, prank = port_kernel.hash_rank_plain(x, cfg)
        torch.testing.assert_close(idx, pidx, rtol=0, atol=0)
        torch.testing.assert_close(rank, prank, rtol=0, atol=0)
