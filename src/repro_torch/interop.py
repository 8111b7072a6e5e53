"""Carry sketch state between the reference package and the port.

There are no weights: a sketch's state is its registers and its exact item
counters, exchanged as numpy arrays in the reference's own layout --
uint8 registers, (m,) or (B, m), and uint32 (hi, lo) counter limbs, (2,) or
(B, 2).  Wire bytes (RHLL, RHLB) need nothing here: both packages write and
read the same formats.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.sketch import hll
from repro_torch.sketch.bank import SketchBank
from repro_torch.sketch.carrier import HyperLogLog
from repro_torch.sketch.hll import HLLConfig


def from_reference_state(
    registers: np.ndarray,
    n_items: np.ndarray,
    p: int,
    hash_bits: int,
    seed: int = 0,
    device=None,
) -> Union[HyperLogLog, SketchBank]:
    """A ``HyperLogLog`` for (m,) registers, a ``SketchBank`` for (B, m)."""
    cfg = HLLConfig(p=p, hash_bits=hash_bits, seed=seed)
    regs = np.asarray(registers)
    limbs = np.asarray(n_items)
    if regs.shape[-1:] != (cfg.m,) or regs.ndim not in (1, 2):
        raise ValueError(f"expected (m,) or (B, m) registers with m={cfg.m}, got {regs.shape}")
    if limbs.shape != regs.shape[:-1] + (2,):
        raise ValueError(f"expected {regs.shape[:-1] + (2,)} counter limbs, got {limbs.shape}")
    device = hll.resolve_device(device)
    state = (
        torch.from_numpy(regs.astype(np.uint8)).to(device),
        torch.from_numpy(limbs.astype(np.uint32).astype(np.int64)).to(device),
        cfg,
    )
    return HyperLogLog(*state) if regs.ndim == 1 else SketchBank(*state)


def to_reference_state(x: Union[HyperLogLog, SketchBank]) -> Tuple[np.ndarray, np.ndarray]:
    """(registers uint8, n_items uint32 limbs) as the reference carries them."""
    return (
        x.registers.detach().cpu().numpy().astype(np.uint8),
        x.n_items.detach().cpu().numpy().astype(np.uint32),
    )
