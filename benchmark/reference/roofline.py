"""Frozen roofline count of the SW wave kernel (``sw_fused``).

Peaks of one NVIDIA H100 SXM, frozen so that the yardstick does not
move with the card a run lands on:

- int32: NVIDIA publishes no int32 rate.  Derived as 132 SMs x 64 int32
  lanes an SM x the 1,980 MHz maximum SM clock = 16.73 Tops.
- memory: 3.35 TB/s of HBM3 (data sheet).

A DP cell costs 6 int32 operations (H, E and F maxima and their
additions).  The cells a launch computes are counted from its inputs
and outputs, whatever implements it: every valid cell of the forward
pass, and for each pair that passes to the begin pass the rows up to
its end in the read by the columns from its end back to its start in
the reference.  Bytes are the block read once and the result written
once.
"""

from __future__ import annotations

import numpy as np

SMS = 132
INT32_LANES_PER_SM = 64
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * SM_CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = 6


def fused_cells(ints: np.ndarray, out: np.ndarray) -> int:
    """``ints``: int32 [B, 3] (q_len, r_len, minimal) of a block;
    ``out``: int32 [5, B] (score, beg_ref, end_ref, beg_read, end_read)."""
    ql = ints[:, 0].astype(np.int64).clip(0)
    rl = ints[:, 1].astype(np.int64).clip(0)
    o = out.astype(np.int64)
    ok = o[1] >= 0
    return int((ql * rl).sum()
               + ((o[4][ok] + 1) * (o[2][ok] - o[1][ok] + 1)).sum())


def bound_s(cells: int, nbytes: int) -> float:
    """The least time the card could take: the larger of the cells'
    operations over the int32 rate and the bytes over HBM's rate."""
    return max(cells * OPS_PER_CELL / INT32_OPS_PER_S,
               nbytes / HBM_BYTES_PER_S)
