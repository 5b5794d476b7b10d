"""Data-parallel SW scoring over a list of torch devices.

The JAX package lays a 1-D ``dp`` mesh over its devices and shards the
batch dim of every SW step over it.  Here a plain list of
``torch.device``s stands for the mesh: a batch is split into contiguous
slices, one a device, each slice is scored by the kernels on its own
device, and the per-slice counts are summed on the host.

* make_mesh(n): the first n CUDA devices (or the caller's list);
* sharded_sw_step: the device step of the align pipeline -- batched SW
  scoring over a split batch plus the global count of threshold-passing
  alignments;
* pad_to_multiple / shard_reads: host-side batch partitioning helpers
  (pair aligned, deterministic order for byte-identical merged reports).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops.sw_kernels import sw_score_batch


def make_mesh(n_devices: int = None, devices=None) -> List[torch.device]:
    """The devices of a data-parallel run: ``devices`` as given, or the
    first ``n_devices`` of the CUDA devices (all of them by default).  It
    never substitutes the CPU: asking for more CUDA devices than there are
    raises."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
    else:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n < 1 or n > count:
            raise RuntimeError(
                f"sortmerna_tpu_torch: {n} CUDA devices asked for, "
                f"{count} present; pass the device list to run elsewhere")
        out = [torch.device("cuda", i) for i in range(n)]
    if n_devices is not None:
        out = out[:n_devices]
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def sharded_sw_step(query, qlen, ref, rlen, mat, minimal, gap_open, gap_ext,
                    devices: Sequence):
    """One data-parallel align device step: ``sw_score_batch`` on each
    device's contiguous slice of the batch (the sw_scan kernel with its
    gather on a CUDA device, the plain version on the CPU), and the count
    of pairs with ``score > minimal`` summed over the slices.

    numpy in (query / ref int [B, L], qlen / rlen / minimal int [B], mat
    int [5, 5]), numpy out: (score, end_ref, end_read) int32 [B] and the
    count as an int.  The kernels take any B, so no slice is padded; the
    result is the JAX function's for the same inputs."""
    devices = [torch.device(d) for d in devices]
    i32 = np.int32
    arrays = [np.ascontiguousarray(a, i32)
              for a in (query, qlen, ref, rlen, minimal)]
    mat = np.asarray(mat, i32)
    # every slice is launched before any result is read back
    running = []
    for dev, sl in zip(devices, shard_reads(len(query), len(devices),
                                            False)):
        if sl.stop == sl.start:
            continue
        q, ql, r, rl, ms = (torch.from_numpy(a[sl]).to(dev)
                            for a in arrays)
        score, er, eq = sw_score_batch(q, ql, r, rl,
                                       torch.from_numpy(mat).to(dev),
                                       gap_open, gap_ext)
        running.append((score, er, eq, (score > ms).sum()))
    score, er, eq = (np.concatenate([o[k].cpu().numpy() for o in running]
                                    + [np.zeros(0, i32)])
                     for k in range(3))
    return score, er, eq, sum(int(o[3]) for o in running)


def shard_reads(n_reads: int, n_shards: int, paired: bool) -> List[slice]:
    """Deterministic contiguous read partition; pair-aligned when paired
    (readfeed.cpp:1110-1114 chunking semantics)."""
    unit = 2 if paired else 1
    n_units = n_reads // unit
    base = n_units // n_shards
    rem = n_units % n_shards
    out = []
    start = 0
    for s in range(n_shards):
        cnt = (base + (1 if s < rem else 0)) * unit
        out.append(slice(start, start + cnt))
        start += cnt
    return out
