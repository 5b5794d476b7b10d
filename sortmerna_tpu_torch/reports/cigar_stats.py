"""Batched CIGAR statistics for the report/classification passes.

The denovo, otu, blast-tabular and sam passes each re-derive
(mismatch, gap, match, %id, %cov) from every stored CIGAR
(Read::calc_miss_gap_match, read.cpp:547-589).  Per-alignment python
walks dominated report time; ``precompute_part_stats`` computes the
whole part's counts in ONE native call (native/feed_scan.cpp
cigar_stats_batch) over the packed strand buffers and caches the tuple
on each Alignment (``aln.mgm``), which calc_miss_gap_match consults
first.
"""

from __future__ import annotations

import numpy as np

from .. import native


def _report_batch(ctx):
    """One packed ReadBatch over ALL reads, cached on the context (the
    report passes sweep every part against the same reads)."""
    batch = getattr(ctx, "_report_batch", None)
    if batch is None:
        from ..engine.read import ReadBatch
        ps = getattr(ctx.reads, "packed_slice", None)
        if ps is not None:
            batch = ReadBatch.from_packed(*ps(0, len(ctx.reads)))
        else:
            batch = ReadBatch(list(ctx.reads))
        batch.ensure_strands()
        ctx._report_batch = batch
    return batch


def precompute_part_stats(ctx, idx_num: int, part_num: int,
                          ref_seqs) -> None:
    """Attach ``mgm`` to every alignment of (idx_num, part_num)."""
    lib = native.get_lib()
    if lib is None:
        return
    batch = _report_batch(ctx)
    refs_off = np.zeros(len(ref_seqs) + 1, np.int64)
    for i, s in enumerate(ref_seqs):
        refs_off[i + 1] = refs_off[i] + len(s)
    refs_data = (np.concatenate(
        [np.asarray(s, np.uint8) for s in ref_seqs])
        if len(ref_seqs) else np.zeros(0, np.uint8))

    alns = []
    for ord_, st in enumerate(ctx.states):
        for a in st.alignments:
            if (a.index_num == idx_num and a.part == part_num
                    and a.cigar is not None
                    and getattr(a, "mgm", None) is None):
                alns.append((ord_, a))
    if not alns:
        return
    n = len(alns)
    cig_off = np.zeros(n + 1, np.int64)
    for i, (_, a) in enumerate(alns):
        cig_off[i + 1] = cig_off[i] + len(a.cigar)
    cigs = np.zeros(int(cig_off[-1]), np.uint32)
    ref_w = np.zeros(n, np.int64)
    q_w = np.zeros(n, np.int64)
    strand = np.zeros(n, np.uint8)
    offs = batch.offs
    for i, (ord_, a) in enumerate(alns):
        cigs[cig_off[i]:cig_off[i + 1]] = np.asarray(a.cigar, np.uint32)
        ref_w[i] = refs_off[a.ref_num] + a.ref_begin1
        q_w[i] = offs[ord_] + a.read_begin1
        strand[i] = a.strand
    out3 = np.zeros((n, 3), np.int32)
    f04 = np.ascontiguousarray(batch.concat04(True))
    r04 = np.ascontiguousarray(batch.concat04(False))
    lib.cigar_stats_batch(
        cigs.ctypes.data, cig_off.ctypes.data,
        refs_data.ctypes.data, ref_w.ctypes.data,
        f04.ctypes.data, r04.ctypes.data,
        strand.ctypes.data, q_w.ctypes.data, n, out3.ctypes.data)
    rows = out3.tolist()
    for (_, a), (miss, gap, match) in zip(alns, rows):
        tot = miss + gap + match
        idr = match / tot if tot else 0.0
        cov = abs(a.read_end1 - a.read_begin1 + 1) / a.readlen
        a.mgm = (miss, gap, match, idr, cov)
