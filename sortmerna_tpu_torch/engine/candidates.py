"""Candidate selection, LIS anchoring and alignment bookkeeping.

Faithful port of compute_lis_alignment (alignment.cpp:100-509) as a
*coroutine*: instead of calling Smith-Waterman inline, the routine yields
``SwJob`` requests and receives ``dict`` results (align_full shape).  The
driver batches jobs from thousands of read coroutines into device waves --
the TPU-native replacement for the reference's per-thread inline SSW calls
-- while preserving the exact per-read sequential semantics (heuristic 1,
best-N replace-min, early exits).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np

from ..ops.lis import find_lis
from .read import Alignment, ReadState, ReadSeq


@dataclass
class SwJob:
    """One Smith-Waterman request: read window vs reference window."""
    query: np.ndarray        # int8/uint8 04-encoded read slice
    ref: np.ndarray          # 04-encoded reference slice
    minimal_score: int


@dataclass
class PartContext:
    """Everything the candidate stage needs about the loaded index part."""
    index_num: int
    part_num: int
    pos_offsets: np.ndarray
    pos_seq: np.ndarray
    pos_pos: np.ndarray
    ref_seqs: object               # 04-encoded (NT_TABLE) references of
                                   # the part: index.artifact.PartRefs
    minimal_score: int
    lnwin: int
    is_last_index: bool
    is_last_part: bool


@dataclass
class Opts:
    """Subset of Runopts consumed by the alignment engine."""
    num_alignments: int = 1
    is_best: bool = True
    num_seeds: int = 2
    min_lis: int = 2
    edges: int = 4
    is_as_percent: bool = False
    match: int = 2
    mismatch: int = -3
    gap_open: int = 5
    gap_ext: int = 2
    score_n: int = 0
    is_full_search: bool = False
    is_forward: bool = False
    is_reverse: bool = False
    minoccur: int = 0
    threads: int = 1        # host threads (--threads, processor.cpp:248)
    device_probe: bool = False   # d<=1 probe on device (ops/seed_search)


class Readstats:
    """Run counters (readstats.cpp:65-80)."""

    def __init__(self, num_dbs: int):
        self.num_aligned = 0
        self.num_short = 0
        self.num_denovo = 0
        self.n_yid_ycov = 0
        self.n_yid_ncov = 0
        self.n_nid_ycov = 0
        self.reads_matched_per_db = [0] * num_dbs
        self.all_reads_count = 0
        self.all_reads_len = 0
        self.min_read_len = 0
        self.max_read_len = 0
        self.total_otu = 0


def compute_lis_alignment(
    read: ReadSeq,
    state: ReadState,
    hits: List[Tuple[int, int]],          # (id, win) accumulated this strand
    forward: bool,
    ctx: PartContext,
    opts: Opts,
    readstats: Readstats,
    max_sw_score: int,
) -> Generator[SwJob, dict, bool]:
    """Coroutine.  Yields SwJob, receives align_full-style result dicts.

    Returns (via StopIteration.value) the final ``search`` flag: False when
    an alignment was accepted this call (stop multi-pass seeding,
    alignment.cpp:472).
    """
    search = True
    is_aligned = False
    readlen = len(read)
    read04 = read.strand04(forward)

    # 1. k-mer hit frequency per candidate reference (alignment.cpp:117-130)
    kid_arr = np.fromiter((h[0] for h in hits), dtype=np.int64, count=len(hits))
    win_arr = np.fromiter((h[1] for h in hits), dtype=np.int64, count=len(hits))
    starts = ctx.pos_offsets[kid_arr]
    ends = ctx.pos_offsets[kid_arr + 1]
    lens = (ends - starts).astype(np.int64)
    total = int(lens.sum())
    flat = np.repeat(starts, lens) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(lens) - lens, lens))
    seqs_flat = ctx.pos_seq[flat].astype(np.int64)
    poss_flat = ctx.pos_pos[flat].astype(np.int64)
    wins_flat = np.repeat(win_arr, lens)
    freq_counts = np.bincount(seqs_flat)

    # 2. candidates with >= num_seeds hits, by (freq desc, seq asc)
    #    (alignment.cpp:134-148)
    cand_seqs = np.flatnonzero(freq_counts >= opts.num_seeds)
    cands = sorted(((int(s), int(freq_counts[s])) for s in cand_seqs),
                   key=lambda p: (-p[1], p[0]))

    is_search_candidates = True
    prev_occur = None
    for k, (max_ref, max_occur) in enumerate(cands):
        if not is_search_candidates:
            break
        if max_occur < opts.num_seeds:
            break
        # best-N candidate budget (alignment.cpp:165-169)
        if is_aligned and opts.min_lis > 0 and k > 0 \
                and max_occur < cands[k - 1][1]:
            state.best -= 1
            if state.best < 1:
                break

        # 3. hits on this reference, sorted (ref_pos, read_pos) asc
        #    (alignment.cpp:176-201)
        sel = seqs_flat == max_ref
        hp = poss_flat[sel]
        hw = wins_flat[sel]
        order = np.lexsort((hw, hp))
        hits_on_ref = list(zip(hp[order].tolist(), hw[order].tolist()))

        # 4. sliding window of read length along the reference
        it = 0
        nhits = len(hits_on_ref)
        match_set: deque = deque()
        begin_ref, begin_read = hits_on_ref[0]
        while it < nhits and is_search_candidates:
            end_ref_max = begin_ref + readlen - begin_read - ctx.lnwin + 1
            push = False
            while it < nhits and hits_on_ref[it][0] <= end_ref_max:
                match_set.append(hits_on_ref[it])
                push = True
                it += 1
            do_align = True
            # heuristic 1 (alignment.cpp:239-249)
            if not push and is_aligned:
                do_align = False
            else:
                is_aligned = False

            if do_align and len(match_set) >= opts.num_seeds:
                lis_arr = find_lis(list(match_set))
                if len(lis_arr) >= opts.min_lis:
                    lcs_ref_start, lcs_que_start = match_set[lis_arr[0]]
                    reflen = len(ctx.ref_seqs[max_ref])
                    edges = int((opts.edges / 100.0) * readlen) \
                        if opts.is_as_percent else int(opts.edges)
                    head = 0
                    tail = 0
                    # overhang geometry (alignment.cpp:283-357)
                    if lcs_ref_start < lcs_que_start:
                        align_ref_start = 0
                        align_que_start = lcs_que_start - lcs_ref_start
                        head = 0
                        if reflen < readlen:
                            tail = 0
                            if align_que_start > (readlen - reflen):
                                align_length = reflen - (
                                    align_que_start - (readlen - reflen))
                            else:
                                align_length = reflen
                        else:
                            tail = reflen - align_ref_start - readlen
                            if tail > edges - 1:
                                tail = edges
                            align_length = readlen + head + tail \
                                - align_que_start
                    else:
                        align_ref_start = lcs_ref_start - lcs_que_start
                        align_que_start = 0
                        if align_ref_start > (edges - 1):
                            head = edges
                        if align_ref_start + readlen > reflen:
                            tail = 0
                            align_length = reflen - align_ref_start - head
                        else:
                            tail = reflen - align_ref_start - readlen
                            if tail > edges - 1:
                                tail = edges
                            align_length = readlen + head + tail

                    qry = read04[align_que_start:
                                 align_que_start + align_length - head - tail]
                    rstart = align_ref_start - head
                    refw = ctx.ref_seqs[max_ref][rstart:rstart + align_length]

                    result = yield SwJob(qry, refw, ctx.minimal_score)

                    is_aligned = (result is not None
                                  and result["score1"] > ctx.minimal_score)
                    if is_aligned:
                        if result["score1"] == max_sw_score:
                            state.max_sw_count += 1
                        aln = Alignment(
                            index_num=ctx.index_num,
                            part=ctx.part_num,
                            ref_num=max_ref,
                            read_begin1=result["read_begin1"]
                            + align_que_start,
                            read_end1=result["read_end1"] + align_que_start,
                            ref_begin1=result["ref_begin1"] + rstart,
                            ref_end1=result["ref_end1"] + rstart,
                            readlen=readlen,
                            score1=result["score1"],
                            strand=forward,
                            cigar=(list(result["cigar"])
                                   if result["cigar"] is not None
                                   else []),
                        )
                        if not state.is_hit:       # alignment.cpp:411-416
                            state.is_hit = True
                            readstats.num_aligned += 1
                            readstats.reads_matched_per_db[
                                ctx.index_num] += 1

                        nal = len(state.alignments)
                        if (opts.num_alignments == 0 or not opts.is_best
                                or nal < opts.num_alignments):
                            state.alignments.append(aln)
                            state.is_new_hit = True
                        elif (opts.is_best and nal == opts.num_alignments
                              and state.alignments[state.min_index].score1
                              < result["score1"]):
                            # replace-min policy (alignment.cpp:425-459)
                            if (opts.num_alignments > 1
                                    and state.max_index == 0
                                    and state.min_index == 0):
                                state.min_index = _find_min(state.alignments)
                                state.max_index = _find_max(state.alignments)
                            mini = state.min_index
                            maxi = state.max_index
                            state.alignments[mini] = aln
                            state.is_new_hit = True
                            if (result["score1"]
                                    > state.alignments[maxi].score1
                                    and len(state.alignments) > 1):
                                state.max_index = mini
                                state.min_index = _find_min(state.alignments)
                            # NOTE: reproduces the reference's counter bug --
                            # alignv[mini] already holds the NEW alignment
                            # when its index_num is decremented
                            # (alignment.cpp:454)
                            readstats.reads_matched_per_db[
                                state.alignments[mini].index_num] -= 1
                            readstats.reads_matched_per_db[
                                ctx.index_num] += 1

                        # stop when all N alignments found
                        # (alignment.cpp:461-469)
                        if opts.num_alignments > 0:
                            if opts.is_best:
                                if opts.num_alignments == state.max_sw_count:
                                    is_search_candidates = False
                            elif opts.num_alignments == len(state.alignments):
                                is_search_candidates = False
                        search = False

            # pop (alignment.cpp:486-506)
            if match_set:
                match_set.popleft()
            if not match_set:
                if it < nhits:
                    begin_ref, begin_read = hits_on_ref[it]
                else:
                    break
            else:
                begin_ref, begin_read = match_set[0]

    return search


def _find_min(alignments: List[Alignment]) -> int:
    mi, ms = 0, alignments[0].score1
    for i, a in enumerate(alignments):
        if a.score1 < ms:
            ms = a.score1
            mi = i
    return mi


def _find_max(alignments: List[Alignment]) -> int:
    mi, ms = 0, alignments[0].score1
    for i, a in enumerate(alignments):
        if a.score1 > ms:
            ms = a.score1
            mi = i
    return mi
