"""SAM report (report_sam.cpp:64-211)."""

from __future__ import annotations

from typing import List

from ..engine.read import Alignment, ReadSeq
from ..options import RunOptions

_NT = "ACGTN"


def sam_header(opts: RunOptions, sq_lists: List[List[tuple]]) -> str:
    """@HD/@SQ/@PG header (report_sam.cpp:154-211).

    sq_lists: per reference DB, list of (name, length).
    """
    out = ["@HD\tVN:1.0\tSO:unsorted\n"]
    if opts.is_SQ:
        for sq in sq_lists:
            for name, ln in sq:
                out.append(f"@SQ\tSN:{name}\tLN:{ln}\n")
    out.append(f"@PG\tID:sortmerna\tVN:1.0\tCL:{opts.cmdline}\n")
    return "".join(out)


def sam_for_read(read: ReadSeq, alignments: List[Alignment],
                 refs_headers: List[str], refs_seqs,
                 index_num: int, part_num: int,
                 is_print_all_reads: bool) -> str:
    out = []
    if is_print_all_reads and not alignments \
            and index_num == 0 and part_num == 0:
        return read.seq_id + "\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n"
    from ..constants import NT_MAP
    from .blast import calc_miss_gap_match
    for aln in alignments:
        if aln.index_num != index_num or aln.part != part_num:
            continue
        ref_id = refs_headers[aln.ref_num].split(" ", 1)[0].split("\t", 1)[0]
        flag = "0" if aln.strand else "16"
        cig = ""
        if aln.read_begin1 != 0:
            cig += f"{aln.read_begin1}S"
        for c in aln.cigar:
            cig += str(c >> 4) + "MID"[c & 0xF]
        end_mask = len(read) - aln.read_end1 - 1
        if end_mask > 0:
            cig += f"{end_mask}S"
        # SEQ in the aligned orientation (report_sam.cpp:116-120)
        seq04 = read.strand04(aln.strand)
        seq = NT_MAP[seq04].tobytes().decode("ascii")
        if read.quality:
            qual = read.quality if aln.strand else read.quality[::-1]
        else:
            qual = "*"
        m = aln.mgm
        if m is None:
            m = calc_miss_gap_match(refs_seqs[aln.ref_num], seq04, aln)
        miss, gaps = m[0], m[1]
        out.append(
            f"{read.seq_id}\t{flag}\t{ref_id}\t{aln.ref_begin1 + 1}\t255\t"
            f"{cig}\t*\t0\t0\t{seq}\t{qual}\tAS:i:{aln.score1}\t"
            f"NM:i:{miss + gaps}\n")
    return "".join(out)
